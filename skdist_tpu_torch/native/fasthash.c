/*
 * fasthash: native text feature hashing for skdist_tpu_torch's
 * FastHashingVectorizer (preprocessing.py).
 *
 * A copy of skdist_tpu/native/fasthash.c, kept byte for byte in its
 * code so that the two packages hash the same documents to the same
 * CSR arrays: tokenise (word or char_wb analyzers), form n-grams, FNV-1a
 * hash them into n_features buckets, count, and emit CSR arrays.
 *
 * The algorithm is mirrored by the pure-Python form in
 * skdist_tpu_torch/native/__init__.py; the tests hold the two (and the
 * JAX package's) bitwise equal.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* FNV-1a 32-bit */
static uint32_t fnv1a(const char *data, size_t len) {
    uint32_t h = 2166136261u;
    for (size_t i = 0; i < len; i++) {
        h ^= (unsigned char)data[i];
        h *= 16777619u;
    }
    return h;
}

typedef struct {
    uint32_t *buf;
    size_t len, cap;
} U32Vec;

static int u32vec_push(U32Vec *v, uint32_t x) {
    if (v->len == v->cap) {
        size_t ncap = v->cap ? v->cap * 2 : 64;
        uint32_t *nbuf = (uint32_t *)realloc(v->buf, ncap * sizeof(uint32_t));
        if (!nbuf) return -1;
        v->buf = nbuf;
        v->cap = ncap;
    }
    v->buf[v->len++] = x;
    return 0;
}

static int is_token_char(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_' || (c >= 0x80);
}

/* collect word token [start, end) offsets; ASCII-lowercase in place */
typedef struct {
    size_t start, end;
} Span;

typedef struct {
    Span *buf;
    size_t len, cap;
} SpanVec;

static int spanvec_push(SpanVec *v, size_t s, size_t e) {
    if (v->len == v->cap) {
        size_t ncap = v->cap ? v->cap * 2 : 32;
        Span *nbuf = (Span *)realloc(v->buf, ncap * sizeof(Span));
        if (!nbuf) return -1;
        v->buf = nbuf;
        v->cap = ncap;
    }
    v->buf[v->len].start = s;
    v->buf[v->len].end = e;
    v->len++;
    return 0;
}

/* hash word n-grams: tokens joined by single spaces */
static int hash_word_ngrams(char *text, size_t tlen, int nlo, int nhi,
                            uint32_t n_features, U32Vec *out) {
    SpanVec toks = {0};
    size_t i = 0;
    int rc = 0;
    char *scratch = NULL;
    while (i < tlen) {
        while (i < tlen && !is_token_char((unsigned char)text[i])) i++;
        size_t s = i;
        while (i < tlen && is_token_char((unsigned char)text[i])) i++;
        /* sklearn-like: tokens of length >= 2 bytes */
        if (i - s >= 2) {
            if (spanvec_push(&toks, s, i) < 0) { rc = -1; goto done; }
        }
    }
    scratch = (char *)malloc(tlen + (size_t)nhi);
    if (!scratch) { rc = -1; goto done; }
    for (int n = nlo; n <= nhi; n++) {
        if ((size_t)n > toks.len) break;
        for (size_t t = 0; t + (size_t)n <= toks.len; t++) {
            size_t pos = 0;
            for (int j = 0; j < n; j++) {
                Span sp = toks.buf[t + (size_t)j];
                if (j) scratch[pos++] = ' ';
                memcpy(scratch + pos, text + sp.start, sp.end - sp.start);
                pos += sp.end - sp.start;
            }
            if (u32vec_push(out, fnv1a(scratch, pos) % n_features) < 0) {
                rc = -1;
                goto done;
            }
        }
    }
done:
    free(scratch);
    free(toks.buf);
    return rc;
}

/* char_wb n-grams: per word padded with single spaces on both sides */
static int hash_charwb_ngrams(char *text, size_t tlen, int nlo, int nhi,
                              uint32_t n_features, U32Vec *out) {
    size_t i = 0;
    char *scratch = (char *)malloc(tlen + 2);
    if (!scratch) return -1;
    int rc = 0;
    while (i < tlen) {
        while (i < tlen && !is_token_char((unsigned char)text[i])) i++;
        size_t s = i;
        while (i < tlen && is_token_char((unsigned char)text[i])) i++;
        if (i == s) continue;
        size_t wlen = i - s;
        scratch[0] = ' ';
        memcpy(scratch + 1, text + s, wlen);
        scratch[wlen + 1] = ' ';
        size_t plen = wlen + 2;
        for (int n = nlo; n <= nhi; n++) {
            if ((size_t)n > plen) break;
            for (size_t p = 0; p + (size_t)n <= plen; p++) {
                if (u32vec_push(out, fnv1a(scratch + p, (size_t)n)
                                         % n_features) < 0) {
                    rc = -1;
                    goto done;
                }
            }
        }
    }
done:
    free(scratch);
    return rc;
}

static int cmp_u32(const void *a, const void *b) {
    uint32_t x = *(const uint32_t *)a, y = *(const uint32_t *)b;
    return (x > y) - (x < y);
}

/*
 * hash_docs(docs: list[str], n_features: int, nlo: int, nhi: int,
 *           analyzer: int (0=word, 1=char_wb), lowercase: int,
 *           binary: int)
 * -> (indptr: bytes int64, indices: bytes int32, data: bytes float32)
 */
static PyObject *hash_docs(PyObject *self, PyObject *args) {
    PyObject *docs;
    unsigned int n_features;
    int nlo, nhi, analyzer, lowercase, binary;
    if (!PyArg_ParseTuple(args, "OIiiiii", &docs, &n_features, &nlo, &nhi,
                          &analyzer, &lowercase, &binary))
        return NULL;
    if (!PyList_Check(docs)) {
        PyErr_SetString(PyExc_TypeError, "docs must be a list of str");
        return NULL;
    }
    if (n_features == 0 || nlo < 1 || nhi < nlo) {
        PyErr_SetString(PyExc_ValueError, "bad n_features / ngram range");
        return NULL;
    }
    Py_ssize_t n_docs = PyList_GET_SIZE(docs);

    int64_t *indptr = (int64_t *)malloc((size_t)(n_docs + 1) * sizeof(int64_t));
    U32Vec all_idx = {0};
    float *all_data = NULL;
    size_t data_cap = 0, data_len = 0;
    U32Vec doc_hashes = {0};
    if (!indptr) goto fail_nomem;
    indptr[0] = 0;

    for (Py_ssize_t di = 0; di < n_docs; di++) {
        PyObject *item = PyList_GET_ITEM(docs, di);
        if (!PyUnicode_Check(item)) {
            PyErr_SetString(PyExc_TypeError, "docs must be a list of str");
            goto fail;
        }
        Py_ssize_t blen;
        const char *bytes = PyUnicode_AsUTF8AndSize(item, &blen);
        if (!bytes) goto fail;
        char *text = (char *)malloc((size_t)blen + 1);
        if (!text) goto fail_nomem;
        if (lowercase) {
            for (Py_ssize_t b = 0; b < blen; b++) {
                char c = bytes[b];
                text[b] = (c >= 'A' && c <= 'Z') ? (char)(c + 32) : c;
            }
        } else {
            memcpy(text, bytes, (size_t)blen);
        }
        text[blen] = 0;

        doc_hashes.len = 0;
        int rc = analyzer == 0
            ? hash_word_ngrams(text, (size_t)blen, nlo, nhi, n_features,
                               &doc_hashes)
            : hash_charwb_ngrams(text, (size_t)blen, nlo, nhi, n_features,
                                 &doc_hashes);
        free(text);
        if (rc < 0) goto fail_nomem;

        /* sort + run-length encode into CSR row */
        if (doc_hashes.len)
            qsort(doc_hashes.buf, doc_hashes.len, sizeof(uint32_t), cmp_u32);
        size_t r = 0;
        while (r < doc_hashes.len) {
            uint32_t col = doc_hashes.buf[r];
            size_t cnt = 1;
            while (r + cnt < doc_hashes.len && doc_hashes.buf[r + cnt] == col)
                cnt++;
            if (data_len == data_cap) {
                size_t ncap = data_cap ? data_cap * 2 : 1024;
                float *nd = (float *)realloc(all_data, ncap * sizeof(float));
                if (!nd) goto fail_nomem;
                all_data = nd;
                data_cap = ncap;
            }
            if (u32vec_push(&all_idx, col) < 0) goto fail_nomem;
            all_data[data_len++] = binary ? 1.0f : (float)cnt;
            r += cnt;
        }
        indptr[di + 1] = (int64_t)data_len;
    }

    {
        PyObject *py_indptr = PyBytes_FromStringAndSize(
            (const char *)indptr, (Py_ssize_t)((n_docs + 1) * sizeof(int64_t)));
        PyObject *py_indices = PyBytes_FromStringAndSize(
            (const char *)all_idx.buf, (Py_ssize_t)(data_len * sizeof(uint32_t)));
        PyObject *py_data = PyBytes_FromStringAndSize(
            (const char *)all_data, (Py_ssize_t)(data_len * sizeof(float)));
        free(indptr);
        free(all_idx.buf);
        free(all_data);
        free(doc_hashes.buf);
        if (!py_indptr || !py_indices || !py_data) {
            Py_XDECREF(py_indptr);
            Py_XDECREF(py_indices);
            Py_XDECREF(py_data);
            return NULL;
        }
        PyObject *out = PyTuple_Pack(3, py_indptr, py_indices, py_data);
        Py_DECREF(py_indptr);
        Py_DECREF(py_indices);
        Py_DECREF(py_data);
        return out;
    }

fail_nomem:
    PyErr_NoMemory();
fail:
    free(indptr);
    free(all_idx.buf);
    free(all_data);
    free(doc_hashes.buf);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"hash_docs", hash_docs, METH_VARARGS,
     "Hash documents into CSR arrays (indptr, indices, data)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fasthash", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__fasthash(void) {
    return PyModule_Create(&moduledef);
}
