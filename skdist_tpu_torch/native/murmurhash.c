/*
 * murmurhash: signed 32-bit MurmurHash3 (x86, 32-bit) of many byte
 * strings at once, for skdist_tpu_torch's HashingVectorizer
 * (featurize/text.py), which hashes every n-gram as scikit-learn's
 * HashingVectorizer does (murmurhash3_32(..., seed=0, positive=False)
 * over the n-gram's UTF-8 bytes).
 *
 * The n-grams of a batch of documents are spans of one concatenated
 * UTF-8 buffer: span i is buf[starts[i] : starts[i] + lengths[i]].
 * Hashing them one Python call each would dominate the vectorizer;
 * here the loop runs in C with the GIL released.
 *
 * The hash is Austin Appleby's public-domain MurmurHash3_x86_32. The
 * pure-Python form in skdist_tpu_torch/native/__init__.py
 * (murmurhash3_32_py) is held bitwise equal to this kernel and to
 * scikit-learn's by the tests.
 *
 * hash_spans(buf: bytes-like, starts: int64 buffer, lengths: int64
 *            buffer, out: int32 writable buffer, n: int, seed: int)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    h ^= h >> 16;
    return h;
}

static uint32_t murmur3_32(const unsigned char *data, int64_t len,
                           uint32_t seed) {
    const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
    const int64_t nblocks = len / 4;
    uint32_t h1 = seed, k1;
    for (int64_t i = 0; i < nblocks; i++) {
        memcpy(&k1, data + 4 * i, 4); /* little-endian hosts only */
        k1 *= c1;
        k1 = rotl32(k1, 15);
        k1 *= c2;
        h1 ^= k1;
        h1 = rotl32(h1, 13);
        h1 = h1 * 5u + 0xe6546b64u;
    }
    const unsigned char *tail = data + 4 * nblocks;
    k1 = 0;
    switch (len & 3) {
    case 3:
        k1 ^= (uint32_t)tail[2] << 16;
        /* fall through */
    case 2:
        k1 ^= (uint32_t)tail[1] << 8;
        /* fall through */
    case 1:
        k1 ^= (uint32_t)tail[0];
        k1 *= c1;
        k1 = rotl32(k1, 15);
        k1 *= c2;
        h1 ^= k1;
    }
    h1 ^= (uint32_t)len;
    return fmix32(h1);
}

static PyObject *hash_spans(PyObject *self, PyObject *args) {
    Py_buffer buf, starts_buf, lengths_buf, out_buf;
    Py_ssize_t n;
    unsigned int seed;
    if (!PyArg_ParseTuple(args, "y*y*y*w*nI", &buf, &starts_buf,
                          &lengths_buf, &out_buf, &n, &seed))
        return NULL;
    const char *err = NULL;
    if (n < 0
        || starts_buf.len < (Py_ssize_t)(n * sizeof(int64_t))
        || lengths_buf.len < (Py_ssize_t)(n * sizeof(int64_t))
        || out_buf.len < (Py_ssize_t)(n * sizeof(int32_t))) {
        err = "starts, lengths and out must hold n entries";
    } else {
        const int64_t *s = (const int64_t *)starts_buf.buf;
        const int64_t *l = (const int64_t *)lengths_buf.buf;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (s[i] < 0 || l[i] < 0 || s[i] + l[i] > (int64_t)buf.len) {
                err = "a span lies outside the buffer";
                break;
            }
        }
    }
    if (err) {
        PyBuffer_Release(&buf);
        PyBuffer_Release(&starts_buf);
        PyBuffer_Release(&lengths_buf);
        PyBuffer_Release(&out_buf);
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }
    Py_BEGIN_ALLOW_THREADS
    const unsigned char *b = (const unsigned char *)buf.buf;
    const int64_t *s = (const int64_t *)starts_buf.buf;
    const int64_t *l = (const int64_t *)lengths_buf.buf;
    int32_t *out = (int32_t *)out_buf.buf;
    for (Py_ssize_t i = 0; i < n; i++)
        out[i] = (int32_t)murmur3_32(b + s[i], l[i], (uint32_t)seed);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&buf);
    PyBuffer_Release(&starts_buf);
    PyBuffer_Release(&lengths_buf);
    PyBuffer_Release(&out_buf);
    Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"hash_spans", hash_spans, METH_VARARGS,
     "Signed MurmurHash3_x86_32 of every span of a byte buffer."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_murmurhash", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__murmurhash(void) {
    return PyModule_Create(&moduledef);
}
