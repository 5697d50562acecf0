/*
 * densify: multithreaded CSR -> dense float32 for skdist_tpu_torch.
 *
 * A copy of skdist_tpu/native/densify.c, kept byte for byte in its
 * code. scipy's .toarray() is single-threaded and dominated by the zero
 * fill; this kernel partitions rows across threads, each zero-filling
 * and scattering its own block, with the GIL released. The port's
 * sparse.sparse_to_dense_f32 routes inputs of 2**22 elements or more
 * through it before a dense product on the card.
 *
 * Contract (mirrored by the scipy form in native/__init__.py):
 * out[r, indices[j]] accumulates data[j] for j in
 * [indptr[r], indptr[r+1]) — ACCUMULATES, like scipy's toarray, so
 * duplicate column entries in a row sum rather than overwrite.
 *
 * Inputs arrive as contiguous buffers (no numpy C API dependency):
 * out f32 (n_rows*n_cols), data f32 (nnz), indices i32 or i64 (nnz),
 * indptr i64 (n_rows+1).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    float *out;
    const float *data;
    const void *indices;
    int idx_is_64;
    const int64_t *indptr;
    int64_t r0, r1, n_cols;
} Job;

static void *densify_rows(void *arg) {
    Job *j = (Job *)arg;
    memset(j->out + j->r0 * j->n_cols, 0,
           (size_t)(j->r1 - j->r0) * (size_t)j->n_cols * sizeof(float));
    if (j->idx_is_64) {
        const int64_t *idx = (const int64_t *)j->indices;
        for (int64_t r = j->r0; r < j->r1; r++) {
            float *row = j->out + r * j->n_cols;
            for (int64_t p = j->indptr[r]; p < j->indptr[r + 1]; p++)
                row[idx[p]] += j->data[p];
        }
    } else {
        const int32_t *idx = (const int32_t *)j->indices;
        for (int64_t r = j->r0; r < j->r1; r++) {
            float *row = j->out + r * j->n_cols;
            for (int64_t p = j->indptr[r]; p < j->indptr[r + 1]; p++)
                row[idx[p]] += j->data[p];
        }
    }
    return NULL;
}

static PyObject *csr_to_dense(PyObject *self, PyObject *args) {
    Py_buffer out_buf, data_buf, idx_buf, indptr_buf;
    Py_ssize_t n_rows, n_cols, idx_itemsize, n_threads;
    if (!PyArg_ParseTuple(args, "w*y*y*y*nnnn", &out_buf, &data_buf,
                          &idx_buf, &indptr_buf, &n_rows, &n_cols,
                          &idx_itemsize, &n_threads))
        return NULL;

    int ok = 1;
    const char *err = NULL;
    if (idx_itemsize != 4 && idx_itemsize != 8) {
        ok = 0; err = "indices must be int32 or int64";
    } else if ((Py_ssize_t)(indptr_buf.len / sizeof(int64_t)) < n_rows + 1) {
        ok = 0; err = "indptr too short";
    } else if (out_buf.len < (Py_ssize_t)(n_rows * n_cols * sizeof(float))) {
        ok = 0; err = "output buffer too small";
    } else {
        const int64_t *indptr = (const int64_t *)indptr_buf.buf;
        int64_t nnz = indptr[n_rows];
        if (data_buf.len < (Py_ssize_t)(nnz * sizeof(float))
            || idx_buf.len < (Py_ssize_t)(nnz * idx_itemsize)) {
            ok = 0; err = "data/indices shorter than indptr implies";
        }
    }
    if (!ok) {
        PyBuffer_Release(&out_buf);
        PyBuffer_Release(&data_buf);
        PyBuffer_Release(&idx_buf);
        PyBuffer_Release(&indptr_buf);
        PyErr_SetString(PyExc_ValueError, err);
        return NULL;
    }

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > n_rows) n_threads = n_rows > 0 ? n_rows : 1;

    Job jobs[64];
    pthread_t tids[64];
    int64_t per = n_rows / n_threads, extra = n_rows % n_threads;
    int spawned = 0;

    Py_BEGIN_ALLOW_THREADS
    int64_t r = 0;
    for (Py_ssize_t t = 0; t < n_threads; t++) {
        int64_t take = per + (t < extra ? 1 : 0);
        jobs[t] = (Job){
            .out = (float *)out_buf.buf,
            .data = (const float *)data_buf.buf,
            .indices = idx_buf.buf,
            .idx_is_64 = (idx_itemsize == 8),
            .indptr = (const int64_t *)indptr_buf.buf,
            .r0 = r, .r1 = r + take, .n_cols = n_cols,
        };
        r += take;
        if (t + 1 == n_threads) {
            densify_rows(&jobs[t]); /* run the last block inline */
        } else if (pthread_create(&tids[spawned], NULL, densify_rows,
                                  &jobs[t]) == 0) {
            spawned++; /* tids packed: joins stay aligned on failures */
        } else {
            densify_rows(&jobs[t]); /* thread spawn failed: run inline */
        }
    }
    for (int t = 0; t < spawned; t++)
        pthread_join(tids[t], NULL);
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&out_buf);
    PyBuffer_Release(&data_buf);
    PyBuffer_Release(&idx_buf);
    PyBuffer_Release(&indptr_buf);
    Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"csr_to_dense", csr_to_dense, METH_VARARGS,
     "Scatter CSR (data, indices, indptr) into a zeroed dense f32 "
     "buffer, rows partitioned across threads."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_densify", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__densify(void) {
    return PyModule_Create(&moduledef);
}
