/*
 * hist_tree: multithreaded per-level histogram accumulation + split
 * search for the host (CPU) forest engine of skdist_tpu_torch.
 *
 * A copy of skdist_tpu/native/hist_tree.c (the JAX package's host
 * engine), kept byte for byte in its code so the two packages' native
 * forests grow the same trees. The port's torch tree grower
 * (models/tree.py) runs the per-level histogram as K4 on the card and
 * as an index_add_ scatter on the CPU; these kernels are the CPU's
 * faster engine, hist_mode="native" (models/native_forest.py):
 *
 * hist_level — index-based accumulation, 2 adds per (sample, feature)
 * for classification instead of C=K+1 channel adds, parallelised over
 * (tree, feature) slabs with the GIL released. An optional per-(tree,
 * feature) activity mask skips features no node at this level sampled
 * (with max_features='sqrt' the union is small at shallow levels).
 *
 * best_splits — the per-level split search as ONE streaming pass over
 * the histogram (running left-accumulators per bin) instead of the
 * numpy cumsum + einsum pipeline and its histogram-sized temporaries.
 * Honors the per-(tree, feature, node) sampling mask and (ExtraTrees)
 * evaluates only the pre-drawn random threshold, computing the
 * occupied-bin range inline. Tie-breaking matches numpy argmax over a
 * feature-major (f*B + b) flattening: iteration is f-then-b ascending
 * with strictly-greater comparison.
 *
 * Contracts are mirrored by pure-numpy fallbacks in
 * models/native_forest.py / native/__init__.py (tested equal).
 *
 * Layouts: hist f32 (Tb, d, nl, B, C); XbT u8 (d, n) feature-major
 * bins; node_rel i32 (Tb, n), -1 = inactive; W f32 (Tb, n); cls i32
 * (n) or yv f32 (n); act u8 (Tb, d); fmask u8 (Tb, d, nl);
 * urand f32 (Tb, d, nl).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

#define MAX_CH 260 /* channel cap for stack accumulators (K <= 259) */

/* ------------------------------------------------------------------ */
/* hist_level                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    float *hist;
    const uint8_t *XbT;
    const int32_t *node_rel;
    const float *W;
    const int32_t *cls; /* NULL for regression */
    const float *yv;    /* NULL for classification */
    const uint8_t *act; /* NULL = all features active */
    int64_t n, d, nl, B, C;
    int64_t item0, item1; /* (t, f) flat work range */
} HistJob;

static void *hist_items(void *arg) {
    HistJob *j = (HistJob *)arg;
    const int64_t n = j->n, d = j->d, B = j->B, C = j->C;
    const int64_t slab = j->nl * B * C;
    for (int64_t item = j->item0; item < j->item1; item++) {
        const int64_t t = item / d, f = item % d;
        float *base = j->hist + item * slab;
        memset(base, 0, (size_t)slab * sizeof(float));
        if (j->act && !j->act[item])
            continue;
        const uint8_t *bins = j->XbT + f * n;
        const int32_t *nr = j->node_rel + t * n;
        const float *w = j->W + t * n;
        if (j->cls != NULL) {
            const int32_t *cls = j->cls;
            for (int64_t s = 0; s < n; s++) {
                const int32_t node = nr[s];
                const float ws = w[s];
                if (node < 0 || ws == 0.0f)
                    continue;
                float *h = base + ((int64_t)node * B + bins[s]) * C;
                h[cls[s]] += ws;
                if (ws > 0.0f)
                    h[C - 1] += 1.0f;
            }
        } else {
            const float *yv = j->yv;
            for (int64_t s = 0; s < n; s++) {
                const int32_t node = nr[s];
                const float ws = w[s];
                if (node < 0 || ws == 0.0f)
                    continue;
                float *h = base + ((int64_t)node * B + bins[s]) * C;
                const float y = yv[s];
                h[0] += ws;
                h[1] += ws * y;
                h[2] += ws * y * y;
                if (ws > 0.0f)
                    h[3] += 1.0f;
            }
        }
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* best_splits                                                         */
/* ------------------------------------------------------------------ */

typedef struct {
    const float *hist;
    const uint8_t *fmask; /* NULL = all features sampled everywhere */
    const float *urand;   /* NULL = best-split mode (not ExtraTrees) */
    float *out_gain;
    int32_t *out_f, *out_t;
    float *out_cntl, *out_cntr;
    int64_t d, nl, B, C, K;
    int classification;
    double msl; /* min_samples_leaf on the unweighted count channel */
    int64_t item0, item1; /* (t, node) flat work range */
} SplitJob;

static void *split_items(void *arg) {
    SplitJob *j = (SplitJob *)arg;
    const int64_t d = j->d, nl = j->nl, B = j->B, C = j->C, K = j->K;
    const int64_t fstride = nl * B * C;
    double tot[MAX_CH], acc[MAX_CH];
    for (int64_t item = j->item0; item < j->item1; item++) {
        const int64_t t = item / nl, node = item % nl;
        const float *tbase = j->hist + t * d * fstride + node * B * C;
        const uint8_t *fm = j->fmask ? j->fmask + (t * d) * nl + node : NULL;
        const float *ur = j->urand ? j->urand + (t * d) * nl + node : NULL;
        double best_gain = -1e30, st = 0.0, totcnt = 0.0, totw = 0.0;
        int32_t best_f = 0, best_t = 0;
        double best_cl = 0.0, best_cr = 0.0;
        int have_tot = 0;
        for (int64_t f = 0; f < d; f++) {
            if (fm && !fm[f * nl])
                continue;
            const float *h = tbase + f * fstride;
            /* pass 1: node totals (feature-independent; computed once)
               and, for ExtraTrees, this feature's occupied bin range */
            int64_t lo = 0, hi = B - 1, seen = 0;
            if (!have_tot || ur) {
                if (!have_tot)
                    for (int64_t c = 0; c < C; c++)
                        tot[c] = 0.0;
                for (int64_t b = 0; b < B; b++) {
                    const float *hb = h + b * C;
                    if (!have_tot)
                        for (int64_t c = 0; c < C; c++)
                            tot[c] += hb[c];
                    if (ur && hb[C - 1] > 0.0f) {
                        if (!seen) {
                            lo = b;
                            seen = 1;
                        }
                        hi = b;
                    }
                }
                if (!have_tot) {
                    totcnt = tot[C - 1];
                    if (j->classification) {
                        double wt = 0.0, ss = 0.0;
                        for (int64_t c = 0; c < K; c++) {
                            wt += tot[c];
                            ss += tot[c] * tot[c];
                        }
                        totw = wt;
                        st = ss / (wt > 1e-12 ? wt : 1e-12);
                    }
                    have_tot = 1;
                }
            }
            int64_t tsel = -1;
            if (ur) {
                int64_t span = hi - lo;
                if (span < 1)
                    span = 1;
                tsel = lo + (int64_t)(ur[f * nl] * (double)span);
                if (tsel > B - 2)
                    tsel = B - 2;
                if (tsel < 0)
                    tsel = 0;
            }
            /* pass 2: running left stats per threshold */
            for (int64_t c = 0; c < C; c++)
                acc[c] = 0.0;
            for (int64_t b = 0; b < B; b++) {
                const float *hb = h + b * C;
                for (int64_t c = 0; c < C; c++)
                    acc[c] += hb[c];
                if (ur && b != tsel)
                    continue;
                const double cl = acc[C - 1], cr = totcnt - cl;
                if (cl < j->msl || cr < j->msl)
                    continue;
                double gain;
                if (j->classification) {
                    double wl = 0.0, sl = 0.0, wr = 0.0, sr = 0.0;
                    for (int64_t c = 0; c < K; c++) {
                        const double l = acc[c], r = tot[c] - l;
                        wl += l;
                        sl += l * l;
                        wr += r;
                        sr += r * r;
                    }
                    sl /= (wl > 1e-12 ? wl : 1e-12);
                    sr /= (wr > 1e-12 ? wr : 1e-12);
                    gain = sl + sr - st;
                } else {
                    const double w_l = acc[0], wy_l = acc[1],
                                 wy2_l = acc[2];
                    const double w_r = tot[0] - w_l, wy_r = tot[1] - wy_l,
                                 wy2_r = tot[2] - wy2_l;
                    const double sse_l =
                        wy2_l - wy_l * wy_l / (w_l > 1e-12 ? w_l : 1e-12);
                    const double sse_r =
                        wy2_r - wy_r * wy_r / (w_r > 1e-12 ? w_r : 1e-12);
                    const double sse_t =
                        tot[2] -
                        tot[1] * tot[1] / (tot[0] > 1e-12 ? tot[0] : 1e-12);
                    gain = sse_t - (sse_l + sse_r);
                }
                if (gain > best_gain) {
                    best_gain = gain;
                    best_f = (int32_t)f;
                    best_t = (int32_t)b;
                    best_cl = cl;
                    best_cr = cr;
                }
            }
        }
        j->out_gain[item] = (float)best_gain;
        j->out_f[item] = best_f;
        j->out_t[item] = best_t;
        j->out_cntl[item] = (float)best_cl;
        j->out_cntr[item] = (float)best_cr;
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* forest_walk: predict-side tree traversal                            */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *Xb; /* (n, d) row-major bins */
    const int32_t *feat, *thr; /* (T, N) */
    const uint8_t *is_split;   /* (T, N) */
    const float *leaf;         /* (T, N, K); NULL in apply mode */
    float *out_mean;           /* (n, K) mean leaf; NULL in apply mode */
    int32_t *out_nodes;        /* (n, T) final node ids; NULL otherwise */
    int64_t n, d, T, N, K, D;
    int64_t s0, s1; /* sample range */
} WalkJob;

static void *walk_samples(void *arg) {
    WalkJob *j = (WalkJob *)arg;
    const int64_t d = j->d, T = j->T, N = j->N, K = j->K, D = j->D;
    for (int64_t s = j->s0; s < j->s1; s++) {
        const uint8_t *row = j->Xb + s * d;
        float *acc = j->out_mean ? j->out_mean + s * K : NULL;
        if (acc)
            for (int64_t c = 0; c < K; c++)
                acc[c] = 0.0f;
        for (int64_t t = 0; t < T; t++) {
            const int32_t *feat = j->feat + t * N;
            const int32_t *thr = j->thr + t * N;
            const uint8_t *sp = j->is_split + t * N;
            int32_t node = 0;
            for (int64_t lvl = 0; lvl < D; lvl++) {
                if (!sp[node])
                    break;
                node = 2 * node + 1 + (row[feat[node]] > thr[node]);
            }
            if (acc) {
                const float *lv = j->leaf + (t * N + node) * K;
                for (int64_t c = 0; c < K; c++)
                    acc[c] += lv[c];
            } else {
                j->out_nodes[s * T + t] = node;
            }
        }
        if (acc) {
            const float inv = 1.0f / (float)T;
            for (int64_t c = 0; c < K; c++)
                acc[c] *= inv;
        }
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* dispatch helpers                                                    */
/* ------------------------------------------------------------------ */

static int run_threaded(void *(*fn)(void *), void *jobs, size_t job_size,
                        int64_t *item0s, int64_t *item1s, int nt) {
    /* pthread_t is opaque (a struct on some platforms), so thread
     * liveness is tracked in a separate flag array rather than by
     * sentinel-zeroing the handles. */
    pthread_t tids[64];
    char started[64] = {0};
    for (int k = 0; k < nt; k++) {
        char *job = (char *)jobs + k * job_size;
        if (item0s[k] >= item1s[k])
            continue;
        if (k == nt - 1 || pthread_create(&tids[k], NULL, fn, job) != 0) {
            fn(job); /* last chunk (or spawn failure) runs inline */
        } else {
            started[k] = 1;
        }
    }
    for (int k = 0; k < nt; k++)
        if (started[k])
            pthread_join(tids[k], NULL);
    return 0;
}

static int clamp_threads(Py_ssize_t n_threads, int64_t n_items) {
    int nt = (int)n_threads;
    if (nt < 1)
        nt = 1;
    if (nt > 64)
        nt = 64;
    if ((int64_t)nt > n_items)
        nt = (int)(n_items > 0 ? n_items : 1);
    return nt;
}

/* ------------------------------------------------------------------ */
/* python entry points                                                 */
/* ------------------------------------------------------------------ */

static PyObject *hist_level(PyObject *self, PyObject *args) {
    Py_buffer hist_buf, xbt_buf, nr_buf, w_buf;
    Py_buffer cls_buf = {0}, yv_buf = {0}, act_buf = {0};
    Py_ssize_t n, d, Tb, nl, B, C, n_threads;
    PyObject *cls_obj, *yv_obj, *act_obj;
    if (!PyArg_ParseTuple(args, "w*y*y*y*OOOnnnnnnn", &hist_buf, &xbt_buf,
                          &nr_buf, &w_buf, &cls_obj, &yv_obj, &act_obj, &n,
                          &d, &Tb, &nl, &B, &C, &n_threads))
        return NULL;
    if (cls_obj != Py_None &&
        PyObject_GetBuffer(cls_obj, &cls_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if (yv_obj != Py_None &&
        PyObject_GetBuffer(yv_obj, &yv_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if (act_obj != Py_None &&
        PyObject_GetBuffer(act_obj, &act_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if ((cls_buf.buf == NULL) == (yv_buf.buf == NULL)) {
        PyErr_SetString(PyExc_ValueError,
                        "exactly one of cls / yv must be provided");
        goto fail;
    }
    if (hist_buf.len < (Py_ssize_t)(Tb * d * nl * B * C * sizeof(float)) ||
        xbt_buf.len < (Py_ssize_t)(d * n) ||
        nr_buf.len < (Py_ssize_t)(Tb * n * sizeof(int32_t)) ||
        w_buf.len < (Py_ssize_t)(Tb * n * sizeof(float)) ||
        (act_buf.buf && act_buf.len < (Py_ssize_t)(Tb * d))) {
        PyErr_SetString(PyExc_ValueError, "buffer too small for shape");
        goto fail;
    }

    {
        int64_t n_items = (int64_t)Tb * d;
        int nt = clamp_threads(n_threads, n_items);
        HistJob jobs[64];
        int64_t i0[64], i1[64];
        int64_t chunk = (n_items + nt - 1) / nt;
        for (int k = 0; k < nt; k++) {
            i0[k] = k * chunk;
            i1[k] = (k + 1) * chunk < n_items ? (k + 1) * chunk : n_items;
            jobs[k] = (HistJob){
                .hist = (float *)hist_buf.buf,
                .XbT = (const uint8_t *)xbt_buf.buf,
                .node_rel = (const int32_t *)nr_buf.buf,
                .W = (const float *)w_buf.buf,
                .cls = (const int32_t *)cls_buf.buf,
                .yv = (const float *)yv_buf.buf,
                .act = (const uint8_t *)act_buf.buf,
                .n = n, .d = d, .nl = nl, .B = B, .C = C,
                .item0 = i0[k], .item1 = i1[k],
            };
        }
        Py_BEGIN_ALLOW_THREADS;
        run_threaded(hist_items, jobs, sizeof(HistJob), i0, i1, nt);
        Py_END_ALLOW_THREADS;
    }

    if (cls_buf.buf)
        PyBuffer_Release(&cls_buf);
    if (yv_buf.buf)
        PyBuffer_Release(&yv_buf);
    if (act_buf.buf)
        PyBuffer_Release(&act_buf);
    PyBuffer_Release(&hist_buf);
    PyBuffer_Release(&xbt_buf);
    PyBuffer_Release(&nr_buf);
    PyBuffer_Release(&w_buf);
    Py_RETURN_NONE;

fail:
    if (cls_buf.buf)
        PyBuffer_Release(&cls_buf);
    if (yv_buf.buf)
        PyBuffer_Release(&yv_buf);
    if (act_buf.buf)
        PyBuffer_Release(&act_buf);
    PyBuffer_Release(&hist_buf);
    PyBuffer_Release(&xbt_buf);
    PyBuffer_Release(&nr_buf);
    PyBuffer_Release(&w_buf);
    return NULL;
}

static PyObject *best_splits(PyObject *self, PyObject *args) {
    Py_buffer hist_buf;
    Py_buffer fm_buf = {0}, ur_buf = {0};
    Py_buffer g_buf, f_buf, t_buf, cl_buf, cr_buf;
    Py_ssize_t Tb, d, nl, B, C, K, classification, n_threads;
    double msl;
    PyObject *fm_obj, *ur_obj;
    if (!PyArg_ParseTuple(args, "y*OOw*w*w*w*w*nnnnnnndn", &hist_buf,
                          &fm_obj, &ur_obj, &g_buf, &f_buf, &t_buf, &cl_buf,
                          &cr_buf, &Tb, &d, &nl, &B, &C, &K, &classification,
                          &msl, &n_threads))
        return NULL;
    if (fm_obj != Py_None &&
        PyObject_GetBuffer(fm_obj, &fm_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if (ur_obj != Py_None &&
        PyObject_GetBuffer(ur_obj, &ur_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if (C > MAX_CH || K > MAX_CH) {
        PyErr_SetString(PyExc_ValueError, "too many channels for C kernel");
        goto fail;
    }
    if (hist_buf.len < (Py_ssize_t)(Tb * d * nl * B * C * sizeof(float)) ||
        g_buf.len < (Py_ssize_t)(Tb * nl * sizeof(float)) ||
        f_buf.len < (Py_ssize_t)(Tb * nl * sizeof(int32_t)) ||
        t_buf.len < (Py_ssize_t)(Tb * nl * sizeof(int32_t)) ||
        cl_buf.len < (Py_ssize_t)(Tb * nl * sizeof(float)) ||
        cr_buf.len < (Py_ssize_t)(Tb * nl * sizeof(float)) ||
        (fm_buf.buf && fm_buf.len < (Py_ssize_t)(Tb * d * nl)) ||
        (ur_buf.buf &&
         ur_buf.len < (Py_ssize_t)(Tb * d * nl * sizeof(float)))) {
        PyErr_SetString(PyExc_ValueError, "buffer too small for shape");
        goto fail;
    }

    {
        int64_t n_items = (int64_t)Tb * nl;
        int nt = clamp_threads(n_threads, n_items);
        SplitJob jobs[64];
        int64_t i0[64], i1[64];
        int64_t chunk = (n_items + nt - 1) / nt;
        for (int k = 0; k < nt; k++) {
            i0[k] = k * chunk;
            i1[k] = (k + 1) * chunk < n_items ? (k + 1) * chunk : n_items;
            jobs[k] = (SplitJob){
                .hist = (const float *)hist_buf.buf,
                .fmask = (const uint8_t *)fm_buf.buf,
                .urand = (const float *)ur_buf.buf,
                .out_gain = (float *)g_buf.buf,
                .out_f = (int32_t *)f_buf.buf,
                .out_t = (int32_t *)t_buf.buf,
                .out_cntl = (float *)cl_buf.buf,
                .out_cntr = (float *)cr_buf.buf,
                .d = d, .nl = nl, .B = B, .C = C, .K = K,
                .classification = (int)classification,
                .msl = msl,
                .item0 = i0[k], .item1 = i1[k],
            };
        }
        Py_BEGIN_ALLOW_THREADS;
        run_threaded(split_items, jobs, sizeof(SplitJob), i0, i1, nt);
        Py_END_ALLOW_THREADS;
    }

    if (fm_buf.buf)
        PyBuffer_Release(&fm_buf);
    if (ur_buf.buf)
        PyBuffer_Release(&ur_buf);
    PyBuffer_Release(&hist_buf);
    PyBuffer_Release(&g_buf);
    PyBuffer_Release(&f_buf);
    PyBuffer_Release(&t_buf);
    PyBuffer_Release(&cl_buf);
    PyBuffer_Release(&cr_buf);
    Py_RETURN_NONE;

fail:
    if (fm_buf.buf)
        PyBuffer_Release(&fm_buf);
    if (ur_buf.buf)
        PyBuffer_Release(&ur_buf);
    PyBuffer_Release(&hist_buf);
    PyBuffer_Release(&g_buf);
    PyBuffer_Release(&f_buf);
    PyBuffer_Release(&t_buf);
    PyBuffer_Release(&cl_buf);
    PyBuffer_Release(&cr_buf);
    return NULL;
}

static PyObject *forest_walk(PyObject *self, PyObject *args) {
    Py_buffer xb_buf, feat_buf, thr_buf, sp_buf;
    Py_buffer leaf_buf = {0}, mean_buf = {0}, nodes_buf = {0};
    PyObject *leaf_obj, *mean_obj, *nodes_obj;
    Py_ssize_t n, d, T, N, K, D, n_threads;
    if (!PyArg_ParseTuple(args, "y*y*y*y*OOOnnnnnnn", &xb_buf, &feat_buf,
                          &thr_buf, &sp_buf, &leaf_obj, &mean_obj,
                          &nodes_obj, &n, &d, &T, &N, &K, &D, &n_threads))
        return NULL;
    if (leaf_obj != Py_None &&
        PyObject_GetBuffer(leaf_obj, &leaf_buf, PyBUF_SIMPLE) < 0)
        goto fail;
    if (mean_obj != Py_None &&
        PyObject_GetBuffer(mean_obj, &mean_buf, PyBUF_WRITABLE) < 0)
        goto fail;
    if (nodes_obj != Py_None &&
        PyObject_GetBuffer(nodes_obj, &nodes_buf, PyBUF_WRITABLE) < 0)
        goto fail;
    if ((mean_buf.buf == NULL) == (nodes_buf.buf == NULL) ||
        (mean_buf.buf != NULL && leaf_buf.buf == NULL)) {
        PyErr_SetString(PyExc_ValueError,
                        "need exactly one of out_mean (with leaf) / "
                        "out_nodes");
        goto fail;
    }
    if (xb_buf.len < (Py_ssize_t)(n * d) ||
        feat_buf.len < (Py_ssize_t)(T * N * sizeof(int32_t)) ||
        thr_buf.len < (Py_ssize_t)(T * N * sizeof(int32_t)) ||
        sp_buf.len < (Py_ssize_t)(T * N) ||
        (leaf_buf.buf &&
         leaf_buf.len < (Py_ssize_t)(T * N * K * sizeof(float))) ||
        (mean_buf.buf &&
         mean_buf.len < (Py_ssize_t)(n * K * sizeof(float))) ||
        (nodes_buf.buf &&
         nodes_buf.len < (Py_ssize_t)(n * T * sizeof(int32_t)))) {
        PyErr_SetString(PyExc_ValueError, "buffer too small for shape");
        goto fail;
    }

    {
        int nt = clamp_threads(n_threads, n);
        WalkJob jobs[64];
        int64_t i0[64], i1[64];
        int64_t chunk = (n + nt - 1) / nt;
        for (int k = 0; k < nt; k++) {
            i0[k] = k * chunk;
            i1[k] = (k + 1) * chunk < n ? (k + 1) * chunk : n;
            jobs[k] = (WalkJob){
                .Xb = (const uint8_t *)xb_buf.buf,
                .feat = (const int32_t *)feat_buf.buf,
                .thr = (const int32_t *)thr_buf.buf,
                .is_split = (const uint8_t *)sp_buf.buf,
                .leaf = (const float *)leaf_buf.buf,
                .out_mean = (float *)mean_buf.buf,
                .out_nodes = (int32_t *)nodes_buf.buf,
                .n = n, .d = d, .T = T, .N = N, .K = K, .D = D,
                .s0 = i0[k], .s1 = i1[k],
            };
        }
        Py_BEGIN_ALLOW_THREADS;
        run_threaded(walk_samples, jobs, sizeof(WalkJob), i0, i1, nt);
        Py_END_ALLOW_THREADS;
    }

    if (leaf_buf.buf)
        PyBuffer_Release(&leaf_buf);
    if (mean_buf.buf)
        PyBuffer_Release(&mean_buf);
    if (nodes_buf.buf)
        PyBuffer_Release(&nodes_buf);
    PyBuffer_Release(&xb_buf);
    PyBuffer_Release(&feat_buf);
    PyBuffer_Release(&thr_buf);
    PyBuffer_Release(&sp_buf);
    Py_RETURN_NONE;

fail:
    if (leaf_buf.buf)
        PyBuffer_Release(&leaf_buf);
    if (mean_buf.buf)
        PyBuffer_Release(&mean_buf);
    if (nodes_buf.buf)
        PyBuffer_Release(&nodes_buf);
    PyBuffer_Release(&xb_buf);
    PyBuffer_Release(&feat_buf);
    PyBuffer_Release(&thr_buf);
    PyBuffer_Release(&sp_buf);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"hist_level", hist_level, METH_VARARGS,
     "accumulate per-level (tree, feature, node, bin, channel) histograms"},
    {"best_splits", best_splits, METH_VARARGS,
     "per-(tree, node) best split from a level histogram"},
    {"forest_walk", forest_walk, METH_VARARGS,
     "tree traversal: mean leaf values or final node ids per sample"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hist_tree", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__hist_tree(void) { return PyModule_Create(&moduledef); }
