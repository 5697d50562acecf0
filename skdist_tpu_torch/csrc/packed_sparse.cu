// Packed-CSR contractions for Hopper (sm_90a): X @ W and X^T @ r.
//
// Replaces the two Pallas TPU kernels of skdist_tpu/ops/pallas_sparse.py:
//   K1 packed_matvec   <- _matvec_2d  (X @ W, the loss and decision forward)
//   K2 packed_rmatvec  <- _rmatvec_2d (X^T @ r, every L-BFGS gradient)
//
// X is padded-row packed CSR: idx (n, m) int32, val (n, m) f32, padding
// (0, 0.0). The operand is a batch of T matrices of k columns each, read
// through strides, so one launch serves a whole round of T tasks
// (K = T * k output columns) without a transposed copy:
//   W[t, row, j] = W[t * w_batch_stride + row * w_row_stride + j]
// and likewise for r and for the outputs.
//
// What bounds them on the H100. Both are gathers with 2 FLOPs per packed
// entry and output column; the compulsory bytes (idx + val, the operand
// rows that idx references, the output) over 3.35 TB/s are an order of
// magnitude above the FLOPs over 67 TFLOP/s. What sets their pace in
// practice is the gather traffic that L2 serves (every entry reads k
// floats of every task: 3.6 GB for K1 and 3.2 GB for K2 at the LogReg
// grid's shape), how many gathers each thread keeps in flight, how the
// stores coalesce, and, for K2, how evenly power-law columns spread over
// the blocks. The TPU kernels rebuild dense (S, DB) blocks of X in VMEM
// for the MXU, because the TPU has no fast gather; Hopper has one, so
// neither kernel builds anything dense.
//
// Both kernels come in two forms, V = 4 and V = 1: with V = 4 a thread
// owns four consecutive j of one task and reads and writes them as one
// 16-byte vector (k % 4 == 0, operand base and strides 16-byte aligned;
// the wrapper decides); with V = 1 it owns one j. The summation order of
// an output is the same in both forms.
//
// K1: a block owns a tile of rows of one task (of a few tasks when k is
// small); each thread owns one (task, row, vector of j) output and sums its row's entries in
// stored order. The tile's idx/val are staged in shared memory in one
// pass (MV_MCHUNK covers the LogReg path's 41 entries a row); a thread
// starts MV_UNROLL independent gathers before it folds them into its sum
// in order. Threads are ordered (row, j) with j fastest, so a warp's
// stores are one contiguous run. Row tiles vary fastest in the grid, so
// the blocks in flight share a few task planes of W, whose popular
// rows then stay in the 50 MB L2; the register cap (MV_MIN_BLOCKS) keeps
// four blocks on an SM.
//
// K2: deterministic, with no float atomics, over a column-sorted (CSC)
// copy of the packed pair built once per operator (padding and explicit
// zeros dropped, which is exact) with its segment table: a column of
// more than L entries (SEGMENT_ENTRIES in the wrapper) is cut into
// segments of at most L. Two launches a call:
//   pass 1 (segments; only when there are long columns): one block per
//     (segment, chunk of output columns) sums the segment's entries in
//     stored order into a scratch row partial[segment, t * k + j].
//   pass 2 (tiles): one block per (tile of RMV_COLS consecutive columns,
//     group of tasks). A warp's lanes are (task, j vector) pairs, so a
//     column's sums for the group are one warp's work; warps take the
//     tile's columns one at a time from a shared counter, so a column of
//     many entries holds up one warp, not the block. A short column sums
//     its entries in stored order, RMV_UNROLL gathers in flight; a long
//     one sums its segments' partials in segment order. The sums gather
//     in shared memory and leave task by task as contiguous runs of
//     RMV_COLS * k floats, so an empty column costs only its share of
//     coalesced stores. Tiles run last column first, so the intercept's
//     tile starts early.
// Every output is a fixed-order sum, so two launches on the same inputs
// are bitwise equal.
//
// K1 and K2 in per-lane row form (packed_row_matvec, packed_row_rmatvec):
// the SGD mini-batch contractions, which the JAX package runs through
// _matvec_2d/_rmatvec_2d on each lane's gathered rows under its lane vmap
// (skdist_tpu/sparse.py row_matvec/row_rmatvec). Lane t owns B gathered
// packed rows (idx, val of (T, B, m), read through lane and row strides,
// so one batch shared by every lane is read in place) and its own
// operand. Neither builds the column copy K2 reads: a mini-batch is new
// at every step.
//   row matvec (K1 row form): for k / V <= ROW_GROUP_KV j vectors (the
//     SGD step's k = 1), a group of gs warp lanes per (lane, row), gs the
//     least power of two >= m (at most 32): each group thread issues its
//     strided share of the row's gathers at once, and a fixed __shfl_xor
//     tree adds the partial sums, so the order depends on m alone. Wider
//     k: one thread per (lane, row, j vector) sums its row in stored
//     order, ROW_UNROLL gathers in flight, as K1 does.
//   row rmatvec (K2 row form): the output is each lane's dense
//     (n_cols, k) plane, made by one launch (no zeroing pass on the
//     stream). One block per (slice of columns, lane or group of lanes,
//     chunk of j): it loads the lane's B * m entries' columns and values
//     at once, picks the entries on its slice's columns into a list in
//     position order (warp ballots and a scan, no atomics), groups the
//     list by column (__match_any_sync ranks, a counting scatter), then
//     streams +0.0 over its whole slice of the output and stores each
//     touched column's sum, added in position order from +0.0 with the
//     lane's g rows staged in shared memory, over it. Entries of value 0
//     (the padding) add exact zeros unless g is inf or NaN, and are left
//     out when every staged g is finite. A slice of more kept entries
//     than the list holds is taken in position-ordered chunks, each
//     chunk's sums continuing from the last. When every lane reads one
//     shared batch (lane strides 0, the SGD path's row_batch of an
//     expanded index), a block serves up to RRM_MAX_LANES lanes with one
//     filter and one grouping. Zipf-shaped text puts one popular column
//     in most rows of a batch: float atomics would serialise on it and
//     make the bits depend on timing; the runs do neither, and each sum
//     is the plain version's index_add_ order exactly, so the result is
//     bitwise repeatable and independent of the lane's slot.
// What bounds them: the row matvec's T * B * m gathers of k floats (a few
// MB at the SGD path's shape, well inside L2), so a launch; the row
// rmatvec's dense output write, T * n_cols * k * 4 bytes (21 MB for 20
// lanes at n_cols = 2**18 + 1, k = 1). Beside that write, each block
// reads the whole batch's keys from L2 to find its slice's entries.
// Fusing the L2 decay and the update into a sparse write is later work.
//
// Plain C entry points, bound with ctypes; each returns cudaGetLastError()
// after its launches and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;         // threads of a K1 block
constexpr int MV_MAX_ROWS = 64;    // rows per K1 block, at most
constexpr int MV_MCHUNK = 48;      // packed entries per row staged at a time
constexpr int MV_UNROLL = 8;       // K1 gathers in flight a thread
constexpr int MV_MIN_BLOCKS = 4;   // K1 blocks an SM must hold (register cap)

constexpr int RMV_THREADS = 256;   // threads of a K2 tile block
constexpr int RMV_COLS = 64;       // columns of a K2 tile
constexpr int RMV_STAGE = 512;     // tile entries staged in shared memory
constexpr int RMV_UNROLL = 4;      // K2 tile gathers in flight a lane
constexpr int SEG_THREADS = 128;   // threads of a K2 segment block
constexpr int SEG_CHUNK = 512;     // segment entries staged at a time
constexpr int SEG_UNROLL = 8;      // K2 segment gathers in flight a thread

constexpr unsigned MAX_GRID_YZ = 65535;

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

template <int V> __device__ __forceinline__ typename Vec<V>::T load(const float* p);
template <> __device__ __forceinline__ float load<1>(const float* p) {
    return __ldg(p);
}
template <> __device__ __forceinline__ float4 load<4>(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

template <int V> __device__ __forceinline__ typename Vec<V>::T zero();
template <> __device__ __forceinline__ float zero<1>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<4>() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float fma_v(float a, float x, float acc) {
    return fmaf(a, x, acc);
}
__device__ __forceinline__ float4 fma_v(float a, float4 x, float4 acc) {
    return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                       fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float add_v(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add_v(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// K1. Block (row tile, task group, chunk of j vectors): kvc j vectors a
// (task, row), tg tasks, `rows` rows; a thread owns one (task, row, j
// vector) output. Threads beyond rows * tg * kvc only stage.
template <int V>
__global__ void __launch_bounds__(BLOCK, MV_MIN_BLOCKS)
packed_matvec_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val, int64_t n, int m,
                     const float* __restrict__ W, int64_t w_row_stride,
                     int64_t w_batch_stride, float* __restrict__ out,
                     int64_t out_row_stride, int64_t out_batch_stride, int T,
                     int kv, int kvc, int rows, int tg) {
    using F = typename Vec<V>::T;
    __shared__ int32_t s_idx[MV_MAX_ROWS][MV_MCHUNK + 1];
    __shared__ float s_val[MV_MAX_ROWS][MV_MCHUNK + 1];

    const int64_t row0 = (int64_t)blockIdx.x * rows;
    const int tid = threadIdx.x;
    const int jv = tid % kvc;
    const int rest = tid / kvc;
    const int rl = rest % rows;
    const int tt = rest / rows;
    const int64_t t = (int64_t)blockIdx.y * tg + tt;
    const int64_t jvec = (int64_t)blockIdx.z * kvc + jv;
    const int64_t row = row0 + rl;
    const bool live = tt < tg && t < T && row < n && jvec < kv;
    const float* Wt = W + t * w_batch_stride + jvec * V;

    F acc = zero<V>();
    for (int m0 = 0; m0 < m; m0 += MV_MCHUNK) {
        const int mc = min(MV_MCHUNK, m - m0);
        for (int e = tid; e < rows * MV_MCHUNK; e += BLOCK) {
            const int r = e / MV_MCHUNK;
            const int q = e % MV_MCHUNK;
            const int64_t i = row0 + r;
            const bool ok = i < n && q < mc;
            s_idx[r][q] = ok ? idx[i * m + m0 + q] : 0;
            s_val[r][q] = ok ? val[i * m + m0 + q] : 0.f;
        }
        __syncthreads();
        if (live) {
            const int32_t* si = s_idx[rl];
            const float* sv = s_val[rl];
            int q = 0;
            for (; q + MV_UNROLL <= mc; q += MV_UNROLL) {
                F x[MV_UNROLL];
#pragma unroll
                for (int u = 0; u < MV_UNROLL; ++u)
                    x[u] = load<V>(Wt + (int64_t)si[q + u] * w_row_stride);
#pragma unroll
                for (int u = 0; u < MV_UNROLL; ++u) acc = fma_v(sv[q + u], x[u], acc);
            }
            for (; q < mc; ++q)
                acc = fma_v(sv[q], load<V>(Wt + (int64_t)si[q] * w_row_stride), acc);
        }
        __syncthreads();
    }
    if (live) store(out + t * out_batch_stride + row * out_row_stride + jvec * V, acc);
}

// K2 pass 1: one block per (segment, chunk of SEG_THREADS * V output
// columns c = t * k + j); partial[s, c] = the segment's entries summed in
// stored order.
template <int V>
__global__ void __launch_bounds__(SEG_THREADS)
packed_rmatvec_segment_kernel(const int64_t* __restrict__ seg_lo,
                              const int64_t* __restrict__ seg_hi,
                              const int32_t* __restrict__ rows,
                              const float* __restrict__ vals,
                              const float* __restrict__ r, int64_t r_row_stride,
                              int64_t r_batch_stride,
                              float* __restrict__ partial, int k, int64_t K) {
    using F = typename Vec<V>::T;
    __shared__ int32_t s_row[SEG_CHUNK];
    __shared__ float s_val[SEG_CHUNK];

    const int64_t s = blockIdx.x;
    const int64_t c = ((int64_t)blockIdx.y * SEG_THREADS + threadIdx.x) * V;
    const bool live = c < K;
    const int64_t t = live ? c / k : 0;
    const int64_t j = live ? c - t * k : 0;
    const float* rt = r + t * r_batch_stride + j;
    const int64_t lo = seg_lo[s];
    const int64_t hi = seg_hi[s];

    F acc = zero<V>();
    for (int64_t b = lo; b < hi; b += SEG_CHUNK) {
        const int ec = (int)min((int64_t)SEG_CHUNK, hi - b);
        for (int q = threadIdx.x; q < ec; q += SEG_THREADS) {
            s_row[q] = rows[b + q];
            s_val[q] = vals[b + q];
        }
        __syncthreads();
        if (live) {
            int q = 0;
            for (; q + SEG_UNROLL <= ec; q += SEG_UNROLL) {
                F x[SEG_UNROLL];
#pragma unroll
                for (int u = 0; u < SEG_UNROLL; ++u)
                    x[u] = load<V>(rt + (int64_t)s_row[q + u] * r_row_stride);
#pragma unroll
                for (int u = 0; u < SEG_UNROLL; ++u) acc = fma_v(s_val[q + u], x[u], acc);
            }
            for (; q < ec; ++q)
                acc = fma_v(s_val[q], load<V>(rt + (int64_t)s_row[q] * r_row_stride), acc);
        }
        __syncthreads();
    }
    if (live) store(partial + s * K + c, acc);
}

template <bool SHARED>
__device__ __forceinline__ int32_t entry_row(const int32_t* p) {
    return SHARED ? *p : __ldg(p);
}
template <bool SHARED>
__device__ __forceinline__ float entry_val(const float* p) {
    return SHARED ? *p : __ldg(p);
}

// A short column of the tile pass, for one lane: entries [e0, e1) of
// (rows, vals) in stored order, RMV_UNROLL gathers in flight.
template <int V, bool SHARED>
__device__ __forceinline__ void sum_entries(typename Vec<V>::T& acc,
                                            const int32_t* rows,
                                            const float* vals, int64_t e0,
                                            int64_t e1, const float* rt,
                                            int64_t r_row_stride, bool live) {
    using F = typename Vec<V>::T;
    int64_t e = e0;
    for (; e + RMV_UNROLL <= e1; e += RMV_UNROLL) {
        F x[RMV_UNROLL];
        float v[RMV_UNROLL];
#pragma unroll
        for (int u = 0; u < RMV_UNROLL; ++u) {
            v[u] = entry_val<SHARED>(vals + e + u);
            const int64_t o = (int64_t)entry_row<SHARED>(rows + e + u) * r_row_stride;
            x[u] = live ? load<V>(rt + o) : zero<V>();
        }
#pragma unroll
        for (int u = 0; u < RMV_UNROLL; ++u) acc = fma_v(v[u], x[u], acc);
    }
    for (; e < e1; ++e) {
        const int64_t o = (int64_t)entry_row<SHARED>(rows + e) * r_row_stride;
        acc = fma_v(entry_val<SHARED>(vals + e), live ? load<V>(rt + o) : zero<V>(),
                    acc);
    }
}

// K2 pass 2: one block per (tile of RMV_COLS columns, group of tw tasks,
// chunk of kvc j vectors), tiles in reverse order. A warp's lanes are the
// (task, j vector) pairs of the group, so one column's sums for the
// group are one warp's work; each warp takes the tile's columns one at a
// time from a shared counter, so a column of many entries holds up one
// warp while the others go on. The tile's entries are staged in shared
// memory when they fit (a tile that holds a long column's entries reads
// its short columns from global memory; staging saves ~3% of this pass
// at the LogReg grid's shape, PERF.md), and so are its sums, which the
// block then writes task by task as contiguous runs of the output.
template <int V>
__global__ void __launch_bounds__(RMV_THREADS)
packed_rmatvec_tile_kernel(const int64_t* __restrict__ col_ptr,
                           const int32_t* __restrict__ col_seg,
                           const int32_t* __restrict__ rows,
                           const float* __restrict__ vals,
                           const float* __restrict__ partial,
                           const float* __restrict__ r, int64_t r_row_stride,
                           int64_t r_batch_stride, float* __restrict__ out,
                           int64_t out_row_stride, int64_t out_batch_stride,
                           int64_t n_cols, int T, int k, int tw, int kvc) {
    using F = typename Vec<V>::T;
    __shared__ int64_t s_ptr[RMV_COLS + 1];
    __shared__ int32_t s_seg[RMV_COLS + 1];
    __shared__ int32_t s_row[RMV_STAGE];
    __shared__ float s_val[RMV_STAGE];
    __shared__ F s_out[RMV_COLS][32];
    __shared__ int s_next;

    const int64_t c0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * RMV_COLS;
    const int nc = (int)min((int64_t)RMV_COLS, n_cols - c0);
    const int lane = threadIdx.x % 32;
    const int tt = lane / kvc;
    const int64_t t = (int64_t)blockIdx.y * tw + tt;
    const int64_t jv = (int64_t)blockIdx.z * kvc + lane % kvc;
    const bool live = tt < tw && t < T && jv * V < k;
    const int64_t j = jv * V;
    const int64_t K = (int64_t)T * k;

    for (int i = threadIdx.x; i <= nc; i += RMV_THREADS) {
        s_ptr[i] = col_ptr[c0 + i];
        s_seg[i] = col_seg[c0 + i];
    }
    if (threadIdx.x == 0) s_next = 0;
    __syncthreads();
    const int64_t base = s_ptr[0];
    const int64_t span = s_ptr[nc] - base;
    const bool staged = span <= RMV_STAGE;
    if (staged) {
        for (int i = threadIdx.x; i < span; i += RMV_THREADS) {
            s_row[i] = rows[base + i];
            s_val[i] = vals[base + i];
        }
    }
    __syncthreads();

    const float* rt = r + t * r_batch_stride + j;
    const float* pt = partial + t * k + j;
    for (;;) {
        int cl = 0;
        if (lane == 0) cl = atomicAdd(&s_next, 1);
        cl = __shfl_sync(0xffffffffu, cl, 0);
        if (cl >= nc) break;
        F acc = zero<V>();
        const int g0 = s_seg[cl], g1 = s_seg[cl + 1];
        if (g1 > g0) {
            // a long column: its segments' partials, in segment order
            int64_t g = g0;
            for (; g + RMV_UNROLL <= g1; g += RMV_UNROLL) {
                F x[RMV_UNROLL];
#pragma unroll
                for (int u = 0; u < RMV_UNROLL; ++u)
                    x[u] = live ? load<V>(pt + (g + u) * K) : zero<V>();
#pragma unroll
                for (int u = 0; u < RMV_UNROLL; ++u) acc = add_v(acc, x[u]);
            }
            for (; g < g1; ++g) acc = add_v(acc, live ? load<V>(pt + g * K) : zero<V>());
        } else if (staged) {
            sum_entries<V, true>(acc, s_row, s_val, s_ptr[cl] - base,
                                 s_ptr[cl + 1] - base, rt, r_row_stride, live);
        } else {
            sum_entries<V, false>(acc, rows, vals, s_ptr[cl], s_ptr[cl + 1], rt,
                                  r_row_stride, live);
        }
        s_out[cl][lane] = acc;
    }
    __syncthreads();
    // the tile's sums, task by task: nc * kvc vectors a task, contiguous
    // in the output when the chunk is all of k
    const int per_task = nc * kvc;
    const int nt = (int)min((int64_t)tw, T - (int64_t)blockIdx.y * tw);
    for (int i = threadIdx.x; i < nt * per_task; i += RMV_THREADS) {
        const int tq = i / per_task;
        const int cl = (i - tq * per_task) / kvc;
        const int jl = i - tq * per_task - cl * kvc;
        const int64_t jq = (int64_t)blockIdx.z * kvc + jl;
        if (jq * V < k)
            store(out + ((int64_t)blockIdx.y * tw + tq) * out_batch_stride +
                      (c0 + cl) * out_row_stride + jq * V,
                  s_out[cl][tq * kvc + jl]);
    }
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float shfl_xor(float x, int o) {
    return __shfl_xor_sync(FULL, x, o);
}
__device__ __forceinline__ float4 shfl_xor(float4 x, int o) {
    return make_float4(__shfl_xor_sync(FULL, x.x, o), __shfl_xor_sync(FULL, x.y, o),
                       __shfl_xor_sync(FULL, x.z, o), __shfl_xor_sync(FULL, x.w, o));
}

constexpr int ROW_THREADS = 256;     // threads of a row-matvec block
constexpr int ROW_GROUP_KV = 4;      // j vectors of the group form, at most
constexpr int ROW_UNROLL = 8;        // gathers in flight a thread (thread form)

// K1 row form, group form (k / V <= ROW_GROUP_KV). A group of gs lanes of
// a warp (gs = the least power of two >= m, at most 32) owns one (lane,
// row): group thread r sums entries r, r + gs, ... of the row for each of
// its kv j vectors, every gather issued at once, and a fixed __shfl_xor
// tree over the group adds the partial sums. The order depends on m
// alone, so a lane's bits do not depend on its slot.
template <int V>
__global__ void __launch_bounds__(ROW_THREADS)
packed_row_matvec_group_kernel(const int32_t* __restrict__ idx, int64_t i_ls,
                               int64_t i_rs, const float* __restrict__ val,
                               int64_t v_ls, int64_t v_rs, int T, int B, int m,
                               const float* __restrict__ W, int64_t w_row_stride,
                               int64_t w_batch_stride, float* __restrict__ out,
                               int k, int kv, int log_gs) {
    using F = typename Vec<V>::T;
    const int gs = 1 << log_gs;
    const int64_t gid = ((int64_t)blockIdx.x * ROW_THREADS + threadIdx.x) >> log_gs;
    const int r = threadIdx.x & (gs - 1);
    const bool live = gid < (int64_t)T * B;
    const int64_t t = live ? gid / B : 0;
    const int64_t b = live ? gid - t * B : 0;
    F acc[ROW_GROUP_KV];
#pragma unroll
    for (int jv = 0; jv < ROW_GROUP_KV; ++jv) acc[jv] = zero<V>();
    if (live) {
        const int32_t* ir = idx + t * i_ls + b * i_rs;
        const float* vr = val + t * v_ls + b * v_rs;
        const float* Wt = W + t * w_batch_stride;
#pragma unroll 2
        for (int q = r; q < m; q += gs) {
            const float v = __ldg(vr + q);
            const float* wr = Wt + (int64_t)__ldg(ir + q) * w_row_stride;
#pragma unroll
            for (int jv = 0; jv < ROW_GROUP_KV; ++jv)
                if (jv < kv) acc[jv] = fma_v(v, load<V>(wr + jv * V), acc[jv]);
        }
    }
    for (int o = gs >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int jv = 0; jv < ROW_GROUP_KV; ++jv) acc[jv] = add_v(acc[jv], shfl_xor(acc[jv], o));
    }
    if (live && r == 0) {
#pragma unroll
        for (int jv = 0; jv < ROW_GROUP_KV; ++jv)
            if (jv < kv) store(out + gid * k + jv * V, acc[jv]);
    }
}

// K1 row form, thread form (wider k). Block (lane, tile of ROW_THREADS
// (row, j vector) outputs); a thread sums its row's m entries in stored
// order, ROW_UNROLL gathers in flight.
template <int V>
__global__ void __launch_bounds__(ROW_THREADS)
packed_row_matvec_kernel(const int32_t* __restrict__ idx, int64_t i_ls,
                         int64_t i_rs, const float* __restrict__ val,
                         int64_t v_ls, int64_t v_rs, int B, int m,
                         const float* __restrict__ W, int64_t w_row_stride,
                         int64_t w_batch_stride, float* __restrict__ out,
                         int k, int kv) {
    using F = typename Vec<V>::T;
    const int64_t t = blockIdx.x;
    const int64_t u = (int64_t)blockIdx.y * ROW_THREADS + threadIdx.x;
    if (u >= (int64_t)B * kv) return;
    const int b = (int)(u / kv);
    const int jv = (int)(u - (int64_t)b * kv);
    const int32_t* ir = idx + t * i_ls + (int64_t)b * i_rs;
    const float* vr = val + t * v_ls + (int64_t)b * v_rs;
    const float* Wt = W + t * w_batch_stride + (int64_t)jv * V;
    F acc = zero<V>();
    int q = 0;
    for (; q + ROW_UNROLL <= m; q += ROW_UNROLL) {
        F x[ROW_UNROLL];
#pragma unroll
        for (int e = 0; e < ROW_UNROLL; ++e)
            x[e] = load<V>(Wt + (int64_t)__ldg(ir + q + e) * w_row_stride);
#pragma unroll
        for (int e = 0; e < ROW_UNROLL; ++e) acc = fma_v(__ldg(vr + q + e), x[e], acc);
    }
    for (; q < m; ++q)
        acc = fma_v(__ldg(vr + q), load<V>(Wt + (int64_t)__ldg(ir + q) * w_row_stride),
                    acc);
    store(out + (t * B + b) * k + (int64_t)jv * V, acc);
}

// n / d for 0 <= n < 2**31 by a multiply-high and a shift (the round-up
// method of Hacker's Delight 10-9, as PyTorch's IntDivider): the row
// rmatvec divides every entry position by m.
struct DivM {
    uint32_t magic, shift;
    explicit DivM(uint32_t d) {
        shift = 0;
        while (shift < 32 && (1ull << shift) < d) ++shift;
        magic = (uint32_t)((((1ull << 32) * ((1ull << shift) - d)) / d) + 1);
    }
    __device__ __forceinline__ int operator()(int n) const {
        return (int)((__umulhi((uint32_t)n, magic) + (uint32_t)n) >> shift);
    }
};

constexpr int RRM_THREADS = 256;                      // threads of a row-rmatvec block
constexpr int RRM_MIN_BLOCKS = 4;                     // row-rmatvec blocks an SM must hold
constexpr int RRM_WARPS = RRM_THREADS / 32;
constexpr int RRM_ITEMS = 2;                          // entries a thread filters a tile
constexpr int RRM_TILE = RRM_THREADS * RRM_ITEMS;     // entries filtered a tile
constexpr int RRM_SUPER = 6;                          // tiles a thread loads at once
constexpr int RRM_PREFETCH = RRM_SUPER * RRM_ITEMS;   // entries a thread loads at once
constexpr int RRM_KEYS = RRM_TILE;                    // kept entries a block holds
constexpr int RRM_OUT = 16384;                        // output floats of a block
constexpr int RRM_MAX_COLS = 8192;                    // columns of a slice, at most
constexpr int RRM_MIN_COLS = 64;                      // columns of a slice, at least
constexpr int RRM_GSTAGE = 2048;                      // floats of g staged, at most
constexpr int RRM_MAX_LANES = 32;                     // lanes of a block (shared batch)
constexpr int RRM_KCHUNK = 32;                        // j of a block, at most
constexpr int RRM_UNROLL = 8;                         // products a run's sum takes at once
static_assert(RRM_ITEMS * RRM_WARPS <= 32, "one warp scans a tile's counts");
static_assert(RRM_GSTAGE * 4 + RRM_MAX_COLS * 2 + RRM_KEYS * 28 <= 48 * 1024,
              "the row rmatvec's shared memory fits the 48 KB default");

// K2 row form. Block (slice of S columns, group of `lanes` lanes, chunk of
// kc j); the lanes of a group share one batch (lane strides 0), so the
// filter and the grouping serve all of them. Slices run in the order 0,
// last, 1, last - 1, ...: the two hot ends (column 0 holds the padding,
// the last column the intercept) start first. Dynamic shared memory: g
// staged as g[lane][row][j] when `stage` (lanes * B * kcn floats), and
// the column -> run map (S int16). The order of the phases keeps the
// block's loads ahead of its stores: once the fill floods the memory
// system, a load waits behind it.
// 1. Loads: each thread loads the column and value of RRM_PREFETCH
//    entries at once, and the block stages g, while memory is idle.
// 2. Filter, from registers: tile by tile in position order, each warp
//    ballots its entries whose column falls in the slice, one warp scans
//    the (item, warp) counts, and the kept entries (position, value) are
//    appended to a list in position order (no atomics). An entry of
//    value 0 adds an exact zero to its sum (a sum is never -0.0) unless
//    its g is inf or NaN, so when every staged g is finite it is not
//    kept (the padding, all on column 0).
// 3. Flush (when the list would overflow, and at the end): warp 0 walks
//    the list 32 entries at a time, groups a chunk's equal columns with
//    __match_any_sync and gives each entry its run (a column, numbered
//    in order of first appearance) and its rank in the run, and scans
//    the run counts into starts; meanwhile, at the first flush, the
//    other warps stream +0.0 over the block's whole slice of the output
//    (16-byte stores where aligned). The entries are scattered into run
//    order; then one thread per (run, lane, j) adds the run's products
//    in position order, RRM_UNROLL products formed at a time, g in
//    shared memory, to the column's sum (+0.0 at the first flush, else
//    the sum the last flush stored) and stores it over the fill.
// Every sum starts from +0.0 and adds __fmul_rn products with __fadd_rn
// in position order: the plain version's index_add_ into a zeroed plane.
// Output bytes: the fill writes each once, and a touched cell's sum
// overwrites it (in the SGD step's shape ~1% of the plane).
__global__ void __launch_bounds__(RRM_THREADS, RRM_MIN_BLOCKS)
packed_row_rmatvec_kernel(const int32_t* __restrict__ idx, int64_t i_ls,
                          int64_t i_rs, const float* __restrict__ val,
                          int64_t v_ls, int64_t v_rs, int T, int B, int m,
                          const float* __restrict__ g, int64_t g_ls,
                          int64_t g_rs, float* __restrict__ out,
                          int64_t n_cols, int k, int lanes, int S, int kc,
                          bool stage, DivM div_m, int per, DivM div_per) {
    extern __shared__ float s_dyn[];
    __shared__ uint16_t s_col[RRM_KEYS];     // kept entry: column - c0
    __shared__ int32_t s_pos[RRM_KEYS];      // kept entry: position b * m + q
    __shared__ float s_val[RRM_KEYS];        // kept entry: value
    __shared__ uint16_t s_run[RRM_KEYS];     // kept entry: its run
    __shared__ uint16_t s_rank[RRM_KEYS];    // kept entry: its rank in the run
    __shared__ int32_t s_b[RRM_KEYS];        // run order: row
    __shared__ float s_v[RRM_KEYS];          // run order: value
    __shared__ uint16_t s_run_col[RRM_KEYS];
    __shared__ uint16_t s_run_cnt[RRM_KEYS];
    __shared__ uint16_t s_run_start[RRM_KEYS];
    __shared__ int s_wcnt[32];
    __shared__ int s_total, s_n_runs, s_nonfinite;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned bx = blockIdx.x;
    const int64_t slice = (bx & 1) ? (int64_t)gridDim.x - 1 - (bx >> 1) : (bx >> 1);
    const int64_t c0 = slice * S;
    const int nc = (int)min((int64_t)S, n_cols - c0);
    const int t0 = blockIdx.y * lanes;
    const int nl = min(lanes, T - t0);
    const int j0 = blockIdx.z * kc;
    const int kcn = min(kc, k - j0);
    float* s_g = s_dyn;
    int16_t* s_colrun = reinterpret_cast<int16_t*>(s_g + (stage ? lanes * B * kcn : 0));
    const int32_t* it = idx + (int64_t)t0 * i_ls;
    const float* vt = val + (int64_t)t0 * v_ls;
    const int E = B * m;

    int col[RRM_PREFETCH];   // column - c0 when in the slice, else -1
    float vv[RRM_PREFETCH];
    auto load = [&](int s0) {
#pragma unroll
        for (int u = 0; u < RRM_PREFETCH; ++u) {
            const int e = s0 + u * RRM_THREADS + tid;
            int c = -1;
            float x = 0.f;
            if (e < E) {
                const int b = div_m(e);
                const int q = e - b * m;
                const int64_t cc =
                    (int64_t)(uint32_t)__ldg(it + (int64_t)b * i_rs + q) - c0;
                x = __ldg(vt + (int64_t)b * v_rs + q);
                c = (cc >= 0 && cc < nc) ? (int)cc : -1;
            }
            col[u] = c;
            vv[u] = x;
        }
    };
    load(0);

    for (int i = tid; i < nc; i += RRM_THREADS) s_colrun[i] = -1;
    if (tid == 0) s_nonfinite = stage ? 0 : 1;
    __syncthreads();
    if (stage) {
        const int per_lane = B * kcn;
        bool bad = false;
        for (int i = tid; i < nl * per_lane; i += RRM_THREADS) {
            const int l = i / per_lane;
            const int b = (i - l * per_lane) / kcn;
            const int jj = i - l * per_lane - b * kcn;
            const float x = __ldg(g + (int64_t)(t0 + l) * g_ls + (int64_t)b * g_rs + j0 + jj);
            s_g[i] = x;
            bad |= !isfinite(x);
        }
        if (bad) s_nonfinite = 1;
    }
    __syncthreads();
    const bool drop_zeros = s_nonfinite == 0;

    // +0.0 over the block's slice of the output, by threads [f0, f0 + fn)
    auto fill = [&](int f0, int fn) {
        const int ft = tid - f0;
        if (ft < 0) return;
        if (kcn == k) {
            // a lane's slice is one contiguous run of nc * k floats: whole
            // 16-byte groups as vectors, the ragged ends as scalars (per:
            // the groups a lane's run can touch, at most)
            const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
            const int L = nc * k;
            for (int u = ft; u < nl * per; u += fn) {
                const int l = div_per(u);
                const int64_t o0 = ((int64_t)(t0 + l) * n_cols + c0) * k;
                const int64_t q0 = ((o0 >> 2) + (u - l * per)) << 2;
                if (vec && q0 >= o0 && q0 + 4 <= o0 + L) {
                    store(out + q0, make_float4(0.f, 0.f, 0.f, 0.f));
                } else {
                    const int64_t hi = min(q0 + 4, o0 + L);
                    for (int64_t q = max(q0, o0); q < hi; ++q) out[q] = 0.f;
                }
            }
        } else {
            for (int u = ft; u < nl * nc * kcn; u += fn) {
                const int jj = u % kcn;
                const int rest = u / kcn;
                const int c = rest % nc;
                const int l = rest / nc;
                out[((int64_t)(t0 + l) * n_cols + c0 + c) * k + j0 + jj] = 0.f;
            }
        }
    };

    // The filter runs super-tile by super-tile; when a tile's kept entries
    // would overflow the list, the loop stops at that tile, flushes the
    // list and comes back to the same tile (its entries are still in
    // registers), so the flush is one body of code: unrolled into every
    // tile, it made the kernel too large for the instruction cache.
    int count = 0;       // kept entries in the list (the same in every thread)
    bool first = true;   // no sum stored yet: the fill comes first, and
                         // every run starts from +0.0
    int s0 = 0, tl0 = 0;
    for (;;) {
        bool overflow = false;
        if (s0 < E) {
#pragma unroll
            for (int tl = 0; tl < RRM_SUPER; ++tl) {
                const int e0 = s0 + tl * RRM_TILE;
                if (tl < tl0) continue;
                if (e0 >= E) break;
                bool keep[RRM_ITEMS];
                unsigned bal[RRM_ITEMS];
#pragma unroll
                for (int u = 0; u < RRM_ITEMS; ++u) {
                    const int w = tl * RRM_ITEMS + u;
                    keep[u] = col[w] >= 0 && !(drop_zeros && vv[w] == 0.f);
                    bal[u] = __ballot_sync(FULL, keep[u]);
                    if (lane == 0) s_wcnt[u * RRM_WARPS + warp] = __popc(bal[u]);
                }
                __syncthreads();
                if (warp == 0) {  // (item, warp) order is position order
                    const int c = lane < RRM_ITEMS * RRM_WARPS ? s_wcnt[lane] : 0;
                    int x = c;
                    for (int o = 1; o < 32; o <<= 1) {
                        const int y = __shfl_up_sync(FULL, x, o);
                        if (lane >= o) x += y;
                    }
                    if (lane < RRM_ITEMS * RRM_WARPS) s_wcnt[lane] = x - c;
                    if (lane == 31) s_total = x;
                }
                __syncthreads();
                const int kept = s_total;
                if (count + kept > RRM_KEYS) {
                    overflow = true;
                    tl0 = tl;
                    break;
                }
#pragma unroll
                for (int u = 0; u < RRM_ITEMS; ++u) {
                    if (keep[u]) {
                        const int w = tl * RRM_ITEMS + u;
                        const int slot =
                            count + s_wcnt[u * RRM_WARPS + warp] + __popc(bal[u] & lt);
                        s_col[slot] = (uint16_t)col[w];
                        s_pos[slot] = e0 + u * RRM_THREADS + tid;
                        s_val[slot] = vv[w];
                    }
                }
                count += kept;
                __syncthreads();
            }
            if (!overflow) {
                s0 += RRM_SUPER * RRM_TILE;
                tl0 = 0;
                if (s0 < E) {
                    load(s0);
                    continue;
                }
            }
        }
        if (count == 0) break;

        // flush: warp 0 groups the list into runs while the other warps
        // fill (the first time)
        if (warp == 0) {
            int nr = 0;
            for (int base = 0; base < count; base += 32) {
                const int i = base + lane;
                const bool act = i < count;
                const int c = act ? (int)s_col[i] : -1;
                const unsigned peers = __match_any_sync(FULL, c);
                const int leader = __ffs(peers) - 1;
                const bool lead = act && lane == leader;
                int r = lead ? (int)s_colrun[c] : 0;
                const bool fresh = lead && r < 0;
                const unsigned fm = __ballot_sync(FULL, fresh);
                if (fresh) {
                    r = nr + __popc(fm & lt);
                    s_colrun[c] = (int16_t)r;
                    s_run_col[r] = (uint16_t)c;
                    s_run_cnt[r] = 0;
                }
                nr += __popc(fm);
                int have = lead ? (int)s_run_cnt[r] : 0;
                r = __shfl_sync(FULL, r, leader);
                have = __shfl_sync(FULL, have, leader);
                if (act) {
                    s_run[i] = (uint16_t)r;
                    s_rank[i] = (uint16_t)(have + __popc(peers & lt));
                }
                if (lead) s_run_cnt[r] = (uint16_t)(have + __popc(peers));
                __syncwarp();
            }
            int carry = 0;
            for (int base = 0; base < nr; base += 32) {
                const int r = base + lane;
                const int c = r < nr ? (int)s_run_cnt[r] : 0;
                int x = c;
                for (int o = 1; o < 32; o <<= 1) {
                    const int y = __shfl_up_sync(FULL, x, o);
                    if (lane >= o) x += y;
                }
                if (r < nr) s_run_start[r] = (uint16_t)(carry + x - c);
                carry += __shfl_sync(FULL, x, 31);
            }
            if (lane == 0) s_n_runs = nr;
        } else if (first) {
            fill(32, RRM_THREADS - 32);
        }
        __syncthreads();
        for (int i = tid; i < count; i += RRM_THREADS) {
            const int d = (int)s_run_start[s_run[i]] + (int)s_rank[i];
            s_b[d] = div_m(s_pos[i]);
            s_v[d] = s_val[i];
        }
        __syncthreads();
        const int nr = s_n_runs;
        for (int u = tid; u < nr * nl * kcn; u += RRM_THREADS) {
            const int jj = u % kcn;
            const int rest = u / kcn;
            const int l = rest % nl;
            const int r = rest / nl;
            float* o = out + ((int64_t)(t0 + l) * n_cols + c0 + s_run_col[r]) * k + j0 + jj;
            float s = first ? 0.f : *o;
            const int lo = s_run_start[r], hi = lo + s_run_cnt[r];
            const float* gs = s_g + l * B * kcn + jj;
            const float* gg = g + (int64_t)(t0 + l) * g_ls + j0 + jj;
            int d = lo;
            for (; d + RRM_UNROLL <= hi; d += RRM_UNROLL) {
                float pr[RRM_UNROLL];
#pragma unroll
                for (int q = 0; q < RRM_UNROLL; ++q) {
                    const int b = s_b[d + q];
                    pr[q] = __fmul_rn(s_v[d + q],
                                      stage ? gs[b * kcn] : __ldg(gg + (int64_t)b * g_rs));
                }
#pragma unroll
                for (int q = 0; q < RRM_UNROLL; ++q) s = __fadd_rn(s, pr[q]);
            }
            for (; d < hi; ++d) {
                const int b = s_b[d];
                s = __fadd_rn(s, __fmul_rn(s_v[d], stage ? gs[b * kcn]
                                                         : __ldg(gg + (int64_t)b * g_rs)));
            }
            *o = s;
        }
        for (int r = tid; r < nr; r += RRM_THREADS) s_colrun[s_run_col[r]] = -1;
        first = false;
        count = 0;
        __syncthreads();
        if (!overflow) break;
    }
    if (first) fill(0, RRM_THREADS);
}

}  // namespace

extern "C" {

// out[t, i, j] = sum_q val[i, q] * W[t, idx[i, q], j]  for i < n, t < T, j < k.
// vec 4 reads and writes j in 16-byte vectors (k % 4 == 0 and W's base
// and strides 16-byte aligned, which the caller checks), vec 1 one by one.
int skdist_packed_matvec_f32(const int32_t* idx, const float* val, int64_t n,
                             int32_t m, const float* W, int64_t w_row_stride,
                             int64_t w_batch_stride, float* out,
                             int64_t out_row_stride, int64_t out_batch_stride,
                             int32_t T, int32_t k, int32_t vec, void* stream) {
    if (n <= 0 || T <= 0 || k <= 0) return (int)cudaSuccess;
    if ((vec != 1 && vec != 4) || k % vec) return (int)cudaErrorInvalidValue;
    const int kv = k / vec;
    const int kvc = kv < BLOCK ? kv : BLOCK;
    // one task a block unless MV_MAX_ROWS rows leave threads idle
    int tg = BLOCK / (MV_MAX_ROWS * kvc);
    if (tg < 1) tg = 1;
    if (tg > T) tg = T;
    int rows = BLOCK / (tg * kvc);
    if (rows > MV_MAX_ROWS) rows = MV_MAX_ROWS;
    const int64_t gx = (n + rows - 1) / rows;
    const int64_t gy = ((int64_t)T + tg - 1) / tg;
    const int64_t gz = ((int64_t)kv + kvc - 1) / kvc;
    if (gx > 0x7fffffffLL || gy > MAX_GRID_YZ || gz > MAX_GRID_YZ)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
    cudaStream_t s = (cudaStream_t)stream;
    if (vec == 4)
        packed_matvec_kernel<4><<<grid, BLOCK, 0, s>>>(
            idx, val, n, m, W, w_row_stride, w_batch_stride, out, out_row_stride,
            out_batch_stride, T, kv, kvc, rows, tg);
    else
        packed_matvec_kernel<1><<<grid, BLOCK, 0, s>>>(
            idx, val, n, m, W, w_row_stride, w_batch_stride, out, out_row_stride,
            out_batch_stride, T, kv, kvc, rows, tg);
    return (int)cudaGetLastError();
}

// out[t, col, j] = sum_{e in column col} vals[e] * r[t, rows[e], j]
// for col < n_cols, over the column-sorted copy (col_ptr, rows, vals) and
// its segment table (col_seg: the first segment of each column, equal
// bounds for a column that is not cut; seg_lo/seg_hi: each segment's
// entries). partial is (n_segs, T * k) scratch. vec as for the matvec,
// for r.
int skdist_packed_rmatvec_f32(const int64_t* col_ptr, const int32_t* col_seg,
                              const int64_t* seg_lo, const int64_t* seg_hi,
                              const int32_t* rows, const float* vals,
                              int64_t n_cols, int64_t n_segs, const float* r,
                              int64_t r_row_stride, int64_t r_batch_stride,
                              float* partial, float* out, int64_t out_row_stride,
                              int64_t out_batch_stride, int32_t T, int32_t k,
                              int32_t vec, void* stream) {
    const int64_t K = (int64_t)T * k;
    if (n_cols <= 0 || K <= 0) return (int)cudaSuccess;
    if ((vec != 1 && vec != 4) || k % vec) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_segs > 0) {
        const int64_t per = (int64_t)SEG_THREADS * vec;
        const int64_t gy = (K + per - 1) / per;
        if (gy > MAX_GRID_YZ || n_segs > 0x7fffffffLL)
            return (int)cudaErrorInvalidConfiguration;
        dim3 grid((unsigned)n_segs, (unsigned)gy);
        if (vec == 4)
            packed_rmatvec_segment_kernel<4><<<grid, SEG_THREADS, 0, s>>>(
                seg_lo, seg_hi, rows, vals, r, r_row_stride, r_batch_stride,
                partial, k, K);
        else
            packed_rmatvec_segment_kernel<1><<<grid, SEG_THREADS, 0, s>>>(
                seg_lo, seg_hi, rows, vals, r, r_row_stride, r_batch_stride,
                partial, k, K);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int kv = k / vec;
    const int kvc = kv < 32 ? kv : 32;
    const int tw = 32 / kvc;
    const int64_t gx = (n_cols + RMV_COLS - 1) / RMV_COLS;
    const int64_t gy = ((int64_t)T + tw - 1) / tw;
    const int64_t gz = ((int64_t)kv + kvc - 1) / kvc;
    if (gx > 0x7fffffffLL || gy > MAX_GRID_YZ || gz > MAX_GRID_YZ)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
    if (vec == 4)
        packed_rmatvec_tile_kernel<4><<<grid, RMV_THREADS, 0, s>>>(
            col_ptr, col_seg, rows, vals, partial, r, r_row_stride,
            r_batch_stride, out, out_row_stride, out_batch_stride, n_cols, T, k,
            tw, kvc);
    else
        packed_rmatvec_tile_kernel<1><<<grid, RMV_THREADS, 0, s>>>(
            col_ptr, col_seg, rows, vals, partial, r, r_row_stride,
            r_batch_stride, out, out_row_stride, out_batch_stride, n_cols, T, k,
            tw, kvc);
    return (int)cudaGetLastError();
}

// out[t, i, j] = sum_q val[t, i, q] * W[t, idx[t, i, q], j] for i < B,
// t < T, j < k; idx/val element (t, i, q) at t * ls + i * rs + q. vec as
// for the matvec, for W (out is contiguous (T, B, k)). k / vec j vectors
// up to ROW_GROUP_KV take the group form, more the thread form.
int skdist_packed_row_matvec_f32(const int32_t* idx, int64_t i_ls, int64_t i_rs,
                                 const float* val, int64_t v_ls, int64_t v_rs,
                                 int32_t T, int32_t B, int32_t m, const float* W,
                                 int64_t w_row_stride, int64_t w_batch_stride,
                                 float* out, int32_t k, int32_t vec,
                                 void* stream) {
    if (T <= 0 || B <= 0 || k <= 0) return (int)cudaSuccess;
    if ((vec != 1 && vec != 4) || k % vec || m < 0) return (int)cudaErrorInvalidValue;
    const int kv = k / vec;
    cudaStream_t s = (cudaStream_t)stream;
    if (kv <= ROW_GROUP_KV) {
        int log_gs = 0;
        while (log_gs < 5 && (1 << log_gs) < m) ++log_gs;
        const int64_t threads = ((int64_t)T * B) << log_gs;
        const int64_t gx = (threads + ROW_THREADS - 1) / ROW_THREADS;
        if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        if (vec == 4)
            packed_row_matvec_group_kernel<4><<<(unsigned)gx, ROW_THREADS, 0, s>>>(
                idx, i_ls, i_rs, val, v_ls, v_rs, T, B, m, W, w_row_stride,
                w_batch_stride, out, k, kv, log_gs);
        else
            packed_row_matvec_group_kernel<1><<<(unsigned)gx, ROW_THREADS, 0, s>>>(
                idx, i_ls, i_rs, val, v_ls, v_rs, T, B, m, W, w_row_stride,
                w_batch_stride, out, k, kv, log_gs);
        return (int)cudaGetLastError();
    }
    const int64_t gy = ((int64_t)B * kv + ROW_THREADS - 1) / ROW_THREADS;
    if (gy > MAX_GRID_YZ) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)T, (unsigned)gy);
    if (vec == 4)
        packed_row_matvec_kernel<4><<<grid, ROW_THREADS, 0, s>>>(
            idx, i_ls, i_rs, val, v_ls, v_rs, B, m, W, w_row_stride,
            w_batch_stride, out, k, kv);
    else
        packed_row_matvec_kernel<1><<<grid, ROW_THREADS, 0, s>>>(
            idx, i_ls, i_rs, val, v_ls, v_rs, B, m, W, w_row_stride,
            w_batch_stride, out, k, kv);
    return (int)cudaGetLastError();
}

// out[t, c, j] = sum over the entries (i, q) of lane t with idx[t, i, q] == c
// of val[t, i, q] * g[t, i, j], in (i, q) order, for every c < n_cols (0
// where lane t has no entry); out is contiguous (T, n_cols, k), written
// once by one launch. g element (t, i, j) at t * g_ls + i * g_rs + j. When
// idx and val both have lane stride 0 (one batch shared by every lane),
// a block serves up to RRM_MAX_LANES lanes.
int skdist_packed_row_rmatvec_f32(const int32_t* idx, int64_t i_ls, int64_t i_rs,
                                  const float* val, int64_t v_ls, int64_t v_rs,
                                  int32_t T, int32_t B, int32_t m, const float* g,
                                  int64_t g_ls, int64_t g_rs, float* out,
                                  int64_t n_cols, int32_t k, void* stream) {
    if (T <= 0 || n_cols <= 0 || k <= 0) return (int)cudaSuccess;
    if (B < 0 || m < 0 || (int64_t)B * m > 0x7fffffffLL || n_cols > 0xffffffffLL)
        return (int)cudaErrorInvalidValue;
    const int nj = (k + RRM_KCHUNK - 1) / RRM_KCHUNK;
    const int kc = (k + nj - 1) / nj;
    int lanes = 1;
    if (T > 1 && i_ls == 0 && v_ls == 0) {
        lanes = T < RRM_MAX_LANES ? T : RRM_MAX_LANES;
        const int cap = RRM_OUT / (RRM_MIN_COLS * kc);
        if (lanes > cap) lanes = cap > 1 ? cap : 1;
    }
    int64_t S = RRM_OUT / (lanes * kc);
    if (S > RRM_MAX_COLS) S = RRM_MAX_COLS;
    if (S > n_cols) S = n_cols;
    const bool stage = (int64_t)lanes * B * kc <= RRM_GSTAGE;
    const size_t smem = (stage ? (size_t)lanes * B * kc * 4 : 0) + (size_t)S * 2;
    const int per = nj == 1 ? (int)(S * k / 4 + 2) : 1;  // S * k <= RRM_OUT here
    const int64_t gx = (n_cols + S - 1) / S;
    const int64_t gy = ((int64_t)T + lanes - 1) / lanes;
    if (gx > 0x7fffffffLL || gy > MAX_GRID_YZ || nj > (int)MAX_GRID_YZ)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)nj);
    packed_row_rmatvec_kernel<<<grid, RRM_THREADS, smem, (cudaStream_t)stream>>>(
        idx, i_ls, i_rs, val, v_ls, v_rs, T, B, m, g, g_ls, g_rs, out, n_cols, k,
        lanes, (int)S, kc, stage, DivM(m > 0 ? m : 1), per, DivM(per));
    return (int)cudaGetLastError();
}

const char* skdist_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
