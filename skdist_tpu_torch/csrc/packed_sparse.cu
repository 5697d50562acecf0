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

const char* skdist_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
