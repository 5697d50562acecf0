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
// What bounds them on the H100: both are gathers with 2 FLOPs per packed
// entry and output column, so memory, not arithmetic, is the limit. The
// compulsory bytes are idx + val (n * m * 8), the operand (the rows of W
// that idx references, or r) and the output, over 3.35 TB/s; the FLOPs
// (2 * nnz * K) over 67 TFLOP/s of fp32 are an order of magnitude below.
//
// What the simple design does about it. The TPU kernels rebuild a dense
// (S, DB) block of X in VMEM and contract it on the MXU, because the TPU
// has no fast gather; Hopper has one, so neither kernel builds anything
// dense.
//   K1: one block per tile of MV_ROWS rows x MV_THREADS output columns.
//   The tile's idx/val are staged in shared memory once and reused by
//   every column thread; each thread owns one output column and sums its
//   rows' entries in a fixed order, so the W reads of a warp are
//   contiguous runs of k floats (coalesced when k is large).
//   K2: deterministic, with no float atomics: the wrapper builds a
//   column-sorted (CSC) copy of the packed pair once per operator
//   (padding and explicit zeros dropped, which is exact), and one block
//   per (column, tile of output columns) sums that column's entries in
//   stored order. Two launches on the same inputs are bitwise equal.
//   Known weakness: columns are power-law and the intercept column holds
//   all n rows, so blocks are uneven; a later PR can split long columns.
//
// Plain C entry points, bound with ctypes; each returns cudaGetLastError()
// after its launch and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MV_THREADS = 128;  // output columns per K1 block
constexpr int MV_ROWS = 8;       // rows per K1 block
constexpr int MV_MCHUNK = 64;    // packed entries per row staged at a time

constexpr int RMV_THREADS = 128;  // output columns per K2 block
constexpr int RMV_ECHUNK = 256;   // column entries staged at a time

constexpr unsigned MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(MV_THREADS)
packed_matvec_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val, int64_t n, int m,
                     const float* __restrict__ W, int64_t w_row_stride,
                     int64_t w_batch_stride, float* __restrict__ out,
                     int64_t out_row_stride, int64_t out_batch_stride,
                     int k, int64_t n_out_cols) {
    __shared__ int32_t s_idx[MV_ROWS][MV_MCHUNK];
    __shared__ float s_val[MV_ROWS][MV_MCHUNK];

    const int64_t row0 = (int64_t)blockIdx.x * MV_ROWS;
    const int64_t c = (int64_t)blockIdx.y * MV_THREADS + threadIdx.x;
    const bool live = c < n_out_cols;
    const int64_t t = live ? c / k : 0;
    const int64_t j = live ? c % k : 0;
    const float* Wc = W + t * w_batch_stride + j;

    float acc[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) acc[r] = 0.f;

    for (int m0 = 0; m0 < m; m0 += MV_MCHUNK) {
        const int mc = min(MV_MCHUNK, m - m0);
        for (int e = threadIdx.x; e < MV_ROWS * MV_MCHUNK; e += MV_THREADS) {
            const int r = e / MV_MCHUNK;
            const int q = e % MV_MCHUNK;
            const int64_t row = row0 + r;
            const bool ok = row < n && q < mc;
            s_idx[r][q] = ok ? idx[row * m + m0 + q] : 0;
            s_val[r][q] = ok ? val[row * m + m0 + q] : 0.f;
        }
        __syncthreads();
        if (live) {
#pragma unroll
            for (int r = 0; r < MV_ROWS; ++r) {
                float a = acc[r];
                for (int q = 0; q < mc; ++q) {
                    a = fmaf(s_val[r][q],
                             __ldg(Wc + (int64_t)s_idx[r][q] * w_row_stride),
                             a);
                }
                acc[r] = a;
            }
        }
        __syncthreads();
    }
    if (!live) return;
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
        const int64_t row = row0 + r;
        if (row < n) out[t * out_batch_stride + row * out_row_stride + j] = acc[r];
    }
}

__global__ void __launch_bounds__(RMV_THREADS)
packed_rmatvec_kernel(const int64_t* __restrict__ col_ptr,
                      const int32_t* __restrict__ rows,
                      const float* __restrict__ vals,
                      const float* __restrict__ r, int64_t r_row_stride,
                      int64_t r_batch_stride, float* __restrict__ out,
                      int64_t out_row_stride, int64_t out_batch_stride,
                      int k, int64_t n_out_cols) {
    __shared__ int32_t s_row[RMV_ECHUNK];
    __shared__ float s_val[RMV_ECHUNK];

    const int64_t col = blockIdx.x;
    const int64_t c = (int64_t)blockIdx.y * RMV_THREADS + threadIdx.x;
    const bool live = c < n_out_cols;
    const int64_t t = live ? c / k : 0;
    const int64_t j = live ? c % k : 0;
    const float* rc = r + t * r_batch_stride + j;
    const int64_t e0 = col_ptr[col];
    const int64_t e1 = col_ptr[col + 1];

    float acc = 0.f;
    for (int64_t b = e0; b < e1; b += RMV_ECHUNK) {
        const int ec = (int)min((int64_t)RMV_ECHUNK, e1 - b);
        for (int q = threadIdx.x; q < ec; q += RMV_THREADS) {
            s_row[q] = rows[b + q];
            s_val[q] = vals[b + q];
        }
        __syncthreads();
        if (live) {
            for (int q = 0; q < ec; ++q) {
                acc = fmaf(s_val[q], __ldg(rc + (int64_t)s_row[q] * r_row_stride),
                           acc);
            }
        }
        __syncthreads();
    }
    if (live) out[t * out_batch_stride + col * out_row_stride + j] = acc;
}

}  // namespace

extern "C" {

// out[t, i, j] = sum_q val[i, q] * W[t, idx[i, q], j]  for i < n, t < T, j < k
int skdist_packed_matvec_f32(const int32_t* idx, const float* val, int64_t n,
                             int32_t m, const float* W, int64_t w_row_stride,
                             int64_t w_batch_stride, float* out,
                             int64_t out_row_stride, int64_t out_batch_stride,
                             int32_t T, int32_t k, void* stream) {
    const int64_t K = (int64_t)T * k;
    if (n <= 0 || K <= 0) return (int)cudaSuccess;
    const int64_t gx = (n + MV_ROWS - 1) / MV_ROWS;
    const int64_t gy = (K + MV_THREADS - 1) / MV_THREADS;
    if (gy > MAX_GRID_Y || gx > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)gx, (unsigned)gy);
    packed_matvec_kernel<<<grid, MV_THREADS, 0, (cudaStream_t)stream>>>(
        idx, val, n, m, W, w_row_stride, w_batch_stride, out, out_row_stride,
        out_batch_stride, k, K);
    return (int)cudaGetLastError();
}

// out[t, col, j] = sum_{e in column col} vals[e] * r[t, rows[e], j]
// for col < n_cols, over the column-sorted copy (col_ptr, rows, vals)
int skdist_packed_rmatvec_f32(const int64_t* col_ptr, const int32_t* rows,
                              const float* vals, int64_t n_cols,
                              const float* r, int64_t r_row_stride,
                              int64_t r_batch_stride, float* out,
                              int64_t out_row_stride, int64_t out_batch_stride,
                              int32_t T, int32_t k, void* stream) {
    const int64_t K = (int64_t)T * k;
    if (n_cols <= 0 || K <= 0) return (int)cudaSuccess;
    const int64_t gy = (K + RMV_THREADS - 1) / RMV_THREADS;
    if (gy > MAX_GRID_Y || n_cols > 0x7fffffffLL)
        return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)n_cols, (unsigned)gy);
    packed_rmatvec_kernel<<<grid, RMV_THREADS, 0, (cudaStream_t)stream>>>(
        col_ptr, rows, vals, r, r_row_stride, r_batch_stride, out,
        out_row_stride, out_batch_stride, k, K);
    return (int)cudaGetLastError();
}

const char* skdist_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
