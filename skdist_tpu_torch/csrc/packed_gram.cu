// Weighted gram of packed-CSR X for Hopper (sm_90a): X^T S X.
//
// Replaces the Pallas TPU kernel of skdist_tpu/ops/pallas_sparse.py:
//   K3 packed_weighted_gram <- _gram_2d (pallas_call at :263), the
//   normal-equation matrix of the ridge family's closed form.
//
// For a round of T lanes that share X and differ in their sample
// weights sw (T, n):
//
//   G[t, u, v] = sum_i sum_{a, b : idx[i,a] = u, idx[i,b] = v}
//                    (val[i, a] * sw[t, i]) * val[i, b]
//
// (the product in that order, as the plain version multiplies it), over
// the padded-row packed pair idx/val (n, m); padding entries (0, 0.0)
// add exactly 0. Output (T, p, p) f32, contiguous.
//
// What bounds it on the H100: the dense output. At the ridge path's
// shape (n = 11314, m = 41 with the intercept, p = 2**14 + 1) a lane
// writes p * p * 4 = 1.07 GB and reads a pair table of ~14M pairs in
// ~5.3M cells (~0.25 GB) once; its 3 FLOPs per pair take the card's
// fp32 units under a microsecond. So the bound is bytes: ~0.4 ms a lane
// at 3.35 TB/s.
//
// What the simple design does about it. The TPU kernel rebuilds two
// dense (S, DB) blocks of X in VMEM and contracts them on the MXU,
// because the TPU has no fast scatter; Hopper needs none of that. The
// wrapper builds a pair table once per operator (independent of sw, so
// one table serves every lane and every round): each (row, slot a,
// slot b) with both values nonzero, keyed by its output cell
// idx[a] * p + idx[b] and stably sorted, so the rows of a cell ascend.
// The occupied cells list their key and the start of their segment.
// One launch zeroes the round's output and then runs one thread per
// (occupied cell, lane), which sums its segment in stored order with
// rounded (not fused) multiplies and adds and writes the cell once. No
// atomics: two launches on the same inputs are bitwise equal, and each
// term is bitwise the plain version's term, so integer data gives the
// plain version's result exactly.
//
// Known weaknesses, for a later PR: the intercept cell and the Zipf-head
// cells sum up to n terms in one thread while most cells hold one or
// two; each lane re-reads the table; the symmetric half is computed
// twice; the zero fill writes every cell that the sum then rewrites.
//
// Plain C entry point, bound with ctypes; it launches on the caller's
// stream and returns the first CUDA error (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRAM_THREADS = 256;  // occupied cells per block
constexpr unsigned MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(GRAM_THREADS)
packed_gram_kernel(const int64_t* __restrict__ cell_key,
                   const int64_t* __restrict__ cell_ptr,
                   const int32_t* __restrict__ rows,
                   const float* __restrict__ va,
                   const float* __restrict__ vb, int64_t n_cells,
                   const float* __restrict__ sw, int64_t sw_lane_stride,
                   float* __restrict__ out, int64_t out_lane_stride) {
    const int64_t c = (int64_t)blockIdx.x * GRAM_THREADS + threadIdx.x;
    if (c >= n_cells) return;
    const int64_t t = blockIdx.y;
    const float* swt = sw + t * sw_lane_stride;
    const int64_t e1 = cell_ptr[c + 1];
    float acc = 0.f;
    for (int64_t e = cell_ptr[c]; e < e1; ++e) {
        const float term =
            __fmul_rn(__fmul_rn(va[e], __ldg(swt + rows[e])), vb[e]);
        acc = __fadd_rn(acc, term);
    }
    out[t * out_lane_stride + cell_key[c]] = acc;
}

}  // namespace

extern "C" {

// out[t, key / p, key % p] = sum over the cell's segment of
// (va[e] * sw[t, rows[e]]) * vb[e] for every occupied cell, 0 elsewhere;
// out is T contiguous lanes of out_lane_stride (= p * p) floats, and
// sw[t, i] = sw[t * sw_lane_stride + i].
int skdist_packed_gram_f32(const int64_t* cell_key, const int64_t* cell_ptr,
                           const int32_t* rows, const float* va,
                           const float* vb, int64_t n_cells, const float* sw,
                           int64_t sw_lane_stride, float* out,
                           int64_t out_lane_stride, int32_t T, void* stream) {
    if (T <= 0 || out_lane_stride <= 0) return (int)cudaSuccess;
    if ((unsigned)T > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)T * (size_t)out_lane_stride * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
    if (n_cells <= 0) return (int)cudaSuccess;
    const int64_t gx = (n_cells + GRAM_THREADS - 1) / GRAM_THREADS;
    if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)gx, (unsigned)T);
    packed_gram_kernel<<<grid, GRAM_THREADS, 0, st>>>(
        cell_key, cell_ptr, rows, va, vb, n_cells, sw, sw_lane_stride, out,
        out_lane_stride);
    return (int)cudaGetLastError();
}

const char* skdist_gram_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
