// Per-level tree histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of skdist_tpu/ops/pallas_hist.py
// (level_histogram, pallas_call at :124). For a round of T trees that
// share the binned features:
//
//   hist[t, f, j, b, c] = sum_i [Xb[i, f] == b] * [key[t, i] == j] * Ych[t, i, c]
//
// Xb (n, d) int32 bins, read through strides; key (T, n) int32 node ids
// relative to the level start, where a key outside [0, nl) means "not at
// this level"; Ych (T, n, C) f32 channels. Output (T, d, nl, B, C) f32,
// contiguous. A bin outside [0, B) adds nothing (it matches no column of
// the TPU kernel's one-hot).
//
// What bounds it on the H100: n * d * C adds per tree against the bytes
// of key, Ych, Xb and the output; at the forest's deepest level (T=256,
// n=200000, d=28, nl=128, B=32, C=3) that is 4.3e9 adds and ~1.2 GB, so
// the bound is bytes (~0.36 ms at 3.35 TB/s).
//
// What the simple design does about it. The TPU kernel builds both
// one-hot factors in VMEM and contracts them on the MXU, because the TPU
// has no fast scatter; Hopper has fast shared-memory atomics, so nothing
// dense is built. One block owns one tile of the output: a group of
// features x the level's nodes of one tree, as many features as fit a
// shared-memory budget (at the forest's deepest level, 2 of 28). It walks
// its samples once and adds each channel into the privatised
// shared-memory histogram with atomics; then it writes the tile out once.
// Every lane of a warp does the same work for its sample, so the atomics
// run at full width; the cost is that each feature group re-reads the
// tree's keys and channels (from L2). The bins are best passed
// feature-major (x_row_stride 1), so that a warp's reads of one feature
// are contiguous. Only when one feature's nodes do not fit (large B * C
// at a deep level) is the node axis cut, and a block then skips the
// samples of other node blocks. When the tiles alone are too few to fill
// the card (the shallow levels), the sample axis is cut into chunks as
// well, and the chunks' tiles are added into a zeroed output with global
// atomics.
//
// Determinism: with integer-valued channels (bootstrap counts times unit
// weights, every sum below 2**24) all sums are exact, so the result does
// not depend on the order of the atomics and equals the plain version
// bitwise. With fractional channels the order of the adds may change
// from run to run, within the float32 summation-order bound.
//
// Plain C entry point, bound with ctypes; launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int HIST_THREADS = 512;
// shared memory of one block: two blocks of 512 threads per SM
constexpr int SMEM_BUDGET = 110 * 1024;
// the most one block may take (sm_90: 227 KB)
constexpr int SMEM_MAX = 227 * 1024;
// fewest samples a chunk holds when the sample axis is cut
constexpr int64_t MIN_CHUNK = 2048;
constexpr unsigned MAX_GRID_YZ = 65535;

__global__ void __launch_bounds__(HIST_THREADS)
level_histogram_kernel(const int32_t* __restrict__ Xb, int64_t x_row_stride,
                       int64_t x_feat_stride, const int32_t* __restrict__ key,
                       const float* __restrict__ Ych,
                       float* __restrict__ out, int64_t n, int d, int nl,
                       int B, int C, int fg, int nj, int n_node_blocks,
                       int64_t chunk, int atomic_flush) {
    extern __shared__ float s_hist[];  // [nf][nnj][B][C]

    const int g = blockIdx.x;
    const int f0 = (g / n_node_blocks) * fg;
    const int j0 = (g % n_node_blocks) * nj;
    const int nf = min(fg, d - f0);
    const int nnj = min(nj, nl - j0);
    const int64_t t = blockIdx.z;
    const int64_t i0 = (int64_t)blockIdx.y * chunk;
    const int64_t i1 = min(n, i0 + chunk);
    const int span = nnj * B * C;  // floats of one feature's tile
    const int tile = nf * span;

    for (int e = threadIdx.x; e < tile; e += HIST_THREADS) s_hist[e] = 0.f;
    __syncthreads();

    const int32_t* kt = key + t * n;
    const float* yt = Ych + t * n * C;
    const int32_t* xf = Xb + (int64_t)f0 * x_feat_stride;
    for (int64_t i = i0 + threadIdx.x; i < i1; i += HIST_THREADS) {
        const int64_t jl = (int64_t)__ldg(kt + i) - j0;
        if (jl < 0 || jl >= nnj) continue;
        const float* yi = yt + i * C;
        const int32_t* xi = xf + i * x_row_stride;
        for (int fl = 0; fl < nf; ++fl) {
            const int b = __ldg(xi + (int64_t)fl * x_feat_stride);
            if ((unsigned)b >= (unsigned)B) continue;
            float* h = s_hist + ((fl * nnj + (int)jl) * B + b) * C;
            for (int c = 0; c < C; ++c) {
                const float v = __ldg(yi + c);
                // adding 0 is exact, so skipping it changes no sum
                if (v != 0.f) atomicAdd(h + c, v);
            }
        }
    }
    __syncthreads();

    // feature fl's tile is one contiguous run of the output
    float* base = out + ((t * d + f0) * (int64_t)nl + j0) * B * C;
    for (int e = threadIdx.x; e < tile; e += HIST_THREADS) {
        const int fl = e / span;
        float* dst = base + (int64_t)fl * nl * B * C + (e - fl * span);
        if (atomic_flush) {
            if (s_hist[e] != 0.f) atomicAdd(dst, s_hist[e]);
        } else {
            *dst = s_hist[e];
        }
    }
}

}  // namespace

extern "C" {

// out (T, d, nl, B, C) = the level histogram of every tree t < T;
// x[i, f] = Xb[i * x_row_stride + f * x_feat_stride]; key (T, n) and
// Ych (T, n, C) contiguous. Returns cudaErrorInvalidValue when one
// node's (B, C) histogram exceeds a block's shared memory.
int skdist_level_histogram_f32(const int32_t* Xb, int64_t x_row_stride,
                               int64_t x_feat_stride, const int32_t* key,
                               const float* Ych, float* out, int64_t n,
                               int32_t d, int32_t nl, int32_t B, int32_t C,
                               int32_t T, void* stream) {
    if (T <= 0 || d <= 0 || nl <= 0 || B <= 0 || C <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t out_bytes = (size_t)T * d * nl * B * C * sizeof(float);
    if (n <= 0) return (int)cudaMemsetAsync(out, 0, out_bytes, st);
    const int64_t per_node = (int64_t)B * C * sizeof(float);
    if (per_node > SMEM_MAX || (unsigned)T > MAX_GRID_YZ)
        return (int)cudaErrorInvalidValue;

    // tile: every node of the level and as many features as fit; only
    // when one feature's nodes do not fit, one feature and a block of
    // nodes (then a block skips the samples of other node blocks)
    int fg, nj;
    if ((int64_t)nl * per_node <= SMEM_BUDGET) {
        nj = nl;
        fg = (int)std::min<int64_t>(d, SMEM_BUDGET / ((int64_t)nl * per_node));
    } else {
        fg = 1;
        nj = (int)std::max<int64_t>(1, SMEM_BUDGET / per_node);
    }
    const int n_fg = (d + fg - 1) / fg;
    const int n_nb = (nl + nj - 1) / nj;
    const int64_t groups = (int64_t)n_fg * n_nb;
    const size_t smem = (size_t)fg * nj * per_node;

    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    // cut the sample axis when the tiles alone give fewer than ~8 blocks
    // per SM (two resident per SM, four waves)
    const int64_t want = 8LL * std::max(n_sm, 1);
    const int64_t base = groups * T;
    int64_t n_chunks = (want + base - 1) / base;
    n_chunks = std::min<int64_t>(n_chunks, (n + MIN_CHUNK - 1) / MIN_CHUNK);
    n_chunks = std::max<int64_t>(1, std::min<int64_t>(n_chunks, MAX_GRID_YZ));
    const int64_t chunk = (n + n_chunks - 1) / n_chunks;
    n_chunks = (n + chunk - 1) / chunk;
    if (groups > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;

    const int atomic_flush = n_chunks > 1;
    if (atomic_flush) {
        cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, st);
        if (err != cudaSuccess) return (int)err;
    }
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            level_histogram_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((unsigned)groups, (unsigned)n_chunks, (unsigned)T);
    level_histogram_kernel<<<grid, HIST_THREADS, smem, st>>>(
        Xb, x_row_stride, x_feat_stride, key, Ych, out, n, d, nl, B, C, fg, nj,
        n_nb, chunk, atomic_flush);
    return (int)cudaGetLastError();
}

const char* skdist_hist_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
