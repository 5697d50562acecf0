// Per-level tree histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of skdist_tpu/ops/pallas_hist.py
// (level_histogram, pallas_call at :124). For a round of T trees that
// share the binned features:
//
//   hist[t, f, j, b, c] = sum_i [Xb[i, f] == b] * [key[t, i] == j] * Ych[t, i, c]
//
// Xb (n, d) bins, uint8 or int32, read through strides (fastest as uint8
// rows padded to 16 bytes, x_feat_stride 1); key (T, n) int32 node ids
// relative to the level start, where a key outside [0, nl) means "not at
// this level"; Ych (T, n, C) f32 channels. Output (T, d, nl, B, C) f32, contiguous. A bin
// outside [0, B) adds nothing (it matches no column of the TPU kernel's
// one-hot).
//
// What bounds it on the H100: n * d * C adds per tree against the bytes
// of key, Ych, Xb and the output; at the forest's deepest level (T=256,
// n=200000, d=28, nl=128, B=32, C=3) that is 4.3e9 adds and ~1.2 GB, so
// the bound is bytes (~0.36 ms at 3.35 TB/s). Neither sets the pace. What
// does is the rate of shared-memory updates (each a read-modify-write of
// a random cell) and the instructions around them. The first design read
// one sample at a time, each load waiting on the one before (with no
// update at all its loop took 5-7 ms a level), re-read every sample once
// per group of two features at the deep levels, and added floats with
// atomicAdd, which sm_90 compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN): 8-13 ms a level.
//
// The design. The TPU kernel builds both one-hot factors in VMEM and
// contracts them on the MXU, because the TPU has no fast scatter; Hopper
// has shared-memory atomics, so nothing dense is built. One block of 1024
// threads (one an SM) owns one tile of the output in 227 KB of shared
// memory: every feature x as many of the level's nodes as fit, of one
// tree. It adds its samples' channels into that privatised histogram,
// then writes the tile out once.
// - Each sample read once a tree: every warp scans windows of 32 keys and
//   queues (ballot, popc) the samples at its block's nodes; the channels
//   and bins of a queued sample are read only by the block that owns its
//   node, and every lane of a warp has a sample to add. A key outside the
//   level (a finished leaf, or a sample the caller marked as weighing
//   nothing) costs one 4-byte read.
// - Loads in flight: a lane adds SPT queued samples at once and issues
//   their channel and bin loads before the first update; bins come as
//   16-byte rows of uint8 (a row-major copy, rows padded to 16 bytes, that
//   the caller makes once a round), 16 features a load.
// - Few instructions an update: a sample's nonzero channels are compacted
//   once (a classification sample has 2 of C = K + 1), converted once,
//   and each update is one predicated `red.shared` on a 32-bit shared
//   address; channel slots no lane of the warp fills are not issued.
// - Integer channels (bootstrap counts times unit weights, counts: whole
//   numbers whose per-tree sums stay below 2**24) take int32 cells with
//   native shared atomics (ATOMS.ADD), converted to float once, on write-
//   out: exact in any order, so bitwise equal to the plain version. Which
//   channels are integral is the caller's proof (int_mask, made once a
//   round by ops/hist.py integer_channels); the others take float cells
//   and the compare-and-swap loop. Both kinds share one tile.
// - Shallow levels with float channels: R copies of every float or int
//   cell (R a power of two up to 32, copy = lane % R, the largest that
//   leaves 8 features a block), so that fewer lanes of a warp collide on
//   a cell and the compare-and-swap loop retries less; at nl = 1 all
//   lanes add into one node's B bins. The copies are summed on write-out
//   (32 by a warp a cell). Integer cells run as fast or faster without
//   copies, so an all-integer launch takes none.
// - When one node of every feature does not fit, the tile is a group of
//   features with every node (each group scans and reads every sample),
//   or one feature and a block of nodes (large B * C at a deep level).
//   When the tiles alone are too few to fill the card (the shallow
//   levels), the sample axis is cut into chunks as well, and the chunks'
//   tiles are added into a zeroed output with global atomics (exact for
//   integer channels: every partial sum is a whole number below 2**24).
// - Other layouts work through strides, at a cost: int32 bins, or uint8
//   bins not in 16-byte rows, take one scalar load a feature; more than 4
//   channels are read once a feature from L1.
//
// Determinism: integer channels give the same bits in any order. Float
// channels may change from run to run in the order of their adds, within
// the float32 summation-order bound.
//
// Plain C entry point, bound with ctypes; launches on the caller's
// stream and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int HIST_THREADS = 1024;
// shared memory of one block: one block an SM
constexpr int SMEM_BUDGET = 227 * 1024;
// fewest samples a chunk holds when the sample axis is cut
constexpr int64_t MIN_CHUNK = 2048;
constexpr unsigned MAX_GRID_YZ = 65535;
// samples a thread adds at once, and features of scalar bins loaded at
// once (more spill at the 64 registers a thread of 1024 may have)
constexpr int SPT = 2;
constexpr int FSUB = 4;
// channels held in registers; more take the generic form (NC = 0)
constexpr int CREG = 4;
// copies of float cells only where at least this many features fit with
// them
constexpr int LANE_COPY_MIN_FEATURES = 8;
// a warp's queue of sample ids: a batch and one window more
constexpr int QUEUE = SPT * 32 + 32;
constexpr int64_t QUEUE_BYTES = (int64_t)(HIST_THREADS / 32) * QUEUE * 4;

// which cells a launch holds: all int32, or float cells for the channels
// int_mask leaves out (all of them when it is 0)
enum Kind { INT_CELLS = 0, MIXED_CELLS = 1 };

// Predicated shared-memory reductions on a 32-bit shared address: no
// branch and no generic-to-shared conversion per update. The int32 form is
// native (ATOMS.ADD); sm_90 has no native shared float add, so ptxas
// expands the float form into a compare-and-swap loop.
__device__ __forceinline__ void red_s32(unsigned addr, unsigned v, bool on) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "@p red.shared.add.s32 [%0], %1;\n\t}"
        :: "r"(addr), "r"(v), "r"((int)on));
}

__device__ __forceinline__ void red_f32(unsigned addr, unsigned v, bool on) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
        "@p red.shared.add.f32 [%0], %1;\n\t}"
        :: "r"(addr), "f"(__uint_as_float(v)), "r"((int)on));
}

template <int KIND>
__device__ __forceinline__ void red_cell(unsigned addr, unsigned v,
                                         bool is_int, bool on) {
    red_s32(addr, v, on && (KIND == INT_CELLS || is_int));
    if (KIND == MIXED_CELLS) red_f32(addr, v, on && !is_int);
}

// a channel value as its cell holds it: int32 bits or float bits
__device__ __forceinline__ unsigned cell_bits(float y, bool is_int) {
    return is_int ? (unsigned)__float2int_rn(y) : __float_as_uint(y);
}

__device__ __forceinline__ float cell_value(unsigned w, bool is_int) {
    return is_int ? (float)(int)w : __uint_as_float(w);
}

// One block's view of its launch: the tile it owns and where it reads.
struct Tile {
    const int32_t* key;  // the tree's keys
    const float* y;      // the tree's channels
    const void* x;       // the bins of the tile's first feature
    int64_t x_row_stride, x_feat_stride;
    int nf, nnj, j0, B, C;
    unsigned int_mask;
    unsigned s_base;      // shared address of cell 0 (plus the lane's copy)
    unsigned bin_bytes;   // between bins of one node
    unsigned node_bytes;  // between nodes of one feature
    unsigned feat_bytes;  // between features
    int copies;
};

// bins of samples i[s], features f0 + q < t.nf, as VEC 16-byte rows or
// one scalar load each
template <typename BT, bool VEC, int NQ>
__device__ __forceinline__ void load_bins(const Tile& t, const int* i,
                                          const bool* on, int fb,
                                          uint4 (&w)[SPT], int (&b)[NQ][SPT]) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        if (VEC) {
            w[s] = on[s] ? __ldg(reinterpret_cast<const uint4*>(
                               static_cast<const uint8_t*>(t.x)
                               + (int64_t)i[s] * t.x_row_stride + fb))
                         : make_uint4(~0u, ~0u, ~0u, ~0u);
        } else {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
                b[q][s] = (on[s] && fb + q < t.nf)
                    ? (int)__ldg(static_cast<const BT*>(t.x)
                                 + (int64_t)i[s] * t.x_row_stride
                                 + (int64_t)(fb + q) * t.x_feat_stride)
                    : -1;
        }
    }
}

// Adds up to SPT * 32 queued samples (queue slots s * 32 + lane < count)
// into the tile: their channels, compacted, then every feature's bin.
template <typename BT, int KIND, int NC, bool VEC>
__device__ __forceinline__ void add_samples(const Tile& t, const int* queue,
                                            int count, int lane) {
    int i[SPT];
    bool on[SPT];
    unsigned v[SPT][NC > 0 ? NC : 1];    // nonzero channels, compacted
    unsigned off[SPT][NC > 0 ? NC : 1];  // their byte offsets in a cell
    unsigned vint[SPT];  // bit k: compacted channel k is an int32 cell
    int nz[SPT];         // how many
    unsigned row[SPT];   // shared address of the sample's node, feature 0, bin 0
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
        const int slot = s * 32 + lane;
        on[s] = slot < count;
        i[s] = on[s] ? queue[slot] : 0;
        const unsigned jl = on[s] ? (unsigned)__ldg(t.key + i[s]) - (unsigned)t.j0 : 0u;
        row[s] = t.s_base + jl * t.node_bytes;
        float y[NC > 0 ? NC : 1];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            y[c] = (on[s] && c < t.C) ? __ldg(t.y + (int64_t)i[s] * t.C + c) : 0.f;
            v[s][c] = off[s][c] = 0u;
        }
        // adding 0 is exact, so skipping it changes no sum
        nz[s] = NC > 0 ? 0 : on[s];  // the generic form reads them per update
        vint[s] = 0u;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const bool keep = y[c] != 0.f;
            const bool is_int = KIND == INT_CELLS || ((t.int_mask >> c) & 1u);
#pragma unroll
            for (int k = 0; k <= c; ++k) {
                if (keep && nz[s] == k) {
                    v[s][k] = cell_bits(y[c], is_int);
                    off[s][k] = 4u * c * t.copies;
                    vint[s] |= (unsigned)is_int << k;
                }
            }
            nz[s] += keep;
        }
        on[s] = nz[s] > 0;
    }
    // channel slots that no lane of the warp fills are not issued
    int most = 0;
#pragma unroll
    for (int s = 0; s < SPT; ++s) most = max(most, nz[s]);
    most = __reduce_max_sync(0xffffffffu, most);

    constexpr int NQ = VEC ? 16 : FSUB;  // features whose bins are loaded at once
    for (int fb = 0; fb < t.nf; fb += NQ) {
        uint4 w[SPT];
        int b[VEC ? 1 : NQ][SPT];
        load_bins<BT, VEC, VEC ? 1 : NQ>(t, i, on, fb, w, b);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (fb + q >= t.nf) break;
#pragma unroll
            for (int s = 0; s < SPT; ++s) {
                int bin;
                if (VEC) {
                    const unsigned word = q < 4 ? w[s].x : q < 8 ? w[s].y
                                        : q < 12 ? w[s].z : w[s].w;
                    bin = on[s] ? (int)((word >> (8 * (q & 3))) & 0xffu) : -1;
                } else {
                    bin = b[VEC ? 0 : q][s];
                }
                const bool ok = (unsigned)bin < (unsigned)t.B;
                const unsigned cell = row[s] + (fb + q) * t.feat_bytes
                    + (unsigned)bin * t.bin_bytes;
                if (NC > 0) {
#pragma unroll
                    for (int k = 0; k < NC; ++k)
                        if (k < most)
                            red_cell<KIND>(cell + off[s][k], v[s][k],
                                           (vint[s] >> k) & 1u, ok && k < nz[s]);
                } else if (ok) {
                    const float* yi = t.y + (int64_t)i[s] * t.C;
                    for (int c = 0; c < t.C; ++c) {
                        const float yc = __ldg(yi + c);
                        const bool is_int = KIND == INT_CELLS
                            || (c < 32 && ((t.int_mask >> c) & 1u));
                        red_cell<KIND>(cell + 4u * c * t.copies,
                                       cell_bits(yc, is_int), is_int, yc != 0.f);
                    }
                }
            }
        }
    }
}

// NC: CREG when C <= CREG (the channels live in registers, their nonzeros
// compacted to the front), else 0 (each channel read per update, from L1).
// VEC: uint8 bins in rows of 16-byte multiples (x_feat_stride 1).
// copies: R copies of every cell (R a power of two up to 32; copy =
// lane % R).
template <typename BT, int KIND, int NC, bool VEC>
__global__ void __launch_bounds__(HIST_THREADS)
level_histogram_kernel(const BT* __restrict__ Xb, int64_t x_row_stride,
                       int64_t x_feat_stride, const int32_t* __restrict__ key,
                       const float* __restrict__ Ych,
                       float* __restrict__ out, int64_t n, int d, int nl,
                       int B, int C, unsigned int_mask, int fg, int nj,
                       int n_node_blocks, int64_t chunk, int copies,
                       int atomic_flush) {
    // a queue of sample ids per warp, then the tile's 32-bit cells
    // [nf][nnj][B][C][copies], int32 or float by channel
    extern __shared__ __align__(16) unsigned smem[];
    int* queue = reinterpret_cast<int*>(smem) + (threadIdx.x / 32) * QUEUE;
    unsigned* s_hist = smem + (HIST_THREADS / 32) * QUEUE;

    const int g = blockIdx.x;
    const int f0 = (g / n_node_blocks) * fg;
    Tile tl;
    tl.j0 = (g % n_node_blocks) * nj;
    tl.nf = min(fg, d - f0);
    tl.nnj = min(nj, nl - tl.j0);
    tl.B = B;
    tl.C = C;
    tl.int_mask = int_mask;
    tl.copies = copies;
    const int64_t t = blockIdx.z;
    const int64_t i0 = (int64_t)blockIdx.y * chunk;
    const int64_t i1 = min(n, i0 + chunk);
    const int span = tl.nnj * B * C;  // cells of one feature's tile
    const int tile = tl.nf * span * copies;

    for (int e = threadIdx.x; e < tile; e += HIST_THREADS) s_hist[e] = 0u;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    tl.key = key + t * n;
    tl.y = Ych + t * n * C;
    tl.x = Xb + (int64_t)f0 * x_feat_stride;
    tl.x_row_stride = x_row_stride;
    tl.x_feat_stride = x_feat_stride;
    tl.s_base = (unsigned)__cvta_generic_to_shared(s_hist)
        + 4u * (lane & (copies - 1));
    tl.bin_bytes = 4u * C * copies;
    tl.node_bytes = tl.bin_bytes * B;
    tl.feat_bytes = tl.node_bytes * tl.nnj;

    // each warp scans windows of 32 samples, queues those at the tile's
    // nodes, and adds them SPT * 32 at a time, every lane busy
    const unsigned below = (1u << lane) - 1u;
    int queued = 0;
    for (int64_t w0 = i0 + (threadIdx.x & ~31); w0 < i1;
         w0 += HIST_THREADS) {
        const int64_t i = w0 + lane;
        const bool here = i < i1
            && (unsigned)__ldg(tl.key + i) - (unsigned)tl.j0 < (unsigned)tl.nnj;
        const unsigned m = __ballot_sync(0xffffffffu, here);
        if (here) queue[queued + __popc(m & below)] = (int)i;
        queued += __popc(m);
        if (queued >= SPT * 32) {
            __syncwarp();
            add_samples<BT, KIND, NC, VEC>(tl, queue, SPT * 32, lane);
            queued -= SPT * 32;  // fewer than 32 left: move them to the front
            const int rest = lane < queued ? queue[SPT * 32 + lane] : 0;
            __syncwarp();
            if (lane < queued) queue[lane] = rest;
            __syncwarp();
        }
    }
    __syncwarp();
    if (queued > 0) add_samples<BT, KIND, NC, VEC>(tl, queue, queued, lane);
    __syncthreads();

    // feature fl's tile is one contiguous run of the output
    float* dst0 = out + ((t * d + f0) * (int64_t)nl + tl.j0) * B * C;
    const int cells = tl.nf * span;
    // a thread a cell (summing its copies), or with 32 copies a warp a
    // cell (lane q reads copy q)
    const int step = copies == 32 ? HIST_THREADS / 32 : HIST_THREADS;
    for (int e = copies == 32 ? threadIdx.x / 32 : threadIdx.x; e < cells;
         e += step) {
        const int c = e % C;
        const bool is_int = KIND == INT_CELLS
            || (c < 32 && ((int_mask >> c) & 1u));
        float val;
        if (copies == 32) {
            const unsigned w = s_hist[e * 32 + lane];
            if (is_int) {
                val = (float)__reduce_add_sync(0xffffffffu, (int)w);
            } else {
                val = __uint_as_float(w);
                for (int o = 16; o; o >>= 1)
                    val += __shfl_xor_sync(0xffffffffu, val, o);
            }
            if (lane != 0) continue;
        } else if (is_int) {
            int sum = 0;
            for (int q = 0; q < copies; ++q) sum += (int)s_hist[e * copies + q];
            val = (float)sum;
        } else {
            val = 0.f;
            for (int q = 0; q < copies; ++q)
                val += __uint_as_float(s_hist[e * copies + q]);
        }
        const int fl = e / span;
        float* dst = dst0 + (int64_t)fl * nl * B * C + (e - fl * span);
        if (atomic_flush) {
            if (val != 0.f) atomicAdd(dst, val);
        } else {
            *dst = val;
        }
    }
}

template <typename BT, int KIND, int NC>
int launch(const BT* Xb, int64_t x_row_stride, int64_t x_feat_stride,
           const int32_t* key, const float* Ych, float* out, int64_t n,
           int d, int nl, int B, int C, unsigned int_mask, int T,
           cudaStream_t st) {
    const size_t out_bytes = (size_t)T * d * nl * B * C * sizeof(float);
    const int64_t budget = SMEM_BUDGET - QUEUE_BYTES;
    const int64_t cell_bytes = (int64_t)B * C * 4;  // one node of one feature

    // tile: every feature and as many nodes as fit (a block scans every
    // key of its chunk and queues its own nodes' samples); when one node
    // of every feature does not fit, as many features as fit with every
    // node, else one feature and a block of nodes. Float cells take as
    // many copies (a power of two up to 32) as leave enough features room.
    int copies = 1;
    if (KIND != INT_CELLS)
        for (int r = 32; r > 1 && copies == 1; r /= 2)
            if (budget / (r * cell_bytes * nl) >= std::min(d, LANE_COPY_MIN_FEATURES))
                copies = r;
    const int64_t per_node = cell_bytes * copies;
    int fg, nj;
    if ((int64_t)d * per_node <= budget) {
        fg = d;
        nj = (int)std::min<int64_t>(nl, budget / (d * per_node));
    } else if ((int64_t)nl * per_node <= budget) {
        nj = nl;
        fg = (int)(budget / (nl * per_node));
        if (fg >= 16) fg -= fg % 16;  // groups start on a 16-byte row word
    } else {
        fg = 1;
        nj = (int)std::max<int64_t>(1, budget / per_node);
    }
    const int n_fg = (d + fg - 1) / fg;
    const int n_nb = (nl + nj - 1) / nj;
    const int64_t groups = (int64_t)n_fg * n_nb;
    const size_t smem = QUEUE_BYTES + (size_t)fg * nj * per_node;

    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    // cut the sample axis when the tiles alone give fewer than ~4 blocks
    // per SM (one resident per SM, four waves)
    const int64_t want = 4LL * std::max(n_sm, 1);
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
    // 16-byte rows of uint8 bins, each feature group starting on one (not
    // for the generic channel form, which would spill)
    const bool vec = NC > 0 && sizeof(BT) == 1 && x_feat_stride == 1
        && x_row_stride % 16 == 0 && x_row_stride >= (d + 15) / 16 * 16
        && (uintptr_t)Xb % 16 == 0 && (n_fg == 1 || fg % 16 == 0);
    auto kernel = vec ? level_histogram_kernel<BT, KIND, NC, true>
                      : level_histogram_kernel<BT, KIND, NC, false>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((unsigned)groups, (unsigned)n_chunks, (unsigned)T);
    kernel<<<grid, HIST_THREADS, smem, st>>>(
        Xb, x_row_stride, x_feat_stride, key, Ych, out, n, d, nl, B, C,
        int_mask, fg, nj, n_nb, chunk, copies, atomic_flush);
    return (int)cudaGetLastError();
}

template <typename BT, int KIND>
int by_width(const BT* Xb, int64_t x_row_stride, int64_t x_feat_stride,
             const int32_t* key, const float* Ych, float* out, int64_t n,
             int d, int nl, int B, int C, unsigned int_mask, int T,
             cudaStream_t st) {
    return C <= CREG
        ? launch<BT, KIND, CREG>(Xb, x_row_stride, x_feat_stride, key, Ych,
                                 out, n, d, nl, B, C, int_mask, T, st)
        : launch<BT, KIND, 0>(Xb, x_row_stride, x_feat_stride, key, Ych, out,
                              n, d, nl, B, C, int_mask, T, st);
}

template <typename BT>
int by_kind(const BT* Xb, int64_t x_row_stride, int64_t x_feat_stride,
            const int32_t* key, const float* Ych, float* out, int64_t n,
            int d, int nl, int B, int C, unsigned int_mask, int T,
            cudaStream_t st) {
    const unsigned all = C >= 32 ? 0xffffffffu : (1u << C) - 1u;
    if (C <= 32 && (int_mask & all) == all)
        return by_width<BT, INT_CELLS>(Xb, x_row_stride, x_feat_stride, key,
                                       Ych, out, n, d, nl, B, C, int_mask, T,
                                       st);
    return by_width<BT, MIXED_CELLS>(Xb, x_row_stride, x_feat_stride, key,
                                     Ych, out, n, d, nl, B, C, int_mask, T,
                                     st);
}

}  // namespace

extern "C" {

// out (T, d, nl, B, C) = the level histogram of every tree t < T;
// x[i, f] = Xb[i * x_row_stride + f * x_feat_stride], uint8 when
// bins_u8 is set, else int32; key (T, n) and Ych (T, n, C) contiguous.
// int_mask bit c (c < 32): every value of channel c is a whole number and
// every tree's sum of its |values| is below 2**24 (the caller's promise),
// so channel c sums in int32 cells. Returns cudaErrorInvalidValue when
// one node's (B, C) histogram exceeds a block's shared memory, or n or T
// is too large for the launch.
int skdist_level_histogram_f32(const void* Xb, int32_t bins_u8,
                               int64_t x_row_stride, int64_t x_feat_stride,
                               const int32_t* key, const float* Ych,
                               float* out, int64_t n, int32_t d, int32_t nl,
                               int32_t B, int32_t C, uint32_t int_mask,
                               int32_t T, void* stream) {
    if (T <= 0 || d <= 0 || nl <= 0 || B <= 0 || C <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    if (n <= 0) {
        return (int)cudaMemsetAsync(
            out, 0, (size_t)T * d * nl * B * C * sizeof(float), st);
    }
    if ((int64_t)B * C * 4 > SMEM_BUDGET - QUEUE_BYTES || (unsigned)T > MAX_GRID_YZ
        || n > 0x7fffffffLL - (int64_t)SPT * HIST_THREADS)
        return (int)cudaErrorInvalidValue;
    return bins_u8
        ? by_kind((const uint8_t*)Xb, x_row_stride, x_feat_stride, key, Ych,
                  out, n, d, nl, B, C, int_mask, T, st)
        : by_kind((const int32_t*)Xb, x_row_stride, x_feat_stride, key, Ych,
                  out, n, d, nl, B, C, int_mask, T, st);
}

const char* skdist_hist_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
