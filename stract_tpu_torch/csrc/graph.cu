// The webgraph centrality kernels on Hopper (sm_90a): K6a HyperBall register
// merge, K6b HLL size estimate, K7 BFS relaxation, K8 the sharded HyperBall's
// ring step.
//
// K6a replaces stract_tpu/ops/hll_ops.py:50 merge_iteration (a gather of
// regs[edge_from] and a scatter-max into regs[edge_to]); its epilogue also
// computes K6b for the new rows. K6b alone replaces hll_ops.py:64
// estimate_sizes (the initial estimate). K7 replaces
// stract_tpu/webgraph/shortest_path.py:21 _relax and its vmap over sources
// (:59).
//
// Pull form, no atomics: every target row v reads the round-start rows of its
// in-neighbours u through the reverse CSR (offsets[v]..offsets[v+1] into
// sources) and writes its new row into a second buffer, so every read sees
// the round-start state (Jacobi, as the reference's gather-then-scatter).
// One int flag, zeroed before the launch, is set when any row changed; the
// host reads 4 bytes a round instead of comparing the registers.
//
// What bounds them: each round moves, once, the registers or distances in
// and out plus the CSR (K6a at 1M nodes x 64 registers and 20M edges: 128 MB
// + 80 MB of sources), but the gather reads an in-neighbour's row for every
// edge (20M x 64 B = 1.28 GB for K6a, 20M x S x 4 B for K7), from L2 when
// the row is there (50 MB L2, 64 MB of registers): the kernels are bound by
// that gather's memory traffic and its latency, far above the bytes-once
// bound. Each edge's row is read whole by neighbouring threads (64 B by 16
// threads for K6a, S x 4 B by one warp for K7 at S >= 32), so each gather is
// coalesced.
//
// In-degree skew: the Pareto targets of a web graph put most edges on few
// rows. A row with more than `long_cut` in-edges is split across a whole
// block (its groups or warps stride over the edges, then reduce in shared
// memory); every other row is walked by one group of threads. The short-row
// blocks cover all rows in order and skip the long ones; blocks past them
// take one long row each.
//
// K8, the ring step of the sharded HyperBall, replaces round_fn's step of
// stract_tpu/webgraph/centrality.py:148-165 (`out.at[let[k]].max(buf[lef[k]],
// mode="drop")` on each device, then a ppermute of the register shard). It is
// K6a's body over one (shard, ring distance) bucket: the bucket's edges are
// sorted by local target into a CSR on the host, the row's running value
// comes from `out` and the gathered rows from the ring buffer (the round-start
// shard standing at that distance, never written), so it needs no atomics and
// the registers stay bit-equal to the reference's. The round's last step
// compares each row with the round-start shard (the change flag) and
// estimates it (K6b in the epilogue). Bound like K6a: a gather per edge, over
// one shard's rows, plus the shard's rows read and written once a step.
//
// K6b's arithmetic follows the reference in f32: alpha * m * m / sum of
// 2^-r left to right, the linear-counting branch m * log(m / zeros) when the
// estimate is <= 2.5 m and zeros remain; logf and exp2f (built with
// --fmad=false, no fast-math). The sum over a row is taken in another order
// than XLA's, so sizes agree to a few f32 ulps, not bit for bit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWordsPerThread = 16;  // m <= 16 x 16 x 4 = 1024 registers
constexpr int kGroupMax = 16;           // threads per register row
constexpr int kRelaxWarps = kThreads / 32;
constexpr int kRelaxCols = 8;           // distances per lane per column tile
constexpr int kRelaxTile = 32 * kRelaxCols;

// the words a thread holds: unrolled to the compile-time maximum and guarded,
// so its array of words stays in registers
#define FOR_WORDS(k) \
    _Pragma("unroll") for (int k = 0; k < kMaxWordsPerThread; ++k) if (k < s.wpt)

struct HllShape {
    int n, W, G, wpt;  // rows, u32 words per row, threads per row, words per thread
    float m, alpha;
};

// sum of 2^-r over one row's registers, and its count of zero registers,
// reduced over the G threads of the row's group (all 32 lanes take part)
__device__ void row_sum(const uint32_t* acc, const HllShape& s, float& sum, int& zeros) {
    sum = 0.0f;
    zeros = 0;
    FOR_WORDS(k) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const unsigned r = (acc[k] >> (8 * b)) & 0xFFu;
            sum += exp2f(-static_cast<float>(r));
            zeros += r == 0;
        }
    }
    for (int o = s.G / 2; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        zeros += __shfl_xor_sync(0xffffffffu, zeros, o);
    }
}

__device__ float hll_estimate(float sum, int zeros, const HllShape& s) {
    const float est = s.alpha * s.m * s.m / sum;
    const float z = static_cast<float>(zeros);
    const float lc = s.m * logf(s.m / fmaxf(z, 1.0f));
    return (est <= 2.5f * s.m && z > 0.0f) ? lc : est;
}

// the epilogue of one row: write the new row, flag a change against `cmp`
// (when given), estimate (when `sizes` is given)
__device__ void merge_epilogue(bool valid, long long v, const uint32_t* acc, const uint32_t* cmp,
                               uint32_t* out, float* __restrict__ sizes, int* __restrict__ changed,
                               int g, const HllShape& s) {
    bool diff = false;
    if (valid) {
        FOR_WORDS(k) {
            const long long w = v * s.W + g + k * s.G;
            if (cmp != nullptr) diff |= acc[k] != cmp[w];
            out[w] = acc[k];
        }
    }
    if (sizes != nullptr) {
        float sum;
        int zeros;
        row_sum(acc, s, sum, zeros);
        if (valid && g == 0) sizes[v] = hll_estimate(sum, zeros, s);
    }
    if (diff) *changed = 1;
}

// K6a and the ring step (K8) in one body: row v of `out` becomes the bytewise
// max of `self` row v and the `src` rows of its in-edges. K6a reads self,
// src and cmp from the round-start registers; the ring step reads self from
// `out` itself (its running row) and src from the ring buffer, a different
// tensor, and compares with the round-start shard at its last step only. A
// row is read and written by the same threads, so self may be out (neither is
// __restrict__); src is never written.
__global__ void __launch_bounds__(kThreads)
hll_merge_kernel(const uint32_t* self, const uint32_t* __restrict__ src, const uint32_t* cmp,
                 const int* __restrict__ offsets, const int* __restrict__ sources,
                 const int* __restrict__ long_rows, int short_blocks, int long_cut, HllShape s,
                 uint32_t* out, float* __restrict__ sizes, int* __restrict__ changed) {
    __shared__ uint32_t s_part[kThreads * kMaxWordsPerThread];
    const int g = threadIdx.x % s.G, group = threadIdx.x / s.G, groups = kThreads / s.G;
    uint32_t acc[kMaxWordsPerThread];

    if (blockIdx.x < short_blocks) {
        // one group of G threads per row; long rows are left to their own blocks
        const long long v = static_cast<long long>(blockIdx.x) * groups + group;
        bool valid = v < s.n;
        int start = 0, end = 0;
        if (valid) {
            start = offsets[v];
            end = offsets[v + 1];
            valid = end - start <= long_cut;
        }
        FOR_WORDS(k) acc[k] = valid ? self[v * s.W + g + k * s.G] : 0u;
        for (int e = start; valid && e < end; ++e) {
            const long long u = sources[e];
            FOR_WORDS(k) acc[k] = __vmaxu4(acc[k], src[u * s.W + g + k * s.G]);
        }
        merge_epilogue(valid, v, acc, cmp, out, sizes, changed, g, s);
        return;
    }

    // a long row: the block's groups stride over its edges, then the partial
    // rows meet in shared memory and the first warp finishes the row
    const long long v = long_rows[blockIdx.x - short_blocks];
    const int start = offsets[v], end = offsets[v + 1];
    FOR_WORDS(k) acc[k] = group == 0 ? self[v * s.W + g + k * s.G] : 0u;
    for (int e = start + group; e < end; e += groups) {
        const long long u = sources[e];
        FOR_WORDS(k) acc[k] = __vmaxu4(acc[k], src[u * s.W + g + k * s.G]);
    }
    FOR_WORDS(k) s_part[(group * s.wpt + k) * s.G + g] = acc[k];
    __syncthreads();
    if (threadIdx.x >= 32) return;
    if (group == 0) {
        FOR_WORDS(k)
            for (int q = 1; q < groups; ++q) acc[k] = __vmaxu4(acc[k], s_part[(q * s.wpt + k) * s.G + g]);
    }
    merge_epilogue(group == 0, v, acc, cmp, out, sizes, changed, g, s);
}

__global__ void __launch_bounds__(kThreads)
hll_estimate_kernel(const uint32_t* __restrict__ regs, HllShape s, float* __restrict__ sizes) {
    const int g = threadIdx.x % s.G, groups = kThreads / s.G;
    const long long v = static_cast<long long>(blockIdx.x) * groups + threadIdx.x / s.G;
    const bool valid = v < s.n;
    uint32_t acc[kMaxWordsPerThread];
    FOR_WORDS(k) acc[k] = valid ? regs[v * s.W + g + k * s.G] : 0u;
    float sum;
    int zeros;
    row_sum(acc, s, sum, zeros);
    if (valid && g == 0) sizes[v] = hll_estimate(sum, zeros, s);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// K7 (dist i32[N, S]): one warp per row. For S a multiple of 32 the lanes
// take the sources, in tiles of 256 columns, and the warp walks the row's
// edges together, so an in-neighbour's S distances are one coalesced read.
// For S = 1 (kOne) the lanes take turns over the edges instead (a tile of one
// column, then a warp min): padded to 32 columns, one source would move 32x
// the bytes. A long row takes a block whose warps stride over its edges and
// meet in shared memory. kOne is a template argument so that the S = 1
// instance keeps one distance a thread, not eight, in registers.
template <bool kOne>
__global__ void __launch_bounds__(kThreads)
bfs_relax_kernel(const int* __restrict__ dist, const int* __restrict__ offsets,
                 const int* __restrict__ sources, const int* __restrict__ long_rows,
                 int short_blocks, int long_cut, int n, int S, int* __restrict__ out,
                 int* __restrict__ changed) {
    constexpr int kCols = kOne ? 1 : kRelaxCols;  // distances a lane holds
    __shared__ int s_min[kRelaxWarps][32 * kCols];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool long_row = blockIdx.x >= short_blocks;
    long long v;
    bool valid;
    int start = 0, end = 0;
    if (long_row) {
        v = long_rows[blockIdx.x - short_blocks];
        valid = true;
        start = offsets[v];
        end = offsets[v + 1];
    } else {
        v = static_cast<long long>(blockIdx.x) * kRelaxWarps + warp;
        valid = v < n;
        if (valid) {
            start = offsets[v];
            end = offsets[v + 1];
            valid = end - start <= long_cut;
        }
    }
    // this thread's first edge and its stride over the row's edges
    constexpr int per_warp = kOne ? 32 : 1;
    const int step = (long_row ? kRelaxWarps : 1) * per_warp;
    start += (long_row ? warp : 0) * per_warp + (kOne ? lane : 0);
    const int col = kOne ? 0 : lane;
    bool diff = false;
    for (int c0 = 0; c0 < S; c0 += kRelaxTile) {
        const int cols = kOne ? 1 : min(kRelaxTile, S - c0) / 32;
        int best[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) best[j] = INT_MAX;
        for (int e = start; valid && e < end; e += step) {
            const int* row = dist + static_cast<long long>(sources[e]) * S + c0 + col;
#pragma unroll
            for (int j = 0; j < kCols; ++j)
                if (j < cols) best[j] = min(best[j], row[32 * j] + 1);
        }
        if (kOne) best[0] = warp_min(best[0]);
        if (long_row) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) s_min[warp][lane + 32 * j] = best[j];
            __syncthreads();
            if (warp == 0) {
                for (int q = 1; q < kRelaxWarps; ++q)
#pragma unroll
                    for (int j = 0; j < kCols; ++j) best[j] = min(best[j], s_min[q][lane + 32 * j]);
            }
            __syncthreads();
        }
        if (valid && (!long_row || warp == 0) && (!kOne || lane == 0)) {
            const long long base = v * S + c0 + col;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                if (j < cols) {
                    const int old = dist[base + 32 * j], nv = min(old, best[j]);
                    out[base + 32 * j] = nv;
                    diff |= nv != old;
                }
            }
        }
    }
    if (diff) *changed = 1;
}

HllShape hll_shape(int n, int m, float alpha) {
    HllShape s;
    s.n = n;
    s.W = m / 4;
    s.G = s.W < kGroupMax ? s.W : kGroupMax;
    s.wpt = s.W / s.G;
    s.m = static_cast<float>(m);
    s.alpha = alpha;
    return s;
}

bool hll_shape_ok(int m) {
    // m a power of two from 4 to 1024 (precision 2..10)
    return m >= 4 && m <= 4 * kGroupMax * kMaxWordsPerThread && (m & (m - 1)) == 0;
}

}  // namespace

extern "C" {

// K6a (+K6b): regs u8[n, m] -> out u8[n, m], sizes f32[n] (may be null),
// changed i32[1] (zeroed here). offsets i32[n + 1], sources i32[E]: the
// reverse CSR; long_rows i32[n_long]: the rows with more than long_cut
// in-edges, in any order. Returns the CUDA status of the launch.
int stract_hll_merge(const void* regs, const int* offsets, const int* sources,
                     const int* long_rows, int n_long, int n, int m, int long_cut, float alpha,
                     void* out, float* sizes, int* changed, cudaStream_t stream) {
    if (!hll_shape_ok(m) || n < 0 || n_long < 0 || long_cut < 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess || n == 0) return err;
    const HllShape s = hll_shape(n, m, alpha);
    const int groups = kThreads / s.G;
    const int short_blocks = (n + groups - 1) / groups;
    const uint32_t* r = static_cast<const uint32_t*>(regs);
    hll_merge_kernel<<<short_blocks + n_long, kThreads, 0, stream>>>(
        r, r, r, offsets, sources, long_rows, short_blocks, long_cut, s,
        static_cast<uint32_t*>(out), sizes, changed);
    return cudaGetLastError();
}

// K8, one ring step of one shard: out u8[S, m] (the shard's running rows,
// updated in place) takes the max over the bucket's edges of the ring
// buffer's rows buf u8[S, m] (another tensor: the round-start shard that
// stands at this step's ring distance). offsets i32[S + 1], sources i32[E]:
// the bucket's edges sorted by local target, sources local rows of buf;
// long_rows as for K6a. At the round's last step `start` (the round-start
// shard) is given: changed i32[1] (zeroed here) is set when a row differs
// from it, and sizes f32[S] (may be null) get K6b's estimate of the new rows.
int stract_hll_ring_step(void* out, const void* buf, const int* offsets, const int* sources,
                         const int* long_rows, int n_long, int S, int m, int long_cut, float alpha,
                         const void* start, float* sizes, int* changed, cudaStream_t stream) {
    if (!hll_shape_ok(m) || S < 0 || n_long < 0 || long_cut < 0 || out == buf ||
        (start != nullptr) != (changed != nullptr) || (sizes != nullptr && start == nullptr))
        return cudaErrorInvalidValue;
    if (changed != nullptr) {
        cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    if (S == 0) return cudaSuccess;
    const HllShape s = hll_shape(S, m, alpha);
    const int groups = kThreads / s.G;
    const int short_blocks = (S + groups - 1) / groups;
    uint32_t* o = static_cast<uint32_t*>(out);
    hll_merge_kernel<<<short_blocks + n_long, kThreads, 0, stream>>>(
        o, static_cast<const uint32_t*>(buf), static_cast<const uint32_t*>(start), offsets,
        sources, long_rows, short_blocks, long_cut, s, o, sizes, changed);
    return cudaGetLastError();
}

// K6b: regs u8[n, m] -> sizes f32[n].
int stract_hll_estimate(const void* regs, int n, int m, float alpha, float* sizes,
                        cudaStream_t stream) {
    if (!hll_shape_ok(m) || n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    const HllShape s = hll_shape(n, m, alpha);
    const int groups = kThreads / s.G;
    hll_estimate_kernel<<<(n + groups - 1) / groups, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(regs), s, sizes);
    return cudaGetLastError();
}

// K7: dist i32[n, S] (S = 1, or a multiple of 32) -> out i32[n, S],
// changed i32[1] (zeroed here); offsets, sources, long_rows as for K6a.
int stract_bfs_relax(const int* dist, const int* offsets, const int* sources, const int* long_rows,
                     int n_long, int n, int S, int long_cut, int* out, int* changed,
                     cudaStream_t stream) {
    if (n < 0 || n_long < 0 || long_cut < 0 || S < 1 || (S > 1 && S % 32 != 0))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess || n == 0) return err;
    const int short_blocks = (n + kRelaxWarps - 1) / kRelaxWarps;
    if (S == 1)
        bfs_relax_kernel<true><<<short_blocks + n_long, kThreads, 0, stream>>>(
            dist, offsets, sources, long_rows, short_blocks, long_cut, n, S, out, changed);
    else
        bfs_relax_kernel<false><<<short_blocks + n_long, kThreads, 0, stream>>>(
            dist, offsets, sources, long_rows, short_blocks, long_cut, n, S, out, changed);
    return cudaGetLastError();
}

}  // extern "C"
