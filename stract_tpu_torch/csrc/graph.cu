// The webgraph centrality kernels on Hopper (sm_90a): K6a HyperBall register
// merge, K6b HLL size estimate, K7 the multi-source BFS's frontier step, K8
// the sharded HyperBall's ring step.
//
// K6a replaces stract_tpu/ops/hll_ops.py:50 merge_iteration (a gather of
// regs[edge_from] and a scatter-max into regs[edge_to]); its epilogue also
// computes K6b for the new rows. K6b alone replaces hll_ops.py:64
// estimate_sizes (the initial estimate). K7 replaces
// stract_tpu/webgraph/shortest_path.py:21 _relax, its vmap over sources
// (:59) and its loop to a fixpoint (:60-64), one launch a round.
//
// Pull form, no atomics: every target row v reads the round-start rows of its
// in-neighbours u through the reverse CSR (offsets[v]..offsets[v+1] into
// sources) and writes its new row into a second buffer, so every read sees
// the round-start state (Jacobi, as the reference's gather-then-scatter).
// One int flag, zeroed before the launch, is set when any row changed; the
// host reads 4 bytes a round instead of comparing the registers.
//
// What bounds K6a and K8: each round moves, once, the registers in and out
// plus the CSR (K6a at 1M nodes x 64 registers and 20M edges: 128 MB + 80
// MB of sources), but the gather reads an in-neighbour's row for every edge
// (20M x 64 B = 1.28 GB), from L2 when the row is there (50 MB L2, 64 MB of
// registers): they are bound by that gather's memory traffic and its
// latency, far above the bytes-once bound. Each edge's row is read whole by
// neighbouring threads (64 B by 16 threads), so each gather is coalesced.
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

// K7, one round r of the multi-source BFS, as a bitset frontier step
// (MS-BFS: Then et al., "The More the Merrier: Efficient Multi-Source Graph
// Traversal", VLDB 2015). The reference relaxes every distance every round,
// dist[v, s] = min(dist[v, s], min over in-edges u of dist[u, s] + 1),
// which gathers the S-wide distance row of every in-neighbour: at S = 256
// 1 KB for each of 20M edges, 20.5 GB a round from a 1 GB table that L2
// cannot hold. From the BFS start state (0 at each source, UNREACHABLE
// elsewhere) every finite distance after r rounds is the exact level, so
// only the pairs at level r (the frontier) can lower anything, and only an
// UNREACHABLE entry, to r + 1: the relaxation's result is "r + 1 where v is
// not yet seen for s and some in-neighbour is in s's frontier", the same
// bits round for round, and it changes exactly when that set is not empty.
//
// State, node-major, W = ceil(S / 32) words a node: seen u32[N, W] (the
// padding bits past S set from the start, so they are never reached),
// frontier u32[N, W] (read) and next u32[N, W] (written: the next round's
// frontier, a second buffer), dist i32[N, 32 W]. Row v: next = (OR over
// in-edges u of frontier[u]) & ~seen[v]; seen[v] |= next and dist[v, s] =
// r + 1 for each bit of next, in place (only v's own threads touch them);
// `changed` is set when any next is not zero.
//
// What bounds it: the bytes once are frontier, seen and next (3 N W 4 B), the
// CSR (offsets, sources, long rows) and 4 B for each distance written this
// round: at 1M nodes x 256 sources and 20M edges 96 MB + 84 MB, 0.054 ms
// over 3.35 TB/s, plus the writes. The gather is W words an edge (32 B at
// S = 256, 640 MB a round) from a 32 MB frontier table that fits in L2.
// Lanes: WL lanes (W rounded up to a power of two, at most 32; chunks of
// 32 words past S = 1,024) read one in-neighbour's words, so its row is one
// coalesced read (one 32 B sector at S = 256); a row's group has
// G = max(8, WL) lanes, which read G / WL in-edges at once. The group loads
// G of the row's sources in one coalesced read and hands them round by
// shuffles, so each lane has WL loads of the frontier in flight at once.
// A row with no in-edges, or whose seen bits are all set (it cannot
// change), skips its edges and writes next = 0. A row with more than
// `long_cut` in-edges takes a block: its groups stride over the edges and
// OR their parts in shared memory, and the first group finishes the row.
constexpr int kStepGroup = 8;  // the fewest lanes of a row's group

template <int WL>
__global__ void __launch_bounds__(kThreads)
bfs_step_kernel(const uint32_t* __restrict__ frontier, const int* __restrict__ offsets,
                const int* __restrict__ sources, const int* __restrict__ long_rows,
                int short_blocks, int long_cut, int n, int W, int level,
                uint32_t* __restrict__ seen, int* __restrict__ dist,
                uint32_t* __restrict__ next, int* __restrict__ changed) {
    constexpr int G = WL < kStepGroup ? kStepGroup : WL;  // lanes of a row's group
    constexpr int kSlots = G / WL;                        // in-edges the group reads at once
    constexpr int kGroups = kThreads / G;
    __shared__ uint32_t s_part[kThreads];
    const int gl = threadIdx.x % G, group = threadIdx.x / G;
    const int wl = gl % WL, slot = gl / WL;
    const unsigned gmask =  // this group's lanes of the warp (G % 32: no shift by 32)
        G == 32 ? 0xffffffffu : ((1u << (G % 32)) - 1) << (threadIdx.x % 32 / G * G);
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
        v = static_cast<long long>(blockIdx.x) * kGroups + group;
        valid = v < n;
        if (valid) {
            start = offsets[v];
            end = offsets[v + 1];
            valid = end - start <= long_cut;
            if (!valid) end = start;  // its own block walks it
        }
    }
    // this group's first edge and its stride over the row's edges
    const int first = start + (long_row ? group * G : 0);
    const int stride = (long_row ? kGroups : 1) * G;
    const bool writer = valid && (!long_row || group == 0) && slot == 0;
    bool any = false;
    for (int c0 = 0; c0 < W; c0 += WL) {
        const int w = c0 + wl;
        const long long at = v * W + w;
        // all ones for a word past W or a row with no in-edges: nothing to gather
        const uint32_t old = valid && w < W && end > start ? seen[at] : ~0u;
        uint32_t acc = 0;
        // the same words in every group of the row: one answer for the group
        // (and for a long row's whole block)
        if (!__all_sync(gmask, old == ~0u)) {
            for (int e0 = first; e0 < end; e0 += stride) {
                const int cnt = min(G, end - e0);
                const int idx = gl < cnt ? sources[e0 + gl] : 0;
#pragma unroll
                for (int j = 0; j < WL; ++j) {
                    const int k = j * kSlots + slot;
                    const long long u = __shfl_sync(gmask, idx, k, G);
                    if (k < cnt && w < W) acc |= frontier[u * W + w];
                }
            }
        }
#pragma unroll
        for (int o = WL; o < G; o <<= 1) acc |= __shfl_xor_sync(gmask, acc, o, G);
        if (long_row) {
            s_part[threadIdx.x] = acc;
            __syncthreads();
            if (group == 0)
                for (int q = 1; q < kGroups; ++q) acc |= s_part[q * G + gl];
            __syncthreads();
        }
        if (writer && w < W) {
            const uint32_t fresh = acc & ~old;
            next[at] = fresh;
            if (fresh != 0u) {
                seen[at] = old | fresh;
                int* row = dist + v * 32LL * W + 32 * w;
                for (uint32_t m = fresh; m != 0u; m &= m - 1) row[__ffs(m) - 1] = level + 1;
                any = true;
            }
        }
    }
    if (any) *changed = 1;
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

// K7, round `level` of the BFS: frontier u32[n, W] (read), seen u32[n, W]
// and dist i32[n, 32 W] (updated in place), next u32[n, W] (written, another
// buffer than frontier), changed i32[1] (zeroed here); offsets, sources,
// long_rows as for K6a. The padding bits of seen past the sources must be
// set. Returns the CUDA status of the launch.
int stract_bfs_step(const uint32_t* frontier, const int* offsets, const int* sources,
                    const int* long_rows, int n_long, int n, int W, int long_cut, int level,
                    uint32_t* seen, int* dist, uint32_t* next, int* changed,
                    cudaStream_t stream) {
    if (n < 0 || n_long < 0 || long_cut < 0 || W < 1 || level < 0 || level >= INT_MAX - 1 ||
        frontier == next)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess || n == 0) return err;
    int wl = 1;  // W rounded up to a power of two, at most 32
    while (wl < W && wl < 32) wl *= 2;
    const int groups = kThreads / (wl < kStepGroup ? kStepGroup : wl);
    const int short_blocks = (n + groups - 1) / groups;
    const unsigned grid = static_cast<unsigned>(short_blocks + n_long);
#define STRACT_BFS_STEP(WL)                                                                    \
    bfs_step_kernel<WL><<<grid, kThreads, 0, stream>>>(frontier, offsets, sources, long_rows, \
                                                       short_blocks, long_cut, n, W, level,   \
                                                       seen, dist, next, changed)
    switch (wl) {
        case 1: STRACT_BFS_STEP(1); break;
        case 2: STRACT_BFS_STEP(2); break;
        case 4: STRACT_BFS_STEP(4); break;
        case 8: STRACT_BFS_STEP(8); break;
        case 16: STRACT_BFS_STEP(16); break;
        default: STRACT_BFS_STEP(32); break;
    }
#undef STRACT_BFS_STEP
    return cudaGetLastError();
}

}  // extern "C"
