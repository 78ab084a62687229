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
// The systolic round (Boldi and Vigna, "In-Core Computation of Geometric
// Centralities with HyperBall", ICDMW 2013). From round 1 on, a row already
// holds the max of its in-neighbours' rows of the round before, so an
// in-neighbour u that did not change in round t adds nothing to round t + 1:
// regs_{t+1}[v] = max(regs_t[v], max over the in-neighbours u that changed in
// round t of regs_t[u]). One change byte a row carries that set from round to
// round: `flags` (read; null: every byte set, the full merge) and
// `flags_out` (written by the row's own lanes from the epilogue's comparison
// with the round start). The result is bit-equal to the full merge from any
// state a HyperBall run reaches (every byte set before round 1), with the
// same change flag and round count; it is not the full merge for an
// arbitrary state, so the stateless merge passes no flags.
//
// What bounds K6a and K8: the bytes once are the registers in and out, the
// CSR, the change bytes in and out and the sizes (K6a at 1M nodes x 64
// registers and 20M edges: 128 MB + 84 MB + 2 MB + 4 MB, 0.065 ms over 3.35
// TB/s). The gather reads a flagged in-neighbour's whole row for each of its
// edges: 64 B x the round's flagged edges (all 20M in round 1, 1.28 GB, from a
// 64 MB table the 50 MB L2 cannot hold; 47 % of them in the fourth round),
// far above the bytes once, and latency-bound where the rows come from L2.
// On an H100 the gather of every row takes about 0.8 ms of a 1.36 ms round
// at that size; the rest, which a round pays even when few rows changed
// (about 0.5 ms), is the walk of every source and its change byte and the
// rows in and out: a push from the changed rows would be needed to skip it.
//
// The body, `hll_merge_kernel<VEC, LANES, PPL, BYTES>`, is specialised on the
// row width: LANES lanes read a row in PPL pieces of VEC words each (16 B
// pieces from m = 16 registers on; m = 64 is 4 lanes of one piece; a word is
// BYTES bytes, 4 but at m = 2 and 1, whose rows are half a word and a byte),
// so a lane holds VEC x PPL words, at most 8. A row's group has G = max(8, LANES) lanes, which
// read G / LANES in-edges' rows at once (the slots). The group loads G of the
// row's sources in one coalesced read, each lane tests its source's change
// byte (a 1 MB table at 1M nodes that stays in L2), a ballot picks the flagged
// ones, and the slots take them in turn by shuffles: each lane issues up to U
// gathers before it maxes any, so no gather waits on the one before, and no
// lane gathers a row that did not change. The slots' rows meet by shuffles.
//
// In-degree skew: the Pareto targets of a web graph put most edges on few
// rows. A row with more than `long_cut` in-edges takes a whole block: its
// groups stride over the edges, write their partial rows to dynamic shared
// memory (the block's groups x the row's bytes) and the first group finishes
// the row; max is exact and order-free, so the result is the same bits. The
// short-row blocks cover all rows in order and skip the long ones; blocks
// past them take one long row each.
//
// K8, the ring step of the sharded HyperBall, replaces round_fn's step of
// stract_tpu/webgraph/centrality.py:148-165 (`out.at[let[k]].max(buf[lef[k]],
// mode="drop")` on each device, then a ppermute of the register shard). It is
// K6a's body over one (shard, ring distance) bucket: the bucket's edges are
// sorted by local target into a CSR on the host, the row's running value
// comes from `out` (updated in place: a row that gathered nothing is neither
// read nor written, unless the step compares or estimates) and the gathered
// rows from the ring buffer (the round-start shard standing at that
// distance, never written), flagged by that shard's change bytes. The
// round's last step compares each row with the round-start shard (the change
// flag and the shard's change bytes) and estimates it (K6b in the epilogue).
//
// Rows wider than a warp takes (m >= 2,048 registers, up to 65,536) go to
// `hll_wide_kernel<T, PPL>`: a block of T = min(1,024, m / 16) threads a row,
// each PPL (at most 4) pieces of 16 B, so a thread holds at most 16 words.
// The block walks the row's in-edges T at a time: each thread loads one
// source and tests its change byte, the flagged ones are listed in shared
// memory, and every thread gathers its pieces of U of them at once. The row's
// figures for K6b (below) meet over the warps in shared memory, summed in warp
// order.
//
// K6b's arithmetic follows the reference in f32: alpha * m * m / sum of
// 2^-r, the linear-counting branch m * log(m / zeros) when the estimate is
// <= 2.5 m and zeros remain (logf; built with --fmad=false, no fast-math).
// 2^-r is a power of two: its bits are (127 - r) << 23 for r <= 125, built
// from a word's four bytes at once with integer operations (no int-to-float
// conversion, no exp2f: those two were quarter-rate work for every register
// and made the old K6b twice its byte bound); from r = 126 on it is 0, as
// XLA's exp2 gives on the CPU (it flushes 2^-126). Zeros are counted a word
// at a time. The sum over a row is taken in another order than XLA's (each
// lane its own words, then the row's lanes by shuffles, then a wide row's
// warps in order), so sizes agree to a few f32 ulps, not bit for bit; K6b
// alone and the merge's epilogue take one routine in one order, so a row
// gets the same bits from K6a, K6b and K8.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinGroup = 8;  // the fewest lanes of a row's group
constexpr int kEstRows = 4;   // rows a lane group of K6b alone loads at once
constexpr unsigned kFull = 0xffffffffu;

// word i of a row of BYTES-byte words at p
template <int BYTES, class P>
__device__ __forceinline__ P word_at(P p, long long i) {
    return p + i * BYTES;
}

// VEC words of BYTES bytes from p (aligned to VEC x BYTES bytes) into w
// (zero-extended), and back; a word of 2 or 1 bytes is a piece alone
template <int VEC, int BYTES>
__device__ __forceinline__ void load_piece(const uint8_t* p, uint32_t (&w)[VEC]) {
    if constexpr (BYTES == 1) {
        w[0] = *p;
    } else if constexpr (BYTES == 2) {
        w[0] = *reinterpret_cast<const uint16_t*>(p);
    } else if constexpr (VEC == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else if constexpr (VEC == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        w[0] = x.x, w[1] = x.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
}

template <int VEC, int BYTES>
__device__ __forceinline__ void store_piece(uint8_t* p, const uint32_t (&w)[VEC]) {
    if constexpr (BYTES == 1) {
        *p = static_cast<uint8_t>(w[0]);
    } else if constexpr (BYTES == 2) {
        *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    } else if constexpr (VEC == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
        *reinterpret_cast<uint32_t*>(p) = w[0];
    }
}

// the position of the k-th (from 0) set bit of mask, which has more than k
__device__ __forceinline__ int nth_set(unsigned mask, int k) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
        const int c = __popc((mask >> pos) & ((1u << w) - 1u));
        if (k >= c) {
            k -= c;
            pos += w;
        }
    }
    return pos;
}

// the low NB bytes of register word w: 2^-r of each added to sum in byte
// order, and its zero bytes counted. Where every byte is below 126 (the test
// flags a byte >= 126, or any byte past one >= 254), 127 - r of all four
// bytes is one subtraction without borrows, and each byte shifted to the
// exponent field is 2^-r; else byte by byte, 0 from r = 126 on. Both paths
// add the same values in the same order.
template <int NB>
__device__ __forceinline__ void word_sum(uint32_t w, float& sum, int& zeros) {
    constexpr uint32_t kHigh = NB == 4 ? 0x80808080u : NB == 2 ? 0x8080u : 0x80u;
    zeros += __popc(~(((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & kHigh);
    if ((((w + 0x02020202u) | w) & 0x80808080u) == 0u) {
        const uint32_t d = 0x7F7F7F7Fu - w;
        constexpr uint32_t kExp = 0x3F800000u;  // the exponent bits of 2^0 .. 2^-126
        sum += __uint_as_float((d << 23) & kExp);
        if (NB > 1) sum += __uint_as_float((d << 15) & kExp);
        if (NB > 2) {
            sum += __uint_as_float((d << 7) & kExp);
            sum += __uint_as_float((d >> 1) & kExp);
        }
    } else {
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const uint32_t r = (w >> (8 * b)) & 0xFFu;
            sum += __uint_as_float(r < 126u ? (127u - r) << 23 : 0u);
        }
    }
}

// sum of 2^-r over one row's registers and its count of zero registers: each
// lane its own words in order, then the LANES lanes of the row (neighbours,
// lanes of `mask`) by shuffles; every lane of the row gets the row's figures
template <int LANES, int PPL, int VEC, int BYTES>
__device__ void row_sum(const uint32_t (&acc)[PPL][VEC], unsigned mask, float& sum, int& zeros) {
    sum = 0.0f;
    zeros = 0;
#pragma unroll
    for (int p = 0; p < PPL; ++p)
#pragma unroll
        for (int i = 0; i < VEC; ++i) word_sum<BYTES>(acc[p][i], sum, zeros);
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(mask, sum, o);
        zeros += __shfl_xor_sync(mask, zeros, o);
    }
}

// a wide row's figures (every thread of the block calls, each with its PPL
// pieces of 16 B): row_sum over each warp, then the warps' partials in warp
// order; every thread gets the row's figures
template <int T, int PPL>
__device__ void wide_row_sum(const uint32_t (&acc)[PPL][4], float* s_sum, int* s_zero,
                             float& sum, int& zeros) {
    row_sum<32, PPL, 4, 4>(acc, kFull, sum, zeros);
    if (threadIdx.x % 32 == 0) {
        s_sum[threadIdx.x / 32] = sum;
        s_zero[threadIdx.x / 32] = zeros;
    }
    __syncthreads();
    sum = 0.0f;
    zeros = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) {
        sum += s_sum[w];
        zeros += s_zero[w];
    }
}

__device__ float hll_estimate(float sum, int zeros, float m, float alpha) {
    const float est = alpha * m * m / sum;
    const float z = static_cast<float>(zeros);
    const float lc = m * logf(m / fmaxf(z, 1.0f));
    return (est <= 2.5f * m && z > 0.0f) ? lc : est;
}

// one launch of the merge body. K6a: self = cmp = the round-start registers,
// src the same, out another buffer. The ring step (K8): self = out (its
// running rows, in place), src the ring buffer, cmp the round-start shard at
// the round's last step (else null). A row is read and written by the same
// lanes, so self may be out (neither is __restrict__); src is never written.
struct MergeArgs {
    const uint8_t* self;
    const uint8_t* src;
    const uint8_t* cmp;         // null: no comparison (nor change bytes)
    const uint8_t* flags;       // src's change bytes; null: every byte set
    const int* offsets;
    const int* sources;
    const int* long_rows;
    int short_blocks, long_cut, n;
    float m, alpha;
    uint8_t* out;
    uint8_t* flags_out;         // the rows' change bytes (may be null)
    float* sizes;               // may be null
    int* changed;
};

template <int VEC, int LANES, int PPL, int BYTES>
__global__ void __launch_bounds__(kThreads) hll_merge_kernel(MergeArgs a) {
    constexpr int W = VEC * LANES * PPL;                     // words a row
    constexpr int G = LANES < kMinGroup ? kMinGroup : LANES;  // lanes of a row's group
    constexpr int kSlots = G / LANES;                        // in-edges the group reads at once
    constexpr int kGroups = kThreads / G;
    constexpr int U = 4 / PPL < LANES ? 4 / PPL : LANES;     // gathers a lane issues at once
    extern __shared__ uint32_t s_part[];                     // long rows: kGroups x W words
    const int gl = threadIdx.x % G, group = threadIdx.x / G;
    const int lane = gl % LANES, slot = gl / LANES;
    const int gbase = threadIdx.x % 32 / G * G;
    const unsigned gmask =  // this group's lanes of the warp (G % 32: no shift by 32)
        G == 32 ? kFull : ((1u << (G % 32)) - 1) << gbase;
    const bool long_row = blockIdx.x >= a.short_blocks;
    long long v;
    bool valid;
    int start = 0, end = 0;
    if (long_row) {
        v = a.long_rows[blockIdx.x - a.short_blocks];
        valid = true;
        start = a.offsets[v];
        end = a.offsets[v + 1];
    } else {
        v = static_cast<long long>(blockIdx.x) * kGroups + group;
        valid = v < a.n;
        if (valid) {
            start = a.offsets[v];
            end = a.offsets[v + 1];
            valid = end - start <= a.long_cut;  // else its own block walks it
        }
        if (!valid) end = start;
    }
    // this group's first edge and its stride over the row's edges
    const int first = start + (long_row ? group * G : 0);
    const int stride = (long_row ? kGroups : 1) * G;

    uint32_t acc[PPL][VEC] = {};
    bool gathered = false;  // the same in every lane of the group
    for (int e0 = first; e0 < end; e0 += stride) {
        const int cnt = min(G, end - e0);
        const int idx = gl < cnt ? a.sources[e0 + gl] : 0;
        const bool flagged = gl < cnt && (a.flags == nullptr || a.flags[idx] != 0);
        const unsigned mask = (__ballot_sync(gmask, flagged) & gmask) >> gbase;
        const int nf = __popc(mask);
        gathered |= nf > 0;
        for (int k0 = 0; k0 < nf; k0 += kSlots * U) {
            uint32_t got[U][PPL][VEC];
#pragma unroll
            for (int j = 0; j < U; ++j) {
                const int k = k0 + j * kSlots + slot;
                const long long u = __shfl_sync(gmask, idx, nth_set(mask, min(k, nf - 1)), G);
#pragma unroll
                for (int p = 0; p < PPL; ++p) {
                    if (k < nf) {
                        load_piece<VEC, BYTES>(
                            word_at<BYTES>(a.src, u * W + (p * LANES + lane) * VEC), got[j][p]);
                    } else {
#pragma unroll
                        for (int i = 0; i < VEC; ++i) got[j][p][i] = 0u;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < U; ++j)
#pragma unroll
                for (int p = 0; p < PPL; ++p)
#pragma unroll
                    for (int i = 0; i < VEC; ++i) acc[p][i] = __vmaxu4(acc[p][i], got[j][p][i]);
        }
    }
    // the slots' rows meet: every slot then holds the group's row
#pragma unroll
    for (int o = LANES; o < G; o <<= 1)
#pragma unroll
        for (int p = 0; p < PPL; ++p)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                acc[p][i] = __vmaxu4(acc[p][i], __shfl_xor_sync(gmask, acc[p][i], o));
    if (long_row) {
        // the groups' partial rows meet in shared memory; the first group finishes
        if (slot == 0) {
#pragma unroll
            for (int p = 0; p < PPL; ++p)
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    s_part[group * W + (p * LANES + lane) * VEC + i] = acc[p][i];
        }
        gathered = __syncthreads_or(gathered);
        if (group != 0) return;
        for (int q = 1; q < kGroups; ++q)
#pragma unroll
            for (int p = 0; p < PPL; ++p)
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    acc[p][i] = __vmaxu4(acc[p][i], s_part[q * W + (p * LANES + lane) * VEC + i]);
    }
    // K6a writes every row into the other buffer; in place, a row that
    // gathered nothing is left as it is unless it is compared or estimated
    const bool in_place = a.out == a.self;
    if (!valid || (in_place && !gathered && a.cmp == nullptr && a.sizes == nullptr)) return;
    const long long at = v * W + lane * VEC;
    uint32_t own[PPL][VEC];
#pragma unroll
    for (int p = 0; p < PPL; ++p)
        load_piece<VEC, BYTES>(word_at<BYTES>(a.self, at + p * LANES * VEC), own[p]);
    bool diff = false;
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
        uint32_t ref[VEC] = {};
        if (a.cmp != nullptr && a.cmp != a.self)
            load_piece<VEC, BYTES>(word_at<BYTES>(a.cmp, at + p * LANES * VEC), ref);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            acc[p][i] = __vmaxu4(acc[p][i], own[p][i]);
            if (a.cmp != nullptr) diff |= acc[p][i] != (a.cmp == a.self ? own[p][i] : ref[i]);
        }
    }
    if (slot == 0 && (!in_place || gathered)) {
#pragma unroll
        for (int p = 0; p < PPL; ++p)
            store_piece<VEC, BYTES>(word_at<BYTES>(a.out, at + p * LANES * VEC), acc[p]);
    }
    if (a.cmp != nullptr) {
        const bool row_diff = __any_sync(gmask, diff);
        if (a.flags_out != nullptr && gl == 0) a.flags_out[v] = row_diff;
        if (row_diff && gl == 0) *a.changed = 1;
    }
    if (a.sizes != nullptr) {
        float sum;
        int zeros;
        row_sum<LANES, PPL, VEC, BYTES>(acc, gmask, sum, zeros);
        if (gl == 0) a.sizes[v] = hll_estimate(sum, zeros, a.m, a.alpha);
    }
}

// the merge body for rows past a warp: a block of T threads a row, thread t
// holding pieces t, T + t, ... (PPL of 16 B); the row's in-edges T at a time,
// the flagged sources listed in shared memory (in any order: max is
// order-free) and gathered U at once. Every row is its own block, so the
// long rows need no list of their own. The epilogue is the narrow body's,
// over the block.
template <int T, int PPL>
__global__ void __launch_bounds__(T) hll_wide_kernel(MergeArgs a) {
    constexpr int W = 4 * T * PPL;           // words a row
    constexpr int U = PPL < 4 ? 4 / PPL : 1;  // rows a thread gathers at once
    __shared__ int s_src[T];
    __shared__ int s_n;
    __shared__ float s_sum[T / 32];
    __shared__ int s_zero[T / 32];
    const int tid = threadIdx.x;
    const long long v = blockIdx.x;
    const int start = a.offsets[v], end = a.offsets[v + 1];
    uint32_t acc[PPL][4] = {};
    bool gathered = false;  // the same in every thread
    for (int e0 = start; e0 < end; e0 += T) {
        const int cnt = min(T, end - e0);
        const int idx = tid < cnt ? a.sources[e0 + tid] : 0;
        const bool flagged = tid < cnt && (a.flags == nullptr || a.flags[idx] != 0);
        if (tid == 0) s_n = 0;
        __syncthreads();
        if (flagged) s_src[atomicAdd(&s_n, 1)] = idx;
        __syncthreads();
        const int nf = s_n;
        gathered |= nf > 0;
        for (int k0 = 0; k0 < nf; k0 += U) {
            uint32_t got[U][PPL][4];
#pragma unroll
            for (int j = 0; j < U; ++j) {
                const long long u = s_src[min(k0 + j, nf - 1)];
#pragma unroll
                for (int p = 0; p < PPL; ++p) {
                    if (k0 + j < nf) {
                        load_piece<4, 4>(word_at<4>(a.src, u * W + (p * T + tid) * 4), got[j][p]);
                    } else {
#pragma unroll
                        for (int i = 0; i < 4; ++i) got[j][p][i] = 0u;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < U; ++j)
#pragma unroll
                for (int p = 0; p < PPL; ++p)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[p][i] = __vmaxu4(acc[p][i], got[j][p][i]);
        }
        __syncthreads();  // the list is rewritten for the next edges
    }
    const bool in_place = a.out == a.self;
    if (in_place && !gathered && a.cmp == nullptr && a.sizes == nullptr) return;
    bool diff = false;
#pragma unroll
    for (int p = 0; p < PPL; ++p) {
        const long long at = v * W + (p * T + tid) * 4;
        uint32_t own[4], ref[4] = {};
        load_piece<4, 4>(word_at<4>(a.self, at), own);
        if (a.cmp != nullptr && a.cmp != a.self) load_piece<4, 4>(word_at<4>(a.cmp, at), ref);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            acc[p][i] = __vmaxu4(acc[p][i], own[i]);
            if (a.cmp != nullptr) diff |= acc[p][i] != (a.cmp == a.self ? own[i] : ref[i]);
        }
        if (!in_place || gathered) store_piece<4, 4>(word_at<4>(a.out, at), acc[p]);
    }
    if (a.cmp != nullptr) {
        const bool row_diff = __syncthreads_or(diff);
        if (tid == 0) {
            if (a.flags_out != nullptr) a.flags_out[v] = row_diff;
            if (row_diff) *a.changed = 1;
        }
    }
    if (a.sizes != nullptr) {
        float sum;
        int zeros;
        wide_row_sum<T, PPL>(acc, s_sum, s_zero, sum, zeros);
        if (tid == 0) a.sizes[v] = hll_estimate(sum, zeros, a.m, a.alpha);
    }
}

// K6b alone: LANES lanes a row (all 32 lanes of a warp take part), each lane
// group kEstRows rows, all their loads issued before any sum
template <int VEC, int LANES, int PPL, int BYTES>
__global__ void __launch_bounds__(kThreads)
hll_estimate_kernel(const uint8_t* __restrict__ regs, int n, float m, float alpha,
                    float* __restrict__ sizes) {
    constexpr int W = VEC * LANES * PPL;
    constexpr int kRows = kThreads / LANES;  // rows a block takes at once
    const int lane = threadIdx.x % LANES;
    const long long v0 =
        static_cast<long long>(blockIdx.x) * kRows * kEstRows + threadIdx.x / LANES;
    uint32_t acc[kEstRows][PPL][VEC] = {};
#pragma unroll
    for (int j = 0; j < kEstRows; ++j) {
        const long long v = v0 + j * kRows;
        if (v < n) {
#pragma unroll
            for (int p = 0; p < PPL; ++p)
                load_piece<VEC, BYTES>(word_at<BYTES>(regs, v * W + (p * LANES + lane) * VEC),
                                       acc[j][p]);
        }
    }
#pragma unroll
    for (int j = 0; j < kEstRows; ++j) {
        float sum;
        int zeros;
        row_sum<LANES, PPL, VEC, BYTES>(acc[j], kFull, sum, zeros);
        const long long v = v0 + j * kRows;
        if (v < n && lane == 0) sizes[v] = hll_estimate(sum, zeros, m, alpha);
    }
}

// K6b alone on rows past a warp: a block a row, as hll_wide_kernel's epilogue
template <int T, int PPL>
__global__ void __launch_bounds__(T)
hll_wide_estimate_kernel(const uint8_t* __restrict__ regs, float m, float alpha,
                         float* __restrict__ sizes) {
    constexpr int W = 4 * T * PPL;
    __shared__ float s_sum[T / 32];
    __shared__ int s_zero[T / 32];
    const long long v = blockIdx.x;
    uint32_t acc[PPL][4];
#pragma unroll
    for (int p = 0; p < PPL; ++p)
        load_piece<4, 4>(word_at<4>(regs, v * W + (p * T + threadIdx.x) * 4), acc[p]);
    float sum;
    int zeros;
    wide_row_sum<T, PPL>(acc, s_sum, s_zero, sum, zeros);
    if (threadIdx.x == 0) sizes[v] = hll_estimate(sum, zeros, m, alpha);
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

// the merge body at m registers a row up to a warp's (a power of two,
// 1..1,024): (VEC, LANES, PPL, BYTES) with VEC x LANES x PPL words of BYTES
// bytes = m bytes
#define STRACT_HLL_WIDTHS(X)                                                              \
    X(1, 1, 1, 1, 1) X(2, 1, 1, 1, 2) X(4, 1, 1, 1, 4) X(8, 2, 1, 1, 4) X(16, 4, 1, 1, 4) \
    X(32, 4, 2, 1, 4) X(64, 4, 4, 1, 4) X(128, 4, 8, 1, 4) X(256, 4, 16, 1, 4)            \
    X(512, 4, 32, 1, 4) X(1024, 4, 32, 2, 4)
// past it, a block a row: (T, PPL) with T x PPL pieces of 16 B = m bytes
#define STRACT_HLL_WIDE(X)                                                        \
    X(2048, 128, 1) X(4096, 256, 1) X(8192, 512, 1) X(16384, 1024, 1) X(32768, 1024, 2) \
    X(65536, 1024, 4)

constexpr int kMaxM = 65536;

bool hll_shape_ok(int m) {
    return m >= 1 && m <= kMaxM && (m & (m - 1)) == 0;
}

// the registers' pointers must hold whole pieces: min(m, 16) bytes
bool hll_aligned(const void* p, int m) {
    return reinterpret_cast<uintptr_t>(p) % (m < 16 ? m : 16) == 0;
}

template <int VEC, int LANES, int PPL, int BYTES>
cudaError_t launch_merge(MergeArgs a, int n_long, cudaStream_t stream) {
    constexpr int G = LANES < kMinGroup ? kMinGroup : LANES;
    constexpr int kGroups = kThreads / G;
    a.short_blocks = (a.n + kGroups - 1) / kGroups;
    const size_t smem = n_long > 0 ? sizeof(uint32_t) * kGroups * VEC * LANES * PPL : 0;
    hll_merge_kernel<VEC, LANES, PPL, BYTES>
        <<<static_cast<unsigned>(a.short_blocks + n_long), kThreads, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int T, int PPL>
cudaError_t launch_wide(const MergeArgs& a, cudaStream_t stream) {
    hll_wide_kernel<T, PPL><<<static_cast<unsigned>(a.n), T, 0, stream>>>(a);
    return cudaGetLastError();
}

cudaError_t merge(int m, const MergeArgs& a, int n_long, cudaStream_t stream) {
    switch (m) {
#define STRACT_HLL_MERGE(M, VEC, LANES, PPL, BYTES) \
    case M: return launch_merge<VEC, LANES, PPL, BYTES>(a, n_long, stream);
        STRACT_HLL_WIDTHS(STRACT_HLL_MERGE)
#undef STRACT_HLL_MERGE
#define STRACT_HLL_MERGE_WIDE(M, T, PPL) \
    case M: return launch_wide<T, PPL>(a, stream);
        STRACT_HLL_WIDE(STRACT_HLL_MERGE_WIDE)
#undef STRACT_HLL_MERGE_WIDE
        default: return cudaErrorInvalidValue;
    }
}

template <int VEC, int LANES, int PPL, int BYTES>
cudaError_t launch_estimate(const uint8_t* regs, int n, float alpha, float* sizes,
                            cudaStream_t stream) {
    constexpr int rows = kThreads / LANES * kEstRows;
    hll_estimate_kernel<VEC, LANES, PPL, BYTES><<<(n + rows - 1) / rows, kThreads, 0, stream>>>(
        regs, n, static_cast<float>(BYTES * VEC * LANES * PPL), alpha, sizes);
    return cudaGetLastError();
}

template <int T, int PPL>
cudaError_t launch_wide_estimate(const uint8_t* regs, int n, float alpha, float* sizes,
                                 cudaStream_t stream) {
    hll_wide_estimate_kernel<T, PPL><<<static_cast<unsigned>(n), T, 0, stream>>>(
        regs, static_cast<float>(16 * T * PPL), alpha, sizes);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6a (+K6b): regs u8[n, m] -> out u8[n, m] (another buffer), sizes f32[n]
// (may be null), changed i32[1] (zeroed here). offsets i32[n + 1], sources
// i32[E]: the reverse CSR; long_rows i32[n_long]: the rows with more than
// long_cut in-edges, in any order. flags u8[n]: the rows that changed in the
// round before (only their out-edges are gathered; null: every row, the full
// merge); flags_out u8[n] (may be null, another buffer than flags): this
// round's change bytes. Returns the CUDA status of the launch.
int stract_hll_merge(const void* regs, const uint8_t* flags, const int* offsets,
                     const int* sources, const int* long_rows, int n_long, int n, int m,
                     int long_cut, float alpha, void* out, uint8_t* flags_out, float* sizes,
                     int* changed, cudaStream_t stream) {
    if (!hll_shape_ok(m) || n < 0 || n_long < 0 || long_cut < 0 || regs == out ||
        !hll_aligned(regs, m) || !hll_aligned(out, m) ||
        (flags != nullptr && flags == flags_out))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
    if (err != cudaSuccess || n == 0) return err;
    const uint8_t* r = static_cast<const uint8_t*>(regs);
    MergeArgs a{r, r, r, flags, offsets, sources, long_rows, 0, long_cut, n,
                static_cast<float>(m), alpha, static_cast<uint8_t*>(out), flags_out, sizes,
                changed};
    return merge(m, a, n_long, stream);
}

// K8, one ring step of one shard: out u8[S, m] (the shard's running rows,
// updated in place) takes the max over the bucket's edges of the ring
// buffer's rows buf u8[S, m] (another tensor: the round-start shard that
// stands at this step's ring distance) whose change byte in flags u8[S] is
// set (null: every row). offsets i32[S + 1], sources i32[E]: the bucket's
// edges sorted by local target, sources local rows of buf; long_rows as for
// K6a. At the round's last step `start` (the round-start shard) is given:
// changed i32[1] (zeroed here) is set when a row differs from it, flags_out
// u8[S] (may be null) gets each row's change byte, and sizes f32[S] (may be
// null) K6b's estimate of the new rows.
int stract_hll_ring_step(void* out, const void* buf, const uint8_t* flags, const int* offsets,
                         const int* sources, const int* long_rows, int n_long, int S, int m,
                         int long_cut, float alpha, const void* start, uint8_t* flags_out,
                         float* sizes, int* changed, cudaStream_t stream) {
    if (!hll_shape_ok(m) || S < 0 || n_long < 0 || long_cut < 0 || out == buf ||
        (start != nullptr) != (changed != nullptr) ||
        ((sizes != nullptr || flags_out != nullptr) && start == nullptr) ||
        !hll_aligned(out, m) || !hll_aligned(buf, m) ||
        (start != nullptr && !hll_aligned(start, m)))
        return cudaErrorInvalidValue;
    if (changed != nullptr) {
        cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    if (S == 0) return cudaSuccess;
    uint8_t* o = static_cast<uint8_t*>(out);
    MergeArgs a{o, static_cast<const uint8_t*>(buf), static_cast<const uint8_t*>(start), flags,
                offsets, sources, long_rows, 0, long_cut, S, static_cast<float>(m), alpha, o,
                flags_out, sizes, changed};
    return merge(m, a, n_long, stream);
}

// K6b: regs u8[n, m] -> sizes f32[n]; m a power of two, 1..65,536.
int stract_hll_estimate(const void* regs, int n, int m, float alpha, float* sizes,
                        cudaStream_t stream) {
    if (!hll_shape_ok(m) || n < 0 || !hll_aligned(regs, m)) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    const uint8_t* r = static_cast<const uint8_t*>(regs);
    switch (m) {
#define STRACT_HLL_ESTIMATE(M, VEC, LANES, PPL, BYTES) \
    case M: return launch_estimate<VEC, LANES, PPL, BYTES>(r, n, alpha, sizes, stream);
        STRACT_HLL_WIDTHS(STRACT_HLL_ESTIMATE)
#undef STRACT_HLL_ESTIMATE
#define STRACT_HLL_ESTIMATE_WIDE(M, T, PPL) \
    case M: return launch_wide_estimate<T, PPL>(r, n, alpha, sizes, stream);
        STRACT_HLL_WIDE(STRACT_HLL_ESTIMATE_WIDE)
#undef STRACT_HLL_ESTIMATE_WIDE
        default: return cudaErrorInvalidValue;
    }
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
