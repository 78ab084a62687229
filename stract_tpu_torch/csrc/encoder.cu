// The BERT encoder's kernels on Hopper (sm_90a): K5a masked self-attention
// (attention_kernel and attention_long_kernel, here), K14a its backward (the
// dQ and dK / dV kernels below them), K5c bias + tanh GELU
// (bias_gelu_kernel), K5b the residual + LayerNorm (add_layernorm_kernel)
// and K14b its backward (add_layernorm_bwd_kernel), K14c the bias + GELU
// backward (bias_gelu_bwd_kernel), and K5d the masked mean pool and its
// backward (mean_pool_kernel, mean_pool_bwd_kernel, last). Each has its
// note above its code: what it replaces, what bounds it on the card and
// what its design does about that. In short: all seven move little data
// and compute less, so device memory bounds them; K5a and K14a take their
// products to the tensor cores (wgmma on cp.async-staged tiles) and spend
// what is left in the f32 softmax and one load-compute-store pass a block;
// K5c reads and writes 16 bytes a thread with the bias from the index; K5b
// and K14b take a row a warp and share its statistics' routine, K14b sums
// its column partials without atomics; K14c takes K5c's pieces and sums its
// column partials as K14b does; K5d takes a batch row a block forward and
// (batch row, token span) blocks backward, with fixed-order sums.
//
// K5a replaces the body of stract_tpu/models/bert.py:97-103 (BertSelfAttention):
// scores = q.k^T in f32 / sqrt(d), masked keys set to finfo(f32).min, softmax
// in f32, probabilities cast to bf16, P.V accumulated in f32, context cast to
// bf16 and laid out [B, T, heads * d]. The q/k/v projections and the output
// projection stay outside (bf16 matrix products, as the JAX package leaves
// them to XLA's dot).
//
// Shapes: head dim d in {16, 32, 64} (BertConfig.tiny, MiniLM, BERT-base and
// -large), a template parameter; any T >= 1 (the reference clamps its
// positions at 511 and attends over any length), a runtime argument; batch
// rows and heads up to the grid's 65,535.
// What bounds it: a query row needs 2 T d multiply-adds for its scores and
// as many for P.V, about T / 2 flops per byte of q, k, v and context moved,
// far below the ~295 at which the bf16 tensor cores would bind: device
// memory bounds it (3.8 us at B = 32, 12 x 32, T = 128). Beside the
// tensor-core products the kernel spends its time in the f32 softmax (an
// exp and two IEEE divisions a score, as the reference computes them) and
// in the latency of one load-compute-store pass per block.
// The design: one warpgroup (4 warps) per (64-query tile, head, batch row).
// The tile's Q rows and the K and V of the (batch row, head) go into shared
// memory by 16-byte cp.async copies (rows past T zero-filled) in the
// canonical no-swizzle layout of wgmma operands: 8-row by 16-byte core
// matrices, an 8-row group's d / 8 core matrices (d columns) in 16 d
// contiguous bytes. S = Q.K^T runs as wgmma m64n64k16
// (bf16 in, f32 accumulated), d / 16 k-steps, for each 64-key chunk. The
// probabilities, rounded to bf16, are the A operand of O = P.V straight
// from registers (wgmma m64ndk16: the f32 accumulator fragment of a 16-key
// slice is the A fragment of that k-step, packed in pairs), with V read
// from shared memory as an N-major (transposed) B operand: V is staged in
// the same layout as K, and an 8-key by 8-dimension core matrix of V is an
// 8 x 16 byte block of it. Two forms of the softmax:
//   - one pass (attention_kernel, T <= 256 at d <= 32, T <= 128 at d = 64):
//     K and V staged whole, all chunks' scores in registers (32 floats a
//     thread a chunk), an exact two-pass row softmax in registers (the four
//     lanes of a quad hold a row: max and sum by two shuffles);
//   - chunked (attention_long_kernel, the longer rows): pass 1 walks the
//     key chunks for the row max and sum (the running sum scaled by
//     exp(old max - new max) when the max grows: exp(0) = 1, exact, when it
//     does not), pass 2 computes each chunk's scores again and forms
//     p = exp(s - max) / sum, rounds it to bf16 and feeds it to P.V, so the
//     normalised probabilities round to bf16 as the reference's do
//     (bert.py:101-102); registers do not grow with T. K and V stream
//     through double buffers, a chunk's cp.async copies in flight while the
//     one before it computes (stream_chunks), and so does the chunk's key
//     mask (64 ints by 4-byte cp.async): 41 KB of shared memory at d = 64
//     for any T, so five blocks share an SM, and nothing staged grows with
//     T. A first build staged K and V whole (141 KB at T = 512, d = 64: one
//     block, one warpgroup an SM) and took 0.358 ms at B = 8, 12 heads of 64
//     (SDPA 0.029) on the H100; a later one staged the whole mask (4 bytes a
//     key: past ~45,000 tokens at d = 64 it would leave a block's 227 KB).
// Keys past T are padding of the 64-key chunk: zero in shared memory and
// left out of the row max and sum. Masked keys inside T take
// finfo(f32).min and stay in, so a fully masked row is finite with uniform
// weights, as in the reference. Query rows past T are not stored.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "col_sum.cuh"

namespace {

constexpr int kTile = 64;             // query rows of a block, keys of a chunk
constexpr int kThreads = 128;         // one warpgroup
constexpr int kCoreBytes = 128;       // a core matrix: 8 rows x 16 bytes
constexpr size_t kDefaultSmem = 48 * 1024;  // above it a kernel must opt in

// a staged 64-row tile of head dim D
template <int D>
struct Tile {
    static_assert(D == 16 || D == 32 || D == 64, "head dim 16, 32 or 64");
    static constexpr int kGroupBytes = 16 * D;  // an 8-row group: D / 8 core matrices
    static constexpr int kBytes = kTile * D * 2;
    static constexpr int kRowPieces = D / 8;    // 16-byte pieces of a row
    static constexpr int kSteps = D / 16;       // wgmma k-steps over the head dim
};

// the most 64-key chunks whose scores the one-pass kernels hold in registers
// (32 a thread a chunk beside a [64 x D] accumulator of D / 2)
template <int D>
constexpr int kHeldChunks = D == 64 ? 2 : 4;

// the byte offset of 16-byte piece c of row r in a staged tile
template <int D>
__device__ __forceinline__ uint32_t staged(int r, int c) {
    return (r >> 3) * Tile<D>::kGroupBytes + c * kCoreBytes + (r & 7) * 16;
}

// a wgmma shared-memory descriptor, no swizzle: start address, the byte
// offset between core matrices adjacent along K (leading) and along M or N
// (stride), each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t leading, uint32_t stride) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(leading >> 4) << 16) |
           (static_cast<uint64_t>(stride >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(bytes));
}

// a 4-byte copy (src_bytes 0: zero-fill, src not read)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(bytes));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, 1, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(a), "l"(b));
}

// d[64 x D] += A[64 x 16] . B[16 x D], A in registers (bf16 pairs), B
// N-major in shared memory (the transpose bit set)
template <int D>
__device__ __forceinline__ void wgmma_context(float (&d)[D / 2], const uint32_t (&a)[4],
                                              uint64_t b) {
    if constexpr (D == 16) {
        asm volatile(
            "{\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    } else if constexpr (D == 32) {
        asm volatile(
            "{\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    } else {
        asm volatile(
            "{\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
            "}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
}

// keep the compiler from reading (or writing) wgmma registers across the
// wait: a new definition of each register after it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// x / d, rounded as the division rounds, with x == 0 answered without
// dividing: the division's fast path refuses a zero dividend and calls a
// slow subroutine, which the scores of zero-filled keys and the weights of
// masked keys (exactly 0) would take in bulk (3x K5a's time at T = 193)
__device__ __forceinline__ float div_nonzero(float x, float d) {
    if (x == 0.0f) return x;
    return x / d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// packed bf16x2 ops, each half rounded to nearest even
__device__ __forceinline__ uint32_t bmul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t badd(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bsub(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// x0, x1 as hi + lo, each a bf16 pair packed for an A fragment
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a row's max and sum over the four lanes of its quad
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows first .. first + rows - 1 of a [T, H * D] tensor's head (src points
// at row 0 of it) into a staged tile by 16-byte cp.async; rows past T fill zeros
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const __nv_bfloat16* src, int first,
                                           int rows, int T, long long row_stride) {
    constexpr int kPieces = Tile<D>::kRowPieces;
    for (int i = threadIdx.x; i < rows * kPieces; i += kThreads) {
        const int r = i / kPieces, c = i % kPieces, t = first + r;
        cp_async16(dst + staged<D>(r, c), src + (t < T ? t * row_stride : 0) + c * 8,
                   t < T ? 16 : 0);
    }
}

// each key's place in the softmax, keys 0 .. keys - 1 of batch row b: 1
// kept, 0 masked (finfo(f32).min), -1 past T (left out)
__device__ __forceinline__ void stage_keep(float* keep, const int* mask, int b, int keys, int T) {
    for (int j = threadIdx.x; j < keys; j += kThreads)
        keep[j] = j >= T ? -1.0f : (mask[static_cast<long long>(b) * T + j] != 0 ? 1.0f : 0.0f);
}

// d[64 x 64] = A.B^T over the head dimension, A and B staged 64-row tiles:
// issued, not waited for. K-major A and B, core matrices 128 bytes apart
// along K and a group apart along M / N; a k-step of 16 columns is two core
// matrices (256 bytes)
template <int D>
__device__ __forceinline__ void issue_tile_product(float (&d)[32], const unsigned char* a,
                                                   const unsigned char* b) {
    constexpr uint32_t G = Tile<D>::kGroupBytes;
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < Tile<D>::kSteps; ++ks)
        wgmma_scores(d, smem_desc(a + ks * 256, kCoreBytes, G),
                     smem_desc(b + ks * 256, kCoreBytes, G));
}

template <int D>
__device__ __forceinline__ void tile_product(float (&d)[32], const unsigned char* a,
                                             const unsigned char* b) {
    issue_tile_product<D>(d, a, b);
    wgmma_commit_and_wait();
    fence_regs(d);
}

// S[64 x 64 c .. 64 c + 63] = Q.K^T for every 64-key chunk c of the staged
// K rows, in registers. s[c][4j + e] is row 16 warp + lane / 4 (+ 8 for
// e >= 2), key 64 c + 8 j + 2 (lane % 4) + (e & 1)
template <int D, int CHUNKS>
__device__ __forceinline__ void chunk_scores(float (&s)[CHUNKS][32], const unsigned char* q_tile,
                                             const unsigned char* k_rows) {
    constexpr uint32_t G = Tile<D>::kGroupBytes;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) s[c][i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) fence_regs(s[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int ks = 0; ks < Tile<D>::kSteps; ++ks)
            wgmma_scores(s[c], smem_desc(q_tile + ks * 256, kCoreBytes, G),
                         smem_desc(k_rows + c * Tile<D>::kBytes + ks * 256, kCoreBytes, G));
    wgmma_commit_and_wait();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) fence_regs(s[c]);
}

// one 64-key chunk's scores scaled (divided by sqrt(d) when DIVIDE, else
// multiplied by its reciprocal), masked keys at finfo(f32).min; the max of
// the keys inside T into mx[row] (keep: the chunk's entries of stage_keep)
template <bool DIVIDE>
__device__ __forceinline__ void mask_scores(float (&s)[32], const float* keep, float scale,
                                            float (&mx)[2]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
        const float k = keep[(i / 4) * 8 + 2 * (lane % 4) + (i & 1)];
        const float x = k > 0.0f ? (DIVIDE ? div_nonzero(s[i], scale) : s[i] * scale) : -FLT_MAX;
        s[i] = x;
        if (k >= 0.0f) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
}

// the B descriptor of k-step kk (16 rows) of a staged tile read N-major:
// core matrices (8 rows x 8 dimensions) a group apart along K and 128 bytes
// apart along N
template <int D>
__device__ __forceinline__ uint64_t rows_desc(const unsigned char* tile, int kk) {
    constexpr uint32_t G = Tile<D>::kGroupBytes;
    return smem_desc(tile + kk * 2 * G, G, kCoreBytes);
}

// a 64-row tile's [64 x D] f32 accumulator (acc[4j + e]: row 16 warp +
// lane / 4 (+ 8 for e >= 2), column 8 j + 2 (lane % 4) + (e & 1)) as bf16
// into rows first .. first + 63 of a [T, H * D] tensor's head (dst at its
// row 0); rows past T are not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 2],
                                           int first, int T, long long row_stride) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int t = first + 16 * warp + lane / 4 + 8 * r;
        if (t >= T) continue;
        __nv_bfloat16* row = dst + t * row_stride;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

template <int D>
size_t attention_smem_bytes(int chunks) {
    return static_cast<size_t>(Tile<D>::kBytes) * (1 + 2 * chunks) +  // Q tile; K and V
           static_cast<size_t>(chunks) * kTile * sizeof(float);      // the mask
}

// the chunked kernel: Q tile, two chunks of K and of V and of the mask
template <int D>
constexpr size_t attention_long_smem_bytes() {
    return static_cast<size_t>(Tile<D>::kBytes) * 5 + 2 * kTile * sizeof(int);
}

// the shared staging of both forward kernels: the query tile, K and V of
// `chunks` 64-key chunks and the keys' places → (s_q, s_k, s_v, s_keep)
template <int D>
__device__ __forceinline__ void stage_forward(unsigned char* smem, const __nv_bfloat16* q,
                                              const __nv_bfloat16* k, const __nv_bfloat16* v,
                                              const int* mask, int chunks, int T, int H,
                                              unsigned char*& s_q, unsigned char*& s_k,
                                              unsigned char*& s_v, float*& s_keep) {
    constexpr int kBytes = Tile<D>::kBytes;
    s_q = smem;
    s_k = s_q + kBytes;
    s_v = s_k + chunks * kBytes;
    s_keep = reinterpret_cast<float*>(s_v + chunks * kBytes);
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(b) * T * row_stride + h * D;
    stage_rows<D>(s_q, q + base, q0, kTile, T, row_stride);
    stage_rows<D>(s_k, k + base, 0, chunks * kTile, T, row_stride);
    stage_rows<D>(s_v, v + base, 0, chunks * kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage_keep(s_keep, mask, b, chunks * kTile, T);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // the copies and stores above are generic-proxy writes; wgmma reads
    // shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
}

// what streams beside a chunk's rows: nothing, a key chunk's 64 mask
// entries (made the keys' places, as stage_keep gives them), or a query
// chunk's 64 x 3 statistics (max, 1 / sum, D, as dkv_chunk reads them),
// each into one of two buffers by 4-byte cp.async, zero-filled past T.
// start(c) is called as chunk c's rows are, ready(c) after they land, by
// each thread for its own copies
struct NoSide {
    __device__ __forceinline__ void start(int) const {}
    __device__ __forceinline__ void ready(int) const {}
};

struct MaskSide {
    const int* m;  // the batch row's mask
    int* buf;      // two chunks' 64 entries: the mask, then the places
    int T;
    __device__ __forceinline__ void start(int c) const {
        for (int j = threadIdx.x; j < kTile; j += kThreads) {
            const int key = c * kTile + j;
            cp_async4(buf + (c & 1) * kTile + j, m + (key < T ? key : 0), key < T ? 4 : 0);
        }
    }
    __device__ __forceinline__ void ready(int c) const {  // 1 kept, 0 masked, -1 past T
        for (int j = threadIdx.x; j < kTile; j += kThreads) {
            int* x = buf + (c & 1) * kTile + j;
            const float place = c * kTile + j >= T ? -1.0f : (*x != 0 ? 1.0f : 0.0f);
            *reinterpret_cast<float*>(x) = place;
        }
    }
    __device__ __forceinline__ const float* keep(int c) const {
        return reinterpret_cast<const float*>(buf + (c & 1) * kTile);
    }
};

struct StatSide {
    const float* st;  // the (batch row, head)'s [T, 3] statistics
    float* buf;       // two chunks' 64 x 3
    int T;
    __device__ __forceinline__ void start(int c) const {
        for (int j = threadIdx.x; j < 3 * kTile; j += kThreads) {
            const long long i = 3LL * c * kTile + j;
            const bool in = c * kTile + j / 3 < T;
            cp_async4(buf + (c & 1) * 3 * kTile + j, st + (in ? i : 0), in ? 4 : 0);
        }
    }
    __device__ __forceinline__ void ready(int c) const {  // the sums as their reciprocals
        for (int j = threadIdx.x; j < 3 * kTile; j += kThreads)
            if (j % 3 == 1) {
                float* x = buf + (c & 1) * 3 * kTile + j;
                *x = __frcp_rn(*x);
            }
    }
    __device__ __forceinline__ const float* chunk(int c) const {
        return buf + (c & 1) * 3 * kTile;
    }
};

// the 64-row chunks of one or two [T, H * D] heads (a, and b unless null;
// src at row 0) through double buffers of shared memory, and `side`'s
// entries with them: chunk c + 1 is copied by cp.async while fn(c, a's
// tile, b's tile) computes on chunk c. Copies started before the call (a
// query tile) land before fn's first call
template <int D, typename S, typename F>
__device__ __forceinline__ void stream_chunks(int chunks, int T, long long row_stride,
                                              const __nv_bfloat16* a, const __nv_bfloat16* b,
                                              unsigned char* a_buf, unsigned char* b_buf,
                                              const S& side, F&& fn) {
    constexpr int kBytes = Tile<D>::kBytes;
    auto load = [&](int c) {
        if (c < chunks) {
            stage_rows<D>(a_buf + (c & 1) * kBytes, a, c * kTile, kTile, T, row_stride);
            if (b) stage_rows<D>(b_buf + (c & 1) * kBytes, b, c * kTile, kTile, T, row_stride);
            side.start(c);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty past the last chunk
    };
    load(0);
    for (int c = 0; c < chunks; ++c) {
        load(c + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // all but chunk c + 1's
        side.ready(c);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        fn(c, a_buf + (c & 1) * kBytes, b_buf + (c & 1) * kBytes);
        __syncthreads();  // chunk c's buffers are read before chunk c + 2 fills them
    }
}

// K5a, one pass: CHUNKS 64-key chunks, ceil(T / 64), 1 .. kHeldChunks<D>
template <int D, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int T, int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char *s_q, *s_k, *s_v;
    float* s_keep;
    stage_forward<D>(smem, q, k, v, mask, CHUNKS, T, H, s_q, s_k, s_v, s_keep);
    const int lane = threadIdx.x % 32;

    float s[CHUNKS][32];
    chunk_scores<D, CHUNKS>(s, s_q, s_k);

    // the reference divides the f32 scores by np.sqrt(head_dim) rounded to f32
    const float scale_div = sqrtf(static_cast<float>(D));
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) mask_scores<true>(s[c], s_keep + c * kTile, scale_div, mx);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            const float e = key < T ? expf(s[c][i] - mx[(i >> 1) & 1]) : 0.0f;
            s[c][i] = e;
            sum[(i >> 1) & 1] += e;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);

    // O = bf16(P).V: k-step kk covers keys 16 kk .. 16 kk + 15, the
    // accumulator registers 8 (kk % 4) .. + 7 of chunk kk / 4
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    uint32_t a[CHUNKS * 4][4];
#pragma unroll
    for (int kk = 0; kk < CHUNKS * 4; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = 8 * (kk % 4) + 2 * j;
            a[kk][j] = pack_bf16(div_nonzero(s[kk / 4][i], sum[j & 1]),
                                 div_nonzero(s[kk / 4][i + 1], sum[j & 1]));
        }
        fence_regs(a[kk]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CHUNKS * 4; ++kk) wgmma_context<D>(o, a[kk], rows_desc<D>(s_v, kk));
    wgmma_commit_and_wait();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < CHUNKS * 4; ++kk) fence_regs(a[kk]);

    const long long row_stride = static_cast<long long>(H) * D;
    store_rows<D>(out + static_cast<long long>(blockIdx.z) * T * row_stride + blockIdx.y * D, o,
                  blockIdx.x * kTile, T, row_stride);
}

// K5a, chunked: any T, the scores of one 64-key chunk at a time; K, V and the
// chunk's mask stream through double buffers (five tiles of shared memory
// and 512 bytes in all, for any T, so several blocks share an SM)
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_long_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                      __nv_bfloat16* __restrict__ out, int T, int H) {
    constexpr int kBytes = Tile<D>::kBytes;
    const int chunks = (T + kTile - 1) / kTile;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_q = smem;
    unsigned char* s_k = s_q + kBytes;      // two chunks' K
    unsigned char* s_v = s_k + 2 * kBytes;  // two chunks' V
    const int b = blockIdx.z, lane = threadIdx.x % 32;
    const MaskSide side{mask + static_cast<long long>(b) * T,
                        reinterpret_cast<int*>(s_v + 2 * kBytes), T};
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(b) * T * row_stride + blockIdx.y * D;
    stage_rows<D>(s_q, q + base, blockIdx.x * kTile, kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float scale_div = sqrtf(static_cast<float>(D));

    // pass 1: the row max and sum (each lane's part of the sum, scaled when
    // the row max grows)
    float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.0f, 0.0f};
    stream_chunks<D>(chunks, T, row_stride, k + base, nullptr, s_k, nullptr, side,
                     [&](int c, const unsigned char* kt, const unsigned char*) {
        float s[32];
        tile_product<D>(s, s_q, kt);
        float cm[2] = {-FLT_MAX, -FLT_MAX};
        mask_scores<true>(s, side.keep(c), scale_div, cm);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m = fmaxf(mx[r], quad_max(cm[r]));
            sum[r] *= expf(mx[r] - m);
            mx[r] = m;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            if (key < T) sum[(i >> 1) & 1] += expf(s[i] - mx[(i >> 1) & 1]);
        }
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);

    // pass 2: O = bf16(exp(s - max) / sum).V, a chunk's four k-steps at a time
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    stream_chunks<D>(chunks, T, row_stride, k + base, v + base, s_k, s_v, side,
                     [&](int c, const unsigned char* kt, const unsigned char* vt) {
        float s[32];
        tile_product<D>(s, s_q, kt);
        float unused[2] = {-FLT_MAX, -FLT_MAX};
        mask_scores<true>(s, side.keep(c), scale_div, unused);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = 8 * kk + 2 * j;
                const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4);
                const float e0 = key < T ? expf(s[i] - mx[j & 1]) : 0.0f;
                const float e1 = key + 1 < T ? expf(s[i + 1] - mx[j & 1]) : 0.0f;
                a[kk][j] = pack_bf16(div_nonzero(e0, sum[j & 1]), div_nonzero(e1, sum[j & 1]));
            }
            fence_regs(a[kk]);
        }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_context<D>(o, a[kk], rows_desc<D>(vt, kk));
        wgmma_commit_and_wait();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    });
    store_rows<D>(out + base, o, blockIdx.x * kTile, T, row_stride);
}

// K14a: the gradient of the kernels above, as jax.vjp differentiates the
// reference body (the training steps of stract_tpu/entrypoint/
// train_encoders.py:244 and parallel/train.py:87,115 through bert.py:97-103).
// With g = f32(dO): dV = bf16(Pb^T g) with Pb = bf16(P), the probabilities
// the forward multiplies V by; dP = bf16(g V^T) (the cotangent of the bf16
// probabilities); dS = P dP - P rowsum(P dP) with the f32 P (softmax's
// gradient); masked keys get dS = 0 (the gradient of the where); then
// dQ = bf16(dS K / sqrt(d)) and dK = bf16(dS^T Q / sqrt(d)).
//
// What bounds it: each (batch row, head) reads q, k, v and dO once and
// writes dq, dk, dv (64 B a token each at d = 32: 0.0132 ms at B = 64,
// T = 128), and its five products of T^2 d multiply-adds each are below the
// bf16 ridge on the tensor cores, so the bytes bind; beside them the f32
// softmax and its gradient (an exp and a dozen other operations a score, in
// each kernel) and the latency of one unpipelined load-compute-store pass a
// block. The design: two kernels on K5a's tiles (the staged layout, the
// descriptors, cp.async, wgmma), one warpgroup a block, grid (64-row
// tiles, heads, batch rows), no atomics (each output row has one writer,
// so two calls are bit-equal):
//   1. the dQ kernel, a 64-query tile: Q and dO tiles, K and V whole in
//      shared memory. One pass (T <= 256 at d <= 32, T <= 128 at d = 64):
//      S = Q.K^T and the masked two-pass softmax as K5a computes it (all
//      chunks' P in registers); dP = dO.V^T by wgmma a 64-key chunk at a
//      time, rounded to bf16, gives D = rowsum(P dP); dP is computed again
//      (two wgmma a chunk: cheaper than 128 more registers or 32 KB of
//      shared memory) for dS, and dQ = dS.K takes dS from registers as the
//      A operand and K as the N-major B (V's role in K5a). Chunked (the
//      longer rows): three passes over the key chunks, nothing of a chunk
//      kept in registers between them: the row max and sum (as K5a's
//      chunked pass 1), then S and dP again for D, then S and dP again for
//      dS and dQ, K, V and the mask streamed as in K5a's chunked kernel.
//      The row's max, sum and D go to an f32 scratch [B, H, T, 3] the
//      wrapper allocates.
//   2. the dK / dV kernel, a 64-key tile: K and V tiles, Q, dO and the
//      scratch whole; a 64-query chunk at a time S^T = K.Q^T and
//      dP^T = V.dO^T (one wait for both), P^T from the scratch's max and
//      sum by the first kernel's expressions, dS^T from its D;
//      dV += bf16(P^T).dO and dK += dS^T.Q, both with the A operand from
//      registers. Its registers do not grow with T: the query chunks are a
//      loop, unrolled over Q and dO staged whole up to K5a's one-pass
//      lengths, beyond them Q, dO and the chunk's 64 x 3 statistics
//      streamed through double buffers (the statistics staged whole, 12
//      bytes a query, would leave a block's 227 KB at ~15,000 tokens at
//      d = 64); no shared memory of the chunked kernels grows with T.
// The divisions: by sqrt(d) and by the row sum, each score is multiplied
// by the correctly rounded reciprocal instead (what PyTorch does for the
// twin's division by the scalar sqrt(d) on the card; within an ulp of the
// division for the row sum). A first build with IEEE divisions (three a
// score in each kernel) and two waits a chunk in the second kernel took
// twice the card time (0.190 against 0.094 ms at B = 64, T = 128 on the
// H100), and a multiplication has no slow path, so a zero dividend
// (zero-filled rows, masked keys' weights, dS of an underflowed P) costs
// nothing. The exponent is __expf (ex2.approx of x log2(e), as Triton's
// tl.exp; a few ulp of f32, far under a bf16 step): expf's accurate path
// took 8 % more card time at T = 128 and 15 % more at T = 256.
// The f32 operand: the reference multiplies an f32 dS by K and Q; a bf16
// wgmma would round dS to 8 bits first. dS is split into hi = bf16(dS) and
// lo = bf16(dS - hi) (the difference is exact in f32), and both go into
// one f32 accumulator: 16 bits of dS, error <= 2^-17 |dS| a term, far under
// the bf16 rounding of dQ and dK. Chosen over tf32 (k8) because it keeps
// the register-A bf16 product of K5a and needs no f32 staging of K and Q
// (tf32 wgmma takes no transposed B). The other three products (S, dP, dV)
// have exact bf16 inputs. Shared memory: 41,984 and 44,032 bytes at
// T = 256, d = 32 (one pass); chunked, 49,664 and 50,688 at d = 64 for any
// T (a kernel opts in above 48 KB).
// Registers: the one-pass dQ kernel holds P of all chunks
// (128 a thread at T > 192, d = 32: ~250 registers, two blocks an SM), as
// K5a. Masked keys stay in the softmax at finfo(f32).min, so a fully masked
// row has uniform weights and dQ = 0; keys past T are zero-filled and left
// out of the sums; query rows past T are not stored, and the second kernel
// gives them P = dS = 0.

// dS / sqrt(d) of one score (0 at a masked key), as the twin computes it
__device__ __forceinline__ float grad_score(float p, float dp, float dsum, bool keep,
                                            float inv_scale) {
    return keep ? (p * dp - p * dsum) * inv_scale : 0.0f;
}

// 1 / sqrt(d) rounded to f32: the twin's division by the scalar sqrt(d) on
// the card (PyTorch multiplies by the scalar's f32 reciprocal)
template <int D>
__device__ __forceinline__ float inv_sqrt_head_dim() {
    return __frcp_rn(sqrtf(static_cast<float>(D)));
}

template <int D>
size_t backward_dq_smem_bytes(int chunks) {
    return 2 * static_cast<size_t>(Tile<D>::kBytes) * (1 + chunks) +  // Q, dO tiles; K, V
           static_cast<size_t>(chunks) * kTile * sizeof(float);        // the mask
}

template <int D>
size_t backward_dkv_smem_bytes(int chunks) {
    return 2 * static_cast<size_t>(Tile<D>::kBytes) * (1 + chunks) +  // K, V tiles; Q, dO
           3 * static_cast<size_t>(chunks) * kTile * sizeof(float);    // max, sum, D a query
}

// the chunked kernels: two tiles (Q and dO, or K and V) and two chunks of the
// other two, and of the mask or of the queries' statistics
template <int D>
constexpr size_t backward_dq_long_smem_bytes() {
    return 6 * static_cast<size_t>(Tile<D>::kBytes) + 2 * kTile * sizeof(int);
}

template <int D>
constexpr size_t backward_dkv_long_smem_bytes() {
    return 6 * static_cast<size_t>(Tile<D>::kBytes) + 2 * 3 * kTile * sizeof(float);
}

// the dQ kernels' staging: the query tile's Q and dO, K and V of `chunks`
// 64-key chunks and the keys' places → (s_q, s_do, s_k, s_v, s_keep)
template <int D>
__device__ __forceinline__ void stage_dq(unsigned char* smem, const __nv_bfloat16* q,
                                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         const int* mask, const __nv_bfloat16* dout,
                                         int chunks, int T, long long base,
                                         long long row_stride, unsigned char*& s_q,
                                         unsigned char*& s_do, unsigned char*& s_k,
                                         unsigned char*& s_v, float*& s_keep) {
    constexpr int kBytes = Tile<D>::kBytes;
    s_q = smem;
    s_do = s_q + kBytes;
    s_k = s_do + kBytes;
    s_v = s_k + chunks * kBytes;
    s_keep = reinterpret_cast<float*>(s_v + chunks * kBytes);
    const int q0 = blockIdx.x * kTile;
    stage_rows<D>(s_q, q + base, q0, kTile, T, row_stride);
    stage_rows<D>(s_do, dout + base, q0, kTile, T, row_stride);
    stage_rows<D>(s_k, k + base, 0, chunks * kTile, T, row_stride);
    stage_rows<D>(s_v, v + base, 0, chunks * kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage_keep(s_keep, mask, blockIdx.z, chunks * kTile, T);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
}

// each query row's max, sum and D into the scratch
__device__ __forceinline__ void store_stats(float* stats, const float (&mx)[2],
                                            const float (&sum)[2], const float (&dsum)[2], int T,
                                            int H) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane % 4) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int t = blockIdx.x * kTile + 16 * warp + lane / 4 + 8 * r;
        if (t >= T) continue;
        float* st = stats + ((static_cast<long long>(blockIdx.z) * H + blockIdx.y) * T + t) * 3;
        st[0] = mx[r];
        st[1] = sum[r];
        st[2] = dsum[r];
    }
}

// dQ += (dS / sqrt(d)).K over one 64-key chunk (its K tile kt): dS from
// the chunk's p (0 past T), bf16(dp) and the row's D, split hi + lo; k-step
// kk covers the chunk's keys 16 kk .. + 15, registers 8 kk .. 8 kk + 7
template <int D>
__device__ __forceinline__ void dq_chunk(float (&acc)[D / 2], const float (&p)[32],
                                         const float (&dp)[32], const float (&dsum)[2],
                                         const float* keep, const unsigned char* kt,
                                         float inv_scale) {
    const int lane = threadIdx.x % 32;
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const int key = (i / 4) * 8 + 2 * (lane % 4);
            const float d = dsum[j & 1];
            split_bf16(grad_score(p[i], round_bf16(dp[i]), d, keep[key] > 0.0f, inv_scale),
                       grad_score(p[i + 1], round_bf16(dp[i + 1]), d, keep[key + 1] > 0.0f,
                                  inv_scale),
                       hi[kk][j], lo[kk][j]);
        }
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        wgmma_context<D>(acc, hi[kk], rows_desc<D>(kt, kk));
        wgmma_context<D>(acc, lo[kk], rows_desc<D>(kt, kk));
    }
    wgmma_commit_and_wait();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
    }
}

// K14a's dQ kernel, one pass: CHUNKS = ceil(T / 64), 1 .. kHeldChunks<D>
template <int D, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
attention_backward_dq_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int T,
                             int H) {
    constexpr int kBytes = Tile<D>::kBytes;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x % 32;
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(blockIdx.z) * T * row_stride + blockIdx.y * D;
    unsigned char *s_q, *s_do, *s_k, *s_v;
    float* s_keep;
    stage_dq<D>(smem, q, k, v, mask, dout, CHUNKS, T, base, row_stride, s_q, s_do, s_k, s_v,
                s_keep);

    // S = Q.K^T for every chunk, then P by K5a's masked two-pass softmax
    // with the reciprocals and __expf
    float p[CHUNKS][32];
    chunk_scores<D, CHUNKS>(p, s_q, s_k);
    const float inv_scale = inv_sqrt_head_dim<D>();
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) mask_scores<false>(p[c], s_keep + c * kTile, inv_scale, mx);
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            const float e = key < T ? __expf(p[c][i] - mx[(i >> 1) & 1]) : 0.0f;
            p[c][i] = e;
            sum[(i >> 1) & 1] += e;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);
    const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) p[c][i] *= rsum[(i >> 1) & 1];

    // D = rowsum(P bf16(dO.V^T)), a key chunk at a time
    float dsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        float dp[32];
        tile_product<D>(dp, s_do, s_v + c * kBytes);
#pragma unroll
        for (int i = 0; i < 32; ++i) dsum[(i >> 1) & 1] += p[c][i] * round_bf16(dp[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) dsum[r] = quad_sum(dsum[r]);
    store_stats(stats, mx, sum, dsum, T, H);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
        float dp[32];
        tile_product<D>(dp, s_do, s_v + c * kBytes);
        dq_chunk<D>(acc, p[c], dp, dsum, s_keep + c * kTile, s_k + c * kBytes, inv_scale);
    }
    store_rows<D>(dq + base, acc, blockIdx.x * kTile, T, row_stride);
}

// K14a's dQ kernel, chunked: any T, one 64-key chunk's scores at a time in
// three passes, K, V and the chunk's mask streamed through double buffers
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_backward_dq_long_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const int* __restrict__ mask,
                                  const __nv_bfloat16* __restrict__ dout,
                                  __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                                  int T, int H) {
    constexpr int kBytes = Tile<D>::kBytes;
    const int chunks = (T + kTile - 1) / kTile;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_q = smem;
    unsigned char* s_do = s_q + kBytes;
    unsigned char* s_k = s_do + kBytes;     // two chunks' K
    unsigned char* s_v = s_k + 2 * kBytes;  // two chunks' V
    const MaskSide side{mask + static_cast<long long>(blockIdx.z) * T,
                        reinterpret_cast<int*>(s_v + 2 * kBytes), T};
    const int lane = threadIdx.x % 32;
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(blockIdx.z) * T * row_stride + blockIdx.y * D;
    stage_rows<D>(s_q, q + base, blockIdx.x * kTile, kTile, T, row_stride);
    stage_rows<D>(s_do, dout + base, blockIdx.x * kTile, kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float inv_scale = inv_sqrt_head_dim<D>();

    // pass 1: the row max and sum, as K5a's chunked pass 1 (with __expf)
    float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.0f, 0.0f};
    stream_chunks<D>(chunks, T, row_stride, k + base, nullptr, s_k, nullptr, side,
                     [&](int c, const unsigned char* kt, const unsigned char*) {
        float s[32];
        tile_product<D>(s, s_q, kt);
        float cm[2] = {-FLT_MAX, -FLT_MAX};
        mask_scores<false>(s, side.keep(c), inv_scale, cm);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m = fmaxf(mx[r], quad_max(cm[r]));
            sum[r] *= __expf(mx[r] - m);
            mx[r] = m;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            if (key < T) sum[(i >> 1) & 1] += __expf(s[i] - mx[(i >> 1) & 1]);
        }
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);
    const float rsum[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};

    // chunk c's P (0 past T) and dP = dO.V^T, both products under one wait
    auto chunk = [&](int c, const unsigned char* kt, const unsigned char* vt, float (&s)[32],
                     float (&dp)[32]) {
        issue_tile_product<D>(s, s_q, kt);
        issue_tile_product<D>(dp, s_do, vt);
        wgmma_commit_and_wait();
        fence_regs(s);
        fence_regs(dp);
        float unused[2] = {-FLT_MAX, -FLT_MAX};
        mask_scores<false>(s, side.keep(c), inv_scale, unused);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            s[i] = key < T ? __expf(s[i] - mx[(i >> 1) & 1]) * rsum[(i >> 1) & 1] : 0.0f;
        }
    };

    // pass 2: D = rowsum(P bf16(dP))
    float dsum[2] = {0.0f, 0.0f};
    stream_chunks<D>(chunks, T, row_stride, k + base, v + base, s_k, s_v, side,
                     [&](int c, const unsigned char* kt, const unsigned char* vt) {
        float p[32], dp[32];
        chunk(c, kt, vt, p, dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dsum[(i >> 1) & 1] += p[i] * round_bf16(dp[i]);
    });
#pragma unroll
    for (int r = 0; r < 2; ++r) dsum[r] = quad_sum(dsum[r]);
    store_stats(stats, mx, sum, dsum, T, H);

    // pass 3: dQ
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    stream_chunks<D>(chunks, T, row_stride, k + base, v + base, s_k, s_v, side,
                     [&](int c, const unsigned char* kt, const unsigned char* vt) {
        float p[32], dp[32];
        chunk(c, kt, vt, p, dp);
        dq_chunk<D>(acc, p, dp, dsum, side.keep(c), kt, inv_scale);
    });
    store_rows<D>(dq + base, acc, blockIdx.x * kTile, T, row_stride);
}

// dK += dS^T.Q and dV += bf16(P^T).dO over one 64-query chunk c (its Q and
// dO tiles qt, dot; the chunk's queries' max, 1 / sum and D in st, three a
// query from the chunk's first; keep: this thread's two key rows kept)
template <int D>
__device__ __forceinline__ void dkv_chunk(float (&acc_k)[D / 2], float (&acc_v)[D / 2],
                                          const unsigned char* s_k, const unsigned char* s_v,
                                          const unsigned char* qt, const unsigned char* dot,
                                          int c, const float* st, const bool (&keep)[2], int T,
                                          float inv_scale) {
    const int lane = threadIdx.x % 32;
    // s[4j + e] and dp[4j + e]: key k0 + 16 warp + lane / 4 (+ 8 for
    // e >= 2), query 64 c + 8 j + 2 (lane % 4) + (e & 1)
    float s[32], dp[32];
    issue_tile_product<D>(s, s_k, qt);
    issue_tile_product<D>(dp, s_v, dot);
    wgmma_commit_and_wait();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pb[4][4], hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float pv[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int i = 8 * kk + 2 * j + e;
                const int t = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + e;
                pv[e] = ds[e] = 0.0f;
                if (t < T) {
                    const float* sq = st + 3 * (t - c * kTile);
                    const float x = keep[j & 1] ? s[i] * inv_scale : -FLT_MAX;
                    pv[e] = __expf(x - sq[0]) * sq[1];
                    ds[e] = grad_score(pv[e], round_bf16(dp[i]), sq[2], keep[j & 1], inv_scale);
                }
            }
            pb[kk][j] = pack_bf16(pv[0], pv[1]);
            split_bf16(ds[0], ds[1], hi[kk][j], lo[kk][j]);
        }
    fence_regs(acc_k);
    fence_regs(acc_v);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pb[kk]);
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        wgmma_context<D>(acc_v, pb[kk], rows_desc<D>(dot, kk));
        wgmma_context<D>(acc_k, hi[kk], rows_desc<D>(qt, kk));
        wgmma_context<D>(acc_k, lo[kk], rows_desc<D>(qt, kk));
    }
    wgmma_commit_and_wait();
    fence_regs(acc_k);
    fence_regs(acc_v);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pb[kk]);
        fence_regs(hi[kk]);
        fence_regs(lo[kk]);
    }
}

// the (batch row, head)'s [T, 3] statistics in the scratch
__device__ __forceinline__ const float* head_stats(const float* stats, int T, int H) {
    return stats + (static_cast<long long>(blockIdx.z) * H + blockIdx.y) * T * 3;
}

// this thread's two key rows of the dK / dV kernels' tile kept → keep
__device__ __forceinline__ void key_rows_kept(const int* mask, int T, bool (&keep)[2]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = blockIdx.x * kTile + 16 * warp + lane / 4 + 8 * r;
        keep[r] = key < T && mask[static_cast<long long>(blockIdx.z) * T + key] != 0;
    }
}

// the one-pass dK / dV kernel's statistics, all T queries' (the sum as its
// reciprocal), and this thread's two key rows kept → keep
__device__ __forceinline__ void stage_dkv_stats(float* s_stat, const float* stats, const int* mask,
                                                int T, int H, bool (&keep)[2]) {
    const float* st = head_stats(stats, T, H);
    for (int j = threadIdx.x; j < T * 3; j += kThreads)
        s_stat[j] = j % 3 == 1 ? __frcp_rn(st[j]) : st[j];
    key_rows_kept(mask, T, keep);
}

// K14a's dK / dV kernel, Q and dO staged whole: CHUNKS 64-query chunks,
// ceil(T / 64), 1 .. kHeldChunks<D>, unrolled
template <int D, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
attention_backward_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int T, int H) {
    constexpr int kBytes = Tile<D>::kBytes;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_k = smem;
    unsigned char* s_v = s_k + kBytes;
    unsigned char* s_q = s_v + kBytes;
    unsigned char* s_do = s_q + CHUNKS * kBytes;
    float* s_stat = reinterpret_cast<float*>(s_do + CHUNKS * kBytes);
    const int k0 = blockIdx.x * kTile;
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(blockIdx.z) * T * row_stride + blockIdx.y * D;
    stage_rows<D>(s_k, k + base, k0, kTile, T, row_stride);
    stage_rows<D>(s_v, v + base, k0, kTile, T, row_stride);
    stage_rows<D>(s_q, q + base, 0, CHUNKS * kTile, T, row_stride);
    stage_rows<D>(s_do, dout + base, 0, CHUNKS * kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    bool keep[2];
    stage_dkv_stats(s_stat, stats, mask, T, H, keep);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const float inv_scale = inv_sqrt_head_dim<D>();
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
        dkv_chunk<D>(acc_k, acc_v, s_k, s_v, s_q + c * kBytes, s_do + c * kBytes, c,
                     s_stat + 3 * c * kTile, keep, T, inv_scale);
    store_rows<D>(dk + base, acc_k, k0, T, row_stride);
    store_rows<D>(dv + base, acc_v, k0, T, row_stride);
}

// K14a's dK / dV kernel, chunked: any T, Q, dO and the chunk's statistics
// streamed a 64-query chunk at a time through double buffers
template <int D>
__global__ void __launch_bounds__(kThreads)
attention_backward_dkv_long_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const int* __restrict__ mask,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ stats,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int T, int H) {
    constexpr int kBytes = Tile<D>::kBytes;
    const int chunks = (T + kTile - 1) / kTile;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_k = smem;
    unsigned char* s_v = s_k + kBytes;
    unsigned char* s_q = s_v + kBytes;       // two chunks' Q
    unsigned char* s_do = s_q + 2 * kBytes;  // two chunks' dO
    const StatSide side{head_stats(stats, T, H), reinterpret_cast<float*>(s_do + 2 * kBytes), T};
    const int k0 = blockIdx.x * kTile;
    const long long row_stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(blockIdx.z) * T * row_stride + blockIdx.y * D;
    stage_rows<D>(s_k, k + base, k0, kTile, T, row_stride);
    stage_rows<D>(s_v, v + base, k0, kTile, T, row_stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    bool keep[2];
    key_rows_kept(mask, T, keep);

    const float inv_scale = inv_sqrt_head_dim<D>();
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
    stream_chunks<D>(chunks, T, row_stride, q + base, dout + base, s_q, s_do, side,
                     [&](int c, const unsigned char* qt, const unsigned char* dot) {
        dkv_chunk<D>(acc_k, acc_v, s_k, s_v, qt, dot, c, side.chunk(c), keep, T, inv_scale);
    });
    store_rows<D>(dk + base, acc_k, k0, T, row_stride);
    store_rows<D>(dv + base, acc_v, k0, T, row_stride);
}

// K5c: bf16 bias add + tanh GELU (bert.py:170-171: nn.Dense's bias, then
// jax.nn.gelu's tanh form at its bf16 constants): s = bf16(y + b), then in
// f32 u = c1 (s + c2 s^3), tanh(u) = 1 - 2 / (exp(2u) + 1), out =
// bf16(s (1 + tanh(u)) / 2). What bounds it: device memory (y read and out
// written once, 4 bytes an element; 0.0075 ms at 4096 x 1536), with ~25
// f32 instructions and two MUFU operations an element close behind
// (--fmad=false: no multiply-add is fused). The design: a 2-D grid, blocks
// of 32 eight-column groups x 8 rows, each thread 2 rows of one group (1.5
// waves of blocks at 4096 rows, so the loads of some overlap the
// arithmetic of others: 7 % under 4 rows a thread), the bias column from
// the index (its 16 bytes loaded once a thread), every load and store 16
// bytes, a warp's 512 contiguous. exp is __expf (ex2.approx, as the Triton kernel it
// replaces computed it); 2 / (e + 1) is 2 rcp_rn(e + 1), the division's
// value exactly (a power-of-two scaling of a correctly rounded reciprocal)
// without its slow path. That exact reciprocal costs 1.6 us at 4096 x 1536
// against __fdividef's approximation (0.0103 against 0.0087 ms on the H100).
constexpr int kGeluGroups = 32;  // 8-column groups a block (x)
constexpr int kGeluRows = 8;     // thread rows a block (y)
constexpr int kGeluRowsPerThread = 2;

__device__ __forceinline__ float gelu_tanh(float y, float bias, float c1, float c2) {
    const float s = round_bf16(y + bias);
    const float u = c1 * (s + c2 * (s * s * s));
    const float t = 1.0f - 2.0f * __frcp_rn(__expf(2.0f * u) + 1.0f);
    return s * (0.5f * (1.0f + t));
}

__global__ void __launch_bounds__(kGeluGroups * kGeluRows)
bias_gelu_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, long long M, int N, float c1, float c2) {
    const int col = (blockIdx.x * kGeluGroups + threadIdx.x) * 8;
    if (col >= N) return;
    const uint4 bw = *reinterpret_cast<const uint4*>(bias + col);
    const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bw);
    float2 bf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bf[j] = __bfloat1622float2(bp[j]);
    constexpr int kBlockRows = kGeluRows * kGeluRowsPerThread;
    for (long long r0 = static_cast<long long>(blockIdx.y) * kBlockRows + threadIdx.y; r0 < M;
         r0 += static_cast<long long>(gridDim.y) * kBlockRows) {
        uint4 w[kGeluRowsPerThread];
#pragma unroll
        for (int i = 0; i < kGeluRowsPerThread; ++i) {
            const long long row = r0 + i * kGeluRows;
            if (row < M) w[i] = *reinterpret_cast<const uint4*>(y + row * N + col);
        }
#pragma unroll
        for (int i = 0; i < kGeluRowsPerThread; ++i) {
            const long long row = r0 + i * kGeluRows;
            if (row >= M) break;
            __nv_bfloat162* yp = reinterpret_cast<__nv_bfloat162*>(&w[i]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 x = __bfloat1622float2(yp[j]);
                yp[j] = __floats2bfloat162_rn(gelu_tanh(x.x, bf[j].x, c1, c2),
                                              gelu_tanh(x.y, bf[j].y, c1, c2));
            }
            *reinterpret_cast<uint4*>(out + row * N + col) = w[i];
        }
    }
}

// K14b: the backward of the residual add + LayerNorm (bert.py:164-165,
// :173-174 and the embedding LN :204-205: flax's LayerNorm(dtype=f32) of
// s = bf16(x + r), cast to bf16), as jax.vjp takes it and
// add_layernorm_backward_plain (ops/encoder.py) computes it: per row, in
// f32, mean = sum(s) / N, z = sum(s^2) / N - mean^2, var = max(z, 0),
// rinv = 1 / sqrt(var + eps), xc = s - mean; dxc = g (rinv w), dz =
// [z > 0] sum(g xc w) (-0.5 rinv / (var + eps)), dmean = -sum(dxc) - 2 mean
// dz; ds = bf16(bf16(dxc) + bf16(dmean / N + (dz / N)(2 s))), the cotangent
// of both x and r; dweight = sum over rows of g xc rinv, dbias = sum of g.
// What bounds it: device memory (x, r, dy read and ds written, 8 bytes an
// element: 0.0075 ms at 8,192 x 384); ~30 f32 operations an element and
// five warp sums a row are far below the card's rates. The design: a warp a
// row, the row held in registers as bf16 (s is a bf16 value, dy one: a
// piece of W of them, one piece per lane of every 32; 8-byte loads and
// stores when N is a multiple of 4 and the pointers 8-byte aligned, else
// 2-byte ones; N up to kLnMaxN), the row's statistics from row_stats (K5b
// computes its forward from the same routine), the row's sums by shuffles,
// w read where it is used (from L1): registers bound how many rows an SM
// holds in flight. A fixed grid of kLnBlocks blocks (fewer when M is small) strides
// over the rows; each lane keeps its columns' dweight and dbias partials
// in f32 registers, the block sums its warps' in shared memory in warp
// order into partials [2][blocks][N], and a second kernel sums those over
// the blocks (kSumGroups interleaved groups, then the groups, each in a
// fixed order): no atomics, so two calls are bit-equal and the grid does not
// depend on the card. Both kernels run in one call, dweight, dbias and the
// partials in one allocation: in the host-bound train step the host's cost
// of a call, not the card's, sets what this kernel costs.
constexpr int kLnWarps = 8;      // rows in flight a block: a warp a row
constexpr int kLnBlocks = 264;   // the grid's most blocks: two for each of the H100's SMs
constexpr int kLnMaxN = 1024;

// W bf16 values of a row, as their bits
template <int W>
struct Piece;

template <>
struct Piece<4> {
    uint2 bits;
    __device__ __forceinline__ void zero() { bits = make_uint2(0u, 0u); }
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        bits = *reinterpret_cast<const uint2*>(p);
    }
    // each value bf16(this + o): the f32 sum of two bf16 values rounded to
    // bf16 is their exact sum rounded once, which add.rn.bf16x2 computes
    __device__ __forceinline__ void add(const Piece<4>& o) {
        bits = make_uint2(badd(bits.x, o.bits.x), badd(bits.y, o.bits.y));
    }
    __device__ __forceinline__ void store(__nv_bfloat16* p) const {
        *reinterpret_cast<uint2*>(p) = bits;
    }
    __device__ __forceinline__ void get(float (&v)[4]) const {
        v[0] = lo_f32(bits.x);
        v[1] = hi_f32(bits.x);
        v[2] = lo_f32(bits.y);
        v[3] = hi_f32(bits.y);
    }
    __device__ __forceinline__ void set(const float (&v)[4]) {  // rounded to nearest
        const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
        bits.x = *reinterpret_cast<const uint32_t*>(&a);
        bits.y = *reinterpret_cast<const uint32_t*>(&b);
    }
};

template <>
struct Piece<1> {
    __nv_bfloat16 bits;
    __device__ __forceinline__ void zero() { bits = __float2bfloat16_rn(0.0f); }
    __device__ __forceinline__ void load(const __nv_bfloat16* p) { bits = *p; }
    __device__ __forceinline__ void add(const Piece<1>& o) {
        bits = __float2bfloat16_rn(__bfloat162float(bits) + __bfloat162float(o.bits));
    }
    __device__ __forceinline__ void store(__nv_bfloat16* p) const { *p = bits; }
    __device__ __forceinline__ void get(float (&v)[1]) const { v[0] = __bfloat162float(bits); }
    __device__ __forceinline__ void set(const float (&v)[1]) { bits = __float2bfloat16_rn(v[0]); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// a row's LayerNorm statistics, as flax's LayerNorm(dtype=f32) takes them
struct RowStats {
    float mean, z, var, rinv;
};

// the statistics of s = bf16(x + r) over a row of N (x, r at its start),
// for K5b and K14b alike, so the backward recomputes what the forward used:
// a lane's pieces lane, lane + 32, ... (at most P of W values; pieces past N
// read nothing and add 0) kept in s, their sums in a fixed order and then
// across the warp by shuffles; mean = sum / N, z = sum(s^2) / N - mean^2,
// var = max(z, 0), rinv = 1 / sqrt(var + eps). Every lane gets the same bits.
template <int W, int P>
__device__ __forceinline__ RowStats row_stats(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ r, int N,
                                              float eps, Piece<W> (&s)[P]) {
    const int lane = threadIdx.x % 32, pieces = N / W;
    float sum = 0.0f, sq = 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i) {  // guarded, not cut short: every piece's loads go out at once
        const int p = lane + 32 * i;
        Piece<W> rp;
        s[i].zero();  // pieces past N: s = 0 adds nothing
        rp.zero();
        if (p < pieces) {
            s[i].load(x + p * W);
            rp.load(r + p * W);
        }
        s[i].add(rp);
        float a[W];
        s[i].get(a);
#pragma unroll
        for (int e = 0; e < W; ++e) {
            sum += a[e];
            sq += a[e] * a[e];
        }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float n = static_cast<float>(N);
    RowStats st;
    st.mean = sum / n;
    st.z = sq / n - st.mean * st.mean;
    st.var = fmaxf(st.z, 0.0f);
    st.rinv = 1.0f / sqrtf(st.var + eps);
    return st;
}

// K5b: the residual add + LayerNorm of the encoder (bert.py:164-165,
// :173-174 and the embedding LN :204-205: flax's LayerNorm(dtype=f32) of
// s = bf16(x + r), cast to bf16), as add_layernorm_plain (ops/encoder.py)
// computes it: y = bf16((s - mean) (rinv w) + b), w and b f32. What bounds
// it: device memory (x and r read, y written: 6 bytes an element, 0.0028 ms
// at 4,096 x 384); ~10 f32 operations an element and two warp sums a row
// are far below the card's rates, but a warp a row issues them all: at
// N = 768 (24 values a lane) a first build (~20 instructions a value, 73
// registers, 1.3 waves at 4,096 rows) took 0.0085 ms on the H100 against
// the Triton kernel's 0.0057 (4 warps a row). The design: K14b's, forward:
// a warp a row, the row's s in registers as packed bf16 pieces (8-byte
// loads and stores when N is a multiple of 4 and the pointers 8-byte
// aligned, else 2-byte ones; N up to kLnMaxN), s = x + r by add.rn.bf16x2
// (two values an instruction, rounded once on the card's adder where the
// Triton kernel it replaces, PR 2-13, wrote a cast pair that Triton may
// drop), the statistics from row_stats, w and b read where they are used
// (8-byte loads, from L1), 64 registers at most up to 24 values a lane.
// Blocks of kLnWarps rows, one for each kLnWarps rows up to kLnFwdBlocks,
// striding past it (4,096 rows: 512 blocks, all resident at once on 132
// SMs); no atomics.
constexpr int kLnFwdBlocks = 65535;

// W f32 values from w + c (W = 4: two 8-byte loads, w + c 8-byte aligned)
template <int W>
__device__ __forceinline__ void load_f32(const float* __restrict__ w, int c, float (&v)[W]) {
    if constexpr (W == 4) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(w + c));
        const float2 b = __ldg(reinterpret_cast<const float2*>(w + c + 2));
        v[0] = a.x;
        v[1] = a.y;
        v[2] = b.x;
        v[3] = b.y;
    } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[e] = __ldg(w + c + e);
    }
}

// up to 24 values a lane (N <= 768 in 8-byte pieces) in at most 64
// registers, so 4 blocks share an SM: 4,096 rows in one wave on 132 SMs
template <int W, int P>
__global__ void __launch_bounds__(kLnWarps * 32, W * P <= 24 ? 4 : 1)
add_layernorm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
                     const float* __restrict__ w, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, long long M, int N, float eps) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, pieces = N / W;
    for (long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp; row < M;
         row += static_cast<long long>(gridDim.x) * kLnWarps) {
        const long long off = row * N;
        Piece<W> s[P];
        const RowStats st = row_stats<W, P>(x + off, r + off, N, eps, s);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
                float v[W], wv[W], bv[W];
                s[i].get(v);
                load_f32<W>(w, p * W, wv);
                load_f32<W>(bias, p * W, bv);
#pragma unroll
                for (int e = 0; e < W; ++e) v[e] = (v[e] - st.mean) * (st.rinv * wv[e]) + bv[e];
                Piece<W> o;
                o.set(v);  // rounded to nearest
                o.store(y + off + p * W);
            }
        }
    }
}

// W bf16s a piece, at most P pieces a lane (N <= 32 P W)
template <int W, int P>
__global__ void __launch_bounds__(kLnWarps * 32)
add_layernorm_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ r,
                         const __nv_bfloat16* __restrict__ dy, const float* __restrict__ w,
                         __nv_bfloat16* __restrict__ ds, float* __restrict__ partials,
                         long long M, int N, float eps) {
    __shared__ float s_part[kLnWarps][kLnMaxN];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, pieces = N / W;
    const float n = static_cast<float>(N);
    float dw[P][W], db[P][W];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int e = 0; e < W; ++e) dw[i][e] = db[i][e] = 0.0f;
    for (long long row = static_cast<long long>(blockIdx.x) * kLnWarps + warp; row < M;
         row += static_cast<long long>(gridDim.x) * kLnWarps) {
        const long long off = row * N;
        Piece<W> s[P], g[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) g[i].load(dy + off + p * W);
        }
        const RowStats st = row_stats<W, P>(x + off, r + off, N, eps, s);
        const float mean = st.mean, z = st.z, var = st.var, rinv = st.rinv;
        float dsum = 0.0f, drs = 0.0f;  // sum(dxc), sum(g xc w)
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
                float sv[W], gv[W];
                s[i].get(sv);
                g[i].get(gv);
#pragma unroll
                for (int e = 0; e < W; ++e) {
                    const float xc = sv[e] - mean, wv = __ldg(w + p * W + e);
                    db[i][e] += gv[e];
                    dw[i][e] += gv[e] * xc * rinv;
                    dsum += gv[e] * (rinv * wv);
                    drs += gv[e] * xc * wv;
                }
            }
        }
        dsum = warp_sum(dsum);
        drs = warp_sum(drs);
        const float dz = z > 0.0f ? drs * (-0.5f * (rinv / (var + eps))) : 0.0f;
        const float dmean = -dsum - 2.0f * mean * dz;
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
                float sv[W], gv[W], out[W];
                s[i].get(sv);
                g[i].get(gv);
#pragma unroll
                for (int e = 0; e < W; ++e) {
                    const float dxc = gv[e] * (rinv * __ldg(w + p * W + e));
                    out[e] = round_bf16(dxc) + round_bf16(dmean / n + (dz / n) * (2.0f * sv[e]));
                }
                Piece<W> o;
                o.set(out);
                o.store(ds + off + p * W);
            }
        }
    }
    // the block's column partials: its warps' summed in warp order
    for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int p = lane + 32 * i;
            if (p < pieces) {
#pragma unroll
                for (int e = 0; e < W; ++e) s_part[warp][p * W + e] = k == 0 ? dw[i][e] : db[i][e];
            }
        }
        __syncthreads();
        for (int c = threadIdx.x; c < N; c += kLnWarps * 32) {
            float acc = 0.0f;
#pragma unroll
            for (int v = 0; v < kLnWarps; ++v) acc += s_part[v][c];
            partials[(static_cast<long long>(k) * gridDim.x + blockIdx.x) * N + c] = acc;
        }
        __syncthreads();
    }
}


// K14c: the backward of the bias add + tanh GELU (bert.py:170-171), the VJP
// of jax.nn.gelu(bf16(y + b)) as jax.value_and_grad takes it through the
// train steps (train_encoders.py:244, parallel/train.py:87,115) and
// bias_gelu_backward_plain (ops/encoder.py) writes it: s = bf16(y + b), c =
// dout, every step of the chain rule rounded to bf16 in the twin's order at
// the bf16 constants c1, c2 (s2 = s s, u = c1 (s + c2 s2 s), th = tanh(u),
// t = (s c / 2)(1 - th), w = c1 (t + t th), dy = (c (1 + th) / 2 + w) +
// (c2 w)(3 s2)); db = the column sum of the rounded dy in f32, cast to bf16.
// tanh is K5c's (1 - 2 rcp_rn(__expf(2u) + 1), gelu_tanh above), so the
// forward and the backward take the same th.
// What bounds it: device memory (y and dout read, dy written: 6 bytes an
// element, 0.0225 ms at 8,192 x 1,536), if the ~25 roundings an element
// stay cheap. Each step of the chain is one op on two bf16 values (the
// constants are bf16 too), whose f32 result rounded to bf16 is the bf16
// op's own result: products of two bf16 values are exact in f32, and a sum
// that f32 rounds differs from the exact one by far less than half a bf16
// step. So the chain runs as packed bf16x2 ops (mul.rn / add.rn / sub.rn
// .bf16x2: round to nearest even, never contracted into an fma), two
// elements an instruction at the f32 rate, on the pairs as they are loaded;
// only tanh widens to f32 and rounds back (one packed conversion a pair).
// A first build rounded each f32 step with cvt.rn.bf16.f32 (16 a clock an
// SM, a quarter of the f32 rate; ~25 an element take ~0.085 ms at 8,192 x
// 1,536): 0.083 ms on the H100; the packed ops take 0.0305.
// The design: K5c's 2-D grid, a block 256 columns (32 threads of 8) x
// kGeluBwdRows thread rows: a thread's 8 columns one 16-byte piece when
// N % 8 == 0 and every pointer is 16-byte aligned, else 8 single elements
// 32 apart (one instantiation: any N and any view, the same grid), each
// thread two rows a step with all four loads issued before the arithmetic,
// the bias read once a thread. db without atomics: the caller fixes the
// grid's row blocks (ops/kernels.py: 264 blocks in all over the column
// blocks, two an SM; fewer when M is small), each thread keeps its
// columns' partials in f32 registers, the block sums its thread rows' in
// order into partials [blocks][N], and col_sum_kernel sums those in fixed
// groups. Two calls are bit-equal, and the grid does not depend on the card.
constexpr int kGeluBwdPieces = 32;   // threads a block's row (x), 8 columns each
constexpr int kGeluBwdRows = 16;     // thread rows a block (y), two rows each a step

__device__ __forceinline__ uint32_t splat_bf16(float x) { return pack_bf16(x, x); }

// K5c's tanh of both halves, each rounded to bf16
__device__ __forceinline__ uint32_t tanh_bf16x2(uint32_t u) {
    const float a = lo_f32(u), b = hi_f32(u);
    return pack_bf16(1.0f - 2.0f * __frcp_rn(__expf(2.0f * a) + 1.0f),
                     1.0f - 2.0f * __frcp_rn(__expf(2.0f * b) + 1.0f));
}

// the chain rule at two elements, in bias_gelu_backward_plain's order: y,
// bias, the cotangent c as bf16 pairs; k1, k2 the constants c1, c2, and
// half, one, three, each in both halves → the pair of dy
__device__ __forceinline__ uint32_t gelu_grad_bf16x2(uint32_t y, uint32_t bias, uint32_t c,
                                                     uint32_t k1, uint32_t k2, uint32_t half,
                                                     uint32_t one, uint32_t three) {
    const uint32_t s = badd(y, bias);
    const uint32_t s2 = bmul(s, s);
    const uint32_t u = bmul(k1, badd(s, bmul(k2, bmul(s2, s))));
    const uint32_t th = tanh_bf16x2(u);
    const uint32_t t = bmul(bmul(half, bmul(s, c)), bsub(one, th));
    const uint32_t w = bmul(k1, badd(t, bmul(t, th)));
    return badd(badd(bmul(c, bmul(half, badd(one, th))), w), bmul(bmul(k2, w), bmul(three, s2)));
}

// a thread's 8 columns of a row as four bf16 pairs: VEC, one 16-byte piece
// (columns col .. col + 7; N % 8 == 0, so wholly inside the row or past
// it); else 8 single elements 32 apart (columns col + 32 e, each guarded:
// any N, any alignment)
template <bool VEC>
struct Eight {
    uint32_t w[4];
    __device__ __forceinline__ void load(const __nv_bfloat16* p, int col, int N) {
        if constexpr (VEC) {
            const uint4 v = *reinterpret_cast<const uint4*>(p + col);
            w[0] = v.x;
            w[1] = v.y;
            w[2] = v.z;
            w[3] = v.w;
        } else {
            const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
            uint32_t h[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) h[e] = col + 32 * e < N ? q[col + 32 * e] : 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] = h[2 * j] | (h[2 * j + 1] << 16);
        }
    }
    __device__ __forceinline__ void store(__nv_bfloat16* p, int col, int N) const {
        if constexpr (VEC) {
            *reinterpret_cast<uint4*>(p + col) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
            unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                if (col + 32 * e < N)
                    q[col + 32 * e] = static_cast<unsigned short>(w[e / 2] >> (16 * (e % 2)));
        }
    }
};

// a block: 256 columns (32 threads of 8) x kGeluBwdRows thread rows, the
// grid's x the column blocks and y the caller's row blocks, in both forms
template <bool VEC>
__global__ void __launch_bounds__(kGeluBwdPieces * kGeluBwdRows)
bias_gelu_bwd_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dy,
                     float* __restrict__ partials, long long M, int N, float c1, float c2) {
    constexpr int kCols = kGeluBwdPieces * 8;
    __shared__ float s_part[kGeluBwdRows][kCols];
    const int base = blockIdx.x * kCols;
    const int local = VEC ? threadIdx.x * 8 : threadIdx.x;  // the thread's first column
    const int stride = VEC ? 1 : 32;                        // ... and the step to its next
    const int col = base + local;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
    if (col < N) {
        const uint32_t k1 = splat_bf16(c1), k2 = splat_bf16(c2), half = splat_bf16(0.5f),
                       one = splat_bf16(1.0f), three = splat_bf16(3.0f);
        Eight<VEC> b;
        b.load(bias, col, N);
        const long long step = static_cast<long long>(gridDim.y) * kGeluBwdRows;
        // one row's dy from its loaded columns, stored, and added to the partials
        auto finish = [&](long long row, const Eight<VEC>& yp, const Eight<VEC>& gp) {
            Eight<VEC> o;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                o.w[j] = gelu_grad_bf16x2(yp.w[j], b.w[j], gp.w[j], k1, k2, half, one, three);
                acc[2 * j] += lo_f32(o.w[j]);
                acc[2 * j + 1] += hi_f32(o.w[j]);
            }
            o.store(dy + row * N, col, N);
        };
        for (long long r0 = static_cast<long long>(blockIdx.y) * kGeluBwdRows + threadIdx.y;
             r0 < M; r0 += 2 * step) {
            const long long r1 = r0 + step;
            Eight<VEC> y0, g0, y1, g1;  // all four loads issued before the arithmetic
            y0.load(y + r0 * N, col, N);
            g0.load(dout + r0 * N, col, N);
            if (r1 < M) {
                y1.load(y + r1 * N, col, N);
                g1.load(dout + r1 * N, col, N);
            }
            finish(r0, y0, g0);
            if (r1 < M) finish(r1, y1, g1);
        }
    }
    // the block's column partials: its thread rows' summed in order (columns
    // past N hold zeros and are not stored)
#pragma unroll
    for (int e = 0; e < 8; ++e) s_part[threadIdx.y][local + stride * e] = acc[e];
    __syncthreads();
    for (int i = threadIdx.y * kGeluBwdPieces + threadIdx.x; i < kCols;
         i += kGeluBwdPieces * kGeluBwdRows) {
        if (base + i < N) {
            float total = 0.0f;
#pragma unroll
            for (int v = 0; v < kGeluBwdRows; ++v) total += s_part[v][i];
            partials[static_cast<long long>(blockIdx.y) * N + base + i] = total;
        }
    }
}

template <bool VEC>
cudaError_t launch_bias_gelu_backward(const __nv_bfloat16* y, const __nv_bfloat16* bias,
                                      const __nv_bfloat16* dout, __nv_bfloat16* dy,
                                      float* partials, long long M, int N, int blocks, float c1,
                                      float c2, cudaStream_t stream) {
    const int col_blocks = (N + kGeluBwdPieces * 8 - 1) / (kGeluBwdPieces * 8);
    bias_gelu_bwd_kernel<VEC><<<dim3(col_blocks, blocks), dim3(kGeluBwdPieces, kGeluBwdRows), 0,
                                stream>>>(y, bias, dout, dy, partials, M, N, c1, c2);
    return cudaGetLastError();
}

// K5d: the masked mean pool of the encoder's last hidden states
// (bert.py:222-226, BertForEmbedding, L2-normalised; :243-245, the cross
// encoder's score_pool="mean", not), as mean_pool_plain (ops/encoder.py)
// computes it: raw = bf16(bf16(sum of the kept tokens' rows in f32) /
// bf16(max(count, 1))), pooled = raw / max(||raw||, 1e-9) when normalised;
// and its VJP as mean_pool_backward_plain writes it: with n = max(||raw||,
// 1e-9), g' = g / n + raw (dn / 2 / ||raw|| * 2) where ||raw|| > 1e-9 (dn =
// -(g . raw) / n^2), else g / n (g' = g when not normalised); dsum =
// bf16(bf16(g') / count) written to every kept token's row, 0 elsewhere.
// What bounds them: device memory (the forward reads the kept tokens' rows
// of h, the backward writes dh: 2 bytes an element each, 0.0039 ms for the
// pair at 64 x 128 x 384 with the mask and the [B, H] rows); the
// arithmetic is an add an element. The forward: one block a batch row, so
// at the dual step's 64 rows half the SMs idle, and each of them has to
// keep a whole row's loads in flight: kPoolFwdWarps warps, warp w taking
// the tokens w, w + kPoolFwdWarps, ... (prefix masks leave no warp idle),
// each loading kPoolUnroll tokens' rows at once (16-byte pieces of 8
// columns, lane, lane + 32, ...; a masked token's row is not read: 96 KB
// of one 128-token row of 384 in flight) and adding them to its f32 column
// sums in token order; the warps' sums meet in dynamic shared memory and
// are added in warp order, the f32 total rounded to bf16 and divided as
// the twin does; sum(raw^2) by block_sum. The backward: a block a (batch
// row, kPoolSpan tokens), 256 at 64 x 128; each loads its row of g and raw
// first, then recomputes the row's count and, normalised, ||raw|| and g .
// raw by block_sum (H floats and T ints: cheap), forms dsum once in shared
// memory and writes its tokens' rows by 16-byte stores. No atomics and
// every sum in a fixed order: two calls are bit-equal. H a multiple of 8
// up to kPoolMaxH, any T up to the backward grid's 65,535 spans (2,097,120
// tokens): nothing staged grows with T; h and dh 16-byte aligned.
// A first forward of 8 warps a block, 8 tokens a warp in flight, took
// 0.0077 ms at 64 x 128 x 384 on the H100 (its backward 0.0041).
constexpr int kPoolFwdWarps = 16;
constexpr int kPoolWarps = 8;  // the backward's
constexpr int kPoolMaxH = 1024;
constexpr int kPoolSpan = 32;  // the backward's tokens a block
constexpr int kPoolMaxSpans = 65535;  // the backward grid's y

// max(bf16(count of the kept tokens), 1) of one row of T mask entries, as
// the reference rounds its bf16 mask sum; every thread of the block calls it
__device__ __forceinline__ float pool_count(const int* __restrict__ mask, int T) {
    int count = 0;
    for (int t0 = 0; t0 < T; t0 += blockDim.x) {
        const int t = t0 + threadIdx.x;
        count += __syncthreads_count(t < T && mask[t] != 0);
    }
    return fmaxf(round_bf16(static_cast<float>(count)), 1.0f);
}

// the sum of v over the block's WARPS warps: each warp's by shuffles, then
// the warps' in warp order; every thread gets the same bits (s_red: WARPS
// floats)
template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* s_red) {
    v = warp_sum(v);
    __syncthreads();  // s_red read by an earlier call
    if (threadIdx.x % 32 == 0) s_red[threadIdx.x / 32] = v;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) total += s_red[i];
    return total;
}

// acc += the 8 bf16 values of a 16-byte piece (a bf16 is the high half of
// its f32: exact)
__device__ __forceinline__ void add_bf16x8(const uint4& v, float (&acc)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        acc[2 * j] += __uint_as_float(w[j] << 16);
        acc[2 * j + 1] += __uint_as_float(w[j] & 0xffff0000u);
    }
}

// P 16-byte pieces a lane at most (H <= 256 P); all its shared memory is
// dynamic, kPoolFwdWarps (H + 1) floats (the launch opts in past 48 KB)
template <int P>
__global__ void __launch_bounds__(kPoolFwdWarps * 32)
mean_pool_kernel(const __nv_bfloat16* __restrict__ h, const int* __restrict__ mask,
                 float* __restrict__ out, float* __restrict__ raw, int T, int H, int normalize) {
    constexpr int kPoolUnroll = P <= 2 ? 8 : 4;  // tokens a warp loads at once
    extern __shared__ __align__(16) float s_part[];  // [kPoolFwdWarps][H], then s_red
    float* s_red = s_part + kPoolFwdWarps * H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, pieces = H / 8;
    const int* m = mask + static_cast<long long>(blockIdx.x) * T;
    const __nv_bfloat16* hb = h + static_cast<long long>(blockIdx.x) * T * H;
    const float count = pool_count(m, T);
    float acc[P][8];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
    for (int t0 = warp; t0 < T; t0 += kPoolFwdWarps * kPoolUnroll) {
        uint4 v[kPoolUnroll][P];
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u) {
            const int t = t0 + u * kPoolFwdWarps;
            const bool keep = t < T && m[t] != 0;  // the same in every lane
#pragma unroll
            for (int i = 0; i < P; ++i) {
                const int p = lane + 32 * i;
                v[u][i] = keep && p < pieces
                    ? *reinterpret_cast<const uint4*>(hb + static_cast<long long>(t) * H + p * 8)
                    : make_uint4(0u, 0u, 0u, 0u);
            }
        }
#pragma unroll
        for (int u = 0; u < kPoolUnroll; ++u)  // in token order; a zero piece adds nothing
#pragma unroll
            for (int i = 0; i < P; ++i) add_bf16x8(v[u][i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
        const int p = lane + 32 * i;
        if (p < pieces) {
            float4* dst = reinterpret_cast<float4*>(s_part + warp * H + p * 8);
            dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
    }
    __syncthreads();
    float sq = 0.0f;
    for (int c = threadIdx.x; c < H; c += kPoolFwdWarps * 32) {  // a column's warps in order
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < kPoolFwdWarps; ++w) total += s_part[w * H + c];
        const float rv = round_bf16(round_bf16(total) / count);
        s_part[c] = rv;  // the thread's own column of warp 0's sums
        sq += rv * rv;
    }
    const long long row = static_cast<long long>(blockIdx.x) * H;
    if (!normalize) {
        for (int c = threadIdx.x; c < H; c += kPoolFwdWarps * 32) out[row + c] = s_part[c];
        return;
    }
    const float n = fmaxf(sqrtf(block_sum<kPoolFwdWarps>(sq, s_red)), 1e-9f);
    for (int c = threadIdx.x; c < H; c += kPoolFwdWarps * 32) {
        const float rv = s_part[c];
        raw[row + c] = rv;
        out[row + c] = rv / n;
    }
}

__global__ void __launch_bounds__(kPoolWarps * 32)
mean_pool_bwd_kernel(const int* __restrict__ mask, const float* __restrict__ raw,
                     const float* __restrict__ g, __nv_bfloat16* __restrict__ dh, int T, int H,
                     int normalize) {
    constexpr int kCols = kPoolMaxH / (kPoolWarps * 32);  // columns a thread at most
    __shared__ __align__(16) __nv_bfloat16 s_d[kPoolMaxH];
    __shared__ float s_red[kPoolWarps];
    const int* m = mask + static_cast<long long>(blockIdx.x) * T;
    const long long row = static_cast<long long>(blockIdx.x) * H;
    float gv[kCols], rv[kCols];  // loaded before the count: their latencies overlap
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        const int c = threadIdx.x + k * kPoolWarps * 32;
        gv[k] = c < H ? g[row + c] : 0.0f;
        rv[k] = normalize && c < H ? raw[row + c] : 0.0f;
    }
    const float count = pool_count(m, T);
    if (normalize) {
        float sq = 0.0f, gr = 0.0f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {  // columns past H hold 0
            sq += rv[k] * rv[k];
            gr += gv[k] * rv[k];
        }
        const float nrm = sqrtf(block_sum<kPoolWarps>(sq, s_red));
        gr = block_sum<kPoolWarps>(gr, s_red);
        const float n = fmaxf(nrm, 1e-9f);
        const float dn = -gr / (n * n);
        const float coef = nrm > 1e-9f ? dn * 0.5f / nrm * 2.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) gv[k] = gv[k] / n + rv[k] * coef;
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        const int c = threadIdx.x + k * kPoolWarps * 32;
        if (c < H) s_d[c] = __float2bfloat16_rn(round_bf16(gv[k]) / count);
    }
    __syncthreads();
    const int pieces = H / 8, first = blockIdx.y * kPoolSpan;
    const int tokens = min(kPoolSpan, T - first);
    for (int i = threadIdx.x; i < tokens * pieces; i += kPoolWarps * 32) {
        const int t = first + i / pieces, p = i % pieces;
        const uint4 v = m[t] != 0 ? *reinterpret_cast<const uint4*>(&s_d[p * 8])
                                  : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dh + (static_cast<long long>(blockIdx.x) * T + t) * H + p * 8) =
            v;
    }
}

// f(W, P) as std::integral_constants: the piece width and the most pieces a
// lane that a LayerNorm row of N takes (K5b, K14b): pieces of 4 (8 bytes)
// when N % 4 == 0 and `bits` (the pointers or'ed) is 8-byte aligned, else
// single elements → f's CUDA status
template <typename F>
cudaError_t with_ln_pieces(int N, uintptr_t bits, F f) {
    using std::integral_constant;
    if (N % 4 || bits % 8) return f(integral_constant<int, 1>{}, integral_constant<int, 32>{});
    const int per = (N / 4 + 31) / 32;
    constexpr integral_constant<int, 4> four{};
    if (per <= 1) return f(four, integral_constant<int, 1>{});
    if (per <= 2) return f(four, integral_constant<int, 2>{});
    if (per <= 3) return f(four, integral_constant<int, 3>{});
    if (per <= 4) return f(four, integral_constant<int, 4>{});
    if (per <= 6) return f(four, integral_constant<int, 6>{});
    return f(four, integral_constant<int, 8>{});
}

// a launch with `smem` bytes of dynamic shared memory, opting the kernel
// in when that is above the default 48 KB (per card: set at every such
// launch) → the CUDA status of the launch
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, A... args) {
    if (smem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, block, smem, stream>>>(args...);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_forward(const __nv_bfloat16* q, const __nv_bfloat16* k,
                           const __nv_bfloat16* v, const int* mask, __nv_bfloat16* out, int B,
                           int T, int H, cudaStream_t stream) {
    const int chunks = (T + kTile - 1) / kTile;
    const dim3 grid(chunks, H, B);
    const size_t smem = attention_smem_bytes<D>(chunks);
    if (chunks == 1)
        return launch(attention_kernel<D, 1>, grid, kThreads, smem, stream, q, k, v, mask, out,
                      T, H);
    if (chunks == 2)
        return launch(attention_kernel<D, 2>, grid, kThreads, smem, stream, q, k, v, mask, out,
                      T, H);
    if constexpr (kHeldChunks<D> == 4) {
        if (chunks == 3)
            return launch(attention_kernel<D, 3>, grid, kThreads, smem, stream, q, k, v, mask, out,
                          T, H);
        if (chunks == 4)
            return launch(attention_kernel<D, 4>, grid, kThreads, smem, stream, q, k, v, mask, out,
                          T, H);
    }
    return launch(attention_long_kernel<D>, grid, kThreads, attention_long_smem_bytes<D>(),
                  stream, q, k, v, mask, out, T, H);
}

// the dQ kernel, then the dK / dV kernel: one pass over CHUNKS chunks
// staged whole, or chunked (CHUNKS = 0)
template <int D, int CHUNKS>
cudaError_t launch_backward_as(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const int* mask, const __nv_bfloat16* dout,
                               __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                               float* stats, int B, int T, int H, cudaStream_t stream) {
    const int chunks = (T + kTile - 1) / kTile;
    const dim3 grid(chunks, H, B);
    const float* st = stats;
    cudaError_t err;
    if constexpr (CHUNKS > 0) {
        err = launch(attention_backward_dq_kernel<D, CHUNKS>, grid, kThreads,
                     backward_dq_smem_bytes<D>(chunks), stream, q, k, v, mask, dout, dq, stats, T,
                     H);
        if (err != cudaSuccess) return err;
        return launch(attention_backward_dkv_kernel<D, CHUNKS>, grid, kThreads,
                      backward_dkv_smem_bytes<D>(chunks), stream, q, k, v, mask, dout, st, dk, dv,
                      T, H);
    } else {
        err = launch(attention_backward_dq_long_kernel<D>, grid, kThreads,
                     backward_dq_long_smem_bytes<D>(), stream, q, k, v, mask, dout, dq,
                     stats, T, H);
        if (err != cudaSuccess) return err;
        return launch(attention_backward_dkv_long_kernel<D>, grid, kThreads,
                      backward_dkv_long_smem_bytes<D>(), stream, q, k, v, mask, dout, st,
                      dk, dv, T, H);
    }
}

template <int D>
cudaError_t launch_backward(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, const int* mask, const __nv_bfloat16* dout,
                            __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                            float* stats, int B, int T, int H, cudaStream_t stream) {
    const int chunks = (T + kTile - 1) / kTile;
    if (chunks == 1)
        return launch_backward_as<D, 1>(q, k, v, mask, dout, dq, dk, dv, stats, B, T, H, stream);
    if (chunks == 2)
        return launch_backward_as<D, 2>(q, k, v, mask, dout, dq, dk, dv, stats, B, T, H, stream);
    if constexpr (kHeldChunks<D> == 4) {
        if (chunks == 3)
            return launch_backward_as<D, 3>(q, k, v, mask, dout, dq, dk, dv, stats, B, T, H,
                                            stream);
        if (chunks == 4)
            return launch_backward_as<D, 4>(q, k, v, mask, dout, dq, dk, dv, stats, B, T, H,
                                            stream);
    }
    return launch_backward_as<D, 0>(q, k, v, mask, dout, dq, dk, dv, stats, B, T, H, stream);
}

}  // namespace

extern "C" {

// q, k, v bf16[B, T, H, D] (16-byte aligned) and mask i32[B, T] -> out
// bf16[B, T, H * D]. D must be 16, 32 or 64, T at least 1, B and H at most
// 65,535 (the grid's y and z). Returns the CUDA status of the launch.
int stract_attention(const void* q, const void* k, const void* v, const int* mask, void* out,
                     int B, int T, int H, int D, cudaStream_t stream) {
    if (B <= 0 || H <= 0) return cudaSuccess;
    if (T <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    const auto* kk = static_cast<const __nv_bfloat16*>(k);
    const auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* o = static_cast<__nv_bfloat16*>(out);
    switch (D) {
        case 16: return launch_forward<16>(qq, kk, vv, mask, o, B, T, H, stream);
        case 32: return launch_forward<32>(qq, kk, vv, mask, o, B, T, H, stream);
        case 64: return launch_forward<64>(qq, kk, vv, mask, o, B, T, H, stream);
        default: return cudaErrorInvalidValue;
    }
}

// q, k, v, dout bf16[B, T, H, D] (16-byte aligned; dout the gradient of
// the [B, T, H * D] context), mask i32[B, T] -> dq, dk, dv bf16[B, T, H, D];
// stats f32[B, H, T, 3] is scratch (each query row's max, sum and D). D,
// T, B and H as stract_attention's. Two launches on the stream; returns the
// CUDA status.
int stract_attention_backward(const void* q, const void* k, const void* v, const int* mask,
                              const void* dout, void* dq, void* dk, void* dv, float* stats,
                              int B, int T, int H, int D, cudaStream_t stream) {
    if (B <= 0 || H <= 0) return cudaSuccess;
    if (T <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    const auto* kk = static_cast<const __nv_bfloat16*>(k);
    const auto* vv = static_cast<const __nv_bfloat16*>(v);
    const auto* go = static_cast<const __nv_bfloat16*>(dout);
    auto* gq = static_cast<__nv_bfloat16*>(dq);
    auto* gk = static_cast<__nv_bfloat16*>(dk);
    auto* gv = static_cast<__nv_bfloat16*>(dv);
    switch (D) {
        case 16:
            return launch_backward<16>(qq, kk, vv, mask, go, gq, gk, gv, stats, B, T, H, stream);
        case 32:
            return launch_backward<32>(qq, kk, vv, mask, go, gq, gk, gv, stats, B, T, H, stream);
        case 64:
            return launch_backward<64>(qq, kk, vv, mask, go, gq, gk, gv, stats, B, T, H, stream);
        default: return cudaErrorInvalidValue;
    }
}

// y bf16[M, N], bias bf16[N] -> out bf16[M, N] (all 16-byte aligned, N a
// multiple of 8): out = gelu_tanh(bf16(y + bias)) at the constants c1, c2.
// Returns the CUDA status of the launch.
int stract_bias_gelu(const void* y, const void* bias, void* out, long long M, int N, float c1,
                     float c2, cudaStream_t stream) {
    if (M <= 0) return cudaSuccess;
    if (N <= 0 || N % 8) return cudaErrorInvalidValue;
    constexpr long long kBlockRows = kGeluRows * kGeluRowsPerThread;
    const long long row_blocks = (M + kBlockRows - 1) / kBlockRows;
    const dim3 grid((N / 8 + kGeluGroups - 1) / kGeluGroups,
                    static_cast<unsigned>(row_blocks < 65535 ? row_blocks : 65535));
    bias_gelu_kernel<<<grid, dim3(kGeluGroups, kGeluRows), 0, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N, c1, c2);
    return cudaGetLastError();
}

// x, r bf16[M, N], w, bias f32[N] -> y bf16[M, N] (K5b): LN(bf16(x + r))
// in f32, rounded to bf16. N must be 1..1024; M = 0 launches nothing.
// Returns the CUDA status of the launch.
int stract_add_layernorm(const void* x, const void* r, const float* w, const float* bias,
                         void* y, long long M, int N, float eps, cudaStream_t stream) {
    if (M < 0 || N <= 0 || N > kLnMaxN) return cudaErrorInvalidValue;
    if (M == 0) return cudaSuccess;
    const auto* xx = static_cast<const __nv_bfloat16*>(x);
    const auto* rr = static_cast<const __nv_bfloat16*>(r);
    auto* out = static_cast<__nv_bfloat16*>(y);
    const long long rows = (M + kLnWarps - 1) / kLnWarps;
    const int blocks = static_cast<int>(rows < kLnFwdBlocks ? rows : kLnFwdBlocks);
    const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                           reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(bias);
    return with_ln_pieces(N, bits, [&](auto w_, auto p_) {
        add_layernorm_kernel<decltype(w_)::value, decltype(p_)::value>
            <<<blocks, kLnWarps * 32, 0, stream>>>(xx, rr, w, bias, out, M, N, eps);
        return cudaGetLastError();
    });
}

// x, r, dy bf16[M, N], w f32[N] -> ds bf16[M, N], dweight and dbias f32[N]
// (K14b); partials f32[2, blocks, N] is scratch. N must be 1..1024, blocks
// 1..264 when M > 0 (0 when M = 0: dweight and dbias are zeros). Two
// launches on the stream; returns the CUDA status.
int stract_add_layernorm_backward(const void* x, const void* r, const void* dy, const float* w,
                                  void* ds, float* dweight, float* dbias, float* partials,
                                  long long M, int N, int blocks, float eps,
                                  cudaStream_t stream) {
    if (M < 0 || N <= 0 || N > kLnMaxN || blocks < 0 || blocks > kLnBlocks ||
        (M > 0) != (blocks > 0))
        return cudaErrorInvalidValue;
    if (M > 0) {
        const auto* xx = static_cast<const __nv_bfloat16*>(x);
        const auto* rr = static_cast<const __nv_bfloat16*>(r);
        const auto* gg = static_cast<const __nv_bfloat16*>(dy);
        auto* out = static_cast<__nv_bfloat16*>(ds);
        const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                               reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(ds);
        const cudaError_t err = with_ln_pieces(N, bits, [&](auto w_, auto p_) {
            add_layernorm_bwd_kernel<decltype(w_)::value, decltype(p_)::value>
                <<<blocks, kLnWarps * 32, 0, stream>>>(xx, rr, gg, w, out, partials, M, N, eps);
            return cudaGetLastError();
        });
        if (err != cudaSuccess) return err;
    }
    return launch_col_sum(static_cast<const float*>(partials), 2, blocks, N, dweight, dbias,
                          stream);
}

// y, dout bf16[M, N], bias bf16[N] -> dy bf16[M, N] and db bf16[N] (K14c);
// partials f32[blocks, N] is scratch. M must be at least 1 (the caller
// gives db its zeros when M = 0), N at least 1, blocks 1..65535 (the grid's
// row blocks). Two launches on the stream; returns the CUDA status.
int stract_bias_gelu_backward(const void* y, const void* bias, const void* dout, void* dy,
                              void* db, float* partials, long long M, int N, int blocks,
                              float c1, float c2, cudaStream_t stream) {
    if (M <= 0 || N <= 0 || blocks <= 0 || blocks > 65535) return cudaErrorInvalidValue;
    const auto* yy = static_cast<const __nv_bfloat16*>(y);
    const auto* bb = static_cast<const __nv_bfloat16*>(bias);
    const auto* gg = static_cast<const __nv_bfloat16*>(dout);
    auto* out = static_cast<__nv_bfloat16*>(dy);
    const uintptr_t bits = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(bias) |
                           reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dy);
    const cudaError_t err =
        N % 8 == 0 && bits % 16 == 0
            ? launch_bias_gelu_backward<true>(yy, bb, gg, out, partials, M, N, blocks, c1, c2,
                                              stream)
            : launch_bias_gelu_backward<false>(yy, bb, gg, out, partials, M, N, blocks, c1, c2,
                                               stream);
    if (err != cudaSuccess) return err;
    auto* sum = static_cast<__nv_bfloat16*>(db);
    return launch_col_sum(static_cast<const float*>(partials), 1, blocks, N, sum, sum, stream);
}

// h bf16[B, T, H] (16-byte aligned), mask i32[B, T] -> out f32[B, H], the
// masked mean (K5d), L2-normalised when `normalize`, and then raw f32[B, H]
// the mean before it (raw is not written otherwise). T must be 1..2,097,120
// (the backward grid's), H a multiple of 8 up to 1024; B = 0 launches
// nothing. Returns the CUDA status of the launch.
int stract_mean_pool(const void* h, const int* mask, float* out, float* raw, int B, int T, int H,
                     int normalize, cudaStream_t stream) {
    if (B < 0 || T <= 0 || (T + kPoolSpan - 1) / kPoolSpan > kPoolMaxSpans || H <= 0 ||
        H > kPoolMaxH || H % 8)
        return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const auto* hh = static_cast<const __nv_bfloat16*>(h);
    const int per = (H / 8 + 31) / 32;
    const size_t smem = sizeof(float) * kPoolFwdWarps * (H + 1);
    auto* kernel = per <= 1 ? mean_pool_kernel<1>
                 : per <= 2 ? mean_pool_kernel<2>
                 : per <= 3 ? mean_pool_kernel<3>
                            : mean_pool_kernel<4>;
    return launch(kernel, dim3(B), dim3(kPoolFwdWarps * 32), smem, stream, hh, mask, out, raw, T,
                  H, normalize);
}

// mask i32[B, T], raw and g f32[B, H] (the mean before normalisation and the
// cotangent of the pool's output) -> dh bf16[B, T, H] (16-byte aligned), the
// VJP of K5d. T, H and B as stract_mean_pool's. Returns the CUDA status of
// the launch.
int stract_mean_pool_backward(const int* mask, const float* raw, const float* g, void* dh, int B,
                              int T, int H, int normalize, cudaStream_t stream) {
    if (B < 0 || T <= 0 || (T + kPoolSpan - 1) / kPoolSpan > kPoolMaxSpans || H <= 0 ||
        H > kPoolMaxH || H % 8)
        return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    mean_pool_bwd_kernel<<<dim3(B, (T + kPoolSpan - 1) / kPoolSpan), kPoolWarps * 32, 0, stream>>>(
        mask, raw, g, static_cast<__nv_bfloat16*>(dh), T, H, normalize);
    return cudaGetLastError();
}

}  // extern "C"
