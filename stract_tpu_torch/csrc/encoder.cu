// K5a: masked self-attention of the BERT encoder on Hopper (sm_90a), and
// K14a: its backward (attention_backward_kernel, below the forward).
//
// Replaces the body of stract_tpu/models/bert.py:97-103 (BertSelfAttention):
// scores = q.k^T in f32 / sqrt(d), masked keys set to finfo(f32).min, softmax
// in f32, probabilities cast to bf16, P.V accumulated in f32, context cast to
// bf16 and laid out [B, T, heads * d]. The q/k/v projections and the output
// projection stay outside (bf16 matrix products, as the JAX package leaves
// them to XLA's dot).
//
// What bounds it: at the encoder's shapes (head dim 32, T <= 256) a query
// row needs 2 * T * 32 multiply-adds for its scores and as many for P.V,
// about T / 2 flops per byte of q, k, v and context moved, far below the
// ~295 at which the bf16 tensor cores would bind: device memory bounds it
// (3.8 us at B = 32, T = 128). Beside the tensor-core products the kernel
// spends its time in the f32 softmax (an exp and two IEEE divisions a
// score, as the reference computes them) and in the latency of one
// load-compute-store pass per block.
// The design: one warpgroup (4 warps) per (64-query tile, head, batch row).
// The tile's Q rows and the whole K and V of the (batch row, head) go into
// shared memory by 16-byte cp.async copies (rows past T zero-filled) in the
// canonical no-swizzle layout of wgmma operands: 8-row by 16-byte core
// matrices, an 8-row group's four core matrices (32 columns) in 512
// contiguous bytes. S = Q.K^T runs as wgmma m64n64k16 (bf16 in, f32
// accumulated), two k-steps of 16 over d = 32, for each 64-key chunk; all
// chunks' scores stay in registers (32 floats a thread a chunk), so the
// softmax is an exact two-pass row softmax in registers (the four lanes of
// a quad hold a row: max and sum by two shuffles). The probabilities,
// rounded to bf16, are the A operand of O = P.V straight from registers
// (wgmma m64n32k16: the f32 accumulator fragment of a 16-key slice is the
// A fragment of that k-step, packed in pairs), with V read from shared
// memory as an N-major (transposed) B operand: V is staged in the same
// layout as K, and an 8-key by 8-dimension core matrix of V is an 8 x 16
// byte block of it. Keys past T are padding of the 64-key chunk: zero in
// shared memory and left out of the row max and sum. Masked keys inside T
// take finfo(f32).min and stay in, so a fully masked row is finite with
// uniform weights, as in the reference. Query rows past T are not stored.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kMaxT = 256;
constexpr int kTile = 64;             // query rows of a block, keys of a chunk
constexpr int kThreads = 128;         // one warpgroup
constexpr int kGroupBytes = 512;      // an 8-row group: 4 core matrices of 8 x 16 bytes
constexpr int kCoreBytes = 128;

// the byte offset of 16-byte chunk c (0..3) of row r in a staged tile
__device__ __forceinline__ uint32_t staged(int r, int c) {
    return (r >> 3) * kGroupBytes + c * kCoreBytes + (r & 7) * 16;
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

// d[64 x 32] += A[64 x 16] . B[16 x 32], A in registers (bf16 pairs), B
// N-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_context(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
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

size_t attention_smem_bytes(int chunks) {
    return static_cast<size_t>(kTile) * kHeadDim * 2 +          // Q tile
           2 * static_cast<size_t>(chunks) * kTile * kHeadDim * 2 +  // K and V
           static_cast<size_t>(chunks) * kTile * sizeof(float);  // the mask
}

// CHUNKS: 64-key chunks, ceil(T / 64), 1..4
template <int CHUNKS>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int T, int H) {
    constexpr int kKeys = CHUNKS * kTile;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* s_q = smem;
    unsigned char* s_k = s_q + kTile * kHeadDim * 2;
    unsigned char* s_v = s_k + kKeys * kHeadDim * 2;
    float* s_keep = reinterpret_cast<float*>(s_v + kKeys * kHeadDim * 2);

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const long long row_stride = static_cast<long long>(H) * kHeadDim;
    const __nv_bfloat16* qb = q + static_cast<long long>(b) * T * row_stride + h * kHeadDim;
    const __nv_bfloat16* kb = k + static_cast<long long>(b) * T * row_stride + h * kHeadDim;
    const __nv_bfloat16* vb = v + static_cast<long long>(b) * T * row_stride + h * kHeadDim;

    // 16-byte copies: chunk c of row r; rows past T read nothing and fill zeros
    for (int i = tid; i < kTile * 4; i += kThreads) {
        const int r = i / 4, c = i % 4, t = q0 + r;
        cp_async16(s_q + staged(r, c), qb + (t < T ? t * row_stride : 0) + c * 8, t < T ? 16 : 0);
    }
    for (int i = tid; i < kKeys * 4; i += kThreads) {
        const int r = i / 4, c = i % 4;
        const long long off = (r < T ? r * row_stride : 0) + c * 8;
        const int bytes = r < T ? 16 : 0;
        cp_async16(s_k + staged(r, c), kb + off, bytes);
        cp_async16(s_v + staged(r, c), vb + off, bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int j = tid; j < kKeys; j += kThreads)
        s_keep[j] = j >= T ? -1.0f : (mask[b * T + j] != 0 ? 1.0f : 0.0f);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    // the copies and stores above are generic-proxy writes; wgmma reads
    // shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q.K^T: K-major A and B, core matrices 128 bytes apart along K and
    // 512 along M / N; a k-step of 16 columns is two core matrices (256 bytes)
    float s[CHUNKS][32];
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
        for (int ks = 0; ks < 2; ++ks)
            wgmma_scores(s[c], smem_desc(s_q + ks * 256, kCoreBytes, kGroupBytes),
                         smem_desc(s_k + c * kTile * kHeadDim * 2 + ks * 256, kCoreBytes,
                                   kGroupBytes));
    wgmma_commit_and_wait();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) fence_regs(s[c]);

    // the accumulator fragment: s[c][4j + e] is row 16 warp + lane / 4 (+ 8
    // for e >= 2), key 64 c + 8 j + 2 (lane % 4) + (e & 1)
    // the reference divides the f32 scores by np.sqrt(head_dim) rounded to f32
    const float scale_div = sqrtf(static_cast<float>(kHeadDim));
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int key = c * kTile + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            const float keep = s_keep[key];
            const float x = keep > 0.0f ? div_nonzero(s[c][i], scale_div) : -FLT_MAX;
            s[c][i] = x;
            if (keep >= 0.0f) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
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
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }

    // O = bf16(P).V: k-step kk covers keys 16 kk .. 16 kk + 15, the
    // accumulator registers 8 (kk % 4) .. + 7 of chunk kk / 4; V's core
    // matrices (8 keys x 8 dimensions) lie 512 bytes apart along K and 128
    // along N
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.0f;
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
    for (int kk = 0; kk < CHUNKS * 4; ++kk)
        wgmma_context(o, a[kk], smem_desc(s_v + kk * 2 * kGroupBytes, kGroupBytes, kCoreBytes));
    wgmma_commit_and_wait();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < CHUNKS * 4; ++kk) fence_regs(a[kk]);

    // o[4j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), dimension
    // 8 j + 2 (lane % 4) + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int t = q0 + 16 * warp + lane / 4 + 8 * r;
        if (t >= T) continue;
        __nv_bfloat16* orow = out + (static_cast<long long>(b) * T + t) * row_stride + h * kHeadDim;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
                __floats2bfloat162_rn(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
}

// K14a: the gradient of the kernel above, as jax.vjp differentiates the
// reference body (the training steps of stract_tpu/entrypoint/
// train_encoders.py:244 and parallel/train.py:87,115 through bert.py:97-103).
// With g = f32(dO): dV = bf16(Pb^T g) with Pb = bf16(P), the probabilities
// the forward multiplies V by; dP = bf16(g V^T) (the cotangent of the bf16
// probabilities); dS = P dP - P rowsum(P dP) with the f32 P (softmax's
// gradient); masked keys get dS = 0 (the gradient of the where); then
// dQ = bf16(dS K / sqrt(d)) and dK = bf16(dS^T Q / sqrt(d)).
//
// What bounds it: like the forward, CUDA-core arithmetic over shared memory
// (each (batch row, head) reads q, k, v and dO once, about 64 B per token,
// and does about 7 T^2 d multiply-adds). The design: one block of eight
// warps per (head, batch row) stages Q, K, V and dO whole in shared memory
// (rows padded to 17 words, so a warp's 32 rows hit 32 banks; 89 KB at
// T = 256, dynamic shared memory). Phase 1 walks the query rows, one warp
// per row: scores and softmax as the forward computes them (lanes own
// keys), dP and the row sum D, then dS / sqrt(d) into a per-warp row and dQ
// with lanes owning the 32 output dimensions; it keeps each row's max, sum
// and D. Phase 2 walks the key rows, one warp per row: lanes own query rows
// and recompute P (the same expressions, so the same bits) and dP, then
// lanes own dimensions for dK and dV. No atomics: each output row has one
// writer, so the result does not depend on scheduling.
constexpr int kBwdWarps = 8;
constexpr int kRowWords = kHeadDim / 2 + 1;  // bf16 pairs per staged row, padded

__device__ __forceinline__ float dot_row(const __nv_bfloat162* a, const __nv_bfloat162* b) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kHeadDim / 2; ++c) {
        const float2 x = __bfloat1622float2(a[c]), y = __bfloat1622float2(b[c]);
        acc += x.x * y.x;
        acc += x.y * y.y;
    }
    return acc;
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float row_elem(const __nv_bfloat162* rows, int j, int d) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rows + j * kRowWords)[d]);
}

size_t backward_smem_bytes(int T) {
    return static_cast<size_t>(4 * T * kRowWords) * sizeof(__nv_bfloat162) +
           static_cast<size_t>(3 * T + 2 * kBwdWarps * T) * sizeof(float) + T;
}

__global__ void __launch_bounds__(kBwdWarps * 32)
attention_backward_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int T, int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat162* s_q = reinterpret_cast<__nv_bfloat162*>(smem);
    __nv_bfloat162* s_k = s_q + T * kRowWords;
    __nv_bfloat162* s_v = s_k + T * kRowWords;
    __nv_bfloat162* s_do = s_v + T * kRowWords;
    float* s_max = reinterpret_cast<float*>(s_do + T * kRowWords);
    float* s_sum = s_max + T;
    float* s_dsum = s_sum + T;
    float* s_a = s_dsum + T;               // [kBwdWarps][T]: a warp's dS / sqrt(d) row
    float* s_b = s_a + kBwdWarps * T;      // [kBwdWarps][T]: a warp's dP or bf16(P) row
    unsigned char* s_keep = reinterpret_cast<unsigned char*>(s_b + kBwdWarps * T);

    const int h = blockIdx.x, b = blockIdx.y;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long row_stride = static_cast<long long>(H) * kHeadDim;
    const long long base = static_cast<long long>(b) * T * row_stride + h * kHeadDim;

    for (int i = threadIdx.x; i < T * (kHeadDim / 2); i += blockDim.x) {
        const int j = i / (kHeadDim / 2), c = i % (kHeadDim / 2);
        const long long off = base + j * row_stride;
        s_q[j * kRowWords + c] = reinterpret_cast<const __nv_bfloat162*>(q + off)[c];
        s_k[j * kRowWords + c] = reinterpret_cast<const __nv_bfloat162*>(k + off)[c];
        s_v[j * kRowWords + c] = reinterpret_cast<const __nv_bfloat162*>(v + off)[c];
        s_do[j * kRowWords + c] = reinterpret_cast<const __nv_bfloat162*>(dout + off)[c];
    }
    for (int j = threadIdx.x; j < T; j += blockDim.x) s_keep[j] = mask[b * T + j] != 0;
    __syncthreads();

    const float scale_div = sqrtf(static_cast<float>(kHeadDim));
    float* a = s_a + warp * T;
    float* p_row = s_b + warp * T;

    // phase 1: one warp per query row t -> dQ[t], and the row's max, sum, D
    for (int t = warp; t < T; t += kBwdWarps) {
        const __nv_bfloat162* qt = s_q + t * kRowWords;
        const __nv_bfloat162* do_t = s_do + t * kRowWords;
        float mx = -FLT_MAX;
        for (int j = lane; j < T; j += 32) {
            const float s = s_keep[j] ? dot_row(qt, s_k + j * kRowWords) / scale_div : -FLT_MAX;
            a[j] = s;
            mx = fmaxf(mx, s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.0f;
        for (int j = lane; j < T; j += 32) {
            const float e = expf(a[j] - mx);
            a[j] = e;
            sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        float dsum = 0.0f;
        for (int j = lane; j < T; j += 32) {
            const float p = a[j] / sum;
            const float dp = round_bf16(dot_row(do_t, s_v + j * kRowWords));
            a[j] = p;
            p_row[j] = dp;
            dsum += p * dp;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
        for (int j = lane; j < T; j += 32) {
            const float p = a[j];
            a[j] = s_keep[j] ? (p * p_row[j] - p * dsum) / scale_div : 0.0f;
        }
        if (lane == 0) {
            s_max[t] = mx;
            s_sum[t] = sum;
            s_dsum[t] = dsum;
        }
        __syncwarp();
        float acc = 0.0f;
        for (int j = 0; j < T; ++j) acc += a[j] * row_elem(s_k, j, lane);
        dq[base + static_cast<long long>(t) * row_stride + lane] = __float2bfloat16(acc);
        __syncwarp();
    }
    __syncthreads();

    // phase 2: one warp per key row s -> dK[s], dV[s]
    for (int s = warp; s < T; s += kBwdWarps) {
        const __nv_bfloat162* ks = s_k + s * kRowWords;
        const __nv_bfloat162* vs = s_v + s * kRowWords;
        const bool keep = s_keep[s];
        for (int i = lane; i < T; i += 32) {
            const float sc = keep ? dot_row(s_q + i * kRowWords, ks) / scale_div : -FLT_MAX;
            const float p = expf(sc - s_max[i]) / s_sum[i];
            const float dp = round_bf16(dot_row(s_do + i * kRowWords, vs));
            a[i] = keep ? (p * dp - p * s_dsum[i]) / scale_div : 0.0f;
            p_row[i] = round_bf16(p);
        }
        __syncwarp();
        float acc_k = 0.0f, acc_v = 0.0f;
        for (int i = 0; i < T; ++i) {
            acc_k += a[i] * row_elem(s_q, i, lane);
            acc_v += p_row[i] * row_elem(s_do, i, lane);
        }
        const long long off = base + static_cast<long long>(s) * row_stride + lane;
        dk[off] = __float2bfloat16(acc_k);
        dv[off] = __float2bfloat16(acc_v);
        __syncwarp();
    }
}

}  // namespace

extern "C" {

// q, k, v bf16[B, T, H, 32] (16-byte aligned) and mask i32[B, T] -> out
// bf16[B, T, H * 32]. T must be 1..256. Returns the CUDA status of the launch.
int stract_attention(const void* q, const void* k, const void* v, const int* mask, void* out,
                     int B, int T, int H, cudaStream_t stream) {
    if (B <= 0 || H <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT) return cudaErrorInvalidValue;
    const int chunks = (T + kTile - 1) / kTile;
    const dim3 grid(chunks, H, B);
    const size_t smem = attention_smem_bytes(chunks);  // at most 37,888 bytes: no opt-in
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    const auto* kk = static_cast<const __nv_bfloat16*>(k);
    const auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* o = static_cast<__nv_bfloat16*>(out);
    switch (chunks) {
        case 1: attention_kernel<1><<<grid, kThreads, smem, stream>>>(qq, kk, vv, mask, o, T, H); break;
        case 2: attention_kernel<2><<<grid, kThreads, smem, stream>>>(qq, kk, vv, mask, o, T, H); break;
        case 3: attention_kernel<3><<<grid, kThreads, smem, stream>>>(qq, kk, vv, mask, o, T, H); break;
        default: attention_kernel<4><<<grid, kThreads, smem, stream>>>(qq, kk, vv, mask, o, T, H);
    }
    return cudaGetLastError();
}

// q, k, v, dout bf16[B, T, H, 32] (dout the gradient of the [B, T, H * 32]
// context), mask i32[B, T] -> dq, dk, dv bf16[B, T, H, 32]. T must be
// 1..256. Returns the CUDA status of the launch.
int stract_attention_backward(const void* q, const void* k, const void* v, const int* mask,
                              const void* dout, void* dq, void* dk, void* dv, int B, int T, int H,
                              cudaStream_t stream) {
    if (B <= 0 || H <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT) return cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        attention_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(backward_smem_bytes(kMaxT)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid(H, B);
    attention_backward_kernel<<<grid, kBwdWarps * 32, backward_smem_bytes(T), stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<const __nv_bfloat16*>(dout),
        static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), T, H);
    return cudaGetLastError();
}

}  // extern "C"
