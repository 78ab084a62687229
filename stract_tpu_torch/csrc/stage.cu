// K16a: the single-head f32 attention of the pipeline stage on Hopper
// (sm_90a), K16b: its backward, and K16d: the SGD update of all the
// parameters of a card in one launch (sgd_multi_kernel, at the end).
//
// Replaces stract_tpu/parallel/pipeline.py:44-48 (_apply_stage): q, k, v
// are the three H-wide column blocks of qkv f32[mb, T, 3H] (one head whose
// width is the whole hidden width H, no mask), scores q.k^T divided by
// sqrt(H) rounded to f32, softmax over the keys (row max subtracted, exp,
// divided by the row sum), out = P.v f32[mb, T, H]; and the gradient that
// jax.value_and_grad takes through it in make_pipeline_train_step
// (:133-136): dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(P dP)) / sqrt(H),
// dQ = dS K, dK = dS^T Q, written into the three column blocks of one
// dqkv f32[mb, T, 3H]. The products around it (x @ attn_qkv, @ attn_out)
// stay cuBLAS f32 matrix products, as the JAX package leaves them to XLA.
//
// What bounds it: every query row needs 2 T H multiply-adds for its scores
// and 2 T H for P.V (the backward five such products); at the smoke's
// shapes (T = 128, H = 384) that is ~64 flops per byte of q, k, v moved, so
// the kernels are bound by f32 arithmetic on the CUDA cores. The head width
// is a runtime argument (up to 1,024): one key row is 1.5 KB at H = 384,
// so K and V cannot be staged whole; they are staged kChunk keys at a time.
//
// The forward: one block of 8 warps per (tile of 8 query rows, batch row).
// The tile's Q rows are staged in shared memory; for each chunk of 32 keys
// (rows padded to an odd stride, so a warp's 32 keys hit 32 banks) warp w
// dots query row w with lane's key, and divides by sqrt(H); the tile's
// T scores stay in shared memory (T <= 256). One warp per row takes the
// softmax; then each thread owns up to 4 of the H output columns and walks
// the keys in order, V read from device memory (coalesced over the
// columns; each block reads its batch row's V once), the 8 rows' sums in
// registers.
// The backward: kernel 1, per (tile of 8 query rows, batch row), recomputes
// the scores (K chunks) and dP = dO V^T (V chunks) as the forward does,
// the softmax, D = rowsum(P dP) and dS; writes P and dS to scratch
// f32[mb, T, T] and dQ = dS K (columns owned as in the forward). Kernel 2,
// per (tile of 8 key rows, batch row), stages its 8 columns of P and dS
// and walks the query rows: dK = dS^T Q and dV = P^T dO, 8 rows of each in
// registers. No atomics: every output element has one writer, so the
// result does not depend on scheduling.
// Tensor cores (TF32 or 3xTF32 mma, wgmma) are later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 8;             // query (or key) rows per block
constexpr int kChunk = 32;           // keys per staged chunk
constexpr int kThreads = kRows * 32; // one warp per row of the tile
constexpr int kMaxT = 256;
constexpr int kMaxH = 1024;
constexpr int kCols = kMaxH / kThreads;  // output columns a thread owns, at most

__host__ __device__ inline int key_stride(int H) { return H | 1; }

size_t forward_smem_bytes(int T, int H) {
    return sizeof(float) * (static_cast<size_t>(kRows) * H + kChunk * key_stride(H) + kRows * T);
}

size_t backward_smem_bytes(int T, int H) {
    return sizeof(float) *
           (2 * static_cast<size_t>(kRows) * H + kChunk * key_stride(H) + 2 * kRows * T);
}

// Stage rows q0..q0+kRows-1 of the first H columns of src (q in qkv, or
// dout) into s[kRows][H]; rows past T are zeros.
__device__ void stage_rows(const float* __restrict__ src, long long row0, int ld, int q0, int T,
                           int H, float* s) {
    for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
        const int r = i / H, c = i % H;
        s[i] = q0 + r < T ? src[(row0 + q0 + r) * ld + c] : 0.0f;
    }
}

// out[r][j] = dot(a[r], qkv[row0 + j, col : col + H]) (/ scale if divide) for
// the tile's kRows rows a (in shared memory) and all T keys, the keys staged
// kChunk at a time in s_k. Ends synchronised.
__device__ void row_dots(const float* __restrict__ qkv, long long row0, int col, int T, int H,
                         const float* a, float* s_k, float* out, bool divide, float scale) {
    const int ld = 3 * H, ks = key_stride(H);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int j0 = 0; j0 < T; j0 += kChunk) {
        const int n = min(kChunk, T - j0);
        __syncthreads();  // the previous chunk is read
        for (int i = threadIdx.x; i < n * H; i += kThreads) {
            const int j = i / H, c = i % H;
            s_k[j * ks + c] = qkv[(row0 + j0 + j) * ld + col + c];
        }
        __syncthreads();
        if (lane < n) {
            const float* ar = a + warp * H;
            const float* kr = s_k + lane * ks;
            float acc = 0.0f;
            for (int c = 0; c < H; ++c) acc += ar[c] * kr[c];
            out[warp * T + j0 + lane] = divide ? acc / scale : acc;
        }
    }
    __syncthreads();
}

// Softmax of row `warp` of s[kRows][T] in place, by its warp (the row's max
// and sum are not kept: the backward recomputes them).
__device__ void softmax_row(float* s, int T) {
    const int lane = threadIdx.x % 32;
    float* row = s + (threadIdx.x / 32) * T;
    float mx = -CUDART_INF_F;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < T; j += 32) {
        const float e = expf(row[j] - mx);
        row[j] = e;
        sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < T; j += 32) row[j] = row[j] / sum;
}

// out[r][d] = sum_j w[r][j] * qkv[row0 + j, col + d] for the tile's rows
// (weights w[kRows][T] in shared memory), written to
// dst[(row0 + q0 + r) * ld_dst + d] for rows below T.
__device__ void weighted_rows(const float* __restrict__ qkv, long long row0, int col, int T,
                              int H, const float* w, float* __restrict__ dst, int ld_dst,
                              int q0) {
    const int ld = 3 * H;
    float acc[kCols][kRows];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = 0.0f;
    for (int j = 0; j < T; ++j) {
        const float* src = qkv + (row0 + j) * ld + col;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int d = threadIdx.x + c * kThreads;
            if (d < H) {
                const float x = src[d];
#pragma unroll
                for (int r = 0; r < kRows; ++r) acc[c][r] += w[r * T + j] * x;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (q0 + r >= T) break;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int d = threadIdx.x + c * kThreads;
            if (d < H) dst[(row0 + q0 + r) * ld_dst + d] = acc[c][r];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
stage_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T, int H,
                       float scale) {
    extern __shared__ __align__(16) float smem[];
    float* s_q = smem;                           // [kRows][H]
    float* s_k = s_q + kRows * H;                // [kChunk][H | 1]
    float* s_p = s_k + kChunk * key_stride(H);   // [kRows][T]
    const int q0 = blockIdx.x * kRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;

    stage_rows(qkv, row0, 3 * H, q0, T, H, s_q);
    row_dots(qkv, row0, H, T, H, s_q, s_k, s_p, true, scale);
    softmax_row(s_p, T);
    __syncthreads();
    weighted_rows(qkv, row0, 2 * H, T, H, s_p, out, H, q0);
}

// K16b, kernel 1: per query tile, P and dS into scratch, dQ into dqkv.
__global__ void __launch_bounds__(kThreads)
stage_attention_bwd_query_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                 float* __restrict__ probs, float* __restrict__ dscores,
                                 float* __restrict__ dqkv, int T, int H, float scale) {
    extern __shared__ __align__(16) float smem[];
    float* s_q = smem;                           // [kRows][H]
    float* s_do = s_q + kRows * H;               // [kRows][H]
    float* s_k = s_do + kRows * H;               // [kChunk][H | 1]
    float* s_p = s_k + kChunk * key_stride(H);   // [kRows][T]: scores, then P
    float* s_dp = s_p + kRows * T;               // [kRows][T]: dP, then dS
    const int q0 = blockIdx.x * kRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    stage_rows(qkv, row0, 3 * H, q0, T, H, s_q);
    stage_rows(dout, row0, H, q0, T, H, s_do);
    row_dots(qkv, row0, H, T, H, s_q, s_k, s_p, true, scale);
    row_dots(qkv, row0, 2 * H, T, H, s_do, s_k, s_dp, false, scale);
    softmax_row(s_p, T);
    {   // D = rowsum(P dP); dS = P (dP - D) / sqrt(H); P and dS to scratch
        const float* p = s_p + warp * T;
        float* ds = s_dp + warp * T;
        float dsum = 0.0f;
        for (int j = lane; j < T; j += 32) dsum += p[j] * ds[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
        const bool live = q0 + warp < T;
        const long long out_row = (row0 + q0 + warp) * T;
        for (int j = lane; j < T; j += 32) {
            const float v = p[j] * (ds[j] - dsum) / scale;
            ds[j] = v;
            if (live) {
                probs[out_row + j] = p[j];
                dscores[out_row + j] = v;
            }
        }
    }
    __syncthreads();
    weighted_rows(qkv, row0, H, T, H, s_dp, dqkv, 3 * H, q0);
}

// K16b, kernel 2: per key tile, dK = dS^T Q and dV = P^T dO into dqkv.
__global__ void __launch_bounds__(kThreads)
stage_attention_bwd_key_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                               const float* __restrict__ probs,
                               const float* __restrict__ dscores, float* __restrict__ dqkv,
                               int T, int H) {
    __shared__ float s_p[kMaxT][kRows];
    __shared__ float s_ds[kMaxT][kRows];
    const int k0 = blockIdx.x * kRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    for (int i = threadIdx.x; i < T * kRows; i += kThreads) {
        const int r = i / kRows, c = i % kRows;
        const bool live = k0 + c < T;
        s_p[r][c] = live ? probs[(row0 + r) * T + k0 + c] : 0.0f;
        s_ds[r][c] = live ? dscores[(row0 + r) * T + k0 + c] : 0.0f;
    }
    __syncthreads();

    float acc_k[kCols][kRows], acc_v[kCols][kRows];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc_k[c][r] = acc_v[c][r] = 0.0f;
    for (int i = 0; i < T; ++i) {
        const float* q = qkv + (row0 + i) * 3 * H;
        const float* g = dout + (row0 + i) * H;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int d = threadIdx.x + c * kThreads;
            if (d < H) {
                const float qd = q[d], gd = g[d];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    acc_k[c][r] += s_ds[i][r] * qd;
                    acc_v[c][r] += s_p[i][r] * gd;
                }
            }
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        if (k0 + r >= T) break;
        float* dst = dqkv + (row0 + k0 + r) * 3 * H;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int d = threadIdx.x + c * kThreads;
            if (d < H) {
                dst[H + d] = acc_k[c][r];
                dst[2 * H + d] = acc_v[c][r];
            }
        }
    }
}

// the reference divides by np.sqrt(H), which JAX rounds to f32
float scale_divisor(int H) { return sqrtf(static_cast<float>(H)); }

// K16d: the SGD update p = p - lr * g of make_pipeline_train_step (:136)
// over every parameter of a card in one launch. The pointer table travels
// by value as the kernel's parameter (SgdArgs, about 2 KB of the 4 KB a
// launch takes), so no device-side table has to outlive the launch. What
// bounds it: 12 bytes of device memory an element (p read and written, g
// read), no arithmetic to speak of; one launch over all tensors saves the
// per-tensor launches, which cost far more than the work at the
// pipeline's 25 tensors. Block i of the grid finds its tensor by a binary
// search of the block prefix; a block covers kSgdTile elements, 16-byte
// loads and stores where both pointers are 16-byte aligned and n % 4 == 0,
// single floats otherwise (views at an offset, odd sizes). The product
// rounds before the difference (__fmul_rn, __fsub_rn: never fused), as in
// the plain version's p - lr * g.
}  // namespace

// at namespace scope: the C entry point below takes it, and a type of the
// anonymous namespace would give that function internal linkage
constexpr int kSgdMaxTensors = 64;

struct SgdArgs {
    float* p[kSgdMaxTensors];
    const float* g[kSgdMaxTensors];
    long long n[kSgdMaxTensors];
    long long first_block[kSgdMaxTensors + 1];  // prefix of the tensors' block counts
    int count;
    float lr;
};

namespace {

constexpr int kSgdThreads = 256;
constexpr int kSgdTile = kSgdThreads * 4 * 4;  // elements a block

__global__ void __launch_bounds__(kSgdThreads) sgd_multi_kernel(const SgdArgs args) {
    const long long blk = blockIdx.x;
    int lo = 0, hi = args.count - 1;  // the last tensor whose first block <= blk
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (args.first_block[mid] <= blk) lo = mid; else hi = mid - 1;
    }
    float* p = args.p[lo];
    const float* g = args.g[lo];
    const long long n = args.n[lo];
    const long long start = (blk - args.first_block[lo]) * kSgdTile;
    const long long end = min(start + kSgdTile, n);
    const float lr = args.lr;
    const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    if (vec) {
        float4* p4 = reinterpret_cast<float4*>(p);
        const float4* g4 = reinterpret_cast<const float4*>(g);
        for (long long i = start / 4 + threadIdx.x; i < end / 4; i += kSgdThreads) {
            float4 a = p4[i];
            const float4 b = g4[i];
            a.x = __fsub_rn(a.x, __fmul_rn(lr, b.x));
            a.y = __fsub_rn(a.y, __fmul_rn(lr, b.y));
            a.z = __fsub_rn(a.z, __fmul_rn(lr, b.z));
            a.w = __fsub_rn(a.w, __fmul_rn(lr, b.w));
            p4[i] = a;
        }
    } else {
        for (long long i = start + threadIdx.x; i < end; i += kSgdThreads)
            p[i] = __fsub_rn(p[i], __fmul_rn(lr, g[i]));
    }
}

}  // namespace

extern "C" {

// qkv f32[B, T, 3H] -> out f32[B, T, H]. T must be 1..256 and H 1..1024.
// Returns the CUDA status of the launch.
int stract_stage_attention(const float* qkv, float* out, int B, int T, int H,
                           cudaStream_t stream) {
    if (B <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT || H <= 0 || H > kMaxH || B > 65535) return cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        stage_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(forward_smem_bytes(kMaxT, kMaxH)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((T + kRows - 1) / kRows, B);
    stage_attention_kernel<<<grid, kThreads, forward_smem_bytes(T, H), stream>>>(
        qkv, out, T, H, scale_divisor(H));
    return cudaGetLastError();
}

// qkv f32[B, T, 3H], dout f32[B, T, H] (the gradient of the output) ->
// dqkv f32[B, T, 3H]; probs and dscores f32[B, T, T] are scratch (P and
// dS, written by the first kernel, read by the second). T must be 1..256
// and H 1..1024. Returns the CUDA status of the launches.
int stract_stage_attention_backward(const float* qkv, const float* dout, float* probs,
                                    float* dscores, float* dqkv, int B, int T, int H,
                                    cudaStream_t stream) {
    if (B <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT || H <= 0 || H > kMaxH || B > 65535) return cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        stage_attention_bwd_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(backward_smem_bytes(kMaxT, kMaxH)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((T + kRows - 1) / kRows, B);
    stage_attention_bwd_query_kernel<<<grid, kThreads, backward_smem_bytes(T, H), stream>>>(
        qkv, dout, probs, dscores, dqkv, T, H, scale_divisor(H));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    stage_attention_bwd_key_kernel<<<grid, kThreads, 0, stream>>>(qkv, dout, probs, dscores,
                                                                   dqkv, T, H);
    return cudaGetLastError();
}

// K16d over args->count (1..64) tensors of one card, args->first_block their
// block prefix (kSgdTile elements a block) and `blocks` its total. Returns
// the CUDA status of the launch.
int stract_sgd_multi(const SgdArgs* args, long long blocks, cudaStream_t stream) {
    if (blocks <= 0) return cudaSuccess;
    if (args->count < 1 || args->count > kSgdMaxTensors || blocks > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    sgd_multi_kernel<<<static_cast<unsigned>(blocks), kSgdThreads, 0, stream>>>(*args);
    return cudaGetLastError();
}

}  // extern "C"
