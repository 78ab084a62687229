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
// What bounds it: at the encoder's shapes (head dim 32, T <= 256) the whole
// K and V of one (batch row, head) fit in 33 KB of shared memory, and every
// query row needs 2 * T * 32 multiply-adds per matrix, so the kernel is
// bound by CUDA-core arithmetic over shared memory, not by device memory
// (q, k, v and the context are read or written once per query tile). The
// design: one block of four warps per (query tile of 32 rows, head, batch
// row); K and V staged once per block; one warp per query row at a time.
// For the scores each lane owns keys lane, lane+32, ... and dots its key
// with the query row (K rows are padded to 17 words so a warp's 32 keys hit
// 32 different banks); the softmax max and sum are warp reductions; for P.V
// each lane owns one of the 32 output dimensions and walks the keys in order.
// Masking by finfo(f32).min and not -inf keeps a fully masked row finite: its
// scores are all equal, so its weights are uniform, as in the reference.
// A tensor-core version (mma over 64-row tiles) is later work.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kMaxT = 256;
constexpr int kQueryTile = 32;
constexpr int kWarps = 4;
constexpr int kKeyWords = kHeadDim / 2 + 1;  // bf16 pairs per staged K row, padded

__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ out, int T, int H) {
    __shared__ __nv_bfloat162 s_k[kMaxT][kKeyWords];
    __shared__ __nv_bfloat162 s_v[kMaxT][kHeadDim / 2];
    __shared__ float s_p[kWarps][kMaxT];
    __shared__ float s_q[kWarps][kHeadDim];
    __shared__ unsigned char s_keep[kMaxT];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQueryTile;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long row_stride = static_cast<long long>(H) * kHeadDim;
    const long long base = static_cast<long long>(b) * T * row_stride + h * kHeadDim;

    for (int i = threadIdx.x; i < T * (kHeadDim / 2); i += blockDim.x) {
        const int j = i / (kHeadDim / 2), c = i % (kHeadDim / 2);
        const long long off = base + j * row_stride;
        s_k[j][c] = reinterpret_cast<const __nv_bfloat162*>(k + off)[c];
        s_v[j][c] = reinterpret_cast<const __nv_bfloat162*>(v + off)[c];
    }
    for (int j = threadIdx.x; j < T; j += blockDim.x) s_keep[j] = mask[b * T + j] != 0;
    __syncthreads();

    // the reference divides the f32 scores by np.sqrt(head_dim) rounded to f32
    const float scale_div = sqrtf(static_cast<float>(kHeadDim));
    for (int r = warp; r < kQueryTile; r += kWarps) {
        const int t = q0 + r;
        if (t >= T) break;  // the same for every lane of the warp
        const long long qoff = base + static_cast<long long>(t) * row_stride;
        s_q[warp][lane] = __bfloat162float(q[qoff + lane]);
        __syncwarp();

        float mx = -FLT_MAX;
        for (int j = lane; j < T; j += 32) {
            float acc = 0.0f;
#pragma unroll
            for (int c = 0; c < kHeadDim / 2; ++c) {
                const float2 kk = __bfloat1622float2(s_k[j][c]);
                acc += s_q[warp][2 * c] * kk.x;
                acc += s_q[warp][2 * c + 1] * kk.y;
            }
            const float s = s_keep[j] ? acc / scale_div : -FLT_MAX;
            s_p[warp][j] = s;
            mx = fmaxf(mx, s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.0f;
        for (int j = lane; j < T; j += 32) {
            const float e = expf(s_p[warp][j] - mx);
            s_p[warp][j] = e;
            sum += e;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        for (int j = lane; j < T; j += 32)
            s_p[warp][j] = __bfloat162float(__float2bfloat16(s_p[warp][j] / sum));
        __syncwarp();

        float acc = 0.0f;
        const __nv_bfloat16* s_vh = reinterpret_cast<const __nv_bfloat16*>(&s_v[0][0]);
        for (int j = 0; j < T; ++j) acc += s_p[warp][j] * __bfloat162float(s_vh[j * kHeadDim + lane]);
        out[qoff + lane] = __float2bfloat16(acc);
        __syncwarp();
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

// q, k, v bf16[B, T, H, 32] and mask i32[B, T] -> out bf16[B, T, H * 32].
// T must be 1..256. Returns the CUDA status of the launch.
int stract_attention(const void* q, const void* k, const void* v, const int* mask, void* out,
                     int B, int T, int H, cudaStream_t stream) {
    if (B <= 0 || H <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT) return cudaErrorInvalidValue;
    const dim3 grid((T + kQueryTile - 1) / kQueryTile, H, B);
    attention_kernel<<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), T, H);
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
    static const cudaError_t attr = cudaFuncSetAttribute(
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
