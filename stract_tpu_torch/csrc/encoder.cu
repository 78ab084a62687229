// K5a: masked self-attention of the BERT encoder on Hopper (sm_90a).
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

}  // extern "C"
