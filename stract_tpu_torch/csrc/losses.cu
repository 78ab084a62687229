// Hand-written Hopper kernels of the training steps' loss heads (K15c),
// value and gradient in one launch each. Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// into a plain C library bound with ctypes. Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// stract_info_nce replaces the dual encoder's in-batch InfoNCE head
//     (stract_tpu/entrypoint/train_encoders.py:246-251: optax's
//     softmax_cross_entropy_with_integer_labels of the B x B logits against
//     the diagonal, mean) as jax.value_and_grad takes it: per row, z = l -
//     max, s = sum(exp(z)); loss = sum over rows of (log(s) - z_ii) / B; the
//     gradient (exp(z) / s - onehot) / B. info_nce_plain (ops/losses.py)
//     writes the same expressions.
// stract_pair_loss replaces the cross encoder's pairwise logistic head
//     ranking_loss (stract_tpu/parallel/train.py:26-28: mean softplus(-(s+ -
//     s-)), softplus(x) = max(x, 0) + log1p(exp(-|x|)) as jnp.logaddexp(x,
//     0), gradient exp(x - softplus(x))) and its distilled form (:92-99:
//     + alpha (mean (s+ - t+)^2 + mean (s- - t-)^2)); pair_loss_plain.
//
// What bounds them: launch latency. B x B f32 logits are 16 KB at B = 64,
// B pairs a few hundred bytes; the work is a few hundred exps. A single
// program that walks the rows in order (the Triton kernel this replaced)
// spends its time in the chain of dependent loads, reductions and stores
// of one row after another. The design runs rows in parallel and keeps
// every sum in a fixed order, so two calls are bit-equal and the result
// does not depend on the card:
//   - InfoNCE: a warp a row. Each lane takes the row's columns lane, lane +
//     32, ...: up to 256 columns it holds them in registers, all loaded at
//     once, and takes exp once; past 256 it reads them from L1 for each
//     pass. The row max, then sum(exp(z)), each reduced by __shfl_xor_sync,
//     then the gradient. One warp sums the rows' loss terms, lane j the rows
//     j, j + 32, ... in order, then the lanes by a fixed shuffle tree. Two
//     forms, the same bits: one block of up to 32 warps, rows strided over
//     them, the terms in shared memory (one launch); or a grid of 8 rows
//     (warps) a block, the terms to a scratch in device memory, and a
//     second launch of one warp for the sum. One block is one SM: at B =
//     256 it took 0.108 ms on the H100 (8 rows a warp), the grid 0.011; at
//     B = 64 0.0075 against 0.0047, at B = 32 0.0030 against 0.0035.
//     ops/kernels.py keeps one block up to 64 rows (the dual step's batch),
//     where a call then costs the host one launch and one allocation fewer
//     (0.011-0.020 ms a call against the grid's 0.021-0.022).
//   - pair: one block, a thread a pair (pairs strided over the threads);
//     each thread's softplus and MSE terms in order, then a fixed shuffle
//     tree per warp, then the warps' partials in warp order.
// expf, logf and log1pf are the full-precision forms (not __expf): the
// heads are held to their plain twins at rtol 1e-5. Built with --fmad=false
// so a*b+c rounds like the twins' separate multiply and add.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxRows = 12288;  // InfoNCE rows in one block (their terms fill 48 KB)
constexpr int kGridRows = 8;     // InfoNCE rows (warps) a block of the grid form

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// x / s, or x itself when it is 0: a zero dividend takes the IEEE division's
// slow path (exp(z) underflows to 0 far from the row max)
__device__ __forceinline__ float div_nonzero(float x, float s) { return x == 0.0f ? x : x / s; }

// the row's gradient into out and its loss term log(s) - z_ii (returned in
// every lane), lane `lane` of the row's warp; K > 0: the row's columns lane,
// lane + 32, ... (K of them, B <= 32 K) held in registers, loaded at once,
// exp taken once; K = 0: any B, the columns read again from L1 for each pass
template <int K>
__device__ __forceinline__ float info_nce_row(const float* __restrict__ row,
                                              float* __restrict__ out, int r, int B, int lane,
                                              float n) {
    float m = -INFINITY, s = 0.0f;
    if constexpr (K > 0) {
        float v[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int c = lane + 32 * i;
            v[i] = c < B ? __ldg(row + c) : -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < K; ++i) m = fmaxf(m, v[i]);
        m = warp_max(m);
#pragma unroll
        for (int i = 0; i < K; ++i) {
            v[i] = lane + 32 * i < B ? expf(v[i] - m) : 0.0f;
            s += v[i];
        }
        s = warp_sum(s);
#pragma unroll
        for (int i = 0; i < K; ++i) {
            const int c = lane + 32 * i;
            if (c < B) {
                const float q = div_nonzero(v[i], s);
                out[c] = c == r ? (q - 1.0f) / n : div_nonzero(q, n);
            }
        }
    } else {
        for (int c = lane; c < B; c += 32) m = fmaxf(m, __ldg(row + c));
        m = warp_max(m);
        for (int c = lane; c < B; c += 32) s += expf(__ldg(row + c) - m);
        s = warp_sum(s);
        for (int c = lane; c < B; c += 32) {
            const float q = div_nonzero(expf(__ldg(row + c) - m), s);
            out[c] = c == r ? (q - 1.0f) / n : div_nonzero(q, n);
        }
    }
    return logf(s) - (__ldg(row + r) - m);
}

// the loss: the B terms summed by one warp, lane j the rows j, j + 32, ... in
// order, then the lanes by a fixed shuffle tree, over B
__device__ __forceinline__ void ordered_mean(const float* terms, int B, int lane, float n,
                                             float* loss) {
    float t = 0.0f;
    for (int r = lane; r < B; r += 32) t += terms[r];
    t = warp_sum(t);
    if (lane == 0) *loss = t / n;
}

// one block: rows strided over its warps, the terms in shared memory
template <int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
info_nce_kernel(const float* __restrict__ logits, float* __restrict__ loss,
                float* __restrict__ d, int B) {
    extern __shared__ float s_term[];  // [B]: each row's log(s) - z_ii
    const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float n = static_cast<float>(B);
    for (int r = warp; r < B; r += warps) {
        const long long off = static_cast<long long>(r) * B;
        const float term = info_nce_row<K>(logits + off, d + off, r, B, lane, n);
        if (lane == 0) s_term[r] = term;
    }
    __syncthreads();
    if (warp == 0) ordered_mean(s_term, B, lane, n, loss);
}

// the grid: a warp a row, kGridRows rows a block, the terms to device memory
// for info_nce_sum_kernel
template <int K>
__global__ void __launch_bounds__(kGridRows * 32)
info_nce_rows_kernel(const float* __restrict__ logits, float* __restrict__ d,
                     float* __restrict__ terms, int B) {
    const int r = blockIdx.x * kGridRows + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (r >= B) return;
    const long long off = static_cast<long long>(r) * B;
    const float term = info_nce_row<K>(logits + off, d + off, r, B, lane, static_cast<float>(B));
    if (lane == 0) terms[r] = term;
}

__global__ void __launch_bounds__(32)
info_nce_sum_kernel(const float* __restrict__ terms, float* __restrict__ loss, int B) {
    ordered_mean(terms, B, threadIdx.x, static_cast<float>(B), loss);
}

template <int K>
cudaError_t launch_info_nce(const float* logits, float* loss, float* d, float* terms, int B,
                            int blocks, cudaStream_t stream) {
    if (blocks == 1) {
        const int warps = B < 1 ? 1 : (B < kMaxWarps ? B : kMaxWarps);
        info_nce_kernel<K><<<1, warps * 32, sizeof(float) * (B > 0 ? B : 1), stream>>>(
            logits, loss, d, B);
        return cudaGetLastError();
    }
    info_nce_rows_kernel<K><<<blocks, kGridRows * 32, 0, stream>>>(logits, d, terms, B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    info_nce_sum_kernel<<<1, 32, 0, stream>>>(terms, loss, B);
    return cudaGetLastError();
}

__global__ void __launch_bounds__(kMaxWarps * 32)
pair_loss_kernel(const float* __restrict__ sp, const float* __restrict__ sn,
                 const float* __restrict__ tp, const float* __restrict__ tn,
                 float* __restrict__ loss, float* __restrict__ dp, float* __restrict__ dn,
                 int B, float alpha, int distill) {
    __shared__ float s_part[kMaxWarps][3];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const float n = static_cast<float>(B);
    float soft_sum = 0.0f, rp_sum = 0.0f, rn_sum = 0.0f;
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
        const float a = sp[i], b = sn[i];
        const float x = -(a - b);
        const float soft = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
        const float sig = expf(x - soft);
        soft_sum += soft;
        float gp = -sig / n, gn = sig / n;
        if (distill) {
            const float rp = a - tp[i], rn = b - tn[i];
            rp_sum += rp * rp;
            rn_sum += rn * rn;
            gp = gp + alpha * (2.0f * rp / n);
            gn = gn + alpha * (2.0f * rn / n);
        }
        dp[i] = gp;
        dn[i] = gn;
    }
    soft_sum = warp_sum(soft_sum);
    rp_sum = warp_sum(rp_sum);
    rn_sum = warp_sum(rn_sum);
    if (lane == 0) {
        s_part[warp][0] = soft_sum;
        s_part[warp][1] = rp_sum;
        s_part[warp][2] = rn_sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float soft = 0.0f, rp2 = 0.0f, rn2 = 0.0f;
        for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) {
            soft += s_part[w][0];
            rp2 += s_part[w][1];
            rn2 += s_part[w][2];
        }
        float total = soft / n;
        if (distill) total = total + alpha * (rp2 / n + rn2 / n);
        *loss = total;
    }
}

}  // namespace

extern "C" {

// logits f32[B, B] -> loss f32[] and d f32[B, B], the gradient of the loss
// in the logits (B = 0 gives a NaN loss, as the mean of nothing). blocks = 1:
// one launch of one block (B up to 12,288); blocks = ceil(B / 8): the grid
// of a warp a row, writing the rows' terms to the scratch terms f32[B], then
// one warp summing them in the same order (two launches, the same result).
// Returns the CUDA status.
int stract_info_nce(const float* logits, float* loss, float* d, float* terms, int B,
                    int blocks, cudaStream_t stream) {
    if (B < 0 || (blocks == 1 && B > kMaxRows) ||
        (blocks != 1 && (terms == nullptr || blocks != (B + kGridRows - 1) / kGridRows)))
        return cudaErrorInvalidValue;
    if (B <= 32) return launch_info_nce<1>(logits, loss, d, terms, B, blocks, stream);
    if (B <= 64) return launch_info_nce<2>(logits, loss, d, terms, B, blocks, stream);
    if (B <= 128) return launch_info_nce<4>(logits, loss, d, terms, B, blocks, stream);
    if (B <= 256) return launch_info_nce<8>(logits, loss, d, terms, B, blocks, stream);
    return launch_info_nce<0>(logits, loss, d, terms, B, blocks, stream);
}

// s_pos, s_neg f32[B] (and, when distill != 0, the targets t_pos, t_neg
// f32[B]) -> loss f32[], d_pos, d_neg f32[B]. One launch on the stream;
// returns its CUDA status.
int stract_pair_loss(const float* s_pos, const float* s_neg, const float* t_pos,
                     const float* t_neg, float* loss, float* d_pos, float* d_neg, int B,
                     float alpha, int distill, cudaStream_t stream) {
    if (B < 0 || (distill && (t_pos == nullptr || t_neg == nullptr)))
        return cudaErrorInvalidValue;
    const int warps = B <= 32 ? 1 : (B + 31) / 32 < kMaxWarps ? (B + 31) / 32 : kMaxWarps;
    pair_loss_kernel<<<1, warps * 32, 0, stream>>>(
        s_pos, s_neg, t_pos, t_neg, loss, d_pos, d_neg, B, alpha, distill);
    return cudaGetLastError();
}

}  // extern "C"
