// Hand-written Hopper kernel of the MoE FFN's router (stract_tpu/models/
// bert.py:108-153 MoEMlp), forward and backward. Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// into a plain C library bound with ctypes. Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K15a stract_moe_router replaces the router of MoEMlp (bert.py:124-130):
//     f32 logits = x.f32 . Wr + br over E experts (E <= MAX_E: a handful, so
//     each token's E dot products are the kernel's own loop, not a library
//     product), softmax, argmax with ties to the first expert (jnp.argmax),
//     and the gate probs[top] rounded to bf16. One warp per token: the lanes
//     stride over the H features, keep E partial sums each, and reduce them
//     with shuffles. Bound by reading x (N*H bf16) once; Wr (E*H f32) stays in
//     L1/L2.
// stract_moe_router_backward: what jax.vjp gives through the router: the
//     gate's cotangent lands on probs[top] alone; the softmax VJP
//     (dl = y*g - y*sum(y*g), jax.nn.softmax's jvp transposed) gives the
//     logits' cotangent dl f32[N, E]; dx = bf16(dl . Wr^T), the cotangent of
//     the x -> f32 cast. The same warp per token; bound by writing dx. dWr and
//     dbr are f32 products and sums over dl in PyTorch (ops/moe.py).
//
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_E = 16;

__global__ void moe_router_kernel(const __nv_bfloat16* __restrict__ x,
                                  const float* __restrict__ w, const float* __restrict__ bias,
                                  int N, int H, int E, float* probs, int* top,
                                  __nv_bfloat16* gate) {
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  float acc[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) acc[e] = 0.0f;
  const __nv_bfloat16* xr = x + n * H;
  for (int h = lane; h < H; h += 32) {
    const float xv = __bfloat162float(xr[h]);
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (e < E) acc[e] += xv * w[(long long)e * H + h];
  }
  float p[MAX_E];
  float mx = -INFINITY;
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    if (e >= E) break;
    for (int o = 16; o > 0; o >>= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    p[e] = acc[e] + bias[e];
    mx = fmaxf(mx, p[e]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    if (e >= E) break;
    p[e] = expf(p[e] - mx);
    sum += p[e];
  }
  int t = 0;
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    if (e >= E) break;
    p[e] = p[e] / sum;
    if (p[e] > p[t]) t = e;  // strictly greater: ties stay with the first
  }
  if (lane == 0) {
    for (int e = 0; e < E; ++e) probs[n * E + e] = p[e];
    top[n] = t;
    gate[n] = __float2bfloat16_rn(p[t]);
  }
}

__global__ void moe_router_backward_kernel(const float* __restrict__ probs,
                                           const int* __restrict__ top,
                                           const __nv_bfloat16* __restrict__ dgate,
                                           const float* __restrict__ w, int N, int H, int E,
                                           float* dlogits, __nv_bfloat16* dx) {
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const int t = top[n];
  const float g = __bfloat162float(dgate[n]);
  // dw = y * g with g non-zero at the top expert only; dl = dw + y * (-sum dw)
  const float s = probs[n * E + t] * g;
  float dl[MAX_E];
#pragma unroll
  for (int e = 0; e < MAX_E; ++e) {
    if (e >= E) break;
    const float y = probs[n * E + e];
    dl[e] = (e == t ? s : 0.0f) + y * (-s);
  }
  if (lane == 0)
    for (int e = 0; e < E; ++e) dlogits[n * E + e] = dl[e];
  for (int h = lane; h < H; h += 32) {
    float v = 0.0f;
#pragma unroll
    for (int e = 0; e < MAX_E; ++e)
      if (e < E) v += dl[e] * w[(long long)e * H + h];
    dx[n * H + h] = __float2bfloat16_rn(v);
  }
}

}  // namespace

extern "C" {

// K15a. x bf16[N, H], w f32[E, H], bias f32[E] -> probs f32[N, E], top
// i32[N], gate bf16[N]; E <= 16.
int stract_moe_router(const void* x, const float* w, const float* bias, int N, int H, int E,
                      float* probs, int* top, void* gate, cudaStream_t stream) {
  if (N < 1 || H < 1 || E < 1 || E > MAX_E) return (int)cudaErrorInvalidValue;
  const long long threads = 32ll * N;
  moe_router_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      (const __nv_bfloat16*)x, w, bias, N, H, E, probs, top, (__nv_bfloat16*)gate);
  return (int)cudaGetLastError();
}

// K15a backward. probs f32[N, E], top i32[N], dgate bf16[N], w f32[E, H] ->
// dlogits f32[N, E], dx bf16[N, H].
int stract_moe_router_backward(const float* probs, const int* top, const void* dgate,
                               const float* w, int N, int H, int E, float* dlogits, void* dx,
                               cudaStream_t stream) {
  if (N < 1 || H < 1 || E < 1 || E > MAX_E) return (int)cudaErrorInvalidValue;
  const long long threads = 32ll * N;
  moe_router_backward_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      probs, top, (const __nv_bfloat16*)dgate, w, N, H, E, dlogits, (__nv_bfloat16*)dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
