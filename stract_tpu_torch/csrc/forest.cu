// K4: the LambdaMART forest walk on Hopper (sm_90a).
//
// Replaces stract_tpu/ranking/models/lambdamart.py:195 _gbdt_forward, the
// jitted XLA program that advances a [trees, rows] matrix of node indices one
// level per fori_loop step with gathers, then sums one leaf value per tree.
//
// What bounds it: nothing heavy. A forest of T=40 depth-3 trees is 40 x 7
// nodes; per row the walk is T * max_depth dependent loads from shared memory
// plus one read of the row's feature vector (46 floats), so the kernel is
// latency-bound on the dependent loads and, at the serving sizes (K = a few
// hundred to 16k rows), on the launch itself. The design keeps it simple: one
// thread per row, the whole forest copied once per block into shared memory,
// the row's features read through L1, trees summed in order 0..T-1 in f32.
//
// Semantics kept from the reference, step for step:
//   - children >= 0 are internal nodes; leaves are encoded -(leaf + 1) and a
//     walk that reached one stays put;
//   - the node index is clipped into [0, N) before every gather;
//   - the loop runs exactly max_depth steps; a walk still on an internal node
//     afterwards reads leaf_value[t, 0] through the clip of -(cur) - 1;
//   - the split goes left when x <= threshold (NaN goes right);
//   - a feature index follows numpy indexing: negative wraps once, then the
//     gather clamps into [0, F).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
forest_kernel(const int* __restrict__ feature, const float* __restrict__ threshold,
              const int* __restrict__ left, const int* __restrict__ right,
              const float* __restrict__ leaf_value, const float* __restrict__ x,
              float* __restrict__ out, int T, int N, int L, int K, int F, int max_depth) {
    extern __shared__ unsigned char smem[];
    int* s_feat = reinterpret_cast<int*>(smem);
    float* s_thr = reinterpret_cast<float*>(s_feat + T * N);
    int* s_left = reinterpret_cast<int*>(s_thr + T * N);
    int* s_right = s_left + T * N;
    float* s_leaf = reinterpret_cast<float*>(s_right + T * N);
    for (int i = threadIdx.x; i < T * N; i += blockDim.x) {
        s_feat[i] = feature[i];
        s_thr[i] = threshold[i];
        s_left[i] = left[i];
        s_right[i] = right[i];
    }
    for (int i = threadIdx.x; i < T * L; i += blockDim.x) s_leaf[i] = leaf_value[i];
    __syncthreads();

    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= K) return;
    const float* row = x + static_cast<long long>(k) * F;
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
        int cur = 0;
        for (int s = 0; s < max_depth && cur >= 0; ++s) {
            const int node = t * N + min(cur, N - 1);
            int f = s_feat[node];
            if (f < 0) f += F;
            f = min(max(f, 0), F - 1);
            cur = row[f] <= s_thr[node] ? s_left[node] : s_right[node];
        }
        const int leaf = min(max(-cur - 1, 0), L - 1);
        acc += s_leaf[t * L + leaf];
    }
    out[k] = acc;
}

}  // namespace

extern "C" {

// feature/left/right i32[T, N], threshold f32[T, N], leaf_value f32[T, L],
// x f32[K, F] -> out f32[K]. Returns the CUDA status of the launch.
int stract_forest(const int* feature, const float* threshold, const int* left,
                  const int* right, const float* leaf_value, const float* x, float* out,
                  int T, int N, int L, int K, int F, int max_depth, cudaStream_t stream) {
    if (K <= 0) return cudaSuccess;
    // the whole forest in shared memory: four i32/f32 node arrays and the leaves
    const long long smem = 16LL * T * N + 4LL * T * L;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            forest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const int blocks = (K + kThreads - 1) / kThreads;
    forest_kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
        feature, threshold, left, right, leaf_value, x, out, T, N, L, K, F, max_depth);
    return cudaGetLastError();
}

}  // extern "C"
