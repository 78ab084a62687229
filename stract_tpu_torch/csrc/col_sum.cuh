// The column sum of the kernels that reduce over rows with a fixed grid and
// no atomics: K14b (dweight, dbias) and K14c (db) in encoder.cu, K15a's
// backward (the router's dWr and dbr) in moe.cu. Each block of such a kernel
// writes its columns' partials; this kernel sums them over the blocks in a
// fixed order, so two calls give the same bits. Included by each source
// that launches it (each library keeps its own copy).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSumCols = 32;   // columns a block (one a lane) ...
constexpr int kSumGroups = 8;  // ... and groups of the blocks' partials (one a warp)

// the blocks' partials [outputs][blocks][N] summed for kSumCols columns of
// one output a block, warp j summing blocks j, j + GROUPS, ... in order,
// then the groups summed in order, the total stored as T (f32, or bf16
// rounded to nearest); grid: outputs x the column blocks
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename T, int GROUPS>
__global__ void __launch_bounds__(kSumCols * GROUPS)
col_sum_kernel(const float* __restrict__ partials, int blocks, int N, T* out0, T* out1) {
    __shared__ float s_sum[GROUPS][kSumCols];
    const int col_blocks = (N + kSumCols - 1) / kSumCols;
    const int k = blockIdx.x / col_blocks;  // the output: 0 or 1
    const int c = blockIdx.x % col_blocks * kSumCols + threadIdx.x;
    const int j = threadIdx.y;
    float acc = 0.0f;
    if (c < N) {
        const float* p = partials + static_cast<long long>(k) * blocks * N + c;
        for (int b = j; b < blocks; b += GROUPS) acc += p[static_cast<long long>(b) * N];
    }
    s_sum[j][threadIdx.x] = acc;
    __syncthreads();
    if (j == 0 && c < N) {
        float total = 0.0f;
#pragma unroll
        for (int v = 0; v < GROUPS; ++v) total += s_sum[v][threadIdx.x];
        store_as((k == 0 ? out0 : out1) + c, total);
    }
}

template <typename T, int GROUPS = kSumGroups>
cudaError_t launch_col_sum(const float* partials, int outputs, int blocks, int N, T* out0,
                           T* out1, cudaStream_t stream) {
    const int col_blocks = (N + kSumCols - 1) / kSumCols;
    col_sum_kernel<T, GROUPS><<<outputs * col_blocks, dim3(kSumCols, GROUPS), 0, stream>>>(
        partials, blocks, N, out0, out1);
    return cudaGetLastError();
}

}  // namespace
