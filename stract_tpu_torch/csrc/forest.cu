// K4: the LambdaMART forest walk on Hopper (sm_90a).
//
// Replaces stract_tpu/ranking/models/lambdamart.py:195 _gbdt_forward, the
// jitted XLA program that advances a [trees, rows] matrix of node indices one
// level per fori_loop step with gathers, then sums one leaf value per tree.
//
// What bounds it: nothing heavy. A forest of T = 40 depth-3 trees is 40 x 7
// nodes; a row's work is T walks of max_depth dependent steps and one read
// of its 46 features, so the kernel is latency-bound on the dependent steps
// and, at the serving sizes (K = 256 to 16,384 rows), on the launch itself.
// The design shortens the chain: a block takes a tile of `rows` rows, stages
// their features in shared memory with coalesced 16-byte loads (each row at
// a stride of F + 1 floats, odd where F is even, so that lanes on
// neighbouring rows read distinct banks), and the forest a chunk of `chunk`
// trees at a time, a node as one 16-byte word (feature, threshold, left,
// right); a thread then walks one (row, tree) pair of the chunk at a time,
// lanes on neighbouring rows of one tree, so a thread's chain is max_depth
// steps, not T x max_depth, and writes the leaf value to shared memory; then
// one thread a row adds the chunk's T' leaf values to the row's running f32
// sum in order t = 0 .. T - 1, the reference's order, so the output is the
// same bits as a tree-order f32 loop for any chunking. ops/kernels.py
// forest_plan sizes the tile and the chunk: a forest that fits shared
// memory beside the tile is one chunk (the repo's 40-tree forests: K = 256
// over 32 blocks; K = 16,384 in 512, one wave); a larger one (LightGBM's
// 500 trees of 31 leaves, 302 KB of nodes and leaves) is walked in chunks
// of a quarter or half of a block's shared memory, so several blocks share
// an SM and some stage while others walk, with tiles of up to 64 rows
// (about one block an SM), since every block stages the whole forest once
// from L2 (0.1055 ms at K = 16,384 on the H100 in quarters, 0.184 in
// halves; 1,000 trees of 255 leaves 0.438 in halves, 0.570 in quarters). A
// single tree too large for shared memory on its own (N past ~11,000
// nodes), or rows too wide for one, takes the global form: nodes, leaves
// and features read where they lie, through L1 and L2, only the chunk's
// leaf values in shared memory.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Node {
    int feature;
    float threshold;
    int left;
    int right;
};

// Dynamic shared memory, STAGED: a chunk's nodes [chunk * N] and leaves
// [chunk * L], the tile's features [rows][stride] and the chunk's leaf
// values [chunk][rows]; else the leaf values alone. rows <= kThreads.
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
forest_kernel(const int* __restrict__ feature, const float* __restrict__ threshold,
              const int* __restrict__ left, const int* __restrict__ right,
              const float* __restrict__ leaf_value, const float* __restrict__ x,
              float* __restrict__ out, int T, int N, int L, int K, int F, int max_depth, int rows,
              int stride, int chunk) {
    extern __shared__ __align__(16) unsigned char smem[];
    Node* s_node = reinterpret_cast<Node*>(smem);
    float* s_leaf = reinterpret_cast<float*>(s_node + (STAGED ? chunk * N : 0));
    float* s_x = s_leaf + (STAGED ? chunk * L : 0);
    float* s_val = s_x + (STAGED ? rows * stride : 0);
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * rows, n = min(rows, K - row0);
    if (STAGED) {
        // the tile's features: the flat range [row0 F, row0 F + n F), its
        // aligned body in 16-byte pieces, each value placed at its row's
        // padded stride
        const long long a = (long long)row0 * F, e = a + (long long)n * F;
        auto place = [&](long long i, float v) {
            const int rel = (int)(i - a), r = rel / F;
            s_x[r * stride + rel - r * F] = v;
        };
        long long b = (a + 3) & ~3ll;  // the first element on a 16-byte boundary
        if ((reinterpret_cast<uintptr_t>(x) & 15) != 0) b = e;  // x misaligned: no pieces
        const long long head = b < e ? b : e;
        for (long long i = a + tid; i < head; i += kThreads) place(i, x[i]);
        const long long pieces = head < e ? (e - head) / 4 : 0;
        const float4* x4 = reinterpret_cast<const float4*>(x + head);
        for (long long pc = tid; pc < pieces; pc += kThreads) {
            const float4 v = x4[pc];
            const long long i = head + 4 * pc;
            place(i, v.x);
            place(i + 1, v.y);
            place(i + 2, v.z);
            place(i + 3, v.w);
        }
        for (long long i = head + 4 * pieces + tid; i < e; i += kThreads) place(i, x[i]);
    }

    float acc = 0.0f;  // row tid's running sum, trees in order
    for (int t0 = 0; t0 < T; t0 += chunk) {
        const int tc = min(chunk, T - t0);
        const long long node0 = (long long)t0 * N, leaf0 = (long long)t0 * L;
        if (STAGED) {
            for (int i = tid; i < tc * N; i += kThreads)
                s_node[i] = Node{feature[node0 + i], threshold[node0 + i], left[node0 + i],
                                 right[node0 + i]};
            for (int i = tid; i < tc * L; i += kThreads) s_leaf[i] = leaf_value[leaf0 + i];
        }
        __syncthreads();  // the chunk staged; the last chunk's values summed

        // a (row, tree) pair a thread at a time, lanes on neighbouring rows
        for (int pr = tid; pr < n * tc; pr += kThreads) {
            const int t = pr / n, r = pr - t * n;
            int cur = 0;
            for (int s = 0; s < max_depth && cur >= 0; ++s) {
                const int i = min(cur, N - 1);
                Node nd;
                float v;
                int f;
                if (STAGED) {
                    nd = s_node[t * N + i];
                } else {
                    const long long g = node0 + (long long)t * N + i;
                    nd = Node{__ldg(feature + g), __ldg(threshold + g), __ldg(left + g),
                              __ldg(right + g)};
                }
                f = nd.feature;
                if (f < 0) f += F;
                f = min(max(f, 0), F - 1);
                v = STAGED ? s_x[r * stride + f] : __ldg(x + (long long)(row0 + r) * F + f);
                cur = v <= nd.threshold ? nd.left : nd.right;
            }
            const int leaf = min(max(-cur - 1, 0), L - 1);
            s_val[t * rows + r] = STAGED ? s_leaf[t * L + leaf]
                                         : __ldg(leaf_value + leaf0 + (long long)t * L + leaf);
        }
        __syncthreads();
        if (tid < n)
            for (int t = 0; t < tc; ++t) acc += s_val[t * rows + tid];
    }
    if (tid < n) out[row0 + tid] = acc;
}

}  // namespace

extern "C" {

// feature/left/right i32[T, N], threshold f32[T, N], leaf_value f32[T, L],
// x f32[K, F] -> out f32[K]: `rows` rows a block (1 .. 256), the forest in
// chunks of `chunk` trees, staged in shared memory when `staged`, else read
// where it lies (ops/kernels.py forest_plan). Returns the CUDA status of the
// launch.
int stract_forest(const int* feature, const float* threshold, const int* left,
                  const int* right, const float* leaf_value, const float* x, float* out,
                  int T, int N, int L, int K, int F, int max_depth, int rows, int chunk,
                  int staged, cudaStream_t stream) {
    if (K <= 0) return cudaSuccess;
    if (T < 1 || N < 1 || L < 1 || F < 1 || rows < 1 || rows > kThreads || chunk < 1)
        return cudaErrorInvalidValue;
    chunk = chunk < T ? chunk : T;
    const int stride = F % 2 == 0 ? F + 1 : F;
    const long long smem =
        staged ? 16LL * chunk * N + 4LL * chunk * L + 4LL * rows * stride + 4LL * chunk * rows
               : 4LL * chunk * rows;
    const long long blocks = (K + rows - 1LL) / rows;
    if (smem > 227 * 1024 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    auto* kernel = staged ? forest_kernel<true> : forest_kernel<false>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
        feature, threshold, left, right, leaf_value, x, out, T, N, L, K, F, max_depth, rows,
        stride, chunk);
    return cudaGetLastError();
}

}  // extern "C"
