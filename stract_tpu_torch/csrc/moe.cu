// Hand-written Hopper kernels of the MoE FFN (stract_tpu/models/bert.py:108-153
// MoEMlp): K15a the router and its backward, K15b the select-and-scale and
// its backward. Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// into a plain C library bound with ctypes. Every entry point launches on the
// caller's stream, allocates nothing, and returns the CUDA status.
//
// K15a stract_moe_router replaces the router of MoEMlp (bert.py:124-130):
//     f32 logits = x.f32 . Wr + br over E <= 16 experts, softmax, argmax with
//     ties to the first expert (jnp.argmax), and the gate probs[top] rounded
//     to bf16.
// stract_moe_router_backward: the router's whole VJP, what jax.vjp gives
//     through it: the gate's cotangent lands on probs[top] alone; the softmax
//     VJP (dl = y*g - y*sum(y*g), jax.nn.softmax's jvp transposed) gives the
//     logits' cotangent dl, which stays on the chip; then dx = bf16(dl . Wr),
//     the cotangent of the x -> f32 cast, and the parameter gradients dWr =
//     dl^T . x.f32 and dbr = sum_n dl, f32 sums in a fixed order.
// K15b stract_moe_select replaces bert.py:152-153: out = bf16(out_e[top[n],
//     n] * gate[n]), the one-hot combine (exact) and the gate's product (a
//     product of two bf16 values is exact in f32: one rounding).
// stract_moe_select_backward: the expert rows' cotangent, bf16(g * gate) in
//     the chosen expert's row and zeros in the others (the dense [E, N, H]
//     tensor the experts' cuBLAS products consume), and the gate's, the f32
//     row sum of out_sel * g (exact products) rounded to bf16.
//
// What bounds them: device memory. At the MoE step's shape (N = 4,096 tokens,
// H = 384, E = 4) the router's VJP moves 9.6 MB (x read by both passes, dx
// written; 0.0029 ms at 3.35 TB/s) for ~38 M f32 operations, the select's
// pair 25 MB (0.0075 ms), 12.6 MB of it the dense cotangent.
// The design:
//   - the expert count is a template bound EB (4 or 16) with a predicate
//     for the E below it, so every loop over experts unrolls and indexes its
//     registers with constants (no stack frame; a bucket of 8 made ptxas
//     spill a register at 48);
//   - x, the expert rows, dx, g and d_out move in 16-byte pieces (8 bf16)
//     where H % 8 == 0 and the pointers allow, else as single elements;
//   - Wr is staged in shared memory once a block (up to kStageMax bytes: E
//     x H x 4 is 6 KB at the step's shape, 64 KB at E = 16, H = 1,024; past
//     it read through L1), laid out so that a warp's lanes read consecutive
//     16 bytes (Wr's rows give each lane's piece a 32-byte stride);
//   - the router's forward and both select kernels give each token a group
//     of G lanes, the fewest (a power of two, at most a warp) that leave a
//     lane at most kChunk pieces (16 lanes of 3 pieces at H = 384); a lane
//     loads its pieces at once (the router's first ones before Wr is
//     staged), so a token costs one trip to device memory; a group's sums (the E dot
//     products, the gate's cotangent) are each lane's in column order, then
//     a butterfly of shuffles; br is read once a thread;
//   - the router's backward gives each thread one piece (a column tile of
//     256 pieces a block, gridDim.y tiles) and a fixed set of tokens: the
//     block's contiguous share of N, kBwdBatch at a time, whose dl a thread
//     a token computes into shared memory, and a thread's tokens in chunks
//     of kTok whose x pieces it loads at once (the first chunk while dl is
//     computed). A thread keeps its piece's dWr partials (EB x 8 f32) in
//     registers; the block sums its token lanes' partials in order (a
//     thread's 8 in shared memory at a stride of 9 words: no bank conflicts)
//     into partials [blocks][E*H + E] (dbr in the last E columns), and the
//     column sum (col_sum.cuh, K14b's, over 32 groups of blocks) sums the
//     blocks in order: no atomics,
//     so two calls give the same bits, and no part of the grid depends on
//     the card;
//   - the select's backward writes the chosen expert's row first, then the
//     zero rows one after another;
//   - fixed grids of at most kBlocks blocks stride over the tokens.
//
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions. The dot products (the
// logits, dx, dWr) take fused multiply-adds (__fmaf_rn) on purpose: the
// plain versions compute them as cuBLAS products, in another order anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "col_sum.cuh"

namespace {

constexpr int kMaxE = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 264;    // a grid's most blocks: two for each of the H100's 132 SMs
constexpr int kChunk = 3;       // pieces a lane loads at once (their loads in flight together)
constexpr int kBwdBatch = 64;   // tokens whose dl a backward block stages at a time
constexpr int kStageMax = 64 * 1024;  // Wr staged in shared memory up to E x H x 4 bytes
constexpr int kRound = 4;       // experts a round of the backward block's partial sums
constexpr int kSumGroupsMoE = 32;  // the column sum's groups of blocks (32 x 32 threads)

// log2 of a token's lanes: the fewest (a power of two, at most 32) that
// leave a lane at most kChunk of the row's units
__host__ int group_log2(int units) {
    int lg = 0;
    while (lg < 5 && (kChunk << lg) < units) ++lg;
    return lg;
}

__host__ bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ void unpack8(const uint4& b, float (&v)[8]) {
    const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// the W columns of Wr's row e from column 8p (W = 8) or p (W = 1)
template <int W>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int e, int H, int p,
                                       float (&v)[W]) {
    if constexpr (W == 8) {
        const float4* r = reinterpret_cast<const float4*>(w + static_cast<long long>(e) * H) + 2 * p;
        const float4 lo = __ldg(r), hi = __ldg(r + 1);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
        v[0] = __ldg(w + static_cast<long long>(e) * H + p);
    }
}

// Wr staged in shared memory. W = 8: the float4 (e, half, piece) at
// (2e + half) * C + piece (C = H / 8 pieces), so a warp's lanes, on
// consecutive pieces, read consecutive 16 bytes; W = 1: row-major
template <int W>
__device__ __forceinline__ void stage_w(const float* __restrict__ w, int E, int H, float* s) {
    if constexpr (W == 8) {
        const int q4 = H / 4, C = H / 8;
        float4* s4 = reinterpret_cast<float4*>(s);
        const float4* w4 = reinterpret_cast<const float4*>(w);
        for (int i = threadIdx.x; i < E * q4; i += blockDim.x) {
            const int e = i / q4, q = i - e * q4;
            s4[(2 * e + (q & 1)) * C + (q >> 1)] = __ldg(w4 + i);
        }
    } else {
        for (int i = threadIdx.x; i < E * H; i += blockDim.x) s[i] = __ldg(w + i);
    }
}

template <int W>
__device__ __forceinline__ void load_ws(const float* s, int e, int H, int p, float (&v)[W]) {
    if constexpr (W == 8) {
        const int C = H / 8;
        const float4 lo = reinterpret_cast<const float4*>(s)[2 * e * C + p];
        const float4 hi = reinterpret_cast<const float4*>(s)[(2 * e + 1) * C + p];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
        v[0] = s[e * H + p];
    }
}

// Wr's W columns from piece p: staged (SW) or through L1
template <int W, bool SW>
__device__ __forceinline__ void wr_piece(const float* __restrict__ w, const float* s, int e, int H,
                                         int p, float (&v)[W]) {
    if constexpr (SW)
        load_ws<W>(s, e, H, p, v);
    else
        load_w<W>(w, e, H, p, v);
}

// piece p of a bf16 row as W floats
template <int W>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, int p, float (&v)[W]) {
    if constexpr (W == 8) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(row) + p), v);
    } else {
        v[0] = __bfloat162float(row[p]);
    }
}

template <int W>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, int p, const float (&v)[W]) {
    if constexpr (W == 8) {
        reinterpret_cast<uint4*>(row)[p] = pack8(v);
    } else {
        row[p] = __float2bfloat16_rn(v[0]);
    }
}

// the tokens of a group: lg = log2 of its lanes. The loop's bound is the
// warp's first token, so a warp's lanes run its iterations together (the
// shuffles need all 32); `n` may pass N in the last one.
#define FOR_GROUP_TOKENS(N, lg)                                                              \
    const int lane = threadIdx.x & 31, gl = lane & ((1 << (lg)) - 1), slot = lane >> (lg);   \
    const long long per_warp = 32 >> (lg);                                                   \
    const long long stride = static_cast<long long>(gridDim.x) * kWarps * per_warp;          \
    for (long long first = (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) * \
                           per_warp,                                                         \
                   n = first + slot;                                                         \
         first < (N); first += stride, n += stride)

// K15a forward: a group of 1 << lg lanes a token; a lane's pieces gl, gl +
// G, ... in chunks of kChunk, each chunk's loads issued before its products;
// with Wr staged (SW), the first chunk's loads issued before the staging
template <int EB, bool VEC, bool SW>
__global__ void __launch_bounds__(kThreads)
router_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, int N, int H, int E, int lg,
              float* __restrict__ probs, int* __restrict__ top, __nv_bfloat16* __restrict__ gate) {
    constexpr int W = VEC ? 8 : 1;
    // pieces loaded at once: kChunk, or one where Wr comes through L1 (its
    // 16 experts' loads beside three pieces made ptxas spill)
    constexpr int kCh = SW ? kChunk : 1;
    extern __shared__ float4 s_dyn[];
    const float* s_w = reinterpret_cast<const float*>(s_dyn);
    const int units = H / W, G = 1 << lg;
    float b[EB];
#pragma unroll
    for (int e = 0; e < EB; ++e) b[e] = e < E ? __ldg(bias + e) : 0.0f;
    const bool vec_probs = E % 4 == 0 && reinterpret_cast<uintptr_t>(probs) % 16 == 0;
    float xv[kCh][W];
    if constexpr (SW) {
        const int gl0 = threadIdx.x & (G - 1);
        const long long n = ((static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
                             (32 >> lg)) + ((threadIdx.x & 31) >> lg);
#pragma unroll
        for (int k = 0; k < kCh; ++k)
            if (n < N && gl0 + k * G < units) load_row<W>(x + n * H, gl0 + k * G, xv[k]);
        stage_w<W>(w, E, H, reinterpret_cast<float*>(s_dyn));
        __syncthreads();
    }
    bool loaded = SW;  // the first chunk of the first token is in xv
    FOR_GROUP_TOKENS(N, lg) {
        const bool valid = n < N;
        float acc[EB];
#pragma unroll
        for (int e = 0; e < EB; ++e) acc[e] = 0.0f;
        if (valid) {
            const __nv_bfloat16* xr = x + n * H;
            for (int p0 = gl; p0 < units; p0 += kCh * G) {
                if (!loaded) {
#pragma unroll
                    for (int k = 0; k < kCh; ++k)
                        if (p0 + k * G < units) load_row<W>(xr, p0 + k * G, xv[k]);
                }
                loaded = false;
#pragma unroll
                for (int k = 0; k < kCh; ++k) {
                    const int p = p0 + k * G;
                    if (p < units) {
#pragma unroll
                        for (int e = 0; e < EB; ++e) {
                            if (e < E) {
                                float wv[W];
                                wr_piece<W, SW>(w, s_w, e, H, p, wv);
#pragma unroll
                                for (int j = 0; j < W; ++j)
                                    acc[e] = __fmaf_rn(xv[k][j], wv[j], acc[e]);
                            }
                        }
                    }
                }
            }
        }
        loaded = false;
        for (int o = G >> 1; o > 0; o >>= 1) {
#pragma unroll
            for (int e = 0; e < EB; ++e)
                if (e < E) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        }
        if (valid && gl == 0) {
            float l[EB], mx = -INFINITY;
#pragma unroll
            for (int e = 0; e < EB; ++e) {
                l[e] = 0.0f;
                if (e < E) {
                    l[e] = acc[e] + b[e];
                    mx = fmaxf(mx, l[e]);
                }
            }
            float sum = 0.0f;
#pragma unroll
            for (int e = 0; e < EB; ++e) {
                if (e < E) {
                    l[e] = expf(l[e] - mx);
                    sum += l[e];
                }
            }
            // the running (value, index) pair: strictly greater, ascending e,
            // so ties stay with the first expert
            float best = 0.0f;
            int t = 0;
#pragma unroll
            for (int e = 0; e < EB; ++e) {
                if (e < E) {
                    l[e] = l[e] / sum;
                    if (e == 0 || l[e] > best) {
                        best = l[e];
                        t = e;
                    }
                }
            }
            float* pr = probs + n * E;
            if (vec_probs) {
#pragma unroll
                for (int q = 0; q < EB / 4; ++q)
                    if (4 * q < E)
                        reinterpret_cast<float4*>(pr)[q] =
                            make_float4(l[4 * q], l[4 * q + 1], l[4 * q + 2], l[4 * q + 3]);
            } else {
#pragma unroll
                for (int e = 0; e < EB; ++e)
                    if (e < E) pr[e] = l[e];
            }
            top[n] = t;
            gate[n] = __float2bfloat16_rn(best);
        }
    }
}

// K15a backward: thread (r, c) of a block takes piece c0 + c of its column
// tile for the block's tokens r, r + R, ... of each batch of kBwdBatch, in
// chunks of kTok whose x pieces it loads at once (the first chunk's while
// Wr is staged (SW) and a thread a token computes the batch's dl into
// shared memory); Wr's piece is read once an expert a chunk
template <int EB, bool VEC, bool SW>
__global__ void __launch_bounds__(kThreads, EB <= 4 ? 2 : 1)
router_bwd_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ probs,
                  const int* __restrict__ top, const __nv_bfloat16* __restrict__ dgate,
                  const float* __restrict__ w, int N, int H, int E,
                  __nv_bfloat16* __restrict__ dx, float* __restrict__ partials) {
    constexpr int W = VEC ? 8 : 1;
    constexpr int kTok = EB <= 4 ? 4 : 2;  // registers: kTok x W of x and of dx a thread
    constexpr int kPad = W > 1 ? W + 1 : 1;  // a thread's partials' stride: no bank conflicts
    extern __shared__ float4 s_dyn[];
    const float* s_w = reinterpret_cast<const float*>(s_dyn);
    __shared__ float s_dl[kBwdBatch][EB];
    __shared__ float s_red[kRound][kThreads * kPad];
    __shared__ float s_bias[kRound][kThreads];
    const int units = H / W;
    const int c0 = blockIdx.y * kThreads;
    const int cb = min(kThreads, units - c0);
    const int R = kThreads / cb;  // token lanes
    const int r = threadIdx.x / cb, cl = threadIdx.x - r * cb, c = c0 + cl;
    const bool active = r < R;
    const bool bias_lane = active && blockIdx.y == 0 && cl == 0;
    const long long per_block = (N + gridDim.x - 1) / gridDim.x;
    const long long n0 = blockIdx.x * per_block;
    const long long n1 = min(static_cast<long long>(N), n0 + per_block);

    float part[EB][W], pb[EB];
#pragma unroll
    for (int e = 0; e < EB; ++e) {
        pb[e] = 0.0f;
#pragma unroll
        for (int j = 0; j < W; ++j) part[e][j] = 0.0f;
    }
    bool staged = !SW;
    for (long long s0 = n0; s0 < n1; s0 += kBwdBatch) {
        const int nb = static_cast<int>(min(static_cast<long long>(kBwdBatch), n1 - s0));
        float xv[kTok][W];
        if (active) {
#pragma unroll
            for (int k = 0; k < kTok; ++k)
                if (r + k * R < nb) load_row<W>(x + (s0 + r + k * R) * H, c, xv[k]);
        }
        if (!staged) {
            stage_w<W>(w, E, H, reinterpret_cast<float*>(s_dyn));
            staged = true;
        }
        if (threadIdx.x < nb) {
            // dw = y * g is y[t] * dgate at the top expert t and 0 elsewhere;
            // dl = dw + y * (-sum dw), as the plain version computes it
            const long long n = s0 + threadIdx.x;
            const int t = __ldg(top + n);
            const float g = __bfloat162float(dgate[n]);
            float y[EB], yt = 0.0f;
#pragma unroll
            for (int e = 0; e < EB; ++e) {
                y[e] = e < E ? __ldg(probs + n * E + e) : 0.0f;
                if (e == t) yt = y[e];
            }
            const float s = yt * g;
#pragma unroll
            for (int e = 0; e < EB; ++e)
                s_dl[threadIdx.x][e] = e < E ? (e == t ? s : 0.0f) + y[e] * (-s) : 0.0f;
        }
        __syncthreads();
        if (active) {
            for (int i0 = r; i0 < nb; i0 += kTok * R) {
                if (i0 != r) {
#pragma unroll
                    for (int k = 0; k < kTok; ++k)
                        if (i0 + k * R < nb) load_row<W>(x + (s0 + i0 + k * R) * H, c, xv[k]);
                }
                float d[kTok][W];
#pragma unroll
                for (int k = 0; k < kTok; ++k)
#pragma unroll
                    for (int j = 0; j < W; ++j) d[k][j] = 0.0f;
#pragma unroll
                for (int e = 0; e < EB; ++e) {
                    if (e < E) {
                        float wv[W];
                        wr_piece<W, SW>(w, s_w, e, H, c, wv);
#pragma unroll
                        for (int k = 0; k < kTok; ++k) {
                            const int i = i0 + k * R;
                            if (i < nb) {
                                const float dl = s_dl[i][e];
#pragma unroll
                                for (int j = 0; j < W; ++j) {
                                    d[k][j] = __fmaf_rn(dl, wv[j], d[k][j]);
                                    part[e][j] = __fmaf_rn(dl, xv[k][j], part[e][j]);
                                }
                                if (bias_lane) pb[e] += dl;
                            }
                        }
                    }
                }
#pragma unroll
                for (int k = 0; k < kTok; ++k)
                    if (i0 + k * R < nb) store_row<W>(dx + (s0 + i0 + k * R) * H, c, d[k]);
            }
        }
        __syncthreads();
    }
    // the block's partials, kRound experts at a time: its token lanes'
    // summed in lane order (dbr's from column tile 0's first piece)
    const long long cols = static_cast<long long>(E) * H + E;
    float* out = partials + blockIdx.x * cols;
    const int span = cb * W;  // a tile's columns
#pragma unroll
    for (int e0 = 0; e0 < EB; e0 += kRound) {
        if (e0 < E) {
            if (active) {
#pragma unroll
                for (int u = 0; u < kRound; ++u) {
                    if (e0 + u < E) {
#pragma unroll
                        for (int j = 0; j < W; ++j)
                            s_red[u][(r * cb + cl) * kPad + j] = part[e0 + u][j];
                        if (bias_lane) s_bias[u][r] = pb[e0 + u];
                    }
                }
            }
            __syncthreads();
            const int ne = min(kRound, E - e0);
            for (int k = threadIdx.x; k < ne * span; k += kThreads) {
                const int u = k / span, col = k - u * span;
                const int at = (col / W) * kPad + col % W;
                float acc = 0.0f;
                for (int q = 0; q < R; ++q) acc += s_red[u][q * cb * kPad + at];
                out[static_cast<long long>(e0 + u) * H + static_cast<long long>(c0) * W + col] = acc;
            }
            if (blockIdx.y == 0 && threadIdx.x < ne) {
                float acc = 0.0f;
                for (int q = 0; q < R; ++q) acc += s_bias[threadIdx.x][q];
                out[static_cast<long long>(E) * H + e0 + threadIdx.x] = acc;
            }
            __syncthreads();
        }
    }
}

// K15b forward: a group of 1 << lg lanes a token, kChunk pieces' loads at once
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
select_kernel(const __nv_bfloat16* __restrict__ out_e, const int* __restrict__ top,
              const __nv_bfloat16* __restrict__ gate, int N, int H, int lg,
              __nv_bfloat16* __restrict__ out) {
    constexpr int W = VEC ? 8 : 1;
    const int units = H / W, G = 1 << lg;
    FOR_GROUP_TOKENS(N, lg) {
        if (n >= N) continue;
        const long long t = __ldg(top + n);
        const float gv = __bfloat162float(gate[n]);
        const __nv_bfloat16* sel = out_e + (t * N + n) * H;
        for (int p0 = gl; p0 < units; p0 += kChunk * G) {
            float v[kChunk][W];
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
                if (p0 + k * G < units) load_row<W>(sel, p0 + k * G, v[k]);
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                if (p0 + k * G < units) {
#pragma unroll
                    for (int j = 0; j < W; ++j) v[k][j] *= gv;
                    store_row<W>(out + n * H, p0 + k * G, v[k]);
                }
            }
        }
    }
}

// K15b backward: a group of 1 << lg lanes a token writes the chosen expert's
// row of d_out (kChunk pieces' loads at once) and the gate's cotangent, then
// zeros into the other experts' rows, a row at a time
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
select_bwd_kernel(const __nv_bfloat16* __restrict__ out_e, const int* __restrict__ top,
                  const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ g,
                  int E, int N, int H, int lg, __nv_bfloat16* __restrict__ d_out,
                  __nv_bfloat16* __restrict__ d_gate) {
    constexpr int W = VEC ? 8 : 1;
    const int units = H / W, G = 1 << lg;
    FOR_GROUP_TOKENS(N, lg) {
        const bool valid = n < N;
        float acc = 0.0f;
        int t = 0;
        if (valid) {
            t = __ldg(top + n);
            const float gv = __bfloat162float(gate[n]);
            const __nv_bfloat16* sel = out_e + (static_cast<long long>(t) * N + n) * H;
            __nv_bfloat16* chosen = d_out + (static_cast<long long>(t) * N + n) * H;
            for (int p0 = gl; p0 < units; p0 += kChunk * G) {
                float gg[kChunk][W], sv[kChunk][W];
#pragma unroll
                for (int k = 0; k < kChunk; ++k) {
                    if (p0 + k * G < units) {
                        load_row<W>(g + n * H, p0 + k * G, gg[k]);
                        load_row<W>(sel, p0 + k * G, sv[k]);
                    }
                }
#pragma unroll
                for (int k = 0; k < kChunk; ++k) {
                    if (p0 + k * G < units) {
                        float d[W];
#pragma unroll
                        for (int j = 0; j < W; ++j) {
                            d[j] = gg[k][j] * gv;
                            acc += sv[k][j] * gg[k][j];
                        }
                        store_row<W>(chosen, p0 + k * G, d);
                    }
                }
            }
        }
        for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (!valid) continue;
        if (gl == 0) d_gate[n] = __float2bfloat16_rn(acc);
        float zero[W];
#pragma unroll
        for (int j = 0; j < W; ++j) zero[j] = 0.0f;
        for (int e = 0; e < E; ++e) {
            if (e == t) continue;
            __nv_bfloat16* row = d_out + (static_cast<long long>(e) * N + n) * H;
            for (int p = gl; p < units; p += G) store_row<W>(row, p, zero);
        }
    }
}

// the blocks of a fixed grid of groups of 1 << lg lanes over N tokens
int grid_for(int N, int lg) {
    const long long per_block = static_cast<long long>(kWarps) * (32 >> lg);
    const long long blocks = (N + per_block - 1) / per_block;
    return static_cast<int>(blocks < kBlocks ? blocks : kBlocks);
}

// Wr staged in dynamic shared memory up to kStageMax bytes, else read
// through L1; the kernel's opt-in to the staged bytes (past 48 KB with its
// static arrays) set on the current card before each such launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
    if (bytes == 0) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int EB, bool VEC, bool SW>
cudaError_t launch_router_as(const __nv_bfloat16* x, const float* w, const float* bias, int N,
                             int H, int E, float* probs, int* top, __nv_bfloat16* gate,
                             cudaStream_t stream) {
    const int lg = group_log2(VEC ? H / 8 : H);
    const int smem = SW ? E * H * 4 : 0;
    const cudaError_t err = allow_smem(router_kernel<EB, VEC, SW>, smem);
    if (err != cudaSuccess) return err;
    router_kernel<EB, VEC, SW><<<grid_for(N, lg), kThreads, smem, stream>>>(
        x, w, bias, N, H, E, lg, probs, top, gate);
    return cudaGetLastError();
}

template <int EB>
cudaError_t launch_router(const __nv_bfloat16* x, const float* w, const float* bias, int N,
                          int H, int E, float* probs, int* top, __nv_bfloat16* gate,
                          cudaStream_t stream) {
    const bool vec = H % 8 == 0 && aligned16(x) && aligned16(w);
    const bool sw = static_cast<long long>(E) * H * 4 <= kStageMax;
    if (vec)
        return sw ? launch_router_as<EB, true, true>(x, w, bias, N, H, E, probs, top, gate, stream)
                  : launch_router_as<EB, true, false>(x, w, bias, N, H, E, probs, top, gate,
                                                      stream);
    return sw ? launch_router_as<EB, false, true>(x, w, bias, N, H, E, probs, top, gate, stream)
              : launch_router_as<EB, false, false>(x, w, bias, N, H, E, probs, top, gate, stream);
}

template <int EB, bool VEC, bool SW>
cudaError_t launch_router_bwd_as(const __nv_bfloat16* x, const float* probs, const int* top,
                                 const __nv_bfloat16* dgate, const float* w, int N, int H, int E,
                                 int blocks, __nv_bfloat16* dx, float* partials,
                                 cudaStream_t stream) {
    const int units = VEC ? H / 8 : H;
    const dim3 grid(blocks, (units + kThreads - 1) / kThreads);
    const int smem = SW ? E * H * 4 : 0;
    const cudaError_t err = allow_smem(router_bwd_kernel<EB, VEC, SW>, smem);
    if (err != cudaSuccess) return err;
    router_bwd_kernel<EB, VEC, SW><<<grid, kThreads, smem, stream>>>(x, probs, top, dgate, w, N,
                                                                     H, E, dx, partials);
    return cudaGetLastError();
}

template <int EB>
cudaError_t launch_router_bwd(const __nv_bfloat16* x, const float* probs, const int* top,
                              const __nv_bfloat16* dgate, const float* w, int N, int H, int E,
                              int blocks, __nv_bfloat16* dx, float* partials,
                              cudaStream_t stream) {
    const bool vec = H % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(dx);
    const bool sw = static_cast<long long>(E) * H * 4 <= kStageMax;
    if (vec)
        return sw ? launch_router_bwd_as<EB, true, true>(x, probs, top, dgate, w, N, H, E, blocks,
                                                         dx, partials, stream)
                  : launch_router_bwd_as<EB, true, false>(x, probs, top, dgate, w, N, H, E,
                                                          blocks, dx, partials, stream);
    return sw ? launch_router_bwd_as<EB, false, true>(x, probs, top, dgate, w, N, H, E, blocks,
                                                      dx, partials, stream)
              : launch_router_bwd_as<EB, false, false>(x, probs, top, dgate, w, N, H, E, blocks,
                                                       dx, partials, stream);
}

}  // namespace

extern "C" {

// K15a. x bf16[N, H], w f32[E, H], bias f32[E] -> probs f32[N, E], top
// i32[N], gate bf16[N]; N, H >= 1, E in 1..16.
int stract_moe_router(const void* x, const float* w, const float* bias, int N, int H, int E,
                      float* probs, int* top, void* gate, cudaStream_t stream) {
    if (N < 1 || H < 1 || E < 1 || E > kMaxE) return static_cast<int>(cudaErrorInvalidValue);
    const auto* xx = static_cast<const __nv_bfloat16*>(x);
    auto* gg = static_cast<__nv_bfloat16*>(gate);
    const cudaError_t err = E <= 4
                                ? launch_router<4>(xx, w, bias, N, H, E, probs, top, gg, stream)
                                : launch_router<16>(xx, w, bias, N, H, E, probs, top, gg, stream);
    return static_cast<int>(err);
}

// K15a backward. x bf16[N, H], probs f32[N, E], top i32[N], dgate bf16[N],
// w f32[E, H] -> dx bf16[N, H]; out f32 holds dWr [E, H], then dbr [E], then
// the partials [blocks][E*H + E] of the fixed grid (blocks 1..65535, the
// caller's: ops/kernels.py). Two launches on the stream.
int stract_moe_router_backward(const void* x, const float* probs, const int* top,
                               const void* dgate, const float* w, int N, int H, int E,
                               int blocks, void* dx, float* out, cudaStream_t stream) {
    if (N < 1 || H < 1 || E < 1 || E > kMaxE || blocks < 1 || blocks > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* xx = static_cast<const __nv_bfloat16*>(x);
    const auto* dg = static_cast<const __nv_bfloat16*>(dgate);
    auto* d = static_cast<__nv_bfloat16*>(dx);
    const long long cols = static_cast<long long>(E) * H + E;
    if (cols > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    float* partials = out + cols;
    const cudaError_t err =
        E <= 4 ? launch_router_bwd<4>(xx, probs, top, dg, w, N, H, E, blocks, d, partials, stream)
               : launch_router_bwd<16>(xx, probs, top, dg, w, N, H, E, blocks, d, partials,
                                       stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_col_sum<float, kSumGroupsMoE>(
        partials, 1, blocks, static_cast<int>(cols), out, out, stream));
}

// K15b. out_e bf16[E, N, H], top i32[N] (each in 0..E-1), gate bf16[N] ->
// out bf16[N, H]; N, H >= 1.
int stract_moe_select(const void* out_e, const int* top, const void* gate, int N, int H,
                      void* out, cudaStream_t stream) {
    if (N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto* oe = static_cast<const __nv_bfloat16*>(out_e);
    const auto* ga = static_cast<const __nv_bfloat16*>(gate);
    auto* o = static_cast<__nv_bfloat16*>(out);
    const bool vec = H % 8 == 0 && aligned16(out_e) && aligned16(out);
    const int lg = group_log2(vec ? H / 8 : H);
    if (vec)
        select_kernel<true><<<grid_for(N, lg), kThreads, 0, stream>>>(oe, top, ga, N, H, lg, o);
    else
        select_kernel<false><<<grid_for(N, lg), kThreads, 0, stream>>>(oe, top, ga, N, H, lg, o);
    return static_cast<int>(cudaGetLastError());
}

// K15b backward. out_e bf16[E, N, H], top i32[N], gate bf16[N], g bf16[N, H]
// -> d_out bf16[E, N, H], d_gate bf16[N]; N, H, E >= 1.
int stract_moe_select_backward(const void* out_e, const int* top, const void* gate,
                               const void* g, int E, int N, int H, void* d_out, void* d_gate,
                               cudaStream_t stream) {
    if (N < 1 || H < 1 || E < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto* oe = static_cast<const __nv_bfloat16*>(out_e);
    const auto* ga = static_cast<const __nv_bfloat16*>(gate);
    const auto* gg = static_cast<const __nv_bfloat16*>(g);
    auto* d = static_cast<__nv_bfloat16*>(d_out);
    auto* dgt = static_cast<__nv_bfloat16*>(d_gate);
    const bool vec = H % 8 == 0 && aligned16(out_e) && aligned16(g) && aligned16(d_out);
    const int lg = group_log2(vec ? H / 8 : H);
    if (vec)
        select_bwd_kernel<true><<<grid_for(N, lg), kThreads, 0, stream>>>(oe, top, ga, gg, E, N,
                                                                          H, lg, d, dgt);
    else
        select_bwd_kernel<false><<<grid_for(N, lg), kThreads, 0, stream>>>(oe, top, ga, gg, E,
                                                                           N, H, lg, d, dgt);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
