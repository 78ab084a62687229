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
// Both take T up to 512 and H up to 1,024 (the reference has no limit).
//
// What bounds it: every query row needs 2 T H multiply-adds for its scores
// and 2 T H for P.V (the backward five such products); at the smoke's
// shapes (T = 128, H = 384) that is ~64 flops per byte of q, k, v moved, so
// arithmetic binds: on the CUDA cores in f32 (K16b), on the tensor cores
// in 3xTF32 (K16a: three TF32 products a product, 0.0012 ms at mb = 8,
// T = 128, H = 384 over 495 TFLOP/s). The head width is a runtime argument
// (up to 1,024): one key row is 1.5 KB at H = 384, so K and V cannot be
// staged whole; they are staged in chunks.
//
// The forward (stage_attention_tc_kernel) on the tensor cores: one block of
// 16 warps per (tile of 16 query rows, batch row), mma.sync.m16n8k8 TF32
// products with f32 accumulators. Each f32 operand a is split as
// hi = tf32(a) (cvt.rna), lo = tf32(a - hi) (the difference is exact), and
// a.b is taken as lo.hi + hi.lo + hi.hi (lo.lo, ~2^-22 |a b|, left out):
// about 21 bits of each product against TF32's 10, so the kernel keeps the
// f32 twin's tolerance (rtol 1e-5, atol 1e-5 x max |out|), which TF32 alone
// misses by orders of magnitude (tests/test_torch_pipeline.py emulates both
// against f64). The tensor cores' f32 sums do not round to nearest: a chain
// of mma into one accumulator drifts (384 of them at H = 1,024 missed the
// tolerance on the H100 at T = 512), so each chain covers kTcGroup k-steps
// from zero and its part is added to the running sum in f32 (four chains a
// group, hi.hi apart from the small terms and even k-steps apart from odd,
// took 0.037 against 0.032 ms at mb = 8, T = 128, H = 384). mma.sync
// over wgmma: TF32 wgmma takes B only K-major, so P.V would need V
// transposed in shared memory; mma.sync's B fragment is loaded from
// registers, read from V as it is staged, and split in registers as it is
// loaded; an operand every warp reads (Q, P) is split once into TF32 hi and
// lo planes in shared memory. The steps:
//   1. S = Q.K^T / sqrt(H): for each chunk of 128 keys (each warp owns 8 of
//      them: one n8 tile), Q's 16 rows and the chunk's K rows are staged
//      64 columns of H at a time (f32, rows padded to 68 floats so a
//      fragment's 32 loads hit 32 banks; Q's slice then split into its
//      planes), and the chunk's scores, divided
//      by sqrt(H) (an IEEE division, as the twin divides), go to a [16, T]
//      score tile in shared memory;
//   2. the softmax of each row in place, one warp a row (max, exp, sum,
//      division by the sum: the twin's expressions), P written as its TF32
//      hi and lo planes (split once, not by every warp that reads it), keys
//      past T 0;
//   3. O = P.V: for each slice of 128 output columns (each warp owns 8: one
//      n8 tile), V is staged 64 keys at a time (rows padded to 136
//      floats) and P's A fragments are read from the two planes; the slice
//      is stored to out.
// Every staging is a round of cp.async copies into one of two buffers, the
// next round's copies in flight while this one computes (the first V
// slice's during the softmax): the grid has 64 blocks at the pipelined
// step's shapes, one an SM, so latency binds, and 16 warps an SM hide more
// of it than 8 (0.043 ms) or 4 warps with each round's loads waited for
// (0.061 ms) did on the H100. Shared memory: the score tile and P's lo
// plane (16 x (T rounded up to 128, + 4) floats each) and two staging
// buffers of 43,520 bytes; 153,088 bytes at T = 512 (the kernel opts in).
// No atomics: every output element has one writer.
//
// The backward (CUDA cores): kernel 1, per (tile of 8 query rows, batch
// row), recomputes the scores (K chunks of 32 keys, rows padded to an odd
// stride so a warp's 32 keys hit 32 banks) and dP = dO V^T (V chunks) as
// dot products, the softmax, D = rowsum(P dP) and dS; writes P and dS to
// scratch f32[mb, T, T] and dQ = dS K (each thread owns up to 4 of the H
// columns and walks the keys in order, the 8 rows' sums in registers).
// Kernel 2, per (tile of 8 key rows, batch row), stages its 8 columns of P
// and dS and walks the query rows: dK = dS^T Q and dV = P^T dO, 8 rows of
// each in registers. No atomics: every output element has one writer, so
// the result does not depend on scheduling. Tensor cores for the backward
// (3xTF32 as the forward) are later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 8;             // query (or key) rows per block
constexpr int kChunk = 32;           // keys per staged chunk
constexpr int kThreads = kRows * 32; // one warp per row of the tile
constexpr int kMaxT = 512;
constexpr int kMaxH = 1024;
constexpr int kCols = kMaxH / kThreads;  // output columns a thread owns, at most

__host__ __device__ inline int key_stride(int H) { return H | 1; }

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

// Softmax of one row of T scores in place, by one warp (the row's max and
// sum are not kept: the backward recomputes them).
__device__ void softmax_row(float* row, int T) {
    const int lane = threadIdx.x % 32;
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


// ---- K16a on the tensor cores ------------------------------------------------------
constexpr int kTcRows = 16;               // query rows a block: one mma tile
constexpr int kTcWarps = 16;             // a warp owns one n8 tile of keys, then of outputs
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcKeys = 128;              // keys of a staged chunk (scores)
constexpr int kTcCols = 64;               // columns of H of a staged Q and K slice
constexpr int kTcVKeys = 64;              // keys of a staged V slice
constexpr int kTcVCols = 128;             // columns of a staged V slice (outputs)
constexpr int kLdQK = kTcCols + 4;        // row stride of staged Q and K slices (floats)
constexpr int kLdV = kTcVCols + 8;        // row stride of a staged V slice
constexpr int kTcGroup = 4;               // k-steps summed in one accumulator chain
// floats of one staging buffer: a Q slice, a K slice and the Q slice's TF32
// lo plane, or a V slice
constexpr int kTcStage = (2 * kTcRows + kTcKeys) * kLdQK > kTcVKeys * kLdV
                             ? (2 * kTcRows + kTcKeys) * kLdQK : kTcVKeys * kLdV;

// the score tile's row stride: T rounded up to a chunk, + 4 (conflict-free A fragments)
__host__ __device__ inline int score_stride(int T) {
    return (T + kTcKeys - 1) / kTcKeys * kTcKeys + 4;
}

// the score tile (then P's TF32 hi part), P's lo part, two staging buffers
size_t tc_smem_bytes(int T) {
    return sizeof(float) * (2 * static_cast<size_t>(kTcRows) * score_stride(T) + 2 * kTcStage);
}

// x as hi + lo, each a TF32 value (the low 13 bits of its f32 pattern zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], TF32 in, f32 accumulated
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in 3xTF32: the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
    mma_tf32(d, a_lo, b_hi);
    mma_tf32(d, a_hi, b_lo);
    mma_tf32(d, a_hi, b_hi);
}

// acc += part, element by element in f32 (rounded to nearest)
__device__ __forceinline__ void add_part(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// the A fragment of k-step columns k0 .. k0 + 7 of a row-major [16, ld]
// tile already split into TF32 hi and lo planes: a[0] (row g, col t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4) with g = lane / 4,
// t = lane % 4
__device__ __forceinline__ void load_a_split(const float* s_hi, const float* s_lo, int ld, int k0,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int offs[4] = {g * ld + k0 + t, (g + 8) * ld + k0 + t, g * ld + k0 + t + 4,
                         (g + 8) * ld + k0 + t + 4};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        hi[i] = __float_as_uint(s_hi[offs[i]]);
        lo[i] = __float_as_uint(s_lo[offs[i]]);
    }
}

__device__ __forceinline__ void cp_async(float* smem, const float* gmem, int bytes, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                     "r"(valid ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                     "r"(valid ? 4 : 0));
}

// rows x cols floats of src (row stride lds) into dst (row stride ldd) by
// cp.async, committed as a group; entries past rows_valid or cols_valid are
// zeros. 16-byte copies when vec (src 16-byte aligned, lds and cols_valid
// multiples of 4), else 4-byte ones
__device__ void stage_f32(float* dst, int ldd, const float* __restrict__ src, long long lds,
                          int rows, int cols, int rows_valid, int cols_valid, bool vec) {
    const int w = vec ? 4 : 1, per_row = cols / w;
    for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
        const int r = i / per_row, c = (i % per_row) * w;
        const bool valid = r < rows_valid && c < cols_valid;
        cp_async(dst + r * ldd + c, valid ? src + r * lds + c : src, 4 * w, valid);
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every group but the newest, then for every thread
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
}

__global__ void __launch_bounds__(kTcThreads)
stage_attention_tc_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T, int H,
                          float scale) {
    extern __shared__ __align__(16) float smem[];
    const int ldp = score_stride(T);
    float* s_p = smem;                       // [16][ldp]: scores, then P's hi part
    float* s_plo = s_p + kTcRows * ldp;      // [16][ldp]: P's lo part
    float* s_buf = s_plo + kTcRows * ldp;    // two staging buffers of kTcStage floats
    const int q0 = blockIdx.x * kTcRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const long long ld = 3LL * H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const bool vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;

    // 1. the scores: round r stages Q's 16 rows and key chunk r / slices'
    // K rows, columns slice r % slices of H, into buffer r % 2 while round
    // r - 1 computes
    const int slices = (H + kTcCols - 1) / kTcCols, chunks = (T + kTcKeys - 1) / kTcKeys;
    auto stage_scores = [&](int r) {
        if (r < chunks * slices) {
            float* buf = s_buf + (r & 1) * kTcStage;
            const int k0 = r / slices * kTcKeys, h0 = r % slices * kTcCols;
            const int cols = min(kTcCols, H - h0);
            stage_f32(buf, kLdQK, qkv + (row0 + q0) * ld + h0, ld, kTcRows, kTcCols, T - q0,
                      cols, vec);
            stage_f32(buf + kTcRows * kLdQK, kLdQK, qkv + (row0 + k0) * ld + H + h0, ld,
                      kTcKeys, kTcCols, T - k0, cols, vec);
        }
        cp_async_commit();
    };
    stage_scores(0);
    float acc[4] = {};
    const int n0 = 8 * warp;  // this warp's n8 tile: its first key in a chunk
    for (int r = 0; r < chunks * slices; ++r) {
        stage_scores(r + 1);
        cp_async_wait_prior();
        float* s_q = s_buf + (r & 1) * kTcStage;
        const float* s_k = s_q + kTcRows * kLdQK;
        float* s_qlo = s_q + (kTcRows + kTcKeys) * kLdQK;
        // Q's slice split once into its TF32 hi (in place) and lo planes:
        // every warp reads all of it
        for (int i = threadIdx.x; i < kTcRows * kTcCols; i += kTcThreads) {
            float* x = s_q + (i / kTcCols) * kLdQK + i % kTcCols;
            uint32_t h, l;
            split_tf32(*x, h, l);
            *x = __uint_as_float(h);
            s_qlo[x - s_q] = __uint_as_float(l);
        }
        __syncthreads();
        const int k0 = r / slices * kTcKeys, cols = min(kTcCols, H - r % slices * kTcCols);
        if (k0 + n0 < T) {
            for (int k0g = 0; k0g < cols; k0g += 8 * kTcGroup) {
                float part[4] = {};
                for (int k = k0g; k < min(cols, k0g + 8 * kTcGroup); k += 8) {
                    uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
                    load_a_split(s_q, s_qlo, kLdQK, k, a_hi, a_lo);
                    const float* kr = s_k + (n0 + g) * kLdQK + k + t;
                    split_tf32(kr[0], b_hi[0], b_lo[0]);
                    split_tf32(kr[4], b_hi[1], b_lo[1]);
                    mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
                }
                add_part(acc, part);
            }
        }
        if (r % slices == slices - 1) {  // the chunk's scores are whole
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s_p[(g + 8 * (e >> 1)) * ldp + k0 + n0 + 2 * t + (e & 1)] = acc[e] / scale;
                acc[e] = 0.0f;
            }
        }
        __syncthreads();  // the buffer is read before round r + 2 fills it
    }

    // 3's first V slice is copied while 2 runs
    const int vchunks = (T + kTcVKeys - 1) / kTcVKeys, outs = (H + kTcVCols - 1) / kTcVCols;
    auto stage_values = [&](int r) {
        if (r < outs * vchunks) {
            const int o0 = r / vchunks * kTcVCols, k0 = r % vchunks * kTcVKeys;
            stage_f32(s_buf + (r & 1) * kTcStage, kLdV, qkv + (row0 + k0) * ld + 2 * H + o0, ld,
                      kTcVKeys, kTcVCols, T - k0, min(kTcVCols, H - o0), vec);
        }
        cp_async_commit();
    };
    stage_values(0);

    // 2. the softmax of each row, P split into its TF32 hi and lo planes;
    // keys past T weigh 0
    for (int row = warp; row < kTcRows; row += kTcWarps) {
        float* p = s_p + row * ldp;
        float* lo = s_plo + row * ldp;
        softmax_row(p, T);
        for (int j = lane; j < ldp; j += 32) {
            uint32_t h = 0, l = 0;
            if (j < T) split_tf32(p[j], h, l);
            p[j] = __uint_as_float(h);
            lo[j] = __uint_as_float(l);
        }
    }

    // 3. O = P.V: round r takes output slice r / vchunks, keys of V slice
    // r % vchunks
    float oacc[4] = {};
    for (int r = 0; r < outs * vchunks; ++r) {
        stage_values(r + 1);
        cp_async_wait_prior();  // also: P is written
        const float* s_v = s_buf + (r & 1) * kTcStage;
        const int o0 = r / vchunks * kTcVCols, k0 = r % vchunks * kTcVKeys;
        const int cols = min(kTcVCols, H - o0), keys = min(kTcVKeys, T - k0);
        if (n0 < cols) {  // n0: this warp's n8 tile, its first column in the slice
            for (int k0g = 0; k0g < keys; k0g += 8 * kTcGroup) {
                float part[4] = {};
                for (int k = k0g; k < min(keys, k0g + 8 * kTcGroup); k += 8) {
                    uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
                    load_a_split(s_p, s_plo, ldp, k0 + k, a_hi, a_lo);
                    const float* vr = s_v + (k + t) * kLdV + n0 + g;
                    split_tf32(vr[0], b_hi[0], b_lo[0]);
                    split_tf32(vr[4 * kLdV], b_hi[1], b_lo[1]);
                    mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
                }
                add_part(oacc, part);
            }
        }
        if (r % vchunks == vchunks - 1) {  // the output slice is whole
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = q0 + g + 8 * (e >> 1), col = o0 + n0 + 2 * t + (e & 1);
                if (row < T && col < H) out[(row0 + row) * H + col] = oacc[e];
                oacc[e] = 0.0f;
            }
        }
        __syncthreads();
    }
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
    softmax_row(s_p + warp * T, T);
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

// qkv f32[B, T, 3H] -> out f32[B, T, H]. T must be 1..512 and H 1..1024.
// Returns the CUDA status of the launch.
int stract_stage_attention(const float* qkv, float* out, int B, int T, int H,
                           cudaStream_t stream) {
    if (B <= 0) return cudaSuccess;
    if (T <= 0 || T > kMaxT || H <= 0 || H > kMaxH || B > 65535) return cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        stage_attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc_smem_bytes(kMaxT)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((T + kTcRows - 1) / kTcRows, B);
    stage_attention_tc_kernel<<<grid, kTcThreads, tc_smem_bytes(T), stream>>>(
        qkv, out, T, H, scale_divisor(H));
    return cudaGetLastError();
}

// qkv f32[B, T, 3H], dout f32[B, T, H] (the gradient of the output) ->
// dqkv f32[B, T, 3H]; probs and dscores f32[B, T, T] are scratch (P and
// dS, written by the first kernel, read by the second). T must be 1..512
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
