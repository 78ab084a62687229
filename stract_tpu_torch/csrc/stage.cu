// K16a: the single-head f32 attention of the pipeline stage on Hopper
// (sm_90a), K16b: its backward, K16c: the stage's f32 tanh GELU and its
// backward, and K16d: the SGD update of all the parameters of a card in one
// launch (K16c and K16d at the end).
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
// Both take any T and H, as the reference does (up to 65,535 batch rows:
// the grid's y).
//
// What bounds it: every query row needs 2 T H multiply-adds for its scores
// and 2 T H for P.V (the backward five such products); at the smoke's
// shapes (T = 128, H = 384) that is ~64 flops per byte of q, k, v moved, so
// arithmetic binds, on the tensor cores in 3xTF32 (three TF32 products a
// product: K16a 0.0012 ms at mb = 8, T = 128, H = 384 over 495 TFLOP/s,
// K16b 0.0031). The head width is a runtime argument (up to 1,024): one key
// row is 1.5 KB at H = 384, so K and V cannot be staged whole; they are
// staged in chunks.
//
// Both run on the tensor cores: blocks of 16 warps, each block one tile of
// 16 rows (query rows, or key rows in K16b's second kernel) of one batch
// row, mma.sync.m16n8k8 TF32 products with f32 accumulators. Each f32
// operand a is split as hi = tf32(a) (cvt.rna), lo = tf32(a - hi) (the
// difference is exact), and a.b is taken as lo.hi + hi.lo + hi.hi (lo.lo,
// ~2^-22 |a b|, left out): about 21 bits of each product against TF32's
// 10, so the kernels keep the f32 twin's tolerance (rtol 1e-5, atol 1e-5 x
// max |out|), which TF32 alone misses by orders of magnitude
// (tests/test_torch_pipeline.py emulates both against f64, the backward's
// five products too). The tensor cores' f32 sums do not round to nearest: a
// chain of mma into one accumulator drifts (384 of them at H = 1,024 missed
// the tolerance on the H100 at T = 512), so each chain covers kTcGroup
// k-steps from zero and its part is added to the running sum in f32 (four
// chains a group, hi.hi apart from the small terms and even k-steps apart
// from odd, took 0.037 against 0.032 ms at mb = 8, T = 128, H = 384). Past
// H = 1,024 nothing changes: a product over H is H / 32 such parts added
// in f32 (64 at H = 2,048; tests/test_torch_pipeline.py emulates the
// grouping there), and the output slices are a loop.
// mma.sync over wgmma: TF32 wgmma takes B only K-major, so P.V would need V
// transposed in shared memory; mma.sync's B fragment is loaded from
// registers, read from V as it is staged, and split in registers as it is
// loaded; an operand every warp reads (Q, P) is split once into TF32 hi and
// lo planes in shared memory. Every product is one of two kinds:
//   - a row product (rows_product: S = Q.K^T, dP = dO.V^T): for each chunk
//     of 128 of B's rows (each warp owns 8 of them: one n8 tile), A's 16
//     rows and the chunk are staged 64 columns of H at a time (f32, rows
//     padded to 68 floats so a fragment's 32 loads hit 32 banks; A's slice
//     then split into its planes), and the chunk's [16, 128] results go to a
//     [16, T] tile in shared memory (S divided by sqrt(H), an IEEE division
//     as the twin divides);
//   - a planes product (planes_product: O = P.V, dQ = dS.K, dV = P^T.dO,
//     dK = dS^T.Q): A is a [16, T] tile held as TF32 hi and lo planes; for
//     each slice of 128 output columns (each warp owns 8: one n8 tile), B is
//     staged 64 of its rows at a time (rows padded to 136 floats) and the
//     slice is stored to its output rows.
// Every staging is a round of cp.async copies into one of two buffers, the
// next round's copies in flight while this one computes (a planes
// product's first round while the tile is formed): the grid has 64 blocks
// at the pipelined step's shapes, one an SM, so latency binds, and 16 warps
// an SM hide more of it than 8 (0.043 ms) or 4 warps with each round's loads
// waited for (0.061 ms) did on the H100 (K16a). Shared memory: two [16,
// T rounded up to 128, + 4] tiles and two staging buffers of 43,520 bytes;
// 153,088 bytes at T = 512, 218,624 at T = 1,024, the most that fits a
// block (the kernels opt in). No atomics: every output element has one
// writer, so two calls are bit-equal.
//
// Past T = 1,024 (kTcChunk) the [16, T] tiles no longer fit, and the keys
// (the queries in K16b's key-tile kernel) are taken in chunks of 1,024 with
// [16, 1,024] tiles: K16a's and K16b's query-tile kernels walk the chunks
// of S once for each row's max and sum (the sum scaled by
// exp(old max - new max) when the max grows, one warp a row), then again
// for p = exp(s - max) / sum, the twin's expressions; K16a feeds each
// chunk's P to P.V, K16b forms D = rowsum(P dP) from the chunks of S and
// dP and writes P^T and dP^T to the scratch, then reads each chunk back for
// dS = P (dP - D) / sqrt(H), writes dS^T over dP^T and feeds dS to dQ; the
// key-tile kernel takes its rows of P^T and dS^T a query chunk at a time.
// A planes product adds each chunk's part of an output row to what the
// chunks before it stored there (the block owns those rows: no atomics, the
// same order every call).
//
// K16a (stage_attention_tc_kernel), per query tile: S, the softmax of each
// row in place (one warp a row: max, exp, sum, division by the sum: the
// twin's expressions), P written as its TF32 hi and lo planes (split once,
// not by every warp that reads it; keys past T 0), O = P.V.
//
// K16b, kernel 1 (stage_attention_bwd_query_kernel), per query tile: S and
// dP as row products into the two tiles; the softmax, D = rowsum(P dP) and
// dS = P (dP - D) / sqrt(H) in f32 (the twin's expressions, a warp a row);
// P and dS written transposed to the scratch f32[mb, T, T] (key j's 16
// entries of the tile contiguous, so kernel 2 stages its rows as they lie);
// dS split into planes (its lo part over P) and dQ = dS.K. Kernel 2
// (stage_attention_bwd_key_kernel), per tile of 16 key rows: its rows of
// P^T staged from the scratch and split, dV = P^T.dO; then dS^T's, dK =
// dS^T.Q. Each Q and dO row is read T / 16 times (an earlier form on the
// CUDA cores read them T / 8 times, unstaged, one serial H-long dot a key a
// lane, and lost 5.4x to the twin's cuBLAS products at T = 512); the
// scratch (2 mb T^2 floats, 4 MB at mb = 8, T = 512) stays in the 50 MB L2
// between the kernels.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

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

// ---- the tiles of the tensor-core products -----------------------------------------
constexpr int kTcRows = 16;               // rows of a block's tile: one mma tile
constexpr int kTcWarps = 16;              // a warp owns one n8 tile of keys, or of outputs
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcKeys = 128;              // B rows of a staged chunk (row products)
constexpr int kTcCols = 64;               // columns of H of a staged A and B slice
constexpr int kTcVKeys = 64;              // B rows of a staged slice (planes products)
constexpr int kTcVCols = 128;             // columns of that slice (outputs)
constexpr int kLdQK = kTcCols + 4;        // row stride of a row product's slices (floats)
constexpr int kLdV = kTcVCols + 8;        // row stride of a planes product's slice
constexpr int kTcGroup = 4;               // k-steps summed in one accumulator chain
// floats of one staging buffer: a row product's A slice, B slice and A's
// TF32 lo plane, or a planes product's B slice
constexpr int kTcStage = (2 * kTcRows + kTcKeys) * kLdQK > kTcVKeys * kLdV
                             ? (2 * kTcRows + kTcKeys) * kLdQK : kTcVKeys * kLdV;

// the most keys (or queries) of a [16, T] tile: past it the kernels take
// them in chunks of kTcChunk
constexpr int kTcChunk = 1024;
static_assert(kTcWarps == kTcRows, "a warp a row of the tile");

// a [16, T] tile's row stride: T rounded up to a chunk, + 4 (conflict-free A fragments)
__host__ __device__ inline int score_stride(int T) {
    return (T + kTcKeys - 1) / kTcKeys * kTcKeys + 4;
}

// two [16, T] tiles (scores and P's planes, or dP and dS's, or P^T's and
// dS^T's planes) and two staging buffers
size_t tc_smem_bytes(int T) {
    return sizeof(float) * (2 * static_cast<size_t>(kTcRows) * score_stride(T) + 2 * kTcStage);
}

// the chunked kernels': two [16, kTcChunk] tiles, the staging buffers and
// each row's D (K16b)
size_t tc_chunked_smem_bytes() { return tc_smem_bytes(kTcChunk) + sizeof(float) * kTcRows; }

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

// ---- the two products every kernel here is made of ----------------------------------
// A row product: s_out[r][j] = A_r . B_j for A's 16 rows and B's T rows,
// both H wide (S = Q.K^T, dP = dO.V^T). Round r stages A's rows and B's
// key chunk r / slices, columns slice r % slices of H, into buffer r % 2;
// each warp owns one n8 tile of a chunk's keys.
__device__ void stage_row_round(float* s_buf, int r, const float* __restrict__ a, long long lda,
                                int a_rows, const float* __restrict__ b, long long ldb, int T,
                                int H, bool vec) {
    const int slices = (H + kTcCols - 1) / kTcCols, chunks = (T + kTcKeys - 1) / kTcKeys;
    if (r < chunks * slices) {
        float* buf = s_buf + (r & 1) * kTcStage;
        const int k0 = r / slices * kTcKeys, h0 = r % slices * kTcCols;
        const int cols = min(kTcCols, H - h0);
        stage_f32(buf, kLdQK, a + h0, lda, kTcRows, kTcCols, a_rows, cols, vec);
        stage_f32(buf + kTcRows * kLdQK, kLdQK, b + k0 * ldb + h0, ldb, kTcKeys, kTcCols, T - k0,
                  cols, vec);
    }
    cp_async_commit();
}

// s_out[r][j] (row stride ldp) = A_r . B_j, divided by scale when divide (an
// IEEE division, as the twin divides), for j below T rounded up to a chunk
// (keys past T: 0). A: a_rows valid rows at a (row stride lda), B: T rows at
// b (row stride ldb). A's slice is split once into its TF32 hi (in place)
// and lo planes: every warp reads all of it. Ends synchronised.
__device__ __forceinline__ void rows_product(float* s_out, int ldp, float* s_buf,
                                             const float* __restrict__ a, long long lda,
                                             int a_rows, const float* __restrict__ b,
                                             long long ldb, int T, int H, bool vec, bool divide,
                                             float scale) {
    const int slices = (H + kTcCols - 1) / kTcCols, chunks = (T + kTcKeys - 1) / kTcKeys;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = 8 * warp;  // this warp's n8 tile: its first key in a chunk
    stage_row_round(s_buf, 0, a, lda, a_rows, b, ldb, T, H, vec);
    float acc[4] = {};
    for (int r = 0; r < chunks * slices; ++r) {
        stage_row_round(s_buf, r + 1, a, lda, a_rows, b, ldb, T, H, vec);
        cp_async_wait_prior();
        float* s_a = s_buf + (r & 1) * kTcStage;
        const float* s_b = s_a + kTcRows * kLdQK;
        float* s_alo = s_a + (kTcRows + kTcKeys) * kLdQK;
        for (int i = threadIdx.x; i < kTcRows * kTcCols; i += kTcThreads) {
            float* x = s_a + (i / kTcCols) * kLdQK + i % kTcCols;
            uint32_t h, l;
            split_tf32(*x, h, l);
            *x = __uint_as_float(h);
            s_alo[x - s_a] = __uint_as_float(l);
        }
        __syncthreads();
        const int k0 = r / slices * kTcKeys, cols = min(kTcCols, H - r % slices * kTcCols);
        if (k0 + n0 < T) {
            for (int k0g = 0; k0g < cols; k0g += 8 * kTcGroup) {
                float part[4] = {};
                for (int k = k0g; k < min(cols, k0g + 8 * kTcGroup); k += 8) {
                    uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
                    load_a_split(s_a, s_alo, kLdQK, k, a_hi, a_lo);
                    const float* br = s_b + (n0 + g) * kLdQK + k + t;
                    split_tf32(br[0], b_hi[0], b_lo[0]);
                    split_tf32(br[4], b_hi[1], b_lo[1]);
                    mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
                }
                add_part(acc, part);
            }
        }
        if (r % slices == slices - 1) {  // the chunk's products are whole
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s_out[(g + 8 * (e >> 1)) * ldp + k0 + n0 + 2 * t + (e & 1)] =
                    divide ? acc[e] / scale : acc[e];
                acc[e] = 0.0f;
            }
        }
        __syncthreads();  // the buffer is read before round r + 2 fills it
    }
}

// A planes product: dst_r = sum_j A[r][j] B_j for a [16, T] A held as TF32
// hi and lo planes (row stride ldp; columns past T zero) and B's T rows, H
// wide (O = P.V, dQ = dS.K, dV = P^T.dO, dK = dS^T.Q). Round r stages B's
// rows r % vchunks (64 of them), columns slice r / vchunks (128), into
// buffer r % 2; each warp owns one n8 tile of a slice's columns.
__device__ void stage_col_round(float* s_buf, int r, const float* __restrict__ b, long long ldb,
                                int T, int H, bool vec) {
    const int vchunks = (T + kTcVKeys - 1) / kTcVKeys, outs = (H + kTcVCols - 1) / kTcVCols;
    if (r < outs * vchunks) {
        const int o0 = r / vchunks * kTcVCols, k0 = r % vchunks * kTcVKeys;
        stage_f32(s_buf + (r & 1) * kTcStage, kLdV, b + k0 * ldb + o0, ldb, kTcVKeys, kTcVCols,
                  T - k0, min(kTcVCols, H - o0), vec);
    }
    cp_async_commit();
}

// dst[r * ld_dst + c] = sum_j A[r][j] B_j[c] for the rows r below rows
// (added to what dst holds when accumulate: a later chunk of keys). The
// caller has committed round 0 (stage_col_round(s_buf, 0, ...)), so its
// copies overlap the caller's work on the planes; the first wait also
// orders the planes' writes before their reads. Ends synchronised.
__device__ __forceinline__ void planes_product(const float* s_hi, const float* s_lo, int ldp,
                                               float* s_buf, const float* __restrict__ b,
                                               long long ldb, int T, int H, bool vec,
                                               float* __restrict__ dst, long long ld_dst,
                                               int rows, bool accumulate = false) {
    const int vchunks = (T + kTcVKeys - 1) / kTcVKeys, outs = (H + kTcVCols - 1) / kTcVCols;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int n0 = 8 * warp;  // this warp's n8 tile: its first column in a slice
    float oacc[4] = {};
    for (int r = 0; r < outs * vchunks; ++r) {
        stage_col_round(s_buf, r + 1, b, ldb, T, H, vec);
        cp_async_wait_prior();
        const float* s_b = s_buf + (r & 1) * kTcStage;
        const int o0 = r / vchunks * kTcVCols, k0 = r % vchunks * kTcVKeys;
        const int cols = min(kTcVCols, H - o0), keys = min(kTcVKeys, T - k0);
        if (n0 < cols) {
            for (int k0g = 0; k0g < keys; k0g += 8 * kTcGroup) {
                float part[4] = {};
                for (int k = k0g; k < min(keys, k0g + 8 * kTcGroup); k += 8) {
                    uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
                    load_a_split(s_hi, s_lo, ldp, k0 + k, a_hi, a_lo);
                    const float* br = s_b + (k + t) * kLdV + n0 + g;
                    split_tf32(br[0], b_hi[0], b_lo[0]);
                    split_tf32(br[4 * kLdV], b_hi[1], b_lo[1]);
                    mma_3xtf32(part, a_hi, a_lo, b_hi, b_lo);
                }
                add_part(oacc, part);
            }
        }
        if (r % vchunks == vchunks - 1) {  // the output slice is whole
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = g + 8 * (e >> 1), col = o0 + n0 + 2 * t + (e & 1);
                if (row < rows && col < H) {
                    float* o = dst + row * ld_dst + col;
                    *o = accumulate ? *o + oacc[e] : oacc[e];
                }
                oacc[e] = 0.0f;
            }
        }
        __syncthreads();
    }
}

// both operands staged by 16-byte copies: widths a multiple of 4, pointers 16-byte aligned
__device__ __forceinline__ bool vec_rows(int H, const float* a, const float* b) {
    return H % 4 == 0 &&
           ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
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
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool vec = vec_rows(H, qkv, qkv);
    const float* base = qkv + row0 * ld;

    // 1. the scores
    rows_product(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H, ld, T, H, vec, true,
                 scale);
    // 3's first V slice is copied while 2 runs
    stage_col_round(s_buf, 0, base + 2 * H, ld, T, H, vec);
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
    // 3. O = P.V
    planes_product(s_p, s_plo, ldp, s_buf, base + 2 * H, ld, T, H, vec, out + (row0 + q0) * H, H,
                   T - q0);
}

// K16b, kernel 1: per tile of 16 query rows, S and dP = dO.V^T as row
// products, the softmax, D and dS in f32; P^T and dS^T to the scratch; dQ =
// dS.K into dqkv's first column block.
__global__ void __launch_bounds__(kTcThreads)
stage_attention_bwd_query_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                 float* __restrict__ probs_t, float* __restrict__ dscores_t,
                                 float* __restrict__ dqkv, int T, int H, float scale) {
    extern __shared__ __align__(16) float smem[];
    const int ldp = score_stride(T);
    float* s_p = smem;                       // [16][ldp]: S, then P, then dS's lo part
    float* s_ds = s_p + kTcRows * ldp;       // [16][ldp]: dP, then dS, then its hi part
    float* s_buf = s_ds + kTcRows * ldp;     // two staging buffers of kTcStage floats
    const int q0 = blockIdx.x * kTcRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const long long ld = 3LL * H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool vec = vec_rows(H, qkv, dout);
    const float* base = qkv + row0 * ld;

    rows_product(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H, ld, T, H, vec, true,
                 scale);
    rows_product(s_ds, ldp, s_buf, dout + (row0 + q0) * H, H, T - q0, base + 2 * H, ld, T, H,
                 vec, false, scale);
    stage_col_round(s_buf, 0, base + H, ld, T, H, vec);  // dQ's first K slice meanwhile
    // the softmax, D = rowsum(P dP) and dS = P (dP - D) / sqrt(H), a warp a
    // row, in the twin's expressions; keys past T: dS = 0
    for (int row = warp; row < kTcRows; row += kTcWarps) {
        float* p = s_p + row * ldp;
        float* ds = s_ds + row * ldp;
        softmax_row(p, T);
        __syncwarp();
        float dsum = 0.0f;
        for (int j = lane; j < T; j += 32) dsum += p[j] * ds[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
        for (int j = lane; j < ldp; j += 32) ds[j] = j < T ? p[j] * (ds[j] - dsum) / scale : 0.0f;
    }
    __syncthreads();
    // P^T and dS^T to the scratch: key j's 16 entries of this tile contiguous
    const int rows = min(kTcRows, T - q0);
    for (int i = threadIdx.x; i < kTcRows * T; i += kTcThreads) {
        const int j = i / kTcRows, q = i % kTcRows;
        if (q < rows) {
            const long long at = (row0 + j) * T + q0 + q;
            probs_t[at] = s_p[q * ldp + j];
            dscores_t[at] = s_ds[q * ldp + j];
        }
    }
    __syncthreads();
    // dS split into its TF32 planes: hi in place, lo over P
    for (int i = threadIdx.x; i < kTcRows * ldp; i += kTcThreads) {
        uint32_t h, l;
        split_tf32(s_ds[i], h, l);
        s_ds[i] = __uint_as_float(h);
        s_p[i] = __uint_as_float(l);
    }
    planes_product(s_ds, s_p, ldp, s_buf, base + H, ld, T, H, vec, dqkv + (row0 + q0) * ld, ld,
                   rows);
}

// K16b, kernel 2: per tile of 16 key rows, dV = P^T.dO and dK = dS^T.Q into
// dqkv's third and second column blocks, each as a planes product with the
// tile's 16 rows of P^T (then dS^T) staged from the scratch and split, a
// chunk of kTcChunk queries at a time past that many.
__global__ void __launch_bounds__(kTcThreads)
stage_attention_bwd_key_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                               const float* __restrict__ probs_t,
                               const float* __restrict__ dscores_t, float* __restrict__ dqkv,
                               int T, int H) {
    extern __shared__ __align__(16) float smem[];
    const int chunk = min(T, kTcChunk);
    const int ldp = score_stride(chunk);
    float* s_hi = smem;                      // [16][ldp]: the tile's rows, then their hi part
    float* s_lo = s_hi + kTcRows * ldp;      // [16][ldp]: their lo part
    float* s_buf = s_lo + kTcRows * ldp;     // two staging buffers of kTcStage floats
    const int k0 = blockIdx.x * kTcRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const long long ld = 3LL * H;
    const bool vec = vec_rows(H, qkv, dout);
    const bool tvec = T % 4 == 0 && ((reinterpret_cast<uintptr_t>(probs_t) |
                                      reinterpret_cast<uintptr_t>(dscores_t)) & 15) == 0;
    const int rows = min(kTcRows, T - k0);
    for (int pass = 0; pass < 2; ++pass) {
        const float* a = (pass == 0 ? probs_t : dscores_t) + (row0 + k0) * T;
        const float* b = pass == 0 ? dout + row0 * H : qkv + row0 * ld;  // dO or Q
        const long long ldb = pass == 0 ? H : ld;
        for (int c0 = 0; c0 < T; c0 += chunk) {
            const int n = min(chunk, T - c0);
            const int cols = (n + 7) / 8 * 8;  // the columns the k-steps read (past n: 0)
            stage_f32(s_hi, ldp, a + c0, T, kTcRows, cols, rows, n, tvec);
            cp_async_commit();
            stage_col_round(s_buf, 0, b + c0 * ldb, ldb, n, H, vec);
            cp_async_wait_prior();  // the tile's rows
            for (int i = threadIdx.x; i < kTcRows * cols; i += kTcThreads) {
                float* x = s_hi + (i / cols) * ldp + i % cols;
                uint32_t h, l;
                split_tf32(*x, h, l);
                *x = __uint_as_float(h);
                s_lo[x - s_hi] = __uint_as_float(l);
            }
            planes_product(s_hi, s_lo, ldp, s_buf, b + c0 * ldb, ldb, n, H, vec,
                           dqkv + (row0 + k0) * ld + (pass == 0 ? 2 * H : H), ld, rows, c0 > 0);
        }
    }
}

// ---- the chunked forms past kTcChunk keys ----------------------------------------------
// a warp's row of n scores folded into its running max and sum (every lane
// gets the same): the sum scaled by exp(old max - new max), the chunk's
// exp(s - new max) added
__device__ __forceinline__ void running_max_sum(const float* row, int n, float& mx, float& sum) {
    const int lane = threadIdx.x % 32;
    float m = -CUDART_INF_F;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float nm = fmaxf(mx, m);
    float e = 0.0f;
    for (int j = lane; j < n; j += 32) e += expf(row[j] - nm);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    sum = sum * expf(mx - nm) + e;  // mx = -inf at the first chunk: the old sum weighs 0
    mx = nm;
}

// pass 1 of the chunked kernels: S = Q.K^T / sqrt(H) a chunk of keys at a
// time into s_p, this warp's row's max and sum over all T keys → mx, sum
__device__ __forceinline__ void chunked_max_sum(float* s_p, int ldp, float* s_buf,
                                                const float* q_rows, long long ld, int q_valid,
                                                const float* k_rows, int T, int H, bool vec,
                                                float scale, float& mx, float& sum) {
    const int warp = threadIdx.x / 32;
    mx = -CUDART_INF_F;
    sum = 0.0f;
    for (int k0 = 0; k0 < T; k0 += kTcChunk) {
        const int n = min(kTcChunk, T - k0);
        rows_product(s_p, ldp, s_buf, q_rows, ld, q_valid, k_rows + k0 * ld, ld, n, H, vec, true,
                     scale);
        running_max_sum(s_p + warp * ldp, n, mx, sum);
        __syncthreads();  // the rows read before the next chunk's scores
    }
}

// K16a past kTcChunk keys: per tile of 16 query rows, the row max and sum
// over the chunks of S, then each chunk's S again, P = exp(s - max) / sum
// split into its planes, O += P.V_chunk
__global__ void __launch_bounds__(kTcThreads)
stage_attention_chunked_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T,
                               int H, float scale) {
    extern __shared__ __align__(16) float smem[];
    const int ldp = score_stride(kTcChunk);
    float* s_p = smem;                       // [16][ldp]: a chunk's scores, then P's hi part
    float* s_plo = s_p + kTcRows * ldp;      // [16][ldp]: P's lo part
    float* s_buf = s_plo + kTcRows * ldp;    // two staging buffers of kTcStage floats
    const int q0 = blockIdx.x * kTcRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const long long ld = 3LL * H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool vec = vec_rows(H, qkv, qkv);
    const float* base = qkv + row0 * ld;
    float mx, sum;
    chunked_max_sum(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H, T, H, vec, scale, mx,
                    sum);
    for (int k0 = 0; k0 < T; k0 += kTcChunk) {
        const int n = min(kTcChunk, T - k0);
        rows_product(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H + k0 * ld, ld, n, H,
                     vec, true, scale);
        stage_col_round(s_buf, 0, base + 2 * H + k0 * ld, ld, n, H, vec);
        float* p = s_p + warp * ldp;
        float* lo = s_plo + warp * ldp;
        for (int j = lane; j < ldp; j += 32) {  // keys past n weigh 0
            uint32_t h = 0, l = 0;
            if (j < n) split_tf32(expf(p[j] - mx) / sum, h, l);
            p[j] = __uint_as_float(h);
            lo[j] = __uint_as_float(l);
        }
        planes_product(s_p, s_plo, ldp, s_buf, base + 2 * H + k0 * ld, ld, n, H, vec,
                       out + (row0 + q0) * H, H, T - q0, k0 > 0);
    }
}

// K16b's kernel 1 past kTcChunk keys: per tile of 16 query rows, the row
// max and sum over the chunks of S; then each chunk's S and dP again, P,
// D's part, P^T and dP^T to the scratch; then each chunk read back, dS =
// P (dP - D) / sqrt(H) written over dP^T, dQ += dS.K_chunk.
__global__ void __launch_bounds__(kTcThreads)
stage_attention_bwd_query_chunked_kernel(const float* __restrict__ qkv,
                                         const float* __restrict__ dout,
                                         float* __restrict__ probs_t,
                                         float* __restrict__ dscores_t,
                                         float* __restrict__ dqkv, int T, int H, float scale) {
    extern __shared__ __align__(16) float smem[];
    const int ldp = score_stride(kTcChunk);
    float* s_p = smem;                       // [16][ldp]: S, then P; then dS's lo part
    float* s_ds = s_p + kTcRows * ldp;       // [16][ldp]: dP; then dS's hi part
    float* s_buf = s_ds + kTcRows * ldp;     // two staging buffers of kTcStage floats
    float* s_d = s_buf + 2 * kTcStage;       // [16]: each row's D
    const int q0 = blockIdx.x * kTcRows;
    const long long row0 = static_cast<long long>(blockIdx.y) * T;
    const long long ld = 3LL * H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool vec = vec_rows(H, qkv, dout);
    const float* base = qkv + row0 * ld;
    const int rows = min(kTcRows, T - q0);
    float mx, sum;
    chunked_max_sum(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H, T, H, vec, scale, mx,
                    sum);
    float dsum = 0.0f;  // this lane's part of its warp's row's D
    for (int k0 = 0; k0 < T; k0 += kTcChunk) {
        const int n = min(kTcChunk, T - k0);
        rows_product(s_p, ldp, s_buf, base + q0 * ld, ld, T - q0, base + H + k0 * ld, ld, n, H,
                     vec, true, scale);
        rows_product(s_ds, ldp, s_buf, dout + (row0 + q0) * H, H, T - q0, base + 2 * H + k0 * ld,
                     ld, n, H, vec, false, scale);
        float* p = s_p + warp * ldp;
        const float* dp = s_ds + warp * ldp;
        for (int j = lane; j < n; j += 32) {
            p[j] = expf(p[j] - mx) / sum;
            dsum += p[j] * dp[j];
        }
        __syncthreads();
        for (int i = threadIdx.x; i < kTcRows * n; i += kTcThreads) {  // key j's 16 contiguous
            const int j = i / kTcRows, q = i % kTcRows;
            if (q < rows) {
                const long long at = (row0 + k0 + j) * T + q0 + q;
                probs_t[at] = s_p[q * ldp + j];
                dscores_t[at] = s_ds[q * ldp + j];
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) s_d[warp] = dsum;
    __syncthreads();
    for (int k0 = 0; k0 < T; k0 += kTcChunk) {
        const int n = min(kTcChunk, T - k0);
        stage_col_round(s_buf, 0, base + H + k0 * ld, ld, n, H, vec);  // dQ's first K slice
        // the chunk's P and dP back from the scratch, dS = P (dP - D) / sqrt(H)
        // over dP^T, split into its planes (hi in s_ds, lo in s_p); past n or
        // past the tile's rows: 0
        for (int i = threadIdx.x; i < kTcRows * ldp; i += kTcThreads) {
            const int j = i / kTcRows, q = i % kTcRows;
            float ds = 0.0f;
            if (j < n && q < rows) {
                const long long at = (row0 + k0 + j) * T + q0 + q;
                ds = probs_t[at] * (dscores_t[at] - s_d[q]) / scale;
                dscores_t[at] = ds;
            }
            uint32_t h, l;
            split_tf32(ds, h, l);
            s_ds[q * ldp + j] = __uint_as_float(h);
            s_p[q * ldp + j] = __uint_as_float(l);
        }
        planes_product(s_ds, s_p, ldp, s_buf, base + H + k0 * ld, ld, n, H, vec,
                       dqkv + (row0 + q0) * ld, ld, rows, k0 > 0);
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

// K16c: the pipeline stage's tanh GELU, jax.nn.gelu(x @ ffn_in,
// approximate=True) in f32 with no bias (stract_tpu/parallel/pipeline.py:50),
// and its VJP, which jax.value_and_grad takes through it in
// make_pipeline_train_step. y = x * 0.5 * (1 + t), t = tanh(c1 (x + c2 x^3)),
// the cube as x * x * x, c1 = f32(sqrt(2 / pi)), c2 = f32(0.044715) (the
// constants of ops/stage.py); dx = g * 0.5 * (1 + t) + g * x * 0.5 * (1 -
// t^2) * c1 * (1 + 3 c2 x^2), in the plain version's order
// (gelu_tanh_backward_plain). tanh(u) is 1 - 2 / (e^{2u} + 1): exact at both
// tails (u -> +inf gives 1, u -> -inf gives -1, and no NaN), to a few ulps in
// between, with expf and __fdividef (2 ulps; 0 for a divisor past 2^126 or
// infinite, which is the top tail's t = 1); the hardware tanh.approx.f32
// keeps about 11 bits, short of the plain version's tolerance (rtol 1e-5).
// The IEEE division takes its slow path on the tails' large e; the
// approximate one leaves the largest error against the plain versions as it
// was (the formula's own cancellation near t = -1 sets it).
//
// What bounds it: one flat pass over memory, 8 bytes an element forward (x
// read, y written) and 12 backward (x and g read, dx written), ~35
// operations an element: 20 B over 3.35 TB/s, 0.0094 ms for the pair at the
// pipelined step's 8 x 128 x 1536 (the 19 MB a pair touches can stay in the
// 50 MB L2 from one call to the next, so a pair may read under that bound).
// The design is the flat pass and nothing
// else: 16-byte loads and stores where every pointer is 16-byte aligned and
// n % 4 == 0, single elements otherwise (any n, any contiguous view), on a
// fixed grid of 8 blocks of 256 an SM (the most that are resident) that
// strides over the elements: a first build with 4 blocks an SM and the IEEE
// division read 0.0087-0.0088 ms a pair on the device, this one
// 0.0071-0.0073 (scripts/kernel_times.py, H100 at 700 W). It is
// CUDA rather than Triton for the host side, not the work: the ctypes
// launch under ops/kernels.py on_card costs a few microseconds of host
// against Triton's Python launcher and device guard, and every other
// kernel of the port is built the same way.
constexpr int kGeluThreads = 256;
constexpr int kGeluBlocksPerSm = 8;
constexpr float kGeluC1 = 0.7978845608028654f;  // f32(sqrt(2 / pi))
constexpr float kGeluC2 = 0.044715f;
// 3 c2 as the plain version forms it: 3.0 * c2 in double, rounded to f32
constexpr float kGelu3C2 = static_cast<float>(3.0 * static_cast<double>(kGeluC2));

__device__ __forceinline__ float gelu_t(float x) {
    const float u = kGeluC1 * (x + kGeluC2 * (x * x * x));
    return 1.0f - __fdividef(2.0f, expf(2.0f * u) + 1.0f);
}

__device__ __forceinline__ float gelu_fwd(float x) { return x * (0.5f * (1.0f + gelu_t(x))); }

__device__ __forceinline__ float gelu_bwd(float x, float g) {
    const float t = gelu_t(x);
    const float du = kGeluC1 * (1.0f + kGelu3C2 * (x * x));
    return g * (0.5f * (1.0f + t)) + g * x * (0.5f * (1.0f - t * t)) * du;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kGeluThreads)
gelu_tanh_kernel(const float* __restrict__ x, float* __restrict__ y, long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * kGeluThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kGeluThreads + threadIdx.x;
    if (n % 4 == 0 && aligned16(x) && aligned16(y)) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        float4* y4 = reinterpret_cast<float4*>(y);
        for (long long i = first; i < n / 4; i += stride) {
            const float4 a = x4[i];
            y4[i] = make_float4(gelu_fwd(a.x), gelu_fwd(a.y), gelu_fwd(a.z), gelu_fwd(a.w));
        }
    } else {
        for (long long i = first; i < n; i += stride) y[i] = gelu_fwd(x[i]);
    }
}

__global__ void __launch_bounds__(kGeluThreads)
gelu_tanh_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          float* __restrict__ dx, long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * kGeluThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kGeluThreads + threadIdx.x;
    if (n % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx)) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const float4* g4 = reinterpret_cast<const float4*>(g);
        float4* d4 = reinterpret_cast<float4*>(dx);
        for (long long i = first; i < n / 4; i += stride) {
            const float4 a = x4[i], b = g4[i];
            d4[i] = make_float4(gelu_bwd(a.x, b.x), gelu_bwd(a.y, b.y), gelu_bwd(a.z, b.z),
                                gelu_bwd(a.w, b.w));
        }
    } else {
        for (long long i = first; i < n; i += stride) dx[i] = gelu_bwd(x[i], g[i]);
    }
}

// the fixed grid of a flat pass over n elements: enough blocks for one
// 16-byte piece a thread, at most kGeluBlocksPerSm blocks an SM of the
// current card, at least one
cudaError_t gelu_grid(long long n, unsigned* blocks) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long want = (n + 4LL * kGeluThreads - 1) / (4LL * kGeluThreads);
    const long long cap = static_cast<long long>(sms) * kGeluBlocksPerSm;
    *blocks = static_cast<unsigned>(want < cap ? (want > 0 ? want : 1) : cap);
    return cudaSuccess;
}

}  // namespace

extern "C" {

// qkv f32[B, T, 3H] -> out f32[B, T, H]: T and H at least 1, B at most
// 65,535. Returns the CUDA status of the launch.
int stract_stage_attention(const float* qkv, float* out, int B, int T, int H,
                           cudaStream_t stream) {
    if (B <= 0) return cudaSuccess;
    if (T <= 0 || H <= 0 || B > 65535) return cudaErrorInvalidValue;
    const bool chunked = T > kTcChunk;
    auto* kernel = chunked ? stage_attention_chunked_kernel : stage_attention_tc_kernel;
    const size_t smem = chunked ? tc_chunked_smem_bytes() : tc_smem_bytes(T);
    const cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((T + kTcRows - 1) / kTcRows, B);
    kernel<<<grid, kTcThreads, smem, stream>>>(qkv, out, T, H, scale_divisor(H));
    return cudaGetLastError();
}

// qkv f32[B, T, 3H], dout f32[B, T, H] (the gradient of the output) ->
// dqkv f32[B, T, 3H]; probs and dscores f32[B, T, T] are scratch (P and
// dS transposed, written by the first kernel, read by the second). T, H and
// B as stract_stage_attention's. Returns the CUDA status of the launches.
int stract_stage_attention_backward(const float* qkv, const float* dout, float* probs,
                                    float* dscores, float* dqkv, int B, int T, int H,
                                    cudaStream_t stream) {
    if (B <= 0) return cudaSuccess;
    if (T <= 0 || H <= 0 || B > 65535) return cudaErrorInvalidValue;
    const bool chunked = T > kTcChunk;
    auto* query = chunked ? stage_attention_bwd_query_chunked_kernel
                          : stage_attention_bwd_query_kernel;
    const size_t smem_query = chunked ? tc_chunked_smem_bytes() : tc_smem_bytes(T);
    const size_t smem_key = tc_smem_bytes(T < kTcChunk ? T : kTcChunk);
    cudaError_t attr = cudaFuncSetAttribute(  // per card: set at every launch
        query, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_query));
    if (attr == cudaSuccess)
        attr = cudaFuncSetAttribute(stage_attention_bwd_key_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem_key));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((T + kTcRows - 1) / kTcRows, B);
    query<<<grid, kTcThreads, smem_query, stream>>>(qkv, dout, probs, dscores, dqkv, T, H,
                                                   scale_divisor(H));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    stage_attention_bwd_key_kernel<<<grid, kTcThreads, smem_key, stream>>>(
        qkv, dout, probs, dscores, dqkv, T, H);
    return cudaGetLastError();
}

// K16c: x f32[n] -> y f32[n], the tanh GELU (any n >= 0; 16-byte pieces
// where both pointers allow and n % 4 == 0). Returns the CUDA status of the
// launch (none for n = 0).
int stract_gelu_tanh(const float* x, float* y, long long n, cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    unsigned blocks = 0;
    const cudaError_t err = gelu_grid(n, &blocks);
    if (err != cudaSuccess) return err;
    gelu_tanh_kernel<<<blocks, kGeluThreads, 0, stream>>>(x, y, n);
    return cudaGetLastError();
}

// K16c backward: x, dout f32[n] -> dx f32[n], the VJP of stract_gelu_tanh.
int stract_gelu_tanh_backward(const float* x, const float* dout, float* dx, long long n,
                              cudaStream_t stream) {
    if (n < 0) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    unsigned blocks = 0;
    const cudaError_t err = gelu_grid(n, &blocks);
    if (err != cudaSuccess) return err;
    gelu_tanh_backward_kernel<<<blocks, kGeluThreads, 0, stream>>>(x, dout, dx, n);
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
