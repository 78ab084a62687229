// Hand-written Hopper kernels for the three device programs of the search
// path (stract_tpu/ops/scoring.py). Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// into a plain C library bound with ctypes. Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K1  stract_stage_a  replaces score_candidates_batch (ops/scoring.py:807):
//     candidate scan + join by doc + top-C. Bound by the B*P*L posting-row
//     reads (12 B each) and the per-query join: one query's P*L entries do not
//     fit in shared memory, so the join is a per-query open-addressing hash
//     table in global memory (atomicCAS on the doc, float atomicAdd for the
//     text sum, atomicOr for the required-group mask and the excluded bit).
//     Top-C is an in-block 4 x 8-bit radix select over the table followed by
//     a shared-memory bitonic sort of the C winners.
// K2  stract_stage_b  replaces score_driver_batch_with_signals (:660) and the
//     unfused score_driver forms (:578, :648): one block per query over the
//     host-joined factor columns (Kd <= 4096), required-group mask + popcount,
//     a shared-memory bitonic sort for top-k, then the K3 tail on the top
//     sig_k columns. Bound by reading the i32[P, Kd] factors once.
// K3  stract_signals_q16  replaces compute_signals_from_factors_batch_q16
//     (:886): one block per (query, signal row); the [46, P] x [P, K] products
//     are evaluated entry by entry (P <= a few hundred) with a block absmax and
//     rintf (round half to even, like jnp.round) quantisation to int16.
//
//
// The same programs under the search path's other configurations:
//
// K1 on q8 rows (_decode_rows :162): stract_stage_a takes the row width. Width 2
//     is the 8-byte layout (w0 = doc << 7 | region << 3, w1 = f1q8 << 24 |
//     f2q8 << 16 | staticq8 << 8 | days8), read as one int2 and widened q8*257
//     into the q16 currency, so everything after the decode is K1 unchanged
//     over two thirds of the bytes.
// K1 with block-max UB (:337-343, :377-387, :837-847): ub_entry f32[B, P] and
//     ub_total f32[B]. Each seen entry adds (contrib - ub_entry) + U, U the
//     query's largest bound, as the reference folds it; the table counts a
//     doc's entries in the upper bits of its mask word (one more atomicAdd on a
//     word the insert already touches), and the select takes
//     (sum - n*U) + ub_total, the reference's own expression, so the only
//     rounding that differs from the reference is the order of the atomic
//     sum, as without UB.
// K11 stract_factors_join replaces factors_join (:749): per (slot, candidate)
//     a binary search of the candidate's doc in the slot's full doc-ascending
//     range of the postings on the card (the lockstep loop of :728-737 gives
//     what a per-thread lower bound gives). Bound by ~log2(len) dependent
//     random reads per pair; neighbouring threads search the same slot, so the
//     upper levels of each search come from L1/L2. stract_stage_b_joined
//     (score_driver_joined[_batch] :760, :770) and stract_signals_search
//     (compute_signals_joined* :894, :912, :922) run the same search inside
//     stage B and pass 2 and never write the [B, P, Kd] matrix: stage B holds
//     a candidate's P factors in registers, pass 2 a chunk of columns in
//     shared memory.
// K12 stract_signals_search with L > 0 replaces compute_signals[_batch]
//     (:492, :859): pass 2 from the first L rows of each slot only, by the
//     reference's fixed-step search over the [P, L] tile (_slot_factor_lookup
//     :450), step for step, so a tf-ordered impact slot gives the
//     reference's answer too.
// K13 stract_stage_a_merge replaces stage A under the reference's merge switch
//     (merge_sorted_tiles :286-312 with _bitonic_stages :260-283, fed by
//     _join_topk :345-366 from the [P, L] tiles of score_candidates_batch
//     :807): the P-way bitonic merge of the tiles, then the run-end tail of
//     _join_topk (:369-410) over the merged order. The network is a fixed
//     list of compare-exchanges (swap where the first key is greater; equal
//     keys never swap), so its output, payloads included, is a function of
//     its input alone, and the kernel follows it stage for stage: keys and
//     payloads come out bit-equal to the reference's, sorted or not (rows of
//     a tf-ordered impact slot are not ascending, and then neither is the
//     output). A query's P*L entries (65,536 x 12 B at the main shape) do not
//     fit one SM's shared memory, so stages whose compare distance fits a
//     MERGE_TILE-entry tile run inside a block (the first kernel also fetches
//     the posting rows and runs every round that fits a tile), and the longer
//     strides run as passes over global memory, one launch per stage. The
//     tail is one block per query: each thread walks a contiguous chunk of the
//     merged order, a segmented block scan carries each run's open sums across
//     chunks, every run end gets its score, and K1's radix select and bitonic
//     sort take the top C. Bound by the global passes over the B*P*L*12 B of
//     network state (about 11 launches at P = 64, L = 1024); a cluster with
//     distributed shared memory would keep more stages on chip.
// K10 stract_dense_rerank replaces rerank_topk[_batch] (ops/dense_rerank.py:18,
//     :31): one block per query, a warp per candidate row (dot product and
//     norm in one pass over the f16/bf16/f32 row), then the block's bitonic
//     select with ties to the lower index, as lax.top_k. Bound by reading the
//     B*K*H embedding rows once.
//
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_GROUPS = 32;
constexpr int EXCLUDED_GROUP = 63;
constexpr int NUM_REGIONS = 16;
constexpr int NUM_STATIC = 11;
constexpr int AUX_REGION_SHIFT = 12;
constexpr int AUX_DAYS_MASK = (1 << 12) - 1;
// largest top-C / Kd / page one block sorts in shared memory, and the most
// fused signal columns; ops/kernels.py checks both before a launch
constexpr int MAX_SORT = 4096;
constexpr int MAX_SIG_K = 64;
constexpr unsigned long long EXCL_BIT = 1ull << 32;
// UB scoring counts a doc's seen entries in the mask word above this bit
// (P*L <= 2^24 entries per query)
constexpr int CNT_SHIFT = 40;
// most signal rows and the widest embedding row the search / rerank kernels
// keep per block in static shared memory
constexpr int MAX_NSIG = 64;
constexpr int MAX_H = 1024;
// K13: entries per shared-memory tile of the merge network (12 B each:
// key, contribution, aux word), and the tail block's thread count
constexpr int MERGE_TILE = 8192;
constexpr int MERGE_THREADS = 1024;

}  // namespace

// Argument blocks, mirrored field by field by ctypes structures in
// ops/kernels.py. Per-query arrays are batch-major and contiguous.
struct SegArgs {
  const float* static_cols;     // [NUM_STATIC, db]
  const float* static_default;  // [db]
  const int* region_ids;        // [db]
  const float* last_updated;    // [db]
  long long db;
  float static_scale;
  int num_docs;
};

struct QueryArgs {
  const int* starts;           // [B, P]
  const int* lens;             // [B, P]
  const int* group;            // [B, P]
  const int* n_required;       // [B]
  const float* idf;            // [B, P]
  const float* w_bm25;         // [B, P]
  const float* w_bm25f;        // [B, P]
  const float* w_presence;     // [B, P]
  const float* static_coeffs;  // [B, NUM_STATIC]
  const float* region_lut;     // [B, NUM_REGIONS]
  const float* coeff_region;   // [B]
  const float* coeff_update;   // [B]
  const float* current_ts;     // [B]
  const float* soft_bonus;     // [B]
  int B;
  int P;
};

struct AggArgs {
  const float* bm25;           // [B, nsig, P]
  const float* bm25f;          // [B, 1, P]
  const float* idf;            // [B, nsig, P]
  const float* cov;            // [B, nsig, P]
  const int* static_of_sig;    // [nsig]: static column of a signal row, or -1
  int nsig;
  int bm25f_row;
  int region_row;
  int update_row;
};

namespace {

__device__ __forceinline__ unsigned order_key(float f) {
  // monotone float -> u32 map; every finite value lands above 0, which is
  // reserved for empty / invalid entries
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  const unsigned u = (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned hash_doc(int doc) {
  unsigned h = (unsigned)doc;
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}

// bm25_math.score_update_timestamp in f32, with jnp.floor_divide's
// (x - fmod(x, y)) / y form for the hour count
__device__ __forceinline__ float update_score(float ts, float now) {
  const float d = fmaxf(now - ts, 1.0f);
  const float m = fmodf(d, 3600.0f);
  const float hours = rintf((d - m) / 3600.0f);
  const float fresh = 72.0f / (hours + 72.0f);
  const bool valid = (ts < now) && (ts > 0.0f) && (hours < 26280.0f);
  return valid ? fresh : 0.0f;
}

__device__ __forceinline__ int clamp_region(int r) {
  return r < 0 ? 0 : (r > NUM_REGIONS - 1 ? NUM_REGIONS - 1 : r);
}

// ops/scoring.py _query_static: column-signal score of one doc
__device__ float query_static(const SegArgs& s, const QueryArgs& q, int b, int doc,
                              bool default_static) {
  float score;
  if (default_static) {
    score = s.static_default[doc];
  } else {
    const float* c = q.static_coeffs + (long long)b * NUM_STATIC;
    score = 0.0f;
    for (int i = 0; i < NUM_STATIC; ++i) score += c[i] * s.static_cols[(long long)i * s.db + doc];
  }
  const int r = clamp_region(s.region_ids[doc]);
  score = score + q.coeff_region[b] * q.region_lut[b * NUM_REGIONS + r];
  const float upd = update_score(s.last_updated[doc], q.current_ts[b]);
  return score + q.coeff_update[b] * upd;
}

// ops/scoring.py _aux_static_score: the same score carried in the row's aux word
__device__ float aux_static(const QueryArgs& q, int b, int aux, float static_scale) {
  const float st = (float)((aux >> 16) & 0xFFFF) * static_scale;
  const int region = (aux >> AUX_REGION_SHIFT) & 0xF;
  const float rs = q.region_lut[b * NUM_REGIONS + region];
  const float days = (float)(aux & AUX_DAYS_MASK);
  const float ts = days > 0.0f ? days * 86400.0f + 1577836800.0f : 0.0f;
  const float upd = update_score(ts, q.current_ts[b]);
  return st + q.coeff_region[b] * rs + q.coeff_update[b] * upd;
}

// descending bitonic sort of n (a power of two) keys with their payload,
// whole block cooperating; ends synchronised
__device__ void bitonic_desc(unsigned* key, int* idx, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned a = key[i], c = key[ixj];
          const bool desc = (i & k) == 0;
          if (desc ? (a < c) : (a > c)) {
            key[i] = c;
            key[ixj] = a;
            const int t = idx[i];
            idx[i] = idx[ixj];
            idx[ixj] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// the same sort with ties to the lower payload (lax.top_k's order): payloads
// are distinct, so the order is total and the result does not depend on the
// network
__device__ void bitonic_desc_stable(unsigned* key, int* idx, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned a = key[i], c = key[ixj];
          const int ia = idx[i], ic = idx[ixj];
          const bool i_first = a > c || (a == c && ia < ic);
          const bool desc = (i & k) == 0;
          if (desc ? !i_first : i_first) {
            key[i] = c;
            key[ixj] = a;
            idx[i] = ic;
            idx[ixj] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
}

// ops/scoring.py _decode_rows: posting row r of width W (3 = q16 rows, 2 = q8
// rows) in the q16 currency
__device__ __forceinline__ void decode_row(const int* __restrict__ postings, long long r, int W,
                                           int& doc, int& fac, int& aux) {
  if (W == 3) {
    const int* row = postings + r * 3;
    doc = row[0];
    fac = row[1];
    aux = row[2];
  } else {
    const int2 w = reinterpret_cast<const int2*>(postings)[r];
    const unsigned w0 = (unsigned)w.x, w1 = (unsigned)w.y;
    doc = (int)((w0 >> 7) & 0x1FFFFFFu);
    const unsigned f1 = ((w1 >> 24) & 0xFFu) * 257u, f2 = ((w1 >> 16) & 0xFFu) * 257u;
    const unsigned s16 = ((w1 >> 8) & 0xFFu) * 257u, days = (w1 & 0xFFu) * 16u;
    fac = (int)((f1 << 16) | f2);  // negative once f1 >= 32768, by design
    aux = (int)((s16 << 16) | (((w0 >> 3) & 0xFu) << AUX_REGION_SHIFT) | days);
  }
}

__device__ __forceinline__ int row_doc(const int* __restrict__ postings, long long r, int W) {
  return W == 3 ? postings[r * 3] : (int)(((unsigned)postings[r * 2] >> 7) & 0x1FFFFFFu);
}

__device__ __forceinline__ int row_factors(const int* __restrict__ postings, long long r, int W) {
  if (W == 3) return postings[r * 3 + 1];
  const unsigned w1 = (unsigned)postings[r * 2 + 1];
  return (int)(((((w1 >> 24) & 0xFFu) * 257u) << 16) | (((w1 >> 16) & 0xFFu) * 257u));
}

// ops/scoring.py _factors_join_one for one (slot, candidate): the packed
// factors of doc in the slot's doc-ascending range [start, start + len), 0 if
// absent. Offsets are 64-bit: start + len runs over all Ptot rows.
__device__ int join_lookup(const int* __restrict__ postings, long long n_rows, int W,
                           long long start, long long len, int doc) {
  long long lo = start, hi = start + len;
  const long long end = hi;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long r = mid < n_rows - 1 ? mid : n_rows - 1;
    if (row_doc(postings, r, W) < doc) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= end) return 0;
  const long long r = lo < n_rows - 1 ? lo : n_rows - 1;
  return row_doc(postings, r, W) == doc ? row_factors(postings, r, W) : 0;
}

// ops/scoring.py _gather_packed + _slot_factor_lookup for one (slot,
// candidate): the reference's fixed-step search over the slot's L-row tile
// (rows past min(len, L) hold the pad doc and no factors), step for step,
// whatever order the rows are in.
__device__ int prefix_lookup(const int* __restrict__ postings, long long n_rows, int W,
                             long long start, int len, int L, int steps, int doc, int num_docs) {
  const int vl = len < L ? len : L;
  auto tile_row = [&](int i) {
    long long r = start + i;
    r = r < 0 ? 0 : (r > n_rows - 1 ? n_rows - 1 : r);
    return r;
  };
  auto tile_doc = [&](int i) { return i < vl ? row_doc(postings, tile_row(i), W) : num_docs; };
  int lo = 0, hi = L;
  for (int st = 0; st < steps; ++st) {
    const int mid = (lo + hi) / 2;
    const int m = mid < 0 ? 0 : (mid > L - 1 ? L - 1 : mid);
    if (tile_doc(m) < doc) lo = mid + 1;
    else hi = mid;
  }
  const int pos = lo < 0 ? 0 : (lo > L - 1 ? L - 1 : lo);
  if (tile_doc(pos) != doc || pos >= vl) return 0;
  return row_factors(postings, tile_row(pos), W);
}

// the largest of a query's P per-slot bounds, by the calling warp
__device__ __forceinline__ float warp_max_bound(const float* __restrict__ ub, int P) {
  float m = -INFINITY;
  for (int p = threadIdx.x & 31; p < P; p += 32) m = fmaxf(m, ub[p]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// one entry of ops/scoring.py _signals_tail: signal row sg of the candidate
// whose factor column starts at fcol (stride between slots)
__device__ float signal_entry(int sg, const int* fcol, long long stride, int doc, int b,
                              const SegArgs& s, const QueryArgs& q, const AggArgs& a,
                              float inv_fs) {
  if (doc >= s.num_docs) return 0.0f;
  if (sg == a.region_row) return q.region_lut[b * NUM_REGIONS + clamp_region(s.region_ids[doc])];
  if (sg == a.update_row) return update_score(s.last_updated[doc], q.current_ts[b]);
  const int P = q.P;
  const float* idf = q.idf + (long long)b * P;
  const float* ab = a.bm25 + ((long long)b * a.nsig + sg) * P;
  const float* ai = a.idf + ((long long)b * a.nsig + sg) * P;
  const float* ac = a.cov + ((long long)b * a.nsig + sg) * P;
  const float* af = a.bm25f + (long long)b * P;
  const bool is_bm25f = sg == a.bm25f_row;
  float vb = 0.0f, vf = 0.0f, vi = 0.0f, vc = 0.0f;
  for (int p = 0; p < P; ++p) {
    const int f = fcol[p * stride];
    const float pres = f != 0 ? 1.0f : 0.0f;
    const float f1 = (float)((f >> 16) & 0xFFFF) * inv_fs;
    vb += ab[p] * (idf[p] * f1);
    if (is_bm25f) vf += af[p] * (idf[p] * ((float)(f & 0xFFFF) * inv_fs));
    vi += ai[p] * (idf[p] * pres);
    vc += ac[p] * pres;
  }
  float v = 0.0f + vb;
  if (is_bm25f) v = v + vf;
  v = v + vi;
  v = v + vc;
  const int st = a.static_of_sig[sg];
  v = v + (st >= 0 ? s.static_cols[(long long)st * s.db + doc] : 0.0f);
  return v;
}

// per-row absmax int16 quantisation of sv[nrows][n]: one warp per row
__device__ void quantize_rows(const float* sv, int nrows, int n, short* out_q, float* out_scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = warp; r < nrows; r += nw) {
    float m = 0.0f;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, fabsf(sv[r * n + j]));
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = fmaxf(m, 1e-30f) * (1.0f / 32767.0f);
    if (lane == 0) out_scale[r] = scale;
    for (int j = lane; j < n; j += 32) out_q[(long long)r * n + j] = (short)rintf(sv[r * n + j] / scale);
  }
}

// ---- K1 ---------------------------------------------------------------------
__global__ void stage_a_insert(const int* __restrict__ postings, long long n_rows, int W,
                               QueryArgs q, const float* __restrict__ ub_entry, int L,
                               float inv_fs, int* tkey, float* tsum,
                               unsigned long long* tmask, int* taux, int T) {
  __shared__ float sh_U;
  const int b = blockIdx.y;
  const int P = q.P;
  if (ub_entry != nullptr) {  // the same for the whole grid: no thread has left yet
    if (threadIdx.x < 32) {
      const float m = warp_max_bound(ub_entry + (long long)b * P, P);
      if (threadIdx.x == 0) sh_U = m;
    }
    __syncthreads();
  }
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P * L) return;
  const int p = e / L, l = e - p * L;
  const int bp = b * P + p;
  const int len = min(q.lens[bp], L);
  if (l >= len) return;
  long long st = q.starts[bp];
  st = st > n_rows - L ? n_rows - L : st;
  st = st < 0 ? 0 : st;
  int doc, fac, aux;
  decode_row(postings, st + l, W, doc, fac, aux);
  const float f1 = (float)((fac >> 16) & 0xFFFF) * inv_fs;
  const float f2 = (float)(fac & 0xFFFF) * inv_fs;
  float contrib = q.w_bm25[bp] * f1 + q.w_bm25f[bp] * f2 +
                  q.w_presence[bp] * (fac != 0 ? 1.0f : 0.0f);
  if (ub_entry != nullptr) contrib = (contrib - ub_entry[bp]) + sh_U;
  int* keys = tkey + (long long)b * T;
  unsigned h = hash_doc(doc) & (unsigned)(T - 1);
  while (true) {
    const int prev = atomicCAS(&keys[h], -1, doc);
    if (prev == -1 || prev == doc) break;
    h = (h + 1) & (unsigned)(T - 1);
  }
  const long long slot = (long long)b * T + h;
  atomicAdd(&tsum[slot], contrib);
  const int g = q.group[bp];
  const unsigned long long bit =
      g < MAX_GROUPS ? (1ull << g) : (g == EXCLUDED_GROUP ? EXCL_BIT : 0ull);
  if (bit) atomicOr(&tmask[slot], bit);
  if (ub_entry != nullptr) atomicAdd(&tmask[slot], 1ull << CNT_SHIFT);
  taux[slot] = aux;  // the aux word is a function of the doc: every writer agrees
}

// the K largest of a block's T ordered keys (0 = empty) into sk / si,
// descending, key ties in no set order: a 4 x 8-bit radix select of the K-th
// largest key, every key above it and enough ties, then the block's bitonic
// sort of those S (a power of two >= K). Called by the whole block after the
// keys are written and the block synchronised.
__device__ void top_keys(const unsigned* keys, int T, int K, int S, unsigned* sk,
                         int* si) {
  __shared__ unsigned hist[256];
  __shared__ unsigned sh_prefix, sh_krem, cnt_hi, cnt_tie;
  unsigned prefix = 0, mask = 0, krem = (unsigned)K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const unsigned k = keys[i];
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned cum = 0;
      int d = 255;
      for (; d > 0; --d) {
        if (cum + hist[d] >= krem) break;
        cum += hist[d];
      }
      sh_prefix = prefix | ((unsigned)d << shift);
      sh_krem = krem - cum;
    }
    __syncthreads();
    prefix = sh_prefix;
    krem = sh_krem;
    mask |= 255u << shift;
    __syncthreads();
  }

  // gather the K winners: every key above the threshold, then krem ties
  if (threadIdx.x == 0) {
    cnt_hi = 0;
    cnt_tie = 0;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    sk[i] = 0;
    si[i] = -1;
  }
  __syncthreads();
  const unsigned n_hi = (unsigned)K - krem;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const unsigned k = keys[i];
    if (k > prefix) {
      const unsigned pos = atomicAdd(&cnt_hi, 1u);
      sk[pos] = k;
      si[pos] = i;
    } else if (k == prefix) {
      const unsigned t = atomicAdd(&cnt_tie, 1u);
      if (t < krem) {
        sk[n_hi + t] = k;
        si[n_hi + t] = i;
      }
    }
  }
  __syncthreads();
  bitonic_desc(sk, si, S);
}

__global__ void __launch_bounds__(1024) stage_a_select(
    const int* __restrict__ tkey, const float* __restrict__ tsum,
    const unsigned long long* __restrict__ tmask, const int* __restrict__ taux,
    unsigned* __restrict__ skey, int T, SegArgs s, QueryArgs q,
    const float* __restrict__ ub_entry, const float* __restrict__ ub_total, int default_static,
    int soft_required, int K, int S, int* out_docs, float* out_scores) {
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  __shared__ float sh_U;
  const int b = blockIdx.x;
  const long long base = (long long)b * T;
  const int nreq = q.n_required[b];
  if (ub_entry != nullptr) {
    if (threadIdx.x < 32) {
      const float m = warp_max_bound(ub_entry + (long long)b * q.P, q.P);
      if (threadIdx.x == 0) sh_U = m;
    }
    __syncthreads();
  }

  // per-doc total and validity -> ordered key (0 = empty or invalid)
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int doc = tkey[base + i];
    unsigned key = 0;
    if (doc >= 0 && doc < s.num_docs) {
      const unsigned long long m = tmask[base + i];
      const int req = __popc((unsigned)(m & 0xFFFFFFFFull));
      bool valid = (m & EXCL_BIT) == 0;
      const float st = default_static ? aux_static(q, b, taux[base + i], s.static_scale)
                                      : query_static(s, q, b, doc, false);
      float text = tsum[base + i];
      if (ub_entry != nullptr)  // undo the per-entry +U, add the query's bound
        text = (text - (float)(m >> CNT_SHIFT) * sh_U) + ub_total[b];
      float total = text + st;
      if (soft_required) {
        total = total + q.soft_bonus[b] * (float)req;
      } else {
        valid = valid && req >= nreq;
      }
      if (valid) key = order_key(total);
    }
    skey[base + i] = key;
  }
  __syncthreads();

  top_keys(skey + base, T, K, S, sk, si);
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const unsigned k = sk[j];
    const bool ok = k != 0;
    out_docs[(long long)b * K + j] = ok ? tkey[base + si[j]] : s.num_docs;
    out_scores[(long long)b * K + j] = ok ? key_value(k) : -INFINITY;
  }
}

// ---- K13 ----------------------------------------------------------------------
// The network state of a query is three [N] rows (N = P*L): keys, the
// contributions and, when the static score reads them, the aux words (aux
// null: not carried). Pointers are generic, so the same steps run on a
// shared-memory tile and on global memory.

// one compare-exchange: swap where the first key is greater
__device__ __forceinline__ void merge_cx(int* k, float* c, int* a, long long i, long long j) {
  const int ki = k[i], kj = k[j];
  if (ki > kj) {
    k[i] = kj;
    k[j] = ki;
    const float t = c[i];
    c[i] = c[j];
    c[j] = t;
    if (a != nullptr) {
      const int u = a[i];
      a[i] = a[j];
      a[j] = u;
    }
  }
}

// the first stage of a round on the two h-entry rows at base and base + h:
// the reference folds the second row reversed behind the first and compares
// distance h apart, i.e. x of the first row with h-1-x of the second. Folded
// positions x and h-1-x touch the same four entries, so one thread does both
// and writes the folded layout in place.
__device__ __forceinline__ void merge_flip(int* k, float* c, int* a, long long base, int h,
                                           int x) {
  const long long i0 = base + x, i1 = base + 2 * h - 1 - x;
  const long long i2 = base + h + x, i3 = base + h - 1 - x;
  const int k0 = k[i0], k1 = k[i1], k2 = k[i2], k3 = k[i3];
  const bool s1 = k0 > k1, s2 = k3 > k2;
  k[i0] = s1 ? k1 : k0;
  k[i2] = s1 ? k0 : k1;
  k[i3] = s2 ? k2 : k3;
  k[i1] = s2 ? k3 : k2;
  const float c0 = c[i0], c1 = c[i1], c2 = c[i2], c3 = c[i3];
  c[i0] = s1 ? c1 : c0;
  c[i2] = s1 ? c0 : c1;
  c[i3] = s2 ? c2 : c3;
  c[i1] = s2 ? c3 : c2;
  if (a != nullptr) {
    const int a0 = a[i0], a1 = a[i1], a2 = a[i2], a3 = a[i3];
    a[i0] = s1 ? a1 : a0;
    a[i2] = s1 ? a0 : a1;
    a[i3] = s2 ? a2 : a3;
    a[i1] = s2 ? a3 : a2;
  }
}

// stage d of n entries at row: x against x + d inside blocks of 2d, by the block
__device__ __forceinline__ void merge_stage_block(int* k, float* c, int* a, int n, int d) {
  for (int u = threadIdx.x; u < n / 2; u += blockDim.x) {
    const int i = ((u & ~(d - 1)) << 1) | (u & (d - 1));
    merge_cx(k, c, a, i, i + d);
  }
}

// a full round in a tile: rows of h = m/2 entries merged pairwise
__device__ __forceinline__ void merge_round_block(int* k, float* c, int* a, int n, int m) {
  const int h = m >> 1;
  if (h == 1) {  // the reversal of a one-entry row is itself: a plain stage
    merge_stage_block(k, c, a, n, 1);
  } else {
    const int hh = h >> 1;
    for (int u = threadIdx.x; u < n / 4; u += blockDim.x)
      merge_flip(k, c, a, (long long)(u / hh) * 2 * h, h, u % hh);
  }
  __syncthreads();
  for (int d = h >> 1; d >= 1; d >>= 1) {
    merge_stage_block(k, c, a, n, d);
    __syncthreads();
  }
}

// One tile of `tile` entries of query blockIdx.y in shared memory. fetch:
// the tile's entries from the posting rows (stage A's fetch, contribution
// and key, as stage_a_insert computes them), else from the network rows.
// Then the stages cont_d .. 1 of a round whose longer strides ran in global
// memory, and the whole rounds m_lo .. m_hi (m the merged row length).
__global__ void __launch_bounds__(1024) merge_tile_kernel(
    const int* __restrict__ postings, long long n_rows, int W, QueryArgs q,
    const float* __restrict__ ub_entry, int L, float inv_fs, int num_docs, int* mkey,
    float* mcon, int* maux, int N, int tile, int fetch, int cont_d, int m_lo, int m_hi) {
  extern __shared__ int smem[];
  int* k = smem;
  float* c = reinterpret_cast<float*>(smem + tile);
  int* a = smem + 2 * tile;
  __shared__ float sh_U;
  const int b = blockIdx.y;
  const long long t0 = (long long)b * N + (long long)blockIdx.x * tile;
  if (fetch) {
    if (ub_entry != nullptr) {
      if (threadIdx.x < 32) {
        const float m = warp_max_bound(ub_entry + (long long)b * q.P, q.P);
        if (threadIdx.x == 0) sh_U = m;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      const int g = blockIdx.x * tile + e;
      const int p = g / L, l = g - p * L;
      const int bp = b * q.P + p;
      const bool valid = l < min(q.lens[bp], L);
      int doc = num_docs, fac = 0, aux = 0;
      if (valid) {
        long long st = q.starts[bp];
        st = st > n_rows - L ? n_rows - L : st;
        st = st < 0 ? 0 : st;
        decode_row(postings, st + l, W, doc, fac, aux);
      }
      const float f1 = (float)((fac >> 16) & 0xFFFF) * inv_fs;
      const float f2 = (float)(fac & 0xFFFF) * inv_fs;
      float contrib = q.w_bm25[bp] * f1 + q.w_bm25f[bp] * f2 +
                      q.w_presence[bp] * (fac != 0 ? 1.0f : 0.0f);
      if (ub_entry != nullptr) contrib = valid ? (contrib - ub_entry[bp]) + sh_U : 0.0f;
      k[e] = (doc << 6) | q.group[bp];
      c[e] = contrib;
      a[e] = aux;
    }
  } else {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      k[e] = mkey[t0 + e];
      c[e] = mcon[t0 + e];
      a[e] = maux != nullptr ? maux[t0 + e] : 0;
    }
  }
  __syncthreads();
  for (int d = cont_d; d >= 1; d >>= 1) {
    merge_stage_block(k, c, a, tile, d);
    __syncthreads();
  }
  for (int m = m_lo; m <= m_hi; m <<= 1) merge_round_block(k, c, a, tile, m);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    mkey[t0 + e] = k[e];
    mcon[t0 + e] = c[e];
    if (maux != nullptr) maux[t0 + e] = a[e];
  }
}

// the first stage of a round whose rows are longer than a tile (h = m/2)
__global__ void merge_flip_kernel(int* mkey, float* mcon, int* maux, int N, int h) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= N / 4) return;
  const int hh = h >> 1;
  const long long base = (long long)blockIdx.y * N + (u / hh) * 2 * h;
  merge_flip(mkey, mcon, maux, base, h, (int)(u % hh));
}

// a stage whose compare distance d is longer than half a tile
__global__ void merge_stage_kernel(int* mkey, float* mcon, int* maux, int N, int d) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= N / 2) return;
  const long long i = (long long)blockIdx.y * N + ((u / d) * 2 * d + u % d);
  merge_cx(mkey, mcon, maux, i, i + d);
}

// The run-end tail of _join_topk over the merged order, one block per query.
// An entry ends its (doc, group) pair where the next key differs and its doc
// where the next doc differs (the last entry ends both). Each thread walks a
// contiguous chunk twice: first for the sums of the run still open at the
// chunk's end, then, with what a segmented block scan of those carries in,
// for the score of each run it ends: the run's contribution sum (with UB,
// minus its entry count times U plus the query's ub_total), the static score
// of the run's last entry, its required pairs (soft bonus or the n_required
// mask) and its excluded pairs; 0 (no candidate) elsewhere. Then K1's top-C.
__global__ void __launch_bounds__(MERGE_THREADS) merge_tail_kernel(
    const int* mkey, const float* mcon, const int* maux, unsigned* skey, int N, SegArgs s,
    QueryArgs q, const float* __restrict__ ub_entry, const float* __restrict__ ub_total,
    int default_static, int soft_required, int K, int S, int* out_docs, float* out_scores) {
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  __shared__ float sh_U;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long row = (long long)b * N;
  if (ub_entry != nullptr) {
    if (tid < 32) {
      const float m = warp_max_bound(ub_entry + (long long)b * q.P, q.P);
      if (tid == 0) sh_U = m;
    }
    __syncthreads();
  }
  const int chunk = (N + nt - 1) / nt;
  const int lo = min(tid * chunk, N), hi = min(lo + chunk, N);
  auto ends = [&](int i, int key, bool& pair_end, bool& doc_end) {
    const int nxt = i + 1 < N ? mkey[row + i + 1] : 0;
    pair_end = i + 1 == N || nxt != key;
    doc_end = i + 1 == N || (nxt >> 6) != (key >> 6);
  };

  // pass 1: the run open at the chunk's end (sum, required and excluded
  // pairs, entries) and whether the chunk ends any run
  int has_end = 0, req = 0, excl = 0, cnt = 0;
  float sum = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const int key = mkey[row + i];
    bool pe, de;
    ends(i, key, pe, de);
    sum += mcon[row + i];
    cnt += 1;
    const int g = key & 63;
    if (pe) {
      req += g < MAX_GROUPS;
      excl += g == EXCLUDED_GROUP;
    }
    if (de) {
      has_end = 1;
      sum = 0.0f;
      req = excl = cnt = 0;
    }
  }
  // inclusive segmented scan of the chunk summaries (Hillis-Steele): a chunk
  // that ends a run restarts the carry, else it extends its left neighbour's
  float* c_sum = reinterpret_cast<float*>(sk);
  int* c_end = reinterpret_cast<int*>(sk) + nt;
  int* c_req = reinterpret_cast<int*>(sk) + 2 * nt;
  int* c_excl = reinterpret_cast<int*>(sk) + 3 * nt;
  int* c_cnt = si;
  c_sum[tid] = sum;
  c_end[tid] = has_end;
  c_req[tid] = req;
  c_excl[tid] = excl;
  c_cnt[tid] = cnt;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    float ps = 0.0f;
    int pe = 0, pr = 0, px = 0, pc = 0;
    if (tid >= off) {
      ps = c_sum[tid - off];
      pe = c_end[tid - off];
      pr = c_req[tid - off];
      px = c_excl[tid - off];
      pc = c_cnt[tid - off];
    }
    __syncthreads();
    if (tid >= off && !has_end) {
      sum = ps + sum;
      req += pr;
      excl += px;
      cnt += pc;
      has_end = pe;
    }
    c_sum[tid] = sum;
    c_end[tid] = has_end;
    c_req[tid] = req;
    c_excl[tid] = excl;
    c_cnt[tid] = cnt;
    __syncthreads();
  }
  // the carry into this chunk: the scan's value left of it
  float rsum = tid > 0 ? c_sum[tid - 1] : 0.0f;
  int rreq = tid > 0 ? c_req[tid - 1] : 0, rexcl = tid > 0 ? c_excl[tid - 1] : 0;
  int rcnt = tid > 0 ? c_cnt[tid - 1] : 0;

  // pass 2: every run end's ordered key
  const int nreq = q.n_required[b];
  for (int i = lo; i < hi; ++i) {
    const int key = mkey[row + i];
    bool pe, de;
    ends(i, key, pe, de);
    rsum += mcon[row + i];
    rcnt += 1;
    const int g = key & 63;
    if (pe) {
      rreq += g < MAX_GROUPS;
      rexcl += g == EXCLUDED_GROUP;
    }
    unsigned okey = 0;
    if (de) {
      const int doc = key >> 6;
      if (doc < s.num_docs && rexcl == 0) {
        float text = rsum;
        if (ub_entry != nullptr) text = (text - (float)rcnt * sh_U) + ub_total[b];
        const float st = default_static ? aux_static(q, b, maux[row + i], s.static_scale)
                                        : query_static(s, q, b, doc, false);
        float total = text + st;
        bool valid = true;
        if (soft_required) {
          total = total + q.soft_bonus[b] * (float)rreq;
        } else {
          valid = rreq >= nreq;
        }
        if (valid) okey = order_key(total);
      }
      rsum = 0.0f;
      rreq = rexcl = rcnt = 0;
    }
    skey[row + i] = okey;
  }
  __syncthreads();

  top_keys(skey + row, N, K, S, sk, si);
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const unsigned kk = sk[j];
    const bool ok = kk != 0;
    out_docs[(long long)b * K + j] = ok ? (mkey[row + si[j]] >> 6) : s.num_docs;
    out_scores[(long long)b * K + j] = ok ? key_value(kk) : -INFINITY;
  }
}

// ---- K2 ---------------------------------------------------------------------
__global__ void __launch_bounds__(1024) stage_b_kernel(
    const int* __restrict__ factors, const int* __restrict__ cand, int Kd, SegArgs s,
    QueryArgs q, AggArgs a, int default_static, float inv_fs, int k, int S, int ks,
    int* out_docs, float* out_scores, short* out_sq, float* out_scale) {
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  __shared__ int top_col[MAX_SIG_K];
  __shared__ int top_doc[MAX_SIG_K];
  const int b = blockIdx.x;
  const int P = q.P;
  const int* F = factors + (long long)b * P * Kd;
  const int* C = cand + (long long)b * Kd;
  const int* grp = q.group + (long long)b * P;
  const float* w1 = q.w_bm25 + (long long)b * P;
  const float* w2 = q.w_bm25f + (long long)b * P;
  const float* wp = q.w_presence + (long long)b * P;
  const int nreq = q.n_required[b];

  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    unsigned key = 0;
    if (c < Kd) {
      float text = 0.0f;
      unsigned m = 0;
      bool excl = false;
      for (int p = 0; p < P; ++p) {
        const int f = F[(long long)p * Kd + c];
        const bool pres = f != 0;
        const float f1 = (float)((f >> 16) & 0xFFFF) * inv_fs;
        const float f2 = (float)(f & 0xFFFF) * inv_fs;
        text += w1[p] * f1 + w2[p] * f2 + wp[p] * (pres ? 1.0f : 0.0f);
        const int g = grp[p];
        if (pres) {
          if (g < MAX_GROUPS) m |= 1u << g;
          else if (g == EXCLUDED_GROUP) excl = true;
        }
      }
      const int doc = C[c];
      const bool valid = doc < s.num_docs && __popc(m) >= nreq && !excl;
      if (valid) key = order_key(text + query_static(s, q, b, doc, default_static != 0));
    }
    sk[c] = key;
    si[c] = c;
  }
  __syncthreads();
  bitonic_desc(sk, si, S);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned key = sk[j];
    out_docs[(long long)b * k + j] = key ? C[si[j]] : s.num_docs;
    out_scores[(long long)b * k + j] = key ? key_value(key) : -INFINITY;
  }
  if (ks == 0) return;

  // K3 tail over the top ks columns, from the factors already in hand
  for (int j = threadIdx.x; j < ks; j += blockDim.x) {
    const bool ok = sk[j] != 0;
    top_col[j] = ok ? si[j] : 0;
    top_doc[j] = ok ? C[si[j]] : s.num_docs;
  }
  __syncthreads();
  float* sv = reinterpret_cast<float*>(sk);  // the sort keys are no longer needed
  for (int t = threadIdx.x; t < a.nsig * ks; t += blockDim.x) {
    const int sg = t / ks, j = t - sg * ks;
    sv[t] = signal_entry(sg, F + top_col[j], Kd, top_doc[j], b, s, q, a, inv_fs);
  }
  __syncthreads();
  quantize_rows(sv, a.nsig, ks, out_sq + (long long)b * a.nsig * ks, out_scale + (long long)b * a.nsig);
}

// ---- K3 ---------------------------------------------------------------------
__global__ void __launch_bounds__(256) signals_q16_kernel(
    const int* __restrict__ factors, const int* __restrict__ cand, int K, SegArgs s,
    QueryArgs q, AggArgs a, float inv_fs, short* out_q, float* out_scale) {
  __shared__ float sv[MAX_SORT];
  __shared__ float wmax[32];
  const int b = blockIdx.x, sg = blockIdx.y;
  const int* F = factors + (long long)b * q.P * K;
  float m = 0.0f;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float v = signal_entry(sg, F + j, K, cand[(long long)b * K + j], b, s, q, a, inv_fs);
    sv[j] = v;
    m = fmaxf(m, fabsf(v));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? wmax[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) wmax[0] = m;
  }
  __syncthreads();
  const float scale = fmaxf(wmax[0], 1e-30f) * (1.0f / 32767.0f);
  const long long row = (long long)b * a.nsig + sg;
  if (threadIdx.x == 0) out_scale[row] = scale;
  for (int j = threadIdx.x; j < K; j += blockDim.x) out_q[row * K + j] = (short)rintf(sv[j] / scale);
}

// ---- K11 ----------------------------------------------------------------------
// the join alone: out[b, p, c] = factors of cand[b, c] in slot (b, p)
__global__ void factors_join_kernel(const int* __restrict__ postings, long long n_rows, int W,
                                    const int* __restrict__ starts, const int* __restrict__ lens,
                                    const int* __restrict__ cand, int P, int Kd, int* out) {
  const int b = blockIdx.z, p = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Kd) return;
  const int bp = b * P + p;
  out[(long long)bp * Kd + c] =
      join_lookup(postings, n_rows, W, starts[bp], lens[bp], cand[(long long)b * Kd + c]);
}

// joined stage B, first half: one thread per candidate joins its P factors
// and folds them as stage_b_kernel does; the ordered key goes to skey[b, S]
__global__ void stage_b_joined_keys(const int* __restrict__ postings, long long n_rows, int W,
                                    const int* __restrict__ cand, int Kd, SegArgs s, QueryArgs q,
                                    int default_static, float inv_fs, int S, unsigned* skey) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= S) return;
  const int P = q.P;
  unsigned key = 0;
  if (c < Kd) {
    const int doc = cand[(long long)b * Kd + c];
    const int* st = q.starts + (long long)b * P;
    const int* ln = q.lens + (long long)b * P;
    const int* grp = q.group + (long long)b * P;
    const float* w1 = q.w_bm25 + (long long)b * P;
    const float* w2 = q.w_bm25f + (long long)b * P;
    const float* wp = q.w_presence + (long long)b * P;
    float text = 0.0f;
    unsigned m = 0;
    bool excl = false;
    for (int p = 0; p < P; ++p) {
      const int f = join_lookup(postings, n_rows, W, st[p], ln[p], doc);
      const bool pres = f != 0;
      const float f1 = (float)((f >> 16) & 0xFFFF) * inv_fs;
      const float f2 = (float)(f & 0xFFFF) * inv_fs;
      text += w1[p] * f1 + w2[p] * f2 + wp[p] * (pres ? 1.0f : 0.0f);
      const int g = grp[p];
      if (pres) {
        if (g < MAX_GROUPS) m |= 1u << g;
        else if (g == EXCLUDED_GROUP) excl = true;
      }
    }
    const bool valid = doc < s.num_docs && __popc(m) >= q.n_required[b] && !excl;
    if (valid) key = order_key(text + query_static(s, q, b, doc, default_static != 0));
  }
  skey[(long long)b * S + c] = key;
}

// second half: the block's bitonic sort of the S keys, top k out
__global__ void __launch_bounds__(1024) stage_b_joined_select(
    const unsigned* __restrict__ skey, const int* __restrict__ cand, int Kd, int num_docs, int k,
    int S, int* out_docs, float* out_scores) {
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  const int b = blockIdx.x;
  const int* C = cand + (long long)b * Kd;
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    sk[c] = skey[(long long)b * S + c];
    si[c] = c;
  }
  __syncthreads();
  bitonic_desc(sk, si, S);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const unsigned key = sk[j];
    out_docs[(long long)b * k + j] = key ? C[si[j]] : num_docs;
    out_scores[(long long)b * k + j] = key ? key_value(key) : -INFINITY;
  }
}

// ---- K11 in pass 2, and K12 ---------------------------------------------------
// One block per query. The candidates go through in chunks of CH columns:
// the block searches the chunk's P x CH factors into shared memory (the full
// range join, or with PREFIX the reference's L-row tile search), then
// evaluates the nsig x CH signal entries from them (K3's tail). f32 rows go
// straight out; q16 rows need each row's absmax first, so the chunks are
// walked twice: once for the absmax, once to quantise.
template <bool PREFIX>
__global__ void __launch_bounds__(512) signals_search_kernel(
    const int* __restrict__ postings, long long n_rows, int W, const int* __restrict__ cand, int K,
    int L, int steps, int CH, SegArgs s, QueryArgs q, AggArgs a, float inv_fs, float* out_f32,
    short* out_q, float* out_scale) {
  extern __shared__ int fac[];  // [P][CH]
  __shared__ unsigned amax[MAX_NSIG];
  const int b = blockIdx.x, P = q.P;
  const int* C = cand + (long long)b * K;
  const int* st = q.starts + (long long)b * P;
  const int* ln = q.lens + (long long)b * P;
  const bool quant = out_q != nullptr;
  for (int i = threadIdx.x; i < a.nsig; i += blockDim.x) amax[i] = 0u;
  __syncthreads();
  for (int pass = 0; pass < (quant ? 2 : 1); ++pass) {
    for (int c0 = 0; c0 < K; c0 += CH) {
      const int n = K - c0 < CH ? K - c0 : CH;
      for (int t = threadIdx.x; t < P * n; t += blockDim.x) {
        const int p = t / n, j = t - p * n;
        const int doc = C[c0 + j];
        fac[p * CH + j] = PREFIX
            ? prefix_lookup(postings, n_rows, W, st[p], ln[p], L, steps, doc, s.num_docs)
            : join_lookup(postings, n_rows, W, st[p], ln[p], doc);
      }
      __syncthreads();
      for (int t = threadIdx.x; t < a.nsig * n; t += blockDim.x) {
        const int sg = t / n, j = t - sg * n;
        const float v = signal_entry(sg, fac + j, CH, C[c0 + j], b, s, q, a, inv_fs);
        const long long o = ((long long)b * a.nsig + sg) * K + c0 + j;
        if (!quant) {
          out_f32[o] = v;
        } else if (pass == 0) {
          atomicMax(&amax[sg], __float_as_uint(fabsf(v)));  // non-negative floats order as bits
        } else {
          const float scale = fmaxf(__uint_as_float(amax[sg]), 1e-30f) * (1.0f / 32767.0f);
          out_q[o] = (short)rintf(v / scale);
        }
      }
      __syncthreads();
    }
    if (quant && pass == 0) {
      for (int i = threadIdx.x; i < a.nsig; i += blockDim.x)
        out_scale[(long long)b * a.nsig + i] =
            fmaxf(__uint_as_float(amax[i]), 1e-30f) * (1.0f / 32767.0f);
    }
  }
}

// ---- K10 ----------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(1024) dense_rerank_kernel(
    const T* __restrict__ emb, const float* __restrict__ qemb, const float* __restrict__ base,
    int K, int H, float weight, int k, int S, int* out_idx, float* out_scores) {
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  __shared__ float qv[MAX_H];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int h = threadIdx.x; h < H; h += blockDim.x) qv[h] = qemb[(long long)b * H + h];
  __syncthreads();
  for (int r = warp; r < S; r += nw) {
    unsigned key = 0;
    if (r < K) {
      const T* row = emb + ((long long)b * K + r) * H;
      float dot = 0.0f, ss = 0.0f;
      for (int h = lane; h < H; h += 32) {
        const float x = to_f32(row[h]);
        dot += x * qv[h];
        ss += x * x;
      }
      for (int o = 16; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      const float norm = sqrtf(ss);
      const float sim = norm > 1e-6f ? dot / fmaxf(norm, 1e-6f) : 0.0f;
      key = order_key(base[(long long)b * K + r] + weight * sim);
    }
    if (lane == 0) {
      sk[r] = key;
      si[r] = r;
    }
  }
  __syncthreads();
  bitonic_desc_stable(sk, si, S);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    out_idx[(long long)b * k + j] = si[j];
    out_scores[(long long)b * k + j] = key_value(sk[j]);
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// K1. postings i32[n_rows, row_w], row_w 3 (q16 rows) or 2 (q8 rows).
// ub_entry f32[B, P] and ub_total f32[B] (both or neither; null = no UB
// scoring). Scratch: tkey i32[B*T], tsum f32[B*T], tmask u64[B*T], taux
// i32[B*T], skey u32[B*T]; T a power of two >= max(2*P*L, K). Out: docs
// i32[B*K], scores f32[B*K], score-descending.
int stract_stage_a(const SegArgs* s, const QueryArgs* q, const int* postings, long long n_rows,
                   int row_w, const float* ub_entry, const float* ub_total, int L, int K, int T,
                   int default_static, int soft_required, float inv_fs, int* tkey, float* tsum,
                   unsigned long long* tmask, int* taux, unsigned* skey, int* out_docs,
                   float* out_scores, cudaStream_t stream) {
  if (K < 1 || K > MAX_SORT || T < K || (T & (T - 1)) != 0 || q->B < 1 ||
      (row_w != 2 && row_w != 3) || (ub_entry == nullptr) != (ub_total == nullptr) ||
      (long long)q->P * L >= (1ll << (64 - CNT_SHIFT)))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)q->B * (size_t)T;
  cudaError_t err = cudaMemsetAsync(tkey, 0xFF, n * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(tsum, 0, n * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(tmask, 0, n * sizeof(unsigned long long), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(taux, 0, n * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int entries = q->P * L;
  dim3 grid((entries + 255) / 256, q->B);
  stage_a_insert<<<grid, 256, 0, stream>>>(postings, n_rows, row_w, *q, ub_entry, L, inv_fs, tkey,
                                           tsum, tmask, taux, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_a_select<<<q->B, 1024, 0, stream>>>(tkey, tsum, tmask, taux, skey, T, *s, *q, ub_entry,
                                            ub_total, default_static, soft_required, K,
                                            next_pow2(K), out_docs, out_scores);
  return (int)cudaGetLastError();
}

// K13. Stage A through the merge network: P (a power of two >= 2) tiles of
// L (a power of two) posting rows per query, row_w as K1. Network rows mkey
// i32[B, N], mcon f32[B, N], maux i32[B, N] (N = P*L; maux null when
// default_static is 0); skey u32[B, N] scratch. K = 0 runs the network alone
// (the rows hold its output; skey, ub_total and the outputs may be null).
// Out: docs i32[B*K], scores f32[B*K], score-descending.
int stract_stage_a_merge(const SegArgs* s, const QueryArgs* q, const int* postings,
                         long long n_rows, int row_w, const float* ub_entry,
                         const float* ub_total, int L, int K, int default_static,
                         int soft_required, float inv_fs, int* mkey, float* mcon, int* maux,
                         unsigned* skey, int* out_docs, float* out_scores, cudaStream_t stream) {
  const int P = q->P;
  if (P < 2 || (P & (P - 1)) != 0 || L < 1 || (L & (L - 1)) != 0 ||
      (long long)P * L > (1ll << 24) || q->B < 1 || q->B > 65535 || K < 0 || K > MAX_SORT ||
      (row_w != 2 && row_w != 3) || n_rows < 1 || mkey == nullptr || mcon == nullptr ||
      (default_static && maux == nullptr) ||
      (K > 0 && ((ub_entry == nullptr) != (ub_total == nullptr) || skey == nullptr ||
                 out_docs == nullptr || out_scores == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int N = P * L;
  const int tile = N < MERGE_TILE ? N : MERGE_TILE;
  const size_t smem = (size_t)tile * 12;
  cudaError_t err = cudaFuncSetAttribute(merge_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the fetch, and every round whose merged rows fit a tile
  int m_hi = 0;
  for (int m = 2 * L; m <= tile; m <<= 1) m_hi = m;
  const dim3 tiles(N / tile, q->B);
  merge_tile_kernel<<<tiles, 1024, smem, stream>>>(postings, n_rows, row_w, *q, ub_entry, L,
                                                   inv_fs, s->num_docs, mkey, mcon, maux, N,
                                                   tile, 1, 0, 2 * L, m_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // longer rounds: the flip and the long strides in global memory, the rest
  // of the round in tiles
  for (int m = m_hi ? 2 * m_hi : 2 * L; m <= N; m <<= 1) {
    merge_flip_kernel<<<dim3((N / 4 + 255) / 256, q->B), 256, 0, stream>>>(mkey, mcon, maux, N,
                                                                         m / 2);
    int d = m / 4;
    for (; 2 * d > tile; d >>= 1)
      merge_stage_kernel<<<dim3((N / 2 + 255) / 256, q->B), 256, 0, stream>>>(mkey, mcon, maux,
                                                                            N, d);
    merge_tile_kernel<<<tiles, 1024, smem, stream>>>(postings, n_rows, row_w, *q, ub_entry, L,
                                                     inv_fs, s->num_docs, mkey, mcon, maux, N,
                                                     tile, 0, d, 1, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (K == 0) return (int)cudaSuccess;
  merge_tail_kernel<<<q->B, MERGE_THREADS, 0, stream>>>(
      mkey, mcon, default_static ? maux : nullptr, skey, N, *s, *q, ub_entry, ub_total,
      default_static, soft_required, K, next_pow2(K), out_docs, out_scores);
  return (int)cudaGetLastError();
}

// K2. factors i32[B, P, Kd], cand i32[B, Kd]; k = min(out_k, Kd) outputs per
// query; ks (0 = unfused) signal columns: out_sq i16[B, nsig, ks], out_scale
// f32[B, nsig].
int stract_stage_b(const SegArgs* s, const QueryArgs* q, const AggArgs* a, const int* factors,
                   const int* cand, int Kd, int default_static, float inv_fs, int k, int ks,
                   int* out_docs, float* out_scores, short* out_sq, float* out_scale,
                   cudaStream_t stream) {
  if (Kd < 1 || Kd > MAX_SORT || k < 1 || k > Kd || ks < 0 || ks > MAX_SIG_K || ks > k ||
      a->nsig * ks > MAX_SORT || q->B < 1)
    return (int)cudaErrorInvalidValue;
  stage_b_kernel<<<q->B, 1024, 0, stream>>>(factors, cand, Kd, *s, *q, *a, default_static, inv_fs, k,
                                            next_pow2(Kd), ks, out_docs, out_scores, out_sq, out_scale);
  return (int)cudaGetLastError();
}

// K3. factors i32[B, P, K], cand i32[B, K] -> q i16[B, nsig, K], scale f32[B, nsig].
int stract_signals_q16(const SegArgs* s, const QueryArgs* q, const AggArgs* a, const int* factors,
                       const int* cand, int K, float inv_fs, short* out_q, float* out_scale,
                       cudaStream_t stream) {
  if (K < 1 || K > MAX_SORT || q->B < 1 || a->nsig < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(q->B, a->nsig);
  signals_q16_kernel<<<grid, 256, 0, stream>>>(factors, cand, K, *s, *q, *a, inv_fs, out_q, out_scale);
  return (int)cudaGetLastError();
}

// K11. postings i32[n_rows, row_w]; starts, lens i32[B, P]; cand i32[B, Kd] ->
// out i32[B, P, Kd].
int stract_factors_join(const int* postings, long long n_rows, int row_w, const int* starts,
                        const int* lens, const int* cand, int B, int P, int Kd, int* out,
                        cudaStream_t stream) {
  if (B < 1 || B > 65535 || P < 1 || P > 65535 || Kd < 1 || n_rows < 1 ||
      (row_w != 2 && row_w != 3))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Kd + 255) / 256, P, B);
  factors_join_kernel<<<grid, 256, 0, stream>>>(postings, n_rows, row_w, starts, lens, cand, P, Kd,
                                                out);
  return (int)cudaGetLastError();
}

// K2 with K11 inside. cand i32[B, Kd]; scratch skey u32[B, S], S the power of
// two >= Kd; k = min(out_k, Kd) outputs per query.
int stract_stage_b_joined(const SegArgs* s, const QueryArgs* q, const int* postings,
                          long long n_rows, int row_w, const int* cand, int Kd, int default_static,
                          float inv_fs, int k, unsigned* skey, int* out_docs, float* out_scores,
                          cudaStream_t stream) {
  if (Kd < 1 || Kd > MAX_SORT || k < 1 || k > Kd || q->B < 1 || q->B > 65535 || n_rows < 1 ||
      (row_w != 2 && row_w != 3))
    return (int)cudaErrorInvalidValue;
  const int S = next_pow2(Kd);
  dim3 grid((S + 127) / 128, q->B);
  stage_b_joined_keys<<<grid, 128, 0, stream>>>(postings, n_rows, row_w, cand, Kd, *s, *q,
                                                default_static, inv_fs, S, skey);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_b_joined_select<<<q->B, 1024, 0, stream>>>(skey, cand, Kd, s->num_docs, k, S, out_docs,
                                                   out_scores);
  return (int)cudaGetLastError();
}

// K3 with K11 inside (L = 0: the full-range join) and K12 (L > 0: the first L
// rows of each slot, `steps` search steps). cand i32[B, K] -> out_f32
// f32[B, nsig, K], or (out_f32 null) out_q i16[B, nsig, K] with out_scale
// f32[B, nsig].
int stract_signals_search(const SegArgs* s, const QueryArgs* q, const AggArgs* a,
                          const int* postings, long long n_rows, int row_w, const int* cand, int K,
                          int L, int steps, float inv_fs, float* out_f32, short* out_q,
                          float* out_scale, cudaStream_t stream) {
  if (K < 1 || q->B < 1 || q->P < 1 || q->P > 8192 || a->nsig < 1 || a->nsig > MAX_NSIG ||
      n_rows < 1 || (row_w != 2 && row_w != 3) || L < 0 || (L > 0 && steps < 1) ||
      (out_f32 == nullptr) == (out_q == nullptr) || (out_q != nullptr && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  // a chunk's P x CH factors stay under 32 KB of shared memory
  int CH = 8192 / q->P;
  if (CH >= 32) CH &= ~31;
  if (CH > K) CH = K;
  const size_t smem = (size_t)q->P * CH * sizeof(int);
  if (L > 0)
    signals_search_kernel<true><<<q->B, 512, smem, stream>>>(
        postings, n_rows, row_w, cand, K, L, steps, CH, *s, *q, *a, inv_fs, out_f32, out_q,
        out_scale);
  else
    signals_search_kernel<false><<<q->B, 512, smem, stream>>>(
        postings, n_rows, row_w, cand, K, L, steps, CH, *s, *q, *a, inv_fs, out_f32, out_q,
        out_scale);
  return (int)cudaGetLastError();
}

// K10. emb [B, K, H] of dtype 0 = f32, 1 = f16, 2 = bf16; qemb f32[B, H];
// base f32[B, K] -> out_idx i32[B, k], out_scores f32[B, k], score-descending,
// ties to the lower index.
int stract_dense_rerank(const void* emb, int dtype, const float* qemb, const float* base, int B,
                        int K, int H, float weight, int k, int* out_idx, float* out_scores,
                        cudaStream_t stream) {
  if (B < 1 || K < 1 || K > MAX_SORT || H < 1 || H > MAX_H || k < 1 || k > K || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int S = next_pow2(K);
  if (dtype == 0)
    dense_rerank_kernel<float><<<B, 1024, 0, stream>>>(
        (const float*)emb, qemb, base, K, H, weight, k, S, out_idx, out_scores);
  else if (dtype == 1)
    dense_rerank_kernel<__half><<<B, 1024, 0, stream>>>(
        (const __half*)emb, qemb, base, K, H, weight, k, S, out_idx, out_scores);
  else
    dense_rerank_kernel<__nv_bfloat16><<<B, 1024, 0, stream>>>(
        (const __nv_bfloat16*)emb, qemb, base, K, H, weight, k, S, out_idx, out_scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
