// Hand-written Hopper kernels for the three device programs of the search
// path (stract_tpu/ops/scoring.py). Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false -shared
// into a plain C library bound with ctypes. Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// K1  stract_stage_a  replaces score_candidates_batch (ops/scoring.py:807):
//     candidate scan + join by doc + top-C, one launch a batch, or two
//     where some of its queries' tables fit shared memory and others do not
//     (ops/kernels.py stage_a_launches: each launch names its queries, so a
//     long query never moves the short ones' tables off chip). A query's
//     work is its E = sum_p min(len_p, L) posting rows (about 4,500 of the
//     P*L = 65,536 the reference tiles at the smoke's shape), so the join is
//     a hash table sized from E (T = the power of two >= 3E/2 slots of doc,
//     text sum, mask word and aux word, 20 B each), held in the shared
//     memory of a thread block cluster: each of the query's blocks owns T /
//     cluster slots and reaches the others' through distributed shared
//     memory; one block where that is the whole cluster, and global memory,
//     still sized from E, for queries past 8 blocks' shared memory (E >
//     43,690 rows at C = 4,096; ops/kernels.py stage_a_plan picks): there
//     memsets clear the n x T slots and a full-grid kernel inserts every
//     entry at once, a doc's text sum an integer of 2^-shift units (the
//     shift from the query's bound, so no sum overflows) added by 64-bit
//     atomics: the same bits in any order, the exact sum of its f32
//     contributions rounded once; the cluster kernel then keeps each
//     block's keys in shared memory for the select. In shared memory the
//     kernel clears its own table, and a doc
//     belongs to the block that owns its first probe's slot: every block
//     reads each used slot's rows (the next slot's prefetched) and inserts
//     the docs it owns with shared-memory atomics, a block barrier after
//     each slot. A posting list holds a doc once, so a doc gets at most one
//     add a slot, in slot order, from one block, and two calls give the same
//     bits. A window that the clamp to n_rows - L moved onto the rows before
//     its list may hold a doc twice; each block's first warp walks such a
//     slot in row order, adding a doc's rows together first
//     (__match_any_sync). Then the shared top-K below over the cluster's
//     slots, ties to the lower doc, each block writing its winners in place.
//     Bound by latency: at the smoke's shape the rows are ~50 KB a query,
//     and the time is the slots' barriers, the sort of the C winners and
//     the ranks across the cluster.
// K2  stract_stage_b  replaces score_driver_batch_with_signals (:660) and the
//     unfused score_driver forms (:578, :648): a cluster of blocks a query
//     (4 at Kd = 4,096), each folding Kd / cluster host-joined factor
//     columns (required-group mask + popcount), the shared top-K of the k
//     winners, sorted on the cluster's first block, then the K3 tail over
//     the top sig_k columns with their P factor words staged in shared
//     memory once (each signal entry summed over p in the same order).
//     Bound by reading the i32[P, Kd] factors once.
// Top-K (K1, K2, K13's tail, K9, the joined K2): `top_keys` over keys held
//     by one block or by a cluster's blocks, in the order key descending,
//     ties to the lower payload (doc, column or index). Zero keys (empty or
//     invalid) enter no histogram. Where every block's nonzero keys fit its
//     sort buffer, all are sorted and those placed past K dropped (the
//     smoke's K1 and K2); else a 4 x 8-bit radix select of the K-th, whose
//     histograms take one shared atomic per distinct digit of a warp
//     (__match_any_sync), and of the keys equal to it those with the lowest
//     payloads win (in index order where the payloads rise with it: K2,
//     K13's tail, K9, the joined K2; else, K1's docs, by a second radix
//     select over their payloads where more tie than win), so both regimes
//     give the same winners, whatever slots K1's hash table gave them. Each
//     block sorts its winners (bitonic, the stages
//     under 32 apart in registers by shuffles) and places each by binary
//     searches of the other blocks' sorted runs, staged in its shared
//     memory, so no block sorts the whole of them.
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
//     rounding that differs from the reference is the order of the sum
//     (slot order), as without UB.
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
//     chunks, every run end gets its score, and the shared top-K takes the
//     top C (ties to the lower position). Bound by the global passes over the
//     B*P*L*12 B of network state (about 11 launches at P = 64, L = 1024),
//     and by the tail's chunk walk (most of its time); a
//     cluster with distributed shared memory would keep more stages on chip.
// K10 stract_dense_rerank replaces rerank_topk[_batch] (ops/dense_rerank.py:18,
//     :31): one block per query, a warp per candidate row (dot product and
//     norm in one pass over the f16/bf16/f32 row), then the block's bitonic
//     select with ties to the lower index, as lax.top_k. Bound by reading the
//     B*K*H embedding rows once.
// K9  stract_mesh_topk replaces the merge of the mesh's search programs
//     (stract_tpu/parallel/search.py:40-44 and :83-85: the all-gather of each
//     shard's top K, then lax.top_k over the n*K gathered scores): one block
//     per query keeps the n*K <= 8,192 scores as ordered keys in shared
//     memory, and the shared top-K keeps lax.top_k's set (the radix select's
//     k-th, keys equal to it taken in index order by a block-wide count) in
//     its order (ties to the lower index). Latency-bound: the work is 8,192 entries a query
//     (about 64 KB read), a few microseconds of bytes; the select's four
//     passes and the sort's 55 stages of block barriers set its time.
//
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// K1 and K2: threads a block, the most blocks a query's cluster takes, the
// bytes of a K1 table slot (doc, text sum, mask word, aux word), the dynamic
// shared memory a block may take (ops/kernels.py plans within it), and the
// most factor words K2 stages for its signal tail
constexpr int SELECT_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;
constexpr int TABLE_SLOT_BYTES = 20;
constexpr int MAX_DYN_SMEM = 224 * 1024;
constexpr int TAIL_STAGE_WORDS = 16384;
constexpr unsigned FULL_MASK = 0xffffffffu;

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

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

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
// whole block cooperating, ties to the lower payload (lax.top_k's order):
// payloads are distinct, so the order is total and the result does not
// depend on the network; ends synchronised
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

// ops/scoring.py _decode_rows: a posting row's words (W = 3: q16 rows, w2
// the aux word; W = 2: q8 rows) in the q16 currency
__device__ __forceinline__ void decode_words(int W, int w0_, int w1_, int w2, int& doc, int& fac,
                                             int& aux) {
  if (W == 3) {
    doc = w0_;
    fac = w1_;
    aux = w2;
  } else {
    const unsigned w0 = (unsigned)w0_, w1 = (unsigned)w1_;
    doc = (int)((w0 >> 7) & 0x1FFFFFFu);
    const unsigned f1 = ((w1 >> 24) & 0xFFu) * 257u, f2 = ((w1 >> 16) & 0xFFu) * 257u;
    const unsigned s16 = ((w1 >> 8) & 0xFFu) * 257u, days = (w1 & 0xFFu) * 16u;
    fac = (int)((f1 << 16) | f2);  // negative once f1 >= 32768, by design
    aux = (int)((s16 << 16) | (((w0 >> 3) & 0xFu) << AUX_REGION_SHIFT) | days);
  }
}

// posting row r of width W in the q16 currency
__device__ __forceinline__ void decode_row(const int* __restrict__ postings, long long r, int W,
                                           int& doc, int& fac, int& aux) {
  if (W == 3) {
    const int* row = postings + r * 3;
    decode_words(3, row[0], row[1], row[2], doc, fac, aux);
  } else {
    const int2 w = reinterpret_cast<const int2*>(postings)[r];
    decode_words(2, w.x, w.y, 0, doc, fac, aux);
  }
}

// a load issued where it stands (a prefetch the compiler may not sink to its
// use)
__device__ __forceinline__ int load_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
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

// ---- the shared top-K --------------------------------------------------------
// The blocks that share one selection: one block (K9, K13's tail) or a thread
// block cluster (K1, K2), whose blocks each hold a part of the keys and reach
// each other's shared memory.
struct BlockScope {
  __device__ __forceinline__ void sync() { __syncthreads(); }
  __device__ __forceinline__ unsigned rank() { return 0; }
  __device__ __forceinline__ unsigned size() { return 1; }
  template <class T>
  __device__ __forceinline__ T* at(T* p, unsigned) { return p; }
};

struct ClusterScope {
  __device__ __forceinline__ void sync() { cg::this_cluster().sync(); }
  __device__ __forceinline__ unsigned rank() { return cg::this_cluster().block_rank(); }
  __device__ __forceinline__ unsigned size() { return cg::this_cluster().num_blocks(); }
  template <class T>
  __device__ __forceinline__ T* at(T* p, unsigned r) {
    return cg::this_cluster().map_shared_rank(p, (int)r);
  }
};

// a block's shared state of one selection (read by the other blocks of a
// cluster: the histograms and the counts)
struct SelectState {
  unsigned hist[2][256];  // a radix pass's digit counts, two passes apart
  unsigned tot[256];      // the scope's counts of the pass
  unsigned cnt[3];        // this block's nonzero keys and keys equal to the K-th;
                          // its winners gathered so far
  unsigned bc[2];         // the pass's prefix and values left to take
  unsigned woff[33];      // warp offsets of an ordered count of ties
  unsigned nloc;          // this block's winners
  unsigned runs[MAX_CLUSTER];  // every block's winners, read once
};

// one shared atomic per distinct digit of the warp's active keys (called by
// all 32 lanes)
__device__ __forceinline__ void warp_hist_add(unsigned* hist, unsigned d, bool active) {
  const unsigned act = __ballot_sync(FULL_MASK, active);
  if (active) {
    const unsigned peers = __match_any_sync(act, d);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[d], (unsigned)__popc(peers));
  }
}

// the block's count of its items i < n where pred(i), into *out; ends
// synchronised
template <class Pred>
__device__ void block_count(int n, Pred pred, unsigned* out) {
  if (threadIdx.x == 0) *out = 0;
  __syncthreads();
  unsigned c = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) c += pred(i) ? 1u : 0u;
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL_MASK, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(out, c);
  __syncthreads();
}

// warp 0: the digit of st.tot (the scope's counts) whose bin holds the
// krem-th largest value, each lane taking 8 bins from the top → st.bc
__device__ void pick_digit(SelectState& st, unsigned prefix, unsigned krem, int shift) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned v[8], sum = 0;
  for (int j = 0; j < 8; ++j) {
    v[j] = st.tot[255 - 8 * lane - j];
    sum += v[j];
  }
  unsigned incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned hit = __ballot_sync(FULL_MASK, incl >= krem);
  if (lane == (hit ? __ffs(hit) - 1 : 31)) {
    unsigned cum = incl - sum;
    int d = 0;
    for (int j = 0; j < 8; ++j) {
      d = 255 - 8 * lane - j;
      if (cum + v[j] >= krem || d == 0) break;
      cum += v[j];
    }
    st.bc[0] = prefix | ((unsigned)d << shift);
    st.bc[1] = krem - cum;
  }
}

// the rank of this thread's item among the block's items in thread order
// where pred holds, after the running base (which advances by the chunk's
// count); every thread of the block calls, one chunk of blockDim.x items at
// a time
__device__ __forceinline__ unsigned ordered_rank(bool pred, unsigned& base, SelectState& st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(FULL_MASK, pred);
  if (lane == 0) st.woff[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const unsigned v = lane < nw ? st.woff[lane] : 0u;
    unsigned incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += t;
    }
    st.woff[lane] = incl - v;
    if (lane == 31) st.woff[32] = incl;
  }
  __syncthreads();
  const unsigned r = base + st.woff[warp] + __popc(ballot & ((1u << lane) - 1u));
  base += st.woff[32];
  __syncthreads();
  return r;
}

// A winner as one 64-bit word: the key above the payload's complement, so
// the words' descending order is the key's, ties to the lower payload (a
// total order where payloads are distinct; the pad, key 0 and payload -1, is
// the word 0).
__device__ __forceinline__ unsigned long long pack_entry(unsigned key, int payload) {
  return ((unsigned long long)key << 32) | (unsigned)~(unsigned)payload;
}
__device__ __forceinline__ unsigned entry_key(unsigned long long e) { return (unsigned)(e >> 32); }
__device__ __forceinline__ int entry_payload(unsigned long long e) {
  return (int)~(unsigned)(e & 0xFFFFFFFFull);
}

// kv[0, n), n a power of two, sorted descending by the whole block: the
// bitonic network's stages of compare distance >= 32 through shared memory,
// the shorter ones of each merge in registers by shuffles (a warp holds 32
// consecutive entries). Ends synchronised.
__device__ void sort_desc(unsigned long long* kv, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = kv[i], c = kv[ixj];
          if (((i & k) == 0) == (a < c)) {
            kv[i] = c;
            kv[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      unsigned long long a = i < n ? kv[i] : 0ull;
      for (int jj = j; jj > 0; jj >>= 1) {
        const unsigned long long b = __shfl_xor_sync(FULL_MASK, a, jj);
        // the lower place of a descending pair keeps the larger word
        if ((((i & jj) == 0) == ((i & k) == 0)) == (b > a)) a = b;
      }
      if (i < n) kv[i] = a;
    }
    __syncthreads();
  }
}

// The K largest nonzero keys of a scope (each block its part keys[0, n); 0 =
// no candidate) with payload(i) beside key i, in the order key descending,
// ties to the lower payload (payloads distinct and >= 0: a total order);
// emit(pos, key, payload) is called once for each winner, pos its place in
// that order. The nonzero keys are counted. Where every block's fit its sort
// buffer (kv: next_pow2(K) entries), all of them are sorted and placed, and
// those placed past K dropped: the winners are exactly the first K of the
// order. Else a 4 x 8-bit radix select over them finds the K-th (each pass:
// warp-aggregated histograms, the scope's summed), and every key above it
// wins; of the keys equal to it, those with the lowest payloads: where
// BY_INDEX (the payloads rise with the scope's index order: block rank, then
// position) the first of them in that order, by an ordered count; else
// found by a second radix select over their payloads where more tie than
// win. So the winners are the first K of the order in both regimes. Each block sorts
// its own winners and places each by its count of the other blocks' winners
// that sort before it: binary searches of their sorted runs, copied first
// into `stage` (stage_cap entries of this block's shared memory) where they
// fit, else read where they lie. Every thread of every block calls, after
// its keys are written and the block synchronised. → the winners, min(K,
// nonzero keys).
template <bool BY_INDEX, class Scope, class Payload, class Emit>
__device__ int top_keys(Scope& scope, SelectState& st, const unsigned* keys, int n, int K,
                        Payload payload, unsigned long long* kv, Emit emit,
                        unsigned long long* stage = nullptr, int stage_cap = 0) {
  const unsigned rank = scope.rank(), nb = scope.size();
  const int tid = threadIdx.x;
  if (tid < 256) {
    st.hist[0][tid] = 0;
    st.hist[1][tid] = 0;
  }
  if (tid == 0) st.cnt[2] = 0;
  block_count(n, [&](int i) { return keys[i] != 0u; }, &st.cnt[0]);
  scope.sync();
  unsigned total = 0, most = 0;
  for (unsigned r = 0; r < nb; ++r) {
    const unsigned c = scope.at(st.cnt, r)[0];
    total += c;
    most = max(most, c);
  }
  // the krem-th largest value(i) over the scope's items where take(i), digit
  // by digit (the histograms alternate over every pass of the call) → its
  // value; krem then holds how many equal to it are taken
  int pass = 0;
  auto radix = [&](auto value, auto take, unsigned& krem) {
    unsigned prefix = 0, mask = 0;
    for (int shift = 24; shift >= 0; shift -= 8, ++pass) {
      unsigned* h = st.hist[pass & 1];
      for (int i0 = 0; i0 < n; i0 += blockDim.x) {
        const int i = i0 + tid;
        const bool on = i < n && take(i);
        const unsigned v = on ? value(i) : 0u;
        warp_hist_add(h, (v >> shift) & 255u, on && (v & mask) == prefix);
      }
      __syncthreads();
      scope.sync();
      if (tid < 256) {  // every block sums the same counts and picks the same digit
        unsigned sum = 0;
        for (unsigned r = 0; r < nb; ++r) sum += scope.at(h, r)[tid];
        st.tot[tid] = sum;
        st.hist[(pass + 1) & 1][tid] = 0;  // read by the others a pass ago
      }
      __syncthreads();
      pick_digit(st, prefix, krem, shift);
      __syncthreads();
      prefix = st.bc[0];
      krem = st.bc[1];
      mask |= 255u << shift;
    }
    return prefix;
  };
  // the winners: every key above kth (kth 0: every nonzero key), and the
  // keys equal to it whose complemented payload is at least pthr. Where every
  // block's nonzero keys fit its sort buffer, they all enter the sort and
  // the places past K are dropped: no select
  unsigned kth = 0, pthr = 0, krem = 0, tie_rank = 0;
  if (total > (unsigned)K && most > (unsigned)next_pow2(K)) {
    krem = (unsigned)K;
    kth = radix([&](int i) { return keys[i]; }, [&](int i) { return keys[i] != 0u; }, krem);
    block_count(n, [&](int i) { return keys[i] == kth; }, &st.cnt[1]);
    scope.sync();
    unsigned ties = 0;
    for (unsigned r = 0; r < nb; ++r) {
      const unsigned c = scope.at(st.cnt, r)[1];
      ties += c;
      if (r < rank) tie_rank += c;  // the ties before this block's
    }
    if (!BY_INDEX && ties > krem)  // the krem lowest payloads among them
      pthr = radix([&](int i) { return ~(unsigned)payload(i); },
                   [&](int i) { return keys[i] == kth; }, krem);
  }
  // this block's winners, in no set order (one atomic a warp)
  const int lane = tid & 31;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    const unsigned k = i < n ? keys[i] : 0u;
    bool win = k > kth;
    if (kth != 0u) {
      if (BY_INDEX) {  // the first krem ties in index order
        const bool tie = i < n && k == kth;
        if (__syncthreads_or(tie)) {
          const unsigned r = ordered_rank(tie, tie_rank, st);
          win = win || (tie && r < krem);
        }
      } else {
        win = win || (k == kth && ~(unsigned)payload(i) >= pthr);
      }
    }
    const unsigned w = __ballot_sync(FULL_MASK, win);
    unsigned first = 0;
    if (lane == 0 && w) first = atomicAdd(&st.cnt[2], (unsigned)__popc(w));
    first = __shfl_sync(FULL_MASK, first, 0);
    if (win) kv[first + __popc(w & ((1u << lane) - 1u))] = pack_entry(k, payload(i));
  }
  __syncthreads();
  const int n_loc = (int)st.cnt[2], S = next_pow2(n_loc > 0 ? n_loc : 1);
  for (int i = n_loc + tid; i < S; i += blockDim.x) kv[i] = 0ull;
  if (tid == 0) st.nloc = (unsigned)n_loc;
  __syncthreads();
  sort_desc(kv, S);
  scope.sync();
  if (tid < (int)nb) st.runs[tid] = *scope.at(&st.nloc, (unsigned)tid);
  __syncthreads();
  // the other blocks' runs, staged here in rank order where they fit
  int others = 0;
  for (unsigned r = 0; r < nb; ++r)
    if (r != rank) others += (int)st.runs[r];
  const bool staged = nb > 1 && others <= stage_cap;
  if (staged) {  // every remote load of a thread issued before its stores
    for (int i0 = 0; i0 < others; i0 += 4 * blockDim.x) {
      unsigned long long e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int i = i0 + u * blockDim.x + tid;
        if (i >= others) continue;
        unsigned r = 0;
        for (;; ++r) {  // the run that holds concatenated entry i
          if (r == rank) continue;
          if (i < (int)st.runs[r]) break;
          i -= (int)st.runs[r];
        }
        e[u] = scope.at(kv, r)[i];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * blockDim.x + tid;
        if (i < others) stage[i] = e[u];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < n_loc; i += blockDim.x) {
    const unsigned long long e = kv[i];
    int pos = i;
    for (unsigned r = 0, off = 0; r < nb; ++r) {
      if (r == rank) continue;
      const int m = (int)st.runs[r];
      const unsigned long long* run = staged ? stage + off : scope.at(kv, r);
      int lo = 0, hi = m;  // the run's entries above e: a descending run
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run[mid] > e) lo = mid + 1;
        else hi = mid;
      }
      pos += lo;
      off += m;
    }
    if (pos < K) emit(pos, entry_key(e), entry_payload(e));
  }
  scope.sync();  // the runs stay in place until every block has read them
  return total > (unsigned)K ? K : (int)total;
}

// ---- K1 ---------------------------------------------------------------------
// A slot's weights: its rows' contributions and its group's mask bit.
struct SlotWeights {
  float w1, w2, wp, ub;
  unsigned long long bit;
};

__device__ __forceinline__ SlotWeights slot_weights(const QueryArgs& q, const float* ub_entry,
                                                    int bp) {
  const int g = q.group[bp];
  return SlotWeights{q.w_bm25[bp], q.w_bm25f[bp], q.w_presence[bp],
                     ub_entry != nullptr ? ub_entry[bp] : 0.0f,
                     g < MAX_GROUPS ? (1ull << g) : (g == EXCLUDED_GROUP ? EXCL_BIT : 0ull)};
}

// ops/scoring.py _stage_a_entries: a row's contribution (UB: (c - ub) + U)
__device__ __forceinline__ float entry_contrib(const SlotWeights& w, int fac, float inv_fs,
                                               bool ub, float U) {
  const float f1 = (float)((fac >> 16) & 0xFFFF) * inv_fs;
  const float f2 = (float)(fac & 0xFFFF) * inv_fs;
  const float c = w.w1 * f1 + w.w2 * f2 + w.wp * (fac != 0 ? 1.0f : 0.0f);
  return ub ? (c - w.ub) + U : c;
}

// The global table's fixed-point unit for query b, 2^-shift: 2 E (|c|max +
// U) (a bound on any doc's sum of entries) stays under 2^62. The calling
// warp, each lane the same result; every kernel that reads the sums calls
// it on the same inputs.
__device__ int fixed_shift(const QueryArgs& q, const float* ub_entry, int b, int L,
                           float inv_fs, float U) {
  const float fmax = 65535.0f * inv_fs;
  float m = 0.0f, e = 0.0f;
  for (int p = threadIdx.x & 31; p < q.P; p += 32) {
    const int bp = b * q.P + p;
    const float ub_p = ub_entry != nullptr ? fabsf(ub_entry[bp]) : 0.0f;
    m = fmaxf(m, (fabsf(q.w_bm25[bp]) + fabsf(q.w_bm25f[bp])) * fmax + fabsf(q.w_presence[bp]) +
                     ub_p);
    e += (float)min(max(q.lens[bp], 0), L);
  }
  for (int o = 16; o > 0; o >>= 1) {  // the same tree on every lane: the same bits
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
    e += __shfl_xor_sync(FULL_MASK, e, o);
  }
  int ex = 0;
  frexpf(2.0f * fmaxf(e, 1.0f) * (m + fabsf(U)), &ex);
  return min(max(62 - ex, -100), 100);
}

// The global form's inserts (tables cleared by the caller: keys -1, sums and
// masks 0): a thread an entry (p, l) of the launch's j-th query, over the
// whole grid; a doc's text sum an integer of 2^-shift units added by 64-bit
// atomics (the same bits in any order: the exact sum of the doc's f32
// contributions), its mask bits ORed and entry count added to its mask word.
__global__ void __launch_bounds__(256) stage_a_global_insert(
    const int* __restrict__ postings, long long n_rows, int W, QueryArgs q,
    const int* __restrict__ rows, const float* __restrict__ ub_entry, int L, float inv_fs,
    int T, int* gkey, unsigned long long* gsum, unsigned long long* gmask, int* gaux) {
  __shared__ float sh_U, sh_scale;
  const int b = rows != nullptr ? rows[blockIdx.y] : (int)blockIdx.y, P = q.P;
  if (threadIdx.x < 32) {
    const float U = ub_entry != nullptr ? warp_max_bound(ub_entry + (long long)b * P, P) : 0.0f;
    const int shift = fixed_shift(q, ub_entry, b, L, inv_fs, U);
    if (threadIdx.x == 0) {
      sh_U = U;
      sh_scale = ldexpf(1.0f, shift);
    }
  }
  __syncthreads();
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)P * L) return;
  const int p = (int)(e / L), l = (int)(e - (long long)p * L), bp = b * P + p;
  if (l >= min(q.lens[bp], L)) return;
  long long st = q.starts[bp];
  st = st > n_rows - L ? n_rows - L : st;
  st = st < 0 ? 0 : st;
  int doc, fac, aux;
  decode_row(postings, st + l, W, doc, fac, aux);
  const SlotWeights w = slot_weights(q, ub_entry, bp);
  const long long v =
      __float2ll_rn(entry_contrib(w, fac, inv_fs, ub_entry != nullptr, sh_U) * sh_scale);
  const long long base = (long long)blockIdx.y * T;
  unsigned h = hash_doc(doc) & (unsigned)(T - 1);
  while (true) {
    const int prev = atomicCAS(gkey + base + h, -1, doc);
    if (prev == -1 || prev == doc) break;
    h = (h + 1) & (unsigned)(T - 1);
  }
  atomicAdd(gsum + base + h, (unsigned long long)v);
  if (w.bit) atomicOr(gmask + base + h, w.bit);
  if (ub_entry != nullptr) atomicAdd(gmask + base + h, 1ull << CNT_SHIFT);
  gaux[base + h] = aux;  // a function of the doc
}

// One cluster a query (grid (cluster, n)): the launch's j-th query is query
// rows[j] of the batch (rows null: query j). T slots a query, T / cluster a
// block: in the block's dynamic shared memory after the sort buffers, where
// the kernel clears and fills them, or (gkey not null) row j of the global
// [n, T] tables, filled by stage_a_global_insert, block r's part the slots
// [r T / cluster, (r + 1) T / cluster). Probing runs over the whole table,
// so it ends (the table holds more slots than the query has entries).
__global__ void __launch_bounds__(SELECT_THREADS, 1) stage_a_kernel(
    const int* __restrict__ postings, long long n_rows, int W, SegArgs s, QueryArgs q,
    const int* __restrict__ rows, const float* __restrict__ ub_entry,
    const float* __restrict__ ub_total, int L, float inv_fs, int T, int default_static,
    int soft_required, int K, int* gkey, unsigned long long* gsum, unsigned long long* gmask,
    int* gaux, int keys_on_chip, int* out_docs, float* out_scores) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelectState st;
  __shared__ float sh_U;
  __shared__ double sh_unscale;
  ClusterScope scope;
  const unsigned CS = scope.size(), rank = scope.rank();
  const int b = rows != nullptr ? rows[blockIdx.y] : (int)blockIdx.y, P = q.P, tid = threadIdx.x;
  const int Tl = T / (int)CS, lg_tl = __ffs(Tl) - 1, S = next_pow2(K);
  unsigned long long* kv = reinterpret_cast<unsigned long long*>(dyn_smem);  // [S] winners
  const bool on_chip = gkey == nullptr;
  // the part in shared memory (the shared-space atomics of the local inserts)
  unsigned long long* s_mask = kv + S;
  int* s_key = reinterpret_cast<int*>(s_mask + Tl);
  float* s_sum = reinterpret_cast<float*>(s_key + Tl);
  int* s_aux = reinterpret_cast<int*>(s_sum + Tl);
  // the query's row of the global tables
  const long long gbase = (long long)blockIdx.y * T;
  int* g_key = on_chip ? nullptr : gkey + gbase;
  unsigned long long* g_sum = on_chip ? nullptr : gsum + gbase;
  unsigned long long* g_mask = on_chip ? nullptr : gmask + gbase;
  int* g_aux = on_chip ? nullptr : gaux + gbase;
  const long long mine = (long long)rank * Tl;
  unsigned long long* my_mask = on_chip ? s_mask : g_mask + mine;
  int* my_key = on_chip ? s_key : g_key + mine;
  int* my_aux = on_chip ? s_aux : g_aux + mine;

  const int* lens = q.lens + (long long)b * P;
  const int* starts = q.starts + (long long)b * P;
  if (on_chip) {
    for (int i = tid; i < Tl; i += blockDim.x) {
      s_key[i] = -1;
      s_mask[i] = 0ull;
      s_sum[i] = 0.0f;
    }
  }
  if (tid < 32) {
    const float U = ub_entry != nullptr ? warp_max_bound(ub_entry + (long long)b * P, P) : 0.0f;
    if (!on_chip) {
      const int shift = fixed_shift(q, ub_entry, b, L, inv_fs, U);
      if (tid == 0) sh_unscale = ldexp(1.0, -shift);
    }
    if (tid == 0) sh_U = U;
  }
  __syncthreads();
  scope.sync();  // every part cleared before any block inserts

  if (on_chip) {  // the global table was filled before the launch
    // the used slots in order: each warp keeps the used bits of a window of
    // 32 slots, read by one ballot (the calls come in order of p)
    const int warp = tid >> 5, lane = tid & 31;
    const unsigned cnt1 = ub_entry != nullptr ? 1u : 0u;
    int win = -32;
    unsigned win_used = 0;
    auto next_used = [&](int p) {
      while (p < P) {
        if (p >= win + 32) {
          win = p & ~31;
          win_used = __ballot_sync(FULL_MASK, win + lane < P && lens[win + lane] > 0);
        }
        const unsigned m = win_used & (~0u << (p - win));
        if (m) return win + __ffs(m) - 1;
        p = win + 32;
      }
      return P;
    };
    auto window = [&](int p) {  // the first row the slot's window reads
      const long long st0 = starts[p];
      const long long st = st0 > n_rows - L ? n_rows - L : st0;
      return st < 0 ? 0ll : st;
    };
    auto contrib = [&](const SlotWeights& w, int fac) {
      return entry_contrib(w, fac, inv_fs, ub_entry != nullptr, sh_U);
    };
    // A doc's entries are all inserted by one block, the owner of its first
    // probe's slot, whatever parts the probe then runs through: every block
    // reads each used slot's rows and takes the docs it owns, with a block
    // barrier after each slot, so a doc's adds come in slot order; the probes
    // stay in the block's own part but where they run past its end.
    // claim slot i of block r for doc or find it there, and add an entry:
    // only the claim races (other docs probing the slot); the doc's own
    // words have one writer a slot, its owner's thread of the doc's row
    auto add = [&](int* kp, float* sp, unsigned long long* mp, int* ap, int doc, float c,
                   unsigned long long bits, unsigned cnt, int aux) {
      const int prev = atomicCAS(kp, -1, doc);
      if (prev != -1 && prev != doc) return false;
      *sp = *sp + c;
      *mp = (*mp | bits) + ((unsigned long long)cnt << CNT_SHIFT);
      *ap = aux;  // a function of the doc
      return true;
    };
    auto insert = [&](int doc, float c, unsigned long long bits, unsigned cnt, int aux) {
      unsigned h = hash_doc(doc) & (unsigned)(T - 1);
      for (int probe = 0; probe < T; ++probe, h = (h + 1) & (unsigned)(T - 1)) {
        const unsigned r = h >> lg_tl, i = h & (unsigned)(Tl - 1);
        if (r == rank) {  // the shared-space atomics of the local inserts
          if (add(s_key + i, s_sum + i, s_mask + i, s_aux + i, doc, c, bits, cnt, aux)) return;
        } else if (add(scope.at(s_key, r) + i, scope.at(s_sum, r) + i, scope.at(s_mask, r) + i,
                       scope.at(s_aux, r) + i, doc, c, bits, cnt, aux)) {
          __threadfence();  // done before the block's next slot
          return;
        }
      }
    };
    auto owned = [&](int doc) {
      return ((hash_doc(doc) & (unsigned)(T - 1)) >> lg_tl) == rank;
    };
    // each thread's first row of the next used slot is fetched while the
    // current one is inserted
    int p = next_used(0);
    int n0 = 0, n1 = 0, n2 = 0;  // the raw words of this thread's row of the next slot
    auto fetch = [&](int p) {
      if (p < P && tid < min(lens[p], L)) {
        const int* row = postings + (window(p) + tid) * W;
        n0 = load_now(row);
        n1 = load_now(row + 1);
        n2 = W == 3 ? load_now(row + 2) : 0;
      }
    };
    fetch(p);
    while (p < P) {
      const int pn = next_used(p + 1);
      int doc0, fac0, aux0;
      decode_words(W, n0, n1, n2, doc0, fac0, aux0);
      fetch(pn);
      const SlotWeights w = slot_weights(q, ub_entry, b * P + p);
      const int len = min(lens[p], L);
      const long long st = window(p);
      if (st == starts[p]) {  // the list's own rows: each doc once
        for (int l = tid; l < len; l += blockDim.x) {
          int doc = doc0, fac = fac0, aux = aux0;
          if (l != tid) decode_row(postings, st + l, W, doc, fac, aux);
          if (owned(doc)) insert(doc, contrib(w, fac), w.bit, cnt1, aux);
        }
      } else if (warp == 0) {
        // a clamped window may hold a doc twice: each block's first warp walks
        // it in row order, 32 rows a step, a doc's rows of a step summed in row
        // order by the lowest of its lanes, which inserts
        for (int l0 = 0; l0 < len; l0 += 32) {
          const int l = l0 + lane;
          int doc = -1, fac = 0, aux = 0;
          if (l < len) decode_row(postings, st + l, W, doc, fac, aux);
          const bool own = l < len && owned(doc);
          const float c = own ? contrib(w, fac) : 0.0f;
          const unsigned act = __ballot_sync(FULL_MASK, own);
          const unsigned peers = own ? __match_any_sync(act, doc) : 0u;
          float sum = 0.0f;
          for (int j = 0; j < 32; ++j) {
            const float cj = __shfl_sync(FULL_MASK, c, j);
            if ((peers >> j) & 1u) sum += cj;
          }
          if (own && lane == __ffs(peers) - 1) insert(doc, sum, w.bit, cnt1 * __popc(peers), aux);
          __syncwarp();
        }
      }
      __syncthreads();
      p = pn;
    }
  }
  scope.sync();  // every block's inserts in place

  // each slot's ordered key (0 = empty or invalid), in place of its aux word,
  // or in shared memory after the sort buffers (keys_on_chip: the global
  // form's, then the other blocks' runs after them)
  const int nreq = q.n_required[b];
  unsigned* okey = keys_on_chip ? reinterpret_cast<unsigned*>(kv + S)
                                : reinterpret_cast<unsigned*>(my_aux);
  for (int i = tid; i < Tl; i += blockDim.x) {
    const int doc = my_key[i];
    unsigned key = 0;
    if (doc >= 0 && doc < s.num_docs) {
      const unsigned long long m = my_mask[i];
      const int req = __popc((unsigned)(m & 0xFFFFFFFFull));
      bool valid = (m & EXCL_BIT) == 0;
      const float stat = default_static ? aux_static(q, b, my_aux[i], s.static_scale)
                                        : query_static(s, q, b, doc, false);
      float text = on_chip ? s_sum[i]
                           : __double2float_rn(__ll2double_rn((long long)g_sum[mine + i]) *
                                               sh_unscale);
      if (ub_entry != nullptr)  // undo the per-entry +U, add the query's bound
        text = (text - (float)(m >> CNT_SHIFT) * sh_U) + ub_total[b];
      float total = text + stat;
      if (soft_required) {
        total = total + q.soft_bonus[b] * (float)req;
      } else {
        valid = valid && req >= nreq;
      }
      if (valid) key = order_key(total);
    }
    okey[i] = key;
  }
  __syncthreads();

  // each block writes its winners in place; ties to the lower doc (the
  // other blocks' runs staged over the table part, dead by then, or after
  // the keys)
  unsigned long long* stage =
      on_chip ? s_mask : keys_on_chip ? reinterpret_cast<unsigned long long*>(okey + Tl) : nullptr;
  const int stage_cap = on_chip ? Tl * TABLE_SLOT_BYTES / 8 : keys_on_chip ? S : 0;
  const int n_w = top_keys<false>(scope, st, okey, Tl, K, [&](int i) { return my_key[i]; }, kv,
                                  [&](int pos, unsigned k, int doc) {
                                    out_docs[(long long)b * K + pos] = doc;
                                    out_scores[(long long)b * K + pos] = key_value(k);
                                  },
                                  stage, stage_cap);
  if (rank != 0) return;
  for (int j = n_w + tid; j < K; j += blockDim.x) {
    out_docs[(long long)b * K + j] = s.num_docs;
    out_scores[(long long)b * K + j] = -INFINITY;
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
// and key, as stage_a_kernel computes them), else from the network rows.
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
    int default_static, int soft_required, int K, int* out_docs, float* out_scores) {
  __shared__ unsigned long long kv[MAX_SORT];  // the top-K's winners; first the scan's
  __shared__ SelectState sel;
  __shared__ float sh_U;
  unsigned* sk = reinterpret_cast<unsigned*>(kv);
  int* si = reinterpret_cast<int*>(kv) + MAX_SORT;
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

  BlockScope scope;
  const int n_w = top_keys<true>(scope, sel, skey + row, N, K, [](int i) { return i; }, kv,
                           [&](int pos, unsigned k, int i) {
                             out_docs[(long long)b * K + pos] = mkey[row + i] >> 6;
                             out_scores[(long long)b * K + pos] = key_value(k);
                           });
  for (int j = n_w + threadIdx.x; j < K; j += blockDim.x) {
    out_docs[(long long)b * K + j] = s.num_docs;
    out_scores[(long long)b * K + j] = -INFINITY;
  }
}

// ---- K2 ---------------------------------------------------------------------
// One cluster a query (grid (cluster, B)): block r folds the columns [r per,
// (r + 1) per), per = ceil(Kd / cluster), into ordered keys; the shared top-K
// gathers the k winners on the first block, which writes the outputs and runs
// the K3 tail. Dynamic shared memory: sort keys and payloads (next_pow2(k)
// each), the other blocks' sorted runs (Kd each), the block's keys (per),
// the signal rows (nsig x ks floats) and, when staged, the winners' factor
// words [P][ks].
__global__ void __launch_bounds__(SELECT_THREADS, 1) stage_b_kernel(
    const int* __restrict__ factors, const int* __restrict__ cand, int Kd, SegArgs s,
    QueryArgs q, AggArgs a, int default_static, float inv_fs, int k, int ks, int staged,
    int* out_docs, float* out_scores, short* out_sq, float* out_scale) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelectState st;
  __shared__ int top_col[MAX_SIG_K];
  __shared__ int top_doc[MAX_SIG_K];
  ClusterScope scope;
  const unsigned CS = scope.size(), rank = scope.rank();
  const int b = blockIdx.y, P = q.P, tid = threadIdx.x;
  const int S = next_pow2(k), per = (Kd + (int)CS - 1) / (int)CS;
  const int c0 = (int)rank * per, n = max(0, min(Kd, c0 + per) - c0);
  unsigned long long* kv = reinterpret_cast<unsigned long long*>(dyn_smem);  // [S] winners
  unsigned long long* stage = kv + S;  // [Kd]: the other blocks' runs
  unsigned* kl = reinterpret_cast<unsigned*>(stage + Kd);
  float* sig = reinterpret_cast<float*>(kl + per);
  int* fac = reinterpret_cast<int*>(sig + a.nsig * ks);
  const int* F = factors + (long long)b * P * Kd;
  const int* C = cand + (long long)b * Kd;
  const int* grp = q.group + (long long)b * P;
  const float* w1 = q.w_bm25 + (long long)b * P;
  const float* w2 = q.w_bm25f + (long long)b * P;
  const float* wp = q.w_presence + (long long)b * P;
  const int nreq = q.n_required[b];

  for (int i = tid; i < n; i += blockDim.x) {
    const int c = c0 + i;
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
    kl[i] = valid ? order_key(text + query_static(s, q, b, doc, default_static != 0)) : 0u;
  }
  __syncthreads();
  // each block writes its winners in place, the first ks also to the first
  // block's signal columns; ties to the lower column
  const int n_w = top_keys<true>(scope, st, kl, n, k, [&](int i) { return c0 + i; }, kv,
                           [&](int pos, unsigned key, int c) {
                             out_docs[(long long)b * k + pos] = C[c];
                             out_scores[(long long)b * k + pos] = key_value(key);
                             if (pos < ks) {
                               scope.at(top_col, 0)[pos] = c;
                               scope.at(top_doc, 0)[pos] = C[c];
                             }
                           },
                           stage, Kd);
  if (rank != 0) return;
  for (int j = n_w + tid; j < k; j += blockDim.x) {
    out_docs[(long long)b * k + j] = s.num_docs;
    out_scores[(long long)b * k + j] = -INFINITY;
  }
  if (ks == 0) return;

  // K3 tail over the top ks columns: their factor words staged once
  for (int j = n_w + tid; j < ks; j += blockDim.x) {
    top_col[j] = 0;
    top_doc[j] = s.num_docs;
  }
  __syncthreads();
  if (staged) {
    for (int t = tid; t < P * ks; t += blockDim.x) {
      const int p = t / ks, j = t - p * ks;
      fac[t] = F[(long long)p * Kd + top_col[j]];
    }
    __syncthreads();
  }
  for (int t = tid; t < a.nsig * ks; t += blockDim.x) {
    const int sg = t / ks, j = t - sg * ks;
    sig[t] = staged ? signal_entry(sg, fac + j, ks, top_doc[j], b, s, q, a, inv_fs)
                    : signal_entry(sg, F + top_col[j], Kd, top_doc[j], b, s, q, a, inv_fs);
  }
  __syncthreads();
  quantize_rows(sig, a.nsig, ks, out_sq + (long long)b * a.nsig * ks, out_scale + (long long)b * a.nsig);
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

// second half: the shared top-K of the Kd keys (K2's selection, so the
// outputs equal K2's over the same factors), top k out
__global__ void __launch_bounds__(1024) stage_b_joined_select(
    const unsigned* __restrict__ skey, const int* __restrict__ cand, int Kd, int num_docs, int k,
    int S, int* out_docs, float* out_scores) {
  __shared__ unsigned long long kv[MAX_SORT];
  __shared__ SelectState sel;
  const int b = blockIdx.x;
  const int* C = cand + (long long)b * Kd;
  BlockScope scope;
  const int n_w = top_keys<true>(scope, sel, skey + (long long)b * S, Kd, k,
                                 [](int i) { return i; }, kv, [&](int pos, unsigned key, int c) {
                             out_docs[(long long)b * k + pos] = C[c];
                             out_scores[(long long)b * k + pos] = key_value(key);
                           });
  for (int j = n_w + threadIdx.x; j < k; j += blockDim.x) {
    out_docs[(long long)b * k + j] = num_docs;
    out_scores[(long long)b * k + j] = -INFINITY;
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

// ---- K9 -----------------------------------------------------------------------
// the gathered entries of one query (N = n shards x K, shard-major) and the
// top k, in lax.top_k's order
constexpr int MESH_MAX_N = 8192;
constexpr int MESH_MAX_K = 1024;

// one block per query: the N gathered scores as ordered keys in shared
// memory, the stable top k, then each winner's doc and shard (index / K)
__global__ void __launch_bounds__(1024) mesh_topk_kernel(
    const float* __restrict__ scores, const int* __restrict__ docs, int N, int K, int k,
    int* __restrict__ out_docs, int* __restrict__ out_shards, float* __restrict__ out_scores) {
  __shared__ unsigned keys[MESH_MAX_N];
  __shared__ unsigned long long kv[MESH_MAX_K];
  __shared__ SelectState sel;
  const long long base = (long long)blockIdx.x * N;
  // -0 and +0 compare equal in lax.top_k: one key for both (a -0 comes out +0)
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float x = scores[base + i];
    keys[i] = order_key(x == 0.0f ? 0.0f : x);
  }
  __syncthreads();
  // every key is nonzero (order_key maps each float above 0), so k of them
  // win: those above the k-th and its ties in index order, sorted with ties
  // to the lower index
  BlockScope scope;
  top_keys<true>(scope, sel, keys, N, k, [](int i) { return i; }, kv,
                 [&](int pos, unsigned key, int i) {
                   const long long o = (long long)blockIdx.x * k + pos;
                   out_docs[o] = docs[base + i];
                   out_shards[o] = i / K;
                   out_scores[o] = key_value(key);
                 });
}

// a launch of kernel over (cluster x B) blocks of SELECT_THREADS threads in
// clusters of `cluster`, with smem bytes of dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int cluster, int B, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(SELECT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool cluster_ok(int cluster) {
  return cluster >= 1 && cluster <= MAX_CLUSTER && (cluster & (cluster - 1)) == 0;
}

}  // namespace

extern "C" {

// K1. postings i32[n_rows, row_w], row_w 3 (q16 rows) or 2 (q8 rows).
// ub_entry f32[B, P] and ub_total f32[B] (both or neither; null = no UB
// scoring). The launch scores n queries of the batch: rows i32[n] (on the
// card) names them, null = all B in order (n = B). T (a power of two) table
// slots a query over a cluster of `cluster` blocks (a power of two <=
// MAX_CLUSTER): in shared memory (gkey null; T / cluster slots of 20 B and
// the sort buffers within MAX_DYN_SMEM), else in the global tables gkey
// i32[n*T], gsum i64[n*T] (fixed-point sums), gmask u64[n*T], gaux
// i32[n*T], which the call clears (memsets) and fills (stage_a_global_insert)
// before the cluster kernel's select. T must exceed each named query's sum_p min(len_p, L)
// entries. Out: docs i32[B*K], scores f32[B*K], score-descending, written in
// the named queries' rows.
int stract_stage_a(const SegArgs* s, const QueryArgs* q, const int* postings, long long n_rows,
                   int row_w, const int* rows, int n, const float* ub_entry,
                   const float* ub_total, int L, int K, int T, int cluster, int default_static,
                   int soft_required, float inv_fs, int* gkey, unsigned long long* gsum,
                   unsigned long long* gmask, int* gaux, int* out_docs, float* out_scores,
                   cudaStream_t stream) {
  const bool global = gkey != nullptr;
  if (K < 1 || K > MAX_SORT || q->B < 1 || q->B > 65535 || q->P < 1 || L < 1 || n_rows < 1 ||
      n < 1 || n > q->B || (rows == nullptr && n != q->B) ||
      (row_w != 2 && row_w != 3) || (ub_entry == nullptr) != (ub_total == nullptr) ||
      (long long)q->P * L >= (1ll << (64 - CNT_SHIFT)) || !cluster_ok(cluster) || T < cluster ||
      (T & (T - 1)) != 0 || (global && (gsum == nullptr || gmask == nullptr || gaux == nullptr)))
    return (int)cudaErrorInvalidValue;
  // the global form keeps the block's keys and the other blocks' runs in
  // shared memory where they fit beside the sort buffers
  const size_t S8 = (size_t)next_pow2(K) * 8, keys = (size_t)(T / cluster) * 4 + S8;
  const int keys_on_chip = global && S8 + keys <= (size_t)MAX_DYN_SMEM;
  const size_t smem = S8 + (global ? (keys_on_chip ? keys : 0)
                                   : (size_t)(T / cluster) * TABLE_SLOT_BYTES);
  if (smem > (size_t)MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  if (global) {  // the tables cleared, then every entry inserted at once
    const size_t slots = (size_t)n * T;
    cudaError_t err = cudaMemsetAsync(gkey, 0xFF, slots * 4, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(gsum, 0, slots * 8, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(gmask, 0, slots * 8, stream);
    if (err != cudaSuccess) return (int)err;
    const long long entries = (long long)q->P * L;
    stage_a_global_insert<<<dim3((unsigned)((entries + 255) / 256), n), 256, 0, stream>>>(
        postings, n_rows, row_w, *q, rows, ub_entry, L, inv_fs, T, gkey, gsum, gmask, gaux);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_clusters(stage_a_kernel, cluster, n, smem, stream, postings, n_rows,
                              row_w, *s, *q, rows, ub_entry, ub_total, L, inv_fs, T,
                              default_static, soft_required, K, gkey, gsum, gmask, gaux,
                              keys_on_chip, out_docs, out_scores);
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
      default_static, soft_required, K, out_docs, out_scores);
  return (int)cudaGetLastError();
}

// K2. factors i32[B, P, Kd], cand i32[B, Kd]; k = min(out_k, Kd) outputs per
// query; ks (0 = unfused) signal columns: out_sq i16[B, nsig, ks], out_scale
// f32[B, nsig]; `cluster` blocks a query (a power of two <= MAX_CLUSTER and
// <= Kd).
int stract_stage_b(const SegArgs* s, const QueryArgs* q, const AggArgs* a, const int* factors,
                   const int* cand, int Kd, int default_static, float inv_fs, int k, int ks,
                   int cluster, int* out_docs, float* out_scores, short* out_sq,
                   float* out_scale, cudaStream_t stream) {
  if (Kd < 1 || Kd > MAX_SORT || k < 1 || k > Kd || ks < 0 || ks > MAX_SIG_K || ks > k ||
      a->nsig * ks > MAX_SORT || q->B < 1 || q->B > 65535 || q->P < 1 || !cluster_ok(cluster) ||
      cluster > Kd)
    return (int)cudaErrorInvalidValue;
  const int per = (Kd + cluster - 1) / cluster;
  const bool staged = (long long)q->P * ks <= TAIL_STAGE_WORDS;
  const size_t smem = (size_t)next_pow2(k) * 8 + (size_t)Kd * 8 + (size_t)per * 4 +
                      (size_t)a->nsig * ks * 4 +
                      (staged ? (size_t)q->P * ks * 4 : 0);
  return (int)launch_clusters(stage_b_kernel, cluster, q->B, smem, stream, factors, cand, Kd, *s,
                              *q, *a, default_static, inv_fs, k, ks, (int)staged, out_docs,
                              out_scores, out_sq, out_scale);
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

// K9: scores f32[B, n, K], docs i32[B, n, K] (the per-shard top K of each
// query, gathered shard-major) -> out_docs, out_shards i32[B, k], out_scores
// f32[B, k], lax.top_k over the flattened n*K: descending, ties (and the -inf
// pads) to the lower flat index.
int stract_mesh_topk(const float* scores, const int* docs, int B, int n, int K, int k,
                     int* out_docs, int* out_shards, float* out_scores, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n < 1 || K < 1 || (long long)n * K > MESH_MAX_N || k < 1 ||
      k > K || k > MESH_MAX_K)
    return (int)cudaErrorInvalidValue;
  mesh_topk_kernel<<<B, 1024, 0, stream>>>(scores, docs, n * K, K, k, out_docs,
                                           out_shards, out_scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
