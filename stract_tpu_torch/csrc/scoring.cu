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
// Top-K (K1, K2, K13's tail, K9's select form, K10): `top_keys` over keys held
//     by one block or by a cluster's blocks, in the order key descending,
//     ties to the lower payload (doc, column or index). Zero keys (empty or
//     invalid) enter no histogram. Where every block's nonzero keys fit its
//     sort buffer, all are sorted and those placed past K dropped (the
//     smoke's K1 and K2); else a 4 x 8-bit radix select of the K-th, whose
//     histograms take one shared atomic per distinct digit of a warp
//     (__match_any_sync), and of the keys equal to it those with the lowest
//     payloads win (in index order where the payloads rise with it: K2,
//     K13's tail, K9; else, K1's docs, by a second radix
//     select over their payloads where more tie than win), so both regimes
//     give the same winners, whatever slots K1's hash table gave them. Each
//     block sorts its winners (bitonic, the stages
//     under 32 apart in registers by shuffles) and places each by binary
//     searches of the other blocks' sorted runs, staged in its shared
//     memory, so no block sorts the whole of them.
// K3  stract_signals_q16  replaces compute_signals_from_factors_batch_q16
//     (:886): a block a query and 2 of its 46 signal rows (23 blocks a
//     query), 256 threads. The block stages its
//     rows' [R, P] aggregation coefficients, the slots' idf and the rows'
//     gather sources once, and lists the slots whose coefficient is nonzero
//     in any of its rows (a slot feeds about one row of each matrix); a
//     thread takes a column at a time, issues its gathers (static column,
//     region, update time) into registers, reads the listed slots' factor
//     words once for its R rows, and sums each entry over them in the order
//     of the reference's signal row (signal_entry's): a term with a zero
//     coefficient adds +-0 to a sum that is never -0, so leaving it out
//     leaves the same bits. Each row's absmax is reduced over the block, and
//     the block quantises its rows (rintf, round half to even like
//     jnp.round) from shared memory in 16-byte pieces. Bound by latency:
//     ~32 KB of factors a query at K = 512, P = 16, and a chain of loads
//     and barriers a block. With the join (joined pass 2) it also writes f32
//     rows, each value as signal_entry sums it, and takes any K and P: past
//     its shared memory the values wait in an f32 matrix in device memory
//     and the coefficients are read where they lie.
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
// K11 stract_factors_join replaces factors_join (:749) and the join inside
//     score_driver_joined[_batch] (:760, :770) and compute_signals_joined*
//     (:894, :912, :922): out[b, p, c], the packed factors of candidate c in
//     slot p's full doc-ascending range. A block a (1,024 candidates, slot,
//     query), 4 candidates a thread bisected in lockstep; the block stages a
//     sample of the slot's range in shared memory (every ceil(len /
//     sample)-th doc; a range no longer than the sample whole), which places
//     each search in one interval of it; the search ends in global memory
//     there. Empty slots (three quarters of the main path's compacted slots)
//     write zeros and leave. ops/kernels.py join_plan picks the sample (256
//     docs). The output equals the reference's lockstep search on every
//     doc-ascending range, and a range too long for the reference's fixed
//     step count to converge on is bisected for those steps alone. Joined
//     stage B and joined pass 2 are this join into an on-card [B, P, K]
//     matrix (8 MB at Kd = 4,096, 1 MB at K = 512: L2-resident), then K2
//     (unfused) and K3 as they stand, so their outputs are those of K2 and
//     K3 over the host join, bit for bit. Bound by the sectors its probes
//     touch: about 10 a search below the sample, each its own, in ~40
//     posting lists of up to 12 MB (a doc sort of the candidates, a merge
//     path, interpolation probes and the join inside K2's blocks all read
//     slower: PERF.md §6).
// K12 stract_signals_prefix replaces compute_signals[_batch]
//     (:492, :859): pass 2 from the first L rows of each slot only, by the
//     reference's fixed-step search over the [P, L] tile (_slot_factor_lookup
//     :450), step for step, so a tf-ordered impact slot gives the
//     reference's answer too. A grid of (tile of 128 candidates, query)
//     blocks (128 blocks at the smoke's B = 32, K = 512): each stages the
//     first min(len, L) doc ids of the query's live slots in its shared
//     memory (4 KB a slot at L = 1,024; past what a block holds, the slots
//     go in groups), runs every search of its candidates against them (rows
//     past the prefix read as num_docs, the mid clamped), reads each found
//     factor word once, then sums the signal entries as K3 does, a thread a
//     (candidate, run of rows) with the run's gathers issued together: the
//     coefficients staged once with each row's list of nonzero slots, terms
//     with a zero coefficient left out (the same bits). ops/kernels.py
//     prefix_plan sizes the tile, the groups and the staging. A query's
//     blocks as one cluster, each staging a quarter of the prefixes and the
//     searches reading the others' through distributed shared memory, read
//     2.4x slower (0.034 ms against 0.014 at the smoke's shape) and went.
//     Bound by latency: its time moved with the blocks in flight, not with
//     the prefix bytes (the prefixes left in L2 read within 15 %).
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
//     output). A query of up to 8,192 entries (12 B each: key,
//     contribution, aux word) lies in one block's shared memory, one launch
//     a batch (ops/kernels.py merge_plan), 8 entries a thread: stages 256
//     apart and more in passes over shared memory that take up to three
//     stages each in registers (8 entries of a group, the round's flip read
//     through the fold), those under 256 apart in registers, across the
//     warp's lanes by shuffles; then the tail (8 consecutive entries a
//     thread, a segmented scan by shuffles, then over the warps) writes each
//     run end's ordered key over its contribution, and the block's top-K
//     takes the top C (ties to the lower position). Larger queries (the
//     main path's P = 64, L = 1,024: N = 65,536) take the global form: the
//     network in [B, N] rows, tile kernels of 8,192 entries for the fetch
//     and each round's short stages (a stage at a time in shared memory:
//     32 registers, two blocks an SM, a batch's tiles in one wave), one
//     launch a stage for the longer strides, then the tail as a grid of
//     tiles (their totals carried in tile order by a second launch: a fixed
//     order, so the same bits every call) and the shared top-K over the
//     fewest blocks a query whose keys fit their shared memory (2 at the
//     main shape). A cluster form that held a query of up to 65,536 entries
//     in the distributed shared memory of 8 blocks, in one launch, measured
//     slower on the H100 (15 clusters of 8 one-SM blocks at once: 3 waves
//     for 32 queries) and is gone.
// K10 stract_dense_rerank replaces rerank_topk[_batch] (ops/dense_rerank.py:18,
//     :31). Bound by reading the B*K*H embedding rows once (25 MB at the
//     smoke's 32 x 1,024 x 384 f16: 0.0075 ms). The old form, one block a
//     query (32 blocks on 132 SMs), 2 bytes a lane a load and a bitonic sort
//     of all K keys, read 8x that. A grid of (128-candidate tile, query)
//     blocks of 512 threads (256 at that shape: one wave at two an SM), a
//     group of 8 lanes taking 2 rows one after the other, each
//     lane's 16-byte pieces (6 at H = 384 f16) issued before any arithmetic,
//     the query staged in shared memory in chunks (any H), dot and sum of
//     squares in f32 and the lanes' shuffles. The top k without a sort of
//     all K keys: the tiles write their keys to a [B, K] scratch, and the
//     last tile block of the query to arrive (a ticket a query, fenced,
//     left at zero for the next call) selects over them: for k <= 32 each
//     warp keeps the 32 largest of its keys in a warp list (sorted and
//     merged by shuffles) and the lists meet pairwise, 4 barriers (the
//     shared top-K's radix passes took 8.3 of 17 us at the smoke's shape);
//     past 32 the shared top-K, a radix select for the k-th key, then a
//     sort of the k winners. (A merge
//     form, each tile sorting its keys and the last block ranking the
//     tiles' lists by bisections as K9 does, read 0.018 against 0.017 ms at
//     that shape and 0.137 against 0.116-0.121 at 4 x 5,000, k = K, on the
//     H100, and went.) Keys are order_key of the total, so +0 sorts above
//     -0 and ties go to the lower index: lax.top_k's order. Any K and H,
//     any k <= K (past RERANK_STAGE winners their sort buffer lies in
//     global memory).
// K9  stract_mesh_topk replaces the merge of the mesh's search programs
//     (stract_tpu/parallel/search.py:39-42 and :78-81: the all-gather of each
//     shard's top K, then lax.top_k over the n*K gathered scores). Each
//     shard's list arrives descending (a top-K), so the global top k is a
//     merge of n sorted lists: the entry at position p of list i has the
//     rank p + (entries of lists before i with a key >= its key) + (entries
//     of lists after i with a key > its key), lax.top_k's tie rule, each
//     count a bisection over a list staged in shared memory, and wins where
//     its rank is below k. A block a (list, query), every rank independent:
//     one barrier after the load, no select and no sort. The kernel reads
//     the lists where they lie through a table of n (scores, docs) pointers
//     (the shards' [B, K] tensors, or a stacked [B, n, K] tensor), and
//     checks that every list of a query is non-increasing in the key (+0
//     above -0, as lax.top_k ranks them on the CPU); a query where one is
//     not takes the shared top-K below over its
//     n*K keys in the same launch (the select form: its radix select and
//     sort of the k winners), the same output. Latency-bound: the work is up
//     to 8,192 keys a query (32 KB).
//
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
// most signal rows the search kernels keep per block in static shared memory
constexpr int MAX_NSIG = 64;
// K10: candidates a block, lanes a candidate row, threads a block (a group of
// lanes takes 2 rows), pieces a lane loads at once, query dims staged at a
// time, and the most select winners the last block sorts in dynamic shared
// memory
constexpr int RERANK_TILE = 128;
constexpr int RERANK_LANES = 8;
constexpr int RERANK_THREADS = 512;
constexpr int RERANK_ILP = 8;
constexpr int RERANK_QCH = 4096;
constexpr int RERANK_STAGE = 8192;
// K13: the entries a block of the merge holds in shared memory (12 B each:
// key, contribution, aux word; a query of the one-block form, or a tile of
// the global form) and its threads (8 entries each)
constexpr int MERGE_TILE = 8192;
constexpr int MERGE_THREADS = 1024;
// K3: threads a block, and the signal rows a block takes (of 1, 2, 4 and 8
// rows a block, 2 read fastest at the main path's K = 512 and 128)
constexpr int SIG_THREADS = 256;
constexpr int SIG_ROWS = 2;
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
// K11: a join block's threads, the candidates each searches at once, the
// candidates a block takes, and the most docs of a slot's sample it stages
// (ops/kernels.py join_plan picks within it)
constexpr int JOIN_THREADS = 256;
constexpr int JOIN_ILP = 4;
constexpr int JOIN_CANDS = JOIN_THREADS * JOIN_ILP;
constexpr int JOIN_CAP = 16384;
// K12: a block's threads, the searches a thread runs at once, the most
// slots a query takes (a slot's list of row indices is 16-bit)
constexpr int PREFIX_THREADS = 512;
constexpr int PREFIX_ILP = 4;
constexpr int PREFIX_MAX_P = 8192;
// K12: the prefix rows a thread loads at once while it stages, the most
// candidates a block takes, and the most signal rows a thread sums
constexpr int PREFIX_STAGE = 8;
constexpr int PREFIX_MAX_CANDS = 512;
constexpr int PREFIX_MAX_RPG = 16;
// K9: the gathered entries of one query (n lists x K), the most it keeps,
// and the most lists a call's table names one by one
constexpr int MESH_MAX_N = 8192;
constexpr int MESH_MAX_K = 1024;
constexpr int MESH_MAX_LISTS = 64;

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

// K3's per-query rows: query b's part of each array at its pointer + b x
// its stride (in floats), so they may be views of one packed upload
struct SignalArgs {
  const float* idf;            // [P] the slots' idf
  const float* region_lut;     // [NUM_REGIONS]
  const float* current_ts;     // [1]
  const float* bm25;           // [nsig, P]
  const float* bm25f;          // [P] (the bm25f row's aggregation)
  const float* aidf;           // [nsig, P]
  const float* cov;            // [nsig, P]
  const int* static_of_sig;    // [nsig]: static column of a signal row, or -1
  long long stride[7];         // of idf, region_lut, current_ts, bm25, bm25f, aidf, cov
  int P;
  int nsig;
  int bm25f_row;
  int region_row;
  int update_row;
};

// K9's lists: list j of query b starts at scores[t] + (j - t) x K + b x
// qstride, t = min(j, ntab - 1). One entry a list (ntab = n: each shard's
// [B, K] tensor where it lies, qstride K) or one entry for all (ntab = 1: a
// stacked [B, n, K] tensor, qstride n x K).
struct MeshLists {
  const float* scores[MESH_MAX_LISTS];
  const int* docs[MESH_MAX_LISTS];
  long long qstride;
  int ntab;
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
// The blocks that share one selection: one block (K9) or a
// thread block cluster (K1, K2, K13), whose blocks each hold a part of the
// keys and reach each other's shared memory.
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
// contributions and, when the static score reads them, the aux words. A
// block holds them in shared memory (the whole query, or a tile of the
// global form), each as three arrays.

// an entry of the network held in registers
struct MEnt {
  int k;
  float c;
  int a;
};

template <bool AUX>
__device__ __forceinline__ MEnt ment_load(const int* k, const float* c, const int* a, int i) {
  return MEnt{k[i], c[i], AUX ? a[i] : 0};
}

template <bool AUX>
__device__ __forceinline__ void ment_store(int* k, float* c, int* a, int i, const MEnt& v) {
  k[i] = v.k;
  c[i] = v.c;
  if (AUX) a[i] = v.a;
}

// one compare-exchange of two held entries: swap where the first key is
// greater (equal keys never swap)
__device__ __forceinline__ void ment_cx(MEnt& lo, MEnt& hi) {
  if (lo.k > hi.k) {
    const MEnt t = lo;
    lo = hi;
    hi = t;
  }
}

// one compare-exchange in place: swap where the first key is greater
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

// stage d of n entries: x against x + d inside blocks of 2d, by the block
__device__ __forceinline__ void merge_stage_block(int* k, float* c, int* a, int n, int d) {
  for (int u = threadIdx.x; u < n / 2; u += blockDim.x) {
    const int i = ((u & ~(d - 1)) << 1) | (u & (d - 1));
    merge_cx(k, c, a, i, i + d);
  }
}

// a full round of n entries, a stage at a time (a query of under 8 entries)
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

// The position that folded position f of a round of h-entry rows reads: the
// reference folds each pair of rows into one, the second reversed behind the
// first (after its first stage the memory holds the folded layout).
__device__ __forceinline__ int fold_src(int f, int h) {
  const int off = f & (2 * h - 1);
  return off < h ? f : f - off + 3 * h - 1 - off;
}

// Up to three stages d = lo << 2, lo << 1, lo (those set in mask, bit 2 the
// first) of a chunk of C entries in shared memory: each thread takes the 8
// entries g + j lo of its group into registers (consecutive threads on
// consecutive entries), runs the stages there and writes them back. flip_h:
// the first stage is the round's flip, the entries read through the fold
// (all reads before any write). C / 8 groups, one a thread.
template <bool AUX>
__device__ void strided_pass(int* k, float* c, int* a, int C, int lo, unsigned mask, int flip_h) {
  const int g = threadIdx.x, lg = __ffs(lo) - 1;
  const bool act = g < (C >> 3);
  const int base = (g & (lo - 1)) | ((g >> lg) << (lg + 3));
  MEnt v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int f = base + j * lo;
    v[j] = act ? ment_load<AUX>(k, c, a, flip_h ? fold_src(f, flip_h) : f) : MEnt{0, 0.0f, 0};
  }
  if (flip_h) __syncthreads();
#pragma unroll
  for (int sb = 2; sb >= 0; --sb) {
    if (!((mask >> sb) & 1u)) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (!(j & (1 << sb))) ment_cx(v[j], v[j | (1 << sb)]);
  }
  if (act) {
#pragma unroll
    for (int j = 0; j < 8; ++j) ment_store<AUX>(k, c, a, base + j * lo, v[j]);
  }
}

// The stages d_hi, d_hi / 2, ..., 1 (d_hi <= 128) of a chunk of C >= 8
// entries, 8 consecutive a thread in registers: d >= 8 across the warp's
// lanes by shuffles, d < 8 within the thread. flip_h: the first stage is the
// round's flip (entries read through the fold, all reads before any write).
template <bool AUX>
__device__ void consecutive_pass(int* k, float* c, int* a, int C, int d_hi, int flip_h) {
  const int t = threadIdx.x, lane = t & 31, i0 = 8 * t;
  const bool act = i0 < C;
  MEnt v[8];
  if (act && !flip_h) {  // 16-byte pieces
    const int4 k0 = *reinterpret_cast<const int4*>(k + i0), k1 = *reinterpret_cast<const int4*>(k + i0 + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(c + i0),
                 c1 = *reinterpret_cast<const float4*>(c + i0 + 4);
    int4 a0 = make_int4(0, 0, 0, 0), a1 = a0;
    if (AUX) {
      a0 = *reinterpret_cast<const int4*>(a + i0);
      a1 = *reinterpret_cast<const int4*>(a + i0 + 4);
    }
    v[0] = MEnt{k0.x, c0.x, a0.x};
    v[1] = MEnt{k0.y, c0.y, a0.y};
    v[2] = MEnt{k0.z, c0.z, a0.z};
    v[3] = MEnt{k0.w, c0.w, a0.w};
    v[4] = MEnt{k1.x, c1.x, a1.x};
    v[5] = MEnt{k1.y, c1.y, a1.y};
    v[6] = MEnt{k1.z, c1.z, a1.z};
    v[7] = MEnt{k1.w, c1.w, a1.w};
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = act ? ment_load<AUX>(k, c, a, fold_src(i0 + j, flip_h)) : MEnt{0, 0.0f, 0};
  }
  if (flip_h) __syncthreads();
  for (int d = d_hi; d >= 8; d >>= 1) {
    const int o = d >> 3;
    const bool lower = (lane & o) == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pk = __shfl_xor_sync(FULL_MASK, v[j].k, o);
      const float pc = __shfl_xor_sync(FULL_MASK, v[j].c, o);
      const int pa = AUX ? __shfl_xor_sync(FULL_MASK, v[j].a, o) : 0;
      if (lower ? v[j].k > pk : pk > v[j].k) v[j] = MEnt{pk, pc, pa};
    }
  }
  if (d_hi >= 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ment_cx(v[j], v[j + 4]);
  }
  if (d_hi >= 2) {
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      ment_cx(v[j], v[j + 2]);
      ment_cx(v[j + 1], v[j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; j += 2) ment_cx(v[j], v[j + 1]);
  if (!act) return;
  *reinterpret_cast<int4*>(k + i0) = make_int4(v[0].k, v[1].k, v[2].k, v[3].k);
  *reinterpret_cast<int4*>(k + i0 + 4) = make_int4(v[4].k, v[5].k, v[6].k, v[7].k);
  *reinterpret_cast<float4*>(c + i0) = make_float4(v[0].c, v[1].c, v[2].c, v[3].c);
  *reinterpret_cast<float4*>(c + i0 + 4) = make_float4(v[4].c, v[5].c, v[6].c, v[7].c);
  if (AUX) {
    *reinterpret_cast<int4*>(a + i0) = make_int4(v[0].a, v[1].a, v[2].a, v[3].a);
    *reinterpret_cast<int4*>(a + i0 + 4) = make_int4(v[4].a, v[5].a, v[6].a, v[7].a);
  }
}

// The stages d_top, d_top / 2, ..., 1 of a round on a chunk of C >= 8 entries
// in shared memory (flip: the first is the round's flip, d_top = h): those
// of 256 and more in strided passes of up to three, the rest in one
// consecutive pass. Called and ends synchronised.
template <bool AUX>
__device__ void local_stages(int* k, float* c, int* a, int C, int d_top, bool flip) {
  int d = d_top;
  while (d >= 256) {
    const int n = d >= 1024 ? 3 : (d >= 512 ? 2 : 1);
    const int lo = min(d >> (n - 1), C >> 3);  // 8 lo <= C; every stage <= 4 lo
    unsigned mask = 0;
    for (int i = 0; i < n; ++i) mask |= 1u << (__ffs(d >> i) - __ffs(lo));
    strided_pass<AUX>(k, c, a, C, lo, mask, flip ? d : 0);
    __syncthreads();
    flip = false;
    d >>= n;
  }
  if (d >= 1) {
    consecutive_pass<AUX>(k, c, a, C, d, flip ? d : 0);
    __syncthreads();
  }
}

// The whole network of a query whose N entries one block holds. Ends
// synchronised.
template <bool AUX>
__device__ void merge_network(int* k, float* c, int* a, int N, int L) {
  if (N < 8) {  // a query of under 8 entries: a stage at a time
    for (int m = 2 * L; m <= N; m <<= 1) merge_round_block(k, c, AUX ? a : nullptr, N, m);
    return;
  }
  for (int h = L; h < N; h <<= 1) local_stages<AUX>(k, c, a, N, h, true);  // rows of h into 2h
}

// stage A's entries [g0, g0 + n) of query b (positions p * L + l of its [P,
// L] tiles) from the posting rows, as _stage_a_entries makes them: key doc
// << 6 | group, contribution (UB: (c - ub) + U), aux word; pads hold the pad
// doc, no contribution and no aux
template <bool AUX>
__device__ void merge_fetch(const int* __restrict__ postings, long long n_rows, int W,
                            const QueryArgs& q, const float* __restrict__ ub_entry, float U, int L,
                            float inv_fs, int num_docs, int b, long long g0, int n, int* k, float* c,
                            int* a) {
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const long long g = g0 + e;
    const int p = (int)(g / L), l = (int)(g - (long long)p * L);
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
    float contrib =
        q.w_bm25[bp] * f1 + q.w_bm25f[bp] * f2 + q.w_presence[bp] * (fac != 0 ? 1.0f : 0.0f);
    if (ub_entry != nullptr) contrib = valid ? (contrib - ub_entry[bp]) + U : 0.0f;
    k[e] = (doc << 6) | q.group[bp];
    c[e] = contrib;
    if (AUX) a[e] = aux;
  }
}

// ---- K13's tail: the run ends of _join_topk over the merged order ----------
// An entry ends its (doc, group) pair where the next key differs and its doc
// where the next doc differs (the query's last entry ends both). A run's
// score takes its contribution sum (UB: minus its entries times U, plus the
// query's ub_total), the static score of its last entry, its required pairs
// (the soft bonus or the n_required mask) and its excluded pairs.
//
// The sums are taken in one fixed order: a tile of up to MERGE_TILE entries
// (the one-block form's query, or a tile of the global form), 8 consecutive
// entries a thread summed in order, the threads' open runs carried by a
// segmented scan of the warp (shuffles) and of the tile's warps, and the
// tiles' open runs carried in tile order.

// the run open at the end of a range of the merged order (its sum, required
// and excluded pairs and entries) and whether the range ends any run
struct RunSum {
  float s;
  int end, req, excl, cnt;
};

// range a, then range b: b's open run, extended by a's where b ends none
__device__ __forceinline__ RunSum run_join(const RunSum& a, const RunSum& b) {
  return b.end ? b : RunSum{a.s + b.s, a.end, a.req + b.req, a.excl + b.excl, a.cnt + b.cnt};
}

__device__ __forceinline__ RunSum run_shfl_up(const RunSum& x, int o) {
  return RunSum{__shfl_up_sync(FULL_MASK, x.s, o), __shfl_up_sync(FULL_MASK, x.end, o),
                __shfl_up_sync(FULL_MASK, x.req, o), __shfl_up_sync(FULL_MASK, x.excl, o),
                __shfl_up_sync(FULL_MASK, x.cnt, o)};
}

// the warp's inclusive segmented scan (Hillis-Steele) → (inclusive, exclusive)
__device__ __forceinline__ void run_scan_warp(RunSum& inc, RunSum& exc) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const RunSum l = run_shfl_up(inc, o);
    if (lane >= o) inc = run_join(l, inc);
  }
  exc = run_shfl_up(inc, 1);
  if (lane == 0) exc = RunSum{0.0f, 0, 0, 0, 0};
}

// the tile scan's shared state: each warp's total and carry-in, the tile's
// total, the carry into the tile
struct TailScan {
  RunSum wsum[32];
  RunSum wex[32];
  RunSum total;
  RunSum carry;
};

// the keys of the thread's 8 entries [i0, i0 + 8) of a tile of n, and the
// key after each (nk the next tile's first, has_nk whether there is one)
__device__ __forceinline__ void tail_keys_of(const int* k, int n, int nk, bool has_nk, int i0,
                                             int* key, int* nxt, bool* has) {
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int i = i0 + j;
    const int x = i < n ? k[i] : nk;
    if (j < 8) key[j] = x;
    if (j > 0) {
      nxt[j - 1] = x;
      has[j - 1] = i < n || has_nk;
    }
  }
}

// The tail's scan over a tile of n <= 8 x blockDim entries: → the carry
// from the tile's start into this thread's first entry (the warp's carry-in
// joined with the lane's); the tile's total in ts.total. Ends synchronised.
__device__ RunSum tile_scan(const int* k, const float* c, int n, int nk, bool has_nk,
                            TailScan& ts) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = blockDim.x >> 5, i0 = 8 * t;
  int key[8], nxt[8];
  bool has[8];
  tail_keys_of(k, n, nk, has_nk, i0, key, nxt, has);
  RunSum x{0.0f, 0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (i0 + j >= n) break;
    const bool pe = !has[j] || nxt[j] != key[j];
    const bool de = !has[j] || (nxt[j] >> 6) != (key[j] >> 6);
    const int g = key[j] & 63;
    x.s = x.s + c[i0 + j];
    x.cnt += 1;
    if (pe) {
      x.req += g < MAX_GROUPS;
      x.excl += g == EXCLUDED_GROUP;
    }
    if (de) x = RunSum{0.0f, 1, 0, 0, 0};
  }
  RunSum inc = x, lex;
  run_scan_warp(inc, lex);
  if (lane == 31) ts.wsum[w] = inc;
  __syncthreads();
  if (w == 0) {
    RunSum winc = lane < nw ? ts.wsum[lane] : RunSum{0.0f, 0, 0, 0, 0}, wexc;
    run_scan_warp(winc, wexc);
    ts.wex[lane] = wexc;
    if (lane == nw - 1) ts.total = winc;
  }
  __syncthreads();
  return run_join(ts.wex[w], lex);
}

// The tiles' carry into tile r: their totals (total(i), i < r) joined in
// tile order from the last tile before r that ends a run.
template <class Total>
__device__ RunSum tile_carry(Total total, int r) {
  int a = r - 1;
  while (a > 0 && !total(a).end) --a;
  RunSum x{0.0f, 0, 0, 0, 0};
  for (int i = max(a, 0); i < r; ++i) x = run_join(x, total(i));
  return x;
}

// The thread's 8 entries of a tile again, from its carry-in x: each run
// end's ordered key (0: no candidate) written over the entry's contribution
// (okey aliases c); a the aux words (null: the static score from the
// segment's columns).
__device__ void tail_scores(const int* k, float* c, const int* a, int n, int nk, bool has_nk,
                            RunSum x, const SegArgs& s, const QueryArgs& q, int b,
                            const float* ub_total, float U, bool default_static,
                            bool soft_required) {
  const int i0 = 8 * threadIdx.x;
  int key[8], nxt[8];
  bool has[8];
  tail_keys_of(k, n, nk, has_nk, i0, key, nxt, has);
  const int nreq = q.n_required[b];
  unsigned* okey = reinterpret_cast<unsigned*>(c);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = i0 + j;
    if (i >= n) break;
    const bool pe = !has[j] || nxt[j] != key[j];
    const bool de = !has[j] || (nxt[j] >> 6) != (key[j] >> 6);
    const int g = key[j] & 63;
    x.s = x.s + c[i];
    x.cnt += 1;
    if (pe) {
      x.req += g < MAX_GROUPS;
      x.excl += g == EXCLUDED_GROUP;
    }
    unsigned ok = 0;
    if (de) {
      const int doc = key[j] >> 6;
      if (doc < s.num_docs && x.excl == 0) {
        float text = x.s;
        if (ub_total != nullptr) text = (text - (float)x.cnt * U) + ub_total[b];
        const float st = default_static ? aux_static(q, b, a[i], s.static_scale)
                                        : query_static(s, q, b, doc, false);
        float total = text + st;
        bool valid = true;
        if (soft_required) {
          total = total + q.soft_bonus[b] * (float)x.req;
        } else {
          valid = x.req >= nreq;
        }
        if (valid) ok = order_key(total);
      }
      x = RunSum{0.0f, 0, 0, 0, 0};
    }
    okey[i] = ok;
  }
}

// The merge in one block's shared memory (N <= MERGE_TILE; grid (1, B)):
// three arrays of N entries, then, for the select, the sort buffer. The
// fetch, the whole network, then K = 0: the entries out to the network
// rows; else the tail's scan, each run end's ordered key over its
// contribution, and the block's top-K (ties to the lower position).
template <bool AUX>
__global__ void __launch_bounds__(MERGE_THREADS, 1) merge_block_kernel(
    const int* __restrict__ postings, long long n_rows, int W, SegArgs s, QueryArgs q,
    const float* __restrict__ ub_entry, const float* __restrict__ ub_total, int L, float inv_fs,
    int N, int soft_required, int K, int* out_key, float* out_con, int* out_aux, int* out_docs,
    float* out_scores) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelectState st;
  __shared__ TailScan ts;
  __shared__ float sh_U;
  BlockScope scope;
  const int b = blockIdx.y, tid = threadIdx.x;
  int* k = reinterpret_cast<int*>(dyn_smem);
  float* c = reinterpret_cast<float*>(k + N);
  int* a = reinterpret_cast<int*>(c + N);
  unsigned long long* kv = reinterpret_cast<unsigned long long*>(a + N);
  if (tid < 32) {
    const float U = ub_entry != nullptr ? warp_max_bound(ub_entry + (long long)b * q.P, q.P) : 0.0f;
    if (tid == 0) sh_U = U;
  }
  __syncthreads();
  merge_fetch<AUX>(postings, n_rows, W, q, ub_entry, sh_U, L, inv_fs, s.num_docs, b, 0, N, k, c,
                   a);
  __syncthreads();
  merge_network<AUX>(k, c, a, N, L);
  if (K == 0) {  // the network alone: its rows out
    const long long o = (long long)b * N;
    for (int e = tid; e < N; e += blockDim.x) {
      out_key[o + e] = k[e];
      out_con[o + e] = c[e];
      if (AUX) out_aux[o + e] = a[e];
    }
    return;
  }
  const RunSum inner = tile_scan(k, c, N, 0, false, ts);
  tail_scores(k, c, AUX ? a : nullptr, N, 0, false, run_join(RunSum{0.0f, 0, 0, 0, 0}, inner), s,
              q, b, ub_total, sh_U, AUX, soft_required != 0);
  __syncthreads();
  const int n_w = top_keys<true>(scope, st, reinterpret_cast<const unsigned*>(c), N, K,
                                 [&](int i) { return i; }, kv,
                                 [&](int pos, unsigned key, int i) {
                                   out_docs[(long long)b * K + pos] = k[i] >> 6;
                                   out_scores[(long long)b * K + pos] = key_value(key);
                                 },
                                 reinterpret_cast<unsigned long long*>(a), N / 2);
  for (int j = n_w + tid; j < K; j += blockDim.x) {
    out_docs[(long long)b * K + j] = s.num_docs;
    out_scores[(long long)b * K + j] = -INFINITY;
  }
}

// The global form (N past one block's shared memory). One tile
// of `tile` entries of query blockIdx.y in shared memory. fetch: the tile's
// entries from the posting rows, else from the network rows. Then the
// stages cont_d .. 1 of a round whose longer strides ran in global memory,
// and the whole rounds of rows of h_lo .. h_hi (0: none), a stage at a time
// (few registers: two blocks of 1,024 threads an SM, so a batch's tiles
// take one wave where the register passes' 51-59 registers took two).
template <bool AUX>
__global__ void __launch_bounds__(MERGE_THREADS) merge_tile_kernel(
    const int* __restrict__ postings, long long n_rows, int W, QueryArgs q,
    const float* __restrict__ ub_entry, int L, float inv_fs, int num_docs, int* mkey,
    float* mcon, int* maux, int N, int tile, int fetch, int cont_d, int h_lo, int h_hi) {
  extern __shared__ __align__(16) int smem[];
  int* k = smem;
  float* c = reinterpret_cast<float*>(smem + tile);
  int* a = smem + 2 * tile;
  __shared__ float sh_U;
  const int b = blockIdx.y;
  const long long t0 = (long long)b * N + (long long)blockIdx.x * tile;
  if (fetch) {
    if (threadIdx.x < 32) {
      const float U =
          ub_entry != nullptr ? warp_max_bound(ub_entry + (long long)b * q.P, q.P) : 0.0f;
      if (threadIdx.x == 0) sh_U = U;
    }
    __syncthreads();
    merge_fetch<AUX>(postings, n_rows, W, q, ub_entry, sh_U, L, inv_fs, num_docs, b,
                     (long long)blockIdx.x * tile, tile, k, c, a);
  } else {
    for (int e = threadIdx.x; e < tile; e += blockDim.x) {
      k[e] = mkey[t0 + e];
      c[e] = mcon[t0 + e];
      if (AUX) a[e] = maux[t0 + e];
    }
  }
  __syncthreads();
  int* ta = AUX ? a : nullptr;
  for (int d = cont_d; d >= 1; d >>= 1) {
    merge_stage_block(k, c, ta, tile, d);
    __syncthreads();
  }
  for (int h = h_lo; h_lo && h <= h_hi; h <<= 1) merge_round_block(k, c, ta, tile, 2 * h);
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    mkey[t0 + e] = k[e];
    mcon[t0 + e] = c[e];
    if (AUX) maux[t0 + e] = a[e];
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

// The global form's tail, first launch: a block a (tile, query) scans its
// tile of the network rows and writes the tile's total to tsum[b, tile].
__global__ void __launch_bounds__(MERGE_THREADS) merge_tail_sum_kernel(const int* mkey,
                                                                       const float* mcon, int N,
                                                                       RunSum* tsum) {
  __shared__ TailScan ts;
  const int r = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const long long t0 = (long long)b * N + (long long)r * MERGE_TILE;
  const bool has_next = r + 1 < tiles;
  tile_scan(mkey + t0, mcon + t0, MERGE_TILE, has_next ? mkey[t0 + MERGE_TILE] : 0, has_next, ts);
  if (threadIdx.x == 0) tsum[(long long)b * tiles + r] = ts.total;
}

// second launch: the same scan, the carry into the tile from the totals,
// and each run end's ordered key over its contribution (mcon in place)
__global__ void __launch_bounds__(MERGE_THREADS) merge_tail_keys_kernel(
    const int* mkey, float* mcon, const int* maux, int N, const RunSum* tsum, SegArgs s,
    QueryArgs q, const float* __restrict__ ub_entry, const float* __restrict__ ub_total,
    int soft_required) {
  __shared__ TailScan ts;
  __shared__ float sh_U;
  const int r = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  if (threadIdx.x < 32) {
    const float U = ub_entry != nullptr ? warp_max_bound(ub_entry + (long long)b * q.P, q.P) : 0.0f;
    if (threadIdx.x == 0) sh_U = U;
  }
  const long long t0 = (long long)b * N + (long long)r * MERGE_TILE;
  const bool has_next = r + 1 < tiles;
  const int nk = has_next ? mkey[t0 + MERGE_TILE] : 0;
  const RunSum inner = tile_scan(mkey + t0, mcon + t0, MERGE_TILE, nk, has_next, ts);
  if (threadIdx.x == 0)
    ts.carry = tile_carry([&](int i) { return tsum[(long long)b * tiles + i]; }, r);
  __syncthreads();
  tail_scores(mkey + t0, mcon + t0, maux != nullptr ? maux + t0 : nullptr, MERGE_TILE, nk,
              has_next, run_join(ts.carry, inner), s, q, b, ub_total, sh_U, maux != nullptr,
              soft_required != 0);
}

// third launch: the shared top-K of each query's N ordered keys over a
// cluster of blocks (N / cluster keys each, staged in shared memory where
// they fit beside the sort buffer and the other blocks' runs), ties to the
// lower position
__global__ void __launch_bounds__(SELECT_THREADS, 1) merge_select_kernel(
    const int* mkey, const unsigned* okey, int N, int num_docs, int K, int keys_on_chip,
    int* out_docs, float* out_scores) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelectState st;
  ClusterScope scope;
  const unsigned CS = scope.size(), rank = scope.rank();
  const int b = blockIdx.y, n = N / (int)CS, S = next_pow2(K), base = (int)rank * n;
  unsigned long long* kv = reinterpret_cast<unsigned long long*>(dyn_smem);
  unsigned long long* stage = kv + S;
  const unsigned* keys = okey + (long long)b * N + base;
  if (keys_on_chip) {
    unsigned* sk = reinterpret_cast<unsigned*>(stage + S);
    for (int i = threadIdx.x; i < n; i += blockDim.x) sk[i] = keys[i];
    __syncthreads();
    keys = sk;
  }
  const int* mk = mkey + (long long)b * N;
  const int n_w = top_keys<true>(scope, st, keys, n, K, [&](int i) { return base + i; }, kv,
                                 [&](int pos, unsigned key, int i) {
                                   out_docs[(long long)b * K + pos] = mk[i] >> 6;
                                   out_scores[(long long)b * K + pos] = key_value(key);
                                 },
                                 stage, S);
  if (rank != 0) return;
  for (int j = n_w + threadIdx.x; j < K; j += blockDim.x) {
    out_docs[(long long)b * K + j] = num_docs;
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
// A block a query and R = SIG_ROWS of its signal rows (grid (B, ceil(nsig /
// R))). The block stages the rows' aggregation coefficients, the slots' idf,
// the rows' gather sources and the region table once, and lists the slots
// whose coefficient is nonzero in any of its rows; a thread then takes the
// columns j, j + SIG_THREADS, ...: it issues the column's gathers for its
// rows (a static column, the region id, the update time) into registers,
// reads the column's factor words of the listed slots once, and folds each
// of the R rows over them in the order of signal_entry, its terms with a
// zero coefficient left out, the values into shared memory and each row's
// largest magnitude into registers. The row maxima are reduced over the
// block, and the block quantises its rows from shared memory (rintf: half
// to even), 16-byte pieces where the rows allow. f32 rows (out_q null) go
// straight to `rows`, each value as signal_entry sums it, and nothing is
// quantised. Past what shared memory holds, a q16 call's values wait in
// `rows` (f32 [B, nsig, K] in device memory) and, past that too (STAGED
// false), the coefficients are read where they lie, every slot walked.
template <bool STAGED>
__global__ void __launch_bounds__(SIG_THREADS) signals_q16_kernel(
    const int* __restrict__ factors, const int* __restrict__ cand, int K, SegArgs s,
    SignalArgs a, float inv_fs, int vec, float* rows, short* out_q, float* out_scale) {
  constexpr int R = SIG_ROWS;
  extern __shared__ __align__(16) float sig_smem[];
  __shared__ float wmax[SIG_THREADS / 32][R];
  __shared__ float sscale[R];
  __shared__ int src[R];  // a row's static column; -1 none, -2 the region, -3 the update
  __shared__ float lut[NUM_REGIONS];
  __shared__ float now;
  __shared__ int n_live;
  const int b = blockIdx.x, r0 = blockIdx.y * R, tid = threadIdx.x, P = a.P;
  const int nr = min(R, a.nsig - r0), rf = a.bm25f_row - r0;
  const bool has_f = rf >= 0 && rf < nr;
  const float* bm25 = a.bm25 + b * a.stride[3] + (long long)r0 * P;
  const float* aidf = a.aidf + b * a.stride[5] + (long long)r0 * P;
  const float* cov = a.cov + b * a.stride[6] + (long long)r0 * P;
  // [R][P] the rows' bm25, idf and coverage coefficients, [P] the bm25f
  // row's and the slots' idf, [P] the slots any of the rows reads
  const float *cb = bm25, *ci = aidf, *cc = cov;
  const float* cf = a.bm25f + b * a.stride[4];
  const float* sidf = a.idf + b * a.stride[0];
  int* live = nullptr;
  float* sv;  // [R][K] the rows' values
  if (STAGED) {
    float* sb = sig_smem;
    float* si = sb + R * P;
    float* sc = si + R * P;
    float* sf = sc + R * P;
    float* sd = sf + P;
    int* sl = reinterpret_cast<int*>(sd + P);
    for (int t = tid; t < R * P; t += SIG_THREADS) {  // rows past nsig hold zeros
      const bool in = t < nr * P;
      sb[t] = in ? bm25[t] : 0.0f;
      si[t] = in ? aidf[t] : 0.0f;
      sc[t] = in ? cov[t] : 0.0f;
    }
    for (int t = tid; t < P; t += SIG_THREADS) {
      sf[t] = cf[t];
      sd[t] = sidf[t];
    }
    cb = sb, ci = si, cc = sc, cf = sf, sidf = sd, live = sl;
    sv = reinterpret_cast<float*>(sl + P);
  } else {
    sv = sig_smem;
  }
  if (rows != nullptr) sv = rows + ((long long)b * a.nsig + r0) * K;
  // a row's coefficient of slot p (0 past nsig)
  auto coef = [&](const float* c, int r, int p) {
    return (STAGED || r < nr) ? c[r * P + p] : 0.0f;
  };
  if (tid < nr) {
    const int sg = r0 + tid;
    src[tid] = sg == a.region_row ? -2 : sg == a.update_row ? -3 : a.static_of_sig[sg];
  }
  if (tid < NUM_REGIONS) lut[tid] = a.region_lut[b * a.stride[1] + tid];
  if (tid == 0) now = a.current_ts[b * a.stride[2]];
  __syncthreads();
  // the slots whose coefficient is nonzero in any of the rows, in order: the
  // rows are sparse (a slot feeds about one row of each matrix), and a term
  // with a zero coefficient adds +-0 to a sum that is never -0, so skipping
  // it leaves the same bits
  if (STAGED && tid < 32) {
    int cnt = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + tid;
      bool on = false;
      if (p < P) {
        on = has_f && cf[p] != 0.0f;
        for (int r = 0; r < nr; ++r)
          on = on || cb[r * P + p] != 0.0f || ci[r * P + p] != 0.0f || cc[r * P + p] != 0.0f;
      }
      const unsigned bal = __ballot_sync(FULL_MASK, on);
      if (on) live[cnt + __popc(bal & ((1u << tid) - 1u))] = p;
      cnt += __popc(bal);
    }
    if (tid == 0) n_live = cnt;
  }
  __syncthreads();
  const int nl = STAGED ? n_live : P;
  const int* F = factors + (long long)b * P * K;
  const bool quant = out_q != nullptr;
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = 0.0f;
  for (int j = tid; j < K; j += SIG_THREADS) {
    const int doc = cand[(long long)b * K + j];
    const bool has_doc = doc < s.num_docs;
    // the column's gathers, raw words in flight while it folds
    int graw[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int st = r < nr ? src[r] : -1;
      const int* at = !has_doc  ? nullptr
                      : st == -2 ? s.region_ids + doc
                      : st == -3 ? reinterpret_cast<const int*>(s.last_updated) + doc
                      : st >= 0  ? reinterpret_cast<const int*>(s.static_cols) + (long long)st * s.db + doc
                                 : nullptr;
      graw[r] = at != nullptr ? __ldg(at) : 0;
    }
    float vb[R], vi[R], vc[R], vf = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) vb[r] = vi[r] = vc[r] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < nl; ++i) {
      const int p = STAGED ? live[i] : i;
      const int f = F[(long long)p * K + j];
      const float id = sidf[p], pres = f != 0 ? 1.0f : 0.0f;
      const float x1 = id * ((float)((f >> 16) & 0xFFFF) * inv_fs), xp = id * pres;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float wb = coef(cb, r, p), wi = coef(ci, r, p), wc = coef(cc, r, p);
        if (wb != 0.0f) vb[r] += wb * x1;
        if (wi != 0.0f) vi[r] += wi * xp;
        if (wc != 0.0f) vc[r] += wc * pres;
      }
      if (has_f && cf[p] != 0.0f) vf += cf[p] * (id * ((float)(f & 0xFFFF) * inv_fs));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) continue;
      const int st = src[r];
      float v = 0.0f;
      if (has_doc) {
        const float g = st == -2   ? lut[clamp_region(graw[r])]
                        : st == -3 ? update_score(__int_as_float(graw[r]), now)
                                   : __int_as_float(graw[r]);  // the static column, or 0
        if (st <= -2) {
          v = g;
        } else {
          v = 0.0f + vb[r];
          if (has_f && r == rf) v = v + vf;
          v = v + vi[r];
          v = v + vc[r];
          v = v + g;
        }
      }
      sv[r * K + j] = v;
      m[r] = fmaxf(m[r], fabsf(v));
    }
  }
  if (!quant) return;
  // each row's largest magnitude over the block
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = m[r];
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
    if (lane == 0) wmax[warp][r] = x;
  }
  __syncthreads();
  if (tid < nr) {
    float x = 0.0f;
    for (int w = 0; w < SIG_THREADS / 32; ++w) x = fmaxf(x, wmax[w][tid]);
    const float scale = fmaxf(x, 1e-30f) * (1.0f / 32767.0f);
    sscale[tid] = scale;
    out_scale[(long long)b * a.nsig + r0 + tid] = scale;
  }
  __syncthreads();
  short* q = out_q + ((long long)b * a.nsig + r0) * K;
  if (vec) {  // K and the output's address multiples of 8 entries
    const int n8 = K >> 3;
    for (int t = tid; t < nr * n8; t += SIG_THREADS) {
      const int r = t / n8, j = (t - r * n8) * 8;
      const float scale = sscale[r];
      const float* v = sv + r * K + j;
      unsigned w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = (unsigned)(unsigned short)(short)rintf(v[2 * u] / scale) |
               ((unsigned)(unsigned short)(short)rintf(v[2 * u + 1] / scale) << 16);
      *reinterpret_cast<int4*>(q + (long long)r * K + j) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
  } else {
    for (int t = tid; t < nr * K; t += SIG_THREADS) {
      const int r = t / K;
      q[t] = (short)rintf(sv[t] / sscale[r]);
    }
  }
}

// ---- K11 ----------------------------------------------------------------------
// The join alone and before K2 and K3: out[b, p, c] = the packed factors of
// cand[b, c] in slot (b, p), 0 where absent. A block takes JOIN_CANDS
// candidates of one (slot, query), JOIN_ILP a thread searched in lockstep
// (the loads of a step in flight together), and first stages a sample of the
// slot's doc-ascending range in shared memory, read once: every step-th doc,
// step = ceil(len / sample) (step 1: the whole range, and the search ends
// there). The sample places each candidate's lower bound in one interval of
// it, and bisection ends the search in global memory inside that interval.
// A range of 2^steps rows or more (steps the reference's fixed count, the
// bit length of n_rows - 1) is bisected whole for those steps alone, as the
// reference does, so that what it returns where that loop has not converged
// is the reference's too. Every probe's row is clamped to n_rows - 1;
// offsets into the rows are 64-bit. Empty slots (most of the compacted
// slots) write zeros and leave.
__global__ void __launch_bounds__(JOIN_THREADS) join_kernel(
    const int* __restrict__ postings, long long n_rows, int W, const int* __restrict__ starts,
    const int* __restrict__ lens, const int* __restrict__ cand, int P, int Kd, int steps,
    int sample, int* __restrict__ out) {
  extern __shared__ int A[];  // the sample [ceil(len / step)]
  const int b = blockIdx.z, p = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * JOIN_CANDS, c1 = min(Kd, c0 + JOIN_CANDS);
  const long long bp = (long long)b * P + p;
  const long long start = starts[bp];
  const int len = lens[bp];
  const int* C = cand + (long long)b * Kd;
  int* O = out + bp * Kd;
  if (len <= 0) {
    for (int j = c0 + tid; j < c1; j += JOIN_THREADS) O[j] = 0;
    return;
  }
  auto row = [&](long long i) {  // range row i, clamped to the last row
    return start + i < n_rows - 1 ? start + i : n_rows - 1;
  };
  const bool reference = (len >> steps) != 0;
  const int step = reference ? len : (int)(((long long)len + sample - 1) / sample);
  const int ns = (len + step - 1) / step, cap = reference ? steps : 64;
  for (int k = tid; k < ns; k += JOIN_THREADS) A[k] = row_doc(postings, row((long long)k * step), W);
  __syncthreads();
  int c[JOIN_ILP], lo[JOIN_ILP], hi[JOIN_ILP];
#pragma unroll
  for (int u = 0; u < JOIN_ILP; ++u) {
    const int j = c0 + tid + u * JOIN_THREADS;
    c[u] = j < c1 ? C[j] : 0;
    // the first sampled doc not below c: the lower bound is in ((a - 1) step, a step]
    int a = 0, z = reference ? 0 : ns;
    while (a < z) {
      const int m = (a + z) >> 1;
      if (A[m] < c[u]) a = m + 1;
      else z = m;
    }
    lo[u] = a == 0 ? 0 : (a - 1) * step + 1;
    hi[u] = reference ? len : a < ns ? a * step : len;
  }
  // bisection of the N intervals in lockstep, at most cap steps
  for (int it = 0; it < cap; ++it) {
    int d[JOIN_ILP];
    bool any = false;
#pragma unroll
    for (int u = 0; u < JOIN_ILP; ++u) {
      if (lo[u] < hi[u]) {
        any = true;
        d[u] = row_doc(postings, row((int)(((unsigned)lo[u] + (unsigned)hi[u]) >> 1)), W);
      }
    }
    if (!any) break;
#pragma unroll
    for (int u = 0; u < JOIN_ILP; ++u) {
      if (lo[u] < hi[u]) {
        const int mid = (int)(((unsigned)lo[u] + (unsigned)hi[u]) >> 1);
        if (d[u] < c[u]) lo[u] = mid + 1;
        else hi[u] = mid;
      }
    }
  }
  // the factor word of row lo where it lies in the range and holds c
#pragma unroll
  for (int u = 0; u < JOIN_ILP; ++u) {
    const int j = c0 + tid + u * JOIN_THREADS;
    if (j >= c1) continue;
    const bool in = lo[u] < len && row_doc(postings, row(lo[u]), W) == c[u];
    O[j] = in ? row_factors(postings, row(lo[u]), W) : 0;
  }
}

// ---- K12 ------------------------------------------------------------------------
// A block a (tile of PT candidates, query): grid (ceil(K / PT), B). The block
// lists the query's live slots (min(len, L) > 0), stages the signal rows'
// coefficients once (STAGED) with each row's list of the slots whose
// coefficient is nonzero, then takes the live slots G at a time: it copies
// each one's first min(len, L) doc ids into shared memory (G x L words; G =
// 0: the searches read the rows where they lie), PREFIX_STAGE rows a thread
// in flight, and runs the reference's fixed-step search for every (slot,
// candidate) of the group against them,
// PREFIX_ILP searches a thread in lockstep; rows past min(len, L) read as
// num_docs, the mid is clamped to [0, L - 1], so each search takes the
// reference's steps and ends where it ends, whatever order the rows are in
// (a tf-ordered impact slot). A found row's factor word is read once, into
// the block's [P][PT] factor tile. Then a thread a (candidate, run of signal
// rows) issues the run's gathers together and sums each entry as
// signal_entry sums it, over the row's listed slots only (a term with a zero
// coefficient adds +-0 to a sum that is never -0: the same bits).
template <bool STAGED>
__global__ void __launch_bounds__(PREFIX_THREADS) signals_prefix_kernel(
    const int* __restrict__ postings, long long n_rows, int W, const int* __restrict__ cand, int K,
    int L, int steps, int PT, int G, SegArgs s, QueryArgs q, AggArgs a, float inv_fs,
    float* __restrict__ out) {
  extern __shared__ __align__(16) int pre_smem[];
  __shared__ int n_live;
  __shared__ int row_n[MAX_NSIG];
  __shared__ int src[MAX_NSIG];  // a row's static column; -1 none, -2 the region, -3 the update
  __shared__ float lut[NUM_REGIONS];
  __shared__ float now;
  const int b = blockIdx.y, c0 = blockIdx.x * PT, tid = threadIdx.x, P = q.P, nsig = a.nsig;
  const int nc = min(PT, K - c0);
  int* fac = pre_smem;           // [P][PT] the candidates' factor words
  int* live = fac + P * PT;      // [P] the live slots, in order
  int* lstart = live + P;        // [P] their first rows
  int* lvl = lstart + P;         // [P] their min(len, L)
  int* tile = lvl + P;           // [G][L] a group's doc ids
  float* cb = reinterpret_cast<float*>(tile + G * L);  // STAGED: [nsig][P] bm25, idf, cov
  float* ci = cb + nsig * P;
  float* cc = ci + nsig * P;
  float* cf = cc + nsig * P;     // [P] the bm25f row's
  float* sd = cf + P;            // [P] the slots' idf
  unsigned short* rl = reinterpret_cast<unsigned short*>(sd + P);  // [nsig][P] each row's slots
  const float* ab = a.bm25 + (long long)b * nsig * P;
  const float* ai = a.idf + (long long)b * nsig * P;
  const float* ac = a.cov + (long long)b * nsig * P;
  const float* af = a.bm25f + (long long)b * P;
  const float* sidf = q.idf + (long long)b * P;
  const int* C = cand + (long long)b * K;
  for (int t = tid; t < P * PT; t += PREFIX_THREADS) fac[t] = 0;
  if (STAGED) {
    for (int t = tid; t < nsig * P; t += PREFIX_THREADS) {
      cb[t] = ab[t];
      ci[t] = ai[t];
      cc[t] = ac[t];
    }
    for (int t = tid; t < P; t += PREFIX_THREADS) {
      cf[t] = af[t];
      sd[t] = sidf[t];
    }
    ab = cb, ai = ci, ac = cc, af = cf, sidf = sd;
  }
  for (int t = tid; t < nsig; t += PREFIX_THREADS)
    src[t] = t == a.region_row ? -2 : t == a.update_row ? -3 : a.static_of_sig[t];
  if (tid < NUM_REGIONS) lut[tid] = q.region_lut[b * NUM_REGIONS + tid];
  if (tid == 0) now = q.current_ts[b];
  if (tid < 32) {  // the live slots, in order
    int cnt = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
      const int p = p0 + tid;
      const int len = p < P ? q.lens[(long long)b * P + p] : 0;
      const bool on = len > 0;
      const unsigned bal = __ballot_sync(FULL_MASK, on);
      if (on) {
        const int at = cnt + __popc(bal & ((1u << tid) - 1u));
        live[at] = p;
        lstart[at] = q.starts[(long long)b * P + p];
        lvl[at] = len < L ? len : L;
      }
      cnt += __popc(bal);
    }
    if (tid == 0) n_live = cnt;
  }
  __syncthreads();
  if (STAGED) {  // each row's slots with a nonzero coefficient, in order (a warp a row)
    const int warp = tid >> 5, lane = tid & 31;
    for (int sg = warp; sg < nsig; sg += PREFIX_THREADS / 32) {
      const bool is_f = sg == a.bm25f_row;
      int cnt = 0;
      for (int p0 = 0; p0 < P; p0 += 32) {
        const int p = p0 + lane;
        const bool on = p < P && (cb[sg * P + p] != 0.0f || ci[sg * P + p] != 0.0f ||
                                  cc[sg * P + p] != 0.0f || (is_f && cf[p] != 0.0f));
        const unsigned bal = __ballot_sync(FULL_MASK, on);
        if (on) rl[sg * P + cnt + __popc(bal & ((1u << lane) - 1u))] = (unsigned short)p;
        cnt += __popc(bal);
      }
      if (lane == 0) row_n[sg] = cnt;
    }
  }
  __syncthreads();
  const int nl = n_live, per = G > 0 ? G : nl;
  for (int g0 = 0; g0 < nl; g0 += per) {
    const int ng = min(per, nl - g0);
    if (G > 0) {  // PREFIX_STAGE rows a thread in flight at once
      for (int t0 = tid; t0 < ng * L; t0 += PREFIX_THREADS * PREFIX_STAGE) {
        int d[PREFIX_STAGE];
#pragma unroll
        for (int u = 0; u < PREFIX_STAGE; ++u) {
          const int t = t0 + u * PREFIX_THREADS, gi = t / L, r = t - gi * L;
          d[u] = 0;
          if (t < ng * L && r < lvl[g0 + gi]) {
            long long row = (long long)lstart[g0 + gi] + r;
            row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
            d[u] = row_doc(postings, row, W);
          }
        }
#pragma unroll
        for (int u = 0; u < PREFIX_STAGE; ++u) {
          const int t = t0 + u * PREFIX_THREADS;
          if (t < ng * L) tile[t] = d[u];
        }
      }
      __syncthreads();
    }
    // row r of the group's slot gi: the staged doc id, or the row where it
    // lies; past min(len, L) the pad doc
    auto doc_at = [&](int gi, int r) {
      if (r >= lvl[g0 + gi]) return s.num_docs;
      if (G > 0) return tile[gi * L + r];
      long long row = (long long)lstart[g0 + gi] + r;
      row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
      return row_doc(postings, row, W);
    };
    for (int t0 = tid; t0 < ng * nc; t0 += PREFIX_THREADS * PREFIX_ILP) {
      int lo[PREFIX_ILP], hi[PREFIX_ILP], c[PREFIX_ILP], gi[PREFIX_ILP], j[PREFIX_ILP];
#pragma unroll
      for (int u = 0; u < PREFIX_ILP; ++u) {
        const int t = t0 + u * PREFIX_THREADS;
        const bool on = t < ng * nc;
        gi[u] = on ? t / nc : 0;
        j[u] = on ? t - gi[u] * nc : -1;
        c[u] = on ? C[c0 + j[u]] : 0;
        lo[u] = 0;
        hi[u] = L;
      }
      for (int st = 0; st < steps; ++st) {
#pragma unroll
        for (int u = 0; u < PREFIX_ILP; ++u) {
          const int mid = (lo[u] + hi[u]) / 2;
          const int m = mid < 0 ? 0 : (mid > L - 1 ? L - 1 : mid);
          if (doc_at(gi[u], m) < c[u]) lo[u] = mid + 1;
          else hi[u] = mid;
        }
      }
#pragma unroll
      for (int u = 0; u < PREFIX_ILP; ++u) {
        if (j[u] < 0) continue;
        const int pos = lo[u] < 0 ? 0 : (lo[u] > L - 1 ? L - 1 : lo[u]);
        if (pos < lvl[g0 + gi[u]] && doc_at(gi[u], pos) == c[u]) {
          long long row = (long long)lstart[g0 + gi[u]] + pos;
          row = row < 0 ? 0 : (row > n_rows - 1 ? n_rows - 1 : row);
          fac[live[g0 + gi[u]] * PT + j[u]] = row_factors(postings, row, W);
        }
      }
    }
    __syncthreads();
  }
  // the signal entries: a thread a (candidate, run of RPG rows), a warp
  // along the candidates of one run (coalesced stores); the thread reads its
  // candidate once and issues its rows' gathers (a static column, the
  // region id, the update time) together before it sums
  const int rg_n = max((nsig + PREFIX_MAX_RPG - 1) / PREFIX_MAX_RPG, min(nsig, PREFIX_THREADS / nc));
  const int rpg = (nsig + rg_n - 1) / rg_n;
  for (int t = tid; t < nc * rg_n; t += PREFIX_THREADS) {
    const int jj = t % nc, r0 = (t / nc) * rpg, nr = min(rpg, nsig - r0);
    const int doc = C[c0 + jj];
    const bool has_doc = doc < s.num_docs;
    int graw[PREFIX_MAX_RPG];
#pragma unroll
    for (int r = 0; r < PREFIX_MAX_RPG; ++r) {
      const int st = r < nr ? src[r0 + r] : -1;
      const int* at = !has_doc  ? nullptr
                      : st == -2 ? s.region_ids + doc
                      : st == -3 ? reinterpret_cast<const int*>(s.last_updated) + doc
                      : st >= 0  ? reinterpret_cast<const int*>(s.static_cols) + (long long)st * s.db + doc
                                 : nullptr;
      graw[r] = at != nullptr ? __ldg(at) : 0;
    }
#pragma unroll
    for (int r = 0; r < PREFIX_MAX_RPG; ++r) {
      if (r >= nr) break;
      const int sg = r0 + r, st = src[sg];
      float v = 0.0f;
      if (has_doc) {
        if (st == -2) {
          v = lut[clamp_region(graw[r])];
        } else if (st == -3) {
          v = update_score(__int_as_float(graw[r]), now);
        } else {
          const bool is_f = sg == a.bm25f_row;
          float vb = 0.0f, vf = 0.0f, vi = 0.0f, vc = 0.0f;
          const int nt = STAGED ? row_n[sg] : P;
          for (int u = 0; u < nt; ++u) {
            const int p = STAGED ? (int)rl[sg * P + u] : u;
            const float wb = ab[sg * P + p], wi = ai[sg * P + p], wc = ac[sg * P + p];
            const int f = fac[p * PT + jj];
            const float id = sidf[p], pres = f != 0 ? 1.0f : 0.0f;
            if (wb != 0.0f) vb += wb * (id * ((float)((f >> 16) & 0xFFFF) * inv_fs));
            if (is_f && af[p] != 0.0f) vf += af[p] * (id * ((float)(f & 0xFFFF) * inv_fs));
            if (wi != 0.0f) vi += wi * (id * pres);
            if (wc != 0.0f) vc += wc * pres;
          }
          v = 0.0f + vb;
          if (is_f) v = v + vf;
          v = v + vi;
          v = v + vc;
          v = v + (st >= 0 ? __int_as_float(graw[r]) : 0.0f);
        }
      }
      out[((long long)b * nsig + sg) * K + c0 + jj] = v;
    }
  }
}

// ---- K10 ----------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// element i (0 or 1) of a 32-bit word of T, in address order
template <typename T>
__device__ __forceinline__ float word_elem(unsigned w, int i) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__ushort_as_half((unsigned short)(i ? w >> 16 : w & 0xFFFFu)));
  } else {
    return __uint_as_float(i ? w & 0xFFFF0000u : w << 16);  // bf16 -> f32 is exact
  }
}

// a warp's 32 words (one a lane) sorted descending across its lanes by
// the bitonic network in shuffles
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL_MASK, x, j);
      // the lower place of a descending pair keeps the larger word
      x = (((lane & j) == 0) == ((lane & k) == 0)) ? (x > o ? x : o) : (x < o ? x : o);
    }
  return x;
}

// the 32 largest of two descending warp lists a and c, descending: a
// against c reversed, the larger of each pair (a bitonic sequence), then
// the bitonic merge
__device__ __forceinline__ unsigned long long warp_merge32(unsigned long long a,
                                                           unsigned long long c) {
  const int lane = threadIdx.x & 31;
  const unsigned long long r = __shfl_sync(FULL_MASK, c, 31 - lane);
  unsigned long long x = a > r ? a : r;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL_MASK, x, j);
    x = (lane & j) == 0 ? (x > o ? x : o) : (x < o ? x : o);
  }
  return x;
}

// the top k <= 32 of a block's n keys (0: none), as words (key, ~index):
// each warp keeps the 32 largest of its stride of keys in a warp list, 32
// keys at a time (sorted, then merged in); the warps' lists meet pairwise
// through `lists` (32 words a warp) in log2(warps) rounds; warp 0 ends with
// the block's list, descending (ties to the lower index). Every thread of
// the block calls.
__device__ unsigned long long block_top32(const unsigned* keys, int n,
                                          unsigned long long* lists) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  unsigned long long list = 0ull;
  for (int i0 = warp * 32; i0 < n; i0 += 2 * blockDim.x) {  // two batches' loads at once
    const int i = i0 + lane, i2 = i + blockDim.x;
    const unsigned key = i < n ? keys[i] : 0u, key2 = i2 < n ? keys[i2] : 0u;
    list = warp_merge32(list, warp_sort32(key != 0u ? pack_entry(key, i) : 0ull));
    list = warp_merge32(list, warp_sort32(key2 != 0u ? pack_entry(key2, i2) : 0ull));
  }
  for (int step = 1; step < nw; step <<= 1) {
    lists[threadIdx.x] = list;
    __syncthreads();
    if (warp % (2 * step) == 0 && warp + step < nw)
      list = warp_merge32(list, lists[(warp + step) * 32 + lane]);
    __syncthreads();
  }
  return list;
}

// A block a (tile of RERANK_TILE candidates, query b): a group of 8 lanes
// takes rows g and g + 64 of the tile, one after the other; each lane's
// pieces (16 B where the rows allow, else single elements) loaded RERANK_ILP
// at a time before any arithmetic (the first batch issued before the query
// is staged in shared memory, RERANK_QCH dims at a time); dot and sum of
// squares as f32 fused multiply-adds, then the lanes' shuffles; the keys to
// a [B, K] scratch. The last tile block of a query to arrive (a ticket a
// query, left at zero for the next call) selects the query's top k over
// its K keys: warp lists for k <= 32 (`block_top32`), else the shared
// top-K; no sort of all K keys.
template <typename T, bool VEC>
__global__ void __launch_bounds__(RERANK_THREADS, 2) dense_rerank_kernel(
    const T* __restrict__ emb, const float* __restrict__ qemb, const float* __restrict__ base,
    int K, int H, float weight, int k, int staged, unsigned* keys,
    unsigned long long* kv_global, unsigned* tickets, int* out_idx, float* out_scores) {
  constexpr int PE = VEC ? 16 / (int)sizeof(T) : 1;  // elements a piece
  constexpr int kGroups = RERANK_THREADS / RERANK_LANES;
  constexpr int kRows = RERANK_TILE / kGroups;      // rows a group takes
  using Piece = typename std::conditional<VEC, uint4, float>::type;
  __shared__ __align__(16) float qs[RERANK_QCH];
  __shared__ SelectState sel;
  __shared__ unsigned long long warp_lists[RERANK_THREADS];
  __shared__ bool last;
  extern __shared__ unsigned long long dyn[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int g = tid / RERANK_LANES, lane = tid % RERANK_LANES;
  const int r0 = blockIdx.x * RERANK_TILE + g;
  float bs[kRows], dot[kRows] = {}, ss[kRows] = {};
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = r0 + rr * kGroups;
    bs[rr] = r < K ? base[(long long)b * K + r] : 0.0f;
  }
  Piece v[RERANK_ILP];
  // a batch of row rr's pieces j0, j0 + 8, ... of the chunk at c0 into v
  auto load = [&](int rr, int c0, int np, int j0) {
    const T* row = emb + ((long long)b * K + r0 + rr * kGroups) * H + c0;
#pragma unroll
    for (int u = 0; u < RERANK_ILP; ++u) {
      const int j = j0 + u * RERANK_LANES;
      if constexpr (VEC) {
        if (j < np) v[u] = *reinterpret_cast<const uint4*>(row + j * PE);
      } else {
        v[u] = j < np ? to_f32(row[j]) : 0.0f;
      }
    }
  };
  auto accumulate = [&](int rr, int np, int j0) {
#pragma unroll
    for (int u = 0; u < RERANK_ILP; ++u) {
      const int j = j0 + u * RERANK_LANES;
      if (j >= np) continue;
      if constexpr (VEC) {
        const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        const float4* q4 = reinterpret_cast<const float4*>(qs + j * PE);
#pragma unroll
        for (int c = 0; c < PE / 4; ++c) {
          const float4 q = q4[c];
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int el = 4 * c + e;
            const float x = word_elem<T>(w[el * (int)sizeof(T) / 4], el % (4 / (int)sizeof(T)));
            dot[rr] = __fmaf_rn(x, qv[e], dot[rr]);
            ss[rr] = __fmaf_rn(x, x, ss[rr]);
          }
        }
      } else {
        dot[rr] = __fmaf_rn(v[u], qs[j], dot[rr]);
        ss[rr] = __fmaf_rn(v[u], v[u], ss[rr]);
      }
    }
  };
  for (int c0 = 0; c0 < H; c0 += RERANK_QCH) {
    const int ch = min(RERANK_QCH, H - c0), np = ch / PE;
    if (r0 < K) load(0, c0, np, lane);  // in flight while the query is staged
    if (c0 > 0) __syncthreads();
    for (int h = tid; h < ch; h += RERANK_THREADS) qs[h] = qemb[(long long)b * H + c0 + h];
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      if (r0 + rr * kGroups >= K) continue;
      for (int j0 = lane; j0 < np; j0 += RERANK_LANES * RERANK_ILP) {
        if (rr > 0 || j0 > lane) load(rr, c0, np, j0);
        accumulate(rr, np, j0);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
#pragma unroll
    for (int o = RERANK_LANES / 2; o > 0; o >>= 1) {
      dot[rr] += __shfl_xor_sync(FULL_MASK, dot[rr], o);
      ss[rr] += __shfl_xor_sync(FULL_MASK, ss[rr], o);
    }
    const int r = r0 + rr * kGroups;
    if (lane == 0 && r < K) {
      const float norm = sqrtf(ss[rr]);
      const float sim = norm > 1e-6f ? dot[rr] / fmaxf(norm, 1e-6f) : 0.0f;
      keys[(long long)b * K + r] = order_key(bs[rr] + weight * sim);
    }
  }
  // the last block of the query to arrive takes its top k
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[b], 1u) == gridDim.x - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) tickets[b] = 0u;
  const long long o = (long long)b * k;
  if (k <= 32) {
    const unsigned long long top = block_top32(keys + (long long)b * K, K, warp_lists);
    if (tid < k) {
      out_idx[o + tid] = entry_payload(top);
      out_scores[o + tid] = key_value(entry_key(top));
    }
    return;
  }
  unsigned long long* kv = staged ? dyn : kv_global + (long long)b * next_pow2(k);
  BlockScope scope;
  top_keys<true>(scope, sel, keys + (long long)b * K, K, k, [](int i) { return i; }, kv,
                 [&](int pos, unsigned kx, int i) {
                   out_idx[o + pos] = i;
                   out_scores[o + pos] = key_value(kx);
                 });
}

// ---- K9 -----------------------------------------------------------------------
template <class T>
__device__ __forceinline__ const T* mesh_list(const T* const* tab, const MeshLists& t, int j,
                                              int K, int b) {
  const int e = j < t.ntab ? j : t.ntab - 1;
  return tab[e] + (long long)(j - e) * K + (long long)b * t.qstride;
}

// A block a (list i, query b). Every block stages the query's N keys (+0
// above -0) and checks that each list is non-increasing in them. Where
// all are (the merge form: each shard's list comes from a top-K), the entry
// at position p < k of list i has the global rank r = p + #{entries of lists
// j < i with key >= its key} + #{entries of lists j > i with key > its
// key}, lax.top_k's order (ties to the lower list, then the lower
// position); each count is a bisection over list j's first k - r keys, and
// the entry is written at r where r < k. Ranks are independent, so the n
// blocks of a query need nothing of each other. Where a list is not
// non-increasing (the select form), block 0 takes the shared top-K over the
// N keys and the other blocks leave. forms (null: not written) gets 0
// (merge) or 1 (select) a query.
__global__ void __launch_bounds__(1024) mesh_topk_kernel(
    const MeshLists t, int n, int K, int k, int* __restrict__ out_docs,
    int* __restrict__ out_shards, float* __restrict__ out_scores, int* __restrict__ forms) {
  __shared__ unsigned keys[MESH_MAX_N];
  __shared__ unsigned long long kv[MESH_MAX_K];
  __shared__ SelectState sel;
  const int i = blockIdx.x, b = blockIdx.y, N = n * K;
  for (int j = 0; j < n; ++j) {
    const float* row = mesh_list(t.scores, t, j, K, b);
    for (int p = threadIdx.x; p < K; p += blockDim.x) {
      const float x = row[p];
      keys[j * K + p] = order_key(x);
    }
  }
  __syncthreads();
  int rising = 0;
  for (int e = threadIdx.x; e < N; e += blockDim.x)
    rising |= (e + 1) % K != 0 && keys[e] < keys[e + 1];
  const bool merge = !__syncthreads_or(rising);
  const long long o = (long long)b * k;
  if (forms != nullptr && i == 0 && threadIdx.x == 0) forms[b] = merge ? 0 : 1;
  if (!merge) {
    if (i != 0) return;
    // every key is nonzero (order_key maps each float above 0), so k of them
    // win: those above the k-th and its ties in index order, sorted with
    // ties to the lower index
    BlockScope scope;
    top_keys<true>(scope, sel, keys, N, k, [](int e) { return e; }, kv,
                   [&](int pos, unsigned key, int e) {
                     const int j = e / K;
                     out_docs[o + pos] = mesh_list(t.docs, t, j, K, b)[e - j * K];
                     out_shards[o + pos] = j;
                     out_scores[o + pos] = key_value(key);
                   });
    return;
  }
  const unsigned* mine = keys + i * K;
  const int* docs = mesh_list(t.docs, t, i, K, b);
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    const unsigned x = mine[p];
    int r = p;
    for (int j = 0; j < n && r < k; ++j) {
      if (j == i) continue;
      const unsigned* l = keys + j * K;
      int lo = 0, hi = k - r;  // a count of k - r or more puts the entry past k
      if (j < i) {
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (l[mid] >= x) lo = mid + 1;
          else hi = mid;
        }
      } else {
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (l[mid] > x) lo = mid + 1;
          else hi = mid;
        }
      }
      r += lo;
    }
    if (r < k) {
      out_docs[o + r] = docs[p];
      out_shards[o + r] = i;
      out_scores[o + r] = key_value(x);
    }
  }
}

// a launch of kernel over (cluster x B) blocks of `threads` threads in
// clusters of `cluster`, with smem bytes of dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int cluster, int B, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
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
  cfg.blockDim = dim3(threads);
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
  return (int)launch_clusters(stage_a_kernel, cluster, n, SELECT_THREADS, smem, stream, postings,
                              n_rows, row_w, *s, *q, rows, ub_entry, ub_total, L, inv_fs, T,
                              default_static, soft_required, K, gkey, gsum, gmask, gaux,
                              keys_on_chip, out_docs, out_scores);
}

// K13. Stage A through the merge network: P (a power of two >= 2) tiles of
// L (a power of two) posting rows per query, row_w as K1, N = P*L <= 2^24.
// cluster 1: the query's N <= MERGE_TILE entries in one block's shared
// memory, one launch (ops/kernels.py merge_plan). cluster 0: the global
// form (N a multiple of MERGE_TILE), the network rows mkey i32[B, N], mcon
// f32[B, N], maux i32[B, N] (null unless default_static; the tail's ordered
// keys go over mcon) and the tiles' totals tsum i32[B, N / MERGE_TILE, 5]
// (K > 0) as scratch. K = 0 runs the network alone: its output goes to
// mkey, mcon and maux (maux null: the aux words are not carried) in either
// form. Out: docs i32[B*K], scores f32[B*K], score-descending.
int stract_stage_a_merge(const SegArgs* s, const QueryArgs* q, const int* postings,
                         long long n_rows, int row_w, const float* ub_entry,
                         const float* ub_total, int L, int K, int cluster, int default_static,
                         int soft_required, float inv_fs, int* mkey, float* mcon, int* maux,
                         int* tsum, int* out_docs, float* out_scores, cudaStream_t stream) {
  const int P = q->P;
  if (P < 2 || (P & (P - 1)) != 0 || L < 1 || (L & (L - 1)) != 0 ||
      (long long)P * L > (1ll << 24) || q->B < 1 || q->B > 65535 || K < 0 || K > MAX_SORT ||
      (row_w != 2 && row_w != 3) || n_rows < 1 || (cluster != 0 && cluster != 1) ||
      (K > 0 && ((ub_entry == nullptr) != (ub_total == nullptr) || out_docs == nullptr ||
                 out_scores == nullptr)) ||
      ((K == 0 || cluster == 0) && (mkey == nullptr || mcon == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int N = P * L;
  // the aux words travel with the entries where the static score reads them
  const bool aux = K == 0 ? maux != nullptr : default_static != 0;
  if (cluster == 1) {
    if (N > MERGE_TILE) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)N * 12 + (K > 0 ? (size_t)next_pow2(K) * 8 : 0);
    auto kernel = aux ? merge_block_kernel<true> : merge_block_kernel<false>;
    return (int)launch_clusters(kernel, 1, q->B, MERGE_THREADS, smem, stream, postings, n_rows,
                                row_w, *s, *q, ub_entry, ub_total, L, inv_fs, N, soft_required,
                                K, mkey, mcon, aux ? maux : nullptr, out_docs, out_scores);
  }
  // the global form: tiles of MERGE_TILE entries
  if (N % MERGE_TILE != 0 || (aux && maux == nullptr) || (K > 0 && tsum == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tile = MERGE_TILE, tiles = N / tile;
  const size_t smem = (size_t)tile * 12;
  auto tile_kernel = aux ? merge_tile_kernel<true> : merge_tile_kernel<false>;
  int* net_aux = aux ? maux : nullptr;
  cudaError_t err =
      cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the fetch, and every round whose merged rows fit a tile
  int h_hi = 0;
  for (int h = L; 2 * h <= tile; h <<= 1) h_hi = h;
  const dim3 grid(tiles, q->B);
  tile_kernel<<<grid, MERGE_THREADS, smem, stream>>>(postings, n_rows, row_w, *q, ub_entry, L,
                                                     inv_fs, s->num_docs, mkey, mcon, net_aux, N,
                                                     tile, 1, 0, h_hi ? L : 0, h_hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // longer rounds: the flip and the long strides in global memory, the rest
  // of the round in tiles
  for (int m = h_hi ? 4 * h_hi : 2 * L; m <= N; m <<= 1) {
    merge_flip_kernel<<<dim3((N / 4 + 255) / 256, q->B), 256, 0, stream>>>(mkey, mcon, net_aux,
                                                                         N, m / 2);
    int d = m / 4;
    for (; 2 * d > tile; d >>= 1)
      merge_stage_kernel<<<dim3((N / 2 + 255) / 256, q->B), 256, 0, stream>>>(mkey, mcon,
                                                                            net_aux, N, d);
    tile_kernel<<<grid, MERGE_THREADS, smem, stream>>>(postings, n_rows, row_w, *q, ub_entry, L,
                                                       inv_fs, s->num_docs, mkey, mcon, net_aux,
                                                       N, tile, 0, d, 0, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (K == 0) return (int)cudaSuccess;
  RunSum* sums = reinterpret_cast<RunSum*>(tsum);
  merge_tail_sum_kernel<<<grid, MERGE_THREADS, 0, stream>>>(mkey, mcon, N, sums);
  merge_tail_keys_kernel<<<grid, MERGE_THREADS, 0, stream>>>(mkey, mcon, net_aux, N, sums, *s,
                                                             *q, ub_entry, ub_total,
                                                             soft_required);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the select over the fewest blocks a query (2, 4 or 8) whose keys fit
  // their shared memory beside the sort buffer and the other blocks' runs
  // (8, in global memory, past that): a query's candidates lie at the front
  // of its merged order, the pads behind them, so its first block does most
  // of the select, and fewer blocks a query run more queries at once
  const size_t S8 = (size_t)next_pow2(K) * 8;
  int sel = 2;
  while (sel < MAX_CLUSTER && 2 * S8 + (size_t)(N / sel) * 4 > (size_t)MAX_DYN_SMEM) sel *= 2;
  const size_t part = (size_t)(N / sel) * 4;
  const int keys_on_chip = 2 * S8 + part <= (size_t)MAX_DYN_SMEM;
  return (int)launch_clusters(merge_select_kernel, sel, q->B, SELECT_THREADS,
                              2 * S8 + (keys_on_chip ? part : 0), stream, mkey,
                              reinterpret_cast<const unsigned*>(mcon), N, s->num_docs, K,
                              keys_on_chip, out_docs, out_scores);
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
  return (int)launch_clusters(stage_b_kernel, cluster, q->B, SELECT_THREADS, smem, stream, factors,
                              cand, Kd, *s, *q, *a, default_static, inv_fs, k, ks, (int)staged,
                              out_docs, out_scores, out_sq, out_scale);
}

// K3. factors i32[B, P, K], cand i32[B, K] and each query's rows of `a` ->
// q i16[B, nsig, K], scale f32[B, nsig]; or (out_q null) the f32 rows
// `rows` [B, nsig, K]. staged: the coefficients in shared memory; rows
// non-null with out_q: the q16 form's values wait there (f32 [B, nsig, K]),
// null: in shared memory. ops/kernels.py signals_plan picks both within
// MAX_DYN_SMEM.
int stract_signals_q16(const SegArgs* s, const SignalArgs* a, const int* factors, const int* cand,
                       int B, int K, float inv_fs, int staged, float* rows, short* out_q,
                       float* out_scale, cudaStream_t stream) {
  if (K < 1 || B < 1 || B > 65535 || a->P < 1 || a->nsig < 1 ||
      (out_q == nullptr && rows == nullptr) || (out_q != nullptr && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (staged ? (size_t)(3 * SIG_ROWS + 3) * a->P * 4 : 0) +
                      (rows == nullptr ? (size_t)SIG_ROWS * K * 4 : 0);
  if (smem > (size_t)MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? signals_q16_kernel<true> : signals_q16_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = K % 8 == 0 && (reinterpret_cast<uintptr_t>(out_q) & 15) == 0;
  const dim3 grid(B, (a->nsig + SIG_ROWS - 1) / SIG_ROWS);
  kernel<<<grid, SIG_THREADS, smem, stream>>>(factors, cand, K, *s, *a, inv_fs, vec, rows, out_q,
                                              out_scale);
  return (int)cudaGetLastError();
}

// K11. postings i32[n_rows, row_w]; starts, lens i32[B, P]; cand i32[B, Kd] ->
// out i32[B, P, Kd], the ranges doc-ascending. Each range is sampled at up
// to `sample` <= JOIN_CAP docs (ops/kernels.py join_plan); steps is the
// reference's step count, the bit length of n_rows - 1 (at least 1).
int stract_factors_join(const int* postings, long long n_rows, int row_w, const int* starts,
                        const int* lens, const int* cand, int B, int P, int Kd, int steps,
                        int sample, int* out, cudaStream_t stream) {
  if (B < 1 || B > 65535 || P < 1 || P > 65535 || Kd < 1 || n_rows < 1 ||
      (row_w != 2 && row_w != 3) || steps < 1 || steps > 62 || sample < 1 || sample > JOIN_CAP)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)sample * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Kd + JOIN_CANDS - 1) / JOIN_CANDS, P, B);
  join_kernel<<<grid, JOIN_THREADS, smem, stream>>>(postings, n_rows, row_w, starts, lens, cand,
                                                    P, Kd, steps, sample, out);
  return (int)cudaGetLastError();
}

// K12: pass 2 from the first L >= 1 rows of each slot, `steps` search steps.
// cand i32[B, K] -> out f32[B, nsig, K]. A block takes `cands` candidates
// and stages `group` slots' prefixes at a time (0: none, the rows read
// where they lie), and the coefficients where `staged`; ops/kernels.py
// prefix_plan picks all three within MAX_DYN_SMEM.
int stract_signals_prefix(const SegArgs* s, const QueryArgs* q, const AggArgs* a,
                          const int* postings, long long n_rows, int row_w, const int* cand, int K,
                          int L, int steps, int cands, int group, int staged, float inv_fs,
                          float* out, cudaStream_t stream) {
  if (K < 1 || q->B < 1 || q->B > 65535 || q->P < 1 || q->P > PREFIX_MAX_P || a->nsig < 1 ||
      a->nsig > MAX_NSIG || n_rows < 1 || (row_w != 2 && row_w != 3) || L < 1 || steps < 1 ||
      out == nullptr || cands < 1 || cands > PREFIX_MAX_CANDS || group < 0 || group > q->P)
    return (int)cudaErrorInvalidValue;
  const long long P = q->P, nsig = a->nsig;
  const long long smem = 4 * (P * cands + 3 * P + (long long)group * L) +
                         (staged ? 4 * (3 * nsig + 2) * P + 2 * nsig * P : 0);
  if (smem > MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = staged ? signals_prefix_kernel<true> : signals_prefix_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((K + cands - 1) / cands), q->B);
  kernel<<<grid, PREFIX_THREADS, (size_t)smem, stream>>>(postings, n_rows, row_w, cand, K, L,
                                                         steps, cands, group, *s, *q, *a,
                                                         inv_fs, out);
  return (int)cudaGetLastError();
}

// K10. emb [B, K, H] of dtype 0 = f32, 1 = f16, 2 = bf16; qemb f32[B, H];
// base f32[B, K] -> out_idx i32[B, k], out_scores f32[B, k], score-descending,
// +0 above -0, ties to the lower index (lax.top_k's order). scratch: the
// keys u32[B, K], then (past RERANK_STAGE winners) the winners' sort buffer
// u64[B, next_pow2(k)] at the next 8-byte boundary; tickets u32[B], zero
// (and left at zero).
int stract_dense_rerank(const void* emb, int dtype, const float* qemb, const float* base, int B,
                        int K, int H, float weight, int k, void* scratch, unsigned* tickets,
                        int* out_idx, float* out_scores, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || H < 1 || k < 1 || k > K || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int staged = next_pow2(k) <= RERANK_STAGE;
  const size_t smem = staged ? sizeof(unsigned long long) * next_pow2(k) : 0;
  unsigned* keys = (unsigned*)scratch;
  unsigned long long* kv =
      (unsigned long long*)((char*)scratch + ((sizeof(unsigned) * B * (size_t)K + 7) & ~(size_t)7));
  const dim3 grid((unsigned)((K + RERANK_TILE - 1) / RERANK_TILE), (unsigned)B);
  int err = 0;
  auto launch = [&](auto kernel, auto* rows) {
    if (smem > 16 * 1024) {  // with the ~21 KB of static shared memory, past 48 KB
      err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
      if (err) return;
    }
    kernel<<<grid, RERANK_THREADS, smem, stream>>>(rows, qemb, base, K, H, weight, k, staged,
                                                  keys, kv, tickets, out_idx, out_scores);
    err = (int)cudaGetLastError();
  };
  auto typed = [&](auto* e) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(e)>>;
    if (((size_t)H * sizeof(T)) % 16 == 0 && (uintptr_t)emb % 16 == 0)
      launch(dense_rerank_kernel<T, true>, e);
    else
      launch(dense_rerank_kernel<T, false>, e);
  };
  if (dtype == 0) typed((const float*)emb);
  else if (dtype == 1) typed((const __half*)emb);
  else typed((const __nv_bfloat16*)emb);
  return err;
}

// K9: the table's n lists of K entries a query (each descending for the
// merge form; any order takes the select form) -> out_docs, out_shards
// i32[B, k], out_scores f32[B, k], lax.top_k over the n*K entries in list
// order: descending, ties (and the -inf pads) to the lower list, then the
// lower position; forms i32[B] (null: not written) 0 where a query took the
// merge, 1 the select.
int stract_mesh_topk(const MeshLists* t, int B, int n, int K, int k, int* out_docs,
                     int* out_shards, float* out_scores, int* forms, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n < 1 || K < 1 || (long long)n * K > MESH_MAX_N || k < 1 ||
      k > K || k > MESH_MAX_K || t->ntab < 1 || t->ntab > MESH_MAX_LISTS ||
      (t->ntab != 1 && t->ntab != n))
    return (int)cudaErrorInvalidValue;
  mesh_topk_kernel<<<dim3(n, B), 1024, 0, stream>>>(*t, n, K, k, out_docs, out_shards,
                                                     out_scores, forms);
  return (int)cudaGetLastError();
}

}  // extern "C"
