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
// Built with --fmad=false so a*b+c rounds like the separate multiply and add
// of the reference and the plain PyTorch versions.

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
__global__ void stage_a_insert(const int* __restrict__ postings, long long n_rows, QueryArgs q,
                               int L, float inv_fs, int* tkey, float* tsum,
                               unsigned long long* tmask, int* taux, int T) {
  const int b = blockIdx.y;
  const int P = q.P;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P * L) return;
  const int p = e / L, l = e - p * L;
  const int bp = b * P + p;
  const int len = min(q.lens[bp], L);
  if (l >= len) return;
  long long st = q.starts[bp];
  st = st > n_rows - L ? n_rows - L : st;
  st = st < 0 ? 0 : st;
  const int* row = postings + (st + l) * 3;
  const int doc = row[0], fac = row[1], aux = row[2];
  const float f1 = (float)((fac >> 16) & 0xFFFF) * inv_fs;
  const float f2 = (float)(fac & 0xFFFF) * inv_fs;
  const float contrib = q.w_bm25[bp] * f1 + q.w_bm25f[bp] * f2 +
                        q.w_presence[bp] * (fac != 0 ? 1.0f : 0.0f);
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
  taux[slot] = aux;  // the aux word is a function of the doc: every writer agrees
}

__global__ void __launch_bounds__(1024) stage_a_select(
    const int* __restrict__ tkey, const float* __restrict__ tsum,
    const unsigned long long* __restrict__ tmask, const int* __restrict__ taux,
    unsigned* __restrict__ skey, int T, SegArgs s, QueryArgs q, int default_static,
    int soft_required, int K, int S, int* out_docs, float* out_scores) {
  __shared__ unsigned hist[256];
  __shared__ unsigned sh_prefix, sh_krem, cnt_hi, cnt_tie;
  __shared__ unsigned sk[MAX_SORT];
  __shared__ int si[MAX_SORT];
  const int b = blockIdx.x;
  const long long base = (long long)b * T;
  const int nreq = q.n_required[b];

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
      float total = tsum[base + i] + st;
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

  // radix select of the K-th largest key, 8 bits per round, MSB first
  unsigned prefix = 0, mask = 0, krem = (unsigned)K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) {
      const unsigned k = skey[base + i];
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
    const unsigned k = skey[base + i];
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
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const unsigned k = sk[j];
    const bool ok = k != 0;
    out_docs[(long long)b * K + j] = ok ? tkey[base + si[j]] : s.num_docs;
    out_scores[(long long)b * K + j] = ok ? key_value(k) : -INFINITY;
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

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// K1. Scratch: tkey i32[B*T], tsum f32[B*T], tmask u64[B*T], taux i32[B*T],
// skey u32[B*T]; T a power of two >= max(2*P*L, K). Out: docs i32[B*K],
// scores f32[B*K], score-descending.
int stract_stage_a(const SegArgs* s, const QueryArgs* q, const int* postings, long long n_rows,
                   int L, int K, int T, int default_static, int soft_required, float inv_fs,
                   int* tkey, float* tsum, unsigned long long* tmask, int* taux, unsigned* skey,
                   int* out_docs, float* out_scores, cudaStream_t stream) {
  if (K < 1 || K > MAX_SORT || T < K || (T & (T - 1)) != 0 || q->B < 1) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)q->B * (size_t)T;
  cudaError_t err = cudaMemsetAsync(tkey, 0xFF, n * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(tsum, 0, n * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(tmask, 0, n * sizeof(unsigned long long), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(taux, 0, n * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int entries = q->P * L;
  dim3 grid((entries + 255) / 256, q->B);
  stage_a_insert<<<grid, 256, 0, stream>>>(postings, n_rows, *q, L, inv_fs, tkey, tsum, tmask, taux, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stage_a_select<<<q->B, 1024, 0, stream>>>(tkey, tsum, tmask, taux, skey, T, *s, *q, default_static,
                                            soft_required, K, next_pow2(K), out_docs, out_scores);
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

}  // extern "C"
