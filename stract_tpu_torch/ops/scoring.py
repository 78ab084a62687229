"""Query-time scoring on torch tensors — the port of stract_tpu/ops/scoring.py.

Three device programs carry a search (the JAX package's jitted XLA programs;
it has no Pallas kernel):

  stage A  score_candidates_batch      candidate scan over P slices of L
                                       posting rows (q16 or q8), join by doc,
                                       top-C; optionally block-max UB scoring;
                                       with merge=True the join follows the
                                       P-way bitonic merge of the [P, L] tiles
  stage B  score_driver_batch[_with_signals]
                                       exact verify over host-joined factor
                                       columns, top-k, fused q16 signals
           score_driver_joined[_batch] the same verify with the factors
                                       joined on the device (factors_join)
  pass 2   compute_signals_from_factors_batch_q16
                                       signal rows of the final page
           compute_signals_joined[_batch[_q16]]
                                       the same with the device join
           compute_signals[_batch]     from the slots' first L rows only

Each has a plain PyTorch version here (`*_plain`), written after the JAX
program, and a hand-written CUDA kernel (csrc/scoring.cu, ops/kernels.py).
The public functions pick by where the segment's tensors live: CPU tensors
take the plain version, CUDA tensors launch the kernel (or raise). There is
no fallback from one to the other.

Layouts and constants are the JAX package's, so results compare like with
like: the [Ptot, 3] posting rows (doc | q16 f1 << 16 | q16 f2 | aux word) or
the [Ptot, 2] q8 rows (index/device.py quantize_rows_q8), the 6-bit group
encoding, the 46-row signal matrix.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ranking import bm25_math as BM
from ..ranking import signals as S

from . import kernels

# default sizes, read from the same variables as the JAX package so both
# packages run at one shape (the tests shrink L and K)
DEFAULT_P = int(os.environ.get("STRACT_TPU_P", 64))
DEFAULT_L = int(os.environ.get("STRACT_TPU_L", 1024))
DEFAULT_K = int(os.environ.get("STRACT_TPU_K", 1024))

NUM_REGIONS = 16

# Term-group encoding in QuerySlots.group (6 bits, packed into the join key):
#   0..MAX_GROUPS-1  required group (MUST)
#   OPTIONAL_GROUP   scoring-only slot (SHOULD)
#   EXCLUDED_GROUP   exclusion (MUST_NOT)
MAX_GROUPS = 32
OPTIONAL_GROUP = 62
EXCLUDED_GROUP = 63
GROUP_BITS = 6
# key = doc << 6 | group → doc ids stay below 2^25 per segment
MAX_SEGMENT_DOCS = (1 << 25) - 2

# tf factors live in [0, K1+1), quantised to 16 bits
FACTOR_SCALE = 65535.0 / (BM.K1 + 1.0)
# the f32 multiplier every decode uses (the JAX package's weak-typed constant)
INV_FACTOR_SCALE = float(np.float32(1.0 / FACTOR_SCALE))

# aux word: q16 static score | 4-bit region | 12-bit days since DAYS_EPOCH
DAYS_EPOCH = 1577836800.0  # 2020-01-01
AUX_REGION_SHIFT = 12
AUX_DAYS_MASK = (1 << 12) - 1

# static column stack (order is a contract with index/device.py)
STATIC_COLUMNS = [
    "host_centrality",
    "host_centrality_rank",
    "page_centrality",
    "page_centrality_rank",
    "is_homepage",
    "fetch_time_ms",
    "tracker_score",
    "num_path_and_query_digits",
    "num_path_and_query_slashes",
    "link_density",
    "likely_has_ads",
]
NUM_STATIC = len(STATIC_COLUMNS)
STATIC_SIGNAL_IDS = [
    S.HOST_CENTRALITY.id, S.HOST_CENTRALITY_RANK.id, S.PAGE_CENTRALITY.id,
    S.PAGE_CENTRALITY_RANK.id, S.IS_HOMEPAGE.id, S.FETCH_TIME_MS.id,
    S.TRACKER_SCORE.id, S.URL_DIGITS.id, S.URL_SLASHES.id, S.LINK_DENSITY.id,
    S.HAS_ADS.id,
]
DEFAULT_STATIC_COEFFS = np.array(
    [S.signal(sid).default_coefficient for sid in STATIC_SIGNAL_IDS], dtype=np.float32
)
# one-hot placing static column rows into the signal matrix
_STATIC_SELECT = np.zeros((S.NUM_SIGNALS, NUM_STATIC), dtype=np.float32)
for _row, _sid in enumerate(STATIC_SIGNAL_IDS):
    _STATIC_SELECT[_sid, _row] = 1.0
# the same placement as a row map for the kernels: signal row → column or -1
_STATIC_OF_SIG = np.full(S.NUM_SIGNALS, -1, dtype=np.int32)
_STATIC_OF_SIG[STATIC_SIGNAL_IDS] = np.arange(NUM_STATIC, dtype=np.int32)

# Soft-required candidate ranking: each required group present adds the
# query's soft_bonus (>= this), so full boolean matches fill the top-C first.
SOFT_REQUIRED_BONUS = 16384.0


class SegmentArrays(NamedTuple):
    """A segment's query-time tensors (index/device.py uploads them once).

    postings rows: [:, 0] doc id, [:, 1] q16(bm25 f) << 16 | q16(bm25f f),
    [:, 2] q16(default static) << 16 | region << 12 | days12; or the q8
    layout's two words per row (_decode_rows). static_scale
    and num_docs are 0-dim CPU tensors: they are launch arguments, and reading
    them must not wait for the card."""

    postings: torch.Tensor        # i32[Ptot, 3] (q16 rows) or i32[Ptot, 2] (q8 rows)
    static_cols: torch.Tensor     # f32[NUM_STATIC, DB]
    static_default: torch.Tensor  # f32[DB]
    static_scale: torch.Tensor    # f32 scalar (CPU)
    region_ids: torch.Tensor      # i32[DB]
    last_updated: torch.Tensor    # f32[DB] unix seconds
    num_docs: torch.Tensor        # i32 scalar (CPU)


class QuerySlots(NamedTuple):
    """Per-query slot arrays, P entries (ranking/computer.py builds them as
    numpy; the functions below move them next to the segment). Batched forms
    carry a leading [B] dimension on every field."""

    starts: torch.Tensor         # i32[P]
    lens: torch.Tensor           # i32[P]
    group: torch.Tensor          # i32[P]
    n_required: torch.Tensor     # i32 scalar
    idf: torch.Tensor            # f32[P]
    w_bm25: torch.Tensor         # f32[P]
    w_bm25f: torch.Tensor        # f32[P]
    w_presence: torch.Tensor     # f32[P]
    static_coeffs: torch.Tensor  # f32[NUM_STATIC]
    region_lut: torch.Tensor     # f32[NUM_REGIONS]
    coeff_region: torch.Tensor   # f32 scalar
    coeff_update: torch.Tensor   # f32 scalar
    current_ts: torch.Tensor     # f32 scalar
    soft_bonus: torch.Tensor     # f32 scalar


class QueryAggregates(NamedTuple):
    """Pass-2 aggregation matrices ([46, P] each, agg_bm25f [1, P])."""

    agg_bm25: torch.Tensor
    agg_bm25f: torch.Tensor
    agg_idf: torch.Tensor
    agg_cov: torch.Tensor


_INT_FIELDS = {"postings", "region_ids", "num_docs", "starts", "lens", "group", "n_required"}
_CPU_FIELDS = {"static_scale", "num_docs"}


def to_tensors(tup, device):
    """A SegmentArrays / QuerySlots / QueryAggregates of numpy arrays (or
    tensors) → the same tuple of contiguous tensors on `device` (i32 for the
    integer fields, f32 for the rest). Segment scalars stay on the CPU."""
    out = []
    for name, x in zip(tup._fields, tup):
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        dev = "cpu" if (name in _CPU_FIELDS and isinstance(tup, SegmentArrays)) else device
        if isinstance(x, torch.Tensor):
            t = x.to(device=dev, dtype=dtype)
        else:
            t = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        out.append(t.contiguous())
    return type(tup)(*out)


def stack(tuples: list):
    """Stack per-query tuples into one batched tuple (numpy, on the host)."""
    first = tuples[0]
    return type(first)(*[np.stack([np.asarray(x) for x in xs]) for xs in zip(*tuples)])


def _batched(x, cls):
    """Coerce a QuerySlots / QueryAggregates of any origin (the JAX package's
    tuples included) to this module's class, field by field."""
    return x if isinstance(x, cls) else cls(*x)


# ---- shared plain helpers ---------------------------------------------------------
def _decode_rows(rows):
    """Posting rows → (docs, packed q16 factors, aux). Width 3 is the native
    q16 layout; width 2 is the q8 layout (index/device.py quantize_rows_q8),
    widened q8*257."""
    if rows.shape[-1] == 3:
        return rows[..., 0], rows[..., 1], rows[..., 2]
    w0, w1 = rows[..., 0], rows[..., 1]
    docs = (w0 >> 7) & 0x1FFFFFF
    f1 = ((w1 >> 24) & 0xFF) * 257
    f2 = ((w1 >> 16) & 0xFF) * 257
    s16 = ((w1 >> 8) & 0xFF) * 257
    days = (w1 & 0xFF) * 16
    factors = (f1 << 16) | f2  # wraps negative for f1q16 >= 32768, by design
    aux = (s16 << 16) | (((w0 >> 3) & 0xF) << AUX_REGION_SHIFT) | days
    return docs, factors, aux


def _unpack_factors(factors):
    # >> is arithmetic on i32: the mask undoes the sign extension of the high half
    f1 = ((factors >> 16) & 0xFFFF).to(torch.float32) * INV_FACTOR_SCALE
    f2 = (factors & 0xFFFF).to(torch.float32) * INV_FACTOR_SCALE
    return f1, f2


def update_score(ts, now):
    """bm25_math.score_update_timestamp in f32 (floor division as jnp's)."""
    hours = torch.div(torch.clamp(now - ts, min=1.0), 3600.0, rounding_mode="floor")
    fresh = BM.UPDATE_HALF_LIFE_HOURS / (hours + BM.UPDATE_HALF_LIFE_HOURS)
    valid = (ts < now) & (ts > 0) & (hours < BM.UPDATE_CACHE_HOURS)
    return torch.where(valid, fresh, torch.zeros_like(fresh))


def _query_static(seg, q, docs, default_static: bool):
    """Column-signal score for doc ids [B, N]."""
    if default_static:
        score = seg.static_default[docs]
    else:
        cols = seg.static_cols[:, docs]  # [NUM_STATIC, B, N]
        score = torch.einsum("bs,sbn->bn", q.static_coeffs, cols)
    region = torch.clamp(seg.region_ids[docs], 0, NUM_REGIONS - 1).long()
    score = score + q.coeff_region[:, None] * torch.gather(q.region_lut, 1, region)
    upd = update_score(seg.last_updated[docs], q.current_ts[:, None])
    return score + q.coeff_update[:, None] * upd


def _aux_static_score(q, aux, static_scale: float):
    """The same score carried per posting in the aux word (no gathers)."""
    static = ((aux >> 16) & 0xFFFF).to(torch.float32) * static_scale
    region = ((aux >> AUX_REGION_SHIFT) & 0xF).long()
    region_score = torch.gather(q.region_lut, 1, region)
    days = (aux & AUX_DAYS_MASK).to(torch.float32)
    ts = days * 86400.0 + DAYS_EPOCH
    upd = update_score(torch.where(days > 0, ts, torch.zeros_like(ts)), q.current_ts[:, None])
    return static + q.coeff_region[:, None] * region_score + q.coeff_update[:, None] * upd


def _segment_sum_at_ends(values, is_end):
    """Per-row sums of runs ending at is_end (any sign): previous run end by a
    cummax over positions."""
    csum = torch.cumsum(values, dim=-1)
    n = values.shape[-1]
    idx = torch.arange(n, device=values.device).expand_as(values)
    end_pos = torch.where(is_end, idx, torch.full_like(idx, -1))
    shifted = torch.cat([torch.full_like(end_pos[:, :1], -1), end_pos[:, :-1]], dim=1)
    prev_pos = torch.cummax(shifted, dim=-1).values
    prev = torch.gather(csum, 1, prev_pos.clamp(min=0))
    return csum - torch.where(prev_pos >= 0, prev, torch.zeros_like(prev))


def _segment_sum_at_ends_nonneg(values, is_end):
    """Non-negative values: the previous run-end cumsum is a cummax."""
    csum = torch.cumsum(values, dim=-1)
    end_csum = torch.where(is_end, csum, torch.zeros_like(csum))
    shifted = torch.cat([torch.zeros_like(end_csum[:, :1]), end_csum[:, :-1]], dim=1)
    return csum - torch.cummax(shifted, dim=-1).values


# ---- stage A ------------------------------------------------------------------
def _stage_a_entries(seg: SegmentArrays, qs: QuerySlots, L: int, ub_entry=None):
    """Stage A's [B, P, L] tiles of the slots' first L rows → (keys = doc << 6
    | group, contrib, aux, U): pads hold the pad doc, no contribution and no
    aux; with ub_entry f32[B, P] each valid entry carries contrib - ub_slot +
    U, U f32[B] the query's largest bound (else None)."""
    nd = int(seg.num_docs)
    n_rows = seg.postings.shape[0]
    dev = seg.postings.device
    starts = torch.clamp(qs.starts.long(), 0, n_rows - L)
    offs = torch.arange(L, device=dev)
    rows = seg.postings[starts[..., None] + offs]  # [B, P, L, W]
    valid = offs < torch.clamp(qs.lens, max=L)[..., None]
    r_docs, r_factors, r_aux = _decode_rows(rows)
    docs = torch.where(valid, r_docs, torch.full_like(r_docs, nd))
    factors = torch.where(valid, r_factors, torch.zeros_like(r_factors))
    aux = torch.where(valid, r_aux, torch.zeros_like(r_aux))
    f1, f2 = _unpack_factors(factors)
    # presence must be != 0: packed (q1 << 16) | q2 is negative once q1 >= 32768
    contrib = (qs.w_bm25[..., None] * f1 + qs.w_bm25f[..., None] * f2
               + qs.w_presence[..., None] * (factors != 0).to(torch.float32))
    keys = (docs << GROUP_BITS) | qs.group[..., None]
    U = None
    if ub_entry is not None:
        U = ub_entry.amax(dim=1)
        contrib = torch.where(valid, contrib - ub_entry[..., None] + U[:, None, None],
                              torch.zeros_like(contrib))
    return keys, contrib, aux, U


def merge_applies(P: int, L: int) -> bool:
    """The reference's gate for the merge (ops/scoring.py _join_topk): [P, L]
    tiles with P a power of two >= 2 and L a power of two."""
    return P >= 2 and P & (P - 1) == 0 and L >= 1 and L & (L - 1) == 0


def _bitonic_stages_plain(k, vs, m: int):
    """log2(m) compare-exchange stages over rows of length m ([B, R, m]):
    stage d pairs each position x with x + d inside blocks of 2d and swaps
    keys (and payloads) where the first key is greater; equal keys never
    swap. Sorts each bitonic row ascending."""
    d = m // 2
    while d >= 1:
        shape = k.shape
        split = lambda x: x.reshape(*x.shape[:-1], m // (2 * d), 2, d).unbind(-2)  # noqa: E731
        ka, kb = split(k)
        swap = ka > kb
        cx = lambda a, b: torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],  # noqa
                                      dim=-2).reshape(shape)
        k = cx(ka, kb)
        vs = [cx(*split(v)) for v in vs]
        d //= 2
    return k, vs


def merge_sorted_tiles_plain(keys, *payloads):
    """The reference's P-way merge (stract_tpu/ops/scoring.py
    merge_sorted_tiles), stage for stage: keys [P, L] or [B, P, L], P a power
    of two; log2(P) rounds, each folding pairs of rows into one of twice the
    length with the second row reversed, then log2(2L) compare-exchange
    stages. Payloads move with their keys. → (flat keys [B, P*L] (or [P*L]),
    [flat payloads]). Sorted where each row was ascending; on other rows
    (a tf-ordered impact slot) the output is whatever this fixed network
    makes of them, as in the reference."""
    single = keys.dim() == 2
    k = keys[None] if single else keys
    vs = [v[None] if single else v for v in payloads]
    B, P, L = k.shape
    while P > 1:
        m = 2 * L

        def fold(x):
            x = x.reshape(B, P // 2, m)
            return torch.cat([x[..., :L], x[..., L:].flip(-1)], dim=-1)

        k, vs = _bitonic_stages_plain(fold(k), [fold(v) for v in vs], m)
        P, L = P // 2, m
    flat = lambda x: x.reshape(-1) if single else x.reshape(B, -1)  # noqa: E731
    return flat(k), [flat(v) for v in vs]


def score_candidates_batch_plain(seg: SegmentArrays, qs: QuerySlots, L: int, K: int,
                                 default_static: bool, soft_required: bool,
                                 ub_entry=None, ub_total=None, merge: bool = False):
    """Plain version of stage A (stract_tpu score_candidates_batch +
    _join_topk): fetch, contribution, sort by key = doc << 6 | group, run-end
    segment sums, boolean semantics, static score, top-K.

    ub_entry f32[B, P] / ub_total f32[B] (block-max UB scoring): each valid
    entry carries contrib - ub_slot + U, U the query's largest bound (values
    stay non-negative for the cummax segment sum); the per-doc entry count
    from the run-end positions takes the +U back out, and ub_total makes the
    score `seen + sum of the unseen slots' bounds`.

    merge=True (the reference's merge switch): where merge_applies(P, L) the
    sort is merge_sorted_tiles_plain over the [P, L] tiles, and the tail runs
    over its output order."""
    B, P = qs.starts.shape
    nd = int(seg.num_docs)
    dev = seg.postings.device
    keys, contrib, aux, U = _stage_a_entries(seg, qs, L, ub_entry)
    if merge and merge_applies(P, L):
        skey, (scontrib, saux) = merge_sorted_tiles_plain(keys, contrib, aux)
    else:
        skey, perm = torch.sort(keys.reshape(B, -1), dim=-1, stable=True)
        scontrib = torch.gather(contrib.reshape(B, -1), 1, perm)
        saux = torch.gather(aux.reshape(B, -1), 1, perm) if default_static else None
    sdocs = skey >> GROUP_BITS
    sgroups = skey & ((1 << GROUP_BITS) - 1)
    last = torch.ones_like(sdocs[:, :1], dtype=torch.bool)
    doc_end = torch.cat([sdocs[:, 1:] != sdocs[:, :-1], last], dim=1)
    pair_end = torch.cat([skey[:, 1:] != skey[:, :-1], last], dim=1)
    segsum = _segment_sum_at_ends_nonneg if default_static else _segment_sum_at_ends
    text_total = segsum(scontrib, doc_end)
    if ub_entry is not None:
        idx = torch.arange(scontrib.shape[1], device=dev).expand_as(sdocs)
        end_pos = torch.where(doc_end, idx, torch.full_like(idx, -1))
        shifted = torch.cat([torch.full_like(end_pos[:, :1], -1), end_pos[:, :-1]], dim=1)
        n_entries = (idx - torch.cummax(shifted, dim=-1).values).to(torch.float32)
        text_total = text_total - n_entries * U[:, None] + ub_total[:, None]
    pe = pair_end.to(torch.float32)
    req_present = segsum(pe * (sgroups < MAX_GROUPS).to(torch.float32), doc_end)
    excl_present = segsum(pe * (sgroups == EXCLUDED_GROUP).to(torch.float32), doc_end)
    if default_static:
        static = _aux_static_score(qs, saux, float(seg.static_scale))
    else:
        static = _query_static(seg, qs, sdocs, False)
    total = text_total + static
    ok = doc_end & (sdocs < nd) & (excl_present < 0.5)
    if soft_required:
        total = total + qs.soft_bonus[:, None] * req_present
    else:
        ok = ok & (req_present >= qs.n_required[:, None].to(torch.float32))
    total = torch.where(ok, total, torch.full_like(total, float("-inf")))
    top_scores, top_idx = torch.topk(total, K, dim=-1)
    top_docs = torch.where(torch.isneginf(top_scores), torch.full_like(top_idx, nd),
                           torch.gather(sdocs, 1, top_idx).long())
    return top_docs.to(torch.int32), top_scores


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_on = kernels.on_device


def score_candidates_batch(seg: SegmentArrays, qs, L: int = DEFAULT_L, K: int = DEFAULT_K,
                           default_static: bool = True, soft_required: bool = False,
                           ub_entry=None, ub_total=None, merge: bool = False):
    """Stage A over a query batch → (docs i32[B, K], scores f32[B, K]),
    score-descending; pads are doc = num_docs, score = -inf. The rows may be
    q16 or q8; ub_entry f32[B, P] with ub_total f32[B] turn block-max UB
    scoring on. merge=True joins in the order of the P-way bitonic merge of
    the [P, L] tiles where merge_applies(P, L) (the merge kernel, K13): on
    rows that are not doc-ascending a doc may then stand in several runs,
    and so several times in the top-K, as in the reference."""
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    ub_entry, ub_total = _on(ub_entry, dev, torch.float32), _on(ub_total, dev, torch.float32)
    if not seg.postings.is_cuda:
        return score_candidates_batch_plain(seg, qs, L, K, default_static, soft_required,
                                            ub_entry, ub_total, merge)
    B, P = qs.starts.shape
    docs = torch.empty((B, K), dtype=torch.int32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    if merge and merge_applies(P, L):
        mkey, mcon, maux, skey = _merge_scratch(B, P * L, default_static, dev)
        kernels.stage_a_merge(seg, qs, L, K, default_static, soft_required, INV_FACTOR_SCALE,
                              mkey, mcon, maux, skey, docs, scores, ub_entry, ub_total)
        return docs, scores
    T = max(_next_pow2(2 * P * L), _next_pow2(K))
    tkey = torch.empty((B, T), dtype=torch.int32, device=dev)
    tsum = torch.empty((B, T), dtype=torch.float32, device=dev)
    tmask = torch.empty((B, T), dtype=torch.int64, device=dev)
    taux = torch.empty((B, T), dtype=torch.int32, device=dev)
    skey = torch.empty((B, T), dtype=torch.int32, device=dev)
    kernels.stage_a(seg, qs, L, K, T, default_static, soft_required, INV_FACTOR_SCALE,
                    tkey, tsum, tmask, taux, skey, docs, scores, ub_entry, ub_total)
    return docs, scores


def _merge_scratch(B: int, N: int, with_aux: bool, dev):
    """The merge kernel's [B, N] network arrays (keys, contributions, aux
    words when the static score reads them) and its ordered score keys."""
    i32 = torch.int32
    return (torch.empty((B, N), dtype=i32, device=dev),
            torch.empty((B, N), dtype=torch.float32, device=dev),
            torch.empty((B, N), dtype=i32, device=dev) if with_aux else None,
            torch.empty((B, N), dtype=i32, device=dev))


def stage_a_network(seg: SegmentArrays, qs, L: int = DEFAULT_L, ub_entry=None):
    """Stage A's merge network alone: the [B, P, L] entries of the slots'
    first L rows through merge_sorted_tiles → (keys i32[B, P*L], contrib
    f32[B, P*L], aux i32[B, P*L]) in the network's output order (what the
    merge kernel's tail reads; the kernel's arrays bit for bit)."""
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    ub_entry = _on(ub_entry, dev, torch.float32)
    B, P = qs.starts.shape
    if not merge_applies(P, L):
        raise ValueError(f"the merge takes a power-of-two P >= 2 and L, not {P} x {L}")
    if not seg.postings.is_cuda:
        keys, contrib, aux, _ = _stage_a_entries(seg, qs, L, ub_entry)
        k, (c, a) = merge_sorted_tiles_plain(keys, contrib, aux)
        return k, c, a
    mkey, mcon, maux, _ = _merge_scratch(B, P * L, True, dev)
    kernels.stage_a_merge(seg, qs, L, 0, True, True, INV_FACTOR_SCALE, mkey, mcon, maux, None,
                          None, None, ub_entry, None)
    return mkey, mcon, maux


def score_candidates(seg: SegmentArrays, q, L: int = DEFAULT_L, K: int = DEFAULT_K,
                     default_static: bool = True, soft_required: bool = False,
                     ub_entry=None, ub_total=None, merge: bool = False):
    """Single-query stage A: the batch path with B = 1 → (docs[K], scores[K]);
    ub_entry f32[P] and ub_total a scalar."""
    if ub_entry is not None:
        ub_entry = np.asarray(ub_entry, dtype=np.float32)[None]
        ub_total = np.asarray(ub_total, dtype=np.float32).reshape(1)
    docs, scores = score_candidates_batch(seg, stack([q]), L, K, default_static, soft_required,
                                          ub_entry, ub_total, merge)
    return docs[0], scores[0]


# ---- stage B and pass 2 ---------------------------------------------------------
def _score_driver_core_plain(seg, qs, factors, driver_docs, default_static: bool,
                             out_k: int | None):
    """Plain stage B (stract_tpu _score_driver_core, batched) → (docs, scores,
    top_idx) over factors i32[B, P, Kd] and driver_docs i32[B, Kd]."""
    nd = int(seg.num_docs)
    f1, f2 = _unpack_factors(factors)
    present = factors != 0
    contrib = (qs.w_bm25[..., None] * f1 + qs.w_bm25f[..., None] * f2
               + qs.w_presence[..., None] * present.to(torch.float32))
    text = contrib.sum(dim=1)
    grp = qs.group.long()
    req = (grp < MAX_GROUPS).to(torch.float32)
    onehot = torch.nn.functional.one_hot(grp.clamp(0, MAX_GROUPS - 1), MAX_GROUPS)
    onehot = onehot.to(torch.float32) * req[..., None]  # [B, P, G]
    grp_present = torch.einsum("bpg,bpk->bgk", onehot, present.to(torch.float32)) > 0
    req_count = grp_present.sum(dim=1)
    excl = ((grp == EXCLUDED_GROUP)[..., None] & present).any(dim=1)
    docs_l = driver_docs.long()
    total = text + _query_static(seg, qs, docs_l.clamp(max=seg.static_default.shape[0] - 1),
                                 default_static)
    valid = (docs_l < nd) & (req_count >= qs.n_required[:, None]) & ~excl
    total = torch.where(valid, total, torch.full_like(total, float("-inf")))
    Kd = driver_docs.shape[1]
    k = min(out_k or Kd, Kd)
    top_scores, top_idx = torch.topk(total, k, dim=-1)
    top_docs = torch.where(torch.isneginf(top_scores), torch.full_like(top_idx, nd),
                           torch.gather(docs_l, 1, top_idx))
    return top_docs.to(torch.int32), top_scores, top_idx


def _signals_tail_plain(seg, qs, aggs, factors, cand):
    """Plain signal matrix f32[B, NUM_SIGNALS, K] for candidate columns."""
    nd = int(seg.num_docs)
    f1, f2 = _unpack_factors(factors)
    present = (factors != 0).to(torch.float32)
    idf = qs.idf[..., None]
    B, _, K = factors.shape
    sig = torch.zeros((B, S.NUM_SIGNALS, K), dtype=torch.float32, device=factors.device)
    sig = sig + torch.bmm(aggs.agg_bm25, idf * f1)
    sig[:, S.BM25_F.id] += torch.bmm(aggs.agg_bm25f, idf * f2)[:, 0]
    sig = sig + torch.bmm(aggs.agg_idf, idf * present)
    sig = sig + torch.bmm(aggs.agg_cov, present)
    c = cand.long()
    cols = seg.static_cols[:, c]  # [NUM_STATIC, B, K]
    select = torch.as_tensor(_STATIC_SELECT, device=factors.device)
    sig = sig + torch.einsum("sr,rbk->bsk", select, cols)
    region = torch.clamp(seg.region_ids[c], 0, NUM_REGIONS - 1).long()
    sig[:, S.REGION.id] = torch.gather(qs.region_lut, 1, region)
    sig[:, S.UPDATE_TIMESTAMP.id] = update_score(seg.last_updated[c], qs.current_ts[:, None])
    return torch.where((c < nd)[:, None, :], sig, torch.zeros_like(sig))


def quantize_signals(sig):
    """int16 with a per-(query, signal) scale absmax/32767, half to even."""
    absmax = sig.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-30) * float(np.float32(1.0 / 32767.0))
    return torch.round(sig / scale[..., None]).to(torch.int16), scale


def score_driver_batch_plain(seg, qs, factors, driver_docs, default_static: bool,
                             out_k: int | None, aggs=None, sig_k: int = 0):
    """Plain stage B: (docs, scores), or with sig_k > 0 (the fused form)
    (docs, scores, sq i16[B, 46, k'], scale f32[B, 46]) for the top
    k' = min(sig_k, k) columns."""
    docs, scores, idx = _score_driver_core_plain(seg, qs, factors, driver_docs,
                                                 default_static, out_k)
    if not sig_k:
        return docs, scores
    k = min(sig_k, docs.shape[1])
    B, P, _ = factors.shape
    fac_top = torch.gather(factors, 2, idx[:, None, :k].expand(B, P, k))
    sq, scale = quantize_signals(_signals_tail_plain(seg, qs, aggs, fac_top, docs[:, :k]))
    return docs, scores, sq, scale


_STATIC_OF_SIG_ON: dict = {}


def _static_of_sig(device) -> torch.Tensor:
    """The signal → static column table on `device`, made once and kept. K2
    and K3 get its raw address in a launch struct, so it must outlive every
    launch: a table made per call was freed before its launch, another
    thread's allocation could take its memory and write into it first, and
    the kernel then indexed the static columns with that thread's data
    (the illegal address of pipeline-on serving)."""
    dev = torch.device(device)
    table = _STATIC_OF_SIG_ON.get(dev)
    if table is None:
        table = _STATIC_OF_SIG_ON.setdefault(dev, torch.as_tensor(_STATIC_OF_SIG, device=dev))
    return table


def _agg_args(aggs, device):
    return kernels.agg_args(aggs, _static_of_sig(device), S.BM25_F.id, S.REGION.id,
                            S.UPDATE_TIMESTAMP.id)


def _stage_b(seg, qs, factors, driver_docs, aggs, default_static, out_k, sig_k):
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    factors = torch.as_tensor(factors, dtype=torch.int32).to(dev).contiguous()
    driver_docs = torch.as_tensor(driver_docs, dtype=torch.int32).to(dev).contiguous()
    if aggs is not None:
        aggs = to_tensors(_batched(aggs, QueryAggregates), dev)
    if not seg.postings.is_cuda:
        return score_driver_batch_plain(seg, qs, factors, driver_docs, default_static,
                                        out_k, aggs, sig_k)
    B, Kd = driver_docs.shape
    k = min(out_k or Kd, Kd)
    ks = min(sig_k, k)
    docs = torch.empty((B, k), dtype=torch.int32, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    if ks:
        sq = torch.empty((B, S.NUM_SIGNALS, ks), dtype=torch.int16, device=dev)
        scale = torch.empty((B, S.NUM_SIGNALS), dtype=torch.float32, device=dev)
        a = _agg_args(aggs, dev)
    else:
        sq = scale = None
        # unfused: the kernel reads no aggregation rows
        a = kernels.AggArgs(None, None, None, None, None, S.NUM_SIGNALS, S.BM25_F.id,
                            S.REGION.id, S.UPDATE_TIMESTAMP.id)
    kernels.stage_b(seg, qs, a, factors, driver_docs, default_static, INV_FACTOR_SCALE,
                    k, ks, docs, scores, sq, scale)
    return (docs, scores, sq, scale) if ks else (docs, scores)


def score_driver_batch(seg: SegmentArrays, qs, factors, driver_docs,
                       default_static: bool = True, out_k: int | None = None):
    """Stage B (exact verify) → (docs i32[B, k], scores f32[B, k]),
    k = min(out_k, Kd), score-descending; pads doc = num_docs, -inf."""
    return _stage_b(seg, qs, factors, driver_docs, None, default_static, out_k, 0)


def score_driver_batch_with_signals(seg: SegmentArrays, qs, factors, driver_docs, aggs,
                                    default_static: bool = True, out_k: int | None = None,
                                    sig_k: int = 64):
    """Fused stage B: verify plus the q16 signal matrix of each query's top
    sig_k docs → (docs, scores, sq i16[B, 46, k'], scale f32[B, 46])."""
    return _stage_b(seg, qs, factors, driver_docs, aggs, default_static, out_k, sig_k)


def score_driver(seg, q, factors, driver_docs, default_static: bool = True,
                 out_k: int | None = None):
    docs, scores = score_driver_batch(seg, stack([q]), np.asarray(factors)[None],
                                      np.asarray(driver_docs)[None], default_static, out_k)
    return docs[0], scores[0]


def score_driver_with_signals(seg, q, factors, driver_docs, aggs, default_static: bool = True,
                              out_k: int | None = None, sig_k: int = 64):
    docs, scores, sq, scale = score_driver_batch_with_signals(
        seg, stack([q]), np.asarray(factors)[None], np.asarray(driver_docs)[None],
        stack([aggs]), default_static, out_k, sig_k)
    return docs[0], scores[0], sq[0], scale[0]


def compute_signals_from_factors_batch_q16_plain(seg, qs, aggs, factors, cands):
    return quantize_signals(_signals_tail_plain(seg, qs, aggs, factors, cands))


def compute_signals_from_factors_batch_q16(seg: SegmentArrays, qs, aggs, factors, cands):
    """Pass 2 on host-joined factors i32[B, P, K] → (q i16[B, 46, K],
    scale f32[B, 46])."""
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    aggs = to_tensors(_batched(aggs, QueryAggregates), dev)
    factors = torch.as_tensor(factors, dtype=torch.int32).to(dev).contiguous()
    cands = torch.as_tensor(cands, dtype=torch.int32).to(dev).contiguous()
    if not seg.postings.is_cuda:
        return compute_signals_from_factors_batch_q16_plain(seg, qs, aggs, factors, cands)
    B, K = cands.shape
    sq = torch.empty((B, S.NUM_SIGNALS, K), dtype=torch.int16, device=dev)
    scale = torch.empty((B, S.NUM_SIGNALS), dtype=torch.float32, device=dev)
    kernels.signals_q16(seg, qs, _agg_args(aggs, dev), factors, cands, INV_FACTOR_SCALE,
                        sq, scale)
    return sq, scale


def compute_signals_from_factors(seg, q, aggs, factors, cand) -> np.ndarray:
    """Single-query pass 2 through the q16 batch path (B = 1), dequantised:
    f32[NUM_SIGNALS, K], within one q16 step of the unquantised matrix."""
    sq, scale = compute_signals_from_factors_batch_q16(
        seg, stack([q]), stack([aggs]), np.asarray(factors)[None], np.asarray(cand)[None])
    return dequantize_signals(sq, scale)[0]


# ---- the device factor join -------------------------------------------------------
def factors_join_plain(postings, starts, lens, cand):
    """Plain version of the join (stract_tpu _factors_join_one, batched):
    packed factors i32[B, P, Kd] of cand i32[B, Kd] by a lockstep binary
    search of every (slot, candidate) pair over the slot's full doc-ascending
    range [start, start + len) of the postings; 0 where absent. q8 rows are
    searched on their decoded doc and give the widened q8 factors."""
    q8 = postings.shape[1] == 2
    docs_col = postings[:, 0]
    dec = (lambda w: (w >> 7) & 0x1FFFFFF) if q8 else (lambda w: w)
    n = docs_col.shape[0]
    (B, P), Kd = starts.shape, cand.shape[1]
    s = starts[..., None].long()
    e = s + lens[..., None].long()
    lo, hi = s.expand(B, P, Kd), e.expand(B, P, Kd)
    c = cand[:, None, :].to(torch.int32)
    for _ in range(max(int(n - 1).bit_length(), 1)):
        mid = (lo + hi) >> 1
        d = dec(docs_col[mid.clamp(max=n - 1)])
        active = lo < hi
        right = active & (d < c)
        lo, hi = torch.where(right, mid + 1, lo), torch.where(active & (d >= c), mid, hi)
    idx = lo.clamp(max=n - 1)
    found = (lo < e) & (dec(docs_col[idx]) == c)
    if q8:
        w1 = postings[idx, 1]
        facs = ((((w1 >> 24) & 0xFF) * 257) << 16) | (((w1 >> 16) & 0xFF) * 257)
    else:
        facs = postings[idx, 1]
    return torch.where(found, facs, torch.zeros_like(facs))


def factors_join(seg: SegmentArrays, starts, lens, cand) -> torch.Tensor:
    """Packed factors i32[P, Kd] of candidate docs joined on the device (or
    i32[B, P, Kd] when the inputs carry a batch dimension): what the host
    join (index/inverted.py _slot_factors_for) returns, without the host's
    searches and without the upload."""
    dev = seg.postings.device
    starts, lens, cand = (_on(x, dev, torch.int32) for x in (starts, lens, cand))
    single = cand.dim() == 1
    if single:
        starts, lens, cand = starts[None], lens[None], cand[None]
    if not seg.postings.is_cuda:
        out = factors_join_plain(seg.postings, starts, lens, cand)
    else:
        out = torch.empty((*starts.shape, cand.shape[1]), dtype=torch.int32, device=dev)
        kernels.factors_join(seg, starts, lens, cand, out)
    return out[0] if single else out


def score_driver_joined_batch_plain(seg, qs, driver_docs, default_static: bool,
                                    out_k: int | None):
    factors = factors_join_plain(seg.postings, qs.starts, qs.lens, driver_docs)
    return _score_driver_core_plain(seg, qs, factors, driver_docs, default_static, out_k)[:2]


def score_driver_joined_batch(seg: SegmentArrays, qs, driver_docs, default_static: bool = True,
                              out_k: int | None = None):
    """Stage B with the factors joined on the device: no host searches, no
    factor upload → (docs i32[B, k], scores f32[B, k]). The kernel searches
    inside the verify and never writes the [B, P, Kd] matrix."""
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    driver_docs = _on(driver_docs, dev, torch.int32)
    if not seg.postings.is_cuda:
        return score_driver_joined_batch_plain(seg, qs, driver_docs, default_static, out_k)
    B, Kd = driver_docs.shape
    k = min(out_k or Kd, Kd)
    skey = torch.empty((B, _next_pow2(Kd)), dtype=torch.int32, device=dev)
    docs = torch.empty((B, k), dtype=torch.int32, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    kernels.stage_b_joined(seg, qs, driver_docs, default_static, INV_FACTOR_SCALE, k, skey,
                           docs, scores)
    return docs, scores


def score_driver_joined(seg, q, driver_docs, default_static: bool = True,
                        out_k: int | None = None):
    docs, scores = score_driver_joined_batch(seg, stack([q]), np.asarray(driver_docs)[None],
                                             default_static, out_k)
    return docs[0], scores[0]


def compute_signals_joined_batch_plain(seg, qs, aggs, cands):
    factors = factors_join_plain(seg.postings, qs.starts, qs.lens, cands)
    return _signals_tail_plain(seg, qs, aggs, factors, cands)


def _signals_search(seg, qs, aggs, cands, L: int, q16: bool):
    """Pass 2 that finds its own factors: the device join (L = 0) or the
    slots' first L rows (K12) → f32[B, 46, K], or (q, scale) when q16."""
    dev = seg.postings.device
    qs = to_tensors(_batched(qs, QuerySlots), dev)
    aggs = to_tensors(_batched(aggs, QueryAggregates), dev)
    cands = _on(cands, dev, torch.int32)
    if not seg.postings.is_cuda:
        sig = (compute_signals_batch_plain(seg, qs, aggs, cands, L) if L
               else compute_signals_joined_batch_plain(seg, qs, aggs, cands))
        return quantize_signals(sig) if q16 else sig
    B, K = cands.shape
    a = _agg_args(aggs, dev)
    if q16:
        sq = torch.empty((B, S.NUM_SIGNALS, K), dtype=torch.int16, device=dev)
        scale = torch.empty((B, S.NUM_SIGNALS), dtype=torch.float32, device=dev)
        kernels.signals_search(seg, qs, a, cands, INV_FACTOR_SCALE, L, _lookup_steps(L),
                               out_q=sq, out_scale=scale)
        return sq, scale
    sig = torch.empty((B, S.NUM_SIGNALS, K), dtype=torch.float32, device=dev)
    kernels.signals_search(seg, qs, a, cands, INV_FACTOR_SCALE, L, _lookup_steps(L), out_f32=sig)
    return sig


def compute_signals_joined_batch(seg: SegmentArrays, qs, aggs, cands):
    """Pass 2 with the device join → f32[B, NUM_SIGNALS, K]."""
    return _signals_search(seg, qs, aggs, cands, 0, False)


def compute_signals_joined_batch_q16(seg: SegmentArrays, qs, aggs, cands):
    """Pass 2 with the device join → (q i16[B, 46, K], scale f32[B, 46])."""
    return _signals_search(seg, qs, aggs, cands, 0, True)


def compute_signals_joined(seg, q, aggs, cand):
    """Single-query pass 2 with the device join → f32[NUM_SIGNALS, K]."""
    return compute_signals_joined_batch(seg, stack([q]), stack([aggs]),
                                        np.asarray(cand)[None])[0]


# ---- pass 2 from the slots' prefixes ---------------------------------------------
def _gather_packed(seg, qs, L: int):
    """[B, P, L] doc and factor tiles of the slots' first L rows (stract_tpu
    _gather_packed); entries past min(len, L) hold the pad doc and no factors."""
    n_rows = seg.postings.shape[0]
    offs = torch.arange(L, device=seg.postings.device)
    valid = offs < torch.clamp(qs.lens, max=L)[..., None]
    idx = torch.clamp(qs.starts.long()[..., None] + offs, 0, n_rows - 1)
    r_docs, r_factors, _ = _decode_rows(seg.postings[idx])
    docs = torch.where(valid, r_docs, torch.full_like(r_docs, int(seg.num_docs)))
    return docs, torch.where(valid, r_factors, torch.zeros_like(r_factors))


def _lookup_steps(L: int) -> int:
    return max(1, int(np.ceil(np.log2(max(L, 2)))) + 1) if L else 0


def _slot_factor_lookup(docs_tile, factors_tile, cand, L: int):
    """Packed factors i32[B, P, K] of cand i32[B, K] in the tiles, 0 if absent:
    the reference's fixed-step binary search (stract_tpu _slot_factor_lookup),
    step for step, so rows that are not doc-ascending (a tf-ordered impact
    slot) give what the reference gives."""
    B, P, _ = docs_tile.shape
    K = cand.shape[1]
    lo = torch.zeros((B, P, K), dtype=torch.int64, device=cand.device)
    hi = torch.full((B, P, K), L, dtype=torch.int64, device=cand.device)
    c = cand[:, None, :]
    for _ in range(_lookup_steps(L)):
        mid = (lo + hi) // 2
        mid_vals = torch.gather(docs_tile, 2, mid.clamp(0, L - 1))
        go_right = mid_vals < c
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    pos = lo.clamp(0, L - 1)
    found = torch.gather(docs_tile, 2, pos) == c
    facs = torch.gather(factors_tile, 2, pos)
    return torch.where(found, facs, torch.zeros_like(facs))


def compute_signals_batch_plain(seg, qs, aggs, cands, L: int):
    docs_tile, factors_tile = _gather_packed(seg, qs, L)
    factors = _slot_factor_lookup(docs_tile, factors_tile, cands, L)
    return _signals_tail_plain(seg, qs, aggs, factors, cands)


def compute_signals_batch(seg: SegmentArrays, qs, aggs, cands, L: int = DEFAULT_L):
    """Pass 2 from the first L rows of each slot only → f32[B, NUM_SIGNALS, K]
    (the device-only variant; serving uses the exact forms above)."""
    return _signals_search(seg, qs, aggs, cands, L, False)


def compute_signals(seg, q, aggs, cand, L: int = DEFAULT_L):
    return compute_signals_batch(seg, stack([q]), stack([aggs]), np.asarray(cand)[None], L)[0]


# ---- host side ------------------------------------------------------------------
def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def dequantize_signals(q, scale) -> np.ndarray:
    """f32[..., NSIG, K] from the q16 rows and their scales."""
    return _np(q).astype(np.float32) * _np(scale).astype(np.float32)[..., None]


def unpack_stageb(result, K: int, nsig: int | None = None, sig_k: int | None = None):
    """Stage-B result on the host: (docs i32[..., K], scores f32[..., K]
    [, sig f32[..., nsig, sig_k] dequantised])."""
    docs = _np(result[0])[..., :K]
    scores = _np(result[1])[..., :K]
    if nsig is None:
        return docs, scores
    sig = dequantize_signals(result[2], result[3])[..., :nsig, :sig_k]
    return docs, scores, sig
