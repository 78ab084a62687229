"""InvertedIndex — the port of stract_tpu/index/inverted.py on torch.

Writes and opens the JAX package's index directory (<path>/index_meta.json
and <path>/segments/, created empty where absent): insert / commit build a
segment on the host (index/segment.py SegmentBuilder), merge_all compacts
the segments into one (index/merge.py), merge_from adopts another index's.
A search uploads each segment to the device the caller names and serves the
two-phase protocol:

    search_arrays_batch(ctxs)         → ranked (segs, docs, scores) per query
    compute_signals_arrays_many(...)  → signal matrices for the final page
    retrieve(ptrs, terms)             → stored docs + snippets (host)

(search_initial / search_initial_batch and compute_signals are the same two
phases for one query and for pointer lists.)

Per segment and query batch: stage A (ops.score_candidates_batch) scans the
slots' posting prefixes for candidates unless the smallest required group is
small enough to be the candidate set itself (driver mode); the host joins
each candidate's full-range factors (native.slot_factors); stage B
(ops.score_driver_batch[_with_signals]) verifies them exactly. On a CUDA
segment stage B also returns the q16 signal rows of each query's top
FUSED_SIG_K docs, so the final page is usually a host cache lookup.

Where the JAX package reads STRACT_TPU_* experiment switches at import, the
port takes arguments of InvertedIndex (the defaults are the JAX package's):

    row_layout   "q16" | "q8": the posting rows on the device (12 or 8 bytes a
                 row). Stage A scans them; with the host join stage B still
                 reads the exact q16 rows on disk, so only the candidate cut
                 can move.
    device_join  stage B and pass 2 find their factors on the device
                 (ops.score_driver_joined_batch, compute_signals_joined*):
                 no host searches, no factor upload, no fused signal rows
                 and no factor cache. With q8 rows the joined factors are the
                 quantised ones, so final scores move (as in the JAX package).
    ub_lambda    > 0: block-max UB scoring in stage A, each truncated slot's
                 unseen contribution bounded and scaled by ub_lambda.
    verify_c     > 0: stage B verifies only the top verify_c (rounded up to
                 the shape menu) of stage A's candidates.
    merge_kernel stage A joins in the order of the P-way bitonic merge of its
                 [P, L] tiles (P and L powers of two; else the default stage
                 A), the JAX package's STRACT_TPU_MERGE_KERNEL. Rows that are
                 not doc-ascending (the impact-prefix slots) leave the merged
                 order unsorted, so the candidates differ from the default's,
                 as in the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid

import numpy as np
import torch

from .. import snippet as snippet_mod
from ..ranking import signals as S

from ..ops import scoring as O
from ..ranking.computer import QueryContext, build_slots, choose_L, uses_default_static
from .device import DeviceSegment, IMPACT_L, build_device_postings
from .merge import merge_segments
from .segment import Segment, SegmentBuilder

# driver mode: when the smallest required group's postings fit this budget
# they are the candidates (exact, no prefix truncation)
DRIVER_MAX = 4096
# stage-A candidate budget per query and segment
SCAN_CANDIDATES = 4096
# stage-B fused signal columns per query
FUSED_SIG_K = 64
# bm25f tf-factor bound: f2 = g(cf*t) <= max(cf, 1) * g(t) = max(cf, 1) * f1
# (g concave through 0, so subadditive), used by the UB scoring bound
_CF_MAX = max(1.0, max(S.BM25F_FIELD_COEFFS.values()))


def _qshape(n: int, steps=(128, 512, 2048, 4096)) -> int:
    """Round a dimension up to a small fixed menu (the JAX package's shapes,
    kept so both packages compute over the same padded arrays); values above
    the menu round up to the next power of two."""
    for s in steps:
        if n <= s:
            return s
    b = steps[-1]
    while b < n:
        b *= 2
    return b


def _term_in_doc(seg, term_h: int, doc_id: int) -> bool:
    starts, lens = seg.lookup_terms(np.array([term_h], dtype=np.uint64))
    s, l = int(starts[0]), int(lens[0])
    if l == 0:
        return False
    docs = seg.postings_docs[s : s + l]
    idx = int(np.searchsorted(docs, doc_id))
    return idx < l and int(docs[idx]) == doc_id


class DocPointer:
    """(segment ordinal, doc id) — the cross-phase doc handle."""

    __slots__ = ("segment", "doc")

    def __init__(self, segment: int, doc: int):
        self.segment = segment
        self.doc = doc

    def to_json(self):
        return {"segment": self.segment, "doc": self.doc}

    @classmethod
    def from_json(cls, d):
        return cls(d["segment"], d["doc"])

    def __repr__(self):
        return f"DocPointer({self.segment},{self.doc})"

    def __eq__(self, o):
        return (self.segment, self.doc) == (o.segment, o.doc)

    def __hash__(self):
        return hash((self.segment, self.doc))


def _nonneg(q) -> bool:
    return (float(np.min(q.w_bm25)) >= 0 and float(np.min(q.w_bm25f)) >= 0
            and float(np.min(q.w_presence)) >= 0)


class InvertedIndex:
    def __init__(self, path: str, device, row_layout: str = "q16", device_join: bool = False,
                 ub_lambda: float = 0.0, verify_c: int = 0, merge_kernel: bool = False,
                 embedding_dim: int = 0):
        if row_layout not in ("q16", "q8"):
            raise ValueError(f"row_layout is 'q16' or 'q8', not {row_layout!r}")
        self.path = path
        self.device = torch.device(device)
        self.row_layout = row_layout
        self.device_join = bool(device_join)
        self.ub_lambda = float(ub_lambda)
        self.verify_c = int(verify_c)
        self.merge_kernel = bool(merge_kernel)
        os.makedirs(os.path.join(path, "segments"), exist_ok=True)
        self._meta_path = os.path.join(path, "index_meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as fh:
                self.meta = json.load(fh)
        else:
            self.meta = {"segments": [], "embedding_dim": embedding_dim}
            self._save_meta()
        self.embedding_dim = self.meta.get("embedding_dim", embedding_dim)
        self.segments: list[Segment] = [
            Segment(os.path.join(path, "segments", name)) for name in self.meta["segments"]
        ]
        self._device: dict[int, DeviceSegment] = {}
        self._builder: SegmentBuilder | None = None

    # -- lifecycle ------------------------------------------------------------
    @classmethod
    def temporary(cls, device, embedding_dim: int = 0) -> "InvertedIndex":
        import tempfile

        return cls(tempfile.mkdtemp(prefix="sti-"), device, embedding_dim=embedding_dim)

    def _save_meta(self):
        # atomic replace: a crash mid-write never leaves a torn segment manifest
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.meta, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._meta_path)

    @property
    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.segments)

    # -- writing (host only: no segment goes to the device here) ---------------
    def insert(self, doc: dict) -> None:
        if self._builder is None:
            self._builder = SegmentBuilder(embedding_dim=self.embedding_dim)
        self._builder.add(doc)

    def commit(self) -> None:
        """Flush pending docs as a new segment."""
        if self._builder is None or len(self._builder) == 0:
            return
        name = f"seg-{uuid.uuid4().hex[:12]}"
        seg = self._builder.build(os.path.join(self.path, "segments", name))
        self.segments.append(seg)
        self.meta["segments"].append(name)
        self._save_meta()
        self._builder = None

    def merge_all(self) -> None:
        """Compact all segments into one (drops the device copies; pointers
        into the old segments no longer hold)."""
        if len(self.segments) <= 1:
            return
        name = f"seg-{uuid.uuid4().hex[:12]}"
        merged = merge_segments(self.segments, os.path.join(self.path, "segments", name))
        for old in self.meta["segments"]:
            shutil.rmtree(os.path.join(self.path, "segments", old), ignore_errors=True)
        self.segments = [merged]
        self.meta["segments"] = [name]
        self._save_meta()
        self._device.clear()

    def merge_from(self, other: "InvertedIndex") -> None:
        """Adopt another index's segments (reference indexer merge-search path)."""
        for name in other.meta["segments"]:
            new_name = f"seg-{uuid.uuid4().hex[:12]}"
            shutil.copytree(
                os.path.join(other.path, "segments", name),
                os.path.join(self.path, "segments", new_name),
            )
            self.segments.append(Segment(os.path.join(self.path, "segments", new_name)))
            self.meta["segments"].append(new_name)
        self._save_meta()

    @property
    def fused(self) -> bool:
        """Stage B returns the page's signal rows with the verify on a card;
        on the CPU the extra signal work buys nothing, and the joined stage B
        returns (docs, scores) only."""
        return self.device.type == "cuda" and not self.device_join

    # -- device -------------------------------------------------------------------
    def device_segment(self, ord_: int) -> DeviceSegment:
        return self.device_segment_for(self.segments[ord_])

    def device_segment_for(self, seg: Segment) -> DeviceSegment:
        """Device tensors keyed by segment identity (a search keeps the
        segment list it started with)."""
        key = id(seg)
        dev = self._device.get(key)
        if dev is None:
            dev = self._device[key] = DeviceSegment(seg, self.device, self.row_layout)
        return dev

    def _df_lookup(self):
        """fn(hashes) → doc frequencies summed across segments; None for one
        segment, where the segment's df is the index df."""
        if len(self.segments) <= 1:
            return None

        def merged(hashes: np.ndarray) -> np.ndarray:
            total = np.zeros(len(hashes), dtype=np.int64)
            for s in self.segments:
                _, lens = s.lookup_terms(hashes)
                total += np.asarray(lens, dtype=np.int64)
            return total

        return merged

    def region_scores(self) -> np.ndarray:
        """Corpus region frequencies, cached per segment count."""
        cached = getattr(self, "_region_scores", None)
        if cached is not None and cached[0] == len(self.segments):
            return cached[1]
        counts = np.zeros(O.NUM_REGIONS, dtype=np.float64)
        for s in self.segments:
            reg = np.asarray(s.column("region"), dtype=np.int64)
            if len(reg):
                counts += np.bincount(reg.clip(0, O.NUM_REGIONS - 1), minlength=O.NUM_REGIONS)
        total = counts.sum()
        out = (counts / total).astype(np.float32) if total else counts.astype(np.float32)
        self._region_scores = (len(self.segments), out)
        return out

    # -- per-request caches ---------------------------------------------------------------
    def _slots_for(self, ctx, ord_: int, seg, total, region_scores, dfl):
        """build_slots memoised on the ctx: both passes use the same slots."""
        cache = ctx.__dict__.setdefault("_slots_cache", {})
        key = (ord_, id(seg))
        if key not in cache:
            cache[key] = build_slots(ctx, seg, total, region_scores, df_lookup=dfl)
        return cache[key]

    @staticmethod
    def _cache_stageb_factors(ctx, ord_: int, seg, cand: np.ndarray, facs: np.ndarray):
        """Remember the verify stage's factor columns: pass 2 re-scores a
        subset of these (query, doc) pairs."""
        order = np.argsort(cand, kind="stable")
        ctx.__dict__.setdefault("_p1_factors", {})[(ord_, id(seg))] = (
            cand[order], order, facs)

    @staticmethod
    def _cache_fused_signals(ctx, ord_: int, seg, docs: np.ndarray, sig: np.ndarray):
        """Remember the fused verify's signal rows: sig f32[NUM_SIGNALS, k]
        aligned with docs[:k], stored sorted by doc."""
        k = sig.shape[-1]
        d = np.asarray(docs[:k], dtype=np.int64)
        valid = d < seg.num_docs
        cols = np.nonzero(valid)[0]
        dv = d[valid]
        order = np.argsort(dv, kind="stable")
        ctx.__dict__.setdefault("_fused_sigs", {})[(ord_, id(seg))] = (
            dv[order], cols[order], sig)

    @staticmethod
    def _fused_signal_fill_arr(ctx, segs, seg_arr: np.ndarray, doc_arr: np.ndarray,
                               out: np.ndarray) -> bool:
        """out[i] = signal row of (seg_arr[i], doc_arr[i]) from the fused
        stage-B cache; all or nothing per query (False on any miss)."""
        cache = ctx.__dict__.get("_fused_sigs")
        if not cache or len(seg_arr) == 0:
            return False
        for ord_ in np.unique(seg_arr):
            ent = cache.get((int(ord_), id(segs[int(ord_)])))
            if ent is None:
                return False
            docs_sorted, cols, sig = ent
            rows = np.nonzero(seg_arr == ord_)[0]
            want = doc_arr[rows]
            if len(docs_sorted) == 0:
                return False
            pos = np.searchsorted(docs_sorted, want)
            pos_c = np.minimum(pos, len(docs_sorted) - 1)
            if not (docs_sorted[pos_c] == want).all():
                return False
            out[rows] = sig[:, cols[pos_c]].T
        return True

    @staticmethod
    def _cached_factor_fill(ctx, ord_: int, seg, cand: np.ndarray, n_real: int,
                            out: np.ndarray) -> bool:
        """Fill out[:, :len(cand)] from the stage-B factor cache; False on a
        miss."""
        hit = ctx.__dict__.get("_p1_factors", {}).get((ord_, id(seg)))
        if hit is None or n_real == 0:
            return hit is not None and n_real == 0
        cand_sorted, order, facs_src = hit
        want = cand[:n_real]
        pos = np.searchsorted(cand_sorted, want)
        pos_c = np.minimum(pos, len(cand_sorted) - 1)
        if not (cand_sorted[pos_c] == want).all():
            return False
        cols = order[pos_c]
        # P buckets may differ between the passes; rows past the kept slots
        # are zero on both sides
        Pc = min(facs_src.shape[0], out.shape[0])
        out[:Pc, :n_real] = facs_src[:Pc, cols]
        out[Pc:, :] = 0
        out[:Pc, n_real:] = 0
        return True

    # -- slot planning ---------------------------------------------------------------------
    @staticmethod
    def _compact_slots(q, aggs=None, min_p: int = 8):
        """Drop zero-length slots and shrink the P bucket (they add no score
        and no group presence). → (q', aggs'), aggs' None when aggs is None."""
        lens = np.asarray(q.lens)
        keep = np.nonzero(lens > 0)[0]
        P = min_p
        while P < len(keep):
            P *= 2
        idx = np.zeros(P, dtype=np.int64)
        idx[: len(keep)] = keep
        mask = np.zeros(P, dtype=bool)
        mask[: len(keep)] = True
        q2 = q._replace(
            starts=np.where(mask, q.starts[idx], 0).astype(np.int32),
            lens=np.where(mask, lens[idx], 0).astype(np.int32),
            group=np.where(mask, q.group[idx], O.OPTIONAL_GROUP).astype(np.int32),
            idf=np.where(mask, q.idf[idx], 0).astype(np.float32),
            w_bm25=np.where(mask, q.w_bm25[idx], 0).astype(np.float32),
            w_bm25f=np.where(mask, q.w_bm25f[idx], 0).astype(np.float32),
            w_presence=np.where(mask, q.w_presence[idx], 0).astype(np.float32),
        )
        if aggs is None:
            return q2, None
        m = mask[None, :]
        aggs2 = aggs._replace(
            agg_bm25=np.where(m, aggs.agg_bm25[:, idx], 0),
            agg_bm25f=np.where(m, aggs.agg_bm25f[:, idx], 0),
            agg_idf=np.where(m, aggs.agg_idf[:, idx], 0),
            agg_cov=np.where(m, aggs.agg_cov[:, idx], 0),
        )
        return q2, aggs2

    @staticmethod
    def _augment_with_impact(seg: Segment, dev: DeviceSegment, q, L_q: int | None = None,
                             ub_lambda: float = 0.0):
        """Fill the query's empty slots with the impact-prefix ranges of its
        long posting lists (index/device.py build_impact_prefixes): the scan
        then covers the best-static and the best-text docs of each slot. The
        two prefixes of a term are doc-disjoint, so contributions add up.
        Only when every long slot finds a free position.

        → (q', ub_entry f32[P], ub_total float): per slot the upper bound of
        what an L_q-deep scan has NOT seen (the block-max role), scaled by
        ub_lambda: 0 for slots the scan covers whole; for a slot with an
        impact prefix the prefix's tf-factor at the scan's depth (everything
        outside is smaller); else the largest possible tf-factor. Stage A
        scores a candidate as `seen + sum of the unseen slots' bounds`."""
        lens = np.asarray(q.lens)
        starts = np.asarray(q.starts)
        groups = np.asarray(q.group)
        w1 = np.asarray(q.w_bm25)
        w2 = np.asarray(q.w_bm25f)
        wp = np.asarray(q.w_presence)
        P = len(lens)
        if L_q is None:
            L_q = O.DEFAULT_L
        t_starts = np.asarray(seg.term_starts, dtype=np.int64)
        imp = {}  # slot -> (device start, len, term index)
        if len(dev.impact_lens):
            for i in np.nonzero(lens > IMPACT_L)[0]:
                ti = int(np.searchsorted(t_starts, starts[i]))
                if ti < len(t_starts) and int(t_starts[ti]) == int(starts[i]) \
                        and dev.impact_lens[ti] > 0:
                    imp[int(i)] = (int(dev.impact_starts[ti]), int(dev.impact_lens[ti]), ti)
        # attached prefixes are scanned L_q deep (bound = prefix row
        # min(L_q, len)-1); unattached ones are not scanned (bound = row 0)
        extras = [(i, s, l) for i, (s, l, _) in imp.items()]
        free = list(np.nonzero(lens == 0)[0])
        attached = bool(extras) and len(free) >= len(extras)

        deq = 1.0 / O.FACTOR_SCALE
        ub = np.zeros(P, dtype=np.float32)
        # with ub_lambda = 0 every bound is 0: the default path skips the walk
        truncated = (lens > L_q) & (groups != O.EXCLUDED_GROUP) if ub_lambda else []
        for i in np.nonzero(truncated)[0]:
            i = int(i)
            f1c = dev.impact_bound_f1(imp[i][2], L_q if attached else 0) if i in imp else 65535.0
            f2c = min(65535.0, f1c * _CF_MAX)
            ub[i] = (max(0.0, float(w1[i])) * f1c * deq + max(0.0, float(w2[i])) * f2c * deq
                     + max(0.0, float(wp[i])))
        ub *= ub_lambda
        ub_total = float(ub.sum())
        if not attached:
            return q, ub, ub_total
        fields = {n: np.asarray(getattr(q, n)).copy()
                  for n in ("starts", "lens", "group", "idf", "w_bm25", "w_bm25f", "w_presence")}
        for (src, ist, iln), dst in zip(extras, free):
            for n in ("group", "idf", "w_bm25", "w_bm25f", "w_presence"):
                fields[n][dst] = fields[n][src]
            fields["starts"][dst] = ist
            fields["lens"][dst] = iln
            # a doc seen in either prefix of the pair is seen for the term: both
            # slots subtract the same bound, and being doc-disjoint never twice
            ub[dst] = ub[src]
        return q._replace(**fields), ub, ub_total

    @staticmethod
    def _driver_docs(seg: Segment, q) -> np.ndarray | None:
        """If the smallest required group's postings fit DRIVER_MAX, its doc
        ids padded with the pad doc to a menu size; else None (scan path)."""
        lens = np.asarray(q.lens, dtype=np.int64)
        starts = np.asarray(q.starts, dtype=np.int64)
        groups = np.asarray(q.group, dtype=np.int64)
        req = groups < O.MAX_GROUPS
        if not req.any():
            return None
        best_gid, best_size = None, None
        for gid in np.unique(groups[req]):
            size = int(lens[groups == gid].sum())
            if best_size is None or size < best_size:
                best_gid, best_size = gid, size
        if best_size == 0 or best_size > DRIVER_MAX:
            return None
        idxs = np.nonzero((groups == best_gid) & (lens > 0))[0]
        parts = [
            np.asarray(seg.postings_docs[starts[i] : starts[i] + lens[i]], dtype=np.int64)
            for i in idxs
        ]
        docs = parts[0] if len(parts) == 1 else np.unique(np.concatenate(parts))
        Kd = _qshape(len(docs), (128, 512, 1024, 4096))
        out = np.full(Kd, seg.num_docs, dtype=np.int32)
        out[: len(docs)] = docs
        return out

    @staticmethod
    def _slot_factors_for(seg: Segment, q, cand: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
        """Packed per-slot factors i32[P, len(cand)] of arbitrary candidates,
        by binary search over each slot's full posting range in the on-disk
        q16 rows: the host half of stage B."""
        from .. import native

        pf = build_device_postings(seg)
        starts = np.asarray(q.starts, dtype=np.int64)
        lens = np.asarray(q.lens, dtype=np.int64)
        P = len(starts)
        if out is None:
            out = np.zeros((P, len(cand)), dtype=np.int32)
        else:
            out = out[:P, : len(cand)]
            out[:] = 0
        if len(pf) == 0:
            return out
        if native.slot_factors(pf, starts, lens, np.ascontiguousarray(cand), out):
            return out
        docs_all = pf[:, 0]
        facs = pf[:, 1]
        for p in range(P):
            l = int(lens[p])
            if l == 0:
                continue
            s = int(starts[p])
            dp = docs_all[s : s + l]
            pos = np.searchsorted(dp, cand)
            pos_c = np.minimum(pos, l - 1)
            found = dp[pos_c] == cand
            out[p, found] = facs[s + pos_c[found]]
        return out

    # -- searching --------------------------------------------------------------------
    def estimate_count(self, ctx: QueryContext) -> int:
        """Approximate total hits: AND queries are bounded by the smallest
        required group's doc frequency, OR-ish queries by the union bound."""
        total = 0
        for seg in self.segments:
            if seg.num_docs == 0:
                continue
            q, _ = build_slots(ctx, seg, self.num_docs)
            lens = np.asarray(q.lens, dtype=np.int64)
            groups = np.asarray(q.group, dtype=np.int64)
            group_dfs = [int(lens[groups == gid].sum())
                         for gid in np.unique(groups[groups < O.MAX_GROUPS])]
            if group_dfs:
                total += min(min(group_dfs), seg.num_docs)
            else:
                total += min(int(lens[groups == O.OPTIONAL_GROUP].sum()), seg.num_docs)
        return total

    def search_initial(self, ctx: QueryContext, top_k: int = 1024):
        """One query → (pointers, scores) ranked by the fused core-signal
        score: the batch path with one query (the same two stages)."""
        return self.search_initial_batch([ctx], top_k)[0]

    def search_initial_batch(self, ctxs: list, top_k: int = 1024) -> list:
        """search_arrays_batch with per-result DocPointer objects → list of
        (pointers, scores)."""
        return [([DocPointer(int(s), int(d)) for s, d in zip(segs, docs)],
                 [float(x) for x in scores])
                for segs, docs, scores in self.search_arrays_batch(ctxs, top_k)]

    def search_arrays_batch(self, ctxs: list, top_k: int = 1024) -> list:
        """Batched search for many queries → list of (segs i32[N], docs
        i32[N], scores f32[N]) aligned with ctxs, best first."""
        region_scores = self.region_scores()
        total = self.num_docs
        dfl = self._df_lookup()
        per_query: list[list] = [[] for _ in ctxs]
        K_out = _qshape(top_k, (512, O.DEFAULT_K))
        fused = self.fused

        segments = self.segments
        for ctx in ctxs:
            # DocPointer ordinals index this snapshot of the segment list
            ctx._segments = segments
        for ord_, seg in enumerate(segments):
            if seg.num_docs == 0:
                continue
            dev = self.device_segment_for(seg)
            scan_items: list = []
            verify_buckets: dict = {}

            def add_verify(qi, q, aggs, cand, ds):
                qc, ac = self._compact_slots(q, aggs if fused else None, min_p=16)
                key = (qc.starts.shape[0], len(cand), ds)
                verify_buckets.setdefault(key, []).append((qi, qc, ac, cand))

            for qi, ctx in enumerate(ctxs):
                q, aggs = self._slots_for(ctx, ord_, seg, total, region_scores, dfl)
                ds = uses_default_static(ctx)
                driver = self._driver_docs(seg, q)
                if driver is not None:
                    add_verify(qi, q, aggs, driver, ds)
                    continue
                L = choose_L(np.asarray(q.lens))
                scan_items.append((qi, q, aggs, L, ds and _nonneg(q), ds))

            # ---- stage A: candidate scan ----------------------------------------------
            buckets: dict = {}
            if scan_items:
                maxL = _qshape(max(it[3] for it in scan_items), (128, O.DEFAULT_L))
                for qi, q, aggs, _, fast, ds in scan_items:
                    # UB visibility uses the scan's L (the batch maxL): slots
                    # no longer than it are seen whole and bound to 0
                    qa, ub, ubt = self._augment_with_impact(seg, dev, q, maxL, self.ub_lambda)
                    buckets.setdefault((qa.starts.shape[0], maxL, fast), []).append(
                        (qi, q, aggs, qa, ds, ub, ubt))
            C = _qshape(max(SCAN_CANDIDATES, top_k), (1024, 2048, 4096))
            pending = []
            for (P, L, fast), items in buckets.items():
                qs = O.stack([it[3] for it in items])
                ubkw = {}
                if self.ub_lambda > 0:
                    ubkw = dict(ub_entry=np.stack([it[5] for it in items]).astype(np.float32),
                                ub_total=np.array([it[6] for it in items], dtype=np.float32))
                cand_b, _ = O.score_candidates_batch(dev.arrays, qs, L, C, fast,
                                                     soft_required=True,
                                                     merge=self.merge_kernel, **ubkw)
                pending.append((cand_b, items))
            for cand_dev, items in pending:
                cand_np = cand_dev.cpu().numpy()
                if self.verify_c:
                    vs = _qshape(max(self.verify_c, top_k), (1024, 2048, 4096))
                    cand_np = cand_np[:, :vs]
                for j, (qi, q, aggs, _, ds, _, _) in enumerate(items):
                    add_verify(qi, q, aggs, cand_np[j], ds)

            # ---- stage B: exact verify over full posting ranges -----------------------
            pending_b = []
            for (P, Kd, ds), items in verify_buckets.items():
                k_fetch = min(K_out, Kd)
                sig_k = min(FUSED_SIG_K, Kd) if fused else None
                qs = O.stack([it[1] for it in items])
                cand_b = np.stack([it[3] for it in items])
                if self.device_join:
                    # the factors are searched on the device: nothing to join,
                    # upload or cache here, and no fused signal rows come back
                    res = O.score_driver_joined_batch(dev.arrays, qs, cand_b, ds, K_out)
                    pending_b.append((res, k_fetch, None, [it[0] for it in items]))
                    continue
                facs_b = np.zeros((len(items), P, Kd), dtype=np.int32)
                for j, (qi, qc, ac, cand) in enumerate(items):
                    self._slot_factors_for(seg, qc, cand, out=facs_b[j])
                    self._cache_stageb_factors(ctxs[qi], ord_, seg, cand, facs_b[j])
                if fused:
                    ags = O.stack([it[2] for it in items])
                    res = O.score_driver_batch_with_signals(
                        dev.arrays, qs, facs_b, cand_b, ags, ds, K_out, sig_k)
                else:
                    res = O.score_driver_batch(dev.arrays, qs, facs_b, cand_b, ds, K_out)
                pending_b.append((res, k_fetch, sig_k, [it[0] for it in items]))
            for res, k_fetch, sig_k, qis in pending_b:
                if sig_k is None:
                    docs_np, scores_np = O.unpack_stageb(res, k_fetch)
                    sig_np = None
                else:
                    docs_np, scores_np, sig_np = O.unpack_stageb(
                        res, k_fetch, S.NUM_SIGNALS, sig_k)
                for j, qi in enumerate(qis):
                    docs, scores = docs_np[j], scores_np[j]
                    valid = docs < seg.num_docs
                    per_query[qi].append((ord_, docs[valid][:top_k], scores[valid][:top_k]))
                    if sig_np is not None:
                        self._cache_fused_signals(ctxs[qi], ord_, seg, docs, sig_np[j])

        out = []
        for chunks in per_query:
            if not chunks:
                out.append((np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.float32)))
                continue
            segs_q = np.concatenate(
                [np.full(len(d), o, dtype=np.int32) for o, d, _ in chunks])
            docs_q = np.concatenate([d for _, d, _ in chunks]).astype(np.int32, copy=False)
            scores_q = np.concatenate([s for _, _, s in chunks]).astype(np.float32, copy=False)
            order = np.argsort(-scores_q, kind="stable")[:top_k]
            out.append((segs_q[order], docs_q[order], scores_q[order]))
        return out

    def compute_signals_batch_many(self, items: list) -> list:
        """items = [(ctx, pointers)] → signal matrices f32[len, NUM_SIGNALS]."""
        conv = []
        for ctx, ptrs in items:
            seg_arr = np.fromiter((p.segment for p in ptrs), dtype=np.int64, count=len(ptrs))
            doc_arr = np.fromiter((p.doc for p in ptrs), dtype=np.int64, count=len(ptrs))
            conv.append((ctx, seg_arr, doc_arr))
        return self.compute_signals_arrays_many(conv)

    def compute_signals(self, ctx: QueryContext, pointers: list) -> np.ndarray:
        """Full signal matrix f32[len(pointers), NUM_SIGNALS] of one query's
        docs (pass 2)."""
        return self.compute_signals_batch_many([(ctx, pointers)])[0]

    def compute_signals_arrays_many(self, items: list) -> list:
        """Pass 2 for many queries: items = [(ctx, seg_arr, doc_arr)] → signal
        matrices f32[len(doc_arr), NUM_SIGNALS]. Rows the fused stage B
        already returned come from the host cache; the rest run one q16
        signals program per segment."""
        region_scores = self.region_scores()
        total = self.num_docs
        dfl = self._df_lookup()
        out = [np.zeros((len(doc_arr), S.NUM_SIGNALS), dtype=np.float32)
               for _, _, doc_arr in items]

        work: dict = {}
        seg_by_id: dict = {}
        for qi, (ctx, seg_arr, doc_arr) in enumerate(items):
            segs = getattr(ctx, "_segments", None) or self.segments
            if len(doc_arr) and self._fused_signal_fill_arr(ctx, segs, seg_arr, doc_arr, out[qi]):
                continue
            for ord_ in np.unique(seg_arr):
                idxs = np.nonzero(seg_arr == ord_)[0]
                seg_by_id[id(segs[ord_])] = segs[ord_]
                work.setdefault(id(segs[ord_]), []).append((qi, idxs, ctx, int(ord_)))

        for seg_key, group in work.items():
            seg = seg_by_id[seg_key]
            dev = self.device_segment_for(seg)
            K = _qshape(max(len(idxs) for _, idxs, _, _ in group), (128, 512))
            B = len(group)
            prepared = []
            maxP = 16
            for qi, idxs, ctx, ord_ in group:
                q, aggs = self._slots_for(ctx, ord_, seg, total, region_scores, dfl)
                q, aggs = self._compact_slots(q, aggs, min_p=16)
                maxP = max(maxP, q.starts.shape[0])
                prepared.append((qi, idxs, q, aggs, ctx, ord_))
            maxP = _qshape(maxP, (16, 64))
            join = self.device_join
            facs_b = None if join else np.zeros((B, maxP, K), dtype=np.int32)
            cands = np.full((B, K), seg.num_docs, dtype=np.int32)
            qlist, alist = [], []
            for j, (qi, idxs, q, aggs, ctx, ord_) in enumerate(prepared):
                pad = maxP - q.starts.shape[0]
                if pad:
                    q = q._replace(
                        starts=np.pad(q.starts, (0, pad)),
                        lens=np.pad(q.lens, (0, pad)),
                        group=np.pad(q.group, (0, pad), constant_values=O.OPTIONAL_GROUP),
                        idf=np.pad(q.idf, (0, pad)),
                        w_bm25=np.pad(q.w_bm25, (0, pad)),
                        w_bm25f=np.pad(q.w_bm25f, (0, pad)),
                        w_presence=np.pad(q.w_presence, (0, pad)),
                    )
                    aggs = aggs._replace(**{
                        n: np.pad(getattr(aggs, n), ((0, 0), (0, pad))) for n in aggs._fields})
                cands[j, : len(idxs)] = items[qi][2][idxs]
                # pass-2 docs are a subset of the verify stage's candidates:
                # reuse those factor columns when cached (host join only: the
                # device join searches again on the device)
                if not join and not self._cached_factor_fill(
                        ctx, ord_, seg, cands[j], len(idxs), facs_b[j]):
                    self._slot_factors_for(seg, q, cands[j], out=facs_b[j])
                qlist.append(q)
                alist.append(aggs)
            if join and B == 1:
                sig_b = O._np(O.compute_signals_joined(dev.arrays, qlist[0], alist[0],
                                                       cands[0]))[None]
            elif join:
                sig_b = O.dequantize_signals(*O.compute_signals_joined_batch_q16(
                    dev.arrays, O.stack(qlist), O.stack(alist), cands))
            else:
                sig_b = O.dequantize_signals(*O.compute_signals_from_factors_batch_q16(
                    dev.arrays, O.stack(qlist), O.stack(alist), facs_b, cands))
            for j, (qi, idxs, *_rest) in enumerate(prepared):
                out[qi][idxs] = sig_b[j][:, : len(idxs)].T
        return out

    # -- phrase verification ------------------------------------------------------------
    def verify_phrase(self, pointer, words: list, segments: list | None = None,
                      fields: tuple | None = None) -> bool:
        """Exact adjacency of `words` in any phrase-tracked field (or the
        given ones; a field-scoped check on a segment without its positions
        falls back to presence)."""
        from ..schema import text_field
        from ..utils.hashing import term_hash

        from .segment import PHRASE_FIELDS

        seg = (segments if segments is not None else self.segments)[pointer.segment]
        for fname in fields or PHRASE_FIELDS:
            fid = text_field(fname).id
            starts = seg.positions_for(term_hash(fid, words[0]), pointer.doc)
            if len(starts) == 0:
                if fields is not None and _term_in_doc(
                        seg, term_hash(fid, words[0]), pointer.doc):
                    return True
                continue
            ok = starts
            for k, w in enumerate(words[1:], start=1):
                pos_k = seg.positions_for(term_hash(fid, w), pointer.doc)
                if len(pos_k) == 0:
                    ok = ok[:0]
                    break
                ok = ok[np.isin(ok + k, pos_k)]
                if len(ok) == 0:
                    break
            if len(ok):
                return True
        return False

    @staticmethod
    def _phrase_checks(phrases: list, field_phrases: list | None) -> list:
        return ([(None, w) for w in phrases]
                + [((f,), w) for f, w in (field_phrases or [])])

    def filter_phrases(self, pointers: list, phrases: list, segments: list | None = None,
                       field_phrases: list | None = None) -> list:
        """Indices of pointers satisfying every phrase (incl. field-scoped)."""
        checks = self._phrase_checks(phrases, field_phrases)
        if not checks:
            return list(range(len(pointers)))
        return [
            i for i, p in enumerate(pointers)
            if all(self.verify_phrase(p, words, segments, fields=flds)
                   for flds, words in checks)
        ]

    def filter_phrases_arr(self, seg_arr: np.ndarray, doc_arr: np.ndarray,
                           phrases: list, segments: list | None = None,
                           field_phrases: list | None = None) -> np.ndarray:
        """bool mask[N]: rows satisfying every phrase (incl. field-scoped)."""
        keep = np.ones(len(doc_arr), dtype=bool)
        checks = self._phrase_checks(phrases, field_phrases)
        if not checks:
            return keep
        for i in range(len(doc_arr)):
            p = DocPointer(int(seg_arr[i]), int(doc_arr[i]))
            keep[i] = all(self.verify_phrase(p, words, segments, fields=flds)
                          for flds, words in checks)
        return keep

    # -- retrieval ---------------------------------------------------------------------
    def retrieve(self, pointers: list, query_terms: list | None = None,
                 segments: list | None = None) -> list:
        """Stored docs + snippets; `segments` is the search-time snapshot the
        pointers' ordinals index."""
        segs = segments if segments is not None else self.segments
        out = []
        for p in pointers:
            stored = segs[p.segment].stored_doc(p.doc)
            snip = snippet_mod.generate(query_terms or [], stored.get("clean_text", ""),
                                        stored.get("description", ""))
            out.append(
                {
                    "url": stored.get("url", ""),
                    "title": stored.get("title", ""),
                    "site": stored.get("site", ""),
                    "domain": stored.get("domain", ""),
                    "snippet": snip.text(),
                    "snippet_html": snip.html(),
                    "description": stored.get("description", ""),
                    "region": stored.get("region", 0),
                    "lang": stored.get("lang", "en"),
                    "stored": stored,
                }
            )
        return out

    # -- embeddings and columns of pointer lists -------------------------------------
    def gather_embeddings(self, pointers: list, name: str,
                          segments: list | None = None) -> np.ndarray | None:
        return self.gather_embeddings_arr(*self._pointer_arrays(pointers), name, segments)

    def gather_columns(self, pointers: list, names: list,
                       segments: list | None = None) -> dict:
        """Per-candidate column values {name: i64[len(pointers)]}."""
        return self.gather_columns_arr(*self._pointer_arrays(pointers), names, segments)

    @staticmethod
    def _pointer_arrays(pointers: list) -> tuple:
        return (np.fromiter((p.segment for p in pointers), dtype=np.int64, count=len(pointers)),
                np.fromiter((p.doc for p in pointers), dtype=np.int64, count=len(pointers)))

    def gather_embeddings_arr(self, seg_arr: np.ndarray, doc_arr: np.ndarray,
                              name: str, segments: list | None = None) -> np.ndarray | None:
        """Embedding rows addressed by (segment ordinal, doc) arrays."""
        segs = segments if segments is not None else self.segments
        dim = None
        for s in segs:
            d = s.meta["embedding_dims"].get(name)
            if d:
                dim = d
        if dim is None:
            return None
        out = np.zeros((len(doc_arr), dim), dtype=np.float32)
        for ord_ in np.unique(seg_arr):
            rows = np.nonzero(seg_arr == ord_)[0]
            mat = segs[int(ord_)].embeddings(name)
            if mat is not None:
                out[rows] = np.asarray(mat[doc_arr[rows]], dtype=np.float32)
        return out

    def gather_columns_arr(self, seg_arr: np.ndarray, doc_arr: np.ndarray,
                           names: list, segments: list | None = None) -> dict:
        """Per-row column values {name: i64[N]}."""
        segs = segments if segments is not None else self.segments
        out = {name: np.zeros(len(doc_arr), dtype=np.int64) for name in names}
        for ord_ in np.unique(seg_arr):
            seg = segs[int(ord_)]
            rows = np.nonzero(seg_arr == ord_)[0]
            docs = doc_arr[rows]
            for name in names:
                col = seg.column(name)
                if len(col):
                    out[name][rows] = np.asarray(col[docs], dtype=np.int64)
        return out
