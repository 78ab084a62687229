"""Array-carried shard results (role of reference combine_results'
Vec<ScoredWebpagePointer>, searcher/api/mod.rs:412-465 — but as STRUCT-OF-
ARRAYS: one numpy column per field instead of one Python object per result).

The per-result object build was the coordinator's #1 host cost at batch 32
(~0.5 ms/query for DocPointers in the emit loop + ~0.5 ms/query for
RankedCandidates — measured, docs/perf_notes.md round 4): results now flow as
a CandidateBlock from the device fetch through cross-shard merge, dedup,
and the recall stage; only the final page (≤20 rows) materializes
RankedCandidate objects for retrieve/snippets/precision."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import signals as S

DEDUP_NAMES = (
    "url_without_query_hash1",
    "url_without_query_hash2",
    "title_hash1",
    "site_hash1",
    "sim_hash",
)


@dataclass
class CandidateBlock:
    """One query's candidates as parallel arrays. `shard` is per-row (blocks
    merge across shards); `ctxs` maps shard id → that shard's search-time
    QueryContext (per-request caches + segment-list snapshot)."""

    shard: np.ndarray                    # i32[N]
    segment: np.ndarray                  # i32[N] (ordinals into the shard ctx's snapshot)
    doc: np.ndarray                      # i64[N]
    score: np.ndarray                    # f32[N]
    dedup: dict                          # {name: u64/i64[N]} for DEDUP_NAMES
    host_id: np.ndarray                  # i64[N]
    signals: np.ndarray | None = None    # f32[N, NUM_SIGNALS], or None while lazy
    title_emb: np.ndarray | None = None  # f32[N, H]
    keyword_emb: np.ndarray | None = None
    ctxs: dict = field(default_factory=dict)   # shard id → QueryContext
    seg_names: dict = field(default_factory=dict)  # shard id → [segment names] (wire retrieval)
    # extra per-row columns (e.g. recall-stage slop values 'title_slop' /
    # 'body_slop' computed shard-side from stored positions)
    cols: dict = field(default_factory=dict)
    # (shard, segment, doc) → retrieved doc dict, for rows that already paid
    # retrieval (optics residual) — to_candidates rehydrates c.retrieved
    retrieved_map: dict | None = None

    def __len__(self) -> int:
        return len(self.doc)

    @classmethod
    def empty(cls) -> "CandidateBlock":
        return cls(
            shard=np.zeros(0, np.int32), segment=np.zeros(0, np.int32),
            doc=np.zeros(0, np.int64), score=np.zeros(0, np.float32),
            dedup={n: np.zeros(0, np.int64) for n in DEDUP_NAMES},
            host_id=np.zeros(0, np.int64),
        )

    def take(self, idx) -> "CandidateBlock":
        """Sub-block by fancy index / slice (signals/embeddings follow)."""
        return CandidateBlock(
            shard=self.shard[idx], segment=self.segment[idx], doc=self.doc[idx],
            score=self.score[idx],
            dedup={n: c[idx] for n, c in self.dedup.items()},
            host_id=self.host_id[idx],
            signals=self.signals[idx] if self.signals is not None else None,
            title_emb=self.title_emb[idx] if self.title_emb is not None else None,
            keyword_emb=self.keyword_emb[idx] if self.keyword_emb is not None else None,
            ctxs=self.ctxs, seg_names=self.seg_names,
            cols={n: c[idx] for n, c in self.cols.items()},
            retrieved_map=self.retrieved_map,
        )

    @staticmethod
    def concat(blocks: list) -> "CandidateBlock":
        blocks = [b for b in blocks if len(b)]
        if not blocks:
            return CandidateBlock.empty()
        if len(blocks) == 1:
            return blocks[0]

        def cat(key):
            return np.concatenate([getattr(b, key) for b in blocks])

        # optional matrices concat only when present on EVERY block (a mixed
        # merge degrades to None, same as the object path's all-or-nothing)
        def cat_opt(key):
            mats = [getattr(b, key) for b in blocks]
            if any(m is None for m in mats):
                return None
            dims = {m.shape[1] for m in mats}
            if len(dims) != 1:
                return None
            return np.concatenate(mats)

        ctxs: dict = {}
        seg_names: dict = {}
        rmap: dict | None = None
        for b in blocks:
            ctxs.update(b.ctxs)
            seg_names.update(b.seg_names)
            if b.retrieved_map:
                rmap = {**(rmap or {}), **b.retrieved_map}
        # extra columns survive the merge only when EVERY block carries them
        # (all-or-nothing, like the optional matrices)
        shared_cols = set(blocks[0].cols)
        for b in blocks[1:]:
            shared_cols &= set(b.cols)
        return CandidateBlock(
            retrieved_map=rmap,
            shard=cat("shard"), segment=cat("segment"), doc=cat("doc"),
            score=cat("score"),
            dedup={n: np.concatenate([b.dedup[n] for b in blocks]) for n in DEDUP_NAMES},
            host_id=cat("host_id"),
            signals=cat_opt("signals"), title_emb=cat_opt("title_emb"),
            keyword_emb=cat_opt("keyword_emb"), ctxs=ctxs, seg_names=seg_names,
            cols={n: np.concatenate([b.cols[n] for b in blocks]) for n in shared_cols},
        )

    def sort_desc(self) -> "CandidateBlock":
        return self.take(np.argsort(-self.score, kind="stable"))

    # recall-stage term-distance (reference stages/recall.rs:311-312): slop
    # VALUES ride as block columns from the shard; these two helpers turn them
    # into scores/signals exactly once per flow
    def slop_score_delta(self, coeff_fn) -> np.ndarray | None:
        """Σ coeff × 1/(slop+1) per row, for the lazy path (the device-fused
        score doesn't include the slop signals)."""
        from ..term_distance import score_slop
        from .. import signals as S

        if "title_slop" not in self.cols:
            return None
        return (coeff_fn(S.MIN_TITLE_SLOP) * score_slop(self.cols["title_slop"])
                + coeff_fn(S.MIN_CLEAN_BODY_SLOP) * score_slop(self.cols["body_slop"]))

    def fill_slop_signals(self) -> None:
        """Write slop scores into the materialized signal matrix (so rescore,
        rankingSignals responses, and the precision stage see them)."""
        from ..term_distance import score_slop
        from .. import signals as S

        if self.signals is None or "title_slop" not in self.cols:
            return
        self.signals[:, S.MIN_TITLE_SLOP.id] = score_slop(self.cols["title_slop"])
        self.signals[:, S.MIN_CLEAN_BODY_SLOP.id] = score_slop(self.cols["body_slop"])

    def to_candidates(self, lo: int = 0, hi: int | None = None) -> list:
        """Materialize rows [lo:hi] as RankedCandidate objects (final page,
        optics residual, sidebar — the ≤20-row tails)."""
        from ..pipeline import RankedCandidate
        from ...index.inverted import DocPointer

        hi = len(self) if hi is None else min(hi, len(self))
        out = []
        for i in range(lo, hi):
            sid = int(self.shard[i])
            c = RankedCandidate(
                shard=sid,
                pointer=DocPointer(int(self.segment[i]), int(self.doc[i])),
                score=float(self.score[i]),
                signals=self.signals[i].copy() if self.signals is not None else None,
                title_embedding=self.title_emb[i] if self.title_emb is not None else None,
                keyword_embedding=self.keyword_emb[i] if self.keyword_emb is not None else None,
                dedup={n: int(self.dedup[n][i]) for n in DEDUP_NAMES},
                host_id=int(self.host_id[i]),
            )
            ctx = self.ctxs.get(sid)
            if ctx is not None:
                c._ctx = ctx
            names = self.seg_names.get(sid)
            if names is not None:
                o = int(self.segment[i])
                c._seg_name = names.get(o) if isinstance(names, dict) else names[o]
            if self.retrieved_map is not None:
                c.retrieved = self.retrieved_map.get(
                    (sid, int(self.segment[i]), int(self.doc[i])))
            if "title_slop" in self.cols:
                # slop signals came from stored positions (recall stage) — the
                # precision stage must not overwrite them from retrieved text
                c._slop_from_positions = True
            out.append(c)
        return out

    @classmethod
    def from_candidates(cls, candidates: list) -> "CandidateBlock":
        """Object-path bridge (optics residual re-entry, remote legacy wire)."""
        n = len(candidates)
        b = cls(
            shard=np.fromiter((c.shard for c in candidates), np.int32, n),
            segment=np.fromiter((c.pointer.segment for c in candidates), np.int32, n),
            doc=np.fromiter((c.pointer.doc for c in candidates), np.int64, n),
            score=np.fromiter((c.score for c in candidates), np.float32, n),
            # dedup hashes are u64 values stored in i64 columns (two's-
            # complement wrap, same as the segment column gathers)
            dedup={nm: np.fromiter((int((c.dedup or {}).get(nm, 0)) & 0xFFFFFFFFFFFFFFFF
                                    for c in candidates),
                                   np.uint64, n).view(np.int64) for nm in DEDUP_NAMES},
            host_id=np.fromiter((c.host_id for c in candidates), np.int64, n),
        )
        if n and all(c.signals is not None for c in candidates):
            b.signals = np.stack([c.signals for c in candidates]).astype(np.float32)
        if n and all(c.title_embedding is not None for c in candidates):
            b.title_emb = np.stack([c.title_embedding for c in candidates]).astype(np.float32)
        if n and all(c.keyword_embedding is not None for c in candidates):
            b.keyword_emb = np.stack([c.keyword_embedding for c in candidates]).astype(np.float32)
        for c in candidates:
            ctx = getattr(c, "_ctx", None)
            if ctx is not None:
                b.ctxs.setdefault(c.shard, ctx)
            # per-row segment names (wire candidates): stored as {ord: name},
            # which to_candidates indexes the same way as a snapshot list
            nm = getattr(c, "_seg_name", None)
            if nm is not None:
                b.seg_names.setdefault(c.shard, {})[c.pointer.segment] = nm
        return b


SIMHASH_MAX_DISTANCE = 3  # matches utils.simhash.is_near_duplicate


def merge_blocks(blocks: list, max_docs: int, de_rank_similar: bool = True) -> CandidateBlock:
    """Cross-shard merge with dedup on arrays (BucketCollector.into_sorted_vec
    semantics, collector/top_docs.rs:326-340): score-desc order; exact dups
    (url-without-query hash pair, title+site hash pair) dropped keeping the
    best-scored; simhash near-dups de-ranked below all unique results."""
    b = CandidateBlock.concat(blocks)
    n = len(b)
    if n == 0:
        return b
    b = b.sort_desc()

    # exact dedup: first occurrence in score order wins. Rows with an all-zero
    # key pair are exempt (parity with the object path's (0, 0) check). The
    # title+site pass runs over URL-pass SURVIVORS only — a row dropped as a
    # url-dup must not claim its title+site key (BucketCollector inserts into
    # seen_title_site only after the url check passes).
    def first_occurrence(rows: np.ndarray, k1: str, k2: str) -> np.ndarray:
        a = b.dedup[k1].astype(np.uint64)[rows]
        c = b.dedup[k2].astype(np.uint64)[rows]
        has_key = (a != 0) | (c != 0)
        packed = np.stack([a, c], axis=1)
        _, first = np.unique(packed, axis=0, return_index=True)
        is_first = np.zeros(len(rows), dtype=bool)
        is_first[first] = True
        return rows[is_first | ~has_key]

    idx = first_occurrence(np.arange(n), "url_without_query_hash1",
                           "url_without_query_hash2")
    idx = first_occurrence(idx, "title_hash1", "site_hash1")
    sh = b.dedup["sim_hash"].astype(np.uint64)

    # simhash de-rank: greedy in score order against previously KEPT hashes.
    # Sequential by nature; the loop runs over ≤ max_docs survivors with a
    # vectorized XOR+popcount per row (the object path did the same per
    # candidate, plus attribute chasing).
    out_rows: list = []
    deranked: list = []
    kept_hashes = np.zeros(min(len(idx), max_docs), dtype=np.uint64)
    n_kept = 0
    for i in idx:
        h = sh[i]
        if de_rank_similar and h and n_kept:
            x = kept_hashes[:n_kept] ^ h
            if int(_popcount(x).min()) <= SIMHASH_MAX_DISTANCE:
                deranked.append(i)
                continue
        if h and n_kept < len(kept_hashes):
            kept_hashes[n_kept] = h
            n_kept += 1
        out_rows.append(i)
        if len(out_rows) >= max_docs:
            break
    out_rows.extend(deranked[: max(max_docs - len(out_rows), 0)])
    return b.take(np.asarray(out_rows, dtype=np.int64))


def _popcount(x):
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (x * np.uint64(0x0101010101010101)) >> np.uint64(56)
