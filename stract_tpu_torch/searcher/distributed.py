"""LocalShardedSearcher — in-process shard fan-out (the port of the
LocalShardedSearcher in stract_tpu/searcher/distributed.py: LocalSearchers
behind the coordinator's interface, without sockets)."""

from __future__ import annotations

import numpy as np

from ..collector import ApproxCount
from ..ranking import signals as S
from ..ranking.pipeline import NUM_PIPELINE_RANKING_RESULTS
from ..ranking.pipeline.block import CandidateBlock

from .query import SearchQuery


class LocalShardedSearcher:
    def __init__(self, searchers: list):
        self.searchers = {s.shard_id: s for s in searchers}

    def search_blocks_many(self, sqs: list, max_candidates: int | None = None) -> list:
        """Per-shard CandidateBlocks concatenated per query (the dedup merge
        happens at the coordinator)."""
        mc = max_candidates or NUM_PIPELINE_RANKING_RESULTS
        blocks = [[] for _ in sqs]
        counts = [ApproxCount(0, True) for _ in sqs]
        for s in self.searchers.values():
            for qi, (block, cnt) in enumerate(s.search_blocks_many(sqs, mc)):
                blocks[qi].append(block)
                counts[qi] = counts[qi] + cnt
        return [(CandidateBlock.concat(bl), cnt) for bl, cnt in zip(blocks, counts)]

    def retrieve(self, sq: SearchQuery, candidates: list) -> None:
        """Stored docs for candidates from their shards, in place; ordinals
        resolve against the snapshot the candidates were searched with."""
        by_shard: dict = {}
        for c in candidates:
            by_shard.setdefault(c.shard, []).append(c)
        for sid, cands in by_shard.items():
            ctx = getattr(cands[0], "_ctx", None)
            snap = getattr(ctx, "_segments", None) if ctx is not None else None
            docs = self.searchers[sid].retrieve(sq, [c.pointer for c in cands], segments=snap)
            for c, d in zip(cands, docs):
                c.retrieved = d

    def ensure_blocks_many(self, items: list) -> None:
        """Lazy signal rows for items = [(sq, block)]: one pass-2 call per
        shard covers every query's rows."""
        per_shard: dict = {}
        for sq, block in items:
            if len(block) == 0 or block.signals is not None:
                continue
            block.signals = np.zeros((len(block), S.NUM_SIGNALS), dtype=np.float32)
            for sid in np.unique(block.shard):
                rows = np.nonzero(block.shard == sid)[0]
                per_shard.setdefault(int(sid), []).append((sq, block, rows))
        for sid, entries in per_shard.items():
            searcher = self.searchers[sid]
            sig_items = []
            for sq, block, rows in entries:
                ctx = block.ctxs.get(sid)
                if ctx is None:
                    ctx = searcher.parse_query(sq).context()
                sig_items.append((ctx, block.segment[rows].astype(np.int64), block.doc[rows]))
            sigs = searcher.index.compute_signals_arrays_many(sig_items)
            for (sq, block, rows), sig in zip(entries, sigs):
                block.signals[rows] = sig

    def size(self) -> int:
        return sum(s.index.num_docs for s in self.searchers.values())
