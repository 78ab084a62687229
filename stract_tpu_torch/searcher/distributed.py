"""DistributedSearcher — the coordinator's fan-out over search shards (the
port of stract_tpu/searcher/distributed.py; role of reference
searcher/distributed.rs:287: search_initial to AllShards with
RandomReplicaSelector, retrieve to the owning shards). It speaks the JAX
package's wire forms over sonic, so its shards may be servers of either
package. With a live client, the live-index shards' candidates (the
freshness tier, entrypoint/live_index.py) merge with the backbone's under
shard ids offset by LIVE_SHARD_OFFSET in all three search forms, and their
retrieval goes back to the live client; the live fan-out is best-effort, as
in the reference. LocalShardedSearcher is the in-process variant:
LocalSearchers behind the same interface, without sockets."""

from __future__ import annotations

from ..collector import ApproxCount
from ..distributed.replication import (
    AllShardsSelector,
    RandomReplicaSelector,
    SpecificShardSelector,
)
from ..entrypoint.search_server import candidate_from_wire
from .query import SearchQuery

# live-index shard ids are offset so they never collide with backbone shard ids
# (reference ShardId::{Backbone, Live}, inverted_index/mod.rs:90)
LIVE_SHARD_OFFSET = 1 << 20


class DistributedSearcher:
    def __init__(self, client, live_client=None):
        """client: ShardedClient | ReusableShardedClient over 'search-server'.
        live_client: optional client over 'live-index' shards — fresh results
        merge with the backbone (reference ShardId::{Backbone,Live},
        inverted_index/mod.rs:90)."""
        self.client = client
        self.live_client = live_client

    def _fan_search(self, client, sq: SearchQuery, shard_offset: int):
        results = client.send(
            "search", sq.to_json(), shard_selector=AllShardsSelector(),
            replica_selector=RandomReplicaSelector(),
        )
        candidates = []
        count = ApproxCount(0, True)
        for sid, replies in results.items():
            r = replies[0]
            for c in r["candidates"]:
                cand = candidate_from_wire(c)
                cand.shard = sid + shard_offset
                candidates.append(cand)
            count = count + ApproxCount(r["count"]["value"], r["count"]["exact"])
        return candidates, count

    def search_initial(self, sq: SearchQuery):
        candidates, count = self._fan_search(self.client, sq, 0)
        if self.live_client is not None:
            try:
                live_c, live_n = self._fan_search(self.live_client, sq, LIVE_SHARD_OFFSET)
                candidates.extend(live_c)
                count = count + live_n
            except Exception:  # noqa: BLE001 — freshness tier is best-effort
                pass
        return candidates, count

    def search_initial_many(self, sqs: list) -> list:
        """Batched fan-out: ONE search_batch RPC per shard carries the whole
        query batch (shard servers run search_initial_many directly)."""
        results = self.client.send(
            "search_batch", {"queries": [sq.to_json() for sq in sqs]},
            shard_selector=AllShardsSelector(), replica_selector=RandomReplicaSelector(),
        )
        out = [([], ApproxCount(0, True)) for _ in sqs]
        for sid, replies in results.items():
            for qi, r in enumerate(replies[0]):
                cands, count = out[qi]
                for c in r["candidates"]:
                    cand = candidate_from_wire(c)
                    cand.shard = sid
                    cands.append(cand)
                out[qi] = (cands, count + ApproxCount(r["count"]["value"], r["count"]["exact"]))
        if self.live_client is not None:
            for qi, sq in enumerate(sqs):
                try:
                    live_c, live_n = self._fan_search(self.live_client, sq, LIVE_SHARD_OFFSET)
                    out[qi][0].extend(live_c)
                    out[qi] = (out[qi][0], out[qi][1] + live_n)
                except Exception:  # noqa: BLE001
                    pass
        return out

    def search_blocks_many(self, sqs: list, max_candidates: int | None = None) -> list:
        """Array-carried batched fan-out: ONE search_block_batch RPC per shard
        carries the whole query batch as packed arrays — no per-result wire
        dicts or Python objects (combine_results searcher/api/mod.rs:412-465
        feeds from these)."""
        from ..entrypoint.search_server import block_from_wire
        from ..ranking.pipeline.block import CandidateBlock

        body = {"queries": [sq.to_json() for sq in sqs]}
        if max_candidates is not None:
            body["max_candidates"] = max_candidates
        results = self.client.send(
            "search_block_batch", body,
            shard_selector=AllShardsSelector(), replica_selector=RandomReplicaSelector(),
        )
        blocks = [[] for _ in sqs]
        counts = [ApproxCount(0, True) for _ in sqs]
        for sid, replies in results.items():
            for qi, r in enumerate(replies[0]):
                blocks[qi].append(block_from_wire(r["block"], sid))
                counts[qi] = counts[qi] + ApproxCount(r["count"]["value"], r["count"]["exact"])
        if self.live_client is not None:
            for qi, sq in enumerate(sqs):
                try:
                    live_c, live_n = self._fan_search(self.live_client, sq, LIVE_SHARD_OFFSET)
                    blocks[qi].append(CandidateBlock.from_candidates(live_c))
                    counts[qi] = counts[qi] + live_n
                except Exception:  # noqa: BLE001 — freshness tier is best-effort
                    pass
        return [(CandidateBlock.concat(bl), cnt) for bl, cnt in zip(blocks, counts)]

    def retrieve(self, sq: SearchQuery, candidates: list) -> None:
        """Fetch stored docs for candidates from their owning shards, in place."""
        by_shard: dict = {}
        for c in candidates:
            by_shard.setdefault(c.shard, []).append(c)
        for sid, cands in by_shard.items():
            body = {
                "query": sq.to_json(),
                "pointers": [
                    {**c.pointer.to_json(), "seg": getattr(c, "_seg_name", None)}
                    for c in cands
                ],
            }
            if sid >= LIVE_SHARD_OFFSET and self.live_client is not None:
                client, real_sid = self.live_client, sid - LIVE_SHARD_OFFSET
            else:
                client, real_sid = self.client, sid
            replies = client.send(
                "retrieve", body, shard_selector=SpecificShardSelector(real_sid),
                replica_selector=RandomReplicaSelector(),
            )
            docs = replies[real_sid][0]
            for c, d in zip(cands, docs):
                c.retrieved = d

    def ensure_signals(self, sq: SearchQuery, candidates: list) -> None:
        """Remote shards serialize materialized signals; nothing to do."""
        return None

    def ensure_signals_many(self, items: list) -> None:
        """items = [(sq, candidates)]; remote candidates arrive materialized."""
        return None

    def size(self) -> int:
        results = self.client.send("size", {}, shard_selector=AllShardsSelector(),
                                   replica_selector=RandomReplicaSelector())
        return sum(r[0]["num_docs"] for r in results.values())

    def get_webpage(self, url: str):
        results = self.client.send("get_webpage", {"url": url})
        for replies in results.values():
            if replies[0] is not None:
                return replies[0]
        return None


class LocalShardedSearcher(DistributedSearcher):
    """In-process variant for single-box serving/tests: LocalSearchers behind
    the DistributedSearcher interface without sockets."""

    def __init__(self, searchers: list):
        self.searchers = {s.shard_id: s for s in searchers}

    def search_initial(self, sq: SearchQuery):
        candidates = []
        count = ApproxCount(0, True)
        for sid, s in self.searchers.items():
            cands, cnt = s.search_initial(sq)
            candidates.extend(cands)
            count = count + cnt
        return candidates, count

    def search_initial_many(self, sqs: list) -> list:
        out = [([], ApproxCount(0, True)) for _ in sqs]
        for sid, s in self.searchers.items():
            for qi, (cands, cnt) in enumerate(s.search_initial_many(sqs)):
                out[qi][0].extend(cands)
                out[qi] = (out[qi][0], out[qi][1] + cnt)
        return out

    def search_blocks_many(self, sqs: list, max_candidates: int | None = None) -> list:
        """Array-carried fan-out: per-shard CandidateBlocks concatenated per
        query (the dedup merge happens at the coordinator's merge stage)."""
        from ..ranking.pipeline import NUM_PIPELINE_RANKING_RESULTS
        from ..ranking.pipeline.block import CandidateBlock

        mc = max_candidates or NUM_PIPELINE_RANKING_RESULTS
        blocks = [[] for _ in sqs]
        counts = [ApproxCount(0, True) for _ in sqs]
        for sid, s in self.searchers.items():
            for qi, (block, cnt) in enumerate(s.search_blocks_many(sqs, mc)):
                blocks[qi].append(block)
                counts[qi] = counts[qi] + cnt
        return [(CandidateBlock.concat(bl), cnt) for bl, cnt in zip(blocks, counts)]

    def retrieve(self, sq: SearchQuery, candidates: list) -> None:
        by_shard: dict = {}
        for c in candidates:
            by_shard.setdefault(c.shard, []).append(c)
        for sid, cands in by_shard.items():
            # resolve pointer ordinals against the snapshot the candidates were
            # searched with (lazy candidates carry their ctx) — a compact/prune
            # between pass 1 and this retrieve must not remap them
            ctx = getattr(cands[0], "_ctx", None)
            snap = getattr(ctx, "_segments", None) if ctx is not None else None
            docs = self.searchers[sid].retrieve(sq, [c.pointer for c in cands], segments=snap)
            for c, d in zip(cands, docs):
                c.retrieved = d

    def ensure_signals(self, sq: SearchQuery, candidates: list) -> None:
        self.ensure_signals_many([(sq, candidates)])

    def ensure_signals_many(self, items: list) -> None:
        """Batched lazy-signal materialization: ONE device pass per shard
        across every query's candidate set (per-query passes would pay a
        launch and a fetch each)."""
        by_shard: dict = {}
        for sq, candidates in items:
            for c in candidates:
                if c.signals is None:
                    by_shard.setdefault(c.shard, {}).setdefault(id(sq), (sq, []))[1].append(c)
        for sid, groups in by_shard.items():
            self.searchers[sid].materialize_signals_many(list(groups.values()))

    def ensure_blocks_many(self, items: list) -> None:
        """Array-carried lazy-signal materialization: items = [(sq, block)].
        Rows group by owning shard; ONE compute_signals_arrays_many pass per
        shard covers every query's rows."""
        import numpy as np

        from ..ranking import signals as S

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
                sig_items.append((ctx, block.segment[rows].astype(np.int64),
                                  block.doc[rows]))
            sigs = searcher.index.compute_signals_arrays_many(sig_items)
            for (sq, block, rows), sig in zip(entries, sigs):
                block.signals[rows] = sig

    def size(self) -> int:
        return sum(s.index.num_docs for s in self.searchers.values())

    def get_webpage(self, url: str):
        from ..entrypoint.search_server import SearchService

        for s in self.searchers.values():
            svc = SearchService.__new__(SearchService)
            svc.searcher = s
            svc.shard_id = s.shard_id
            hit = svc.get_webpage({"url": url})
            if hit:
                return hit
        return None
