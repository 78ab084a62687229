"""Inbound-link similarity (the port's copy of
stract_tpu/ranking/inbound_similarity.py, over the port's webgraph store; role of reference ranking/inbound_similarity.rs,
353 LoC + bitvec_similarity.rs, 331 LoC).

A host's profile is the set of hosts linking to it (inbound host ranks). The
query side aggregates the profiles of the user's liked/disliked hosts
(optics HostRankings); a candidate's signal is

    score = Σ_liked cos(profile(liked), profile(candidate))
          − Σ_disliked cos(profile(disliked), profile(candidate))

with cos(A, B) = |A ∩ B| / sqrt(|A|·|B|) over binary vectors. Profiles are
sorted-int arrays host-side; batch scoring intersects with np.intersect1d
(the reference's bitvec AND + popcount)."""

from __future__ import annotations

import numpy as np

from ..utils.hashing import prehash
from ..webgraph.store import Webgraph


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0 or len(b) == 0:
        return 0.0
    inter = len(np.intersect1d(a, b, assume_unique=True))
    return inter / np.sqrt(len(a) * len(b))


class InboundSimilarity:
    def __init__(self, graph: Webgraph):
        self.graph = graph
        self._cache: dict[int, np.ndarray] = {}

    def profile(self, host) -> np.ndarray:
        """Sorted inbound host-rank array for a host (by name or rank)."""
        rank = host if isinstance(host, int) else self.graph.rank_of(host)
        if rank is None:
            return np.zeros(0, dtype=np.int64)
        if rank not in self._cache:
            self._cache[rank] = np.unique(self.graph.backlink_ranks(rank))
        return self._cache[rank]

    def profile_by_node_id(self, node_id: int) -> np.ndarray:
        rank = self.graph.rank_of(node_id)
        if rank is None:
            return np.zeros(0, dtype=np.int64)
        return self.profile(rank)

    def score(self, host_rankings, candidate_node_ids: list[int]) -> np.ndarray:
        """Signal values for candidates given the query's HostRankings."""
        out = np.zeros(len(candidate_node_ids), dtype=np.float64)
        if host_rankings is None:
            return out
        liked = [self.profile(h) for h in getattr(host_rankings, "liked", [])]
        disliked = [self.profile(h) for h in getattr(host_rankings, "disliked", [])]
        if not liked and not disliked:
            return out
        for i, nid in enumerate(candidate_node_ids):
            cand = self.profile_by_node_id(int(nid))
            s = sum(_cosine(l, cand) for l in liked)
            s -= sum(_cosine(d, cand) for d in disliked)
            out[i] = s
        return out

    def similar_hosts(self, hosts: list[str], top_k: int = 20) -> list[tuple[str, float]]:
        """Explore feature (role of reference similar_hosts.rs): hosts whose
        inbound profiles are most similar to the given hosts'."""
        seeds = [self.profile(h) for h in hosts]
        seeds = [s for s in seeds if len(s)]
        if not seeds:
            return []
        # candidate pool: hosts co-cited with the seeds (share an in-linker)
        pool = set()
        for s in seeds:
            for linker in s[:512]:
                for tgt, _ in self.graph.forwardlinks(int(linker))[:512]:
                    pool.add(tgt)
        for h in hosts:
            r = self.graph.rank_of(h)
            if r is not None:
                pool.discard(r)
        scored = []
        for cand in pool:
            p = self.profile(int(cand))
            s = sum(_cosine(seed, p) for seed in seeds)
            if s > 0:
                scored.append((self.graph.name_of(int(cand)), s))
        scored.sort(key=lambda kv: -kv[1])
        return scored[:top_k]


def host_node_id(host: str) -> int:
    """HostNodeID column value for a host name (keep in sync with the indexer)."""
    return prehash(host)
