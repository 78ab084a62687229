"""Query autosuggest (the port's copy of stract_tpu/autosuggest.py; role of reference autosuggest.rs — FST-based prefix
search over popular queries; here a sorted array + binary search, the same
O(prefix) access pattern)."""

from __future__ import annotations

import bisect
import os

import msgpack


class Autosuggest:
    def __init__(self, entries: dict[str, float] | None = None):
        self.queries: list[str] = []
        self.scores: dict[str, float] = {}
        if entries:
            self.scores = {q.strip().lower(): s for q, s in entries.items() if q.strip()}
            self.queries = sorted(self.scores)

    @classmethod
    def from_queries(cls, queries: list[str]) -> "Autosuggest":
        from collections import Counter

        counts = Counter(q.strip().lower() for q in queries if q.strip())
        return cls(dict(counts))

    def suggest(self, prefix: str, top_k: int = 10) -> list[str]:
        p = prefix.strip().lower()
        if not p:
            return []
        lo = bisect.bisect_left(self.queries, p)
        hi = bisect.bisect_right(self.queries, p + "￿")
        matches = self.queries[lo:hi]
        matches.sort(key=lambda q: (-self.scores.get(q, 0.0), q))
        return matches[:top_k]

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(msgpack.packb(self.scores, use_bin_type=True))

    @classmethod
    def load(cls, path: str) -> "Autosuggest":
        with open(path, "rb") as fh:
            return cls(msgpack.unpackb(fh.read(), raw=False))
