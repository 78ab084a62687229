"""Cross-shard result merging with de-duplication (role of reference
collector/top_docs.rs BucketCollector: :326-340 dedups in into_sorted_vec, and
approx_count.rs for result-count estimation).

Exact duplicates (same url-without-query hash, or same title+site hash) are
dropped; simhash near-duplicates are de-ranked (pushed below all unique results)
— the reference's de-rank-similar behavior."""

from __future__ import annotations



class BucketCollector:
    def __init__(self, max_docs: int):
        self.max_docs = max_docs
        self.items: list = []

    def insert(self, candidate) -> None:
        self.items.append(candidate)

    def extend(self, candidates) -> None:
        self.items.extend(candidates)

    def into_sorted_vec(self, de_rank_similar: bool = True) -> list:
        import numpy as np

        self.items.sort(key=lambda c: -c.score)
        seen_url = set()
        seen_title_site = set()
        # vectorized near-dup check: XOR against ALL kept hashes + popcount in
        # numpy (the per-pair Python loop was quadratic and dominated the
        # coordinator tail at 300 candidates/query)
        kept_simhashes = np.zeros(self.max_docs, dtype=np.uint64)
        n_kept = 0
        out = []
        deranked = []
        for c in self.items:
            d = c.dedup or {}
            url_h = (d.get("url_without_query_hash1", 0), d.get("url_without_query_hash2", 0))
            ts_h = (d.get("title_hash1", 0), d.get("site_hash1", 0))
            if url_h != (0, 0):
                if url_h in seen_url:
                    continue
                seen_url.add(url_h)
            if ts_h != (0, 0):
                if ts_h in seen_title_site:
                    continue
                seen_title_site.add(ts_h)
            sh = int(d.get("sim_hash", 0)) & 0xFFFFFFFFFFFFFFFF
            if de_rank_similar and sh and n_kept:
                x = kept_simhashes[:n_kept] ^ np.uint64(sh)
                if int(_popcount(x).min()) <= SIMHASH_MAX_DISTANCE:
                    deranked.append(c)
                    continue
            if sh and n_kept < len(kept_simhashes):
                kept_simhashes[n_kept] = sh
                n_kept += 1
            out.append(c)
            if len(out) >= self.max_docs:
                break
        out.extend(deranked[: max(self.max_docs - len(out), 0)])
        return out


SIMHASH_MAX_DISTANCE = 3  # matches utils.simhash.is_near_duplicate


def _popcount(x):
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x)
    # fallback: SWAR popcount on uint64
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return (x * np.uint64(0x0101010101010101)) >> np.uint64(56)


class ApproxCount:
    """Result-count estimate (role of collector/approx_count.rs Count::{Exact,
    Approximate}): exact when the shard scanned everything, extrapolated when
    early termination kicked in."""

    def __init__(self, value: int, exact: bool):
        self.value = value
        self.exact = exact

    def __add__(self, other: "ApproxCount") -> "ApproxCount":
        return ApproxCount(self.value + other.value, self.exact and other.exact)

    def to_json(self):
        return {"value": self.value, "exact": self.exact}
