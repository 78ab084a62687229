"""SimHash near-duplicate fingerprints (role of reference simhash.rs).

64-bit simhash over token hashes; used by the collector to de-rank near-identical
pages (collector/top_docs.rs dedup in the reference).
"""

from __future__ import annotations

import numpy as np

from .hashing import prehash


def simhash_tokens(tokens: list[str]) -> int:
    if not tokens:
        return 0
    hashes = np.array([prehash(t) for t in tokens], dtype=np.uint64)
    bits = ((hashes[:, None] >> np.arange(64, dtype=np.uint64)[None, :]) & np.uint64(1)).astype(np.int64)
    votes = (2 * bits - 1).sum(axis=0)
    out = np.uint64(0)
    for i in range(64):
        if votes[i] > 0:
            out |= np.uint64(1) << np.uint64(i)
    return int(out)


def simhash_text(text: str) -> int:
    return simhash_tokens(text.split())


def hamming_distance(a: int, b: int) -> int:
    return bin(a ^ b).count("1")


def is_near_duplicate(a: int, b: int, max_distance: int = 3) -> bool:
    if a == 0 or b == 0:
        return False
    return hamming_distance(a, b) <= max_distance
