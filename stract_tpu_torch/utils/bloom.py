"""Bloom filters (role of reference crates/bloom: U64BloomFilter, BytesBloomFilter).

Backed by a numpy uint64 bitset so filters can be merged with a vectorized OR and
serialized as raw bytes. Used by the KV store segments and centrality bookkeeping.
"""

from __future__ import annotations

import math

import numpy as np

from .hashing import fnv1a64, splitmix64, splitmix64_many


class U64BloomFilter:
    """Bloom filter over u64 keys. k hash probes derived from splitmix chains."""

    def __init__(self, estimated_items: int = 1024, fp_rate: float = 0.01):
        estimated_items = max(1, estimated_items)
        m = int(-estimated_items * math.log(fp_rate) / (math.log(2) ** 2))
        m = max(64, m)
        self.num_bits = ((m + 63) // 64) * 64
        self.num_hashes = max(1, round((self.num_bits / estimated_items) * math.log(2)))
        self.bits = np.zeros(self.num_bits // 64, dtype=np.uint64)

    def _probes(self, key: int):
        h = key & 0xFFFFFFFFFFFFFFFF
        for _ in range(self.num_hashes):
            h = splitmix64(h)
            yield h % self.num_bits

    def insert(self, key: int) -> None:
        for p in self._probes(key):
            self.bits[p >> 6] |= np.uint64(1 << (p & 63))

    def insert_many(self, keys) -> None:
        """insert() over every key, vectorised: the same probes, the same bits."""
        h = np.asarray(keys, dtype=np.uint64)
        for _ in range(self.num_hashes):
            h = splitmix64_many(h)
            p = h % np.uint64(self.num_bits)
            np.bitwise_or.at(self.bits, (p >> np.uint64(6)).astype(np.int64),
                             np.left_shift(np.uint64(1), p & np.uint64(63)))

    def contains(self, key: int) -> bool:
        one = np.uint64(1)
        for p in self._probes(key):
            if not (self.bits[p >> 6] >> np.uint64(p & 63)) & one:
                return False
        return True

    def union(self, other: "U64BloomFilter") -> None:
        assert self.num_bits == other.num_bits
        self.bits |= other.bits

    def estimate_card(self) -> float:
        """Estimated number of distinct inserted items."""
        x = int(np.sum([bin(int(w)).count("1") for w in self.bits]))
        if x >= self.num_bits:
            return float(self.num_bits)
        return -self.num_bits / self.num_hashes * math.log(1 - x / self.num_bits)

    def to_bytes(self) -> bytes:
        head = np.array([self.num_bits, self.num_hashes], dtype=np.uint64).tobytes()
        return head + self.bits.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "U64BloomFilter":
        head = np.frombuffer(data[:16], dtype=np.uint64)
        f = cls.__new__(cls)
        f.num_bits = int(head[0])
        f.num_hashes = int(head[1])
        f.bits = np.frombuffer(data[16:], dtype=np.uint64).copy()
        return f


class BytesBloomFilter(U64BloomFilter):
    """Bloom filter over byte strings."""

    def insert_bytes(self, data: bytes) -> None:
        self.insert(fnv1a64(data))

    def contains_bytes(self, data: bytes) -> bool:
        return self.contains(fnv1a64(data))
