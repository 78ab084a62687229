"""Stable 64/128-bit hashing used across the engine.

Role of reference's `prehashed.rs` / `intmap.rs` hashing (crates/core/src/prehashed.rs):
terms, node ids and KV keys are addressed by stable integer hashes so the hot paths
operate on fixed-width integers instead of strings.  All hashes here are pure
functions of bytes — stable across processes and machines (required because term
dictionaries and webgraph node ids are persisted).
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit hash of bytes."""
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def splitmix64(x: int) -> int:
    """SplitMix64 finalizer — cheap avalanche for integer keys."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def combine_u64s(a: int, b: int) -> int:
    """Combine two u64 hashes (role of crates/bloom combine_u64s)."""
    return splitmix64((a ^ ((b << 1) & _MASK64)) & _MASK64)


def prehash(s: str) -> int:
    """Stable u64 hash of a unicode string (role of prehashed.rs Prehashed)."""
    return fnv1a64(s.encode("utf-8"))


def term_hash(field_id: int, token: str) -> int:
    """Term-dictionary key: hash of (field, token).

    The reference keeps per-field postings inside tantivy segments
    (crates/tantivy); here every (field, token) pair owns one posting list keyed
    by a stable u64.
    """
    return combine_u64s(splitmix64(field_id), prehash(token))


def hash128(s: str) -> int:
    """Stable 128-bit hash for webgraph NodeIDs (role of webgraph/node.rs NodeID u128)."""
    b = s.encode("utf-8")
    lo = fnv1a64(b)
    hi = fnv1a64(b + b"\x00hi")
    return (hi << 64) | lo


def fnv1a64_many(data: list) -> np.ndarray:
    """fnv1a64 of each byte string, vectorised over the list (one pass per
    byte position) → uint64 array, equal to [fnv1a64(d) for d in data]."""
    n = len(data)
    lens = np.fromiter((len(d) for d in data), dtype=np.int64, count=n)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    if n == 0 or lens.max() == 0:
        return h
    width = int(lens.max())
    buf = np.frombuffer(b"".join(d.ljust(width, b"\0") for d in data), dtype=np.uint8)
    buf = buf.reshape(n, width)
    prime = np.uint64(_FNV_PRIME)
    for j in range(width):
        live = lens > j
        h[live] = (h[live] ^ buf[live, j]) * prime  # uint64 arrays wrap mod 2**64
    return h


def splitmix64_many(x: np.ndarray) -> np.ndarray:
    """splitmix64 over a uint64 array (wrapping arithmetic)."""
    z = np.asarray(x, dtype=np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def fnv1a64_np(tokens: list[bytes]) -> np.ndarray:
    """Vectorized-ish FNV over a list of byte strings → uint64 array."""
    out = np.empty(len(tokens), dtype=np.uint64)
    for i, t in enumerate(tokens):
        out[i] = fnv1a64(t)
    return out
