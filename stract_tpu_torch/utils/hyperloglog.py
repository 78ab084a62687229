"""HyperLogLog cardinality sketches on the host — the port's copy of
stract_tpu/utils/hyperloglog.py (role of reference hyperloglog.rs, 4.6k LoC
HLL++). It is not ops/hll_ops.py: that module holds the graph's sketches as
one [num_nodes, num_registers] u8 tensor and merges them on the card (K6a,
K6b); this class is the scalar / streaming counterpart with the same register
semantics, so host and device sketches interconvert losslessly. The
coordinator's user counts (api/user_count.py) observe into it.

Uses the classic HLL bias-corrected estimator with linear counting for small
cardinalities (the reference ships HLL++ bias tables, hyperloglog.rs:27-1150;
the standard corrections are within the same error envelope for the register
counts used here).
"""

from __future__ import annotations

import math

import numpy as np

from .hashing import splitmix64


class HyperLogLog:
    """HLL sketch with 2**precision registers (default 64 registers = precision 6,
    matching the reference's HyperLogLog<64> used for harmonic centrality,
    webgraph/centrality/harmonic.rs)."""

    __slots__ = ("precision", "m", "registers")

    def __init__(self, precision: int = 6):
        self.precision = precision
        self.m = 1 << precision
        self.registers = np.zeros(self.m, dtype=np.uint8)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_registers(cls, registers: np.ndarray) -> "HyperLogLog":
        h = cls.__new__(cls)
        h.m = len(registers)
        h.precision = int(math.log2(h.m))
        h.registers = registers.astype(np.uint8, copy=True)
        return h

    # -- updates -------------------------------------------------------------
    def add_u64(self, value: int) -> None:
        h = splitmix64(int(value) & 0xFFFFFFFFFFFFFFFF)
        idx = h >> (64 - self.precision)
        rest = (h << self.precision) & 0xFFFFFFFFFFFFFFFF
        # rank = leading zeros of remaining bits + 1, capped
        if rest == 0:
            rank = 64 - self.precision + 1
        else:
            rank = 1
            probe = 1 << 63
            while not (rest & probe):
                rank += 1
                probe >>= 1
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    def add_many_u64(self, values: np.ndarray) -> None:
        for v in np.asarray(values, dtype=np.uint64):
            self.add_u64(int(v))

    def merge(self, other: "HyperLogLog") -> None:
        assert self.m == other.m
        np.maximum(self.registers, other.registers, out=self.registers)

    # -- estimation -----------------------------------------------------------
    @staticmethod
    def _alpha(m: int) -> float:
        if m == 16:
            return 0.673
        if m == 32:
            return 0.697
        if m == 64:
            return 0.709
        return 0.7213 / (1 + 1.079 / m)

    def size(self) -> float:
        regs = self.registers.astype(np.float64)
        est = self._alpha(self.m) * self.m * self.m / np.sum(np.exp2(-regs))
        if est <= 2.5 * self.m:
            zeros = int(np.count_nonzero(self.registers == 0))
            if zeros > 0:
                return self.m * math.log(self.m / zeros)
        return float(est)

    def __len__(self) -> int:
        return int(round(self.size()))

    def to_bytes(self) -> bytes:
        return self.registers.tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "HyperLogLog":
        return cls.from_registers(np.frombuffer(data, dtype=np.uint8))


def raw_estimates(registers: np.ndarray) -> np.ndarray:
    """Uncorrected HLL estimate per row (no linear counting): [N, m] → [N]."""
    registers = np.asarray(registers)
    m = registers.shape[1]
    return HyperLogLog._alpha(m) * m * m / np.sum(
        np.exp2(-registers.astype(np.float64)), axis=1)


def mc_bias_table(precision: int = 6, trials: int = 4000, seed: int = 0,
                  max_factor: float = 6.0, n_points: int = 48):
    """Monte-Carlo bias table for the HLL++ estimator (role of the reference's
    empirical bias-correction constants, hyperloglog.rs:27-1150 — Google built
    those by simulation; this derives the same kind of table independently,
    for our hash, instead of copying theirs). For a grid of true cardinalities
    c ≤ max_factor·m, inserts c random u64s `trials` times and records the
    mean RAW estimate → (raw_grid, bias_grid) for interpolation."""
    rng = np.random.default_rng(seed)
    m = 1 << precision
    cards = np.unique(np.round(np.geomspace(1, max_factor * m, n_points)).astype(int))
    raw_grid, bias_grid = [], []
    for c in cards:
        h = rng.integers(0, 2**64, size=(trials, c), dtype=np.uint64)
        idx = (h >> np.uint64(64 - precision)).astype(np.int64)
        rest = (h << np.uint64(precision)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        # rank = leading zeros of the remaining 64-p bits + 1
        nbits = np.where(rest > 0, 64 - np.floor(np.log2(
            np.maximum(rest, 1).astype(np.float64))).astype(np.int64) - 1, 64)
        rank = np.minimum(nbits + 1, 64 - precision + 1).astype(np.uint8)
        regs = np.zeros((trials, m), dtype=np.uint8)
        flat = idx + (np.arange(trials)[:, None] * m)
        np.maximum.at(regs.reshape(-1), flat.reshape(-1), rank.reshape(-1))
        raw = raw_estimates(regs)
        raw_grid.append(float(raw.mean()))
        bias_grid.append(float(raw.mean() - c))
    return np.asarray(raw_grid), np.asarray(bias_grid)


def estimate_cardinalities_pp(registers: np.ndarray,
                              bias: tuple | None = None,
                              precision_cache: dict = {}) -> np.ndarray:
    """HLL++-faithful estimation (role of reference hyperloglog.rs HLL++ path):
    raw estimate, minus interpolated empirical bias when raw ≤ 5m, with linear
    counting preferred while zero registers remain and its estimate stays
    under the small-range threshold. bias = (raw_grid, bias_grid) from
    mc_bias_table (computed once per precision and memoized)."""
    registers = np.asarray(registers)
    n, m = registers.shape
    p = int(math.log2(m))
    if bias is None:
        if p not in precision_cache:
            precision_cache[p] = mc_bias_table(p)
        bias = precision_cache[p]
    raw_grid, bias_grid = bias
    raw = raw_estimates(registers)
    corrected = raw - np.interp(raw, raw_grid, bias_grid, left=bias_grid[0], right=0.0)
    corrected = np.where(raw <= 5 * m, corrected, raw)
    zeros = np.count_nonzero(registers == 0, axis=1)
    with np.errstate(divide="ignore"):
        lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    # HLL++ uses LC while it is reliable (zeros remain and LC is small); the
    # 2.5m crossover is the classic rule — HLL++'s per-p thresholds sit near
    # it and the MC bias table absorbs the residual difference
    use_lc = (zeros > 0) & (lc <= 2.5 * m)
    return np.where(use_lc, lc, corrected)


def estimate_cardinalities(registers: np.ndarray) -> np.ndarray:
    """Vectorized HLL size estimate over a batch: registers [N, m] → sizes [N].

    The host twin of the device estimator in ops/hll_ops.py: both use the same
    formula, so host and device sketches agree bit for bit on register state and
    within float tolerance on estimates.
    """
    registers = np.asarray(registers)
    n, m = registers.shape
    alpha = HyperLogLog._alpha(m)
    est = alpha * m * m / np.sum(np.exp2(-registers.astype(np.float64)), axis=1)
    zeros = np.count_nonzero(registers == 0, axis=1)
    small = est <= 2.5 * m
    with np.errstate(divide="ignore"):
        lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    use_lc = small & (zeros > 0)
    return np.where(use_lc, lc, est)
