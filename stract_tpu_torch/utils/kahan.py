"""Kahan compensated summation (role of reference kahan_sum.rs).

Used by harmonic-centrality accumulation where millions of tiny 1/r terms are
summed; a plain f64 sum drifts."""

from __future__ import annotations


class KahanSum:
    __slots__ = ("sum", "_c")

    def __init__(self, value: float = 0.0):
        self.sum = float(value)
        self._c = 0.0

    def add(self, x: float) -> "KahanSum":
        y = x - self._c
        t = self.sum + y
        self._c = (t - self.sum) - y
        self.sum = t
        return self

    def __iadd__(self, x: float) -> "KahanSum":
        return self.add(x)

    def value(self) -> float:
        return self.sum
