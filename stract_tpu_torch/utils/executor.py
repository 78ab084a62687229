"""Parallel/sequential execution dispatch (role of reference executor.rs).

The reference switches between rayon thread pools and sequential execution; here
we dispatch between a thread pool (IO-bound host work: WARC fetch, RPC fan-out)
and sequential execution. CPU-bound Python work stays sequential by default
(GIL); heavy numeric work is numpy/JAX which releases the GIL.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class Executor:
    def __init__(self, num_threads: int | None = None):
        self.num_threads = num_threads

    @classmethod
    def multi_thread(cls, num_threads: int | None = None) -> "Executor":
        return cls(num_threads=num_threads or 8)

    @classmethod
    def single_thread(cls) -> "Executor":
        return cls(num_threads=1)

    def map(self, fn: Callable[[T], R], items: Iterable[T]) -> list[R]:
        items = list(items)
        if self.num_threads == 1 or len(items) <= 1:
            return [fn(x) for x in items]
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            return list(pool.map(fn, items))
