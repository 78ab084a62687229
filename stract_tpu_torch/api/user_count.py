"""Daily/monthly active user counters via HyperLogLog — the port's copy of
stract_tpu/api/user_count.py (role of reference
api/user_count.rs: hyperloglog user sets backing DAU/MAU metrics)."""

from __future__ import annotations

import time

from ..utils.hashing import prehash
from ..utils.hyperloglog import HyperLogLog


class UserCount:
    def __init__(self, precision: int = 12):
        self.precision = precision
        self._day: tuple[int, HyperLogLog] | None = None
        self._month: tuple[int, HyperLogLog] | None = None

    def _bucketed(self, current, bucket: int) -> HyperLogLog:
        if current is None or current[0] != bucket:
            current = (bucket, HyperLogLog(self.precision))
        return current

    def observe(self, user_key: str, now: float | None = None) -> None:
        now = now or time.time()
        day = int(now // 86400)
        month = int(now // (30 * 86400))
        self._day = self._bucketed(self._day, day)
        self._month = self._bucketed(self._month, month)
        h = prehash(user_key or "anon")
        self._day[1].add_u64(h)
        self._month[1].add_u64(h)

    def daily_active(self) -> int:
        return len(self._day[1]) if self._day else 0

    def monthly_active(self) -> int:
        return len(self._month[1]) if self._month else 0
