"""Prometheus text-exposition metrics (role of reference metrics.rs:36-80).

Hand-rolled counters/gauges/histograms with a registry that renders the
Prometheus text format for the /metrics endpoint (api/mod.rs:266-268 in the
reference)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def get(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def get(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket latency histogram (seconds)."""

    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._total += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.start)


@dataclass
class _Entry:
    name: str
    help: str
    metric: object
    labels: dict = field(default_factory=dict)


class PrometheusRegistry:
    def __init__(self):
        self._entries: list[_Entry] = []
        self._lock = threading.Lock()

    def register(self, name: str, help: str, metric, labels: dict | None = None):
        with self._lock:
            self._entries.append(_Entry(name, help, metric, labels or {}))
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self.register(name, help, Counter(), labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self.register(name, help, Gauge(), labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self.register(name, help, Histogram(), labels)

    @staticmethod
    def _fmt_labels(labels: dict) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    def render(self) -> str:
        lines = []
        seen_help = set()
        with self._lock:
            for e in self._entries:
                if e.name not in seen_help:
                    seen_help.add(e.name)
                    kind = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}[type(e.metric)]
                    if e.help:
                        lines.append(f"# HELP {e.name} {e.help}")
                    lines.append(f"# TYPE {e.name} {kind}")
                lbl = self._fmt_labels(e.labels)
                m = e.metric
                if isinstance(m, Counter):
                    lines.append(f"{e.name}{lbl} {m.get()}")
                elif isinstance(m, Gauge):
                    lines.append(f"{e.name}{lbl} {m.get()}")
                elif isinstance(m, Histogram):
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum += m._counts[i]
                        lines.append(f'{e.name}_bucket{{le="{b}"}} {cum}')
                    cum += m._counts[-1]
                    lines.append(f'{e.name}_bucket{{le="+Inf"}} {cum}')
                    lines.append(f"{e.name}_sum{lbl} {m._sum}")
                    lines.append(f"{e.name}_count{lbl} {m._total}")
        return "\n".join(lines) + "\n"
