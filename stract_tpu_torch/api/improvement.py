"""Click improvement logging — the port's copy of stract_tpu/api/improvement.py
(role of reference improvement.rs:20-92 +
api/improvement.rs: click events behind a LeakyQueue; the reference drains
them to ScyllaDB for LTR training data, the port keeps them in memory)."""

from __future__ import annotations

import queue
import time


class LeakyQueue:
    """Bounded queue that drops oldest events under pressure."""

    def __init__(self, maxsize: int = 10_000):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)

    def push(self, item) -> None:
        try:
            self.q.put_nowait(item)
        except queue.Full:
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            try:
                self.q.put_nowait(item)
            except queue.Full:
                pass

    def drain(self) -> list:
        out = []
        while True:
            try:
                out.append(self.q.get_nowait())
            except queue.Empty:
                return out


class ImprovementLog:
    """The served queries and their clicks, held in a LeakyQueue. The JAX
    package's log drains to a file only when given a path, which its
    coordinator never gives (ROADMAP queue 3), so the port keeps the queue
    alone: the drain comes with the wiring of improvement_log_path."""

    def __init__(self):
        self.queue = LeakyQueue()

    def log(self, qid: str, click: str) -> None:
        self.queue.push({"qid": qid, "click": click, "ts": time.time()})

    def store(self, query: str, urls: list) -> str:
        """Store a served query + result URLs, returning its qid (role of
        reference api/improvement.rs:64-80 StoreQuery → ScyllaDB)."""
        import uuid

        qid = uuid.uuid4().hex
        self.queue.push({"qid": qid, "query": query, "urls": urls, "ts": time.time()})
        return qid
