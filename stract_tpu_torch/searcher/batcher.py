"""Request micro-batchers (the port of stract_tpu/searcher/batcher.py).

PipelinedBatcher serves the HTTP route: concurrent searches queue; worker 1
drains up to `max_batch` every `window_ms` and runs phase 1 (parse + the
batched device search), worker 2 runs phase 2 (merge, page signals,
retrieve, snippets) and resolves the callers' futures. Batch k's host tail
overlaps batch k+1's device work.

MicroBatcher / QueryBatcher serve a shard server: concurrent `search` RPCs
queue, one worker drains a batch and runs the whole shard-side flow batched
(LocalSearcher.search_initial_many), so concurrent queries share one set of
launches."""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

# a caller waits at most this long for its result
SUBMIT_TIMEOUT_S = 300.0


class MicroBatcher:
    """Generic request micro-batcher: callers block on submit(), one worker
    thread drains up to `max_batch` items per `window_ms` and runs
    `process_many(items) → results`."""

    def __init__(self, process_many, max_batch: int = 64, window_ms: float = 4.0):
        self.process_many = process_many
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item):
        fut: Future = Future()
        self._q.put((item, fut))
        return fut.result(timeout=SUBMIT_TIMEOUT_S)

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self.process_many([item for item, _ in batch])
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — propagate to all callers
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)


class PipelinedBatcher:
    """Two-stage micro-batcher: worker 1 collects a batch and runs
    `phase1(items) → mid` (the device-heavy half; waiting on the card
    releases the GIL); worker 2 runs `phase2(mid) → results` (the host tail:
    merge/snippets/rerank) and resolves futures. Batch k's host tail overlaps
    batch k+1's device wait."""

    def __init__(self, phase1, phase2, max_batch: int = 64, window_ms: float = 4.0,
                 depth: int = 2):
        self.phase1 = phase1
        self.phase2 = phase2
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._mid: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._t1 = threading.Thread(target=self._loop1, daemon=True)
        self._t2 = threading.Thread(target=self._loop2, daemon=True)
        self._t1.start()
        self._t2.start()

    def submit(self, item):
        fut: Future = Future()
        self._q.put((item, fut))
        return fut.result(timeout=SUBMIT_TIMEOUT_S)

    def _loop1(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                mid = self.phase1([item for item, _ in batch])
            except Exception as e:  # noqa: BLE001 — propagate to all callers
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # bounded: backpressure on the tail — but never block forever, or
            # stop() with a full mid-queue (phase-2 worker dead) strands every
            # queued caller until SUBMIT_TIMEOUT_S
            delivered = False
            while not self._stop.is_set():
                try:
                    self._mid.put((batch, mid), timeout=0.2)
                    delivered = True
                    break
                except queue.Full:
                    continue
            if not delivered:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(RuntimeError("batcher stopped during phase 1"))

    def _loop2(self):
        while not self._stop.is_set():
            try:
                batch, mid = self._mid.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                results = self.phase2(mid)
                for (_, fut), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def stop(self):
        self._stop.set()
        self._t1.join(timeout=2)
        self._t2.join(timeout=2)
        # fail anything still queued so callers don't hang until SUBMIT_TIMEOUT_S
        err = RuntimeError("batcher stopped")
        while True:
            try:
                _, fut = self._q.get_nowait()
                if not fut.done():
                    fut.set_exception(err)
            except queue.Empty:
                break
        while True:
            try:
                batch, _ = self._mid.get_nowait()
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(err)
            except queue.Empty:
                break


class QueryBatcher(MicroBatcher):
    """Shard-side micro-batcher over LocalSearcher.search_initial_many."""

    def __init__(self, searcher, max_batch: int = 64, window_ms: float = 4.0,
                 top_k: int = 300):
        self.searcher = searcher
        self.top_k = top_k
        super().__init__(self._process, max_batch=max_batch, window_ms=window_ms)

    def search_initial(self, sq, max_candidates: int | None = None):
        """Blocking: enqueue + wait → (candidates, count)."""
        cands, count = self.submit(sq)
        mc = max_candidates or self.top_k
        return cands[:mc], count

    def _process(self, sqs: list) -> list:
        return self.searcher.search_initial_many(sqs, self.top_k)
