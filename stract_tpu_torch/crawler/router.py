"""Crawl router — the port of stract_tpu/crawler/router.py
(role of reference crawler/router.rs:70-81: workers ask the
router for jobs; the router round-robins across coordinators)."""

from __future__ import annotations

import itertools
import threading

from ..distributed.sonic import RemoteClient


class Router:
    def __init__(self, coordinator_addrs: list):
        self.clients = [RemoteClient(a) for a in coordinator_addrs]
        self._rr = itertools.cycle(range(len(self.clients)))
        self._lock = threading.Lock()

    # -- RPC method -------------------------------------------------------------
    def new_job(self, body=None):
        with self._lock:
            order = [next(self._rr) for _ in range(len(self.clients))]
        for i in order:
            job = self.clients[i].send("new_job", None)
            if job is not None:
                return job
        return None
