"""AMPC worker — the port's copy of stract_tpu/ampc/worker.py (role of
reference ampc/worker.rs:28-80 Worker/RemoteWorker): hosts a data shard
(e.g. a webgraph partition) and executes mapper stages sent by the
coordinator."""

from __future__ import annotations

from ..distributed.sonic import serve_in_thread
from .dht_conn import DhtConn


class Worker:
    """Subclass with mapper implementations; `meta()` advertises shard ownership."""

    mappers: dict = {}  # name → Mapper instance (set by subclass)
    jobs: dict = {}     # job deserializers: kind → from_json

    def meta(self) -> dict:
        return {}

    # -- RPC methods -------------------------------------------------------------
    def get_meta(self, body=None) -> dict:
        return self.meta()

    def run_mapper(self, body: dict):
        mapper = self.mappers[body["mapper"]]
        job_cls = self.jobs[body["job"]["kind"]]
        job = job_cls.from_json(body["job"])
        dht = DhtConn.from_serializable(body["dht"])
        mapper.map(job, self, dht)
        return True


def start_worker(worker: Worker):
    return serve_in_thread(worker)
