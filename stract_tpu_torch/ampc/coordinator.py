"""AMPC coordinator — the port's copy of stract_tpu/ampc/coordinator.py (role
of reference ampc/coordinator.rs:151-213 Coordinator::run: round loop until
the finisher says done; per round, every mapper stage schedules jobs on idle
compatible workers and RESCHEDULES a worker's job elsewhere when its RPC
fails mid-round — the elastic-recovery behavior, coordinator.rs:174-206).
A stage runs its jobs one after another, so the DHT sees every round's
upserts in one order."""

from __future__ import annotations

import threading

from ..distributed.sonic import RemoteClient, RpcError
from .dht_conn import DhtConn


class WorkerHandle:
    def __init__(self, addr):
        self.addr = tuple(addr)
        self.client = RemoteClient(addr, retries=1)
        self.meta = None
        self.alive = True

    def fetch_meta(self):
        self.meta = self.client.send("get_meta", None)
        return self.meta


class Coordinator:
    def __init__(self, setup, mappers: list, worker_addrs: list):
        self.setup = setup
        self.mappers = mappers  # ordered stage list
        self.workers = [WorkerHandle(a) for a in worker_addrs]
        for w in self.workers:
            try:
                w.fetch_meta()
            except RpcError:
                w.alive = False  # dead at startup — jobs reschedule elsewhere

    def _run_stage(self, mapper_name: str, jobs: list, dht: DhtConn) -> None:
        """Schedule all jobs for one mapper stage; reschedule on worker death."""
        pending = list(jobs)
        lock = threading.Lock()
        errors = []

        def run_on(worker: WorkerHandle, job) -> bool:
            try:
                worker.client.send(
                    "run_mapper",
                    {"mapper": mapper_name, "job": job.to_json(), "dht": dht.serializable()},
                )
                return True
            except RpcError:
                worker.alive = False
                return False

        while pending:
            with lock:
                job = pending.pop(0)
            candidates = [w for w in self.workers if w.alive and job.is_schedulable(w.meta)]
            if not candidates:
                raise RpcError(f"no live worker can run job {job.to_json()}")
            done = False
            for w in candidates:
                if run_on(w, job):
                    done = True
                    break
            if not done:
                # all candidates died — refresh list and retry once
                for w in self.workers:
                    try:
                        w.fetch_meta()
                        w.alive = True
                    except RpcError:
                        w.alive = False
                if not any(w.alive and job.is_schedulable(w.meta) for w in self.workers):
                    raise RpcError("cluster lost all compatible workers")
                with lock:
                    pending.insert(0, job)

    def run(self, jobs: list, dht: DhtConn, finisher, max_rounds: int = 1000) -> int:
        """Round loop (reference :151-213). Returns rounds executed."""
        self.setup.init_tables(dht)
        rounds = 0
        while rounds < max_rounds and not finisher.is_finished(dht):
            self.setup.setup_round(dht)
            for mapper in self.mappers:
                self._run_stage(mapper.name, jobs, dht)
            dht.next_round()
            rounds += 1
        return rounds
