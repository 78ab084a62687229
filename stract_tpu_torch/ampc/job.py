"""AMPC job abstractions — the port's copy of stract_tpu/ampc/job.py (role of
reference ampc/job.rs:31 Job, mapper.rs Mapper, setup/finisher traits —
ampc/mod.rs:17-43)."""

from __future__ import annotations


class Job:
    """A unit of work bound to a worker that owns the matching data shard.
    Must be msgpack-serializable via to_json/from_json."""

    def is_schedulable(self, worker_meta: dict) -> bool:
        """Can this job run on a worker with the given metadata (e.g. owns the
        right graph shard)?"""
        return True

    def to_json(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_json(cls, d: dict) -> "Job":
        raise NotImplementedError


class Mapper:
    """One stage of a round; workers execute map() over their job."""

    name = "mapper"

    def map(self, job, worker, dht) -> None:
        raise NotImplementedError


class Setup:
    """Round initialization hooks (reference Setup trait)."""

    def init_tables(self, dht) -> None:
        pass

    def setup_round(self, dht) -> None:
        pass


class Finisher:
    """Termination check per round (reference Finisher trait)."""

    def is_finished(self, dht) -> bool:
        raise NotImplementedError
