"""LiveIndex — the freshness tier, the port of stract_tpu/live_index/index.py
(role of reference live_index/mod.rs:26-30 + index.rs: WAL + TTL'd
segments, 60-day TTL, hourly compaction by date, 10-minute autocommit), over
the port's InvertedIndex on an explicit device.

Docs are WAL'd before indexing (crash replay), flushed into small segments,
compacted hourly (segments of the same hour merge), and pruned wholesale
after the TTL. Its directory (index/, wal/live.wal, live_meta.json) is the
JAX package's: either package opens what the other wrote.

Concurrency contract with serving: the index's segment list and its device
copies (`index._device`, keyed by segment identity) are only ever REBOUND,
never mutated, so a search that snapshotted the old list keeps a consistent
view for its whole pass, and the old device copies are freed when the last
search holding them returns. Segment files open lazily, so dropped segment
directories are deleted DROP_GRACE_SECONDS later."""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid

from ..device import resolve_device
from ..index.inverted import InvertedIndex
from ..index.merge import merge_segments
from ..index.segment import Segment
from .wal import Wal

TTL_SECONDS = 60 * 24 * 3600        # 60 days (live_index/mod.rs:26-30)
COMPACT_INTERVAL = 3600             # 1 hour
AUTOCOMMIT_INTERVAL = 600           # 10 minutes
DROP_GRACE_SECONDS = 300            # dropped segment dirs outlive in-flight searches


class LiveIndex:
    def __init__(self, path: str, device=None, clock=time.time):
        """device: where searches run ("cuda" when None; "cuda" without a
        card raises); clock: the time source of commits, compaction buckets
        and the TTL."""
        self.path = path
        self.clock = clock
        self.device = resolve_device("cuda" if device is None else device)
        os.makedirs(path, exist_ok=True)
        self.index = InvertedIndex(os.path.join(path, "index"), self.device)
        self.wal = Wal(os.path.join(path, "wal", "live.wal"))
        self._meta_path = os.path.join(path, "live_meta.json")
        self.meta = {"segment_times": {}, "last_commit": 0.0, "last_compact": 0.0}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as fh:
                self.meta.update(json.load(fh))
        # (deadline, dir) of segment dirs unpublished but not yet deleted
        self._pending_delete: list[tuple[float, str]] = []
        self._reap_orphans()
        self._replay_wal()

    def _reap_orphans(self) -> None:
        """Startup only: delete segment dirs on disk that the index meta does
        not publish (a crash between a merge or flush and its publish, or
        before a deferred delete ran)."""
        seg_root = os.path.join(self.index.path, "segments")
        if not os.path.isdir(seg_root):
            return
        live = set(self.index.meta["segments"])
        for name in os.listdir(seg_root):
            if name not in live:
                shutil.rmtree(os.path.join(seg_root, name), ignore_errors=True)

    def _defer_delete(self, name: str) -> None:
        self._pending_delete.append(
            (self.clock() + DROP_GRACE_SECONDS, os.path.join(self.index.path, "segments", name))
        )

    def _reap_dropped(self) -> None:
        now = self.clock()
        still = []
        for deadline, path in self._pending_delete:
            if now >= deadline:
                shutil.rmtree(path, ignore_errors=True)
            else:
                still.append((deadline, path))
        self._pending_delete = still

    def _save_meta(self):
        with open(self._meta_path, "w") as fh:
            json.dump(self.meta, fh)

    def _replay_wal(self):
        pending = list(self.wal.iter())
        if pending:
            for doc in pending:
                self.index.insert(doc)
            self._commit_segment()

    # -- writes ----------------------------------------------------------------
    def insert(self, doc: dict) -> None:
        self.wal.write(doc)
        self.index.insert(doc)

    def insert_batch(self, docs: list[dict]) -> None:
        for d in docs:
            self.insert(d)

    def _commit_segment(self) -> None:
        before = set(self.index.meta["segments"])
        self.index.commit()
        for name in self.index.meta["segments"]:
            if name not in before:
                self.meta["segment_times"][name] = self.clock()
        self.wal.clear()
        self.meta["last_commit"] = self.clock()
        self._save_meta()

    def commit(self) -> None:
        self._commit_segment()

    # -- background maintenance (role of the reference's event loop) -------------
    def tick(self) -> None:
        now = self.clock()
        if now - self.meta["last_commit"] >= AUTOCOMMIT_INTERVAL:
            self.commit()
        if now - self.meta["last_compact"] >= COMPACT_INTERVAL:
            self.compact()
            self.meta["last_compact"] = now
            self._save_meta()
        self.prune()
        self._reap_dropped()

    def prune(self) -> None:
        """Drop segments older than the TTL (wholesale, like the reference)."""
        now = self.clock()
        keep, drop = [], []
        for name in self.index.meta["segments"]:
            t = self.meta["segment_times"].get(name, now)
            (drop if now - t > TTL_SECONDS else keep).append(name)
        if not drop:
            return
        self.index.segments = [
            s for s, name in zip(self.index.segments, self.index.meta["segments"]) if name in keep
        ]
        for name in drop:
            self._defer_delete(name)
            self.meta["segment_times"].pop(name, None)
        self.index.meta["segments"] = keep
        self.index._save_meta()
        self.index._device = {}  # rebind (serving threads may hold the old dict)
        self._save_meta()

    def compact(self) -> None:
        """Merge segments that fall in the same hour bucket (reference hourly
        compaction by date), on copies published by single rebinds."""
        buckets: dict[int, list] = {}
        for name in self.index.meta["segments"]:
            t = self.meta["segment_times"].get(name, self.clock())
            buckets.setdefault(int(t // 3600), []).append(name)
        new_names = list(self.index.meta["segments"])
        new_segments = list(self.index.segments)
        dropped: list[str] = []
        changed = False
        for hour, names in buckets.items():
            if len(names) < 2:
                continue
            changed = True
            segs = [new_segments[new_names.index(n)] for n in names]
            new_name = f"seg-{uuid.uuid4().hex[:12]}"
            merge_segments(segs, os.path.join(self.index.path, "segments", new_name))
            for n in names:
                idx = new_names.index(n)
                new_names.pop(idx)
                new_segments.pop(idx)
                dropped.append(n)
                self.meta["segment_times"].pop(n, None)
            new_segments.append(Segment(os.path.join(self.index.path, "segments", new_name)))
            new_names.append(new_name)
            self.meta["segment_times"][new_name] = hour * 3600.0
        if changed:
            self.index.segments = new_segments
            self.index.meta["segments"] = new_names
            self.index._save_meta()
            self.index._device = {}
            for n in dropped:
                self._defer_delete(n)
            self._save_meta()
