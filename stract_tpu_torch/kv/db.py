"""Immutable on-disk KV store for read-heavy workloads (role of reference
crates/speedy-kv: FST index + blob store, segments with bloom filters, O(k)
lookups — speedy-kv/src/lib.rs:17-39).

Design: a segment is (sorted u64 key-hashes, key blobs, msgpack value blobs,
bloom filter). Lookup = bloom check → binary search on the hash array (numpy
memmap searchsorted, the same access pattern an FST gives for fixed-size keys)
→ exact key verification. Writes accumulate in a memtable; commit() seals a new
segment; merge() compacts. Used for centrality stores, canonical-url index,
crawl bookkeeping."""

from __future__ import annotations

import json
import os
import uuid

import msgpack
import numpy as np

from ..utils.bloom import U64BloomFilter
from ..utils.hashing import fnv1a64, fnv1a64_many


class _Segment:
    def __init__(self, path: str):
        self.path = path

        def mm(name, dtype):
            p = os.path.join(path, name)
            if os.path.getsize(p) == 0:
                return np.zeros(0, dtype=dtype)
            return np.memmap(p, dtype=dtype, mode="r")

        self.hashes = mm("hashes.bin", np.uint64)
        self.key_offsets = mm("key_offsets.bin", np.uint64)
        self.val_offsets = mm("val_offsets.bin", np.uint64)
        with open(os.path.join(path, "bloom.bin"), "rb") as fh:
            self.bloom = U64BloomFilter.from_bytes(fh.read())
        self._keys_path = os.path.join(path, "keys.bin")
        self._vals_path = os.path.join(path, "vals.bin")
        self._keys_fh = None
        self._vals_fh = None

    def __len__(self):
        return len(self.hashes)

    @classmethod
    def write(cls, path: str, items: dict[bytes, bytes]) -> "_Segment":
        """The JAX package's segment, byte for byte (keys sorted by (hash,
        key)), with the hashing, sort and bloom filter vectorised."""
        os.makedirs(path, exist_ok=True)
        keys = list(items.keys())
        hashes = fnv1a64_many(keys)
        order = np.argsort(hashes, kind="stable")
        hashes = hashes[order]
        keys = [keys[i] for i in order]
        tied = np.nonzero(hashes[1:] == hashes[:-1])[0]
        if len(tied):  # equal hashes: order those runs by the key bytes
            for s in np.unique(np.searchsorted(hashes, hashes[tied])):
                e = int(np.searchsorted(hashes, hashes[s], side="right"))
                keys[s:e] = sorted(keys[s:e])
        bloom = U64BloomFilter(estimated_items=max(len(keys), 16))
        bloom.insert_many(hashes)
        vals = [items[k] for k in keys]
        key_off = np.zeros(len(keys) + 1, dtype=np.uint64)
        val_off = np.zeros(len(keys) + 1, dtype=np.uint64)
        key_off[1:] = np.cumsum(np.fromiter(map(len, keys), np.uint64, len(keys)))
        val_off[1:] = np.cumsum(np.fromiter(map(len, vals), np.uint64, len(vals)))
        with open(os.path.join(path, "keys.bin"), "wb") as kf:
            kf.write(b"".join(keys))
        with open(os.path.join(path, "vals.bin"), "wb") as vf:
            vf.write(b"".join(vals))
        hashes.tofile(os.path.join(path, "hashes.bin"))
        key_off.tofile(os.path.join(path, "key_offsets.bin"))
        val_off.tofile(os.path.join(path, "val_offsets.bin"))
        with open(os.path.join(path, "bloom.bin"), "wb") as fh:
            fh.write(bloom.to_bytes())
        return cls(path)

    def _key_at(self, i: int) -> bytes:
        s, e = int(self.key_offsets[i]), int(self.key_offsets[i + 1])
        if self._keys_fh is None:
            self._keys_fh = open(self._keys_path, "rb")
        self._keys_fh.seek(s)
        return self._keys_fh.read(e - s)

    def _val_at(self, i: int) -> bytes:
        s, e = int(self.val_offsets[i]), int(self.val_offsets[i + 1])
        if self._vals_fh is None:
            self._vals_fh = open(self._vals_path, "rb")
        self._vals_fh.seek(s)
        return self._vals_fh.read(e - s)

    def get(self, key: bytes) -> bytes | None:
        h = fnv1a64(key)
        if not self.bloom.contains(h):
            return None
        i = int(np.searchsorted(self.hashes, np.uint64(h)))
        while i < len(self.hashes) and self.hashes[i] == np.uint64(h):
            if self._key_at(i) == key:
                return self._val_at(i)
            i += 1
        return None

    def items(self):
        for i in range(len(self.hashes)):
            yield self._key_at(i), self._val_at(i)


class Db:
    """speedy_kv::Db equivalent. Values are arbitrary msgpack-able objects."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as fh:
                self.meta = json.load(fh)
        else:
            self.meta = {"segments": []}
        self.segments = [_Segment(os.path.join(path, s)) for s in self.meta["segments"]]
        self._memtable: dict[bytes, bytes] = {}

    @classmethod
    def open(cls, path: str) -> "Db":
        return cls(path)

    def insert(self, key: bytes, value) -> None:
        self._memtable[bytes(key)] = msgpack.packb(value, use_bin_type=True)

    def insert_raw(self, key: bytes, value: bytes) -> None:
        self._memtable[bytes(key)] = bytes(value)

    def commit(self) -> None:
        if not self._memtable:
            return
        name = f"seg-{uuid.uuid4().hex[:12]}"
        seg = _Segment.write(os.path.join(self.path, name), self._memtable)
        self.segments.append(seg)
        self.meta["segments"].append(name)
        with open(self._meta_path, "w") as fh:
            json.dump(self.meta, fh)
        self._memtable = {}

    def get(self, key: bytes):
        raw = self.get_raw(key)
        return None if raw is None else msgpack.unpackb(raw, raw=False)

    def get_raw(self, key: bytes) -> bytes | None:
        key = bytes(key)
        if key in self._memtable:
            return self._memtable[key]
        for seg in reversed(self.segments):
            v = seg.get(key)
            if v is not None:
                return v
        return None

    def __contains__(self, key: bytes) -> bool:
        return self.get_raw(key) is not None

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments) + len(self._memtable)

    def items(self):
        """Iterate (key, value) across segments (newest wins on duplicates)."""
        for k, v in self.items_raw():
            yield k, msgpack.unpackb(v, raw=False)

    def items_raw(self):
        """Iterate (key, raw value bytes) — pairs with insert_raw (the
        reference speedy-kv iterates raw bytes; typed decoding is a layer
        above, speedy_kv/mod.rs)."""
        seen = set()
        for k, v in self._memtable.items():
            seen.add(k)
            yield k, v
        for seg in reversed(self.segments):
            for k, v in seg.items():
                if k not in seen:
                    seen.add(k)
                    yield k, v

    def merge_segments(self) -> None:
        """Compact all segments into one (role of speedy-kv segment merge)."""
        import shutil

        all_items: dict[bytes, bytes] = {}
        for seg in self.segments:
            for k, v in seg.items():
                all_items[k] = v
        all_items.update(self._memtable)
        old = list(self.meta["segments"])
        name = f"seg-{uuid.uuid4().hex[:12]}"
        seg = _Segment.write(os.path.join(self.path, name), all_items)
        self.segments = [seg]
        self.meta["segments"] = [name]
        with open(self._meta_path, "w") as fh:
            json.dump(self.meta, fh)
        self._memtable = {}
        for s in old:
            shutil.rmtree(os.path.join(self.path, s), ignore_errors=True)
