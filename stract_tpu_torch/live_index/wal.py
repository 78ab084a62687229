"""Write-ahead log — the port of stract_tpu/live_index/wal.py (role of
reference crates/simple-wal, used by the live index, live_index/index.rs:30).
Length-framed msgpack entries (a 4-byte big-endian length, then the entry),
replayable after a crash, truncatable after a commit; a torn tail is
ignored. The files are the JAX package's, byte for byte."""

from __future__ import annotations

import os
import struct

import msgpack

_HEADER = struct.Struct(">I")


class Wal:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")

    def write(self, entry) -> None:
        blob = msgpack.packb(entry, use_bin_type=True)
        self._fh.write(_HEADER.pack(len(blob)) + blob)
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def iter(self):
        self._fh.flush()
        with open(self.path, "rb") as fh:
            while True:
                head = fh.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                (n,) = _HEADER.unpack(head)
                blob = fh.read(n)
                if len(blob) < n:
                    break  # torn tail write — ignore
                yield msgpack.unpackb(blob, raw=False)

    def clear(self) -> None:
        self._fh.close()
        self._fh = open(self.path, "wb")

    def close(self) -> None:
        self._fh.close()
