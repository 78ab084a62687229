"""On-disk FIFO job queue — the port of stract_tpu/crawler/file_queue.py
(role of reference crawler/file_queue.rs: the crawl
plan is a persistent queue the coordinator pops from)."""

from __future__ import annotations

import os
import struct
import threading

import msgpack

_HEADER = struct.Struct(">I")


class FileQueue:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._data_path = path + ".q"
        self._pos_path = path + ".pos"
        if not os.path.exists(self._data_path):
            open(self._data_path, "wb").close()
        self._read_pos = 0
        if os.path.exists(self._pos_path):
            with open(self._pos_path) as fh:
                self._read_pos = int(fh.read() or 0)

    def push(self, item) -> None:
        blob = msgpack.packb(item, use_bin_type=True)
        with self._lock, open(self._data_path, "ab") as fh:
            fh.write(_HEADER.pack(len(blob)) + blob)

    def push_many(self, items) -> None:
        with self._lock, open(self._data_path, "ab") as fh:
            for item in items:
                blob = msgpack.packb(item, use_bin_type=True)
                fh.write(_HEADER.pack(len(blob)) + blob)

    def pop(self):
        with self._lock:
            size = os.path.getsize(self._data_path)
            if self._read_pos >= size:
                return None
            with open(self._data_path, "rb") as fh:
                fh.seek(self._read_pos)
                head = fh.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return None
                (n,) = _HEADER.unpack(head)
                blob = fh.read(n)
            self._read_pos += _HEADER.size + n
            with open(self._pos_path, "w") as fh:
                fh.write(str(self._read_pos))
            return msgpack.unpackb(blob, raw=False)

    def __len__(self) -> int:
        with self._lock:
            count = 0
            size = os.path.getsize(self._data_path)
            pos = self._read_pos
            with open(self._data_path, "rb") as fh:
                fh.seek(pos)
                while pos < size:
                    head = fh.read(_HEADER.size)
                    if len(head) < _HEADER.size:
                        break
                    (n,) = _HEADER.unpack(head)
                    fh.seek(n, 1)
                    pos += _HEADER.size + n
                    count += 1
            return count
