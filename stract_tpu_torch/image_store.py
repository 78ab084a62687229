"""Entity image store — the port's copy of stract_tpu/image_store.py (role
of reference image_store.rs / EntityImageStore: content-addressed blobs on
disk with a kv index, serving resized entity images for the sidebar). The
layout on disk is the JAX package's:
blobs/<sha[:2]>/<sha> beside the kv index (kv/db.py), so a store written by
either package reads in the other."""

from __future__ import annotations

import hashlib
import os

from .kv import Db


class ImageStore:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.join(path, "blobs"), exist_ok=True)
        self.index = Db.open(os.path.join(path, "index"))

    def insert(self, key: str, image_bytes: bytes) -> str:
        return self.insert_many({key: image_bytes})[0]

    def insert_many(self, items: dict) -> list:
        """insert() of each (key, image bytes) with one commit of the kv
        index (insert commits a kv segment per call) → the digests."""
        digests = []
        for key, image_bytes in items.items():
            digest = hashlib.sha256(image_bytes).hexdigest()
            blob_path = os.path.join(self.path, "blobs", digest[:2], digest)
            os.makedirs(os.path.dirname(blob_path), exist_ok=True)
            if not os.path.exists(blob_path):
                with open(blob_path, "wb") as fh:
                    fh.write(image_bytes)
            self.index.insert(key.encode(), digest)
            digests.append(digest)
        self.index.commit()
        return digests

    def get(self, key: str) -> bytes | None:
        digest = self.index.get(key.encode())
        if digest is None:
            return None
        blob_path = os.path.join(self.path, "blobs", digest[:2], digest)
        if not os.path.exists(blob_path):
            return None
        with open(blob_path, "rb") as fh:
            return fh.read()

    def __contains__(self, key: str) -> bool:
        return self.index.get(key.encode()) is not None
