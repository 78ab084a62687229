"""Chunked remote file copy (role of reference distributed/remote_cp.rs: 1MB
chunks over sonic, used to clone live-index replica data,
live_index/search_server.rs:395-420)."""

from __future__ import annotations

import hashlib
import os

CHUNK_SIZE = 1 << 20  # 1MB (remote_cp.rs:25)


class RemoteCpService:
    """Mixin/standalone RPC service exposing a directory tree for cloning."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _safe(self, rel: str) -> str:
        p = os.path.abspath(os.path.join(self.root, rel))
        if not p.startswith(self.root):
            raise ValueError("path escape")
        return p

    # -- RPC methods ------------------------------------------------------------
    def list_files(self, body=None) -> list:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                full = os.path.join(dirpath, f)
                rel = os.path.relpath(full, self.root)
                out.append({"path": rel, "size": os.path.getsize(full)})
        return out

    def read_chunk(self, body: dict) -> dict:
        p = self._safe(body["path"])
        with open(p, "rb") as fh:
            fh.seek(body["offset"])
            data = fh.read(body.get("size", CHUNK_SIZE))
        return {"data": data, "eof": body["offset"] + len(data) >= os.path.getsize(p)}

    def file_digest(self, body: dict) -> str:
        h = hashlib.sha256()
        with open(self._safe(body["path"]), "rb") as fh:
            while True:
                b = fh.read(CHUNK_SIZE)
                if not b:
                    break
                h.update(b)
        return h.hexdigest()


def download_tree(client, dest_root: str) -> int:
    """Clone a RemoteCpService's tree → dest. Returns files copied. Skips files
    whose digest already matches (resumable replication)."""
    os.makedirs(dest_root, exist_ok=True)
    copied = 0
    for f in client.send("list_files", None):
        rel, size = f["path"], f["size"]
        dest = os.path.join(dest_root, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if os.path.exists(dest) and os.path.getsize(dest) == size:
            want = client.send("file_digest", {"path": rel})
            h = hashlib.sha256()
            with open(dest, "rb") as fh:
                while True:
                    b = fh.read(CHUNK_SIZE)
                    if not b:
                        break
                    h.update(b)
            if h.hexdigest() == want:
                continue
        with open(dest, "wb") as fh:
            offset = 0
            while True:
                chunk = client.send("read_chunk", {"path": rel, "offset": offset})
                fh.write(chunk["data"])
                offset += len(chunk["data"])
                if chunk["eof"]:
                    break
        copied += 1
    return copied
