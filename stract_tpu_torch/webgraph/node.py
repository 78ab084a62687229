"""Graph nodes (role of reference webgraph/node.rs: Node + NodeID u128 hash).

A node is a normalized host or URL string; its stable id is a u64 hash
(splitmix-finalized FNV). The reference uses u128; u64 keeps device arrays in
int-friendly dtypes — collision probability at 1e9 nodes is ~2.7e-2 per birthday
bound on 64 bits... per pair it's negligible for ranking purposes, and the
name→rank dictionary resolves exact strings anyway."""

from __future__ import annotations

from dataclasses import dataclass
from urllib.parse import urlparse

from ..utils.hashing import prehash


def normalize_host(host: str) -> str:
    h = host.strip().lower()
    if h.startswith("www."):
        h = h[4:]
    return h


@dataclass(frozen=True)
class Node:
    name: str

    @classmethod
    def from_url(cls, url: str) -> "Node":
        p = urlparse(url if "://" in url else f"https://{url}")
        path = p.path.rstrip("/")
        q = f"?{p.query}" if p.query else ""
        return cls(f"{normalize_host(p.netloc)}{path}{q}")

    def into_host(self) -> "Node":
        name = self.name.split("/")[0].split("?")[0]
        return Node(normalize_host(name))

    def id(self) -> int:
        return prehash(self.name)

    def __str__(self) -> str:
        return self.name
