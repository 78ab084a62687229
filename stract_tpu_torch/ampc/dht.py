"""Sharded in-memory DHT — the port's copy of stract_tpu/ampc/dht.py (role of
reference ampc/dht/: keys routed hash(key) % num_shards, no rebalancing —
dht/mod.rs:17-29; upsert functions U64Add/U64Min/F32Add/F64Add/KahanSumAdd/
HyperLogLog*Upsert — upsert.rs:93-141).

The reference replicates each shard with openraft; here a shard is one sonic
service (the AMPC jobs only need commutative upserts, so shard loss = key loss
— the same documented limitation as the reference, dht/mod.rs:24-28). A
raft group (ampc/raft.py) answers its own RPCs, not this client's: as in the
JAX package, a DhtClient cannot talk to one."""

from __future__ import annotations

import threading

import numpy as np

from ..distributed.sonic import RemoteClient, serve_in_thread
from ..utils.hashing import fnv1a64


# ---- upsert functions (commutative merges) ------------------------------------

def _u64_add(old, new):
    return (old or 0) + new


def _u64_min(old, new):
    return new if old is None else min(old, new)


def _f64_add(old, new):
    return (old or 0.0) + new


def _kahan_add(old, new):
    """old/new: [sum, compensation] pairs."""
    if old is None:
        old = [0.0, 0.0]
    s, c = old
    y = new[0] - c
    t = s + y
    return [t, (t - s) - y + new[1] * 0]


def _hll_max(old, new):
    """Register-wise max of HLL sketches (bytes)."""
    if old is None:
        return new
    a = np.frombuffer(old, dtype=np.uint8)
    b = np.frombuffer(new, dtype=np.uint8)
    return np.maximum(a, b).tobytes()


UPSERT_FNS = {
    "u64_add": _u64_add,
    "u64_min": _u64_min,
    "f32_add": _f64_add,
    "f64_add": _f64_add,
    "kahan_add": _kahan_add,
    "hll_max": _hll_max,
}


class upsert:
    U64_ADD = "u64_add"
    U64_MIN = "u64_min"
    F32_ADD = "f32_add"
    F64_ADD = "f64_add"
    KAHAN_ADD = "kahan_add"
    HLL_MAX = "hll_max"


class DhtShard:
    """One DHT shard: table → {key bytes → value} (role of dht/store.rs Table
    store + network server)."""

    def __init__(self):
        self.tables: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- RPC methods ------------------------------------------------------------
    def batch_get(self, body: dict):
        table = self.tables.get(body["table"], {})
        return [table.get(bytes(k)) for k in body["keys"]]

    def batch_set(self, body: dict):
        with self._lock:
            t = self.tables.setdefault(body["table"], {})
            for k, v in body["pairs"]:
                t[bytes(k)] = v
        return True

    def batch_upsert(self, body: dict):
        fn = UPSERT_FNS[body["fn"]]
        with self._lock:
            t = self.tables.setdefault(body["table"], {})
            for k, v in body["pairs"]:
                k = bytes(k)
                t[k] = fn(t.get(k), v)
        return True

    def scan(self, body: dict):
        """All (key, value) pairs of a table on this shard."""
        t = self.tables.get(body["table"], {})
        return list(t.items())

    def drop_table(self, body: dict):
        with self._lock:
            self.tables.pop(body["table"], None)
        return True

    def clone_table(self, body: dict):
        with self._lock:
            self.tables[body["to"]] = dict(self.tables.get(body["from"], {}))
        return True

    def num_keys(self, body: dict):
        return len(self.tables.get(body["table"], {}))


class DhtClient:
    """Shard-routing client (role of dht/client.rs): hash(key) % num_shards."""

    def __init__(self, shard_addrs: list):
        self.clients = [RemoteClient(a) for a in shard_addrs]
        self.n = len(self.clients)

    def _route(self, key: bytes) -> int:
        return fnv1a64(bytes(key)) % self.n

    def _group(self, pairs):
        groups: dict[int, list] = {}
        for k, v in pairs:
            groups.setdefault(self._route(k), []).append((k, v))
        return groups

    def batch_set(self, table: str, pairs) -> None:
        for sid, group in self._group(pairs).items():
            self.clients[sid].send("batch_set", {"table": table, "pairs": group})

    def batch_upsert(self, table: str, fn: str, pairs) -> None:
        for sid, group in self._group(pairs).items():
            self.clients[sid].send("batch_upsert", {"table": table, "fn": fn, "pairs": group})

    def batch_get(self, table: str, keys: list):
        by_shard: dict[int, list] = {}
        order: dict[int, list] = {}
        for i, k in enumerate(keys):
            sid = self._route(k)
            by_shard.setdefault(sid, []).append(k)
            order.setdefault(sid, []).append(i)
        out = [None] * len(keys)
        for sid, ks in by_shard.items():
            vals = self.clients[sid].send("batch_get", {"table": table, "keys": ks})
            for i, v in zip(order[sid], vals):
                out[i] = v
        return out

    def get(self, table: str, key: bytes):
        return self.batch_get(table, [key])[0]

    def set(self, table: str, key: bytes, value) -> None:
        self.batch_set(table, [(key, value)])

    def scan(self, table: str):
        out = []
        for c in self.clients:
            out.extend((bytes(k), v) for k, v in c.send("scan", {"table": table}))
        return out

    def drop_table(self, table: str) -> None:
        for c in self.clients:
            c.send("drop_table", {"table": table})

    def clone_table(self, src: str, dst: str) -> None:
        for c in self.clients:
            c.send("clone_table", {"from": src, "to": dst})

    def num_keys(self, table: str) -> int:
        return sum(c.send("num_keys", {"table": table}) for c in self.clients)


def start_dht(num_shards: int = 1):
    """In-process DHT cluster for tests/dev → (servers, DhtClient)."""
    servers = [serve_in_thread(DhtShard()) for _ in range(num_shards)]
    return servers, DhtClient([s.addr for s in servers])
