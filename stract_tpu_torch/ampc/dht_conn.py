"""Double-buffered DHT tables per AMPC round — the port's copy of
stract_tpu/ampc/dht_conn.py (role of reference ampc/dht_conn.rs:387 DhtConn{prev,next} + :173 typed DhtTable batch ops).

Each round reads `prev` and writes `next`; next_round() swaps them — the
bulk-synchronous barrier of the AMPC model."""

from __future__ import annotations

from .dht import DhtClient


class DhtTable:
    def __init__(self, client: DhtClient, name: str):
        self.client = client
        self.name = name

    def get(self, key: bytes):
        return self.client.get(self.name, key)

    def batch_get(self, keys):
        return self.client.batch_get(self.name, keys)

    def set(self, key: bytes, value):
        self.client.set(self.name, key, value)

    def batch_set(self, pairs):
        self.client.batch_set(self.name, pairs)

    def batch_upsert(self, fn: str, pairs):
        self.client.batch_upsert(self.name, fn, pairs)

    def scan(self):
        return self.client.scan(self.name)

    def num_keys(self) -> int:
        return self.client.num_keys(self.name)


class DhtConn:
    def __init__(self, client: DhtClient, tables: list[str]):
        self.client = client
        self.table_names = list(tables)
        self.round = 0

    def _table(self, name: str, gen: int) -> DhtTable:
        return DhtTable(self.client, f"{name}@{gen}")

    def prev(self, name: str) -> DhtTable:
        return self._table(name, self.round)

    def next(self, name: str) -> DhtTable:
        return self._table(name, self.round + 1)

    def next_round(self) -> None:
        """Swap: next becomes prev; old prev tables are dropped
        (cleanup_prev_tables/next_round, dht_conn.rs:387-400)."""
        for name in self.table_names:
            self.client.drop_table(f"{name}@{self.round}")
        self.round += 1

    def seed_next_from_prev(self) -> None:
        """Copy prev tables into next (rounds that accumulate in place)."""
        for name in self.table_names:
            self.client.clone_table(f"{name}@{self.round}", f"{name}@{self.round + 1}")

    def serializable(self) -> dict:
        """Wire form handed to workers (they rebuild a DhtConn)."""
        return {"round": self.round, "tables": self.table_names,
                "shards": [c.addr for c in self.client.clients]}

    @classmethod
    def from_serializable(cls, d: dict) -> "DhtConn":
        conn = cls(DhtClient([tuple(a) for a in d["shards"]]), d["tables"])
        conn.round = d["round"]
        return conn
