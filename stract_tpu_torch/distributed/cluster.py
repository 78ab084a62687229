"""Cluster membership via UDP gossip (role of reference distributed/cluster.rs:45
chitchat scuttlebutt: 1s gossip interval, φ-accrual failure detection,
`Service` key per node declaring role + shard — member.rs:99-136).

Implementation: each node keeps a state table
    member_id → {service, gossip_addr, heartbeat, wall}
bumps its own heartbeat every interval, gossips its full table to k random
peers, and merges received tables by max heartbeat. A member is alive if its
heartbeat advanced within `failure_timeout` (simplified φ-accrual: constant
threshold instead of an adaptive phi; same observable behavior for tests)."""

from __future__ import annotations

import json
import random
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field

GOSSIP_INTERVAL = 1.0     # cluster.rs:27
FAILURE_TIMEOUT = 10.0
FANOUT = 3


@dataclass(frozen=True)
class Service:
    """Role descriptor: kind + host (RPC addr) + shard/extra."""

    kind: str                  # 'api' | 'search-server' | 'webgraph' | 'live-index' | 'dht' | ...
    host: tuple | None = None  # RPC (ip, port)
    shard: int = 0
    extra: tuple = ()

    def to_json(self):
        return {"kind": self.kind, "host": list(self.host) if self.host else None,
                "shard": self.shard, "extra": list(self.extra)}

    @classmethod
    def from_json(cls, d):
        return cls(d["kind"], tuple(d["host"]) if d.get("host") else None,
                   d.get("shard", 0), tuple(d.get("extra", ())))


@dataclass
class Member:
    id: str
    service: Service
    gossip_addr: tuple
    heartbeat: int = 0
    last_seen: float = field(default_factory=time.monotonic)

    def is_alive(self, timeout: float = FAILURE_TIMEOUT) -> bool:
        return time.monotonic() - self.last_seen < timeout


class Cluster:
    def __init__(self, service: Service, gossip_addr=("127.0.0.1", 0), seeds=(), member_id=None,
                 interval: float = GOSSIP_INTERVAL, failure_timeout: float = FAILURE_TIMEOUT):
        self.id = member_id or uuid.uuid4().hex[:16]
        self.service = service
        self.interval = interval
        self.failure_timeout = failure_timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(tuple(gossip_addr))
        self._sock.settimeout(0.2)
        self.gossip_addr = self._sock.getsockname()
        self.seeds = [tuple(s) for s in seeds]
        self._members: dict[str, Member] = {
            self.id: Member(self.id, service, self.gossip_addr)
        }
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._gossip_loop, daemon=True),
            threading.Thread(target=self._recv_loop, daemon=True),
        ]

    # -- lifecycle --------------------------------------------------------------
    @classmethod
    def join(cls, service: Service, gossip_addr=("127.0.0.1", 0), seeds=(), **kw) -> "Cluster":
        c = cls(service, gossip_addr, seeds, **kw)
        for t in c._threads:
            t.start()
        return c

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._sock.close()

    # -- state ---------------------------------------------------------------------
    def _digest(self) -> bytes:
        with self._lock:
            state = {
                mid: {
                    "service": m.service.to_json(),
                    "gossip_addr": list(m.gossip_addr),
                    "heartbeat": m.heartbeat,
                }
                for mid, m in self._members.items()
                if m.is_alive(self.failure_timeout) or mid == self.id
            }
        return json.dumps(state).encode()

    def _merge(self, state: dict):
        now = time.monotonic()
        with self._lock:
            for mid, info in state.items():
                if mid == self.id:
                    continue
                hb = info["heartbeat"]
                m = self._members.get(mid)
                if m is None:
                    self._members[mid] = Member(
                        mid, Service.from_json(info["service"]), tuple(info["gossip_addr"]), hb, now
                    )
                elif hb > m.heartbeat:
                    m.heartbeat = hb
                    m.last_seen = now

    # -- loops ------------------------------------------------------------------------
    def _gossip_loop(self):
        while not self._stop.is_set():
            with self._lock:
                me = self._members[self.id]
                me.heartbeat += 1
                me.last_seen = time.monotonic()
                peers = [m.gossip_addr for mid, m in self._members.items() if mid != self.id]
            targets = list(self.seeds) + peers
            random.shuffle(targets)
            payload = self._digest()
            for addr in targets[:FANOUT] or self.seeds:
                try:
                    self._sock.sendto(payload, tuple(addr))
                except OSError:
                    pass
            self._stop.wait(self.interval)

    def _recv_loop(self):
        while not self._stop.is_set():
            try:
                data, addr = self._sock.recvfrom(1 << 20)
                self._merge(json.loads(data.decode()))
            except socket.timeout:
                continue
            except (OSError, ValueError):
                continue

    # -- queries -------------------------------------------------------------------------
    def members(self, alive_only: bool = True) -> list[Member]:
        with self._lock:
            ms = list(self._members.values())
        if alive_only:
            ms = [m for m in ms if m.id == self.id or m.is_alive(self.failure_timeout)]
        return ms

    def services(self, kind: str | None = None) -> list[Service]:
        return [m.service for m in self.members() if kind is None or m.service.kind == kind]

    def await_member(self, predicate, timeout: float = 10.0) -> Member | None:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            for m in self.members():
                if predicate(m):
                    return m
            time.sleep(0.05)
        return None
