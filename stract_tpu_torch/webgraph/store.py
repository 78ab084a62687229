"""Webgraph storage — CSR arrays on disk (replaces the reference's
tantivy-index-of-edge-documents design, webgraph/store.rs:49 + schema.rs:62-171).

TPU-first re-design: the edge store IS the compute layout. Nodes live in dense
rank space (u32); forward and reverse CSR adjacency arrays memory-map on host
and upload to HBM unchanged for centrality/shortest-path iterations. Strings
(node names, link labels) stay host-side in row stores.

Directory layout:
    meta.json            num_nodes, num_edges
    node_hashes.bin      u64[N] sorted (id → rank via searchsorted)
    node_names.bin/+off  names row store, rank-ordered
    out_offsets.bin      u64[N+1]   ┐ forward CSR (sorted by (from, to))
    out_targets.bin      u32[E]     │
    out_flags.bin        u32[E]     ┘
    in_offsets.bin       u64[N+1]   ┐ reverse CSR
    in_sources.bin       u32[E]     │
    in_flags.bin         u32[E]     ┘
    labels.bin/+off      per-forward-edge anchor text (zlib row store)
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from ..utils.hashing import fnv1a64_many, prehash
from .edge import Edge
from .node import Node


class WebgraphBuilder:
    def __init__(self, host_graph: bool = False):
        self.host_graph = host_graph
        self.edges: list[Edge] = []

    def insert(self, edge: Edge) -> None:
        if self.host_graph:
            edge = Edge(
                str(Node.from_url(edge.from_name).into_host()),
                str(Node.from_url(edge.to_name).into_host()),
                edge.rel_flags,
                edge.label,
            )
        self.edges.append(edge)

    def build(self, path: str) -> "Webgraph":
        os.makedirs(path, exist_ok=True)
        names = sorted({e.from_name for e in self.edges} | {e.to_name for e in self.edges})
        hashes = np.array([prehash(n) for n in names], dtype=np.uint64)
        order = np.argsort(hashes)
        hashes = hashes[order]
        names = [names[i] for i in order]
        rank_of = {h: i for i, h in enumerate(hashes.tolist())}
        n = len(names)

        frm = np.array([rank_of[prehash(e.from_name)] for e in self.edges], dtype=np.int64)
        to = np.array([rank_of[prehash(e.to_name)] for e in self.edges], dtype=np.int64)
        flags = np.array([e.rel_flags for e in self.edges], dtype=np.uint32)

        # dedup parallel edges (keep first label, OR the flags)
        if len(frm):
            key = frm * n + to
            uniq, first_idx, inv = np.unique(key, return_index=True, return_inverse=True)
            or_flags = np.zeros(len(uniq), dtype=np.uint32)
            np.bitwise_or.at(or_flags, inv, flags)
            frm, to = uniq // n, uniq % n
            flags = or_flags
            labels = [self.edges[i].label for i in first_idx]
        else:
            labels = []

        def csr(src, dst, fl):
            perm = np.lexsort((dst, src))
            s, d, f = src[perm], dst[perm], fl[perm]
            offsets = np.zeros(n + 1, dtype=np.uint64)
            counts = np.bincount(s, minlength=n)
            offsets[1:] = np.cumsum(counts)
            return offsets, d.astype(np.uint32), f, perm

        out_off, out_tgt, out_fl, fwd_perm = csr(frm, to, flags)
        in_off, in_src, in_fl, _ = csr(to, frm, flags)

        def w(name, arr):
            arr.tofile(os.path.join(path, name))

        w("node_hashes.bin", hashes)
        w("out_offsets.bin", out_off)
        w("out_targets.bin", out_tgt)
        w("out_flags.bin", out_fl)
        w("in_offsets.bin", in_off)
        w("in_sources.bin", in_src)
        w("in_flags.bin", in_fl)

        # names row store
        name_off = np.zeros(n + 1, dtype=np.uint64)
        with open(os.path.join(path, "node_names.bin"), "wb") as fh:
            pos = 0
            for i, nm in enumerate(names):
                b = nm.encode("utf-8")
                fh.write(b)
                pos += len(b)
                name_off[i + 1] = pos
        w("node_names_offsets.bin", name_off)

        # labels row store, ordered like the forward CSR
        lbl_off = np.zeros(len(labels) + 1, dtype=np.uint64)
        with open(os.path.join(path, "labels.bin"), "wb") as fh:
            pos = 0
            # fwd_perm maps sorted-pos → original edge index
            ordered = [labels[i] for i in fwd_perm] if len(labels) else []
            for i, lb in enumerate(ordered):
                b = zlib.compress(lb.encode("utf-8"), 1) if lb else b""
                fh.write(b)
                pos += len(b)
                lbl_off[i + 1] = pos
        w("labels_offsets.bin", lbl_off)

        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump({"num_nodes": n, "num_edges": int(len(frm)), "host_graph": self.host_graph}, fh)
        return Webgraph(path)


class Webgraph:
    """Memory-mapped CSR graph with the reference's query surface
    (webgraph/query/: forwardlinks, backlinks, links-between, id2node)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as fh:
            self.meta = json.load(fh)
        self.num_nodes = self.meta["num_nodes"]
        self.num_edges = self.meta["num_edges"]

        def mm(name, dtype):
            p = os.path.join(path, name)
            if os.path.getsize(p) == 0:
                return np.zeros(0, dtype=dtype)
            return np.memmap(p, dtype=dtype, mode="r")

        self.node_hashes = mm("node_hashes.bin", np.uint64)
        self.out_offsets = mm("out_offsets.bin", np.uint64)
        self.out_targets = mm("out_targets.bin", np.uint32)
        self.out_flags = mm("out_flags.bin", np.uint32)
        self.in_offsets = mm("in_offsets.bin", np.uint64)
        self.in_sources = mm("in_sources.bin", np.uint32)
        self.in_flags = mm("in_flags.bin", np.uint32)
        self.name_offsets = mm("node_names_offsets.bin", np.uint64)
        self._names_path = os.path.join(path, "node_names.bin")
        self._names_fh = None
        self.label_offsets = mm("labels_offsets.bin", np.uint64)
        self._labels_path = os.path.join(path, "labels.bin")

    # -- id ↔ rank ↔ name -------------------------------------------------------
    def rank_of(self, node) -> int | None:
        h = prehash(str(node)) if not isinstance(node, int) else node
        i = int(np.searchsorted(self.node_hashes, np.uint64(h)))
        if i < len(self.node_hashes) and self.node_hashes[i] == np.uint64(h):
            return i
        return None

    def name_of(self, rank: int) -> str:
        s, e = int(self.name_offsets[rank]), int(self.name_offsets[rank + 1])
        if self._names_fh is None:
            self._names_fh = open(self._names_path, "rb")
        # positional read — the handle is shared across server threads
        return os.pread(self._names_fh.fileno(), e - s, s).decode("utf-8")

    def names(self) -> list[str]:
        """Every node's name, rank-ordered, in one read of the row store."""
        off = np.asarray(self.name_offsets, dtype=np.int64)
        with open(self._names_path, "rb") as fh:
            data = fh.read()
        return [data[s:e].decode("utf-8") for s, e in zip(off[:-1].tolist(), off[1:].tolist())]

    def id2node(self, node_id: int) -> str | None:
        """(role of Id2NodeQuery)"""
        r = self.rank_of(node_id)
        return self.name_of(r) if r is not None else None

    # -- adjacency queries ---------------------------------------------------------
    def out_degree(self, rank: int) -> int:
        return int(self.out_offsets[rank + 1] - self.out_offsets[rank])

    def in_degree(self, rank: int) -> int:
        return int(self.in_offsets[rank + 1] - self.in_offsets[rank])

    def forwardlinks(self, node) -> list[tuple[int, int]]:
        """(role of ForwardlinksQuery) → [(target_rank, flags)]"""
        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return []
        s, e = int(self.out_offsets[r]), int(self.out_offsets[r + 1])
        return list(zip(self.out_targets[s:e].tolist(), self.out_flags[s:e].tolist()))

    def backlinks(self, node) -> list[tuple[int, int]]:
        """(role of HostBacklinksQuery) → [(source_rank, flags)]"""
        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return []
        s, e = int(self.in_offsets[r]), int(self.in_offsets[r + 1])
        return list(zip(self.in_sources[s:e].tolist(), self.in_flags[s:e].tolist()))

    def backlink_ranks(self, node) -> np.ndarray:
        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return np.zeros(0, dtype=np.int64)
        s, e = int(self.in_offsets[r]), int(self.in_offsets[r + 1])
        return np.asarray(self.in_sources[s:e], dtype=np.int64)

    def group_sketch(self, node, direction: str = "to", precision: int = 12) -> dict:
        """HLL-sketched grouping of one node's links (role of reference
        HostGroupSketchQuery + GroupSketchCollector, webgraph/query/
        group_by.rs:40 + query/collector/group_sketch.rs:33): for
        direction='to' (backlinks into `node`), group the linking nodes by
        their HOST and sketch the distinct linking nodes per host into a
        HyperLogLog (the reference uses HLL<4096> = precision 12).
        skip_self_links and deduplication match the reference defaults.
        → {host_name: HyperLogLog}."""
        from ..utils.hyperloglog import HyperLogLog
        from .node import Node as _N

        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return {}
        if direction == "to":
            others = {rank for rank, _ in self.backlinks(r)}
        else:
            others = {rank for rank, _ in self.forwardlinks(r)}
        others.discard(r)  # skip_self_links
        groups: dict = {}
        for o in others:
            name = self.name_of(o)
            host = str(_N(name).into_host())
            hll = groups.get(host)
            if hll is None:
                hll = groups[host] = HyperLogLog(precision)
            hll.add_u64(int(self.node_hashes[o]))
        return groups

    def group_exact(self, node, direction: str = "to", limit: int = 4096) -> dict:
        """Exact grouping of one node's links by the other endpoint's host
        (role of reference HostGroupQuery, webgraph/query/group_by.rs:188 —
        exact sets where the sketch variant trades memory for error).
        → {host_name: [node names]} (each group capped at `limit`)."""
        from .node import Node as _N

        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return {}
        if direction == "to":
            others = {rank for rank, _ in self.backlinks(r)}
        else:
            others = {rank for rank, _ in self.forwardlinks(r)}
        others.discard(r)
        groups: dict = {}
        for o in sorted(others):
            name = self.name_of(o)
            host = str(_N(name).into_host())
            members = groups.setdefault(host, [])
            if len(members) < limit:
                members.append(name)
        return groups

    def links_between(self, frm, to) -> list[Edge]:
        """(role of FullLinksBetweenQuery)"""
        rf = frm if isinstance(frm, int) else self.rank_of(frm)
        rt = to if isinstance(to, int) else self.rank_of(to)
        if rf is None or rt is None:
            return []
        s, e = int(self.out_offsets[rf]), int(self.out_offsets[rf + 1])
        out = []
        for i in range(s, e):
            if int(self.out_targets[i]) == rt:
                out.append(Edge(self.name_of(rf), self.name_of(rt), int(self.out_flags[i]),
                                self.edge_label(i)))
        return out

    def edge_label(self, edge_idx: int) -> str:
        if len(self.label_offsets) <= edge_idx + 1:
            return ""
        s, e = int(self.label_offsets[edge_idx]), int(self.label_offsets[edge_idx + 1])
        if s == e:
            return ""
        with open(self._labels_path, "rb") as fh:
            fh.seek(s)
            return zlib.decompress(fh.read(e - s)).decode("utf-8")

    def backlink_labels(self, node, limit: int = 128) -> list[str]:
        """Anchor texts of inbound links (feeds BacklinkText field + label groups)."""
        r = node if isinstance(node, int) else self.rank_of(node)
        if r is None:
            return []
        out = []
        for src, _ in self.backlinks(r)[:limit]:
            s, e = int(self.out_offsets[src]), int(self.out_offsets[src + 1])
            for i in range(s, e):
                if int(self.out_targets[i]) == r:
                    lb = self.edge_label(i)
                    if lb:
                        out.append(lb)
        return out

    def edges(self):
        """Iterate all edges as Edge objects (used by merge)."""
        for rank in range(self.num_nodes):
            s, e = int(self.out_offsets[rank]), int(self.out_offsets[rank + 1])
            frm = self.name_of(rank)
            for i in range(s, e):
                yield Edge(frm, self.name_of(int(self.out_targets[i])),
                           int(self.out_flags[i]), self.edge_label(i))

    # -- bulk arrays for device compute ------------------------------------------------
    def csr_arrays(self):
        """(out_offsets, out_targets, in_offsets, in_sources) as numpy views."""
        return (
            np.asarray(self.out_offsets, dtype=np.int64),
            np.asarray(self.out_targets, dtype=np.int32),
            np.asarray(self.in_offsets, dtype=np.int64),
            np.asarray(self.in_sources, dtype=np.int32),
        )


def write_graph(path: str, names: list, edge_from, edge_to, host_graph: bool = False) -> "Webgraph":
    """The files WebgraphBuilder.build writes for the edges (names[edge_from[i]]
    → names[edge_to[i]], no rel flags, no labels), vectorised for graphs of
    tens of millions of edges: the nodes are the names that occur in an edge,
    ranked by prehash; parallel edges are merged; both CSRs sorted as the
    builder sorts them."""
    os.makedirs(path, exist_ok=True)
    ef = np.asarray(edge_from, dtype=np.int64)
    et = np.asarray(edge_to, dtype=np.int64)
    present = np.zeros(int(max(ef.max(initial=-1), et.max(initial=-1))) + 1, dtype=bool)
    present[ef] = present[et] = True
    used = np.flatnonzero(present)
    encoded = [names[i].encode("utf-8") for i in used.tolist()]
    hashes = fnv1a64_many(encoded)
    order = np.argsort(hashes)
    hashes = hashes[order]
    n = len(used)
    rank = np.empty(int(used[-1]) + 1 if n else 0, dtype=np.int64)
    rank[used[order]] = np.arange(n)
    # edges as (from, to) keys, sorted and deduplicated: the out-CSR's order;
    # the same keys read (to, from) and sorted: the in-CSR's (a sort and a
    # neighbour compare: np.unique may hash first, tens of seconds at 20M)
    pairs = np.sort(rank[ef] * n + rank[et])
    pairs = pairs[np.concatenate([[True], pairs[1:] != pairs[:-1]])] if len(pairs) else pairs
    frm, to = pairs // n, pairs % n
    flags = np.zeros(len(frm), dtype=np.uint32)

    def offsets(rows):
        out = np.zeros(n + 1, dtype=np.uint64)
        out[1:] = np.cumsum(np.bincount(rows, minlength=n))
        return out

    out_off, out_tgt = offsets(frm), to.astype(np.uint32)
    in_off, in_src = offsets(to), (np.sort(to * n + frm) % n).astype(np.uint32)
    for name, arr in (("node_hashes.bin", hashes), ("out_offsets.bin", out_off),
                      ("out_targets.bin", out_tgt), ("out_flags.bin", flags),
                      ("in_offsets.bin", in_off), ("in_sources.bin", in_src),
                      ("in_flags.bin", flags)):
        arr.tofile(os.path.join(path, name))
    ranked = [encoded[i] for i in order.tolist()]
    name_off = np.zeros(n + 1, dtype=np.uint64)
    name_off[1:] = np.cumsum(np.fromiter(map(len, ranked), np.uint64, n))
    with open(os.path.join(path, "node_names.bin"), "wb") as fh:
        fh.write(b"".join(ranked))
    name_off.tofile(os.path.join(path, "node_names_offsets.bin"))
    open(os.path.join(path, "labels.bin"), "wb").close()
    np.zeros(len(frm) + 1, dtype=np.uint64).tofile(os.path.join(path, "labels_offsets.bin"))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump({"num_nodes": n, "num_edges": int(len(frm)), "host_graph": host_graph}, fh)
    return Webgraph(path)


def merge_graphs(paths: list, out_path: str, host_graph: bool = False) -> "Webgraph":
    """Merge several graphs into one (role of reference `webgraph merge`,
    entrypoint/webgraph.rs): union of nodes, edges deduped with OR'd flags."""
    b = WebgraphBuilder(host_graph=False)
    for p in paths:
        g = Webgraph(p)
        for e in g.edges():
            b.insert(e)
    return b.build(out_path)
