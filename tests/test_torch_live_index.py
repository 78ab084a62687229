"""The port's freshness tier (stract_tpu_torch/live_index/wal.py, index.py,
entrypoint/live_index.py, the live client of searcher/distributed.py and
`main.py live-index serve`) against the JAX package's, on the CPU.

Tolerance: the WAL, the live directory (live_meta.json, index_meta.json,
every segment, the WAL) byte for byte after every operation of the seeded
sequences; search scores within rtol / atol 1e-3 (test_torch_slice.py's),
the top 10 compared as sets at ties on the cut; wire results of one
server read through either package's coordinator exactly equal. The clock
is injected and uuid4 pinned in both packages (a sequence for each, as
tests/test_torch_indexer.py pins them), so both name their segments alike.
Every wait on a server or process is bounded by its own timeout.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import subprocess
import sys
import threading
import uuid
from contextlib import contextmanager
from unittest import mock

import msgpack
import numpy as np
import pytest

from conftest import make_doc
from test_torch_indexer import tree_diff
from test_torch_slice import _assert_pages_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-3
T0 = 1_700_000_000.0
VOCAB = [f"w{i}" for i in range(40)] + ["fresh", "news", "story", "update"]
QUERIES = ("fresh news", "w3", "story w7")


@contextmanager
def pins():
    """uuid4 from a counter of the package named by `who[0]`, time.time fixed:
    each package's run of a lockstep sequence sees the same names."""
    counters = {"jax": itertools.count(1), "port": itertools.count(1)}
    who = ["jax"]
    with mock.patch("uuid.uuid4", side_effect=lambda: uuid.UUID(int=next(counters[who[0]]) << 80)), \
            mock.patch("time.time", return_value=T0):
        yield who


def _doc(rng, i: int, host: str = "live") -> dict:
    words = lambda k: " ".join(rng.choice(VOCAB, size=k))  # noqa: E731
    return make_doc(f"https://{host}{i % 7}.com/p/{i}", words(int(rng.integers(1, 5))),
                    words(int(rng.integers(5, 30))), region=int(rng.integers(0, 4)))


def _contexts(pkg: str, now: float) -> list:
    import importlib

    qc = importlib.import_module(f"{pkg}.ranking.computer").QueryContext
    return [qc(raw=q, simple_terms=q.split(), current_ts=now) for q in QUERIES]


def _top10(live, pkg: str, now: float) -> list:
    """Each query's top 10 as [(segment name, doc), score]."""
    out = []
    for ctx in _contexts(pkg, now):
        ptrs, scores = live.index.search_initial(ctx, top_k=10)
        names = live.index.meta["segments"]
        out.append([((names[p.segment], p.doc), float(s)) for p, s in zip(ptrs, scores)])
    return out


def assert_top10_match(a: list, b: list):
    """One query's top 10 of each package: scores within the tolerance in
    order, and every entry clearly above the cut in both."""
    sa, sb = [s for _, s in a], [s for _, s in b]
    assert len(sa) == len(sb)
    np.testing.assert_allclose(sb, sa, rtol=RTOL, atol=ATOL)
    if not sa:
        return
    cut = sa[-1] + (abs(sa[-1]) * RTOL + ATOL) * 2 if len(sa) == 10 else -np.inf
    mb = dict(b)
    for key, s in a:
        if s > cut:
            assert key in mb, key
            np.testing.assert_allclose(mb[key], s, rtol=RTOL, atol=ATOL)


# ---- the write-ahead log -----------------------------------------------------------------
def test_wal_files_are_byte_equal_and_replay_across(tmp_path):
    from stract_tpu.live_index import Wal as JaxWal
    from stract_tpu_torch.live_index import Wal

    rng = np.random.default_rng(280)
    entries = [_doc(rng, i) for i in range(12)] + [{"x": b"\x00bytes", "n": [1, 2.5, None]}]
    for cls, name in ((JaxWal, "jax"), (Wal, "port")):
        w = cls(str(tmp_path / name / "live.wal"))
        for e in entries:
            w.write(e)
        w.close()
    assert (tmp_path / "jax" / "live.wal").read_bytes() == \
        (tmp_path / "port" / "live.wal").read_bytes()
    for reader, name in ((Wal, "jax"), (JaxWal, "port")):
        assert list(reader(str(tmp_path / name / "live.wal")).iter()) == entries
    # a torn tail (a header, half an entry) is ignored by both
    blob = msgpack.packb({"torn": True}, use_bin_type=True)
    for name in ("jax", "port"):
        with open(tmp_path / name / "live.wal", "ab") as fh:
            fh.write(struct.pack(">I", len(blob)) + blob[: len(blob) // 2])
    for cls in (JaxWal, Wal):
        for name in ("jax", "port"):
            assert list(cls(str(tmp_path / name / "live.wal")).iter()) == entries
    for cls, name in ((JaxWal, "port"), (Wal, "jax")):
        w = cls(str(tmp_path / name / "live.wal"))
        w.clear()
        assert list(w.iter()) == [] and (tmp_path / name / "live.wal").read_bytes() == b""


def test_a_wal_of_either_package_replays_in_the_other(tmp_path):
    from stract_tpu.live_index import LiveIndex as JaxLive
    from stract_tpu_torch.live_index import LiveIndex

    rng = np.random.default_rng(281)
    docs = [_doc(rng, i) for i in range(6)]
    with pins() as who:
        for writer, reader, name in ((JaxLive, "port", "a"), (LiveIndex, "jax", "b")):
            who[0] = "jax" if writer is JaxLive else "port"
            w = writer(str(tmp_path / name), clock=lambda: T0) if writer is JaxLive else \
                writer(str(tmp_path / name), device="cpu", clock=lambda: T0)
            for d in docs:
                w.insert(d)  # WAL'd, never committed: a crash
            who[0] = reader
            r = JaxLive(str(tmp_path / name), clock=lambda: T0) if reader == "jax" else \
                LiveIndex(str(tmp_path / name), device="cpu", clock=lambda: T0)
            assert r.index.num_docs == 6 and len(r.index.segments) == 1
            assert list(r.wal.iter()) == []


# ---- LiveIndex under seeded sequences ------------------------------------------------------
def _ops(rng, n: int) -> list:
    ops = [("insert", 3), ("commit",)]
    for k in range(n):
        r = rng.random()
        if r < 0.35:
            ops.append(("insert", int(rng.integers(1, 4))))
        elif r < 0.5:
            ops.append(("commit",))
        elif r < 0.75:
            ops.append(("tick", float(rng.choice([120.0, 700.0, 1900.0, 3700.0]))))
        elif r < 0.85:
            ops.append(("compact",))
        elif r < 0.93:
            ops.append(("crash", int(rng.integers(1, 3))))
        else:
            ops.append(("insert", 2))
        if k == n // 2:
            ops.append(("ttl",))  # past 60 days: the first hours drop
    return ops + [("commit",), ("tick", 3700.0)]


class _Side:
    """One package's LiveIndex in the lockstep run."""

    def __init__(self, pkg: str, path: str):
        import importlib

        self.pkg, self.path = pkg, path
        self.cls = importlib.import_module(f"{pkg}.live_index").LiveIndex
        self.now = [T0]
        self.live = self.open()

    def open(self):
        kw = {"device": "cpu"} if self.pkg == "stract_tpu_torch" else {}
        return self.cls(self.path, clock=lambda: self.now[0], **kw)

    def apply(self, op, docs):
        live = self.live
        if op[0] == "insert":
            live.insert_batch(docs)
        elif op[0] == "commit":
            live.commit()
        elif op[0] == "tick":
            self.now[0] += op[1]
            live.tick()
        elif op[0] == "compact":
            live.compact()
        elif op[0] == "ttl":
            self.now[0] += 61 * 24 * 3600
            live.prune()
        elif op[0] == "crash":
            for d in docs:
                live.wal.write(d)
            live.wal.close()
            self.live = self.open()

    def state(self) -> tuple:
        idx = self.live.index
        times = self.live.meta["segment_times"]
        return (len(idx.segments), list(idx.meta["segments"]),
                {n: int(times[n] // 3600) for n in idx.meta["segments"] if n in times},
                idx.num_docs)


@pytest.mark.parametrize("seed", [282, 283])
def test_live_index_sequence_matches_the_jax_package(tmp_path, seed):
    """Inserts, commits, ticks at pinned clock steps (autocommit, hourly
    compaction, the TTL), compact, a TTL jump and reopen-after-crash, in
    lockstep: after every operation the same segments and hour buckets, the
    same files byte for byte, and the same top 10 of three queries."""
    rng = np.random.default_rng(seed)
    ops = _ops(rng, 18)
    with pins() as who:
        sides = {}
        for name, pkg in (("jax", "stract_tpu"), ("port", "stract_tpu_torch")):
            who[0] = name
            sides[name] = _Side(pkg, str(tmp_path / name))
        n_doc, searched = 0, 0
        for step, op in enumerate(ops):
            k = op[1] if op[0] in ("insert", "crash") else 0
            docs = [_doc(rng, n_doc + j) for j in range(k)]
            n_doc += k
            for name in ("jax", "port"):
                who[0] = name
                sides[name].apply(op, docs)
            sj, sp = sides["jax"].state(), sides["port"].state()
            assert sp == sj, (step, op)
            assert tree_diff(str(tmp_path / "jax"), str(tmp_path / "port")) == [], (step, op)
            if sj[0]:
                now = sides["jax"].now[0]
                for a, b in zip(_top10(sides["jax"].live, "stract_tpu", now),
                                _top10(sides["port"].live, "stract_tpu_torch", now)):
                    assert_top10_match(a, b)
                    searched += len(a)
    assert searched > 20
    kinds = {op[0] for op in ops}
    assert {"insert", "commit", "tick", "compact", "ttl", "crash"} <= kinds


def test_region_scores_cache_keyed_by_segment_count_as_in_the_jax_package(tmp_path):
    """A gap of the reference that the port keeps: InvertedIndex caches the
    corpus region frequencies by segment count, and LiveIndex never resets
    the cache, so 3 segments → compact to 1 → 2 commits → 3 segments reads
    the first corpus's frequencies in both packages."""
    results = {}
    with pins() as who:
        for name, pkg in (("jax", "stract_tpu"), ("port", "stract_tpu_torch")):
            who[0] = name
            side = _Side(pkg, str(tmp_path / name))
            live = side.live
            for region in (1, 1, 2):
                live.insert(make_doc(f"https://r{region}.com/{len(live.index.segments)}",
                                     "fresh news", "fresh news story", region=region))
                live.commit()
            first = live.index.region_scores().copy()
            live.compact()
            for k in range(2):
                live.insert(make_doc(f"https://r5.com/{k}", "fresh news", "story", region=5))
                live.commit()
            assert len(live.index.segments) == 3
            stale = live.index.region_scores().copy()
            live.index._region_scores = None
            fresh = live.index.region_scores().copy()
            results[name] = (first, stale, fresh, _top10(live, pkg, T0))
    for j, p in zip(results["jax"][:3], results["port"][:3]):
        np.testing.assert_array_equal(p, j)
    first, stale, fresh, _ = results["port"]
    np.testing.assert_array_equal(stale, first)
    assert not np.array_equal(stale, fresh)
    for a, b in zip(results["jax"][3], results["port"][3]):
        assert_top10_match(a, b)


# ---- the serving contract on the port ------------------------------------------------------
def _port_live(tmp_path, n: int = 2):
    from stract_tpu_torch.live_index import LiveIndex

    now = [T0]
    live = LiveIndex(str(tmp_path / "live"), device="cpu", clock=lambda: now[0])
    for i in range(n):
        live.insert(make_doc(f"https://s{i}.com/", f"doc {i} common story", f"text common w{i}"))
        live.commit()
    return live, now


def test_compact_rebinds_and_a_held_snapshot_stays_whole(tmp_path):
    from stract_tpu_torch.ranking.computer import QueryContext

    live, now = _port_live(tmp_path)
    old_list, old_dev_dict = live.index.segments, live.index._device
    old_seg = old_list[0]
    old_dev = live.index.device_segment_for(old_seg)
    live.compact()
    assert live.index.segments is not old_list and len(old_list) == 2
    assert live.index._device is not old_dev_dict and old_dev_dict[id(old_seg)] is old_dev
    assert old_dev.seg is old_seg and live.index.device_segment_for(old_seg).seg is old_seg
    assert old_seg.num_docs == 1
    ptrs, _ = live.index.search_initial(
        QueryContext(raw="story", simple_terms=["story"], current_ts=now[0]), top_k=5)
    assert len(ptrs) == 2


def test_search_during_compaction_in_a_thread(tmp_path):
    from stract_tpu_torch.ranking.computer import QueryContext

    live, now = _port_live(tmp_path, 4)
    errors, stop = [], threading.Event()

    def searcher():
        while not stop.is_set():
            try:
                ptrs, _ = live.index.search_initial(
                    QueryContext(raw="common", simple_terms=["common"], current_ts=now[0]),
                    top_k=8)
                if len(ptrs) != 4:
                    errors.append(f"got {len(ptrs)} results")
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(repr(e))

    t = threading.Thread(target=searcher)
    t.start()
    try:
        for _ in range(3):
            live.compact()
            live.insert(make_doc("https://extra.com/", "extra", "unrelated text"))
            live.commit()
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors[:3]


def test_lazy_signals_and_retrieve_survive_compaction(tmp_path):
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    live, _ = _port_live(tmp_path)
    searcher = LocalSearcher(live.index, shard_id=0, lazy_signals=True)
    sq = SearchQuery(query="story")
    cands, _ = searcher.search_initial(sq)
    assert len(cands) == 2 and all(c.signals is None for c in cands)
    before = {d["url"] for d in searcher.retrieve(sq, [c.pointer for c in cands],
                                                  segments=cands[0]._ctx._segments)}
    live.compact()
    searcher.materialize_signals(sq, cands)
    assert all(c.signals is not None for c in cands)
    docs = searcher.retrieve(sq, [c.pointer for c in cands], segments=cands[0]._ctx._segments)
    assert {d["url"] for d in docs} == before == {"https://s0.com/", "https://s1.com/"}


def test_wire_retrieve_resolves_by_segment_name_and_deletes_wait(tmp_path):
    from stract_tpu_torch.entrypoint.live_index import LiveIndexService
    from stract_tpu_torch.live_index.index import DROP_GRACE_SECONDS
    from stract_tpu_torch.searcher.query import SearchQuery

    live, now = _port_live(tmp_path, 1)
    svc = LiveIndexService(live, shard_id=0)
    sq = SearchQuery(query="story").to_json()
    wire = svc.search(sq)["candidates"]
    assert wire and wire[0]["seg"]
    docs = svc.retrieve({"query": sq, "pointers": [{"segment": 99, "doc": wire[0]["doc"],
                                                    "seg": wire[0]["seg"]}]})
    assert docs[0]["url"] == "https://s0.com/"
    live.insert(make_doc("https://b.com/2", "beta story", "the beta story text"))
    live.commit()
    names = list(live.index.meta["segments"])
    live.compact()
    assert svc.retrieve({"query": sq, "pointers": [dict(wire[0])]})[0] == {}
    seg_dir = lambda n: os.path.join(live.index.path, "segments", n)  # noqa: E731
    assert all(os.path.isdir(seg_dir(n)) for n in names)
    now[0] += DROP_GRACE_SECONDS + 1
    live._reap_dropped()
    assert not any(os.path.isdir(seg_dir(n)) for n in names)
    assert svc.size() == {"num_docs": 2}


def test_a_dropped_device_copy_leaves_the_launch_argument_cache(tmp_path):
    """The launch-argument cache (ops/kernels.py seg_args) holds a segment's
    card arrays for its launch structs; once compaction drops a DeviceSegment
    its entry goes too, so a dropped segment's card memory is freed with its
    device copy (a CPU copy stands in for the card's here)."""
    import gc

    from stract_tpu_torch.ops import kernels

    live, _ = _port_live(tmp_path)
    devs = [live.index.device_segment_for(s) for s in live.index.segments]
    for dev in devs:  # as seg_args files a card segment's arrays
        kernels._SEG_ARGS[id(dev.arrays)] = (dev.arrays, None)
    keys = [id(dev.arrays) for dev in devs]
    live.compact()
    del devs, dev
    gc.collect()
    assert not any(k in kernels._SEG_ARGS for k in keys)
    kept = live.index.device_segment_for(live.index.segments[0])
    kernels._SEG_ARGS[id(kept.arrays)] = (kept.arrays, None)
    gc.collect()
    assert kernels._SEG_ARGS[id(kept.arrays)][0] is kept.arrays  # a live copy keeps its entry
    kernels.forget_seg_args(kept.arrays)


def test_live_index_on_cuda_without_a_card_raises(tmp_path):
    import torch

    from stract_tpu_torch.live_index import LiveIndex

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LiveIndex(str(tmp_path / "x"))


# ---- across packages over sonic --------------------------------------------------------------
PAGE = ("<html><head><title>Breaking news</title></head><body><p>something happened in the "
        "world today and it matters a great deal to everyone reading fresh news</p></body></html>")


def _live_servers(pkg: str, tmp_path, n: int = 2) -> list:
    import importlib

    li = importlib.import_module(f"{pkg}.live_index")
    ep = importlib.import_module(f"{pkg}.entrypoint.live_index")
    sonic = importlib.import_module(f"{pkg}.distributed.sonic")
    kw = {"device": "cpu"} if pkg == "stract_tpu_torch" else {}
    return [sonic.serve_in_thread(ep.LiveIndexService(
        li.LiveIndex(str(tmp_path / f"{pkg}-r{i}"), **kw), shard_id=0)) for i in range(n)]


@pytest.mark.parametrize("client_pkg,server_pkg", [("stract_tpu_torch", "stract_tpu"),
                                                   ("stract_tpu", "stract_tpu_torch")])
def test_quorum_writes_across_packages(tmp_path, client_pkg, server_pkg):
    """A LiveIndexClient of one package over two replicas of the other: both
    ack; with one replica down, fraction 0.5 still acks and 1.0 raises."""
    import importlib

    ep = importlib.import_module(f"{client_pkg}.entrypoint.live_index")
    rep = importlib.import_module(f"{client_pkg}.distributed.replication")
    sonic = importlib.import_module(f"{client_pkg}.distributed.sonic")
    srvs = _live_servers(server_pkg, tmp_path)
    try:
        addrs = [s.addr for s in srvs]
        pages = [{"url": "https://news.com/x", "html": PAGE}]
        assert ep.LiveIndexClient(rep.ReplicatedClient(addrs, timeout=60), 1.0) \
            .index_webpages(pages) == 1
        for s in srvs:
            assert sonic.RemoteClient(s.addr, timeout=60).send("commit", None) is True
            r = sonic.RemoteClient(s.addr, timeout=60).send("search", {"query": "breaking"})
            assert len(r["candidates"]) == 1
        srvs[1].stop()
        half = ep.LiveIndexClient(rep.ReplicatedClient(addrs, timeout=10), 0.5)
        assert half.index_webpages([{"url": "https://news.com/y", "html": PAGE}]) == 1
        with pytest.raises(sonic.RpcError):
            ep.LiveIndexClient(rep.ReplicatedClient(addrs, timeout=10), 1.0).index_webpages(pages)
    finally:
        for s in srvs:
            s.stop()


def _coordinator(pkg: str, backbone, live, live_up: bool = True):
    import importlib

    rep = importlib.import_module(f"{pkg}.distributed.replication")
    dist = importlib.import_module(f"{pkg}.searcher.distributed")
    api = importlib.import_module(f"{pkg}.searcher.api")
    client = lambda a: rep.ShardedClient({0: rep.ReplicatedClient([a], timeout=60)})  # noqa: E731
    d = dist.DistributedSearcher(client(backbone), live_client=client(live))
    return d, api.ApiSearcher(d)


def _cands(cands) -> list:
    return [(c.shard, c.pointer.segment, c.pointer.doc, getattr(c, "_seg_name", None),
             round(float(c.score), 6)) for c in cands]


def test_coordinators_merge_the_live_tier_alike(tmp_path):
    """The port's DistributedSearcher with a live client and the JAX one over
    the same backbone shard and live shard: the same candidates under
    LIVE_SHARD_OFFSET in all three search forms, retrieval routed to the live
    shard, and the same pages; with the live shard down both still serve the
    backbone's."""
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.distributed.sonic import serve_in_thread
    from stract_tpu_torch.entrypoint.live_index import LiveIndexService
    from stract_tpu_torch.entrypoint.search_server import SearchService
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.live_index import LiveIndex
    from stract_tpu_torch.searcher.distributed import LIVE_SHARD_OFFSET
    from stract_tpu_torch.searcher.query import SearchQuery

    rng = np.random.default_rng(284)
    backbone = InvertedIndex(str(tmp_path / "backbone"), "cpu")
    for i in range(40):
        backbone.insert(_doc(rng, i, host="old"))
    backbone.commit()
    live = LiveIndex(str(tmp_path / "live"), device="cpu", clock=lambda: T0)
    for i in range(12):
        live.insert(_doc(rng, 100 + i, host="fresh"))
        if i % 4 == 3:
            live.commit()
    bsrv = serve_in_thread(SearchService(backbone, batching=False))
    lsrv = serve_in_thread(LiveIndexService(live))
    requests = [{"query": q} for q in QUERIES] + [{"query": "w1 w2", "page": 1,
                                                  "num_results": 5}]
    try:
        jd, japi = _coordinator("stract_tpu", bsrv.addr, lsrv.addr)
        pd, papi = _coordinator("stract_tpu_torch", bsrv.addr, lsrv.addr)
        jsq = [JaxSQ.from_json(r) for r in requests]
        psq = [SearchQuery.from_json(r) for r in requests]
        n_live = 0
        for a, b in zip(jsq, psq):
            ja, pa = jd.search_initial(a), pd.search_initial(b)
            assert _cands(pa[0]) == _cands(ja[0]) and pa[1].to_json() == ja[1].to_json()
            n_live += sum(c.shard >= LIVE_SHARD_OFFSET for c in pa[0])
            jd.retrieve(a, ja[0])
            pd.retrieve(b, pa[0])
            assert [c.retrieved for c in pa[0]] == [c.retrieved for c in ja[0]]
        assert n_live > 5
        for (jc, jn), (pc, pn) in zip(jd.search_initial_many(jsq), pd.search_initial_many(psq)):
            assert _cands(pc) == _cands(jc) and pn.to_json() == jn.to_json()
        for (jb, jn), (pb, pn) in zip(jd.search_blocks_many(jsq), pd.search_blocks_many(psq)):
            np.testing.assert_array_equal(pb.shard, jb.shard)
            np.testing.assert_array_equal(pb.doc, jb.doc)
            np.testing.assert_array_equal(pb.score, jb.score)
            assert pn.to_json() == jn.to_json()
        pages = [(japi.search(a).to_json(), papi.search(b).to_json()) for a, b in zip(jsq, psq)]
        for pj, pp in pages:
            _assert_pages_match(pj, pp)
        assert any(w["url"].startswith("https://fresh") for _, pp in pages
                   for w in pp["webpages"])
        lsrv.stop()  # new coordinators: a pooled connection would wait out its timeout
        jd, _ = _coordinator("stract_tpu", bsrv.addr, lsrv.addr)
        pd, _ = _coordinator("stract_tpu_torch", bsrv.addr, lsrv.addr)
        for a, b in zip(jsq, psq):
            ja, pa = jd.search_initial(a), pd.search_initial(b)
            assert _cands(pa[0]) == _cands(ja[0])
            assert all(c.shard < LIVE_SHARD_OFFSET for c in pa[0])
    finally:
        bsrv.stop()
        lsrv.stop()


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_live_index_serve_answers_a_search_found_by_gossip(tmp_path):
    """`python -m stract_tpu_torch.main live-index serve CONFIG --device cpu`
    on a live directory the port wrote: it joins gossip as `live-index`,
    and a search sent to the address gossip gives finds the live pages."""
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.distributed.sonic import RemoteClient
    from stract_tpu_torch.live_index import LiveIndex

    rng = np.random.default_rng(285)
    live = LiveIndex(str(tmp_path / "live"), device="cpu")
    for i in range(8):
        live.insert(_doc(rng, i, host="fresh"))
    live.commit()
    live.wal.close()
    g_watch, g_shard, rpc = _free_port(socket.SOCK_DGRAM), _free_port(socket.SOCK_DGRAM), \
        _free_port()
    cfg = tmp_path / "live.toml"
    cfg.write_text(f'path = "{tmp_path / "live"}"\nshard = 2\nhost = "127.0.0.1"\nport = {rpc}\n'
                   f'[gossip]\naddr = "127.0.0.1:{g_shard}"\nseeds = ["127.0.0.1:{g_watch}"]\n')
    watcher = Cluster.join(Service("watcher"), gossip_addr=("127.0.0.1", g_watch), interval=0.1)
    proc = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", "live-index", "serve",
                             str(cfg), "--device", "cpu"], cwd=REPO,
                            env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        m = watcher.await_member(lambda m: m.service.kind == "live-index", timeout=180)
        assert m is not None and m.service.shard == 2, "the live shard did not join"
        r = RemoteClient(tuple(m.service.host), timeout=120).send("search", {"query": "fresh"})
        assert r["candidates"] and r["count"]["value"] > 0
        assert RemoteClient(tuple(m.service.host), timeout=60).send("size", None) == {
            "num_docs": 8}
    finally:
        watcher.shutdown()
        proc.terminate()
        try:
            proc.communicate(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate(timeout=15)
