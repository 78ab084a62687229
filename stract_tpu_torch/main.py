"""Command line of the port.

    python -m stract_tpu_torch.main serve --index DIR --port N --device cuda \
        [--dual-encoder DIR] [--cross-encoder DIR] [--lambdamart FILE] \
        [--row-layout {q16,q8}] [--device-join] [--ub-lambda X] [--verify-c N] \
        [--merge-kernel]
    python -m stract_tpu_torch.main train-encoders {dual,cross,both} INDEX OUT \
        [--steps 120] [--batch 16] [--triples 512] [--device cuda]
    python -m stract_tpu_torch.main centrality \
        {harmonic,approx-harmonic,harmonic-nearest-seed} CONFIG [--device cuda]
    python -m stract_tpu_torch.main search-server CONFIG [--device cuda]
    python -m stract_tpu_torch.main api CONFIG [--device cuda]
    python -m stract_tpu_torch.main web-spell CONFIG
    python -m stract_tpu_torch.main indexer {search,merge,canonical,entity} CONFIG
    python -m stract_tpu_torch.main configure [--data-dir data] [--device cuda]
    python -m stract_tpu_torch.main site-stats CONFIG
    python -m stract_tpu_torch.main safety-classifier {train DATA MODEL,predict MODEL TEXT...}
    python -m stract_tpu_torch.main admin {index-stats PATH,top-keyphrases PATH,status HOST:PORT}
    python -m stract_tpu_torch.main entity-search-server CONFIG
    python -m stract_tpu_torch.main live-index {serve,crawler} CONFIG [--device cuda]
    python -m stract_tpu_torch.main crawler {worker,coordinator,router,plan} CONFIG
    python -m stract_tpu_torch.main webgraph {create,merge} CONFIG
    python -m stract_tpu_torch.main webgraph-server CONFIG
    python -m stract_tpu_torch.main ampc {dht,harmonic-worker,harmonic-coordinator,\
        approx-harmonic-coordinator,shortest-path-worker,shortest-path-coordinator} \
        CONFIG [--device cuda]

`serve` is the one-process deployment (index + searcher + coordinator + HTTP
API in one process) restricted to the search route: POST /beta/api/search
and GET /metrics. DIR is an index directory of either package
(index_meta.json + segments/). --device cpu runs the plain PyTorch versions
of the kernels; --device cuda needs a card and runs the hand-written kernels.

--row-layout, --device-join, --ub-lambda, --verify-c and --merge-kernel
choose the shard search's configuration (index/inverted.py InvertedIndex:
the JAX package's STRACT_TPU_ROW_LAYOUT, _DEVICE_JOIN, _UB_LAMBDA,
_VERIFY_C and _MERGE_KERNEL switches); the defaults are q16 rows, the host
factor join, no UB scoring, verify all, stage A's join without the merge.

The model flags are the coordinator's ApiConfig fields dual_encoder_path,
cross_encoder_path and lambdamart_path, loaded as the JAX package's api
entry point loads them: the dual encoder into the recall stage, the cross
encoder into the precision stage, the forest (LightGBM text when the file
holds "Tree=", else JSON) into both. Encoder dirs are native checkpoints of
either package or HF safetensors dirs. Recall's embedding similarity reads
the index's embedding columns (index/embeddings.py writes them).

`train-encoders` is the JAX package's subcommand of the same name
(entrypoint/train_encoders.py): it trains the dual encoder, the cross
encoder or both (each on its own, at the tiny config) on triples
synthesised from INDEX and saves them under OUT/dual_encoder and
OUT/cross_encoder; --device cuda needs a card.

`centrality` is the JAX package's subcommand of the same name
(entrypoint/centrality.py): CONFIG is a CentralityConfig TOML
(configs/centrality.toml); the job reads the webgraph at webgraph_path and
writes the kv store at output_path, and prints what the JAX package prints.
--device cuda needs a card.

`search-server` and `api` are the JAX package's two serving roles of the
same names: CONFIG is a SearchServerConfig TOML (configs/search_server.toml)
or an ApiConfig TOML (configs/api.toml). A search server serves one index
directory over sonic RPC (entrypoint/search_server.py) and announces itself
by gossip; with mesh_search = "auto" and more than one card it serves the
segments one per card (parallel/search.py). The api role joins gossip, fans
each search out to the shards it finds and serves the search route over
HTTP (entrypoint/api.py). Both speak the JAX package's wire forms, so the
roles of the two packages mix. --device cpu runs the plain versions.

`web-spell` is the JAX package's subcommand of the same name: CONFIG is a
WebSpellConfig TOML (index_path, output_path). It reads the stored docs of
an index directory of either package on the host (no device work) and
writes the term frequencies, the language model and the error model that
the coordinator's spell_path loads.

`indexer` is the JAX package's subcommand of the same name: CONFIG is an
IndexerConfig TOML (configs/indexer.toml). `search` and `merge` index the
pages of the WARC files at warc_paths (entrypoint/indexer.py: parse, the
host and page centralities of the kv stores at host_centrality_path and
page_centrality_path, keywords, one segment a file) into the search index
at output_path, merged into one segment for `merge` or when the config sets
merge; `canonical` writes the canonical-URL store of the pages'
rel=canonical links (canon_index.py); `entity` reads the ZIM at zim_path
(zim.py), parses each article's abstract, infobox and image
(entrypoint/entity.py) and writes the entity index (entities.bin) to
output_path, stopping at entity_limit. All four are host work, and each
writes the JAX package's files. As in the JAX package, dual_encoder_path and
safety_model_path are read nowhere here: entrypoint/indexer.py run takes a
dual encoder (IndexingWorker(dual_encoder=...)), whose embeddings run on
the card it was loaded onto.

`configure` is the JAX package's dev bootstrap (entrypoint/configure.py): a
small synthetic WARC, its host graph, the graph's harmonic centrality (on
--device), the index, the spell models, autosuggest and an entity index,
all under --data-dir.

`site-stats` (a SiteStatsConfig TOML: index_path, output_path,
host_centrality_path), `safety-classifier train DATA MODEL | predict MODEL
TEXT` and `admin index-stats PATH | top-keyphrases PATH | status HOST:PORT`
are the JAX package's subcommands of the same names, host work all.

`entity-search-server` is the JAX package's role of the same name: CONFIG is
an EntitySearchServerConfig TOML (index_path, image_store_path, host, port,
[gossip]). It serves the entity index's search and the image store's images
over sonic RPC and announces itself by gossip as `entity-search`; a
coordinator without entity_index_path asks it for the sidebar and the entity
images. It does no device work, so it takes no --device.

`live-index serve` is the JAX package's role of the same name: CONFIG is a
LiveIndexConfig TOML (path, shard, host, port, [gossip]). It serves the
live directory at `path` (entrypoint/live_index.py: a WAL, hourly
compaction, a 60-day TTL) over sonic RPC and announces itself by gossip as
`live-index`; a coordinator merges its candidates with the search shards'.
Its searches run on --device (K1-K3 on a card). `live-index crawler` and
`crawler plan` print a line, as in the JAX package: the live crawler takes
a site list through its Python API (live_index/crawler.py LiveCrawler), the
plan make_crawl_plan (crawler/planner.py).

`crawler coordinator | router | worker` are the JAX package's crawl roles:
CONFIG is a CrawlerConfig TOML (queue_path, discovered_path,
warc_output_dir, coordinator_addrs, router_addr). The coordinator serves
the job queue at queue_path, the router round-robins the coordinators at
coordinator_addrs, a worker takes jobs from the router at router_addr until
none is left and writes a WARC file a job under warc_output_dir. Host work
all: no --device.

`webgraph create | merge` and `webgraph-server` are the JAX package's
subcommands of the same names. `webgraph create` reads a
WebgraphConstructConfig TOML (warc_paths, output_path, level = host | page)
and writes the graph of the WARC files' links (entrypoint/webgraph_build.py);
`webgraph merge` takes warc_paths as the graphs to merge
(webgraph/store.py merge_graphs). `webgraph-server` (a WebgraphServerConfig
TOML: graph_path, shard, host, port, [gossip]) serves one graph shard over
sonic RPC and announces itself by gossip as `webgraph`
(entrypoint/webgraph_server.py); webgraph/remote.py RemoteWebgraph fans a
coordinator's queries out over the shards it finds. Host work: no --device.

`ampc ROLE CONFIG` is the JAX package's distributed graph job (an AmpcConfig
TOML, one struct for every role; entrypoint/ampc.py): `dht` serves a DHT
shard (raft-replicated with `peers`), `harmonic-worker` and
`shortest-path-worker` an edge partition of webgraph_path (shard of
num_shards), and the three coordinators find them by gossip, drive the
rounds and write output_path. The harmonic worker merges its partition's
registers on --device (K6a on a card; cuda without one raises); the other
roles are host work and take no --device.
"""

from __future__ import annotations

import argparse
import asyncio
import threading

from aiohttp import web


def build_searcher(index_dir: str, device: str, dual_encoder: str | None = None,
                   cross_encoder: str | None = None, lambdamart: str | None = None,
                   row_layout: str = "q16", device_join: bool = False, ub_lambda: float = 0.0,
                   verify_c: int = 0, merge_kernel: bool = False):
    """The serving stack over one local shard, with the ranking pipeline's
    models loaded from the given paths onto `device` and the shard search in
    the given configuration (InvertedIndex's arguments) → ApiSearcher."""
    from .entrypoint.api import build_pipeline
    from .index.inverted import InvertedIndex
    from .searcher.api import ApiSearcher
    from .searcher.distributed import LocalShardedSearcher
    from .searcher.local import LocalSearcher

    index = InvertedIndex(index_dir, device=device, row_layout=row_layout,
                          device_join=device_join, ub_lambda=ub_lambda, verify_c=verify_c,
                          merge_kernel=merge_kernel)
    for seg in index.segments:
        index.device_segment_for(seg)  # upload before the first request
    return ApiSearcher(LocalShardedSearcher([LocalSearcher(index)]),
                       build_pipeline(device, dual_encoder, cross_encoder, lambdamart))


class ServerThread:
    """The HTTP app on its own event loop in a background thread (tests and
    chip_smoke.py drive the real route in process). stop() shuts the app
    down and joins the thread."""

    def __init__(self, app: web.Application, host: str = "127.0.0.1", port: int = 0):
        self._app = app
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._runner = None
        self.port = port
        self._host = host
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=60) or self._error is not None:
            raise RuntimeError(f"server did not start: {self._error}")

    def _run(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._start())
        except Exception as e:  # noqa: BLE001 — reported by __init__
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self._loop.run_forever()
        self._loop.run_until_complete(self._runner.cleanup())
        self._loop.close()

    async def _start(self):
        self._runner = web.AppRunner(self._app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("server thread did not stop")


def run_centrality(mode: str, config: str, device: str = "cuda",
                   timings: dict | None = None) -> dict:
    """`main.py centrality MODE CONFIG`: the job over the config's paths →
    the centrality of each node (also printed as the JAX package prints it)."""
    from .config import load_config
    from .entrypoint.centrality import (run_approx_harmonic, run_harmonic,
                                        run_harmonic_nearest_seed)

    cfg = load_config("centrality", config)
    if mode == "harmonic":
        c = run_harmonic(cfg.webgraph_path, cfg.output_path, cfg.precision, device=device,
                         timings=timings)
    elif mode == "harmonic-nearest-seed":
        c = run_harmonic_nearest_seed(cfg.webgraph_path, cfg.original_centrality_path,
                                      cfg.output_path, cfg.discount_factor, device=device)
    else:
        c = run_approx_harmonic(cfg.webgraph_path, cfg.output_path, cfg.num_samples,
                                device=device, timings=timings)
    print(f"centrality for {len(c)} nodes → {cfg.output_path}")
    return c


def _indexer(action: str, config: str) -> None:
    """`main.py indexer ACTION CONFIG` (stract_tpu/main.py's indexer actions)."""
    from .config import load_config

    cfg = load_config("indexer", config)
    if action == "entity":
        from .entrypoint.entity import build_entity_index

        idx = build_entity_index(cfg.zim_path, cfg.output_path, limit=cfg.entity_limit or None)
        print(f"indexed {len(idx)} entities → {cfg.output_path}", flush=True)
    elif action == "canonical":
        from .canon_index import build_from_warcs as build_canonical

        build_canonical(cfg.warc_paths, cfg.output_path)
        print(f"canonical index → {cfg.output_path}", flush=True)
    else:
        from .entrypoint.indexer import IndexingWorker, run
        from .kv import Db

        worker = IndexingWorker(
            host_centrality=Db.open(cfg.host_centrality_path) if cfg.host_centrality_path else None,
            page_centrality=Db.open(cfg.page_centrality_path) if cfg.page_centrality_path else None,
        )
        idx = run(cfg.warc_paths, cfg.output_path, worker, embedding_dim=cfg.embedding_dim,
                  merge=(action == "merge" or cfg.merge))
        print(f"indexed {idx.num_docs} docs → {cfg.output_path}", flush=True)


def _safety(action: str, rest: list) -> None:
    from .webpage.safety import SafetyClassifier

    if action == "train":
        import json

        data_path, model_path = rest
        texts, labels = [], []
        with open(data_path) as fh:
            for line in fh:
                d = json.loads(line)
                texts.append(d["text"])
                labels.append(d["label"])
        SafetyClassifier.train(texts, labels).save(model_path)
        print(f"model → {model_path}")
    else:
        model_path, text = rest[0], " ".join(rest[1:])
        print(SafetyClassifier.load(model_path).classify(text))


def _admin(action: str, path) -> None:
    # the index is read on the host (stored docs and segment metadata)
    if action == "index-stats" and path:
        from .index.inverted import InvertedIndex

        idx = InvertedIndex(path, "cpu")
        print(f"docs={idx.num_docs} segments={len(idx.segments)}")
        for s in idx.segments:
            print(f"  {s.path}: docs={s.num_docs} terms={s.meta['num_terms']} "
                  f"postings={s.meta['num_postings']}")
    elif action == "top-keyphrases" and path:
        from .generic_query import TopKeyPhrasesQuery, run_generic_query
        from .index.inverted import InvertedIndex
        from .searcher.local import LocalSearcher

        phrases = run_generic_query(
            TopKeyPhrasesQuery(50), [LocalSearcher(InvertedIndex(path, "cpu"), 0)])
        for phrase, count in sorted(phrases.items(), key=lambda kv: -kv[1]):
            print(f"{count:6d}  {phrase}")
    elif action == "status" and path:
        import time

        from .distributed.cluster import Cluster, Service

        h, p = path.rsplit(":", 1)
        c = Cluster.join(Service("admin"), seeds=[(h, int(p))])
        time.sleep(3)
        for m in c.members():
            svc = m.service
            print(f"{m.id} kind={svc.kind} shard={svc.shard} host={svc.host} alive={m.is_alive()}")
        c.shutdown()
    else:
        print("usage: admin status <gossip-seed host:port> | admin index-stats <path>")


def _crawler_role(role: str, config: str) -> None:
    """`main.py crawler ROLE CONFIG` (stract_tpu/main.py _run_crawler_role)."""
    import os
    import time

    from .config import load_config
    from .distributed.sonic import RemoteClient, serve_in_thread

    cfg = load_config("crawler", config)
    if role == "coordinator":
        from .crawler import CrawlCoordinator

        srv = serve_in_thread(CrawlCoordinator(cfg.queue_path, cfg.discovered_path), port=0)
        print(f"crawl coordinator rpc={srv.addr}", flush=True)
        _wait_forever()
    elif role == "router":
        from .crawler import Router

        addrs = [(a.rsplit(":", 1)[0], int(a.rsplit(":", 1)[1])) for a in cfg.coordinator_addrs]
        srv = serve_in_thread(Router(addrs), port=0)
        print(f"crawl router rpc={srv.addr}", flush=True)
        _wait_forever()
    elif role == "worker":
        from .crawler.worker import WorkerThread
        from .warc import WarcWriter

        h, p = cfg.router_addr.rsplit(":", 1)
        os.makedirs(cfg.warc_output_dir, exist_ok=True)

        def warc_factory(domain):
            return WarcWriter.open(f"{cfg.warc_output_dir}/{domain}-{int(time.time())}.warc.gz")

        n = WorkerThread(RemoteClient((h, int(p))), warc_factory=warc_factory).run()
        print(f"crawled {n} jobs", flush=True)
    else:
        print("use stract_tpu_torch.crawler.planner.make_crawl_plan with centrality + url stores")


def _webgraph(action: str, config: str) -> None:
    """`main.py webgraph ACTION CONFIG` (stract_tpu/main.py's webgraph actions)."""
    from .config import load_config

    cfg = load_config("webgraph", config)
    if action == "merge":
        from .webgraph.store import merge_graphs

        g = merge_graphs(cfg.warc_paths, cfg.output_path)  # paths = source graphs
    else:
        from .entrypoint.webgraph_build import build_from_warcs

        g = build_from_warcs(cfg.warc_paths, cfg.output_path, cfg.level)
    print(f"webgraph: {g.num_nodes} nodes, {g.num_edges} edges → {cfg.output_path}", flush=True)


def _ampc_role(role: str, config: str, device: str) -> None:
    """`main.py ampc ROLE CONFIG` (stract_tpu/main.py _run_ampc_role)."""
    from .config import GossipConfig, _from_dict, load_config
    from .entrypoint import ampc as ep

    cfg = load_config("ampc", config)
    g = _from_dict(GossipConfig, cfg.gossip or {})
    ga, gs = g.addr_tuple(), g.seed_tuples()
    if role == "dht":
        peers = []
        for a in cfg.peers:
            if isinstance(a, str):
                h, p = a.rsplit(":", 1)
                peers.append((h, int(p)))
            else:
                peers.append(tuple(a))
        server, _cluster, _obj = ep.run_dht(
            cfg.host, cfg.port, cfg.node_id, peers or None, ga, gs)
        print(f"ampc dht shard={cfg.node_id} rpc={server.addr}", flush=True)
        _wait_forever()
    elif role == "harmonic-worker":
        server, _cluster = ep.run_harmonic_worker(
            cfg.webgraph_path, cfg.shard, cfg.num_shards, cfg.precision,
            cfg.host, cfg.port, ga, gs, device=device)
        print(f"ampc harmonic-worker shard={cfg.shard} rpc={server.addr}", flush=True)
        _wait_forever()
    elif role == "shortest-path-worker":
        server, _cluster = ep.run_shortest_path_worker(
            cfg.webgraph_path, cfg.shard, cfg.num_shards, cfg.host, cfg.port, ga, gs)
        print(f"ampc shortest-path-worker shard={cfg.shard} rpc={server.addr}", flush=True)
        _wait_forever()
    elif role == "harmonic-coordinator":
        c = ep.run_harmonic_coordinator(
            cfg.webgraph_path, cfg.output_path, cfg.num_shards, cfg.precision,
            ga, gs, cfg.wait_s)
        print(f"harmonic centrality for {len(c)} nodes → {cfg.output_path}", flush=True)
    elif role == "approx-harmonic-coordinator":
        c = ep.run_approx_harmonic_coordinator(
            cfg.webgraph_path, cfg.output_path, cfg.num_shards,
            cfg.num_samples, cfg.seed, ga, gs, cfg.wait_s)
        print(f"approx harmonic centrality for {len(c)} nodes → {cfg.output_path}", flush=True)
    else:
        d = ep.run_shortest_path_coordinator(
            cfg.webgraph_path, cfg.source, cfg.output_path, cfg.num_shards,
            ga, gs, cfg.wait_s)
        print(f"shortest paths from {cfg.source}: {len(d)} reachable → {cfg.output_path}",
              flush=True)


def _wait_forever():
    stop = threading.Event()
    while not stop.wait(3600):
        pass


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stract_tpu_torch.main")
    sub = ap.add_subparsers(dest="role", required=True)
    sp = sub.add_parser("serve", help="index + coordinator + HTTP search API in one process")
    sp.add_argument("--index", required=True, help="index directory")
    sp.add_argument("--port", type=int, default=3000)
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--device", default="cuda", help="cuda or cpu")
    sp.add_argument("--dual-encoder", default="", help="dual encoder dir (recall stage)")
    sp.add_argument("--cross-encoder", default="", help="cross encoder dir (precision stage)")
    sp.add_argument("--lambdamart", default="", help="forest file, LightGBM text or JSON")
    sp.add_argument("--row-layout", choices=["q16", "q8"], default="q16",
                    help="posting rows on the device: 12 or 8 bytes a row")
    sp.add_argument("--device-join", action="store_true",
                    help="join stage B's and pass 2's factors on the device")
    sp.add_argument("--ub-lambda", type=float, default=0.0,
                    help="> 0: block-max UB scoring in stage A, bounds scaled by this")
    sp.add_argument("--verify-c", type=int, default=0,
                    help="> 0: stage B verifies only stage A's top N candidates")
    sp.add_argument("--merge-kernel", action="store_true",
                    help="stage A joins through the P-way bitonic merge of its tiles")
    tp = sub.add_parser("train-encoders", help="fine-tune dual/cross encoders from an index")
    tp.add_argument("kind", choices=["dual", "cross", "both"])
    tp.add_argument("index_path")
    tp.add_argument("out_dir")
    tp.add_argument("--steps", type=int, default=120)
    tp.add_argument("--batch", type=int, default=16)
    tp.add_argument("--triples", type=int, default=512)
    tp.add_argument("--device", default="cuda", help="cuda or cpu")
    cp = sub.add_parser("centrality", help="harmonic centrality jobs")
    cp.add_argument("mode", choices=["harmonic", "approx-harmonic", "harmonic-nearest-seed"])
    cp.add_argument("config")
    cp.add_argument("--device", default="cuda", help="cuda or cpu")
    wp = sub.add_parser("web-spell", help="train spell-correction models from an index")
    wp.add_argument("config")
    ip = sub.add_parser("indexer", help="build search/entity/canonical indexes")
    ip.add_argument("action", choices=["search", "merge", "entity", "canonical"])
    ip.add_argument("config")
    cf = sub.add_parser("configure", help="build a tiny dev deployment in data/")
    cf.add_argument("--data-dir", default="data")
    cf.add_argument("--device", default="cuda", help="cuda or cpu")
    ss = sub.add_parser("site-stats", help="aggregate per-site statistics")
    ss.add_argument("config")
    sc = sub.add_parser("safety-classifier")
    sc.add_argument("action", choices=["train", "predict"])
    sc.add_argument("args", nargs="*")
    ad = sub.add_parser("admin")
    ad.add_argument("action", choices=["status", "index-stats", "top-keyphrases"])
    ad.add_argument("path", nargs="?", help="index path, or gossip seed host:port for status")
    ep = sub.add_parser("entity-search-server",
                        help="the entity sidebar's server over sonic RPC, announced by gossip")
    ep.add_argument("config")
    lp = sub.add_parser("live-index", help="freshness tier")
    lp.add_argument("action", choices=["serve", "crawler"])
    lp.add_argument("config")
    lp.add_argument("--device", default="cuda", help="cuda or cpu")
    cr = sub.add_parser("crawler", help="distributed crawler roles")
    cr.add_argument("crawl_role", choices=["worker", "coordinator", "router", "plan"])
    cr.add_argument("config")
    wg = sub.add_parser("webgraph", help="build webgraph from WARCs")
    wg.add_argument("action", choices=["create", "merge"])
    wg.add_argument("config")
    ws = sub.add_parser("webgraph-server",
                        help="one webgraph shard over sonic RPC, announced by gossip")
    ws.add_argument("config")
    am = sub.add_parser("ampc", help="distributed graph-compute roles")
    am.add_argument("ampc_role", choices=[
        "dht", "harmonic-worker", "harmonic-coordinator", "approx-harmonic-coordinator",
        "shortest-path-worker", "shortest-path-coordinator"])
    am.add_argument("config")
    am.add_argument("--device", default=None,
                    help="harmonic-worker: cuda (the default) or cpu")
    for role, what in (("search-server", "a search shard over sonic RPC, announced by gossip"),
                       ("api", "the coordinator: gossip, shard fan-out, HTTP search API")):
        rp = sub.add_parser(role, help=what)
        rp.add_argument("config")
        rp.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    if args.role == "search-server":
        from .config import GossipConfig, _from_dict, load_config
        from .entrypoint.search_server import run

        cfg = load_config("search-server", args.config)
        g = _from_dict(GossipConfig, cfg.gossip or {})
        server, cluster = run(cfg.index_path, cfg.shard, cfg.host, cfg.port, g.addr_tuple(),
                              g.seed_tuples(), linear_model_path=cfg.linear_model_path,
                              mesh=cfg.mesh_search, device=args.device)
        print(f"search-server shard={cfg.shard} rpc={server.addr} gossip={cluster.gossip_addr}",
              flush=True)
        _wait_forever()
        return

    if args.role == "indexer":
        _indexer(args.action, args.config)
        return

    if args.role == "webgraph":
        _webgraph(args.action, args.config)
        return

    if args.role == "webgraph-server":
        from .config import GossipConfig, _from_dict, load_config
        from .entrypoint.webgraph_server import run

        cfg = load_config("webgraph-server", args.config)
        g = _from_dict(GossipConfig, cfg.gossip or {})
        server, cluster = run(cfg.graph_path, cfg.shard, cfg.host, cfg.port, g.addr_tuple(),
                              g.seed_tuples())
        print(f"webgraph-server shard={cfg.shard} rpc={server.addr} gossip={cluster.gossip_addr}",
              flush=True)
        _wait_forever()
        return

    if args.role == "ampc":
        if args.device is not None and args.ampc_role != "harmonic-worker":
            ap.error("--device applies to ampc harmonic-worker alone")
        _ampc_role(args.ampc_role, args.config, args.device or "cuda")
        return

    if args.role == "live-index":
        from .config import GossipConfig, _from_dict, load_config

        cfg = load_config("live-index", args.config)
        if args.action == "serve":
            from .entrypoint.live_index import run

            g = _from_dict(GossipConfig, cfg.gossip or {})
            server, cluster = run(cfg.path, cfg.shard, cfg.host, cfg.port, g.addr_tuple(),
                                  g.seed_tuples(), device=args.device)
            print(f"live-index shard={cfg.shard} rpc={server.addr} gossip={cluster.gossip_addr}",
                  flush=True)
            _wait_forever()
        else:
            print("live crawler requires a site list; see stract_tpu_torch/live_index/crawler.py")
        return

    if args.role == "crawler":
        _crawler_role(args.crawl_role, args.config)
        return

    if args.role == "configure":
        from .entrypoint.configure import run as configure_run

        configure_run(args.data_dir, device=args.device)
        return

    if args.role == "site-stats":
        from . import site_stats
        from .config import load_config
        from .index.inverted import InvertedIndex
        from .kv import Db

        cfg = load_config("site-stats", args.config)
        hc = Db.open(cfg.host_centrality_path) if cfg.host_centrality_path else None
        # the stored docs are read on the host: the index is never uploaded
        site_stats.run(InvertedIndex(cfg.index_path, "cpu"), cfg.output_path, hc)
        print(f"site stats → {cfg.output_path}")
        return

    if args.role == "safety-classifier":
        _safety(args.action, args.args)
        return

    if args.role == "admin":
        _admin(args.action, args.path)
        return

    if args.role == "entity-search-server":
        from .config import GossipConfig, _from_dict, load_config
        from .entrypoint.entity_search_server import run

        cfg = load_config("entity-search-server", args.config)
        g = _from_dict(GossipConfig, cfg.gossip or {})
        server, cluster = run(cfg.index_path, cfg.image_store_path, cfg.host, cfg.port,
                              g.addr_tuple(), g.seed_tuples())
        print(f"entity-search-server rpc={server.addr} gossip={cluster.gossip_addr}", flush=True)
        _wait_forever()
        return

    if args.role == "api":
        from .config import load_config
        from .entrypoint.api import run

        run(load_config("api", args.config), device=args.device)
        return

    if args.role == "centrality":
        run_centrality(args.mode, args.config, args.device)
        return

    if args.role == "web-spell":
        from .config import load_config
        from .index.inverted import InvertedIndex
        from .spell.trainer import train_from_index

        cfg = load_config("web-spell", args.config)
        # the stored docs are read on the host: the index is never uploaded
        train_from_index(InvertedIndex(cfg.index_path, "cpu"), cfg.output_path)
        print(f"spell models → {cfg.output_path}")
        return

    if args.role == "train-encoders":
        import os

        from .entrypoint import train_encoders as te

        if args.kind in ("dual", "both"):
            te.train_dual_encoder(args.index_path, os.path.join(args.out_dir, "dual_encoder"),
                                  steps=args.steps, batch=args.batch, n_triples=args.triples,
                                  device=args.device)
        if args.kind in ("cross", "both"):
            te.train_cross_encoder(args.index_path, os.path.join(args.out_dir, "cross_encoder"),
                                   steps=args.steps, batch=args.batch, n_triples=args.triples,
                                   device=args.device)
        return

    from .api.server import build_app

    app = build_app(build_searcher(args.index, args.device, args.dual_encoder,
                                   args.cross_encoder, args.lambdamart, args.row_layout,
                                   args.device_join, args.ub_lambda, args.verify_c,
                                   args.merge_kernel))
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
