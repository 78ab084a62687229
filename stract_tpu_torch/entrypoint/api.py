"""API coordinator process — the port of stract_tpu/entrypoint/api.py (role
of reference entrypoint/api.rs): joins gossip, fans the search route out to
the discovered search shards (searcher/distributed.py DistributedSearcher
over sonic, shard servers of either package), loads the ranking pipeline's
three models, and serves HTTP (api/server.py: the search route, the side
answers, autosuggest, similar hosts, the optic exports, /metrics).

spell_path loads the spell checker (spell/trainer.py load_checker, the
files `main.py web-spell` writes), autosuggest_path the autosuggest
queries, host_graph_path the host graph whose inbound similarity serves the
similar-hosts route, the host link routes and the recall stage's liked /
disliked hosts; the widgets (calculator, thesaurus) are always on.

The page's other services, as the JAX coordinator wires them
(page_services): entity_index_path loads the entity index for a local
SidebarManager; without it the sidebar and the entity images come from
gossip-found `entity-search` servers (RemoteSidebarManager,
RemoteEntityImageStore). page_graph_path loads the page graph of the page
link routes, entity_image_store_path the image store of the entity image
route. improvement_log_path is read nowhere, as in the JAX package (its app
keeps the improvement log in memory; ROADMAP queue 3). The coordinator
also fans every search out to the gossip-found `live-index` shards (the
freshness tier, entrypoint/live_index.py) and merges their candidates with
the search shards' (searcher/distributed.py LIVE_SHARD_OFFSET), as the JAX
coordinator does.
"""

from __future__ import annotations

from ..api.server import build_app
from ..autosuggest import Autosuggest
from ..bangs import Bangs
from ..config import ApiConfig, GossipConfig, _from_dict
from ..device import resolve_device
from ..distributed.cluster import Cluster, Service
from ..distributed.replication import ReusableShardedClient
from ..entity_index.index import EntityIndex, SidebarManager
from ..image_store import ImageStore
from ..ranking.inbound_similarity import InboundSimilarity
from ..searcher.api import ApiSearcher
from ..searcher.distributed import DistributedSearcher
from ..spell.trainer import load_checker
from ..webgraph.store import Webgraph
from ..widgets import WidgetManager
from .entity_search_server import RemoteEntityImageStore, RemoteSidebarManager


def build_pipeline(device, dual_encoder: str = "", cross_encoder: str = "",
                   lambdamart: str = ""):
    """The ranking pipeline with the models at the given paths loaded onto
    `device`, as the JAX package's coordinator loads them: the dual encoder
    into recall, the cross encoder into precision, the forest (LightGBM text
    or JSON) into both."""
    from ..ranking.pipeline import PrecisionStage, RankingPipeline, RecallStage

    recall, precision = RecallStage(), PrecisionStage()
    if dual_encoder:
        from ..models.dual_encoder import DualEncoder

        recall.dual_encoder = DualEncoder.load(dual_encoder, device=device)
    if cross_encoder:
        from ..ranking.models.cross_encoder import CrossEncoderModel

        precision.cross_encoder = CrossEncoderModel.load(cross_encoder, device=device)
    if lambdamart:
        from ..ranking.models.lambdamart import LambdaMART

        recall.lambdamart = precision.lambdamart = LambdaMART.load(lambdamart, device=device)
    return RankingPipeline(recall, precision)


def page_services(cfg: ApiConfig, cluster) -> tuple:
    """The entity sidebar, the page graph and the entity image store of the
    config, as the JAX coordinator wires them → (sidebar, page_graph,
    image_store). Without entity_index_path the sidebar is a
    RemoteSidebarManager over the cluster's `entity-search` servers, and so
    is the image store unless entity_image_store_path names one."""
    if cfg.entity_index_path:
        sidebar = SidebarManager(EntityIndex(cfg.entity_index_path))
    else:
        sidebar = RemoteSidebarManager(ReusableShardedClient(cluster, "entity-search"))
    page_graph = Webgraph(cfg.page_graph_path) if cfg.page_graph_path else None
    image_store = None
    if cfg.entity_image_store_path:
        image_store = ImageStore(cfg.entity_image_store_path)
    elif not cfg.entity_index_path:
        image_store = RemoteEntityImageStore(ReusableShardedClient(cluster, "entity-search"))
    return sidebar, page_graph, image_store


def build_coordinator(cfg: ApiConfig, device="cuda") -> tuple:
    """The coordinator's searcher over the gossip-discovered search shards
    and live-index shards →
    (ApiSearcher, cluster, pages). The models run on `device`; the spell
    checker, the widgets, the host graph's inbound similarity (in the recall
    stage) and the entity sidebar are loaded from the config's paths; pages
    is page_services' (page_graph, image_store) pair, for coordinator_app."""
    resolve_device(device)
    pipeline = build_pipeline(device, cfg.dual_encoder_path, cfg.cross_encoder_path,
                              cfg.lambdamart_path)
    if cfg.host_graph_path:
        pipeline.recall.inbound = InboundSimilarity(Webgraph(cfg.host_graph_path))
    gossip = _from_dict(GossipConfig, cfg.gossip or {})
    cluster = Cluster.join(Service("api"), gossip_addr=gossip.addr_tuple(),
                           seeds=gossip.seed_tuples())
    searcher = DistributedSearcher(ReusableShardedClient(cluster, "search-server"),
                                   live_client=ReusableShardedClient(cluster, "live-index"))
    sidebar, page_graph, image_store = page_services(cfg, cluster)
    api = ApiSearcher(
        searcher,
        pipeline=pipeline,
        bangs=Bangs.from_path(cfg.bangs_path) if cfg.bangs_path else Bangs.builtin(),
        spell_checker=load_checker(cfg.spell_path) if cfg.spell_path else None,
        widget_manager=WidgetManager(),
        sidebar_manager=sidebar,
    )
    return api, cluster, (page_graph, image_store)


def coordinator_app(cfg: ApiConfig, api: ApiSearcher, pages: tuple = (None, None)):
    """The HTTP app of a coordinator built by build_coordinator: autosuggest
    from cfg.autosuggest_path, similar hosts and the host links from the
    recall stage's inbound similarity, the page graph and the image store
    from `pages`, the (page_graph, image_store) pair build_coordinator
    returns."""
    page_graph, image_store = pages
    suggest = Autosuggest.load(cfg.autosuggest_path) if cfg.autosuggest_path else None
    return build_app(api, autosuggest=suggest, similar_hosts=api.pipeline.recall.inbound,
                     page_graph=page_graph, image_store=image_store,
                     max_concurrency=cfg.max_concurrency)


def run(cfg: ApiConfig, device="cuda"):
    """Serve the search route on cfg.host:cfg.port until stopped."""
    from aiohttp import web

    api, _cluster, pages = build_coordinator(cfg, device)
    web.run_app(coordinator_app(cfg, api, pages), host=cfg.host, port=cfg.port)
