"""API coordinator process — the port of stract_tpu/entrypoint/api.py (role
of reference entrypoint/api.rs): joins gossip, fans the search route out to
the discovered search shards (searcher/distributed.py DistributedSearcher
over sonic, shard servers of either package), loads the ranking pipeline's
three models, and serves HTTP (api/server.py: the search route, the side
answers, autosuggest, similar hosts, the optic exports, /metrics).

spell_path loads the spell checker (spell/trainer.py load_checker, the
files `main.py web-spell` writes), autosuggest_path the autosuggest
queries, host_graph_path the host graph whose inbound similarity serves the
similar-hosts route and the recall stage's liked / disliked hosts; the
widgets (calculator, thesaurus) are always on.

The entity sidebar is not ported: without entity_index_path the JAX
coordinator asks gossip-found entity-search servers for it, and the port
passes no sidebar manager, so the sidebar route answers the StackOverflow
optic search alone. The entity index, its image store, the page graph and
the improvement log are not ported (ROADMAP queue 1 item 3b): a config that
sets one raises. The live-index tier is not ported either (queue 1 item 5),
so the coordinator fans out to the search shards alone.
"""

from __future__ import annotations

from ..api.server import build_app
from ..autosuggest import Autosuggest
from ..bangs import Bangs
from ..config import ApiConfig, GossipConfig, _from_dict
from ..device import resolve_device
from ..distributed.cluster import Cluster, Service
from ..distributed.replication import ReusableShardedClient
from ..ranking.inbound_similarity import InboundSimilarity
from ..searcher.api import ApiSearcher
from ..searcher.distributed import DistributedSearcher
from ..spell.trainer import load_checker
from ..webgraph.store import Webgraph
from ..widgets import WidgetManager

UNPORTED = ("entity_index_path", "page_graph_path", "entity_image_store_path",
            "improvement_log_path")


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


def build_coordinator(cfg: ApiConfig, device="cuda") -> tuple:
    """The coordinator's searcher over the gossip-discovered search shards →
    (ApiSearcher, cluster). The models run on `device`; the spell checker,
    the widgets and the host graph's inbound similarity (in the recall stage)
    are loaded from the config's paths."""
    resolve_device(device)
    unported = [name for name in UNPORTED if getattr(cfg, name)]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not ported yet "
                                  "(ROADMAP queue 1 item 3b)")
    pipeline = build_pipeline(device, cfg.dual_encoder_path, cfg.cross_encoder_path,
                              cfg.lambdamart_path)
    if cfg.host_graph_path:
        pipeline.recall.inbound = InboundSimilarity(Webgraph(cfg.host_graph_path))
    gossip = _from_dict(GossipConfig, cfg.gossip or {})
    cluster = Cluster.join(Service("api"), gossip_addr=gossip.addr_tuple(),
                           seeds=gossip.seed_tuples())
    searcher = DistributedSearcher(ReusableShardedClient(cluster, "search-server"))
    api = ApiSearcher(
        searcher,
        pipeline=pipeline,
        bangs=Bangs.from_path(cfg.bangs_path) if cfg.bangs_path else Bangs.builtin(),
        spell_checker=load_checker(cfg.spell_path) if cfg.spell_path else None,
        widget_manager=WidgetManager(),
    )
    return api, cluster


def coordinator_app(cfg: ApiConfig, api: ApiSearcher):
    """The HTTP app of a coordinator built by build_coordinator: autosuggest
    from cfg.autosuggest_path, similar hosts from the recall stage's
    inbound similarity."""
    suggest = Autosuggest.load(cfg.autosuggest_path) if cfg.autosuggest_path else None
    return build_app(api, autosuggest=suggest, similar_hosts=api.pipeline.recall.inbound,
                     max_concurrency=cfg.max_concurrency)


def run(cfg: ApiConfig, device="cuda"):
    """Serve the search route on cfg.host:cfg.port until stopped."""
    from aiohttp import web

    api, _cluster = build_coordinator(cfg, device)
    web.run_app(coordinator_app(cfg, api), host=cfg.host, port=cfg.port)
