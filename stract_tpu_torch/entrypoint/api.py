"""API coordinator process — the port of stract_tpu/entrypoint/api.py (role
of reference entrypoint/api.rs): joins gossip, fans the search route out to
the discovered search shards (searcher/distributed.py DistributedSearcher
over sonic, shard servers of either package), loads the ranking pipeline's
three models, serves HTTP (api/server.py: POST /beta/api/search, GET
/metrics).

The coordinator's other options (autosuggest, spell checking, the entity
sidebar and its image store, the host and page graphs, the improvement log)
are not ported (ROADMAP queue 1 item 3): a config that sets one raises. The
live-index tier is not ported either, so the coordinator fans out to the
search shards alone.
"""

from __future__ import annotations

from ..api.server import build_app
from ..bangs import Bangs
from ..config import ApiConfig, GossipConfig, _from_dict
from ..device import resolve_device
from ..distributed.cluster import Cluster, Service
from ..distributed.replication import ReusableShardedClient
from ..searcher.api import ApiSearcher
from ..searcher.distributed import DistributedSearcher

UNPORTED = ("autosuggest_path", "spell_path", "entity_index_path", "host_graph_path",
            "page_graph_path", "entity_image_store_path", "improvement_log_path")


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
    (ApiSearcher, cluster). The models run on `device`."""
    resolve_device(device)
    unported = [name for name in UNPORTED if getattr(cfg, name)]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not ported yet "
                                  "(ROADMAP queue 1 item 3)")
    gossip = _from_dict(GossipConfig, cfg.gossip or {})
    cluster = Cluster.join(Service("api"), gossip_addr=gossip.addr_tuple(),
                           seeds=gossip.seed_tuples())
    searcher = DistributedSearcher(ReusableShardedClient(cluster, "search-server"))
    api = ApiSearcher(
        searcher,
        pipeline=build_pipeline(device, cfg.dual_encoder_path, cfg.cross_encoder_path,
                                cfg.lambdamart_path),
        bangs=Bangs.from_path(cfg.bangs_path) if cfg.bangs_path else Bangs.builtin(),
    )
    return api, cluster


def run(cfg: ApiConfig, device="cuda"):
    """Serve the search route on cfg.host:cfg.port until stopped."""
    from aiohttp import web

    api, _cluster = build_coordinator(cfg, device)
    web.run_app(build_app(api, max_concurrency=cfg.max_concurrency), host=cfg.host,
                port=cfg.port)
