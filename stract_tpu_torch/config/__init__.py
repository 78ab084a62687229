"""TOML config structs — the part of stract_tpu/config/__init__.py the
port's command line reads (role of reference crates/core/src/config/,
main.rs:267-275 load_toml_config): the coordinator's, the search shard's,
the entity search server's, the indexer's, the centrality job's, the
spell trainer's, the site-stats job's, the live-index shard's and the
crawl roles' configs, read from the same TOML
files (configs/api.toml, configs/search_server.toml, configs/indexer.toml,
configs/centrality.toml, a web-spell TOML: index_path, output_path; an
entity-search-server TOML: index_path, image_store_path, host, port,
[gossip]; a site-stats TOML: index_path, output_path,
host_centrality_path; a live-index TOML: path, shard, host, port, [gossip],
consistency_fraction; a crawler TOML: queue_path, discovered_path,
warc_output_dir, coordinator_addrs, router_addr; a webgraph-server TOML:
graph_path, shard, host, port, [gossip]; a webgraph TOML: warc_paths,
output_path, level; an ampc TOML: every role's fields in one struct)."""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field, fields


def load_toml(path: str) -> dict:
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def _from_dict(cls, d: dict):
    known = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class GossipConfig:
    addr: str = "127.0.0.1:0"
    seeds: list = field(default_factory=list)

    def addr_tuple(self):
        h, p = self.addr.rsplit(":", 1)
        return (h, int(p))

    def seed_tuples(self):
        return [(s.rsplit(":", 1)[0], int(s.rsplit(":", 1)[1])) for s in self.seeds]


@dataclass
class ApiConfig:
    host: str = "0.0.0.0"
    port: int = 3000
    gossip: dict = field(default_factory=dict)
    bangs_path: str = ""
    autosuggest_path: str = ""
    spell_path: str = ""
    entity_index_path: str = ""
    host_graph_path: str = ""
    page_graph_path: str = ""
    entity_image_store_path: str = ""
    lambdamart_path: str = ""
    dual_encoder_path: str = ""
    cross_encoder_path: str = ""
    max_concurrency: int = 64
    improvement_log_path: str = ""


@dataclass
class SearchServerConfig:
    index_path: str = "data/index"
    shard: int = 0
    host: str = "127.0.0.1"
    port: int = 0
    gossip: dict = field(default_factory=dict)
    linear_model_path: str = ""
    max_docs_considered: int = 1000
    # "auto": the mesh path when this process sees more than one card
    # (parallel/search.py); "off": the per-segment path
    mesh_search: str = "auto"


@dataclass
class WebgraphServerConfig:
    graph_path: str = "data/webgraph"
    shard: int = 0
    host: str = "127.0.0.1"
    port: int = 0
    gossip: dict = field(default_factory=dict)


@dataclass
class LiveIndexConfig:
    path: str = "data/live"
    shard: int = 0
    host: str = "127.0.0.1"
    port: int = 0
    gossip: dict = field(default_factory=dict)
    consistency_fraction: float = 0.5


@dataclass
class IndexerConfig:
    warc_paths: list = field(default_factory=list)
    output_path: str = "data/index"
    host_centrality_path: str = ""
    page_centrality_path: str = ""
    safety_model_path: str = ""
    dual_encoder_path: str = ""
    embedding_dim: int = 0
    merge: bool = True
    # `indexer entity` (entrypoint/entity.rs) / `indexer canonical` (canonical.rs)
    zim_path: str = ""
    entity_limit: int = 0


@dataclass
class WebgraphConstructConfig:
    warc_paths: list = field(default_factory=list)
    output_path: str = "data/webgraph"
    level: str = "host"  # host | page


@dataclass
class CentralityConfig:
    webgraph_path: str = "data/webgraph"
    output_path: str = "data/centrality"
    mode: str = "harmonic"  # harmonic | approx-harmonic | harmonic-nearest-seed
    precision: int = 6
    num_samples: int = 256
    # harmonic-nearest-seed (entrypoint/centrality.rs:126)
    original_centrality_path: str = ""
    discount_factor: float = 0.85


@dataclass
class WebSpellConfig:
    index_path: str = "data/index"
    output_path: str = "data/web_spell"


@dataclass
class EntitySearchServerConfig:
    """(role of reference config::EntitySearchServerConfig)"""

    index_path: str = "data/entity"
    image_store_path: str = ""
    host: str = "127.0.0.1"
    port: int = 0
    gossip: dict = field(default_factory=dict)


@dataclass
class CrawlerConfig:
    queue_path: str = "data/crawl/jobs"
    discovered_path: str = "data/crawl/discovered"
    warc_output_dir: str = "data/crawl/warc"
    coordinator_addrs: list = field(default_factory=list)
    router_addr: str = ""
    politeness_delay: float = 1.0
    num_worker_threads: int = 4


@dataclass
class SiteStatsConfig:
    """(role of reference config::SiteStatsConfig, entrypoint/site_stats.rs)"""

    index_path: str = "data/index"
    output_path: str = "data/site_stats"
    host_centrality_path: str = ""


@dataclass
class AmpcConfig:
    """One struct for every `ampc` role (role of reference config::ampc::*);
    each role reads the subset of fields it needs."""

    webgraph_path: str = "data/webgraph"
    shard: int = 0
    num_shards: int = 1
    precision: int = 6
    num_samples: int = 16
    seed: int = 0
    source: str = ""            # shortest-path source node
    output_path: str = ""
    host: str = "127.0.0.1"
    port: int = 0
    node_id: int = 0
    peers: list = field(default_factory=list)  # raft replica addrs (dht role)
    gossip: dict = field(default_factory=dict)
    wait_s: float = 30.0


CONFIG_TYPES = {"api": ApiConfig, "search-server": SearchServerConfig,
                "webgraph-server": WebgraphServerConfig,
                "entity-search-server": EntitySearchServerConfig, "live-index": LiveIndexConfig,
                "indexer": IndexerConfig, "webgraph": WebgraphConstructConfig,
                "centrality": CentralityConfig, "crawler": CrawlerConfig,
                "web-spell": WebSpellConfig, "site-stats": SiteStatsConfig, "ampc": AmpcConfig}


def load_config(kind: str, path: str):
    return _from_dict(CONFIG_TYPES[kind], load_toml(path))
