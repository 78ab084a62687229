"""TOML config structs — the part of stract_tpu/config/__init__.py the
port's command line reads (role of reference crates/core/src/config/,
main.rs:267-275 load_toml_config): the centrality job's config, read from the
same TOML files (configs/centrality.toml)."""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, fields


def load_toml(path: str) -> dict:
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def _from_dict(cls, d: dict):
    known = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


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


CONFIG_TYPES = {"centrality": CentralityConfig}


def load_config(kind: str, path: str):
    return _from_dict(CONFIG_TYPES[kind], load_toml(path))
