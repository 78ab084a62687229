"""Encoder checkpoint store — the port of stract_tpu/models/store.py: save
and load the dual- and cross-encoder models as self-contained directories,
in the JAX package's layout, so either package reads what the other wrote.

Layout:
    <path>/vocab.txt       one wordpiece per line, line number = id
    <path>/params.msgpack  the flax param tree as flax.serialization.to_bytes
                           writes it (msgpack; each array an ext of code 1
                           holding (shape, dtype name, raw bytes))
    <path>/config.json     BertConfig fields + {"max_len", "kind"}
or an HF-style dir holding model.safetensors + config.json (HF field names)
+ vocab.txt.

flax's msgpack and the safetensors format are decoded here, with msgpack
and torch alone: neither flax nor the safetensors package is needed.
`save_encoder` writes config.json last, through a temp file and a rename,
so a save cut short leaves a directory without config.json, which no
loader or rebuild guard takes for a checkpoint.
"""

from __future__ import annotations

import json
import os

import msgpack
import numpy as np
import torch

from .bert import BertConfig, load_hf_safetensors, params_from_jax, params_to_jax
from .wordpiece import WordPieceTokenizer

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _array_from_ext(data: bytes):
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: decode with torch
        t = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf else \
            torch.zeros(0, dtype=torch.bfloat16)
        return t.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_ext(data)
    if code == _EXT_NPSCALAR:
        return _array_from_ext(data)[()]
    raise ValueError(f"unsupported msgpack ext code {code} in a flax checkpoint")


def _check_tree(node) -> None:
    for v in node.values():
        if isinstance(v, dict):
            if "__msgpack_chunked_array__" in v:
                raise ValueError("chunked (>1 GiB) arrays in a flax checkpoint are not supported")
            _check_tree(v)


def read_flax_msgpack(data: bytes) -> dict:
    """flax.serialization.to_bytes output → nested dict of numpy arrays
    (bfloat16 leaves as torch tensors)."""
    tree = msgpack.unpackb(data, ext_hook=_ext_hook, raw=False, strict_map_key=False)
    _check_tree(tree)
    return tree


def write_flax_msgpack(tree: dict) -> bytes:
    """A nested dict of numpy arrays → bytes that flax.serialization.from_bytes reads."""
    def ext(x):
        if isinstance(x, np.ndarray):
            a = np.ascontiguousarray(x)
            return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
                (a.shape, a.dtype.name, a.tobytes("C")), use_bin_type=True))
        raise TypeError(f"cannot serialise {type(x)}")
    return msgpack.packb(tree, default=ext, strict_types=True)


def save_encoder(path: str, cfg: BertConfig, state_dict: dict, tokenizer: WordPieceTokenizer,
                 max_len: int, kind: str) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        for piece, _ in sorted(tokenizer.vocab.items(), key=lambda kv: kv[1]):
            fh.write(piece + "\n")
    with open(os.path.join(path, "params.msgpack"), "wb") as fh:
        fh.write(write_flax_msgpack(params_to_jax(state_dict)))
    meta = cfg.to_json()
    meta["max_len"] = int(max_len)
    meta["kind"] = kind
    cfg_path = os.path.join(path, "config.json")
    tmp = f"{cfg_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1)
    os.replace(tmp, cfg_path)


def load_encoder(path: str, kind: str):
    """→ (cfg, state_dict, tokenizer, max_len). An HF safetensors dir
    (model.safetensors present) loads through load_hf_safetensors."""
    tok = WordPieceTokenizer.from_vocab_file(os.path.join(path, "vocab.txt"))
    with open(os.path.join(path, "config.json")) as fh:
        meta = json.load(fh)

    if os.path.exists(os.path.join(path, "model.safetensors")):
        cfg = BertConfig(
            vocab_size=meta["vocab_size"],
            hidden_size=meta["hidden_size"],
            num_layers=meta.get("num_hidden_layers", meta.get("num_layers", 12)),
            num_heads=meta.get("num_attention_heads", meta.get("num_heads", 12)),
            intermediate_size=meta["intermediate_size"],
            max_position_embeddings=meta["max_position_embeddings"],
            type_vocab_size=meta.get("type_vocab_size", 2),
        )
        head = "score" if kind == "cross" else None
        sd = load_hf_safetensors(os.path.join(path, "model.safetensors"), cfg, head=head)
        return cfg, sd, tok, min(cfg.max_position_embeddings, 512)

    if meta.get("kind") not in (None, kind):
        raise ValueError(f"{path} holds a {meta['kind']!r} encoder, wanted {kind!r}")
    cfg = BertConfig.from_json(meta)
    with open(os.path.join(path, "params.msgpack"), "rb") as fh:
        sd = params_from_jax(read_flax_msgpack(fh.read()))
    return cfg, sd, tok, int(meta.get("max_len", 128))
