"""BERT on torch — the port of stract_tpu/models/bert.py (the neural
reranker backbone: embeddings + encoder, a mean-pooled embedding head for
the dual encoder and a score head for the cross encoder).

Numerics follow the JAX package (flax, bf16 compute, f32 params). Two
forms: the serving modules (the default) store the projection and embedding
weights in bf16, rounded once from the f32 checkpoint (the round-to-nearest-
even cast flax applies at every call); the training form
(`param_dtype=torch.float32`) holds them as f32 masters and casts them to
bf16 at every call, as flax does, so each master's gradient is the bf16
cotangent widened to f32. Both compute the same numbers. LayerNorm
parameters and the score head stay f32 in both. The projections are bf16
`F.linear` products; attention, residual + LayerNorm, bias + GELU and the
mean pool go through ops/encoder.py (K5a-d and their gradients K14a-c:
kernels on a card, plain twins on the CPU).

Parameter names mirror the flax tree ("bert.layer_0.attention.query.weight"
for params/bert/layer_0/attention/query/kernel), so `params_from_jax` and
`params_to_jax` are a renaming plus the [in, out] ↔ [out, in] transpose.

`num_experts > 0` (BertLayer, BertEncoder, BertForSequenceScore) swaps each
layer's FFN for the MoE FFN (MoEMlp, the JAX package's expert-parallel block
run on one card): an f32 top-1 router and E experts whose weights are bf16
parameters in both forms, as the JAX package creates them ("moe.experts_in"
[E, H, I] and "moe.experts_out" [E, I, H], stored untransposed; the router
is a Dense like the others).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import encoder as E
from ..ops import moe as M

BF16 = torch.bfloat16


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    # cross-encoder score readout: "cls" (the first token) or "mean" (masked
    # mean pool)
    score_pool: str = "cls"

    @classmethod
    def tiny(cls, **kw):
        """2-layer test config."""
        d = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=128, type_vocab_size=2)
        d.update(kw)
        return cls(**d)

    @classmethod
    def mini_lm(cls, **kw):
        """MiniLM-L6 (the usual dual-encoder size)."""
        d = dict(hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536)
        d.update(kw)
        return cls(**d)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "BertConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in fields})
        if cfg.dtype != "bfloat16":
            raise ValueError(f"the port's encoder computes in bfloat16, not {cfg.dtype}")
        return cfg


class LayerNorm(nn.Module):
    """f32 scale and bias of a LayerNorm; `forward(x, r)` normalises bf16(x + r)."""

    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.eps = eps

    def forward(self, x, r):
        return E.add_layernorm(x, r, self.weight, self.bias, self.eps)


def _bf16(p: torch.Tensor) -> torch.Tensor:
    """A parameter as the bf16 value flax computes with: the cast of an f32
    master (differentiable, so its gradient is the bf16 one widened), the
    parameter itself when it is stored in bf16."""
    return p.to(BF16)


def _linear(x, m: nn.Linear, bias: bool = True):
    return F.linear(x, _bf16(m.weight), _bf16(m.bias) if bias else None)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, param_dtype: torch.dtype = BF16):
        super().__init__()
        H = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query, self.key, self.value, self.out = (nn.Linear(H, H, dtype=param_dtype)
                                                      for _ in range(4))

    def forward(self, x, mask):
        B, T, H = x.shape
        shape = (B, T, self.num_heads, H // self.num_heads)
        q, k, v = (_linear(x, m).reshape(shape) for m in (self.query, self.key, self.value))
        ctx = E.attention(q, k, v, mask)
        return _linear(ctx, self.out)


class MoEMlp(nn.Module):
    """The MoE FFN (stract_tpu/models/bert.py MoEMlp): top-1 routing by an
    f32 router, dense dispatch (every expert computes every token), the
    token's expert output times its gate. bf16[B, T, H] → bf16[B, T, H].
    The router and the select-and-scale are K15a-b (ops/moe.py), the expert
    products bf16 cuBLAS products with f32 sums, the GELU K5c. The first
    product runs over all experts at once against the [H, E*I] view of
    experts_in, so x's cotangent is one f32 sum over (expert, unit) rounded
    once, as the reference's einsum."""

    def __init__(self, cfg: BertConfig, num_experts: int):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.num_experts = num_experts
        self.router = nn.Linear(H, num_experts, dtype=torch.float32)
        self.experts_in = nn.Parameter(torch.zeros((num_experts, H, I), dtype=BF16))
        self.experts_out = nn.Parameter(torch.zeros((num_experts, I, H), dtype=BF16))

    def forward(self, x):
        B, T, H = x.shape
        Ex, I = self.num_experts, self.experts_in.shape[2]
        xf = x.reshape(B * T, H)
        top, gate = M.router(xf, self.router.weight, self.router.bias)
        w_in = self.experts_in.permute(1, 0, 2).reshape(H, Ex * I)
        h = (xf @ w_in).view(B * T, Ex, I).transpose(0, 1).contiguous()
        h = E.bias_gelu(h, torch.zeros(I, dtype=BF16, device=x.device))
        out = torch.bmm(h, self.experts_out)  # [E, N, H]
        return M.select_scale(out, top, gate).view(B, T, H)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, param_dtype: torch.dtype = BF16, num_experts: int = 0):
        super().__init__()
        self.attention = BertSelfAttention(cfg, param_dtype)
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        if num_experts:
            self.moe = MoEMlp(cfg, num_experts)
        else:
            self.mlp_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=param_dtype)
            self.mlp_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=param_dtype)
        self.mlp_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = self.attn_ln(x, self.attention(x, mask))
        if hasattr(self, "moe"):
            return self.mlp_ln(x, self.moe(x))
        h = E.bias_gelu(_linear(x, self.mlp_in, bias=False), _bf16(self.mlp_in.bias))
        return self.mlp_ln(x, _linear(h, self.mlp_out))


class BertEncoder(nn.Module):
    """Embeddings + transformer stack → final hidden states bf16[B, T, H].
    `param_dtype` is the storage of the projection and embedding weights:
    bf16 to serve, float32 to train (f32 masters, cast per call);
    `num_experts` > 0 gives every layer the MoE FFN."""

    def __init__(self, cfg: BertConfig, param_dtype: torch.dtype = BF16, num_experts: int = 0):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H, dtype=param_dtype)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H,
                                                dtype=param_dtype)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H, dtype=param_dtype)
        self.emb_ln = LayerNorm(H, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, param_dtype, num_experts))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        c = self.cfg
        B, T = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(T, device=input_ids.device).clamp_max(
            c.max_position_embeddings - 1)
        word = F.embedding(input_ids, _bf16(self.word_embeddings.weight))
        pos = F.embedding(pos_ids, _bf16(self.position_embeddings.weight))[None]
        typ = F.embedding(token_type_ids, _bf16(self.token_type_embeddings.weight))
        # (word + pos) + typ: the reference's bf16 rounding order
        x = self.emb_ln(word + pos, typ)
        mask = attention_mask.to(torch.int32).contiguous()
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x


class BertForEmbedding(nn.Module):
    """Mean-pooled, L2-normalised sentence embedding → f32[B, H] (K5d)."""

    def __init__(self, cfg: BertConfig, normalize: bool = True,
                 param_dtype: torch.dtype = BF16):
        super().__init__()
        self.bert = BertEncoder(cfg, param_dtype)
        self.normalize = normalize

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        h = self.bert(input_ids, attention_mask, token_type_ids)
        return E.mean_pool(h, attention_mask.to(torch.int32).contiguous(), self.normalize)


class BertForSequenceScore(nn.Module):
    """CLS (or masked mean, K5d) → f32 linear score head → f32[B] logits;
    `num_experts` > 0 swaps the FFNs for MoE blocks."""

    def __init__(self, cfg: BertConfig, param_dtype: torch.dtype = BF16, num_experts: int = 0):
        super().__init__()
        self.bert = BertEncoder(cfg, param_dtype, num_experts)
        self.score = nn.Linear(cfg.hidden_size, 1, dtype=torch.float32)
        self.pool = cfg.score_pool

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        h = self.bert(input_ids, attention_mask, token_type_ids)
        if self.pool == "mean":
            pooled = E.mean_pool(h, attention_mask.to(torch.int32).contiguous())
        else:
            pooled = h[:, 0, :].float()
        return F.linear(pooled, self.score.weight, self.score.bias)[:, 0]


# ---- parameters ---------------------------------------------------------------------------
def random_init(model: nn.Module, seed: int) -> nn.Module:
    """Random weights in place: normal(0.02) for every matrix, embedding
    table and expert tensor (drawn in f32 from an explicit generator, then
    rounded once to the parameter's dtype: bf16 for the experts), zero
    biases, LayerNorm scale 1 and bias 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_ln.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32).normal_(0.0, 0.02, generator=g))
    return model


# the MoE expert tensors: flax params of their own name, not transposed
_EXPERT_LEAVES = ("experts_in", "experts_out")


def _flax_leaf(name: str) -> tuple:
    """Port parameter name → (flax path, transpose?)."""
    *parent, leaf = name.split(".")
    if leaf in _EXPERT_LEAVES:
        return (*parent, leaf), False
    if leaf == "bias":
        return (*parent, "bias"), False
    if parent[-1].endswith("_ln"):
        return (*parent, "scale"), False
    if parent[-1].endswith("_embeddings"):
        return (*parent, "embedding"), False
    return (*parent, "kernel"), True


def params_from_jax(tree) -> dict:
    """The flax param tree (nested dicts of arrays, with or without the
    outer "params" key) → this module's state_dict: kernels [in, out] become
    weights [out, in], LayerNorm "scale" and Embed "embedding" become
    "weight"; the expert tensors keep their names and layout. Values keep
    their dtype, bf16 included (load_state_dict rounds into the module's)."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, (*path, k))
                continue
            t = v if isinstance(v, torch.Tensor) else _from_numpy(np.array(v))
            leaf = {"scale": "weight", "embedding": "weight", "kernel": "weight"}.get(k, k)
            out[".".join((*path, leaf))] = t.T.contiguous() if k == "kernel" else t
    walk(tree, ())
    return out


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (the JAX package's expert
    weights, an extension dtype numpy itself lacks) by their bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to_jax(state_dict: dict) -> dict:
    """The inverse of params_from_jax: {"params": nested dict of f32 numpy
    arrays} in flax's layout (what flax.serialization.to_bytes writes). The
    bf16 expert tensors come out as f32 arrays of the same values, exact."""
    tree: dict = {}
    for name, t in state_dict.items():
        path, transpose = _flax_leaf(name)
        a = t.detach().float().cpu()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (a.T if transpose else a).contiguous().numpy()
    return {"params": tree}


# ---- HF safetensors ---------------------------------------------------------------------
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32}


def read_safetensors(path: str) -> dict:
    """{name: tensor} from a .safetensors file, parsed here (an 8-byte
    little-endian header length, a JSON header of dtype / shape /
    data_offsets, then the raw little-endian tensors)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        if spec["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {spec['dtype']}")
        lo, hi = spec["data_offsets"]
        buf = bytearray(data[lo:hi])
        t = (torch.frombuffer(buf, dtype=_ST_DTYPES[spec["dtype"]]) if buf
             else torch.zeros(0, dtype=_ST_DTYPES[spec["dtype"]]))
        out[name] = t.reshape(spec["shape"])
    return out


def _hf_map(num_layers: int, head: str | None) -> dict:
    """HF BERT names (after a "bert." / "model." prefix is cut) → port names
    (the mapping of stract_tpu/models/bert.py:255-322, in torch layout)."""
    m = {"embeddings.word_embeddings.weight": "bert.word_embeddings.weight",
         "embeddings.position_embeddings.weight": "bert.position_embeddings.weight",
         "embeddings.token_type_embeddings.weight": "bert.token_type_embeddings.weight",
         "embeddings.LayerNorm.weight": "bert.emb_ln.weight",
         "embeddings.LayerNorm.bias": "bert.emb_ln.bias"}
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}.", f"bert.layer_{i}."
        for a, b in (("attention.self.query", "attention.query"),
                     ("attention.self.key", "attention.key"),
                     ("attention.self.value", "attention.value"),
                     ("attention.output.dense", "attention.out"),
                     ("intermediate.dense", "mlp_in"), ("output.dense", "mlp_out"),
                     ("attention.output.LayerNorm", "attn_ln"), ("output.LayerNorm", "mlp_ln")):
            for leaf in ("weight", "bias"):
                m[f"{src}{a}.{leaf}"] = f"{dst}{b}.{leaf}"
    if head == "score":
        m.update({"classifier.weight": "score.weight", "classifier.bias": "score.bias"})
    return m


def load_hf_safetensors(path: str, cfg: BertConfig, head: str | None = None) -> dict:
    """An HF bert safetensors file → this module's state_dict (f32 values).
    `head`: None, or "score" for a cross encoder's classifier."""
    mapping = _hf_map(cfg.num_layers, head)
    out = {}
    for key, t in read_safetensors(path).items():
        k = key
        for prefix in ("bert.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k in mapping:
            out[mapping[k]] = t.float()
    return out

