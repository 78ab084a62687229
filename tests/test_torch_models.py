"""Parity of the port's BERT encoders (stract_tpu_torch/models,
ranking/models/cross_encoder.py, ops/encoder.py) with the JAX package's on
the CPU, at BertConfig.tiny() with seeded inputs: the JAX models are made
with their own random_init and save, and the port loads those files.
The encoder kernels themselves (K5a-c) are held against these twins on a
card in test_torch_kernels.py.

Tolerances, and why:
  - both packages compute in bf16 with f32 sums, but round at other places
    (XLA may keep a fused elementwise chain in f32; torch's CPU bf16 matmul
    and XLA's dot sum in other orders), so hidden states differ by a few
    bf16 steps. Pooled, L2-normalised embeddings: cosine >= 0.999 and max
    abs <= 2e-2 per row. Sigmoid scores: atol 1e-2.
  - single modules (one attention, one layer): max abs <= 3 bf16 steps of
    the output's magnitude (atol 4e-2 on values of order 1).
  - parameters: exact (a renaming and a transpose; bf16 rounding is RNE in
    both).
"""

from __future__ import annotations

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stract_tpu.models import bert as JB
from stract_tpu.models import wordpiece as JW
from stract_tpu.models.dual_encoder import DualEncoder as JaxDual
from stract_tpu.ranking.models.cross_encoder import CrossEncoderModel as JaxCross
from stract_tpu_torch.models import bert as TB
from stract_tpu_torch.models import store as TS
from stract_tpu_torch.models import wordpiece as TW
from stract_tpu_torch.models.dual_encoder import DualEncoder
from stract_tpu_torch.ops import encoder as E
from stract_tpu_torch.ranking.models.cross_encoder import CrossEncoderModel

TEXTS = ["the quick brown fox", "jumps over the lazy dog", "", "fox",
         "a much longer sentence about brown dogs and quick foxes in the park " * 3,
         "lazy", "the the the", "über naïve café"]
PAIRS = [("quick fox", t) for t in TEXTS] + [("", ""), ("dog", "the lazy dog sleeps")]
EMB_COS, EMB_ATOL, SCORE_ATOL, MODULE_ATOL = 0.999, 2e-2, 1e-2, 4e-2


def _tokenizer():
    return JW.WordPieceTokenizer.build(TEXTS * 3, vocab_size=JB.BertConfig.tiny().vocab_size)


def _unboxed(params):
    """A flax tree as numpy f32 (bf16 leaves widen exactly)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), nn.meta.unbox(params))


@pytest.fixture(scope="module")
def dual_dirs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dual"))
    jd = JaxDual.random_init(JB.BertConfig.tiny(), _tokenizer(), seed=3)
    jd.save(path)
    return jd, path


def test_dual_encoder_matches_jax(dual_dirs):
    jd, path = dual_dirs
    pd = DualEncoder.load(path, device="cpu")
    ej, ep = jd.embed(TEXTS), pd.embed(TEXTS)
    assert ep.shape == ej.shape == (len(TEXTS), 64) and ep.dtype == np.float32
    cos = (ej * ep).sum(1) / (np.linalg.norm(ej, axis=1) * np.linalg.norm(ep, axis=1))
    assert cos.min() >= EMB_COS, cos
    assert np.abs(ej - ep).max() <= EMB_ATOL
    np.testing.assert_allclose(np.linalg.norm(ep, axis=1), 1.0, atol=1e-5)
    f16 = pd.embed_async(TEXTS[:3], out_dtype=np.float16)()
    assert f16.dtype == np.float16 and f16.shape == (3, 64)
    assert pd.embed([]).shape == (0, 64)


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_cross_encoder_matches_jax(tmp_path, pool):
    cfg = JB.BertConfig.tiny(score_pool=pool)
    jc = JaxCross.random_init(cfg, _tokenizer(), seed=5)
    jc.save(str(tmp_path))
    pc = CrossEncoderModel.load(str(tmp_path), device="cpu")
    assert pc.cfg.score_pool == pool
    sj, sp = jc.score_pairs(PAIRS), pc.score_pairs(PAIRS)
    assert sp.shape == (len(PAIRS),) and sp.dtype == np.float32
    np.testing.assert_allclose(sp, sj, atol=SCORE_ATOL)
    assert ((sp > 0) & (sp < 1)).all()
    assert pc.score_pairs([]).shape == (0,)


def test_params_from_jax_is_the_flax_tree(dual_dirs):
    """Every flax leaf lands in the port's state_dict, transposed where flax
    keeps [in, out]; the msgpack decoder reads what flax wrote."""
    jd, path = dual_dirs
    tree = _unboxed(jd.params)
    sd = TB.params_from_jax(tree)
    model = TB.BertForEmbedding(TB.BertConfig.tiny())
    assert set(sd) == set(model.state_dict())
    p = tree["params"]["bert"]
    np.testing.assert_array_equal(sd["bert.layer_1.attention.query.weight"].numpy(),
                                  p["layer_1"]["attention"]["query"]["kernel"].T)
    np.testing.assert_array_equal(sd["bert.emb_ln.weight"].numpy(), p["emb_ln"]["scale"])
    np.testing.assert_array_equal(sd["bert.word_embeddings.weight"].numpy(),
                                  p["word_embeddings"]["embedding"])
    with open(os.path.join(path, "params.msgpack"), "rb") as fh:
        decoded = TB.params_from_jax(TS.read_flax_msgpack(fh.read()))
    assert all(torch.equal(decoded[k], sd[k]) for k in sd)
    back = TB.params_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for k, v in flat_a:
        np.testing.assert_array_equal(flat_b[k], v)


def test_port_save_loads_in_jax(tmp_path):
    """A checkpoint the port writes is one the JAX package loads."""
    pd = DualEncoder.random_init(TB.BertConfig.tiny(), _tokenizer(), seed=9, device="cpu")
    pd.save(str(tmp_path))
    jd = JaxDual.load(str(tmp_path))
    ej, ep = jd.embed(TEXTS), pd.embed(TEXTS)
    assert ((ej * ep).sum(1)).min() >= EMB_COS


def test_bfloat16_leaves_decode(tmp_path):
    """A flax tree may hold bfloat16 arrays: they decode through torch."""
    from flax import serialization

    w = np.asarray(jnp.linspace(-2, 2, 12, dtype=jnp.bfloat16).reshape(3, 4))
    data = serialization.to_bytes({"a": {"kernel": w, "n": np.arange(3, dtype=np.int32)}})
    tree = TS.read_flax_msgpack(data)
    assert tree["a"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["a"]["kernel"].float().numpy(), w.astype(np.float32))
    np.testing.assert_array_equal(tree["a"]["n"], np.arange(3))


def _hf_tensors(tree: dict, head: bool) -> dict:
    p = tree["params"]["bert"]
    out = {"bert.embeddings.word_embeddings.weight": p["word_embeddings"]["embedding"],
           "bert.embeddings.position_embeddings.weight": p["position_embeddings"]["embedding"],
           "bert.embeddings.token_type_embeddings.weight": p["token_type_embeddings"]["embedding"],
           "bert.embeddings.LayerNorm.weight": p["emb_ln"]["scale"],
           "bert.embeddings.LayerNorm.bias": p["emb_ln"]["bias"]}
    names = {"attention.self.query": ("attention", "query"),
             "attention.self.key": ("attention", "key"),
             "attention.self.value": ("attention", "value"),
             "attention.output.dense": ("attention", "out"),
             "intermediate.dense": ("mlp_in",), "output.dense": ("mlp_out",)}
    for i in range(2):
        layer = p[f"layer_{i}"]
        for hf, path in names.items():
            node = layer
            for k in path:
                node = node[k]
            out[f"bert.encoder.layer.{i}.{hf}.weight"] = node["kernel"].T.copy()
            out[f"bert.encoder.layer.{i}.{hf}.bias"] = node["bias"]
        for hf, ln in (("attention.output.LayerNorm", "attn_ln"), ("output.LayerNorm", "mlp_ln")):
            out[f"bert.encoder.layer.{i}.{hf}.weight"] = layer[ln]["scale"]
            out[f"bert.encoder.layer.{i}.{hf}.bias"] = layer[ln]["bias"]
    if head:
        out["classifier.weight"] = tree["params"]["score"]["kernel"].T.copy()
        out["classifier.bias"] = tree["params"]["score"]["bias"]
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["dual", "cross"])
def test_hf_safetensors_loads_like_jax(tmp_path, kind):
    """An HF dir written with the safetensors package loads the same
    through the JAX loader and through the port's own parser."""
    from safetensors.numpy import save_file

    cfg = JB.BertConfig.tiny()
    jax_cls = JaxDual if kind == "dual" else JaxCross
    src = jax_cls.random_init(cfg, _tokenizer(), seed=13)
    save_file(_hf_tensors(_unboxed(src.params), kind == "cross"),
              str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as fh:
        json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "type_vocab_size": 2}, fh)
    with open(tmp_path / "vocab.txt", "w") as fh:
        for piece, _ in sorted(src.tokenizer.vocab.items(), key=lambda kv: kv[1]):
            fh.write(piece + "\n")
    jm = jax_cls.load(str(tmp_path))
    _, sd, _, max_len = TS.load_encoder(str(tmp_path), kind)
    assert max_len == cfg.max_position_embeddings
    # the JAX loader rounds matrices to bf16 as it reads, the port in
    # load_state_dict: the loaded modules hold the same values
    module = TB.BertForEmbedding if kind == "dual" else TB.BertForSequenceScore
    mine, ref = module(TB.BertConfig.tiny()), module(TB.BertConfig.tiny())
    mine.load_state_dict(sd)
    ref.load_state_dict(TB.params_from_jax(_unboxed(jm.params)))
    for k, v in ref.state_dict().items():
        assert torch.equal(mine.state_dict()[k], v), k
    if kind == "dual":
        pm = DualEncoder.load(str(tmp_path), device="cpu")
        assert ((jm.embed(TEXTS) * pm.embed(TEXTS)).sum(1)).min() >= EMB_COS
    else:
        pm = CrossEncoderModel.load(str(tmp_path), device="cpu")
        np.testing.assert_allclose(pm.score_pairs(PAIRS), jm.score_pairs(PAIRS), atol=SCORE_ATOL)


def test_interrupted_save_leaves_no_config(tmp_path, monkeypatch):
    """config.json comes last, by rename: a save cut short before the rename
    leaves no config.json, so the directory is never taken for a checkpoint."""
    pd = DualEncoder.random_init(TB.BertConfig.tiny(), _tokenizer(), seed=1, device="cpu")

    def killed(*a, **k):
        raise KeyboardInterrupt("killed before the rename")
    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        pd.save(str(tmp_path / "enc"))
    assert not os.path.exists(tmp_path / "enc" / "config.json")
    assert os.path.exists(tmp_path / "enc" / "params.msgpack")
    monkeypatch.undo()
    pd.save(str(tmp_path / "enc"))
    assert DualEncoder.load(str(tmp_path / "enc"), device="cpu").embed(TEXTS[:2]).shape == (2, 64)


def test_trim_to_bucket_and_tokenizer_match_jax():
    jt, pt = _tokenizer(), TW.WordPieceTokenizer.build(TEXTS * 3, vocab_size=1024)
    assert jt.vocab == pt.vocab
    for max_len in (16, 128):
        for batch in (TEXTS, PAIRS):
            a, b = jt.encode_batch(batch, max_len), pt.encode_batch(batch, max_len)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            for x, y in zip(JW.trim_to_bucket(*a), TW.trim_to_bucket(*b)):
                np.testing.assert_array_equal(x, y)
    empty = np.zeros((0, 32), np.int32)
    assert TW.trim_to_bucket(empty, empty, empty)[0].shape == (0, 16)


def _layer_inputs(rng, B=3, T=12, H=64):
    x = rng.normal(size=(B, T, H)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    mask[2, :] = 0  # a fully masked row: uniform weights, finite output
    return x, mask


@pytest.mark.parametrize("module", ["attention", "layer"])
def test_modules_match_flax(module):
    """One BertSelfAttention (K5a's plain twin between the projections) and
    one BertLayer (K5a-c) against flax's on the same bf16 input and weights."""
    cfg_j, cfg_t = JB.BertConfig.tiny(), TB.BertConfig.tiny()
    x, mask = _layer_inputs(np.random.default_rng(21))
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    jmod = JB.BertSelfAttention(cfg_j) if module == "attention" else JB.BertLayer(cfg_j)
    params = jmod.init(jax.random.PRNGKey(4), xj, jnp.asarray(mask, bool))
    yj = np.asarray(jmod.apply(params, xj, jnp.asarray(mask, bool)).astype(jnp.float32))
    tmod = TB.BertSelfAttention(cfg_t) if module == "attention" else TB.BertLayer(cfg_t)
    tmod.load_state_dict(TB.params_from_jax(_unboxed(params)))
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)).float().numpy()
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, atol=MODULE_ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 65, 200])
def test_plain_attention_matches_flax_at_tile_tails(T):
    """K5a's plain twin, between the projections of one BertSelfAttention,
    against flax's at the tails of the kernel's 64-row tiles (T = 1, 65,
    200), with a half, a fully and a tail masked row; and the twin alone
    against the reference's body written in jnp."""
    cfg_j, cfg_t = JB.BertConfig.tiny(), TB.BertConfig.tiny()
    rng = np.random.default_rng(T)
    x = rng.normal(size=(4, T, 64)).astype(np.float32)
    mask = np.ones((4, T), np.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask[3, T - max(1, T // 5):] = 0
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    jmod = JB.BertSelfAttention(cfg_j)
    params = jmod.init(jax.random.PRNGKey(T), xj, jnp.asarray(mask, bool))
    yj = np.asarray(jmod.apply(params, xj, jnp.asarray(mask, bool)).astype(jnp.float32))
    tmod = TB.BertSelfAttention(cfg_t)
    tmod.load_state_dict(TB.params_from_jax(_unboxed(params)))
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)).float().numpy()
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, atol=MODULE_ATOL, rtol=0)

    q, k, v = (rng.normal(size=(4, T, 3, 32)).astype(np.float32) for _ in range(3))
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    sc = jnp.einsum("bthd,bshd->bhts", qj, kj, preferred_element_type=jnp.float32) / np.sqrt(32)
    sc = jnp.where(jnp.asarray(mask, bool)[:, None, None, :], sc, jnp.finfo(jnp.float32).min)
    ctx = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(sc, -1).astype(jnp.bfloat16), vj,
                     preferred_element_type=jnp.float32).astype(jnp.bfloat16).reshape(4, T, 96)
    bt = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = E.attention_plain(bt(q), bt(k), bt(v), torch.from_numpy(mask)).float().numpy()
    np.testing.assert_allclose(got, np.asarray(ctx, np.float32), atol=2e-2)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("T", [257, 512])
@pytest.mark.parametrize("hidden,heads", [(64, 4), (128, 2)])
def test_attention_twin_matches_flax_at_other_head_dims(hidden, heads, T):
    """K5a's plain twin inside one BertSelfAttention at head dim 16 (hidden
    64 / 4 heads, BertConfig.tiny's) and 64 (hidden 128 / 2 heads, BERT-base's
    head), past the 256 tokens of the one-pass kernels and at 512 (the
    reference's last position), against flax's; rows half, fully and tail
    masked."""
    cfg_j = JB.BertConfig.tiny(hidden_size=hidden, num_heads=heads)
    cfg_t = TB.BertConfig.tiny(hidden_size=hidden, num_heads=heads)
    rng = np.random.default_rng(T + hidden)
    x = rng.normal(size=(4, T, hidden)).astype(np.float32)
    mask = np.ones((4, T), np.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask[3, T - T // 5:] = 0
    xj = jnp.asarray(x, dtype=jnp.bfloat16)
    jmod = JB.BertSelfAttention(cfg_j)
    params = jmod.init(jax.random.PRNGKey(T), xj, jnp.asarray(mask, bool))
    yj = np.asarray(jmod.apply(params, xj, jnp.asarray(mask, bool)).astype(jnp.float32))
    tmod = TB.BertSelfAttention(cfg_t)
    tmod.load_state_dict(TB.params_from_jax(_unboxed(params)))
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)).float().numpy()
    assert yt.shape == yj.shape == (4, T, hidden) and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, atol=MODULE_ATOL, rtol=0)


def test_bert_encoder_clamps_positions_past_the_table_as_jax():
    """BertEncoder at T = 520 over a 512-row position table: tokens 511 .. 519
    all take position 511, as the reference's jnp.minimum clamps them
    (bert.py:194); the port's hidden states against flax's, a half-padded
    row included, at the single modules' tolerance (two layers at
    BertConfig.tiny differ by one bf16 step at most)."""
    cfg_j = JB.BertConfig.tiny(max_position_embeddings=512)
    cfg_t = TB.BertConfig.tiny(max_position_embeddings=512)
    rng = np.random.default_rng(520)
    ids = rng.integers(5, cfg_j.vocab_size, size=(2, 520)).astype(np.int32)
    mask = np.ones((2, 520), np.int32)
    mask[1, 260:] = 0
    jmod = JB.BertEncoder(cfg_j)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(ids), jnp.asarray(mask))
    yj = np.asarray(jmod.apply(params, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))
    tmod = TB.BertEncoder(cfg_t)
    tmod.load_state_dict(TB.params_from_jax(_unboxed(params)))
    with torch.no_grad():
        yt = tmod(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert yt.shape == yj.shape == (2, 520, cfg_t.hidden_size) and np.isfinite(yt).all()
    np.testing.assert_allclose(yt, yj, atol=MODULE_ATOL, rtol=0)
    # the clamp: tokens past 511 see position 511's row, so equal ids there
    # give equal embeddings
    table = tmod.position_embeddings.weight
    pos = torch.arange(520).clamp_max(511)
    assert torch.equal(table[pos][511:], table[511].expand(9, -1))


def test_plain_twins_follow_the_reference_formulas():
    """The three plain twins against jnp written after bert.py: attention
    with a fully masked row, LN of a bf16 sum, tanh GELU with bf16 constants."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 9, 3, 32)).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 9), np.int32)
    mask[1] = 0
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    s = jnp.einsum("bthd,bshd->bhts", qj, kj, preferred_element_type=jnp.float32) / np.sqrt(32)
    s = jnp.where(jnp.asarray(mask, bool)[:, None, None, :], s, jnp.finfo(jnp.float32).min)
    ctx = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, -1).astype(jnp.bfloat16), vj,
                     preferred_element_type=jnp.float32).astype(jnp.bfloat16).reshape(2, 9, 96)
    bt = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = E.attention(bt(q), bt(k), bt(v), torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ctx, np.float32), atol=2e-2)
    # the fully masked row averages V uniformly
    np.testing.assert_allclose(got[1].float().numpy(),
                               np.broadcast_to(bt(v)[1].float().mean(0).reshape(1, 96), (9, 96)),
                               atol=2e-2)

    x, r = (rng.normal(size=(5, 384)).astype(np.float32) for _ in range(2))
    w, b = rng.normal(size=384).astype(np.float32), rng.normal(size=384).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12, dtype=jnp.float32)
    ref = ln.apply({"params": {"scale": w, "bias": b}},
                   jnp.asarray(x, jnp.bfloat16) + jnp.asarray(r, jnp.bfloat16))
    got = E.add_layernorm(bt(x), bt(r), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.bfloat16), np.float32), atol=3e-2)

    y, bias = rng.normal(size=(4, 1536)).astype(np.float32), rng.normal(size=1536).astype(np.float32)
    ref = jax.nn.gelu(jnp.asarray(y, jnp.bfloat16) + jnp.asarray(bias, jnp.bfloat16))
    got = E.bias_gelu(bt(y), bt(bias))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)
