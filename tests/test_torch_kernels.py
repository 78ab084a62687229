"""The ranking pipeline's kernels against their plain twins: K4 (forest
walk, ops/forest.py) and K5a-c (attention, residual + LayerNorm, bias +
GELU, ops/encoder.py). This file imports the port alone (no jax, no flax),
so it also runs on a machine with a card and no JAX package:

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Tests marked `cuda` skip without a card. The others run here: the dispatch
keys on where a tensor lies, and every wrapper checks its arguments before
any build or launch.

Tolerances, kernel against plain twin on one card:
  - forest: rtol 1e-6, atol 1e-6 x the sum over trees of max |leaf| (the same
    leaves; the tree sum taken in another order);
  - attention, LayerNorm, GELU: bf16 outputs within one bf16 step (rtol 2^-7)
    plus atol 1e-2 (2e-2 for attention): f32 sums in another order and
    exp / rsqrt / tanh in another implementation can move a value across a
    rounding boundary of the final bf16 cast;
  - the whole MiniLM-shaped dual encoder, card against CPU: cosine >= 0.999.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stract_tpu_torch.models.bert import BertConfig
from stract_tpu_torch.models.dual_encoder import DualEncoder
from stract_tpu_torch.models.wordpiece import WordPieceTokenizer
from stract_tpu_torch.ops import encoder as E
from stract_tpu_torch.ops import forest as forest_ops
from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

ENC_RTOL, ENC_ATOL = 2 ** -7, 1e-2
TEXTS = ["the quick brown fox", "jumps over the lazy dog", "", "fox " * 40]


def _forest(rng) -> LambdaMART:
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = 2 * x[:, 0] + x[:, 5] * x[:, 7] + (x[:, 11] > 0.3)
    return LambdaMART.train(x, y, num_trees=40, max_depth=3)


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """A CUDA tensor calls the kernel wrapper, never the plain twin (checked
    with stand-ins, so it runs without a card)."""
    pm = _forest(np.random.default_rng(0))
    called = []
    monkeypatch.setattr(forest_ops, "gbdt_forward_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "forest", lambda *a, **k: called.append("forest"))
    monkeypatch.setattr(E, "attention_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "attention", lambda *a, **k: called.append("attention"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    forest_ops.gbdt_forward(*pm._arrays(), torch.zeros((256, 46)), pm.max_depth)
    q = torch.zeros((1, 16, 12, 32), dtype=torch.bfloat16)
    E.attention(q, q, q, torch.ones((1, 16), dtype=torch.int32))
    assert called == ["forest", "attention"]


def test_kernel_arguments_are_checked(monkeypatch):
    """Shapes, dtypes and layouts a kernel does not take raise before any
    build or launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    big = torch.zeros((4000, 4000), dtype=torch.int32)
    with pytest.raises(ValueError):  # a forest too large for one block's shared memory
        kernels.forest(big, big.float(), big, big, torch.zeros((4000, 8)), torch.zeros((4, 46)),
                       torch.zeros(4), 5)
    bf = torch.zeros((1, 300, 12, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # more tokens than the attention kernel stages
        kernels.attention(bf, bf, bf, torch.ones((1, 300), dtype=torch.int32),
                          torch.zeros((1, 300, 384), dtype=torch.bfloat16))
    d16 = torch.zeros((1, 16, 4, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head width other than 32
        kernels.attention(d16, d16, d16, torch.ones((1, 16), dtype=torch.int32),
                          torch.zeros((1, 16, 64), dtype=torch.bfloat16))
    x = torch.zeros((8, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # f32 residual
        E.add_layernorm(x, x.float(), torch.ones(384), torch.zeros(384), 1e-12)
    with pytest.raises(ValueError):  # bias of the wrong width
        E.bias_gelu(x, torch.zeros(383, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # not contiguous
        E.bias_gelu(torch.zeros((384, 8), dtype=torch.bfloat16).t(),
                    torch.zeros(384, dtype=torch.bfloat16))


def test_plain_attention_keeps_fully_masked_rows_finite():
    """finfo(f32).min, not -inf: a fully masked row gets uniform weights."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, 8, 2, 32), generator=g).to(torch.bfloat16) for _ in range(3))
    mask = torch.tensor([[1] * 8, [0] * 8], dtype=torch.int32)
    out = E.attention_plain(q, k, v, mask).float()
    assert torch.isfinite(out).all()
    mean_v = v[1].float().mean(dim=0).reshape(1, 64).to(torch.bfloat16).float()
    torch.testing.assert_close(out[1], mean_v.expand(8, 64), atol=2e-2, rtol=0)


# ---- on the card ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    kernels.build()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [256, 16384])
def test_forest_kernel_matches_plain(k):
    dev = _card()
    rng = np.random.default_rng(3)
    pm = _forest(rng).to(dev)
    x = torch.from_numpy(rng.normal(size=(k, 46)).astype(np.float32)).to(dev)
    n = kernels.LAUNCHES["forest"]
    got = forest_ops.gbdt_forward(*pm._arrays(), x, pm.max_depth)
    assert kernels.LAUNCHES["forest"] == n + 1
    ref = forest_ops.gbdt_forward_plain(*pm._arrays(), x, pm.max_depth)
    leaf_sum = float(pm.leaf_value.abs().max(dim=1).values.sum())
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * leaf_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 128, 256])
def test_attention_kernel_matches_plain(T):
    dev = _card()
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn((4, T, 12, 32), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = torch.ones((4, T), dtype=torch.int32)
    mask[1, T // 3:] = 0
    mask[3] = 0
    mask = mask.to(dev)
    n = kernels.LAUNCHES["attention"]
    got = E.attention(q, k, v, mask)
    assert kernels.LAUNCHES["attention"] == n + 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), E.attention_plain(q, k, v, mask).float(),
                               rtol=ENC_RTOL, atol=2 * ENC_ATOL)


@pytest.mark.cuda
def test_layernorm_and_gelu_kernels_match_plain():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    x, r = (torch.randn((32 * 128, 384), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    w, b = (torch.randn(384, generator=g).to(dev) for _ in range(2))
    torch.testing.assert_close(E.add_layernorm(x, r, w, b, 1e-12).float(),
                               E.add_layernorm_plain(x, r, w, b, 1e-12).float(),
                               rtol=ENC_RTOL, atol=ENC_ATOL)
    y = torch.randn((32 * 128, 1536), generator=g).to(dev, torch.bfloat16)
    bias = torch.randn(1536, generator=g).to(dev, torch.bfloat16)
    torch.testing.assert_close(E.bias_gelu(y, bias).float(), E.bias_gelu_plain(y, bias).float(),
                               rtol=ENC_RTOL, atol=ENC_ATOL)


@pytest.mark.cuda
def test_dual_encoder_on_the_card_matches_the_cpu(tmp_path):
    """MiniLM-L6 at full width: saved, loaded onto the card and onto the
    CPU, the same texts embed alike (kernels against plain twins end to end)."""
    _card()
    tok = WordPieceTokenizer.build(TEXTS, vocab_size=30522)
    DualEncoder.random_init(BertConfig.mini_lm(), tok, seed=2).save(str(tmp_path))
    gpu = DualEncoder.load(str(tmp_path), device="cuda").embed(TEXTS)
    cpu = DualEncoder.load(str(tmp_path)).embed(TEXTS)
    assert ((gpu * cpu).sum(1)).min() >= 0.999
