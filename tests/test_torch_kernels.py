"""The ranking pipeline's kernels against their plain twins: K4 (forest
walk, ops/forest.py), K5a-d (attention, residual + LayerNorm, bias + GELU,
mean pool, ops/encoder.py) and the training kernels K14a-d (the backward of
K5a-c, ops/encoder.py, and the fused AdamW update, optim.py). This file
imports the port alone (no jax, no flax), so it also runs on a machine with
a card and no JAX package:

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
  - the whole MiniLM-shaped dual encoder, card against CPU: cosine >= 0.999;
  - the backward kernels and the pool (bf16 or bf16-rounded outputs): within
    one bf16 step of the plain twin's largest magnitude, elementwise
    (rtol 2^-7, atol 2^-7 x max |plain|): f32 sums in other orders and exp /
    tanh in other implementations move intermediate values across bf16
    rounding boundaries (the probabilities, dP, each step of the GELU chain);
  - the LayerNorm parameter gradients (f32 column sums over the rows):
    rtol 1e-4, atol 1e-4 x max |plain|;
  - AdamW over 3 steps: rtol 1e-6, atol 1e-6 x max |plain| (the same f32
    ops; Triton's division and square root may round differently by an ulp).
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
from stract_tpu_torch.webgraph.csr import InCSR, in_csr

ENC_RTOL, ENC_ATOL = 2 ** -7, 1e-2
STEP = 2 ** -7
TEXTS = ["the quick brown fox", "jumps over the lazy dog", "", "fox " * 40]


def _forest(rng) -> LambdaMART:
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = 2 * x[:, 0] + x[:, 5] * x[:, 7] + (x[:, 11] > 0.3)
    return LambdaMART.train(x, y, num_trees=40, max_depth=3, device="cpu")


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


def test_training_wrappers_never_take_the_plain_path(monkeypatch):
    """On a CUDA tensor the backward dispatchers, the pool and the AdamW
    update launch their kernels (stand-ins here), never the plain twins."""
    from stract_tpu_torch import optim

    called = []

    class Kern:
        def __init__(self, name):
            self.name = name

        def __getitem__(self, grid):
            return lambda *a, **k: called.append(self.name)

    for name in ("attention_backward_plain", "add_layernorm_backward_plain",
                 "bias_gelu_backward_plain", "mean_pool_plain",
                 "mean_pool_backward_plain"):
        monkeypatch.setattr(E, name, lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(optim, "adamw_update_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "attention_backward", lambda *a, **k: called.append("attn"))
    monkeypatch.setattr(E, "_triton_kernels", lambda: {n: Kern(n) for n in (
        "add_layernorm_bwd", "col_sum", "bias_gelu_bwd", "mean_pool", "mean_pool_bwd")})
    monkeypatch.setattr(optim, "_triton_kernel", lambda: Kern("adamw"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    mask = torch.ones((2, 16), dtype=torch.int32)
    E.attention_backward(bf(2, 16, 12, 32), bf(2, 16, 12, 32), bf(2, 16, 12, 32), mask,
                         bf(2, 16, 384))
    E.add_layernorm_backward(bf(32, 384), bf(32, 384), torch.ones(384), 1e-12, bf(32, 384))
    E.bias_gelu_backward(bf(32, 1536), bf(1536), bf(32, 1536))
    E.mean_pool_forward(bf(2, 16, 384), mask, True)
    E.mean_pool_backward(mask, torch.zeros(2, 384), torch.zeros(2, 384), True, torch.bfloat16)
    f = torch.zeros(4096)
    optim.adamw_update(f, f, f, f, 1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    assert called == ["attn", "add_layernorm_bwd", "col_sum", "col_sum", "bias_gelu_bwd",
                      "col_sum", "mean_pool", "mean_pool_bwd", "adamw"]


def test_training_kernel_arguments_are_checked(monkeypatch):
    """Arguments the training kernels do not take raise before any launch."""
    from stract_tpu_torch import optim

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    bf = torch.zeros((1, 16, 12, 32), dtype=torch.bfloat16)
    mask = torch.ones((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError):  # the context gradient of the wrong width
        kernels.attention_backward(bf, bf, bf, mask, torch.zeros((1, 16, 380),
                                   dtype=torch.bfloat16), bf, bf, bf)
    with pytest.raises(ValueError):  # f32 gradient of a bf16 activation
        E.add_layernorm_backward(bf, bf, torch.ones(32), 1e-12, bf.float())
    with pytest.raises(ValueError):  # an f32 bias
        E.bias_gelu_backward(bf, torch.zeros(32), bf)
    with pytest.raises(ValueError):  # the pool writes bf16 gradients only
        E.mean_pool_backward(mask, torch.zeros(1, 384), torch.zeros(1, 384), True, torch.float32)
    with pytest.raises(ValueError):  # moments of another length
        optim.adamw_update(torch.zeros(8), torch.zeros(8), torch.zeros(7), torch.zeros(8),
                           1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)


def test_adamw_keeps_parameters_and_gradients_in_its_buffers():
    """Parameters and gradients are views into the flat buffers the fused
    update reads; a gradient replaced behind the optimizer's back raises."""
    from stract_tpu_torch.optim import AdamW

    model = torch.nn.Linear(4, 3)
    opt = AdamW(model.parameters(), 1e-2)
    before = opt.flat.clone()
    model(torch.ones(2, 4)).sum().backward()
    assert opt.grad.abs().sum() > 0 and model.weight.grad.data_ptr() == opt.grad.data_ptr()
    opt.step()
    assert opt.count == 1 and not torch.equal(opt.flat, before)
    assert torch.equal(model.weight.detach().reshape(-1), opt.flat[:12])
    model.weight.grad = torch.zeros(3, 4)
    with pytest.raises(RuntimeError):
        opt.step()


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
    DualEncoder.random_init(BertConfig.mini_lm(), tok, seed=2, device="cpu").save(str(tmp_path))
    gpu = DualEncoder.load(str(tmp_path), device="cuda").embed(TEXTS)
    cpu = DualEncoder.load(str(tmp_path), device="cpu").embed(TEXTS)
    assert ((gpu * cpu).sum(1)).min() >= 0.999


def _step_close(got, ref):
    """Within one bf16 step of the reference's largest magnitude."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=STEP, atol=STEP * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 128, 256])
def test_attention_backward_kernel_matches_plain(T):
    dev = _card()
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn((4, T, 12, 32), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    dout = torch.randn((4, T, 384), generator=g).to(dev, torch.bfloat16)
    mask = torch.ones((4, T), dtype=torch.int32)
    mask[1, T // 3:] = 0
    mask[3] = 0
    mask = mask.to(dev)
    n = kernels.LAUNCHES["attention_backward"]
    got = E.attention_backward(q, k, v, mask, dout)
    assert kernels.LAUNCHES["attention_backward"] == n + 1
    for a, b in zip(got, E.attention_backward_plain(q, k, v, mask, dout)):
        _step_close(a, b)
    assert not got[0][3].float().any()


@pytest.mark.cuda
def test_layernorm_and_gelu_backward_kernels_match_plain():
    dev = _card()
    g = torch.Generator().manual_seed(1)
    x, r, dy = (torch.randn((32 * 128, 384), generator=g).to(dev, torch.bfloat16)
                for _ in range(3))
    w = (1 + 0.1 * torch.randn(384, generator=g)).to(dev)
    ds, dw, db = E.add_layernorm_backward(x, r, w, 1e-12, dy)
    ps, pw, pb = E.add_layernorm_backward_plain(x, r, w, 1e-12, dy)
    _step_close(ds, ps)
    for a, b in ((dw, pw), (db, pb)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    y, dout = (torch.randn((32 * 128, 1536), generator=g).to(dev, torch.bfloat16)
               for _ in range(2))
    bias = (0.5 * torch.randn(1536, generator=g)).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["bias_gelu_backward"]
    gy, gb = E.bias_gelu_backward(y, bias, dout)
    assert kernels.LAUNCHES["bias_gelu_backward"] == n + 1
    py, pb = E.bias_gelu_backward_plain(y, bias, dout)
    _step_close(gy, py)
    _step_close(gb, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [True, False])
def test_mean_pool_kernels_match_plain(normalize):
    dev = _card()
    g = torch.Generator().manual_seed(2)
    h = torch.randn((64, 128, 384), generator=g).to(dev, torch.bfloat16)
    mask = torch.ones((64, 128), dtype=torch.int32)
    mask[1, 40:] = 0
    mask[2] = 0
    mask = mask.to(dev)
    pooled, raw = E.mean_pool_forward(h, mask, normalize)
    ref_pooled, ref_raw = E.mean_pool_plain(h, mask, normalize)
    _step_close(pooled, ref_pooled)
    _step_close(raw, ref_raw)
    cot = torch.randn((64, 384), generator=g).to(dev)
    _step_close(E.mean_pool_backward(mask, raw, cot, normalize, torch.bfloat16),
                E.mean_pool_backward_plain(mask, raw, cot, normalize, torch.bfloat16))


@pytest.mark.cuda
def test_adamw_kernel_matches_plain():
    from stract_tpu_torch import optim

    dev = _card()
    g = torch.Generator().manual_seed(3)
    n = 1 << 20
    state = [(0.02 * torch.randn(n, generator=g)).to(dev), torch.zeros(n, device=dev),
             torch.zeros(n, device=dev)]
    plain = [t.clone() for t in state]
    for step in range(1, 4):
        grad = torch.randn(n, generator=g).to(dev)
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        optim.adamw_update(state[0], grad, state[1], state[2], 3e-4, 0.9, 0.999, 1e-8, 1e-4,
                           bc1, bc2)
        optim.adamw_update_plain(plain[0], grad, plain[1], plain[2], 3e-4, 0.9, 0.999, 1e-8,
                                 1e-4, bc1, bc2)
    for a, b in zip(state, plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_dual_train_step_kernels_match_plain_twins(monkeypatch):
    """One InfoNCE step of a MiniLM-shaped encoder (2 layers) on the card from
    the same f32 masters, once through the kernels and once through the plain
    twins (the same cuBLAS products): the same loss (1e-3 relative) and the
    same gradient. The kernels and twins round alike but for a few values
    that sit on a bf16 rounding boundary (K5a-d and K14a-c each within one
    step); those flips reach every gradient. Cosine >= 0.999 over all
    parameters and for each matrix, embedding table of words and LayerNorm
    scale; >= 0.98 for the leaves that sum a gradient over every token of the
    batch (biases, the position and token-type tables), where the flips
    cancel less than the signal does at random init (measured on the H100:
    >= 0.9999 and >= 0.990). The attention key biases are zero but for
    rounding (softmax ignores a per-row shift) and are not compared."""
    from stract_tpu_torch.models.bert import BertForEmbedding, random_init
    from stract_tpu_torch.parallel.train import info_nce_loss

    _card()
    cfg = BertConfig.mini_lm(num_layers=2, vocab_size=1024)
    rng = np.random.default_rng(4)
    ids = rng.integers(5, 1024, size=(2, 16, 64)).astype(np.int32)
    mask = np.ones((16, 64), np.int32)
    mask[:, 40:] = 0
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             (("q_ids", ids[0]), ("q_mask", mask), ("d_ids", ids[1]), ("d_mask", mask))}
    plain = {"attention_forward": E.attention_plain,
             "add_layernorm_forward": E.add_layernorm_plain,
             "bias_gelu_forward": E.bias_gelu_plain, "mean_pool_forward": E.mean_pool_plain,
             "attention_backward": E.attention_backward_plain,
             "add_layernorm_backward": E.add_layernorm_backward_plain,
             "bias_gelu_backward": E.bias_gelu_backward_plain,
             "mean_pool_backward": E.mean_pool_backward_plain}
    runs = []
    for twins in (False, True):
        if twins:
            for name, fn in plain.items():
                monkeypatch.setattr(E, name, fn)
        model = random_init(BertForEmbedding(cfg, param_dtype=torch.float32), 5).to("cuda")
        kernels.reset_launches()
        loss = info_nce_loss(model, batch)
        loss.backward()
        assert (kernels.LAUNCHES["attention_backward"] == 0) == twins
        runs.append((float(loss.detach()),
                     {n: p.grad.double().ravel() for n, p in model.named_parameters()}))
    (lk, gk), (lp, gp) = runs
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))  # noqa: E731
    assert cos(torch.cat(list(gk.values())), torch.cat(list(gp.values()))) >= 0.999
    for name, b in gp.items():
        if b.norm() == 0 or name.endswith("key.bias"):
            continue
        summed = name.endswith("bias") or "position_" in name or "token_type" in name
        assert cos(gk[name], b) >= (0.98 if summed else 0.999), (name, cos(gk[name], b))


# ---- the webgraph kernels: K6a/K6b (HyperBall merge + estimate), K7 (BFS relaxation) ------
def _graph(n: int, hub_in: int, seed: int = 0):
    """A Pareto web graph of n nodes with node 0 a hub of `hub_in` in-edges,
    node n - 1 with no in-edges, and self-loops left in → (sources, targets)
    i32 (edges u → v)."""
    rng = np.random.default_rng(seed)
    m = 8 * n
    tgt = (rng.pareto(1.3, m) * n / 50).astype(np.int64) % (n - 1)
    src = rng.integers(0, n, m)
    src = np.concatenate([src, rng.integers(1, n, hub_in)])
    tgt = np.concatenate([tgt, np.zeros(hub_in, np.int64)])
    return src.astype(np.int32), tgt.astype(np.int32)


def test_graph_wrappers_dispatch_and_check(monkeypatch):
    """CPU tensors take the plain versions; a CUDA tensor calls the kernel
    (stand-ins here); a register row the kernel does not take raises."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import shortest_path as SP

    src, dst = _graph(50, 10)
    regs = torch.from_numpy(hll_ops.init_registers(50, 4))
    np.testing.assert_array_equal(hll_ops.merge_iteration(regs, src, dst).numpy(),
                                  hll_ops.merge_iteration_plain(regs, src, dst).numpy())
    called = []
    for name in ("hll_merge", "hll_estimate", "bfs_relax"):
        monkeypatch.setattr(kernels, name, lambda *a, name=name, **k: called.append(name))
    for name in ("merge_iteration_plain", "estimate_sizes_plain"):
        monkeypatch.setattr(hll_ops, name, lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(SP, "relax_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    csr = InCSR(torch.zeros(51, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32))
    hll_ops.merge_csr(regs, csr)
    hll_ops.estimate_sizes(regs)
    SP.relax(torch.zeros((50, 32), dtype=torch.int32), csr)
    assert called == ["hll_merge", "hll_estimate", "bfs_relax"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError):  # 48 registers: not a power of two
        kernels.hll_estimate(torch.zeros((4, 48), dtype=torch.uint8), 0.7, torch.zeros(4))
    with pytest.raises(ValueError):  # 40 sources: neither 1 nor a multiple of 32
        kernels.bfs_relax(torch.zeros((4, 40), dtype=torch.int32), *csr, 64,
                          torch.zeros((4, 40), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hub_in,precision", [(100_003, 100_000, 6), (5_001, 300, 4),
                                                (5_001, 300, 10)])
def test_hll_kernels_match_plain(n, hub_in, precision):
    """K6a bit-equal to the plain merge round by round (and its changed flag
    to the plain comparison), K6b (in K6a's epilogue and alone) within rel
    1e-6 of the plain estimate: a hub of 100k in-edges, N not a multiple of
    the block, a node with no in-edges, 16 / 64 / 1024 registers a row."""
    from stract_tpu_torch.ops import hll_ops

    dev = _card()
    src, dst = _graph(n, hub_in)
    csr = in_csr(n, src, dst, dev)
    assert csr.long_rows.numel() > 0
    ef, et = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    regs = torch.from_numpy(hll_ops.init_registers(n, precision)).to(dev)
    torch.testing.assert_close(hll_ops.estimate_sizes(regs), hll_ops.estimate_sizes_plain(regs),
                               rtol=1e-6, atol=0)
    for _ in range(4):
        new, sizes, changed = hll_ops.merge_csr(regs, csr)
        plain = hll_ops.merge_iteration_plain(regs, ef, et)
        assert torch.equal(new, plain)
        assert bool(changed.item()) == (not torch.equal(plain, regs))
        torch.testing.assert_close(sizes, hll_ops.estimate_sizes_plain(plain), rtol=1e-6, atol=0)
        regs = new
    assert torch.equal(regs[n - 1], torch.from_numpy(hll_ops.init_registers(n, precision)[n - 1])
                       .to(dev))  # no in-edges: the row never changes


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 32, 256])
def test_bfs_kernel_matches_plain(S):
    """K7 bit-equal to the plain relaxation round by round, UNREACHABLE
    included, from 1, 32 and 256 sources (the [N, S] layout against the
    plain [S, N]), over a hub of 100k in-edges."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import shortest_path as SP

    dev = _card()
    n = 100_003
    src, dst = _graph(n, 100_000, seed=1)
    csr = in_csr(n, src, dst, dev)
    ef, et = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    sources = np.random.default_rng(2).choice(n, size=S, replace=False)
    dist = torch.full((S, n), int(SP.UNREACHABLE), dtype=torch.int32, device=dev)
    dist[torch.arange(S), torch.from_numpy(sources).to(dev)] = 0
    for _ in range(12):
        new, changed = SP.relax(dist.t().contiguous(), csr)
        plain = SP.relax_plain(dist, ef, et)
        assert torch.equal(new.t(), plain)
        assert bool(changed.item()) == (not torch.equal(plain, dist))
        dist = plain
    assert (dist == int(SP.UNREACHABLE)).any()
    got = SP.bfs(n, src, dst, sources, device=dev)
    want = SP.bfs(n, src, dst, sources, device="cpu")
    np.testing.assert_array_equal(got, want)


# ---- entry points run on the card unless asked for the CPU ------------------------------
@pytest.mark.parametrize("where,name", [
    ("entrypoint.train_encoders", "train_cross_encoder"),
    ("entrypoint.train_encoders", "train_dual_encoder"),
    ("parallel.train", "make_train_state"),
    ("models.dual_encoder", "DualEncoder.random_init"),
    ("models.dual_encoder", "DualEncoder.load"),
    ("ranking.models.cross_encoder", "CrossEncoderModel.random_init"),
    ("ranking.models.cross_encoder", "CrossEncoderModel.load"),
    ("ranking.models.lambdamart", "LambdaMART.__init__"),
    ("ranking.models.lambdamart", "LambdaMART.from_json"),
    ("ranking.models.lambdamart", "LambdaMART.load"),
    ("ranking.models.lambdamart", "LambdaMART.train"),
    ("entrypoint.centrality", "run_harmonic"),
    ("entrypoint.centrality", "run_approx_harmonic"),
    ("entrypoint.centrality", "run_harmonic_nearest_seed"),
    ("webgraph.centrality", "harmonic_centrality"),
    ("webgraph.shortest_path", "approx_harmonic_centrality"),
])
def test_entry_points_default_to_the_card(where, name):
    """Entry points and the model loaders they call take device="cuda"
    unless the caller asks for the CPU; without a card that default raises
    (checked on a model and a forest), and nothing falls back."""
    import importlib
    import inspect

    obj = importlib.import_module(f"stract_tpu_torch.{where}")
    for part in name.split("."):
        obj = getattr(obj, part)
    assert inspect.signature(obj).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    if name == "DualEncoder.random_init":
        with pytest.raises((RuntimeError, AssertionError)):
            DualEncoder.random_init(BertConfig.tiny(), seed=1)
    if name == "LambdaMART.train":
        x = np.random.default_rng(0).normal(size=(40, 46)).astype(np.float32)
        with pytest.raises((RuntimeError, AssertionError)):
            LambdaMART.train(x, x[:, 0], num_trees=2, max_depth=2)
