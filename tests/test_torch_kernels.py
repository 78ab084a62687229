"""The ranking pipeline's kernels against their plain twins: K4 (forest
walk, ops/forest.py), K5a-d (attention, residual + LayerNorm, bias + GELU,
mean pool, ops/encoder.py), the training kernels K14a-d (the backward of
K5a-c, ops/encoder.py, and the fused AdamW update, optim.py) and K15a-d (the
MoE router and select-and-scale, ops/moe.py; the loss heads, ops/losses.py;
the bf16 AdamW update, optim.py), and the mesh's two (K9, the global top-k
of the shards, ops/scoring.py; K8, the sharded HyperBall's ring step,
ops/hll_ops.py and webgraph/centrality.py). This file
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
  - the MoE router: probabilities rtol 1e-5 (f32 sums over H in another
    order, expf), the expert chosen equal but where two probabilities lie
    within 1e-5 of each other, the gate and dx within one bf16 step, the
    logits' cotangent rtol 1e-5, atol 1e-6 x max |plain|; select-and-scale
    and its backward bit-equal but the gate's cotangent (an f32 row sum in
    another order, rounded to bf16: one bf16 step);
  - the loss heads: rtol 1e-5 (sums over B in another order; exp and log in
    another implementation);
  - K9 and K8: bit-equal (a selection; a max), K8's sizes rel 1e-6 (K6b's);
  - the bf16 AdamW over 3 steps: within one bf16 step of the plain twin
    (each operation rounds to bf16; Triton's division and square root are
    not correctly rounded in f32, which may move a value across a bf16
    rounding boundary).
"""

from __future__ import annotations

import contextlib

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
from stract_tpu_torch.webgraph.csr import LONG_ROW, InCSR, in_csr

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
    empty = torch.zeros((40, 0), dtype=torch.int32)
    with pytest.raises(ValueError):  # a malformed forest: trees without nodes
        kernels.forest(empty, empty.float(), empty, empty, torch.zeros((40, 8)),
                       torch.zeros((4, 46)), torch.zeros(4), 5)
    bf = torch.zeros((65536, 1, 1, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # more batch rows than the grid's 65,535
        kernels.attention(bf, bf, bf, torch.ones((65536, 1), dtype=torch.int32),
                          torch.zeros((65536, 1, 16), dtype=torch.bfloat16))
    d24 = torch.zeros((1, 16, 4, 24), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a head width other than 16, 32 or 64
        kernels.attention(d24, d24, d24, torch.ones((1, 16), dtype=torch.int32),
                          torch.zeros((1, 16, 96), dtype=torch.bfloat16))
    x = torch.zeros((8, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # f32 residual
        E.add_layernorm(x, x.float(), torch.ones(384), torch.zeros(384), 1e-12)
    with pytest.raises(ValueError):  # bias of the wrong width
        E.bias_gelu(x, torch.zeros(383, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # not contiguous
        E.bias_gelu(torch.zeros((384, 8), dtype=torch.bfloat16).t(),
                    torch.zeros(384, dtype=torch.bfloat16))


class _RecordingLib:
    """A stand-in library: every stract_* entry point records its name and
    arguments and returns success."""

    def __init__(self, called):
        self.called = called

    def __getattr__(self, name):
        if not name.startswith("stract_"):
            raise AttributeError(name)
        return lambda *args: self.called.append((name, args)) or 0


@pytest.mark.parametrize("shape", [(2, 16, 4, 24), (2, 513, 4, 16), (2, 513, 2, 64)])
@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_attention_wrappers_reject_other_head_dims_and_long_rows(monkeypatch, kind, shape):
    """K5a and K14a take head dims 16, 32 and 64 and any number of tokens: a
    head dim of 24 raises through ops/encoder.py's dispatchers before the
    library is loaded or a kernel launched, with a message that names what
    they take; 513 tokens (past the 512 they once stopped at) reach the C
    entry point with T = 513, counted once."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    B, T, h, d = shape
    q = torch.zeros(shape, dtype=torch.bfloat16)
    mask = torch.ones((B, T), dtype=torch.int32)
    dout = torch.zeros((B, T, h * d), dtype=torch.bfloat16)
    if d not in kernels.ATTN_HEAD_DIMS:
        monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
        with pytest.raises(ValueError, match=r"head dims \(16, 32, 64\), at least one token"):
            if kind == "forward":
                E.attention_forward(q, q, q, mask)
            else:
                E.attention_backward(q, q, q, mask, dout)
        return
    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    kernels.reset_launches()
    if kind == "forward":
        out = E.attention_forward(q, q, q, mask)
        assert out.shape == (B, T, h * d)
    else:
        grads = E.attention_backward(q, q, q, mask, dout)
        assert [g.shape for g in grads] == [shape] * 3
    name = "stract_attention" if kind == "forward" else "stract_attention_backward"
    assert [c[0] for c in called] == [name]
    assert called[0][1][-5:] == (B, T, h, d, 0)
    assert kernels.LAUNCHES["attention" if kind == "forward" else "attention_backward"] == 1


def test_every_launch_takes_the_stream_of_its_tensors_card():
    """Every call of a csrc/ kernel in ops/kernels.py (`lib.stract_*`) sits
    inside `with on_card(...) as <name>` and takes <name>, the stream of its
    tensors' card, as its last argument: no launch reads the current card's
    stream."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(kernels))
    launches = []

    def visit(node, streams):
        if isinstance(node, ast.With):
            bound = {item.optional_vars.id for item in node.items
                     if isinstance(item.context_expr, ast.Call)
                     and getattr(item.context_expr.func, "id", None) == "on_card"
                     and isinstance(item.optional_vars, ast.Name)}
            streams = streams | bound
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.startswith("stract_")
                and getattr(node.func.value, "id", None) == "lib"):
            last = node.args[-1] if node.args else None
            launches.append((node.func.attr, isinstance(last, ast.Name) and last.id in streams))
        for child in ast.iter_child_nodes(node):
            visit(child, streams)

    visit(tree, frozenset())
    assert len(launches) >= 21, launches
    assert all(ok for _, ok in launches), [name for name, ok in launches if not ok]
    assert "_stream" not in {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


class _FailingLib:
    def __getattr__(self, name):
        return lambda *a: pytest.fail(f"{name} was launched")


@pytest.mark.parametrize("kernel", ["attention", "mesh_topk", "sgd_multi", "forest"])
def test_launch_on_two_cards_raises_before_any_launch(monkeypatch, kernel):
    """Tensors of one launch on two cards raise ValueError before the
    library is called (the devices stood in by a patched `Tensor.device`:
    one argument reports cuda:1, the others cuda:0)."""
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    if kernel == "attention":
        other = bf(2, 16, 128)
        args = (bf(2, 16, 4, 32), bf(2, 16, 4, 32), bf(2, 16, 4, 32),
                torch.ones((2, 16), dtype=torch.int32), other)
        call = lambda: kernels.attention(*args)  # noqa: E731
    elif kernel == "mesh_topk":
        scores, other = _gathered(2, 4, 64)
        outs = [torch.zeros((2, 32), dtype=t) for t in (torch.int32, torch.int32, torch.float32)]
        call = lambda: kernels.mesh_topk(scores, other, 32, *outs)  # noqa: E731
    elif kernel == "sgd_multi":
        other = torch.zeros(3)
        ps, gs = [torch.zeros(8), other], [torch.zeros(8), torch.zeros(3)]
        call = lambda: kernels.sgd_multi(ps, gs, 0.1)  # noqa: E731
    else:
        pm = _forest(np.random.default_rng(0))
        arrays, other = pm._arrays(), torch.zeros((16, 46))
        call = lambda: kernels.forest(*arrays, other, torch.zeros(16), pm.max_depth)  # noqa: E731
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda", 1 if self is other else 0)))
    monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: pytest.fail("a card was entered"))
    with pytest.raises(ValueError, match="on one card"):
        call()


def test_training_wrappers_never_take_the_plain_path(monkeypatch):
    """On a CUDA tensor the backward dispatchers, the pool (forward and
    backward: csrc/encoder.cu's entry points) and the AdamW update launch
    their kernels (stand-ins here), never the plain twins."""
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
    monkeypatch.setattr(kernels, "add_layernorm_backward", lambda *a, **k: called.append("ln"))
    monkeypatch.setattr(kernels, "bias_gelu_backward",
                        lambda y, b, *a: called.append("bias_gelu_bwd") or (y, b))
    monkeypatch.setattr(kernels, "mean_pool", lambda *a: called.append("mean_pool"))
    monkeypatch.setattr(kernels, "mean_pool_backward", lambda *a: called.append("mean_pool_bwd"))
    monkeypatch.setattr(optim, "_triton_kernel", lambda: Kern("adamw"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
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
    assert called == ["attn", "ln", "bias_gelu_bwd", "mean_pool", "mean_pool_bwd", "adamw"]


class _EncoderLib:
    """A stand-in for csrc/encoder.cu's library: stract_add_layernorm_backward
    records its arguments, and stract_add_layernorm, stract_mean_pool and
    stract_mean_pool_backward their name and arguments; each returns
    success."""

    def __init__(self, called):
        self.called = called

    def stract_add_layernorm_backward(self, *args):
        self.called.append(args)
        return 0

    def __getattr__(self, name):
        if name not in ("stract_add_layernorm", "stract_mean_pool", "stract_mean_pool_backward"):
            raise AttributeError(name)
        return lambda *args: self.called.append((name, args)) or 0


@pytest.mark.parametrize("shape", [(2, 16, 384), (5, 40), (0, 64)])
def test_layernorm_backward_reaches_its_c_entry_point(monkeypatch, shape):
    """K14b on CUDA tensors (stand-ins) calls stract_add_layernorm_backward
    once with the rows flattened, the fixed grid's block count and its
    partials, launches nothing of Triton (not imported) and counts one
    launch; the same tensors on the CPU take the twin."""
    import sys

    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    N = shape[-1]
    M = int(np.prod(shape[:-1]))
    args = (bf(*shape), bf(*shape), torch.ones(N), 1e-12, bf(*shape))
    twin = []
    monkeypatch.setattr(E, "add_layernorm_backward_plain", lambda *a: twin.append(a) or (a[0],) * 3)
    E.add_layernorm_backward(*args)
    assert len(twin) == 1
    called = []
    monkeypatch.setattr(E, "add_layernorm_backward_plain",
                        lambda *a: pytest.fail("the twin was reached"))
    assert not hasattr(E, "_triton_kernels")  # no Triton kernel to reach
    monkeypatch.setattr(kernels, "_load", lambda name: _EncoderLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    ds, dw, db = E.add_layernorm_backward(*args)
    assert ds.shape == shape and dw.shape == db.shape == (N,)
    assert len(called) == 1 and kernels.LAUNCHES["add_layernorm_backward"] == 1
    *_, m, n, blocks, eps, stream = called[0]
    assert (m, n, eps, stream) == (M, N, 1e-12, 0)
    assert blocks == min(kernels.LN_BWD_BLOCKS, -(-M // kernels.LN_BWD_WARPS))
    assert "triton" not in sys.modules


@pytest.mark.parametrize("shape", [(2, 16, 384), (5, 40), (0, 64)])
def test_add_layernorm_reaches_its_c_entry_point(monkeypatch, shape):
    """K5b on CUDA tensors (stand-ins) calls stract_add_layernorm once with
    the rows flattened, counts one launch and imports no triton; with no
    rows it launches nothing; the same tensors on the CPU take the twin."""
    import sys

    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    N = shape[-1]
    M = int(np.prod(shape[:-1]))
    args = (bf(*shape), bf(*shape), torch.ones(N), torch.zeros(N), 1e-12)
    twin = []
    monkeypatch.setattr(E, "add_layernorm_plain", lambda *a: twin.append(a) or a[0])
    E.add_layernorm(*args)
    assert len(twin) == 1
    called = []
    monkeypatch.setattr(E, "add_layernorm_plain", lambda *a: pytest.fail("the twin was reached"))
    monkeypatch.setattr(kernels, "_load", lambda name: _EncoderLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    y = E.add_layernorm_forward(*args)
    assert y.shape == shape and y.dtype == torch.bfloat16
    assert "triton" not in sys.modules
    if M == 0:
        assert called == [] and kernels.LAUNCHES["add_layernorm"] == 0
        return
    assert len(called) == 1 and kernels.LAUNCHES["add_layernorm"] == 1
    name, (xp, rp, wp, bp, yp, m, n, eps, stream) = called[0]
    assert name == "stract_add_layernorm"
    assert (xp, rp, yp) == (args[0].data_ptr(), args[1].data_ptr(), y.data_ptr())
    assert (wp, bp) == (args[2].data_ptr(), args[3].data_ptr())
    assert (m, n, eps, stream) == (M, N, 1e-12, 0)


@pytest.mark.parametrize("B,normalize", [(2, True), (2, False), (0, True)])
def test_mean_pool_reaches_its_c_entry_points(monkeypatch, B, normalize):
    """K5d on CUDA tensors (stand-ins): the forward calls stract_mean_pool
    once (raw its own tensor when normalised, the output itself else), the
    backward stract_mean_pool_backward once, each counted under
    "mean_pool", triton not imported; with no rows neither launches; the
    same tensors on the CPU take the twins."""
    import sys

    T, H = 16, 384
    h = torch.zeros((B, T, H), dtype=torch.bfloat16)
    mask = torch.ones((B, T), dtype=torch.int32)
    g = torch.zeros((B, H))
    twin = []
    monkeypatch.setattr(E, "mean_pool_plain", lambda *a: twin.append("fwd") or (g, g))
    monkeypatch.setattr(E, "mean_pool_backward_plain", lambda *a: twin.append("bwd") or h)
    E.mean_pool_forward(h, mask, normalize)
    E.mean_pool_backward(mask, g, g, normalize, torch.bfloat16)
    assert twin == ["fwd", "bwd"]
    called = []
    for name in ("mean_pool_plain", "mean_pool_backward_plain"):
        monkeypatch.setattr(E, name, lambda *a: pytest.fail("a twin was reached"))
    monkeypatch.setattr(kernels, "_load", lambda name: _EncoderLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    pooled, raw = E.mean_pool_forward(h, mask, normalize)
    dh = E.mean_pool_backward(mask, raw, g, normalize, torch.bfloat16)
    assert pooled.shape == raw.shape == (B, H) and (raw is pooled) == (not normalize)
    assert dh.shape == (B, T, H) and dh.dtype == torch.bfloat16
    assert "triton" not in sys.modules
    if B == 0:
        assert called == [] and kernels.LAUNCHES["mean_pool"] == 0
        return
    assert [name for name, _ in called] == ["stract_mean_pool", "stract_mean_pool_backward"]
    assert kernels.LAUNCHES["mean_pool"] == 2
    (_, fwd), (_, bwd) = called
    assert fwd == (h.data_ptr(), mask.data_ptr(), pooled.data_ptr(), raw.data_ptr(), B, T, H,
                   int(normalize), 0)
    assert bwd == (mask.data_ptr(), raw.data_ptr(), g.data_ptr(), dh.data_ptr(), B, T, H,
                   int(normalize), 0)


class _GeluLib:
    """A stand-in for csrc/encoder.cu's library: stract_bias_gelu_backward
    records its arguments and returns success."""

    def __init__(self, called):
        self.called = called

    def stract_bias_gelu_backward(self, *args):
        self.called.append(args)
        return 0


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor of `shape` that starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 8, dtype=dtype)
    start = next(i for i in range(8) if (flat.data_ptr() + 2 * i) % 16)
    return flat[start:start + n].view(shape)


@pytest.mark.parametrize("shape,misaligned", [
    ((64, 128, 1536), False), ((4, 128), False), ((3, 11, 3072), False), ((5, 1000), False),
    ((7, 1536), True), ((0, 1536), False)])
def test_bias_gelu_backward_reaches_its_c_entry_point(monkeypatch, shape, misaligned):
    """K14c on CUDA tensors (stand-ins) calls stract_bias_gelu_backward once
    with the rows flattened, the grid's row blocks and partials f32[blocks,
    N] the wrapper computes (any width, a misaligned view too: the kernel
    picks its piece width), launches nothing of Triton (not imported) and
    counts one launch; with no rows it launches nothing and gives db zeros;
    the same tensors on the CPU take the twin."""
    import sys

    N = shape[-1]
    M = int(np.prod(shape[:-1]))
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    y = _misaligned(shape) if misaligned else bf(*shape)
    args = (y, bf(N), bf(*shape))
    twin = []
    monkeypatch.setattr(E, "bias_gelu_backward_plain", lambda *a: twin.append(a) or a[:2])
    E.bias_gelu_backward(*args)
    assert len(twin) == 1
    called = []
    monkeypatch.setattr(E, "bias_gelu_backward_plain", lambda *a: pytest.fail("the twin ran"))
    assert not hasattr(E, "_triton_kernels")  # no Triton kernel to reach
    monkeypatch.setattr(kernels, "_load", lambda name: _GeluLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    dy, db = E.bias_gelu_backward(*args)
    assert dy.shape == shape and db.shape == (N,) and db.dtype == torch.bfloat16
    assert "triton" not in sys.modules
    if M == 0:
        assert called == [] and kernels.LAUNCHES["bias_gelu_backward"] == 0
        assert not db.any()
        return
    assert len(called) == 1 and kernels.LAUNCHES["bias_gelu_backward"] == 1
    yp, bp, gp, dyp, dbp, partials, m, n, blocks, c1, c2, stream = called[0]
    assert (yp, m, n, c1, c2, stream) == (y.data_ptr(), M, N, E.GELU_C1, E.GELU_C2, 0)
    assert (dyp, dbp) == (dy.data_ptr(), db.data_ptr())
    cols = -(-N // kernels.GELU_BWD_COLS)
    assert blocks == max(1, min(-(-M // kernels.GELU_BWD_ROWS), kernels.GELU_BWD_BLOCKS // cols))
    assert blocks * cols <= kernels.GELU_BWD_BLOCKS or blocks == 1
    if shape == (64, 128, 1536):  # the dual step's shape: 6 column blocks x 44 row blocks
        assert blocks == 44
    assert partials % 16 == 0


class _LossLib:
    """A stand-in for csrc/losses.cu's library: each entry point records its
    name and arguments and returns success."""

    def __init__(self, called):
        self.called = called

    def __getattr__(self, name):
        return lambda *args: self.called.append((name, args)) or 0


def test_loss_heads_reach_their_c_entry_points(monkeypatch):
    """K15c on CUDA tensors (stand-ins) calls stract_pair_loss (targets
    NULL and distill 0 undistilled, both targets and distill 1 distilled)
    and stract_info_nce once each, counts each head under its own name,
    and neither names nor imports triton."""
    import sys

    from stract_tpu_torch.ops import losses as LO

    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _LossLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    sp, sn, tp, tn = (torch.zeros(32) for _ in range(4))
    LO.pair_loss_forward(sp, sn)
    LO.pair_loss_forward(sp, sn, tp, tn.double(), 2.0)
    LO.info_nce_forward(torch.zeros(64, 64))
    LO.info_nce_forward(torch.zeros(65, 65))
    assert [name for name, _ in called] == ["stract_pair_loss", "stract_pair_loss",
                                            "stract_info_nce", "stract_info_nce"]
    plain, distilled, one, grid = (args for _, args in called)
    assert plain[2:4] == (None, None) and plain[-4:] == (32, 0.0, 0, 0)
    assert distilled[2] == tp.data_ptr() and distilled[3] is not None
    assert distilled[-4:] == (32, 2.0, 1, 0)
    # one block up to INFO_NCE_ONE_BLOCK rows (no scratch), past it the grid
    # of INFO_NCE_GRID_ROWS rows a block over a scratch of the rows' terms
    assert kernels.INFO_NCE_ONE_BLOCK == 64 and kernels.INFO_NCE_GRID_ROWS == 8
    assert one[3] is None and one[-3:] == (64, 1, 0)
    assert grid[3] is not None and grid[-3:] == (65, 9, 0)
    assert kernels.LAUNCHES["pair_loss"] == 2 and kernels.LAUNCHES["info_nce"] == 2
    with pytest.raises(ValueError, match="1 or 9 blocks"):
        kernels.info_nce(torch.zeros(65, 65), torch.zeros(()), torch.zeros(65, 65), blocks=4)
    assert kernels.LAUNCHES["info_nce"] == 2
    assert "triton" not in sys.modules


@pytest.mark.parametrize("module", ["losses", "encoder", "stage", "moe"])
def test_kernel_module_names_no_triton(module):
    """ops/losses.py (K15c), ops/encoder.py (K5a-d, K14a-c), ops/stage.py
    (K16a-d) and ops/moe.py (K15a-b) launch their kernels through
    ops/kernels.py alone: no source imports nor names triton, and no module
    has a `_triton_kernels`."""
    import ast
    import importlib
    import inspect

    mod = importlib.import_module(f"stract_tpu_torch.ops.{module}")
    src = inspect.getsource(mod)
    assert "triton" not in src.lower()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any("triton" in n for n in names)
    assert not hasattr(mod, "_triton_kernels")


@pytest.mark.parametrize("N", [1025, 4096])
@pytest.mark.parametrize("kind", ["backward", "forward"])
def test_layernorm_backward_refuses_wider_rows_before_any_launch(monkeypatch, kind, N):
    """A row wider than K14b and K5b hold (kernels.LN_MAX_N = 1,024 columns)
    raises ValueError naming the widths they take, before any build or
    launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
    x = torch.zeros((4, N), dtype=torch.bfloat16)
    name = "add_layernorm" if kind == "forward" else "add_layernorm_backward"
    before = kernels.LAUNCHES[name]
    with pytest.raises(ValueError, match="1..1024 columns"):
        if kind == "forward":
            E.add_layernorm_forward(x, x, torch.ones(N), torch.zeros(N), 1e-12)
        else:
            E.add_layernorm_backward(x, x, torch.ones(N), 1e-12, x)
    assert kernels.LAUNCHES[name] == before


@pytest.mark.parametrize("T,H,misaligned", [(513, 384, False), (16, 380, False),
                                             (16, 1032, False), (16, 384, True)])
@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_mean_pool_refuses_other_shapes_before_any_launch(monkeypatch, kind, T, H, misaligned):
    """K5d takes any number of tokens (up to its backward grid's 65,535
    spans of 32), widths that are multiples of 8 up to 1,024 and 16-byte
    aligned hidden states: 513 tokens (past the 512 it once stopped at)
    reach the C entry point with T = 513; a width of 380 or 1,032 or a
    misaligned view raises ValueError before any build or launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    mask = torch.ones((2, T), dtype=torch.int32)
    if T > 512:
        called = []
        monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
        monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
        h = torch.zeros((2, T, H), dtype=torch.bfloat16)
        kernels.reset_launches()
        if kind == "forward":
            pooled, raw = E.mean_pool_forward(h, mask, True)
            assert pooled.shape == raw.shape == (2, H)
        else:
            kernels.mean_pool_backward(mask, torch.zeros(2, H), torch.zeros(2, H), h, True)
        name = "stract_mean_pool" if kind == "forward" else "stract_mean_pool_backward"
        assert [c[0] for c in called] == [name] and called[0][1][-5:] == (2, T, H, 1, 0)
        assert kernels.LAUNCHES["mean_pool"] == 1
        return
    monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
    before = kernels.LAUNCHES["mean_pool"]
    with pytest.raises(ValueError, match="mean pool"):
        if kind == "forward":
            h = _misaligned((2, T, H)) if misaligned else torch.zeros((2, T, H),
                                                                      dtype=torch.bfloat16)
            E.mean_pool_forward(h, mask, True)
        else:
            dh = _misaligned((2, T, H))
            kernels.mean_pool_backward(mask, torch.zeros(2, H), torch.zeros(2, H), dh, True)
    assert kernels.LAUNCHES["mean_pool"] == before


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


def test_bias_gelu_kernel_arguments_are_checked(monkeypatch):
    """K5c reads 16-byte vectors: a width that is not a multiple of 8 and a
    view that is not 16-byte aligned raise before any build or launch."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
    with pytest.raises(ValueError, match="multiple of 8"):
        E.bias_gelu(torch.zeros((4, 1540), dtype=torch.bfloat16),
                    torch.zeros(1540, dtype=torch.bfloat16))
    flat = torch.zeros(4 * 1536 + 8, dtype=torch.bfloat16)
    start = next(i for i in range(8) if (flat.data_ptr() + 2 * i) % 16)
    y = flat[start:start + 4 * 1536].view(4, 1536)  # contiguous, 16-byte misaligned
    assert y.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        E.bias_gelu(y, torch.zeros(1536, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="aligned"):
        kernels.bias_gelu(torch.zeros((4, 1536), dtype=torch.bfloat16),
                          flat[start:start + 1536], torch.zeros((4, 1536), dtype=torch.bfloat16),
                          E.GELU_C1, E.GELU_C2)


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
def test_launch_context_takes_the_current_stream_of_the_tensors_card():
    """on_card yields the raw handle of the current stream of its tensors'
    card (a side stream while one is current) and leaves the current card
    as it found it."""
    _card()
    x = torch.zeros(8, device="cuda")
    side = torch.cuda.Stream()
    before = torch.cuda.current_device()
    with torch.cuda.stream(side), kernels.on_card(x, None) as stream:
        assert stream == side.cuda_stream
        assert torch.cuda.current_device() == x.device.index
    with kernels.on_card(x) as stream:
        assert stream == torch.cuda.current_stream().cuda_stream
    assert torch.cuda.current_device() == before


def _deep_forest(rng):
    """A forest walked past what max_depth lets it reach: 12 depth-5 trees
    evaluated at max_depth 3, and two negative feature indices (one that
    wraps into range, one that wraps below 0 and is clamped). → (forest,
    the max_depth to evaluate at)."""
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = x[:, 1] - 3 * x[:, 2] + np.sin(x[:, 9])
    pm = LambdaMART.train(x, y, num_trees=12, max_depth=5, device="cpu")
    feature = pm.feature.clone()
    feature[0, 0], feature[1, 0] = -3, -100
    return LambdaMART(feature, *(t.numpy() for t in pm._arrays()[1:]), 5, device="cpu"), 3


def _tree_order_sum(pm, x, max_depth):
    """Each tree's leaf value by the plain walk, summed in f32 in tree order
    t = 0 .. T - 1 (the reference's order)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for t in range(pm.num_trees):
        acc = acc + forest_ops.gbdt_forward_plain(*(a[t:t + 1] for a in pm._arrays()), x,
                                                  max_depth)
    return acc


def test_forest_plan_tiles_the_rows():
    """K4's tile: K = 256 over more than 2 SMs, K = 16,384 in one wave (at
    most FOREST_BLOCKS blocks; 8 of 256 threads fit an SM), 64 rows a block
    at most, the repo's 40-tree forest one staged chunk; a forest too large
    for a block's shared memory is walked in chunks (4,000 trees of 4,000
    nodes: a tree a chunk) and raises nothing; only a malformed forest
    raises."""
    assert -(-256 // kernels.forest_plan(40, 7, 8, 46, 256).rows) > 2
    assert -(-16384 // kernels.forest_plan(40, 7, 8, 46, 16384).rows) <= kernels.FOREST_BLOCKS
    assert kernels.forest_plan(40, 7, 8, 46, 1 << 20).rows == 64
    assert kernels.forest_plan(40, 7, 8, 46, 1).rows >= 1
    for K in (1, 256, 16384):
        assert kernels.forest_plan(40, 7, 8, 46, K)[1:] == (40, True)
    assert kernels.forest_plan(4000, 4000, 8, 46, 256) == (8, 3, True)
    for bad in ((0, 7, 8, 46, 256), (40, 0, 8, 46, 256), (40, 7, 0, 46, 256),
                (40, 7, 8, 0, 256), (40, 7, 8, 46, -1)):
        with pytest.raises(ValueError):
            kernels.forest_plan(*bad)


@pytest.mark.parametrize("T,N,L,F", [(500, 30, 31, 46), (4000, 4000, 8, 46),
                                     (1000, 254, 255, 46), (3, 20000, 20001, 46)])
@pytest.mark.parametrize("K", [1, 256, 16384])
def test_forest_plan_chunks_large_forests(T, N, L, F, K):
    """Past one block's shared memory K4 walks the forest in chunks: a
    chunk's nodes, leaves, the tile's features and its leaf values fill the
    first budget of FOREST_CHUNK_SMEM (a quarter, a half or all of a block's
    shared memory) whose chunk holds FOREST_CHUNK_TREES trees, else the
    largest (4,000-node trees: 3 a chunk); the tile grows to 64 rows while
    the blocks outnumber the card's SMs (every block stages the whole
    forest); a single tree past shared memory (20,000 nodes: 320 KB) takes
    the global form, whose chunk of leaf values alone fits."""
    plan = kernels.forest_plan(T, N, L, F, K)
    assert 1 <= plan.rows <= 64 and 1 <= plan.trees <= T
    assert plan.rows == 64 or -(-K // plan.rows) <= kernels.FOREST_SMS
    if kernels._forest_smem(1, N, L, F, 1) > kernels.MAX_SMEM:
        assert not plan.staged and 4 * plan.trees * plan.rows <= kernels.MAX_SMEM // 2
        return
    assert plan.staged and plan.trees < T
    smem = lambda trees: kernels._forest_smem(trees, N, L, F, plan.rows)  # noqa: E731
    budget = next(b for b in kernels.FOREST_CHUNK_SMEM if smem(plan.trees) <= b)
    assert smem(plan.trees + 1) > budget
    assert plan.trees >= kernels.FOREST_CHUNK_TREES or budget == kernels.MAX_SMEM
    assert all(smem(kernels.FOREST_CHUNK_TREES) > b for b in kernels.FOREST_CHUNK_SMEM
               if b < budget)


def test_forest_wrapper_passes_its_plan_to_the_c_entry_point(monkeypatch):
    """K4 on stand-in CUDA tensors over a LightGBM dump of 500 trees of 31
    leaves (past a block's shared memory): one stract_forest call with
    forest_plan's rows, trees a chunk and form, counted once."""
    from stract_tpu_torch.bench_corpus import synthetic_lightgbm

    pm = LambdaMART.parse_lightgbm(synthetic_lightgbm(500, 31, 46, 0), device="cpu")
    x, out = torch.zeros((16384, 46)), torch.zeros(16384)
    called = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    kernels.reset_launches()
    kernels.forest(*pm._arrays(), x, out, pm.max_depth)
    plan = kernels.forest_plan(500, 30, 31, 46, 16384)
    assert plan.staged and plan.trees < 500
    assert [c[0] for c in called] == ["stract_forest"]
    assert called[0][1][7:] == (500, 30, 31, 16384, 46, pm.max_depth, plan.rows, plan.trees, 1, 0)
    assert kernels.LAUNCHES["forest"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 255, 256, 16384])
@pytest.mark.parametrize("shape", ["trained", "deep", "lightgbm_500x31", "lightgbm_1000x255",
                                   "lightgbm_3x12000"])
def test_forest_kernel_matches_plain(k, shape):
    """K4 bit-equal to a tree-order f32 sum of the plain walk's leaves, and
    within the forest tolerance of the plain version (which sums the trees
    in another order), at row counts off and on its tiles, on a trained
    forest, on one walked past max_depth with negative feature indices, on
    LightGBM dumps of 500 trees of 31 leaves and 1,000 of 255 (walked in
    chunks of trees: past one block's shared memory), and on 3 trees of
    12,000 leaves (a tree past a block: the global form)."""
    from stract_tpu_torch.bench_corpus import synthetic_lightgbm

    dev = _card()
    rng = np.random.default_rng(3)
    if shape.startswith("lightgbm"):
        trees, leaves = map(int, shape.split("_")[1].split("x"))
        pm = LambdaMART.parse_lightgbm(synthetic_lightgbm(trees, leaves, 46, trees), device="cpu")
        depth = pm.max_depth
    else:
        pm, depth = _deep_forest(rng) if shape == "deep" else (_forest(rng), 3)
    pm = pm.to(dev)
    x = torch.from_numpy(rng.normal(size=(k, 46)).astype(np.float32))
    x[0, 5] = float("nan")  # NaN goes right
    x = x.to(dev)
    n = kernels.LAUNCHES["forest"]
    got = forest_ops.gbdt_forward(*pm._arrays(), x, depth)
    assert kernels.LAUNCHES["forest"] == n + 1
    assert torch.equal(got.view(torch.int32), _tree_order_sum(pm, x, depth).view(torch.int32))
    ref = forest_ops.gbdt_forward_plain(*pm._arrays(), x, depth)
    leaf_sum = float(pm.leaf_value.abs().max(dim=1).values.sum())
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * leaf_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 128, 256, 1024, 2048])
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


# sequence lengths below, at and past the 64-row tiles of K5a and K14a
TAIL_T = [1, 16, 64, 65, 128, 193, 200, 256]


def _tail_masked(B: int, T: int, dev):
    """Row 0 keeps all keys; then half masked, fully masked (uniform
    weights, finite), the last fifth masked; cycled over B."""
    mask = torch.ones((B, T), dtype=torch.int32)
    for b in range(B):
        kind = b % 4
        if kind == 1:
            mask[b, T // 2:] = 0
        elif kind == 2:
            mask[b] = 0
        elif kind == 3:
            mask[b, T - max(1, T // 5):] = 0
    return mask.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", [1, 7, 16, 63, 64, 65, 128, 200, 256])
def test_attention_wgmma_kernel_matches_plain_at_tile_tails(T, B):
    """K5a (wgmma over 64-query tiles and 64-key chunks) at every tail of a
    tile: T below, at and past multiples of 64, with half, fully and tail
    masked rows; each call counted once."""
    dev = _card()
    g = torch.Generator().manual_seed(T * 10 + B)
    q, k, v = (torch.randn((B, T, 12, 32), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = _tail_masked(B, T, dev)
    n = kernels.LAUNCHES["attention"]
    got = E.attention(q, k, v, mask)
    assert kernels.LAUNCHES["attention"] == n + 1
    assert got.shape == (B, T, 384) and torch.isfinite(got.float()).all()
    want = E.attention_plain(q, k, v, mask)
    torch.testing.assert_close(got.float(), want.float(), rtol=ENC_RTOL, atol=2 * ENC_ATOL)
    if B == 4:  # the fully masked row: the mean of V
        torch.testing.assert_close(got[2].float(), want[2].float(), rtol=ENC_RTOL,
                                   atol=2 * ENC_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T", TAIL_T)
def test_attention_autograd_through_both_kernels_matches_plain_vjp(T):
    """E.attention's autograd Function on the card (K5a forward, K14a
    backward) against the plain twins' forward and VJP on the same card."""
    dev = _card()
    g = torch.Generator().manual_seed(T + 3)
    ins = [torch.randn((4, T, 12, 32), generator=g).to(dev, torch.bfloat16) for _ in range(3)]
    dout = torch.randn((4, T, 384), generator=g).to(dev, torch.bfloat16)
    mask = _tail_masked(4, T, dev)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    n = (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"])
    out = E.attention(*leaves, mask)
    grads = torch.autograd.grad(out, leaves, dout)
    assert (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"]) == \
        (n[0] + 1, n[1] + 1)
    torch.testing.assert_close(out.float(), E.attention_plain(*ins, mask).float(),
                               rtol=ENC_RTOL, atol=2 * ENC_ATOL)
    for a, b in zip(grads, E.attention_backward_plain(*ins, mask, dout)):
        _step_close(a, b)


# every head dim K5a and K14a take, at tile tails below, at and past the 256
# tokens of their one-pass forms, at 512 and past it
GRID_D, GRID_T = [16, 32, 64], [1, 65, 256, 257, 512, 1024, 1100]


@pytest.mark.cuda
@pytest.mark.parametrize("T", GRID_T)
@pytest.mark.parametrize("D", GRID_D)
def test_attention_kernels_match_plain_at_every_head_dim(D, T):
    """K5a and K14a at head dims 16, 32 and 64 and T = 1 .. 512 (one pass,
    or chunked past 256 tokens, past 128 at d = 64), rows half, fully and
    tail masked: the forward at rtol 2^-7, atol 2e-2, the backward within
    one bf16 step, each call counted once, a second call of each bit-equal
    to the first, the fully masked row's dQ 0."""
    dev = _card()
    g = torch.Generator().manual_seed(D * 1000 + T)
    q, k, v = (torch.randn((4, T, 3, D), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    dout = torch.randn((4, T, 3 * D), generator=g).to(dev, torch.bfloat16)
    mask = _tail_masked(4, T, dev)
    n = (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"])
    out = E.attention_forward(q, k, v, mask)
    grads = E.attention_backward(q, k, v, mask, dout)
    assert (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"]) == \
        (n[0] + 1, n[1] + 1)
    assert out.shape == (4, T, 3 * D) and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), E.attention_plain(q, k, v, mask).float(),
                               rtol=ENC_RTOL, atol=2 * ENC_ATOL)
    for a, b in zip(grads, E.attention_backward_plain(q, k, v, mask, dout)):
        _step_close(a, b)
    assert torch.equal(E.attention_forward(q, k, v, mask), out)
    for a, b in zip(grads, E.attention_backward(q, k, v, mask, dout)):
        assert torch.equal(a, b)
    assert not grads[0][2].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,D", [(16384, 2, 64), (4096, 12, 32)])
def test_attention_kernels_match_plain_past_the_staged_lengths(T, H, D):
    """K5a and K14a at B = 1 past the lengths at which the chunked kernels'
    mask and statistics, staged whole, would have left a block's shared
    memory (16,384 tokens at d = 64): the forward and the backward within
    one bf16 step of the plain versions' largest magnitude (a typical output
    there, ~1/sqrt(13,000), is under the shorter rows' atol), the row's last
    fifth masked, each call counted once, a second call bit-equal."""
    dev = _card()
    g = torch.Generator().manual_seed(T + D)
    q, k, v = (torch.randn((1, T, H, D), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    dout = torch.randn((1, T, H * D), generator=g).to(dev, torch.bfloat16)
    mask = torch.ones((1, T), dtype=torch.int32)
    mask[0, T - T // 5:] = 0
    mask = mask.to(dev)
    n = (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"])
    out = E.attention_forward(q, k, v, mask)
    grads = E.attention_backward(q, k, v, mask, dout)
    assert (kernels.LAUNCHES["attention"], kernels.LAUNCHES["attention_backward"]) == \
        (n[0] + 1, n[1] + 1)
    _step_close(out, E.attention_plain(q, k, v, mask))
    for a, b in zip(grads, E.attention_backward_plain(q, k, v, mask, dout)):
        _step_close(a, b)
    assert torch.equal(E.attention_forward(q, k, v, mask), out)
    for a, b in zip(grads, E.attention_backward(q, k, v, mask, dout)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_main_train_encoders_runs_on_the_card_at_its_defaults(tmp_path, capsys):
    """`main.py train-encoders both INDEX OUT --steps 2` at its defaults
    (--device cuda, BertConfig.tiny: head dim 16) on a 3,000-doc corpus
    written by the port: both encoders train through K5a and K14a, their
    losses finite, and save."""
    import re

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.main import main

    _card()
    index = bc.ensure_corpus(str(tmp_path), 3000, seed=0, log=lambda *a: None)
    kernels.reset_launches()
    main(["train-encoders", "both", index, str(tmp_path / "out"), "--steps", "2"])
    assert kernels.LAUNCHES["attention"] > 0 and kernels.LAUNCHES["attention_backward"] > 0
    losses = [float(x) for pair in re.findall(r"\(loss (\S+) → (\S+)\)", capsys.readouterr().out)
              for x in pair]
    assert len(losses) == 4 and np.isfinite(losses).all()
    for kind in ("dual", "cross"):
        assert (tmp_path / "out" / f"{kind}_encoder" / "config.json").exists()


def _bf16_steps(a, b):
    """The largest distance between a and b, bf16 tensors of one shape, in
    bf16 steps (0: equal, 1: neighbours; +0 and -0 are one value), over the
    elements where they differ by more than f32 rounding of the largest |b|
    (2^-16 max |b|: a value that cancels to near 0 is as exact as its
    terms)."""
    if not a.numel():
        return 0

    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    far = (a.float() - b.float()).abs() > 2 ** -16 * float(b.float().abs().max())
    return int(((ordinal(a) - ordinal(b)).abs() * far).max())


def test_bf16_steps_counts_representable_values():
    """_bf16_steps: neighbours are one step apart, across 0 and across a
    power of two, and values within f32 rounding of the largest count 0."""
    bf = lambda *v: torch.tensor(v, dtype=torch.float32).to(torch.bfloat16)  # noqa: E731
    assert _bf16_steps(bf(1.0, -2.0, 0.0), bf(1.0, -2.0, -0.0)) == 0
    assert _bf16_steps(bf(1.0 + 2 ** -7, 4.0), bf(1.0, 4.0)) == 1
    assert _bf16_steps(bf(1.0 + 2 ** -6, 4.0), bf(1.0, 4.0)) == 2
    assert _bf16_steps(bf(2.0 - 2 ** -7, 4.0), bf(2.0, 4.0)) == 1
    assert _bf16_steps(bf(1e-30, 4.0), bf(-1e-30, 4.0)) == 0  # within 2^-16 * 4
    assert _bf16_steps(bf(1e-3, 4.0), bf(-1e-3, 4.0)) > 1
    assert _bf16_steps(bf(), bf()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 384, 768, 1000])
@pytest.mark.parametrize("M", [0, 1, 4096, 4099])
def test_layernorm_and_gelu_kernels_match_plain(M, N):
    """K5b (CUDA, a warp a row) at BertConfig.tiny's, MiniLM's and
    BERT-base's widths and at 1,000, over no rows, one, 4,096 and an odd
    4,099: within one bf16 step of the twin, a second call bit-equal, one
    launch counted (none for no rows); K5c at 4,096 x 1,536."""
    dev = _card()
    g = torch.Generator().manual_seed(M + N)
    x, r = (torch.randn((M, N), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    w = (1 + 0.1 * torch.randn(N, generator=g)).to(dev)
    b = (0.1 * torch.randn(N, generator=g)).to(dev)
    n = kernels.LAUNCHES["add_layernorm"]
    got = E.add_layernorm(x, r, w, b, 1e-12)
    assert kernels.LAUNCHES["add_layernorm"] == n + (M > 0)
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _bf16_steps(got, E.add_layernorm_plain(x, r, w, b, 1e-12)) <= 1
    assert torch.equal(E.add_layernorm(x, r, w, b, 1e-12), got)
    y = torch.randn((32 * 128, 1536), generator=g).to(dev, torch.bfloat16)
    bias = torch.randn(1536, generator=g).to(dev, torch.bfloat16)
    torch.testing.assert_close(E.bias_gelu(y, bias).float(), E.bias_gelu_plain(y, bias).float(),
                               rtol=ENC_RTOL, atol=ENC_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4096, 4099])
def test_bias_gelu_kernel_matches_plain_at_row_tails(M):
    """K5c (CUDA, 16-byte vectors) at the serving shape 4096 x 1536 and at
    an odd row count, with a non-zero bias: the tolerance of
    test_layernorm_and_gelu_kernels_match_plain; each call counted once."""
    dev = _card()
    g = torch.Generator().manual_seed(M)
    y = (3 * torch.randn((M, 1536), generator=g)).to(dev, torch.bfloat16)
    bias = torch.randn(1536, generator=g).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["bias_gelu"]
    got = E.bias_gelu(y, bias)
    assert kernels.LAUNCHES["bias_gelu"] == n + 1
    assert got.shape == (M, 1536) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), E.bias_gelu_plain(y, bias).float(),
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
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", TAIL_T)
def test_attention_backward_kernel_matches_plain(T, B):
    """K14a (the dQ and dK / dV kernels on wgmma) at every tail of a tile,
    with half, fully and tail masked rows: within one bf16 step of the
    twin, the fully masked row's dQ 0, each call counted once, and a second
    call bit-equal to the first (no atomics)."""
    dev = _card()
    g = torch.Generator().manual_seed(T * 10 + B)
    q, k, v = (torch.randn((B, T, 12, 32), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    dout = torch.randn((B, T, 384), generator=g).to(dev, torch.bfloat16)
    mask = _tail_masked(B, T, dev)
    n = kernels.LAUNCHES["attention_backward"]
    got = E.attention_backward(q, k, v, mask, dout)
    assert kernels.LAUNCHES["attention_backward"] == n + 1
    for a, b in zip(got, E.attention_backward_plain(q, k, v, mask, dout)):
        _step_close(a, b)
    for a, b in zip(got, E.attention_backward(q, k, v, mask, dout)):
        assert torch.equal(a, b)
    if B == 4:
        assert not got[0][2].float().any()


@pytest.mark.cuda
def test_attention_backward_scratch_holds_each_rows_statistics():
    """At T = 256 (the largest shared-memory tiles, four chunks a block) the
    dQ kernel's scratch holds each query row's max, sum and D of the plain
    softmax: max and sum rtol 1e-5 (f32 sums in another order), D within
    one bf16 step of its largest magnitude (dP rounds to bf16); the dK / dV
    kernel reads it back, so the gradients match the twin."""
    dev = _card()
    B, T, H = 8, 256, 12
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((B, T, H, 32), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    dout = torch.randn((B, T, H * 32), generator=g).to(dev, torch.bfloat16)
    mask = _tail_masked(B, T, dev)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    stats = torch.full((B, H, T, 3), float("nan"), device=dev)
    kernels.attention_backward(q, k, v, mask, dout, *grads, stats)
    qf, kf, vf = (t.float() for t in (q, k, v))
    keep = (mask != 0)[:, None, None, :]
    x = torch.where(keep, torch.einsum("bthd,bshd->bhts", qf, kf) / np.sqrt(32),
                    torch.finfo(torch.float32).min)
    mx = x.amax(dim=-1)
    e = torch.exp(x - mx[..., None])
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bthd,bshd->bhts", dout.view(B, T, H, 32).float(), vf)
    dsum = (p * dp.to(torch.bfloat16).float()).sum(dim=-1)
    torch.testing.assert_close(stats[..., 0], mx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stats[..., 1], e.sum(dim=-1), rtol=1e-5, atol=0)
    _step_close(stats[..., 2], dsum)
    for a, b in zip(grads, E.attention_backward_plain(q, k, v, mask, dout)):
        _step_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(8192, 384), (257, 64), (1000, 768), (33, 1024), (5, 40),
                                 (257, 65)])
def test_layernorm_and_gelu_backward_kernels_match_plain(M, N):
    """K14b (CUDA, a warp a row) at every width the configurations use (64,
    384, 768, 1,024), at 40 and at an odd 65 (single-element loads), M odd or
    not a multiple of the grid's rows: ds within one bf16 step of the twin,
    dweight and dbias rtol 1e-4, one launch counted, a second call bit-equal;
    K14c at (M, 4 N)."""
    dev = _card()
    g = torch.Generator().manual_seed(1)
    x, r, dy = (torch.randn((M, N), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    w = (1 + 0.1 * torch.randn(N, generator=g)).to(dev)
    n = kernels.LAUNCHES["add_layernorm_backward"]
    ds, dw, db = E.add_layernorm_backward(x, r, w, 1e-12, dy)
    assert kernels.LAUNCHES["add_layernorm_backward"] == n + 1
    ps, pw, pb = E.add_layernorm_backward_plain(x, r, w, 1e-12, dy)
    _step_close(ds, ps)
    for a, b in ((dw, pw), (db, pb)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(E.add_layernorm_backward(x, r, w, 1e-12, dy),
                                                 (ds, dw, db)))
    y, dout = (torch.randn((M, 4 * N), generator=g).to(dev, torch.bfloat16) for _ in range(2))
    bias = (0.5 * torch.randn(4 * N, generator=g)).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["bias_gelu_backward"]
    gy, gb = E.bias_gelu_backward(y, bias, dout)
    assert kernels.LAUNCHES["bias_gelu_backward"] == n + 1
    py, pb = E.bias_gelu_backward_plain(y, bias, dout)
    _step_close(gy, py)
    _step_close(gb, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [128, 1536, 3072, 1000])
@pytest.mark.parametrize("M", [1, 33, 8192])
def test_bias_gelu_backward_kernel_matches_plain(M, N):
    """K14c (CUDA: 16-byte pieces at N = 128, 1,536, 3,072; single elements
    at 1,000) at one row, an odd row count and the dual step's 8,192 rows:
    dy and db within one bf16 step of the twin's largest magnitude, one
    launch counted, a second call bit-equal."""
    dev = _card()
    g = torch.Generator().manual_seed(M + N)
    y, dout = ((2 * torch.randn((M, N), generator=g)).to(dev, torch.bfloat16) for _ in range(2))
    bias = (0.5 * torch.randn(N, generator=g)).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["bias_gelu_backward"]
    gy, gb = E.bias_gelu_backward(y, bias, dout)
    assert kernels.LAUNCHES["bias_gelu_backward"] == n + 1
    py, pb = E.bias_gelu_backward_plain(y, bias, dout)
    _step_close(gy, py)
    _step_close(gb, pb)
    assert all(torch.equal(a, b) for a, b in zip(E.bias_gelu_backward(y, bias, dout), (gy, gb)))


@pytest.mark.cuda
def test_bias_gelu_backward_kernel_takes_misaligned_views():
    """K14c on contiguous views that start 2 bytes past a 16-byte boundary
    (single-element loads at a width that is a multiple of 8): dy and db
    within one bf16 step of the twin, a second call bit-equal."""
    dev = _card()
    M, N = 300, 1536
    g = torch.Generator().manual_seed(3)
    y, dout = (torch.randn(M * N + 1, generator=g).to(dev, torch.bfloat16)[1:].view(M, N)
               for _ in range(2))
    bias = (0.5 * torch.randn(N + 1, generator=g)).to(dev, torch.bfloat16)[1:]
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 2 for t in (y, dout, bias))
    gy, gb = E.bias_gelu_backward(y, bias, dout)
    py, pb = E.bias_gelu_backward_plain(y, bias, dout)
    _step_close(gy, py)
    _step_close(gb, pb)
    assert all(torch.equal(a, b) for a, b in zip(E.bias_gelu_backward(y, bias, dout), (gy, gb)))


@pytest.mark.cuda
def test_layernorm_backward_kernel_takes_misaligned_views():
    """K14b on contiguous views that start 2 bytes past an 8-byte boundary
    (single-element loads at a width that is a multiple of 4): ds within one
    bf16 step of the twin, dweight and dbias rtol 1e-4, a second call
    bit-equal."""
    dev = _card()
    M, N = 300, 384
    g = torch.Generator().manual_seed(2)
    x, r, dy = (torch.randn(M * N + 1, generator=g).to(dev, torch.bfloat16)[1:].view(M, N)
                for _ in range(3))
    assert all(t.is_contiguous() and t.data_ptr() % 8 == 2 for t in (x, r, dy))
    w = (1 + 0.1 * torch.randn(N, generator=g)).to(dev)
    ds, dw, db = E.add_layernorm_backward(x, r, w, 1e-12, dy)
    ps, pw, pb = E.add_layernorm_backward_plain(x, r, w, 1e-12, dy)
    _step_close(ds, ps)
    for a, b in ((dw, pw), (db, pb)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(E.add_layernorm_backward(x, r, w, 1e-12, dy),
                                                 (ds, dw, db)))


def pool_mask(B: int, T: int, g):
    """K5d's test mask: random lengths 1..T, the first row whole and, past
    one row, the last fully masked."""
    lens = torch.randint(1, T + 1, (B, 1), generator=g)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    return (torch.arange(T) < lens).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 17, 128, 512, 1024, 4096])
@pytest.mark.parametrize("B", [1, 64, 256])
@pytest.mark.parametrize("normalize", [True, False])
def test_mean_pool_kernels_match_plain(normalize, B, T):
    """K5d (CUDA) forward and backward at one row, the dual step's 64 and
    256, over 1, 17, 128, 512, 1,024 and 4,096 tokens, a fully masked row past one row,
    normalised and not: pooled, raw and dh within one bf16 step of the
    twin's largest magnitude, second calls bit-equal, each call counted."""
    dev = _card()
    g = torch.Generator().manual_seed(B * T + normalize)
    h = torch.randn((B, T, 384), generator=g).to(dev, torch.bfloat16)
    mask = pool_mask(B, T, g).to(dev)
    n = kernels.LAUNCHES["mean_pool"]
    pooled, raw = E.mean_pool_forward(h, mask, normalize)
    assert kernels.LAUNCHES["mean_pool"] == n + 1
    ref_pooled, ref_raw = E.mean_pool_plain(h, mask, normalize)
    _step_close(pooled, ref_pooled)
    _step_close(raw, ref_raw)
    cot = torch.randn((B, 384), generator=g).to(dev)
    dh = E.mean_pool_backward(mask, raw, cot, normalize, torch.bfloat16)
    assert kernels.LAUNCHES["mean_pool"] == n + 2
    _step_close(dh, E.mean_pool_backward_plain(mask, raw, cot, normalize, torch.bfloat16))
    again = E.mean_pool_forward(h, mask, normalize)
    assert torch.equal(again[0], pooled) and torch.equal(again[1], raw)
    assert torch.equal(E.mean_pool_backward(mask, raw, cot, normalize, torch.bfloat16), dh)


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


# ---- K15a-d: the MoE router and select-and-scale, the loss heads, the bf16 AdamW -----------
def test_moe_and_loss_wrappers_never_take_the_plain_path(monkeypatch):
    """On CUDA tensors the router, select-and-scale, loss heads and bf16
    AdamW launch their kernels (stand-ins here), never the plain twins."""
    from stract_tpu_torch import optim
    from stract_tpu_torch.ops import losses as LO
    from stract_tpu_torch.ops import moe as MO

    called = []

    class Kern:
        def __init__(self, name):
            self.name = name

        def __getitem__(self, grid):
            return lambda *a, **k: called.append(self.name)

    for mod, names in ((MO, ("router_plain", "router_backward_plain", "select_scale_plain",
                             "select_scale_backward_plain")),
                       (LO, ("pair_loss_plain", "info_nce_plain")),
                       (optim, ("adamw_bf16_update_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "moe_router", lambda *a: called.append("router"))
    monkeypatch.setattr(kernels, "moe_router_backward", lambda *a: called.append("router_bwd"))
    monkeypatch.setattr(kernels, "moe_select", lambda *a: called.append("select"))
    monkeypatch.setattr(kernels, "moe_select_backward", lambda *a: called.append("select_bwd"))
    monkeypatch.setattr(kernels, "pair_loss", lambda *a: called.append("pair"))
    monkeypatch.setattr(kernels, "info_nce", lambda *a: called.append("info_nce"))
    monkeypatch.setattr(optim, "_triton_kernels", lambda: {"adamw_bf16": Kern("adamw_bf16")})
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    top = torch.zeros(8, dtype=torch.int32)
    MO.router_forward(bf(8, 64), torch.zeros(4, 64), torch.zeros(4))
    MO.router_backward(bf(8, 64), torch.zeros(8, 4), top, bf(8), torch.zeros(4, 64))
    MO.select_scale_forward(bf(4, 8, 64), top, bf(8))
    MO.select_scale_backward(bf(4, 8, 64), top, bf(8), bf(8, 64))
    LO.pair_loss_forward(torch.zeros(8), torch.zeros(8))
    LO.pair_loss_forward(torch.zeros(8), torch.zeros(8), torch.zeros(8), torch.zeros(8), 0.5)
    LO.info_nce_forward(torch.zeros(8, 8))
    optim.adamw_bf16_update(bf(64), bf(64), bf(64), bf(64), 1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.1,
                            0.001)
    assert called == ["router", "router_bwd", "select", "select_bwd", "pair", "pair",
                      "info_nce", "adamw_bf16"]


def test_moe_kernel_arguments_are_checked(monkeypatch):
    from stract_tpu_torch import optim
    from stract_tpu_torch.ops import losses as LO
    from stract_tpu_torch.ops import moe as MO

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    top = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # more experts than the router keeps in registers
        kernels.moe_router(bf(8, 64), torch.zeros(32, 64), torch.zeros(32), torch.zeros(8, 32),
                           top, bf(8))
    with pytest.raises(ValueError):  # an f32 router input
        kernels.moe_router(torch.zeros(8, 64), torch.zeros(4, 64), torch.zeros(4),
                           torch.zeros(8, 4), top, bf(8))
    with pytest.raises(ValueError):  # an f32 gate
        MO.select_scale_forward(bf(4, 8, 64), top, torch.zeros(8))
    with pytest.raises(ValueError):  # i64 expert indices
        MO.select_scale_forward(bf(4, 8, 64), top.long(), bf(8))
    with pytest.raises(ValueError):  # a cotangent of another width
        MO.select_scale_backward(bf(4, 8, 64), top, bf(8), bf(8, 32))
    with pytest.raises(ValueError):  # bf16 scores
        LO.pair_loss_forward(bf(8), bf(8))
    with pytest.raises(ValueError):  # logits that are not square
        LO.info_nce_forward(torch.zeros(8, 4))
    with pytest.raises(ValueError):  # f32 buffers through the bf16 update
        optim.adamw_bf16_update(*[torch.zeros(8)] * 4, 1e-3, 0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    for name in ("moe_router", "moe_select", "pair_loss", "info_nce", "adamw_bf16"):
        assert name in kernels.LAUNCHES


def test_moe_select_checks_its_arguments_before_any_build(monkeypatch):
    """kernels.moe_select and moe_select_backward raise ValueError on a wrong
    dtype or shape before they build or launch anything."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: pytest.fail("built before the check"))
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    top = torch.zeros(8, dtype=torch.int32)
    n = kernels.LAUNCHES["moe_select"]
    for args in ((torch.zeros(4, 8, 64), top, bf(8)),  # f32 expert rows
                 (bf(4, 8, 64), top.long(), bf(8)),  # i64 expert indices
                 (bf(4, 8, 64), top, torch.zeros(8)),  # an f32 gate
                 (bf(8, 64), top, bf(8)),  # no expert axis
                 (bf(4, 8, 64), top[:7], bf(8)),  # fewer indices than tokens
                 (bf(4, 8, 64), top, bf(9))):  # more gates than tokens
        with pytest.raises(ValueError):
            kernels.moe_select(*args)
        with pytest.raises(ValueError):
            kernels.moe_select_backward(*args, bf(8, 64))
    with pytest.raises(ValueError):  # a cotangent of another width
        kernels.moe_select_backward(bf(4, 8, 64), top, bf(8), bf(8, 32))
    with pytest.raises(ValueError):  # a transposed cotangent
        kernels.moe_select_backward(bf(4, 8, 64), top, bf(8), bf(64, 8).t())
    assert kernels.LAUNCHES["moe_select"] == n


class _MoELib:
    """A stand-in for csrc/moe.cu's library: each entry point records its
    name and arguments and returns success."""

    def __init__(self, called):
        self.called = called

    def __getattr__(self, name):
        if not name.startswith("stract_moe_"):
            raise AttributeError(name)
        return lambda *args: self.called.append((name, args)) or 0


@pytest.mark.parametrize("N, H, E_", [(4096, 384, 4), (17, 100, 16), (1, 64, 1), (0, 64, 4)])
def test_moe_kernels_reach_their_c_entry_points(monkeypatch, N, H, E_):
    """K15a's backward and K15b's two directions on CUDA tensors (stand-ins):
    one C call each, counted once; the router's dw, db and the fixed grid's
    partials one allocation (dw at its start, db after it, the partials of
    min(MOE_BWD_BLOCKS, ceil(N / MOE_BWD_TOKENS)) blocks after db), d_out and
    d_gate one allocation; N = 0 launches no select and the router refuses
    it before any call."""
    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _MoELib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    bf = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    top = torch.zeros(N, dtype=torch.int32)
    kernels.reset_launches()
    if N:
        dx, dw, db = kernels.moe_router_backward(bf(N, H), torch.zeros(N, E_), top, bf(N),
                                                 torch.zeros(E_, H))
        (name, args), = called
        assert name == "stract_moe_router_backward" and kernels.LAUNCHES["moe_router"] == 1
        *_, n, h, e, blocks, dx_ptr, out_ptr, stream = args
        assert (n, h, e, stream) == (N, H, E_, 0) and dx_ptr == dx.data_ptr()
        assert blocks == min(kernels.MOE_BWD_BLOCKS, -(-N // kernels.MOE_BWD_TOKENS))
        assert dw.shape == (E_, H) and db.shape == (E_,) and dx.shape == (N, H)
        assert dw.data_ptr() == out_ptr and db.data_ptr() == out_ptr + 4 * E_ * H
        assert dw.untyped_storage().nbytes() == 4 * (blocks + 1) * (E_ * H + E_)
        called.clear()
    else:
        with pytest.raises(ValueError):
            kernels.moe_router_backward(bf(N, H), torch.zeros(N, E_), top, bf(N),
                                        torch.zeros(E_, H))
    out = kernels.moe_select(bf(E_, N, H), top, bf(N))
    d_out, d_gate = kernels.moe_select_backward(bf(E_, N, H), top, bf(N), bf(N, H))
    assert out.shape == (N, H) and d_out.shape == (E_, N, H) and d_gate.shape == (N,)
    assert d_out.untyped_storage().data_ptr() == d_gate.untyped_storage().data_ptr()
    if not N:
        assert called == [] and kernels.LAUNCHES["moe_select"] == 0
        return
    assert [c[0] for c in called] == ["stract_moe_select", "stract_moe_select_backward"]
    assert kernels.LAUNCHES["moe_select"] == 2
    *_, e, n, h, d_ptr, g_ptr, stream = called[1][1]
    assert (e, n, h, stream) == (E_, N, H, 0)
    assert d_ptr == d_out.data_ptr() and g_ptr == d_gate.data_ptr() == d_ptr + 2 * E_ * N * H


def test_router_backward_on_the_card_is_one_kernel_call(monkeypatch):
    """On (stand-in) CUDA tensors the router's VJP is one
    kernels.moe_router_backward call: autograd returns that call's dx, dw
    and db as the cotangents of x and of the router's weight and bias, and
    runs no product or sum of its own."""
    from stract_tpu_torch.ops import moe as MO

    rng = np.random.default_rng(3)
    N, H, E_ = 8, 64, 4
    x = torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.1, (E_, H)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, E_).astype(np.float32))
    outs = (torch.from_numpy(rng.normal(size=(N, H)).astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(rng.normal(size=(E_, H)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=E_).astype(np.float32)))
    calls = []

    def router(x_, w_, b_, probs, top, gate):
        for out, ref in zip((probs, top, gate), MO.router_plain(x_, w_, b_)):
            out.copy_(ref)

    def backward(*args):
        calls.append(args)
        return tuple(t.clone() for t in outs)

    monkeypatch.setattr(kernels, "moe_router", router)
    monkeypatch.setattr(kernels, "moe_router_backward", backward)
    monkeypatch.setattr(MO, "router_backward_plain", lambda *a: pytest.fail("plain twin"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    top, gate = MO.router(*leaves)
    dgate = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(torch.bfloat16)
    grads = torch.autograd.grad(gate, leaves, dgate)
    assert len(calls) == 1
    xs, probs, tops, dg, ws = calls[0]
    assert torch.equal(xs, x) and torch.equal(ws, w) and torch.equal(dg, dgate)
    assert torch.equal(tops, top) and probs.shape == (N, E_)
    for got, want in zip(grads, outs):
        assert torch.equal(got, want)


def test_adamw_groups_f32_and_bf16_parameters():
    """f32 and bf16 parameters each live in their own dtype's flat buffers;
    other dtypes are refused."""
    from stract_tpu_torch.optim import AdamW

    w = torch.nn.Parameter(torch.ones(3, 2))
    e = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = AdamW([w, e], 1e-2)
    (w.sum() + e.float().sum()).backward()
    assert e.grad.dtype == torch.bfloat16 and e.grad.abs().sum() > 0
    opt.step()
    groups = opt.groups
    assert set(groups) == {torch.float32, torch.bfloat16}
    assert torch.equal(groups[torch.bfloat16].flat, e.detach()) and e.dtype == torch.bfloat16
    assert groups[torch.bfloat16].m.dtype == torch.bfloat16
    assert float(e.detach()[0]) < 1.0 and float(w.detach()[0, 0]) < 1.0
    with pytest.raises(ValueError):
        AdamW([torch.nn.Parameter(torch.ones(2, dtype=torch.float16))], 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("E_", [1, 4, 16])
@pytest.mark.parametrize("H", [64, 100, 384, 768, 1032, 1100])
@pytest.mark.parametrize("N", [1, 17, 4096])
def test_moe_router_kernel_matches_plain(N, H, E_):
    """K15a at every expert bucket (E = 1, 4, 16), 16-byte pieces (H = 64,
    384, 768, 1,032) and single elements (H = 100, 1,100), the router's
    weight staged in shared memory and, past 64 KB (E = 16 at H = 1,032 and
    1,100), read through L1, with a tied router row (the
    last expert's row and bias are the second's: it never wins): the
    probabilities within rtol 1e-5, the chosen expert equal where the top
    two probabilities differ by more than 1e-5, the gate and dx within one
    bf16 step; the router's weight and bias gradients within rtol 1e-5,
    atol 1e-6 x max |plain| (f32 sums over the N tokens in another order),
    and a second backward call bit-equal (fixed-order sums)."""
    from stract_tpu_torch.ops import moe as MO

    dev = _card()
    g = torch.Generator().manual_seed(11)
    x = torch.randn((N, H), generator=g).to(dev, torch.bfloat16)
    w = (0.05 * torch.randn((E_, H), generator=g)).to(dev)
    b = (0.1 * torch.randn(E_, generator=g)).to(dev)
    if E_ > 2:
        w[-1], b[-1] = w[1], b[1]
    pk, tk, gk = MO.router_forward(x, w, b)
    pp, tp, gp = MO.router_plain(x, w, b)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-7)
    clear = torch.ones(N, dtype=torch.bool, device=dev)
    if E_ > 1:
        top2 = pp.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    assert torch.equal(tk[clear], tp[clear])
    assert E_ <= 2 or not bool((tk == E_ - 1).any())
    _step_close(gk, gp)
    dgate = torch.randn(N, generator=g).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["moe_router"]
    got = MO.router_backward(x, pp, tp, dgate, w)
    assert kernels.LAUNCHES["moe_router"] == n + 1  # the column sum counts with its kernel
    (dxk, dwk, dbk), (dxp, dwp, dbp) = got, MO.router_backward_plain(x, pp, tp, dgate, w)
    _step_close(dxk, dxp)
    for k, p in ((dwk, dwp), (dbk, dbp)):
        assert k.shape == p.shape and k.dtype == torch.float32
        torch.testing.assert_close(k, p, rtol=1e-5, atol=1e-6 * float(p.abs().max()))
    assert all(torch.equal(a, c) for a, c in zip(MO.router_backward(x, pp, tp, dgate, w), got))


@pytest.mark.cuda
@pytest.mark.parametrize("E_", [1, 4, 16])
@pytest.mark.parametrize("H", [64, 100, 384, 768])
@pytest.mark.parametrize("N", [1, 17, 4096])
def test_moe_select_kernels_match_plain(N, H, E_):
    """K15b (csrc/moe.cu) over the same shapes: the forward and the experts'
    cotangent bit-equal to the plain versions (one rounding of a product
    that is exact in f32), the gate's cotangent within one bf16 step (an f32
    row sum in another order); a call counted once; N = 0 launches
    nothing."""
    from stract_tpu_torch.ops import moe as MO

    dev = _card()
    g = torch.Generator().manual_seed(12)
    out_e = torch.randn((E_, N, H), generator=g).to(dev, torch.bfloat16)
    top = torch.randint(0, E_, (N,), generator=g).to(dev, torch.int32)
    gate = torch.rand(N, generator=g).to(dev, torch.bfloat16)
    n = kernels.LAUNCHES["moe_select"]
    assert torch.equal(MO.select_scale_forward(out_e, top, gate),
                       MO.select_scale_plain(out_e, top, gate))
    gr = torch.randn((N, H), generator=g).to(dev, torch.bfloat16)
    (dk, gk), (dp, gp) = MO.select_scale_backward(out_e, top, gate, gr), \
        MO.select_scale_backward_plain(out_e, top, gate, gr)
    assert kernels.LAUNCHES["moe_select"] == n + 2
    assert torch.equal(dk, dp)
    _step_close(gk, gp)
    empty = MO.select_scale_backward(out_e[:, :0], top[:0], gate[:0], gr[:0])
    assert empty[0].shape == (E_, 0, H) and empty[1].shape == (0,)
    assert MO.select_scale_forward(out_e[:, :0], top[:0], gate[:0]).shape == (0, H)
    assert kernels.LAUNCHES["moe_select"] == n + 2


@pytest.mark.cuda
def test_loss_head_kernels_match_plain():
    """K15c (csrc/losses.cu) at B = 1, 8, 32 (the pair head's batch), 64
    (InfoNCE's), 65 (past one block's 32 warps and past the one-block form),
    256: both heads within rtol 1e-5 of their twins, a second call
    bit-equal, each call counted once under its head's name; the InfoNCE
    head's one-block and grid forms bit-equal."""
    from stract_tpu_torch.ops import losses as LO

    dev = _card()
    g = torch.Generator().manual_seed(13)
    for B in (1, 8, 32, 64, 65, 256):
        sp, sn, tp, tn = (torch.randn(B, generator=g).to(dev) for _ in range(4))
        for args in ((sp, sn), (sp, sn, tp, tn, 0.5)):
            n = kernels.LAUNCHES["pair_loss"]
            got = LO.pair_loss_forward(*args)
            assert kernels.LAUNCHES["pair_loss"] == n + 1
            for a, b in zip(got, LO.pair_loss_plain(*args)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
            assert all(torch.equal(a, b) for a, b in zip(LO.pair_loss_forward(*args), got))
        logits = 20.0 * torch.randn((B, B), generator=g).to(dev)
        n = kernels.LAUNCHES["info_nce"]
        got = LO.info_nce_forward(logits)
        assert kernels.LAUNCHES["info_nce"] == n + 1
        for a, b in zip(got, LO.info_nce_plain(logits)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        assert all(torch.equal(a, b) for a, b in zip(LO.info_nce_forward(logits), got))
        for blocks in (1, -(-B // kernels.INFO_NCE_GRID_ROWS)):  # either form: the same bits
            loss, d = torch.empty((), device=dev), torch.empty_like(logits)
            kernels.info_nce(logits, loss, d, blocks=blocks)
            assert torch.equal(loss, got[0]) and torch.equal(d, got[1]), blocks


@pytest.mark.cuda
def test_adamw_bf16_kernel_matches_plain():
    from stract_tpu_torch import optim

    dev = _card()
    g = torch.Generator().manual_seed(14)
    n = 1 << 20
    bf = torch.bfloat16
    state = [(0.02 * torch.randn(n, generator=g)).to(dev, bf), torch.zeros(n, device=dev,
                                                                           dtype=bf),
             torch.zeros(n, device=dev, dtype=bf)]
    plain = [t.clone() for t in state]
    for step in range(1, 4):
        grad = (0.01 * torch.randn(n, generator=g)).to(dev, bf)
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        optim.adamw_bf16_update(state[0], grad, state[1], state[2], 1e-3, 0.9, 0.999, 1e-8,
                                1e-4, bc1, bc2)
        optim.adamw_bf16_update_plain(plain[0], grad, plain[1], plain[2], 1e-3, 0.9, 0.999,
                                      1e-8, 1e-4, bc1, bc2)
    for a, b in zip(state, plain):
        torch.testing.assert_close(a.float(), b.float(), rtol=STEP, atol=1e-12)


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
    """CPU tensors take the plain versions (the BFS step's over the CSR's
    edges, the same as over the forward edges); a CUDA tensor calls the
    kernel (stand-ins here); a register row or a BFS state the kernel does
    not take raises."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import shortest_path as SP

    src, dst = _graph(50, 10)
    regs = torch.from_numpy(hll_ops.init_registers(50, 4))
    np.testing.assert_array_equal(hll_ops.merge_iteration(regs, src, dst).numpy(),
                                  hll_ops.merge_iteration_plain(regs, src, dst).numpy())
    state = SP.bfs_start(50, [0, 7, 9], "cpu")
    for level in range(3):
        got, changed = SP.frontier_step(state, in_csr(50, src, dst, "cpu"), level)
        want, want_changed = SP.frontier_step_plain(state, src, dst, level)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(changed, want_changed)
        state = got
    called = []
    for name in ("hll_merge", "hll_estimate", "bfs_step"):
        monkeypatch.setattr(kernels, name, lambda *a, name=name, **k: called.append(name))
    for name in ("merge_iteration_plain", "estimate_sizes_plain"):
        monkeypatch.setattr(hll_ops, name, lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(SP, "frontier_step_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    csr = InCSR(torch.zeros(51, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.int32))
    hll_ops.merge_csr(regs, csr)
    hll_ops.estimate_sizes(regs)
    bits = torch.zeros((50, 1), dtype=torch.int32)
    SP.frontier_step(SP.BfsState(bits, bits.clone(), torch.zeros((50, 32), dtype=torch.int32)),
                     csr, 0)
    assert called == ["hll_merge", "hll_estimate", "bfs_step"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError):  # 48 registers: not a power of two
        kernels.hll_estimate(torch.zeros((4, 48), dtype=torch.uint8), 0.7, torch.zeros(4))
    bits, flag = torch.zeros((4, 2), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="32 W"):  # 40 distance columns: not 32 x 2
        kernels.bfs_step(bits, bits.clone(), torch.zeros((4, 40), dtype=torch.int32), *csr, 64,
                         0, bits.clone(), flag)
    with pytest.raises(ValueError, match="another tensor"):  # next written over the frontier
        kernels.bfs_step(bits, bits.clone(), torch.zeros((4, 64), dtype=torch.int32), *csr, 64,
                         0, bits, flag)


class _GraphLib:
    """A stand-in for csrc/graph.cu's library: stract_hll_merge and
    stract_hll_ring_step record their name and arguments and return
    success."""

    def __init__(self, called):
        self.called = called

    def stract_hll_merge(self, *args):
        self.called.append(("merge", args))
        return 0

    def stract_hll_ring_step(self, *args):
        self.called.append(("ring", args))
        return 0


def test_hll_kernels_reach_their_c_entry_points(monkeypatch):
    """K6a and K8 on CUDA tensors (stand-ins) call their C entry points once
    a call, the change bytes' pointers in their places (null where none are
    given: the full merge, a step that writes none), and count one launch
    each; change bytes written over those read, registers that do not start
    on a whole piece or that K6a would write over, change bytes of another
    shape or type, and change bytes written at a step that is not the
    round's last raise before any launch."""
    from stract_tpu_torch.ops import hll_ops

    n, m = 50, 64
    regs = torch.from_numpy(hll_ops.init_registers(n, 6))
    src, dst = _graph(n, 100)
    csr = in_csr(n, src, dst, "cpu")
    assert csr.long_rows.numel() > 0
    flags, flags_out = torch.ones(n, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    alpha = hll_ops.hll_alpha(m)
    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _GraphLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    kernels.reset_launches()
    out, sizes, changed = hll_ops.merge_csr(regs, csr, flags=flags, flags_out=flags_out)
    hll_ops.merge_csr(regs, csr, sizes=False)
    (name, a), (_, b) = called
    assert name == "merge" and kernels.LAUNCHES["hll_merge"] == 2
    assert a[:2] == (regs.data_ptr(), flags.data_ptr())
    assert a[2:5] == tuple(t.data_ptr() for t in csr)
    assert a[5:10] == (csr.long_rows.numel(), n, m, LONG_ROW, alpha)
    assert a[10:14] == (out.data_ptr(), flags_out.data_ptr(), sizes.data_ptr(),
                        changed.data_ptr())
    assert b[1] is None and b[11] is None and b[12] is None and a[14] == b[14] == 0
    called.clear()
    run = out.clone()
    hll_ops.ring_step(run, regs, csr, flags=flags)
    last, last_sizes = hll_ops.ring_step(run, regs, csr, start=out, sizes=True, flags=flags,
                                         flags_out=flags_out)
    (name, a), (_, b) = called
    assert name == "ring" and kernels.LAUNCHES["hll_ring_step"] == 2
    assert a[:3] == (run.data_ptr(), regs.data_ptr(), flags.data_ptr())
    assert a[6:11] == (csr.long_rows.numel(), n, m, LONG_ROW, alpha)
    assert a[11:15] == (None, None, None, None)
    assert b[11:15] == (out.data_ptr(), flags_out.data_ptr(), last_sizes.data_ptr(),
                        last.data_ptr())
    called.clear()
    shifted = torch.zeros(n * m + 16, dtype=torch.uint8)[1:1 + n * m].view(n, m)
    for call in (lambda: hll_ops.merge_csr(regs, csr, flags=flags, flags_out=flags),
                 lambda: hll_ops.merge_csr(regs, csr, out=regs),
                 lambda: hll_ops.merge_csr(shifted, csr),
                 lambda: hll_ops.merge_csr(regs, csr, flags=flags.int()),
                 lambda: hll_ops.merge_csr(regs, csr, flags_out=flags[1:].clone()),
                 lambda: hll_ops.ring_step(run, regs, csr, flags_out=flags_out),
                 lambda: kernels.hll_ring_step(run, regs, *csr, LONG_ROW, alpha,
                                               flags_out=flags_out),
                 lambda: hll_ops.ring_step(run, shifted, csr)):
        with pytest.raises(ValueError):
            call()
    assert not called


def test_hll_rows_refuse_only_what_no_kernel_takes():
    """The graph kernels take every power of two from 1 to 65,536 registers
    a row (m = 2: half a 32-bit word); `_hll_rows` refuses a width that is
    not a power of two, one past 65,536, and registers that do not start on
    a whole piece (min(m, 16) bytes), and says which."""
    for m in (1, 2, 4, 1024, 2048, 65536):
        kernels._hll_rows(m, torch.zeros((3, m), dtype=torch.uint8))
    with pytest.raises(ValueError, match="not a power of two"):
        kernels._hll_rows(48)
    with pytest.raises(ValueError, match="past the kernels' 65,536"):
        kernels._hll_rows(131072)
    wide = torch.zeros(4 * 2048 + 16, dtype=torch.uint8)[8:8 + 4 * 2048].view(4, 2048)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernels._hll_rows(2048, wide)
    half = torch.zeros(9, dtype=torch.uint8)[1:].view(4, 2)
    with pytest.raises(ValueError, match="2-byte boundary"):
        kernels._hll_rows(2, half)


def _word_sum_model(w: np.ndarray) -> tuple:
    """csrc/graph.cu word_sum over u32 words: the 2^-r bits of the four bytes
    by the fast path (127 - r of all four bytes in one subtraction, each
    shifted to the exponent field) and by the byte path, where the fast test
    lets a word through, and the zero-byte count."""
    w = w.astype(np.uint32)
    fast = (((w + np.uint32(0x02020202)) | w) & np.uint32(0x80808080)) == 0
    d, e = np.uint32(0x7F7F7F7F) - w, np.uint32(0x3F800000)
    fast_bits = np.stack([(d << np.uint32(s)) & e for s in (23, 15, 7)] + [(d >> np.uint32(1)) & e],
                         axis=-1)
    r = np.stack([(w >> np.uint32(8 * b)) & np.uint32(0xFF) for b in range(4)], axis=-1)
    byte_bits = np.where(r < 126, (np.uint32(127) - r) << np.uint32(23), 0).astype(np.uint32)
    t = ~(((w & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | w) & np.uint32(0x80808080)
    zeros = np.array([bin(int(x)).count("1") for x in t])
    return fast, fast_bits, byte_bits, r, zeros


def test_hll_powers_of_two_are_built_from_the_exponent_bits():
    """(127 - r) << 23 is the f32 bits of 2^-r for r = 0 ... 126. K6b's two
    paths (numpy model of word_sum) give the same bits wherever the fast
    test lets a word through, the test lets none through that holds a byte
    >= 126, every word of bytes < 126 with no byte >= 254 goes through, the
    zero-byte count is exact, and the plain version's 2^-r (hll_ops.exp2_neg)
    equals the byte path: 0 from r = 126 on."""
    from stract_tpu_torch.ops import hll_ops

    r = np.arange(127, dtype=np.uint32)
    np.testing.assert_array_equal(((np.uint32(127) - r) << np.uint32(23)).view(np.float32),
                                  (2.0 ** -r.astype(np.float64)).astype(np.float32))
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 63, 64, 124, 125, 126, 127, 128, 149, 150, 253, 254, 255], np.uint32)
    b = np.concatenate([rng.integers(0, 256, (50_000, 4)), rng.integers(0, 126, (50_000, 4)),
                        np.stack(np.meshgrid(*[edge] * 4), -1).reshape(-1, 4)]).astype(np.uint32)
    w = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
    fast, fast_bits, byte_bits, bytes_, zeros = _word_sum_model(w)
    assert fast.sum() > 50_000
    np.testing.assert_array_equal(fast_bits[fast], byte_bits[fast])
    assert not (bytes_[fast] >= 126).any()
    assert fast[(bytes_ < 126).all(axis=1)].all()
    np.testing.assert_array_equal(zeros, (bytes_ == 0).sum(axis=1))
    got = hll_ops.exp2_neg(torch.from_numpy(bytes_.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), byte_bits)


def _warp_sort32(x: np.ndarray) -> np.ndarray:
    """csrc/scoring.cu warp_sort32 over a warp's 32 words (lane i at x[i])."""
    lane = np.arange(32)
    k = 2
    while k <= 32:
        j = k >> 1
        while j:
            o = x[lane ^ j]
            larger = ((lane & j) == 0) == ((lane & k) == 0)
            x = np.where(larger, np.maximum(x, o), np.minimum(x, o))
            j >>= 1
        k <<= 1
    return x


def _warp_merge32(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """csrc/scoring.cu warp_merge32: the 32 largest of two descending lists."""
    lane = np.arange(32)
    x = np.maximum(a, c[31 - lane])
    j = 16
    while j:
        o = x[lane ^ j]
        x = np.where((lane & j) == 0, np.maximum(x, o), np.minimum(x, o))
        j >>= 1
    return x


@pytest.mark.parametrize("n", [1, 21, 32, 1000, 1024, 5000])
def test_rerank_warp_list_select_model(n):
    """A numpy model of K10's select for k <= 32 (csrc/scoring.cu
    block_top32: 16 warps, each keeping the 32 largest (key, ~index) words
    of its stride of keys, 32 at a time sorted by the bitonic network and
    merged in; the lists merged pairwise in 4 rounds): the block's list is
    the 32 largest words, descending, ties to the lower index, zero keys
    (none) last, on keys with many ties."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 40, n).astype(np.uint64)
    words = np.where(keys != 0, keys << np.uint64(32) | (~np.arange(n, dtype=np.uint64)
                                                       & np.uint64(0xFFFFFFFF)), 0)
    words = words.astype(np.uint64)
    lists = []
    for w in range(16):
        lst = np.zeros(32, np.uint64)
        for i0 in range(32 * w, n, 512):  # the kernel's loop takes these two at a time
            i = i0 + np.arange(32)
            lst = _warp_merge32(lst, _warp_sort32(np.where(i < n, words[np.minimum(i, n - 1)], 0)
                                                  .astype(np.uint64)))
        lists.append(lst)
    step = 1
    while step < 16:
        lists = [_warp_merge32(lists[w], lists[w + step]) if w % (2 * step) == 0 else lists[w]
                 for w in range(16 - step)] + lists[16 - step:]
        step *= 2
    want = np.concatenate([np.sort(words)[::-1], np.zeros(32, np.uint64)])[:32]
    np.testing.assert_array_equal(lists[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hub_in,precision", [(100_003, 100_000, 6), (5_001, 300, 4),
                                                (5_001, 300, 10), (5_001, 300, 1),
                                                (20_003, 20_000, 11), (5_001, 3_000, 12)])
def test_hll_kernels_match_plain(n, hub_in, precision):
    """K6a round by round in the systolic form a HyperBall runs (change
    bytes carried from round to round, every byte set before round 1):
    registers bit-equal to the plain merge and to the systolic twin, change
    bytes to the twin's, the changed flag to the plain comparison, a second
    call bit-equal to the first; K6b (in K6a's epilogue and alone) within
    rel 1e-6 of the plain estimate. From a state no run reaches (the rows
    shuffled) a call with every byte set, or with no change bytes, is the
    full merge, and a call with no byte set a copy (changed 0, every byte
    0). A hub of 100k in-edges, N not a multiple of the block, a node with
    no in-edges, 2 / 16 / 64 / 1,024 registers a row, and 2,048 and 4,096 (a
    block a row)."""
    from stract_tpu_torch.ops import hll_ops

    dev = _card()
    src, dst = _graph(n, hub_in)
    csr = in_csr(n, src, dst, dev)
    assert csr.long_rows.numel() > 0
    ef, et = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    regs = torch.from_numpy(hll_ops.init_registers(n, precision)).to(dev)
    torch.testing.assert_close(hll_ops.estimate_sizes(regs), hll_ops.estimate_sizes_plain(regs),
                               rtol=1e-6, atol=0)
    flags = torch.ones(n, dtype=torch.uint8, device=dev)
    for _ in range(4):
        flags_out = torch.empty_like(flags)
        new, sizes, changed = hll_ops.merge_csr(regs, csr, flags=flags, flags_out=flags_out)
        plain = hll_ops.merge_iteration_plain(regs, ef, et)
        twin, twin_flags = hll_ops.merge_systolic_plain(regs, flags, ef, et)
        assert torch.equal(new, plain) and torch.equal(twin, plain)
        assert torch.equal(flags_out, twin_flags)
        assert bool(changed.item()) == (not torch.equal(plain, regs))
        torch.testing.assert_close(sizes, hll_ops.estimate_sizes_plain(plain), rtol=1e-6, atol=0)
        again = torch.empty_like(flags)
        new2, sizes2, changed2 = hll_ops.merge_csr(regs, csr, flags=flags, flags_out=again)
        assert torch.equal(new2, new) and torch.equal(sizes2, sizes)
        assert torch.equal(again, flags_out) and torch.equal(changed2, changed)
        regs, flags = new, flags_out
    assert 0 < int(flags.sum()) < n  # the last round gathered some rows, not all
    assert torch.equal(regs[n - 1], torch.from_numpy(hll_ops.init_registers(n, precision)[n - 1])
                       .to(dev))  # no in-edges: the row never changes
    mixed = regs[torch.randperm(n, generator=torch.Generator().manual_seed(0)).to(dev)]
    want = hll_ops.merge_iteration_plain(mixed, ef, et)
    for every in (torch.ones_like(flags), None):
        got, _, changed = hll_ops.merge_csr(mixed, csr, flags=every)
        assert torch.equal(got, want)
        assert int(changed.item()) == int(not torch.equal(want, mixed))
    none_out = torch.ones_like(flags)
    copy, _, changed = hll_ops.merge_csr(mixed, csr, flags=torch.zeros_like(flags),
                                         flags_out=none_out)
    assert torch.equal(copy, mixed) and int(changed.item()) == 0 and not none_out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", range(17))
def test_hll_estimate_kernel_matches_plain_at_every_width(precision):
    """K6b at m = 2^precision registers a row, 1 ... 65,536 (a byte, half a
    word, a warp's lanes, past 1,024 a block a row), on seeded registers
    (zero-free rows of geometric ranks, which take the estimate, and rows
    with zeros, which take linear counting), a row all 0, a row of the bytes
    125, 126, 127, 149, 150, 255 and a row all 126 (inf): within rel 1e-6 of
    the plain version, two calls bit-equal, a row count that is not a
    multiple of a block's."""
    from stract_tpu_torch.ops import hll_ops

    dev = _card()
    m = 1 << precision
    n = min(20_003, (1 << 24) // m + 3)
    rng = np.random.default_rng(precision)
    regs = np.minimum(rng.geometric(0.5, (n, m)), 65 - precision)
    regs[::2] -= 1
    regs = regs.astype(np.uint8)
    regs[0] = 0
    regs[1] = np.resize(np.array([125, 126, 127, 149, 150, 255], np.uint8), m)
    regs[2] = 126
    t = torch.from_numpy(regs).to(dev)
    got = hll_ops.estimate_sizes(t)
    want = hll_ops.estimate_sizes_plain(torch.from_numpy(regs))
    assert torch.isinf(want[2]) and bool(torch.isfinite(want[3:]).all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    assert torch.equal(hll_ops.estimate_sizes(t), got)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [1, 4, 6, 10, 11, 12, 16])
def test_hll_merge_sizes_bit_equal_to_the_estimate(precision):
    """K6a's epilogue (two rounds) and K8's last ring step estimate the rows
    they write bit-equal to K6b alone on the same rows, at 2 ... 65,536
    registers a row: one routine, one order."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import centrality as PC

    dev = _card()
    m = 1 << precision
    n = min(5_001, (1 << 24) // m + 1)
    src, dst = _graph(n, min(300, n - 2))
    csr = in_csr(n, src, dst, dev)
    regs = torch.from_numpy(hll_ops.init_registers(n, precision)).to(dev)
    for _ in range(2):
        new, sizes, _ = hll_ops.merge_csr(regs, csr)
        assert torch.equal(sizes, hll_ops.estimate_sizes(new))
        regs = new
    bucket = PC.ring_buckets(n, src, dst, [torch.device(dev)])[0][0]
    out = regs.clone()
    _, sizes = hll_ops.ring_step(out, regs, bucket, start=regs, sizes=True)
    assert torch.equal(sizes, hll_ops.estimate_sizes(out))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 32, 40, 256, 300, 1100])
def test_bfs_kernel_matches_plain(S):
    """K7's frontier step bit-equal to the reference's relaxation round by
    round (distances, UNREACHABLE included, and the changed flag) and its
    whole state to the plain twin's, from 1, 32, 40 (a word of padding bits),
    256, 300 (W = 10: 16 lanes a row) and 1,100 sources (W = 35: 32 lanes in
    two chunks of words) over a hub of 100k in-edges (a long row); rows whose
    seen bits are all set at a round's start in a chunk of 32 words (their
    edges skipped for that chunk) are among them; a second call on the same
    input bit-equal to the first; the whole BFS equal to the CPU's."""
    from stract_tpu_torch.webgraph import shortest_path as SP

    dev = _card()
    n = 100_003
    src, dst = _graph(n, 100_000, seed=1)
    csr = in_csr(n, src, dst, dev)
    assert csr.long_rows.numel() > 0
    ef, et = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    sources = np.random.default_rng(2).choice(n, size=S, replace=False)
    state = SP.bfs_start(n, sources, dev)
    dist = state.dist[:, :S].t().contiguous()  # the reference's [S, N]
    skipped = 0
    for level in range(12):
        twin, twin_changed = SP.frontier_step_plain(state, ef, et, level)
        ref = SP.relax_plain(dist, ef, et)
        seen0, dist0 = state.seen.clone(), state.dist.clone()
        skipped += sum(int((seen0[:, c:c + 32] == -1).all(dim=1).sum())
                       for c in range(0, seen0.shape[1], 32))
        new, changed = SP.frontier_step(state, csr, level)
        assert torch.equal(new.dist[:, :S].t(), ref)
        assert all(torch.equal(a, b) for a, b in zip(new, twin))
        assert int(changed.item()) == int(twin_changed.item()) == int(not torch.equal(ref, dist))
        again, again_changed = SP.frontier_step(SP.BfsState(seen0, state.frontier, dist0), csr,
                                                level)
        assert all(torch.equal(a, b) for a, b in zip(again, new))
        assert torch.equal(again_changed, changed)
        state, dist = new, ref
    assert skipped > 0
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
    ("entrypoint.search_server", "run"),
    ("entrypoint.api", "run"),
    ("entrypoint.api", "build_coordinator"),
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


# ---- the mesh's kernels: K9 (the global top-k of the shards), K8 (the ring step) --------
def _gathered(B: int, n: int, K: int, seed: int = 0):
    """Seeded per-shard top-K lists gathered shard-major → (scores f32[B, n, K],
    docs i32[B, n, K]): scores on a coarse grid, so many tie across and
    within shards, each shard's list descending with a -inf tail (a shard
    with fewer matches than K), one shard all -inf, and a -0 beside +0."""
    rng = np.random.default_rng(seed)
    scores = np.sort(rng.integers(0, 40, (B, n, K)).astype(np.float32) / 4, axis=2)[..., ::-1]
    scores = np.ascontiguousarray(scores)
    for b in range(B):
        for d in range(n):
            scores[b, d, rng.integers(K // 2, K + 1):] = -np.inf
    scores[:, -1, :] = -np.inf
    scores[0, 0, :2] = [0.0, -0.0]
    docs = rng.integers(0, 1_000_000, (B, n, K)).astype(np.int32)
    return torch.from_numpy(scores), torch.from_numpy(docs)


def test_mesh_wrappers_dispatch_and_check(monkeypatch):
    """The mesh merge and the ring step take their plain twins on CPU
    tensors; a CUDA tensor calls the kernel (stand-ins here); arguments the
    kernels do not take raise before any build or launch."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.ops import scoring as O

    scores, docs = _gathered(2, 4, 64)
    got = O.mesh_topk(scores, docs, 32)
    want = O.mesh_topk_plain(scores, docs, 32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    regs = torch.from_numpy(hll_ops.init_registers(50, 4))
    src, dst = _graph(50, 10)
    csr = in_csr(50, src % 50, dst, "cpu")
    out = regs.clone()
    changed, sizes = hll_ops.ring_step(out, regs.flip(0).contiguous(), csr, start=regs,
                                       sizes=True)
    assert bool(changed.item()) and sizes.shape == (50,)
    with pytest.raises(ValueError):  # the ring buffer is the tensor it updates
        hll_ops.ring_step(out, out, csr)
    called = []
    monkeypatch.setattr(O, "mesh_topk_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(hll_ops, "ring_step_plain", lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "mesh_topk", lambda *a, **k: called.append("mesh_topk"))
    monkeypatch.setattr(kernels, "hll_ring_step", lambda *a, **k: called.append("ring"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    O.mesh_topk(scores, docs, 32)
    hll_ops.ring_step(out, regs, csr, start=regs, sizes=True)
    assert called == ["mesh_topk", "ring"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    big_s, big_d = _gathered(1, 9, 1024)
    with pytest.raises(ValueError):  # 9 x 1024 entries: more than one block holds
        kernels.mesh_topk(big_s, big_d, 1024, *(torch.zeros((1, 1024), dtype=t)
                                                for t in (torch.int32, torch.int32,
                                                          torch.float32)))
    with pytest.raises(ValueError):  # keeps more than each shard gave
        kernels.mesh_topk(scores, docs, 65, *(torch.zeros((2, 65), dtype=t)
                                              for t in (torch.int32, torch.int32,
                                                        torch.float32)))
    with pytest.raises(ValueError):  # the ring buffer aliases the rows it updates
        kernels.hll_ring_step(out, out, *csr, 64, 0.7)
    with pytest.raises(ValueError):  # a change flag without the round-start shard
        kernels.hll_ring_step(out, regs, *csr, 64, 0.7, changed=torch.zeros(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,K", [(1, 512), (4, 1024), (8, 1024), (8, 512)])
def test_mesh_topk_kernel_matches_plain(n, K):
    """K9 against its plain twin (a stable sort, lax.top_k's order): docs,
    shards and scores equal, ties (planted across and within shards, -inf
    tails, a -0 beside +0) in flat-index order; k = K and k = 10."""
    from stract_tpu_torch.ops import scoring as O

    dev = _card()
    scores, docs = _gathered(5, n, K, seed=n)
    scores, docs = scores.to(dev), docs.to(dev)
    for k in (K, 10):
        c = kernels.LAUNCHES["mesh_topk"]
        got = O.mesh_topk(scores, docs, k)
        assert kernels.LAUNCHES["mesh_topk"] == c + 1
        for a, b in zip(got, O.mesh_topk_plain(scores, docs, k)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("out_of_order", [False, True])
@pytest.mark.parametrize("n,K", [(1, 512), (4, 512), (4, 1024), (8, 1024), (16, 512)])
def test_mesh_topk_merge_and_select_forms_match_plain(n, K, out_of_order):
    """K9 over the shards' lists where they lie (mesh_topk_lists, as the
    mesh's merge calls it) and over the stacked tensor, at k = K and k = 10:
    docs, shards and scores bit-equal to the plain twin. Every list
    descending (each list's head made descending, -0 after +0 in a run)
    takes the merge form for every query; with one list of query 2 out of
    order, that query takes the select form and the others the merge."""
    from stract_tpu_torch.ops import scoring as O

    dev = _card()
    B = 5
    scores, docs = _gathered(B, n, K, seed=n + K)
    scores[0, 0, :2] = scores[0, 0, 2]  # _gathered's +0, -0 head: a tie, in order
    scores[1, 0, 2:6] = torch.tensor([0.0, 0.0, -0.0, -0.0])
    scores[1, 0, :2] = 1.0
    scores[1, 0, 6:] = scores[1, 0, 6:].clamp(max=-0.25)
    if out_of_order:
        scores[2, 0, K - 1] = 100.0
    scores, docs = scores.to(dev), docs.to(dev)
    s_l = [scores[:, i].contiguous() for i in range(n)]
    d_l = [docs[:, i].contiguous() for i in range(n)]
    want_forms = [0, 0, int(out_of_order), 0, 0]
    for k in (K, 10):
        plain = O.mesh_topk_plain(scores, docs, k)
        for call in ("lists", "stacked"):
            forms = torch.full((B,), -1, dtype=torch.int32, device=dev)
            kernels.reset_launches()
            got = (O.mesh_topk_lists(s_l, d_l, k, forms) if call == "lists"
                   else O.mesh_topk(scores, docs, k, forms))
            assert kernels.LAUNCHES["mesh_topk"] == 1 and kernels.MESH_TOPK_CALLS[call] == 1
            for a, b in zip(got, plain):
                assert torch.equal(a, b), (call, k)
            assert forms.tolist() == want_forms


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_ring_step_kernel_matches_plain(n_shards):
    """K8 round by round over the ring buckets of a Pareto graph with a hub
    of 50k in-edges (long rows) and uneven shards, in the systolic form (each
    shard's change bytes travel with it, every byte set before round 1):
    every shard's registers bit-equal to the plain ring steps' with the same
    bytes and to the full plain ring's, its change bytes and change flag to
    the plain comparison, the sizes of the last step within rel 1e-6 of the
    plain estimate; then one step with every byte set (given, and not
    given) bit-equal to the plain step."""
    _ring_rounds_match_plain(n_shards, 50_003, 50_000, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards,precision", [(3, 1), (3, 11), (4, 12)])
def test_ring_step_kernel_matches_plain_at_other_widths(n_shards, precision):
    """test_ring_step_kernel_matches_plain at 2 registers a row (half a
    word) and at 2,048 and 4,096 (a block a row)."""
    _ring_rounds_match_plain(n_shards, 5_003, 3_000, precision)


def _ring_rounds_match_plain(n_shards: int, n: int, hub_in: int, precision: int) -> None:
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import centrality as PC

    dev = _card()
    src, dst = _graph(n, hub_in, seed=2)
    S = -(-n // n_shards)
    regs0 = np.zeros((S * n_shards, 1 << precision), np.uint8)
    regs0[:n] = hll_ops.init_registers(n, precision)
    shards = {where: [torch.from_numpy(regs0[d * S:(d + 1) * S]).to(where)
                      for d in range(n_shards)] for where in (dev, "cpu")}
    flags = {where: [torch.ones(S, dtype=torch.uint8, device=where) for _ in range(n_shards)]
             for where in (dev, "cpu")}
    buckets = {where: PC.ring_buckets(n, src, dst, [torch.device(where)] * n_shards)
               for where in (dev, "cpu")}
    assert any(b.long_rows.numel() for row in buckets[dev] for b in row)
    for _ in range(4):
        c = kernels.LAUNCHES["hll_ring_step"]
        got, got_sz, got_ch, got_fl = PC.ring_round(shards[dev], buckets[dev], flags=flags[dev])
        assert kernels.LAUNCHES["hll_ring_step"] == c + n_shards * n_shards
        want, _, want_ch, want_fl = PC.ring_round(shards["cpu"], buckets["cpu"],
                                                  flags=flags["cpu"])
        full = PC.ring_round(shards["cpu"], buckets["cpu"], sizes=False)[0]
        for g, w, f, gs, gc, wc, gf, wf in zip(got, want, full, got_sz, got_ch, want_ch, got_fl,
                                               want_fl):
            assert torch.equal(g.cpu(), w) and torch.equal(w, f)
            assert int(gc.item()) == int(wc.item()) == int(bool(wf.any()))
            assert torch.equal(gf.cpu(), wf)
            torch.testing.assert_close(gs.cpu(), hll_ops.estimate_sizes_plain(w), rtol=1e-6,
                                       atol=0)
        shards, flags = {dev: got, "cpu": want}, {dev: got_fl, "cpu": want_fl}
    k = 1 % n_shards
    want = hll_ops.ring_step_plain(shards["cpu"][0].clone(), shards["cpu"][k], buckets["cpu"][0][k])
    for every in (torch.ones(S, dtype=torch.uint8, device=dev), None):
        out = shards[dev][0].clone()
        hll_ops.ring_step(out, shards[dev][k], buckets[dev][0][k], flags=every)
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
def test_mesh_kernels_launch_on_their_tensors_card():
    """F6: K9 and K8 with their shards on cuda:1 while cuda:0 is current
    equal their plain twins, and the current card is left as it was."""
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.ops import scoring as O

    dev = _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards")
    one = torch.device(dev, 1)
    torch.cuda.set_device(0)
    scores, docs = _gathered(5, 4, 512, seed=9)
    got = O.mesh_topk(scores.to(one), docs.to(one), 10)
    for a, b in zip(got, O.mesh_topk_plain(scores, docs, 10)):
        assert a.device == one and torch.equal(a.cpu(), b)
    n = 20_000
    src, dst = _graph(n, 5_000, seed=4)
    regs = torch.from_numpy(hll_ops.init_registers(n, 6))
    csr_one, csr_cpu = in_csr(n, src, dst, one), in_csr(n, src, dst, "cpu")
    buf = regs.flip(0).contiguous()
    out_one, out_cpu = regs.to(one), regs.clone()
    ch1, sz1 = hll_ops.ring_step(out_one, buf.to(one), csr_one, start=regs.to(one), sizes=True)
    ch0, sz0 = hll_ops.ring_step(out_cpu, buf, csr_cpu, start=regs, sizes=True)
    torch.cuda.synchronize(one)
    assert torch.equal(out_one.cpu(), out_cpu) and int(ch1.item()) == int(ch0.item())
    torch.testing.assert_close(sz1.cpu(), sz0, rtol=1e-6, atol=0)
    assert torch.cuda.current_device() == 0
