"""The port's pipeline-parallel train step (stract_tpu_torch/parallel/
pipeline.py, K16) and its f32 stage ops (ops/stage.py, K16a-d) against the
JAX package's stract_tpu/parallel/pipeline.py, on the 8 CPU devices of
tests/conftest.py (the JAX side exactly as tests/test_pipeline_parallel.py
runs it) and on CPU Meshes of the port. Inputs come from numpy seeds; the
JAX package's parameters cross over through params_from_numpy.

Tolerances:
  - the stage and its gradients against jax.vjp: rtol 1e-5, atol 1e-6 x
    the largest |JAX value| of each array (f32 sums over H and T in other
    orders, tanh and exp in other implementations: each package is ~1e-7 of
    that magnitude from an f64 evaluation, and the gradients of a unit
    cotangent summed over the rows reach 30);
  - the pipelined forward: the JAX test's rtol 2e-4, atol 2e-5;
  - 30 SGD steps of the JAX test's recipe: losses within a relative 1e-5
    at every step, final parameters within 1e-6;
  - dp = 2 against dp = 1: rtol 1e-5, atol 1e-7 (the dp shards' gradients
    summed in another order);
  - on the card (`cuda`-marked; they import the port alone, so they also
    run where the JAX package's flax is absent:
    `python -m pytest tests/test_torch_pipeline.py -m cuda -q`), kernel
    against plain twin: attention forward and backward rtol 1e-5, atol
    1e-5 x max |plain| (f32 sums of up to 1,024 terms in another order),
    GELU rtol 1e-5, atol 1e-6 x max |x| (1 + tanh loses the same bits in
    both near -1), SGD bit-equal (the kernel is compiled without fused
    multiply-adds: lr * g rounds before the difference, as in the twin).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import stage as ST
from stract_tpu_torch.parallel import pipeline as TP
from stract_tpu_torch.parallel.mesh import Mesh
from test_torch_kernels import _RecordingLib

CPU = torch.device("cpu")
PIPE_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the `cuda` tests run without it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, PartitionSpec as P

    from stract_tpu.parallel import pipeline as JP

    return jax, jnp, JMesh, P, JP


def _cpu_mesh(pp: int, dp: int) -> Mesh:
    return Mesh([[CPU] * dp] * pp, axis_names=("pp", "dp"))


def _stage_np(rng, H: int, F: int) -> dict:
    """Stage weights at 1 / sqrt(fan-in), so the stage's values stay O(1)
    and its attention is far from uniform (the reference's 0.02 makes it
    nearly so at these widths)."""
    return {k: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32) for k, shape in (
        ("attn_qkv", (H, 3 * H)), ("attn_out", (H, H)), ("ffn_in", (H, F)), ("ffn_out", (F, H)))}


# ---- the stage and its gradients ---------------------------------------------------------
@pytest.mark.parametrize("H,T", [(16, 4), (16, 16), (32, 4), (32, 16), (16, 600), (1040, 8)])
def test_apply_stage_and_its_gradients_match_jax(jx, H, T):
    jax, jnp, _, _, JP = jx
    rng = np.random.default_rng(H * 100 + T)
    p = _stage_np(rng, H, 2 * H)
    x = rng.normal(size=(3, T, H)).astype(np.float32)
    ct = rng.normal(size=(3, T, H)).astype(np.float32)
    out_j, vjp = jax.vjp(JP._apply_stage, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    dp_j, dx_j = vjp(jnp.asarray(ct))
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = TP._apply_stage(pt, xt)
    grads = torch.autograd.grad(out_t, [xt, *pt.values()], torch.from_numpy(ct))
    for name, got, want in (("out", out_t.detach(), out_j), ("x", grads[0], dx_j),
                            *((k, g, dp_j[k]) for k, g in zip(pt, grads[1:]))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)


# ---- the pipelined forward -----------------------------------------------------------------
@pytest.mark.parametrize("pp,dp", [(4, 2), (2, 1), (4, 1)])
def test_pipeline_apply_matches_jax_and_the_sequential_twin(jx, pp, dp):
    jax, jnp, JMesh, P, JP = jx
    H, F, M, MB, T = 16, 32, 6, 4, 4
    params = JP.init_stage_params(jax.random.PRNGKey(0), H, F, pp)
    mbs = np.random.default_rng(pp * 10 + dp).normal(size=(M, MB, T, H)).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:pp * dp]).reshape(pp, dp), axis_names=("pp", "dp"))
    spec = {k: P("pp", None, None) for k in params}
    piped_j = jax.jit(jax.shard_map(
        JP.pipeline_apply, mesh=jmesh, in_specs=(spec, P(None, "dp", None, None)),
        out_specs=P(None, "dp", None, None)))(params, jnp.asarray(mbs))
    mesh = _cpu_mesh(pp, dp)
    pt = TP.params_from_numpy({k: np.asarray(v) for k, v in params.items()}, mesh)
    with torch.no_grad():
        piped = TP.pipeline_apply(mesh, pt, torch.from_numpy(mbs))
        seq = TP.reference_forward(pt, torch.from_numpy(mbs))
    assert piped.shape == (M, MB, T, H)
    np.testing.assert_allclose(piped.numpy(), np.asarray(piped_j), **PIPE_TOL)
    np.testing.assert_allclose(piped.numpy(), seq.numpy(), **PIPE_TOL)
    np.testing.assert_allclose(seq.numpy(), np.asarray(JP.reference_forward(params, mbs)),
                               **PIPE_TOL)


# ---- the train step ------------------------------------------------------------------------
def _recipe(seed: int = 0):
    rng = np.random.default_rng(seed)
    M, MB, T, H = 4, 4, 4, 16
    return (rng.normal(size=(M, MB, T, H)).astype(np.float32),
            rng.normal(size=(M, MB)).astype(np.float32))


def test_train_step_follows_jax_for_30_steps(jx):
    """The JAX test's recipe on (pp=4, dp=2): H=16, FFN=32, M=4, mb=4, T=4,
    lr 5e-2, 30 steps from the same parameters."""
    jax, jnp, JMesh, _, JP = jx
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(4, 2), axis_names=("pp", "dp"))
    init_j, step_j = JP.make_pipeline_train_step(jmesh, hidden=16, ffn=32, learning_rate=5e-2)
    mesh = _cpu_mesh(4, 2)
    _, step_t = TP.make_pipeline_train_step(mesh, hidden=16, ffn=32, learning_rate=5e-2)
    pj = init_j(jax.random.PRNGKey(1))
    pt = TP.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, mesh)
    mbs, targets = _recipe()
    lj, lt = [], []
    with jmesh:
        for _ in range(30):
            pj, loss = step_j(pj, jnp.asarray(mbs), jnp.asarray(targets))
            lj.append(float(loss))
    for _ in range(30):
        pt, loss = step_t(pt, torch.from_numpy(mbs), torch.from_numpy(targets))
        lt.append(float(loss))
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=0)
    assert lt[-1] < lt[0] * 0.5, lt[:3] + lt[-3:]
    final = TP.params_to_numpy(pt)
    assert set(final) == set(pj)
    for k, v in final.items():
        np.testing.assert_allclose(v, np.asarray(pj[k]), rtol=0, atol=1e-6, err_msg=k)


def test_dp_shards_sum_their_gradients():
    """A step on (pp=4, dp=2) equals the step on (pp=4, dp=1): autograd's sum
    over the dp shards' reads of each stage is the all-reduce."""
    mbs, targets = _recipe(3)
    runs = []
    for dp in (2, 1):
        mesh = _cpu_mesh(4, dp)
        init_fn, step_fn = TP.make_pipeline_train_step(mesh, hidden=16, ffn=32, learning_rate=5e-2)
        params = init_fn(5)
        losses = [float(step_fn(params, torch.from_numpy(mbs), torch.from_numpy(targets))[1])
                  for _ in range(3)]
        runs.append((losses, TP.params_to_numpy(params)))
    (l2, p2), (l1, p1) = runs
    np.testing.assert_allclose(l2, l1, rtol=1e-5, atol=0)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_init_and_parameter_transfer():
    """init_stage_params puts each stage on its device with N(0, 0.02)
    entries from the seed; params_to_numpy / params_from_numpy round-trip
    the JAX package's stacked layout."""
    p = TP.init_stage_params(0, 32, 64, 3, devices=[CPU] * 3)
    assert [t.shape for t in p["attn_qkv"]] == [(32, 96)] * 3
    again = TP.init_stage_params(0, 32, 64, 3, devices="cpu")
    assert all(torch.equal(a, b) for k in p for a, b in zip(p[k], again[k]))
    std = float(torch.cat([t.reshape(-1) for k in p for t in p[k]]).std())
    assert 0.019 < std < 0.021
    mesh = _cpu_mesh(3, 2)
    init_fn, _ = TP.make_pipeline_train_step(mesh, hidden=32, ffn=64)
    full = init_fn(0)
    assert all(t.requires_grad for k in TP.STAGE_KEYS for t in full[k])
    assert full["head"].shape == (32,) and full["head"].requires_grad
    arrays = TP.params_to_numpy(full)
    assert arrays["ffn_in"].shape == (3, 32, 64) and arrays["head"].shape == (32,)
    back = TP.params_to_numpy(TP.params_from_numpy(arrays, mesh))
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)


# ---- the twins ------------------------------------------------------------------------------
def test_autograd_functions_pass_gradcheck_in_f64():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 5, 12), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ST.stage_attention, (qkv,))
    x = (3 * torch.randn((3, 7), generator=g, dtype=torch.float64)).requires_grad_(True)
    assert torch.autograd.gradcheck(ST.gelu_tanh, (x,))


def test_twins_follow_the_reference_formulas_on_edge_values(jx):
    """gelu_tanh_plain against jax.nn.gelu(approximate=True) at large |x|
    and around 0, with its gradient; the attention twin against
    jax.nn.softmax on a row of equal scores (uniform weights: the mean of v)
    and on large scores."""
    jax, jnp, _, _, _ = jx
    x = np.array([-1e4, -60.0, -12.0, -3.0, -1e-3, 0.0, 1e-6, 0.5, 3.0, 12.0, 60.0, 1e4],
                 dtype=np.float32)
    got = ST.gelu_tanh_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
                               rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()
    ct = np.ones_like(x)
    _, vjp = jax.vjp(lambda a: jax.nn.gelu(a, approximate=True), jnp.asarray(x))
    np.testing.assert_allclose(
        ST.gelu_tanh_backward_plain(torch.from_numpy(x), torch.from_numpy(ct)).numpy(),
        np.asarray(vjp(jnp.asarray(ct))[0]), rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(1)
    H, T = 8, 6
    qkv = rng.normal(size=(2, T, 3 * H)).astype(np.float32)
    qkv[0, :, H:2 * H] = qkv[0, 0, H:2 * H]  # every key equal: one score a row
    qkv[1, :, :H] *= 300.0  # scores in the thousands
    out = ST.stage_attention_plain(torch.from_numpy(qkv)).numpy()
    np.testing.assert_allclose(out[0], np.broadcast_to(qkv[0, :, 2 * H:].mean(0), (T, H)),
                               rtol=1e-5, atol=1e-6)
    q, k, v = (jnp.asarray(qkv[..., i * H:(i + 1) * H]) for i in range(3))
    att = jax.nn.softmax(jnp.einsum("bth,bsh->bts", q, k) / np.sqrt(H), axis=-1)
    np.testing.assert_allclose(out, np.asarray(jnp.einsum("bts,bsh->bth", att, v)),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(out).all()


def _tf32(x):
    """f32 → the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32):
    the low 13 bits of the pattern rounded off."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tensor_core_product(eq: str, a, b, split: bool):
    """einsum eq of f32 a and b as K16a's mma.sync takes them: TF32 inputs
    (exact products, f32 sums); split: 3xTF32, a = hi + lo with hi = tf32(a),
    lo = tf32(a - hi), and a.b as lo.hi + hi.lo + hi.hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


@pytest.mark.parametrize("mb,T,H", [(8, 128, 384), (1, 512, 1024), (1, 2048, 384),
                                    (1, 128, 2048)])
def test_3xtf32_products_keep_the_f32_tolerance(mb, T, H):
    """K16a's arithmetic emulated on the CPU at the smoke's shape, at the
    largest its one-tile form once took, past 1,024 keys (its chunked form)
    and past H = 1,024: both products in 3xTF32, the softmax in f32 as the
    twin computes it. Against the attention in f64 of the same f32 inputs
    it stays within the card test's rtol 1e-5, atol 1e-5 x max |out|, as the
    f32 twin does; with plain TF32 products (10-bit mantissas) it does not."""
    g = torch.Generator().manual_seed(T + H)
    qkv = torch.randn((mb, T, 3 * H), generator=g)
    want = ST.stage_attention_plain(qkv.double())
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))

    def emulated(split: bool):
        q, k, v = (qkv[..., i * H:(i + 1) * H] for i in range(3))
        scores = _tensor_core_product("bth,bsh->bts", q, k, split) / ST._scale(H, torch.float32)
        return _tensor_core_product("bts,bsh->bth", torch.softmax(scores, dim=-1), v, split)
    torch.testing.assert_close(emulated(True).double(), want, **tol)
    torch.testing.assert_close(ST.stage_attention_plain(qkv).double(), want, **tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(emulated(False).double(), want, **tol)


def _grouped_product(eq: str, a, b, axis_a: int, axis_b: int, split: bool):
    """_tensor_core_product with the kernels' chain grouping: the
    contracted axis (axis_a of a, axis_b of b) cut into chains of kTcGroup
    = 4 k-steps (32 entries), each chain's product a part in f32, the parts
    added to the running sum in f32 in order."""
    n, out = a.shape[axis_a], None
    for c in range(0, n, 32):
        part = _tensor_core_product(eq, a.narrow(axis_a, c, min(32, n - c)),
                                    b.narrow(axis_b, c, min(32, n - c)), split)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("mb,T,H", [(8, 128, 384), (1, 512, 1024), (1, 2048, 384),
                                    (1, 128, 2048)])
def test_3xtf32_backward_products_keep_the_f32_tolerance(mb, T, H):
    """K16b's arithmetic emulated on the CPU at the smoke's shape, at the
    largest its one-tile form once took, past 1,024 keys and past H =
    1,024 (64 chains of 4 k-steps added in f32 for each product over H):
    its five products (S = Q.K^T, dP = dO.V^T, dQ = dS.K,
    dV = P^T.dO, dK = dS^T.Q) in 3xTF32 with the kernels' chain grouping, the
    softmax, D and dS in f32 as the twin computes them. Against autograd in
    f64 of the same f32 inputs it stays within the card test's rtol 1e-5,
    atol 1e-5 x max |dqkv|; with plain TF32 products it does not."""
    g = torch.Generator().manual_seed(T + H + 1)
    qkv = torch.randn((mb, T, 3 * H), generator=g)
    dout = torch.randn((mb, T, H), generator=g)
    leaf = qkv.double().requires_grad_(True)
    (want,) = torch.autograd.grad(ST.stage_attention_plain(leaf), leaf, dout.double())
    tol = dict(rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    scale = ST._scale(H, torch.float32)

    def emulated(split: bool):
        q, k, v = (qkv[..., i * H:(i + 1) * H] for i in range(3))
        prod = lambda eq, a, b, ia, ib: _grouped_product(eq, a, b, ia, ib, split)  # noqa: E731
        p = torch.softmax(prod("bth,bsh->bts", q, k, 2, 2) / scale, dim=-1)
        dp = prod("bth,bsh->bts", dout, v, 2, 2)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) / scale
        dq = prod("bts,bsh->bth", ds, k, 2, 1)
        dk = prod("bts,bth->bsh", ds, q, 1, 1)
        dv = prod("bts,bth->bsh", p, dout, 1, 1)
        return torch.cat([dq, dk, dv], dim=-1)
    torch.testing.assert_close(emulated(True).double(), want, **tol)
    torch.testing.assert_close(ST.stage_attention_backward_plain(qkv, dout).double(), want, **tol)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(emulated(False).double(), want, **tol)


def _sgd_pairs(sizes, offsets, seed):
    """f32 parameters of the given sizes (those at `offsets` views one
    element into a larger buffer, so not 16-byte aligned) and gradients."""
    g = torch.Generator().manual_seed(seed)
    base = [torch.randn(n + 3, generator=g) for n in sizes]
    ps = [b[1:1 + n] if i in offsets else b[:n] for i, (b, n) in enumerate(zip(base, sizes))]
    gs = [torch.randn(n, generator=g) for n in sizes]
    return ps, gs


SGD_SIZES = [1, 3, 5, 4096, 4097, 442368, 1000, 384] * 3 + [7]  # 25 tensors


def test_sgd_update_many_plain_is_per_tensor_sgd():
    """The many-tensor twin equals sgd_update_plain tensor by tensor, bit
    for bit, on 25 tensors of mixed sizes (1 and 3 among them) and views at
    an element offset; sgd_update_many on CPU tensors takes it."""
    ps, gs = _sgd_pairs(SGD_SIZES, (1, 9, 17), 0)
    one, many, twin = ([p.clone() for p in ps] for _ in range(3))
    for p, g in zip(one, gs):
        ST.sgd_update_plain(p, g, 5e-2)
    ST.sgd_update_many_plain(many, gs, 5e-2)
    ST.sgd_update_many(twin, gs, 5e-2)
    assert all(torch.equal(a, b) for a, b in zip(many, one))
    assert all(torch.equal(a, b) for a, b in zip(twin, one))
    assert not torch.equal(one[5], ps[5])


def test_train_step_updates_all_leaves_in_one_call(monkeypatch):
    """The step hands every leaf (4 keys x S stages + the head) with its
    gradient to sgd_update_many once: one K16d launch per card a step."""
    calls = []
    real = ST.sgd_update_many
    monkeypatch.setattr(ST, "sgd_update_many",
                        lambda ps, gs, lr: (calls.append((len(ps), len(gs), lr)), real(ps, gs, lr)))
    init_fn, step_fn = TP.make_pipeline_train_step(_cpu_mesh(3, 2), hidden=16, ffn=32,
                                                   learning_rate=5e-2)
    params = init_fn(0)
    mbs, targets = _recipe(1)
    for _ in range(2):
        step_fn(params, torch.from_numpy(mbs), torch.from_numpy(targets))
    assert calls == [(4 * 3 + 1, 4 * 3 + 1, 5e-2)] * 2


# ---- the entry points and the dispatch -------------------------------------------------------
def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cuda = Mesh([[torch.device("cuda", 0)] * 2] * 2, axis_names=("pp", "dp"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.make_pipeline_train_step(cuda)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TP.init_stage_params(0, 16, 32, 2)
    with pytest.raises(ValueError, match="axes"):
        TP.make_pipeline_train_step(Mesh([CPU] * 2, axis_names=("dp",)))


def test_dispatchers_send_cpu_tensors_to_the_twins(monkeypatch):
    called = []
    for name in ("stage_attention_plain", "stage_attention_backward_plain", "gelu_tanh_plain",
                 "gelu_tanh_backward_plain", "sgd_update_plain"):
        monkeypatch.setattr(ST, name, lambda *a, _n=name: called.append(_n))
    monkeypatch.setattr(kernels, "_load", lambda name: pytest.fail("a kernel was reached"))
    t = torch.zeros((1, 4, 12))
    ST.stage_attention_forward(t)
    ST.stage_attention_backward(t, t[..., :4])
    ST.gelu_tanh_forward(t)
    ST.gelu_tanh_backward(t, t)
    ST.sgd_update_many([t], [t], 0.1)
    assert called == ["stage_attention_plain", "stage_attention_backward_plain", "gelu_tanh_plain",
                      "gelu_tanh_backward_plain", "sgd_update_plain"]


class _StageLib:
    """A stand-in for csrc/stage.cu's library: stract_sgd_multi records "sgd",
    stract_gelu_tanh and its backward "gelu" and "gelu_bwd" (with their
    arguments when `args` is given), and each returns success."""

    def __init__(self, called, args=None):
        self.called, self.args = called, args

    def stract_sgd_multi(self, args, blocks, stream):
        self.called.append("sgd")
        return 0

    def stract_gelu_tanh(self, *args):
        self.called.append("gelu")
        if self.args is not None:
            self.args.append(args)
        return 0

    def stract_gelu_tanh_backward(self, *args):
        self.called.append("gelu_bwd")
        if self.args is not None:
            self.args.append(args)
        return 0


def test_cuda_tensors_launch_the_kernels(monkeypatch):
    """A CUDA tensor reaches the kernel wrappers, never a twin (stand-ins, so
    it runs without a card); each wrapper counts its launch."""
    called = []
    for name in ("stage_attention_plain", "stage_attention_backward_plain", "gelu_tanh_plain",
                 "gelu_tanh_backward_plain", "sgd_update_plain"):
        monkeypatch.setattr(ST, name, lambda *a, _n=name: pytest.fail(f"{_n} was reached"))
    monkeypatch.setattr(kernels, "_load", lambda name: _StageLib(called))
    monkeypatch.setattr(kernels, "stage_attention", lambda *a: called.append("K16a"))
    monkeypatch.setattr(kernels, "stage_attention_backward", lambda *a: called.append("K16b"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))  # card, stream
    kernels.reset_launches()
    t = torch.zeros((1, 4, 12))
    ST.stage_attention_forward(t)
    ST.stage_attention_backward(t, t[..., :4].contiguous())
    ST.gelu_tanh_forward(t)
    ST.gelu_tanh_backward(t, t)
    ST.sgd_update_many([t], [t], 0.1)
    assert called == ["K16a", "K16b", "gelu", "gelu_bwd", "sgd"]
    assert kernels.LAUNCHES["gelu_tanh"] == 2 and kernels.LAUNCHES["sgd"] == 1


def _misaligned_f32(n: int):
    """A contiguous f32 tensor of n elements that starts 4 bytes past a
    16-byte boundary."""
    flat = torch.zeros(n + 4)
    start = next(i for i in range(4) if (flat.data_ptr() + 4 * i) % 16)
    return flat[start:start + n]


@pytest.mark.parametrize("shape,misaligned", [((8, 128, 1536), False), ((3, 7), False),
                                              ((1_572_865,), False), ((1001,), True),
                                              ((0, 1536), False)])
def test_gelu_tanh_reaches_its_c_entry_points(monkeypatch, shape, misaligned):
    """K16c on CUDA tensors (stand-ins) calls stract_gelu_tanh and
    stract_gelu_tanh_backward once each with the flat length and its
    tensors' pointers, at any length (n % 4 != 0) and on a view at an
    offset (the kernel picks its piece width), names no Triton and counts one
    launch each; with no elements it launches and counts nothing. The same
    tensors on the CPU take the twins."""
    import sys

    n = int(np.prod(shape))
    x = _misaligned_f32(n).view(shape) if misaligned else torch.zeros(shape)
    g = torch.zeros(shape)
    assert not misaligned or x.data_ptr() % 16
    torch.testing.assert_close(ST.gelu_tanh_forward(x), ST.gelu_tanh_plain(x))
    torch.testing.assert_close(ST.gelu_tanh_backward(x, g), ST.gelu_tanh_backward_plain(x, g))
    called, args = [], []
    for name in ("gelu_tanh_plain", "gelu_tanh_backward_plain"):
        monkeypatch.setattr(ST, name, lambda *a, _n=name: pytest.fail(f"{_n} was reached"))
    monkeypatch.setattr(kernels, "_load", lambda name: _StageLib(called, args))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.delitem(sys.modules, "triton", raising=False)
    kernels.reset_launches()
    y = ST.gelu_tanh_forward(x)
    dx = ST.gelu_tanh_backward(x, g)
    assert y.shape == shape and dx.shape == shape and "triton" not in sys.modules
    if n == 0:
        assert called == [] and kernels.LAUNCHES["gelu_tanh"] == 0
        return
    assert called == ["gelu", "gelu_bwd"] and kernels.LAUNCHES["gelu_tanh"] == 2
    assert args[0] == (x.data_ptr(), y.data_ptr(), n, 0)
    assert args[1] == (x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, 0)


@pytest.mark.parametrize("shape", [(1, 513, 48), (1, 16, 3 * 1025), (1, 16, 50)])
def test_stage_attention_arguments_are_checked(monkeypatch, shape):
    """A width that is not 3H raises before any build or launch; T above
    512 and H above 1,024 (where K16a-b once stopped) reach the C entry
    points with that T and H, forward and backward, each counted once."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    if shape[2] % 3:
        monkeypatch.setattr(kernels, "_load", lambda name: pytest.fail("no build here"))
        with pytest.raises(ValueError, match="stage attention"):
            ST.stage_attention_forward(torch.zeros(shape))
        return
    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    kernels.reset_launches()
    mb, T, H = shape[0], shape[1], shape[2] // 3
    out = ST.stage_attention_forward(torch.zeros(shape))
    dqkv = ST.stage_attention_backward(torch.zeros(shape), torch.zeros((mb, T, H)))
    assert out.shape == (mb, T, H) and dqkv.shape == shape
    assert [c[0] for c in called] == ["stract_stage_attention",
                                      "stract_stage_attention_backward"]
    assert all(c[1][-4:] == (mb, T, H, 0) for c in called)
    assert kernels.LAUNCHES["stage_attention"] == kernels.LAUNCHES["stage_attention_backward"] == 1


# ---- on the card ----------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    return "cuda"


def _close(got, want, rtol, atol_of_max):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_of_max * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mb,T,H", [(2, 16, 16), (3, 37, 40), (8, 128, 384), (1, 256, 1024),
                                    (2, 257, 768), (1, 512, 1024), (2, 512, 384), (1, 1024, 384),
                                    (1, 2048, 384), (2, 1031, 36), (1, 128, 2048),
                                    (1, 300, 1536),
                                    (3, 65, 36), (1, 1, 8), (2, 33, 30)])
def test_stage_attention_kernels_match_plain(mb, T, H):
    """K16a (3xTF32 on the tensor cores) and K16b against the f32 twins at
    rtol 1e-5, atol 1e-5 x max |plain|, from tiny shapes and widths that are
    not multiples of 8 or of 128 (H = 30: rows staged by 4-byte copies) up
    to T = 1,024 (the one-tile forms), past it (the key-chunked forms: T =
    1,031 with H = 36 staged by 4-byte copies, 2,048) and past H = 1,024;
    each call counted once, and a second call bit-equal to the first."""
    dev = _card()
    g = torch.Generator().manual_seed(T + H)
    qkv = torch.randn((mb, T, 3 * H), generator=g).to(dev)
    dout = torch.randn((mb, T, H), generator=g).to(dev)
    n = dict(kernels.LAUNCHES)
    out = ST.stage_attention_forward(qkv)
    dqkv = ST.stage_attention_backward(qkv, dout)
    assert kernels.LAUNCHES["stage_attention"] == n["stage_attention"] + 1
    assert kernels.LAUNCHES["stage_attention_backward"] == n["stage_attention_backward"] + 1
    _close(out, ST.stage_attention_plain(qkv), 1e-5, 1e-5)
    _close(dqkv, ST.stage_attention_backward_plain(qkv, dout), 1e-5, 1e-5)
    leaf = qkv.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ST.stage_attention_plain(leaf), leaf, dout)
    _close(dqkv, auto, 1e-5, 1e-5)
    assert torch.equal(ST.stage_attention_forward(qkv), out)
    assert torch.equal(ST.stage_attention_backward(qkv, dout), dqkv)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 32), (8, 128, 1536), (1_572_865,), (1001,)])
def test_gelu_and_sgd_kernels_match_plain(shape):
    """K16c forward and backward within rtol 1e-5, atol 1e-6 x max |x| of the
    twins at the step's shape and odd lengths, on a view 4 bytes past a
    16-byte boundary too, each call counted once and a second call
    bit-equal; at |x| = 10, 50, 1e4 finite, with t = +-1 exactly (gelu = x or
    0, its gradient the cotangent or 0). K16d bit-equal to its twin."""
    dev = _card()
    g = torch.Generator().manual_seed(7)
    x = (3 * torch.randn(shape, generator=g)).to(dev)
    dout = torch.randn(shape, generator=g).to(dev)
    n = x.numel()
    view = torch.cat([torch.zeros(1), x.reshape(-1).cpu()]).to(dev)[1:]  # 4 B past the start
    assert view.data_ptr() % 16
    for xv, gv in ((x, dout), (view, dout.reshape(-1))):
        atol = 1e-6 * float(xv.abs().max())
        launches = kernels.LAUNCHES["gelu_tanh"]
        y, dx = ST.gelu_tanh_forward(xv), ST.gelu_tanh_backward(xv, gv)
        assert kernels.LAUNCHES["gelu_tanh"] == launches + 2
        torch.testing.assert_close(y, ST.gelu_tanh_plain(xv), rtol=1e-5, atol=atol)
        torch.testing.assert_close(dx, ST.gelu_tanh_backward_plain(xv, gv), rtol=1e-5, atol=atol)
        assert torch.equal(ST.gelu_tanh_forward(xv), y)
        assert torch.equal(ST.gelu_tanh_backward(xv, gv), dx)
    signs = torch.where(torch.arange(n, device=dev) % 2 == 0, 1.0, -1.0)
    for mag in (10.0, 50.0, 1e4):
        big = (mag * signs).reshape(shape)
        y, dx = ST.gelu_tanh_forward(big), ST.gelu_tanh_backward(big, dout)
        assert torch.isfinite(y).all() and torch.isfinite(dx).all()
        assert torch.equal(y, torch.where(big > 0, big, 0.0))
        assert torch.equal(dx, torch.where(big > 0, dout, 0.0))
    p = (0.02 * torch.randn(shape, generator=g)).to(dev)
    p_plain = p.clone()
    ST.sgd_update_many([p], [dout], 5e-2)
    ST.sgd_update_plain(p_plain, dout, 5e-2)
    assert torch.equal(p, p_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("count,launches", [(25, 1), (70, 2)])
def test_sgd_multi_kernel_matches_plain(count, launches):
    """K16d over 25 tensors (one launch) and 70 (two: 64 a launch), sizes 1
    and 3 and views at an element offset among them: bit-equal to the twin,
    LAUNCHES["sgd"] up by the launches."""
    dev = _card()
    sizes = SGD_SIZES if count == 25 else [(i * 997) % 50_000 + 1 for i in range(70)]
    ps, gs = _sgd_pairs(sizes, (1, 9, 17, 33, 69), count)
    ps = [p.to(dev) if i not in (1, 9, 17, 33, 69) else
          torch.cat([torch.zeros(1), p]).to(dev)[1:] for i, p in enumerate(ps)]
    gs = [g.to(dev) for g in gs]
    want = [p.clone() for p in ps]
    n = kernels.LAUNCHES["sgd"]
    ST.sgd_update_many(ps, gs, 5e-2)
    ST.sgd_update_many_plain(want, gs, 5e-2)
    assert kernels.LAUNCHES["sgd"] == n + launches
    assert any(p.data_ptr() % 16 for p in ps)
    assert all(torch.equal(a, b) for a, b in zip(ps, want))


@pytest.mark.cuda
def test_stage_attention_kernel_refuses_long_sequences():
    """The length it once refused and past the one-tile forms' 1,024: T =
    1,536 at H = 48 (half a chunk in the last) takes the key-chunked K16a
    and K16b within rtol 1e-5, atol 1e-5 x max |plain| of the twins, each
    counted once."""
    dev = _card()
    g = torch.Generator().manual_seed(1536)
    qkv = torch.randn((1, 1536, 144), generator=g).to(dev)
    dout = torch.randn((1, 1536, 48), generator=g).to(dev)
    n = dict(kernels.LAUNCHES)
    _close(ST.stage_attention_forward(qkv), ST.stage_attention_plain(qkv), 1e-5, 1e-5)
    _close(ST.stage_attention_backward(qkv, dout), ST.stage_attention_backward_plain(qkv, dout),
           1e-5, 1e-5)
    assert kernels.LAUNCHES["stage_attention"] == n["stage_attention"] + 1
    assert kernels.LAUNCHES["stage_attention_backward"] == n["stage_attention_backward"] + 1


@pytest.mark.cuda
def test_train_step_on_the_card_follows_the_cpu():
    """Five steps on Mesh([cuda:0] * 8) as (pp=4, dp=2) with the kernels
    against the same steps on a CPU mesh (the twins): losses rtol 1e-5."""
    dev = _card()
    mbs, targets = _recipe(4)
    losses = []
    for mesh in (Mesh([[torch.device(dev, 0)] * 2] * 4, axis_names=("pp", "dp")), _cpu_mesh(4, 2)):
        init_fn, step_fn = TP.make_pipeline_train_step(mesh, hidden=16, ffn=32, learning_rate=5e-2)
        params = init_fn(2)
        losses.append([float(step_fn(params, torch.from_numpy(mbs), torch.from_numpy(targets))[1])
                       for _ in range(5)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [1, 2])
def test_train_step_across_cards_follows_the_cpu(dp):
    """The stages on different cards (stage s, shard d on cuda:(s * dp + d)):
    the activations and the dp shards' parameter reads cross cards by peer
    copies, each kernel launches on its tensor's card; five steps against
    the same steps on a CPU mesh, losses rtol 1e-5, parameters atol 1e-6."""
    dev = _card()
    n = torch.cuda.device_count()
    if n < 2 * dp:
        pytest.skip(f"needs {2 * dp} cards, has {n}")
    pp = n // dp
    mbs, targets = _recipe(6)
    cards = Mesh([[torch.device(dev, s * dp + d) for d in range(dp)] for s in range(pp)],
                 axis_names=("pp", "dp"))
    runs = []
    for mesh in (cards, _cpu_mesh(pp, dp)):
        init_fn, step_fn = TP.make_pipeline_train_step(mesh, hidden=16, ffn=32, learning_rate=5e-2)
        params = init_fn(3)
        losses = [float(step_fn(params, torch.from_numpy(mbs), torch.from_numpy(targets))[1])
                  for _ in range(5)]
        runs.append((losses, params))
    assert [t.device.index for t in runs[0][1]["ffn_in"]] == [s * dp for s in range(pp)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    got, want = TP.params_to_numpy(runs[0][1]), TP.params_to_numpy(runs[1][1])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
