"""The MoE FFN (K15a-b), the loss heads (K15c) and the bf16 AdamW (K15d), the
port against the JAX package on the CPU at BertConfig.tiny() with E = 4
experts: MoEMlp and the whole BertForSequenceScore forward against flax with
weights carried by params_from_jax, the parameter round trip, gradients of
every parameter against jax.grad, MoEMlp's VJP against jax.vjp at E = 1, 4
and 16, a tied router row, the bf16 AdamW against
optax.adamw, the loss heads against the JAX expressions, and 5-step loss
curves against the JAX package's make_train_state(num_experts=4) and its
train steps. Inputs are made with numpy from seeds.

Tolerances, and why:
  - MoEMlp: the router's choice equal, the gate within one bf16 step; the
    output within one bf16 step of its largest magnitude (rtol 2^-7, atol
    2^-7 x max |ref|): the first expert product and the combine agree bit
    for bit, but the GELU is K5c's (f32 inside, one rounding), where
    jax.nn.gelu on a bf16 input rounds each of its steps to bf16, and a bf16
    step of a hidden unit passes through the second product into every
    output of its token, small ones included;
  - the whole model's scores: rtol 1e-2, atol 1e-2 (that difference through
    two layers, LayerNorms and the f32 head);
  - the parameter round trip: bit-equal (the bf16 expert tensors travel as
    f32 arrays of the same values);
  - gradients: as tests/test_torch_training.py, cosine >= 0.999 for every
    leaf the reference determines (its bf16 gradient at cosine >= 0.999 to
    the same model's in f32), else as close to the f32 gradient as the
    reference's (within twice its distance);
  - the bf16 AdamW: bit-equal to optax over 5 steps (each operation rounds
    to bf16 in both);
  - the loss heads: rtol 1e-6 (the same f32 expressions);
  - 5 steps of training: losses within 5 % at every step, as the dense
    step's 10-step curves.
The `cuda`-marked tests holding each kernel against its plain twin on a
card are in tests/test_torch_kernels.py.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stract_tpu.models import bert as JB
from stract_tpu.parallel import train as JPT
from stract_tpu.parallel.mesh import make_mesh
from stract_tpu_torch.models import bert as TB
from stract_tpu_torch.ops import losses as LO
from stract_tpu_torch.ops import moe as MO
from stract_tpu_torch.optim import AdamW
from stract_tpu_torch.parallel import train as TPT

from test_torch_training import _batch, _cos

E_ = 4
STEP = 2 ** -7
GRAD_COS, CURVE_RTOL = 0.999, 0.05


def _bt(a) -> torch.Tensor:
    """A JAX / numpy array as a tensor of the same dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a).astype(np.float32)


def _init(module, *args, seed: int = 3):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(
        module.init(jax.random.PRNGKey(seed), *args)))


# ---- the forward --------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_pair():
    """A JAX MoEMlp at tiny width, its params, and the port's with the same
    values."""
    cfg = JB.BertConfig.tiny()
    x = jnp.asarray(np.random.default_rng(1).normal(size=(3, 12, 64)), jnp.bfloat16)
    jm = JB.MoEMlp(cfg, E_)
    params = _init(jm, x)
    tm = TB.MoEMlp(TB.BertConfig.tiny(), E_)
    tm.load_state_dict(TB.params_from_jax(params))
    return jm, params, tm, x


def test_moe_mlp_forward_matches_flax(moe_pair):
    jm, params, tm, x = moe_pair
    p = params["params"]
    assert p["experts_in"].dtype.name == "bfloat16" and p["router"]["kernel"].dtype == np.float32
    assert tm.experts_in.dtype == torch.bfloat16 and tm.router.weight.dtype == torch.float32
    y_j = _f32(jm.apply(params, x))
    y_t = tm(_bt(x))
    assert y_t.dtype == torch.bfloat16 and y_t.shape == (3, 12, 64)
    y_t = _f32(y_t)
    np.testing.assert_allclose(y_t, y_j, rtol=STEP, atol=STEP * np.abs(y_j).max())
    # the router: the same expert for every token, the gate within a bf16 step
    xf = np.asarray(x).astype(np.float32).reshape(-1, 64)
    probs = jax.nn.softmax(xf @ p["router"]["kernel"] + p["router"]["bias"], axis=-1)
    top_j = np.asarray(jnp.argmax(probs, axis=-1))
    top_t, gate_t = MO.router(_bt(x).reshape(-1, 64), tm.router.weight, tm.router.bias)
    np.testing.assert_array_equal(top_t.numpy(), top_j)
    assert len(np.unique(top_j)) > 1  # the tokens spread over several experts
    gate_j = np.take_along_axis(np.asarray(probs), top_j[:, None], 1)[:, 0]
    np.testing.assert_allclose(_f32(gate_t), gate_j, rtol=STEP)


def test_moe_cross_encoder_forward_and_parameter_round_trip():
    cfg = JB.BertConfig.tiny()
    jm = JB.BertForSequenceScore(cfg, num_experts=E_)
    params = _init(jm, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    tm = TB.BertForSequenceScore(TB.BertConfig.tiny(), param_dtype=torch.float32,
                                 num_experts=E_)
    sd = TB.params_from_jax(params)
    assert set(sd) == set(tm.state_dict())
    assert sd["bert.layer_0.moe.experts_in"].dtype == torch.bfloat16
    assert tuple(sd["bert.layer_0.moe.experts_in"].shape) == (E_, 64, 128)
    assert tuple(sd["bert.layer_1.moe.router.weight"].shape) == (E_, 64)  # transposed
    tm.load_state_dict(sd)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[1, 10:] = 0
    s_j = np.asarray(jm.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    s_t = tm(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-2, atol=1e-2)
    # back to flax's layout: every leaf bit-equal in value, the experts included
    back = TB.params_to_jax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.shape == leaf.shape, path
        np.testing.assert_array_equal(got, np.asarray(leaf).astype(np.float32), err_msg=str(path))


def test_tied_router_row_goes_to_the_first_expert():
    """Two experts with the same router row and bias tie on every token:
    the first of them wins, in the port as in jnp.argmax."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64, E_)).astype(np.float32)
    b = rng.normal(0, 0.1, E_).astype(np.float32)
    w[:, 2], b[2] = w[:, 0], b[0]
    xb = jnp.asarray(x, jnp.bfloat16)
    probs = jax.nn.softmax(np.asarray(xb).astype(np.float32) @ w + b, axis=-1)
    top_j = np.asarray(jnp.argmax(probs, axis=-1))
    top_t, _ = MO.router(_bt(xb), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    np.testing.assert_array_equal(top_t.numpy(), top_j)
    assert (top_j == 0).any() and not (top_j == 2).any()


# ---- gradients ---------------------------------------------------------------------------
def _models(kind: str, dtype=None):
    cfg = JB.BertConfig.tiny(**({"dtype": dtype} if dtype else {}))
    jm = JB.BertForSequenceScore(cfg, num_experts=E_)
    params = _init(jm, jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32), seed=12)
    tm = TB.BertForSequenceScore(TB.BertConfig.tiny(), param_dtype=torch.float32,
                                 num_experts=E_)
    tm.load_state_dict(TB.params_from_jax(params))
    return jm, params, tm


def _loss_fn(kind: str, jm, alpha: float = 2.0):
    def loss_fn(p, b):
        s_pos = jm.apply(p, b["pos_ids"], b["pos_mask"], b["pos_types"])
        s_neg = jm.apply(p, b["neg_ids"], b["neg_mask"], b["neg_types"])
        loss = JPT.ranking_loss(s_pos, s_neg)
        if kind == "distill":
            loss = loss + alpha * (jnp.mean((s_pos - b["t_pos"]) ** 2)
                                   + jnp.mean((s_neg - b["t_neg"]) ** 2))
        return loss
    return jax.jit(jax.value_and_grad(loss_fn))


def _port_loss(kind: str):
    return (TPT.distill_loss, {"alpha": 2.0}) if kind == "distill" else (TPT.pairwise_loss, {})


@pytest.mark.parametrize("kind", ["pairwise", "distill"])
def test_moe_gradients_match_jax(kind):
    batch = _batch(kind)
    jm, params, tm = _models(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = _loss_fn(kind, jm)(params, jb)
    jm32 = JB.BertForSequenceScore(JB.BertConfig.tiny(dtype=jnp.float32), num_experts=E_)
    p32 = jax.tree_util.tree_map(lambda a: np.asarray(a).astype(np.float32), params)
    _, grads_f32 = _loss_fn(kind, jm32)(p32, jb)
    fn, kw = _port_loss(kind)
    loss_t = fn(tm, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-2 * abs(float(loss_j))
    ref, exact = (TB.params_from_jax(jax.tree_util.tree_map(np.asarray, g))
                  for g in (grads_j, grads_f32))
    got = dict(tm.named_parameters())
    assert set(ref) == set(got)
    determined, experts = 0, 0
    for name, r in ref.items():
        g = got[name].grad
        assert g.dtype == got[name].dtype, name  # bf16 gradients for the bf16 experts
        r, x = r.float(), exact[name].float()
        if not r.any():
            assert not g.any(), name
        elif _cos(r, x) >= GRAD_COS:
            determined += 1
            experts += "experts" in name
            assert _cos(g.float(), r) >= GRAD_COS, (name, _cos(g.float(), r))
        else:
            assert (g.double() - x.double()).norm() <= 2 * (r.double() - x.double()).norm(), name
    # at init the pairwise loss hardly sees most leaves (s+ - s- cancels), the
    # experts among them; the distilled loss determines them
    assert determined >= (8 if kind == "pairwise" else 0.6 * len(ref))
    assert kind == "pairwise" or experts >= 4


@pytest.mark.parametrize("E", [1, 4, 16])
def test_moe_mlp_vjp_matches_jax(E):
    """jax.vjp of the JAX package's MoEMlp (BertConfig.tiny, E experts)
    against the port's MoEMlp backward on the CPU, the weights carried by
    params_from_jax and a seeded bf16 cotangent made with numpy: the chosen
    experts equal where the top two probabilities differ by more than 1e-5;
    x's cotangent, the router's kernel and bias and both expert tensors at
    cosine >= 0.999, test_moe_gradients_match_jax's tolerance (K5c's GELU,
    f32 inside and rounded once, against jax.nn.gelu's bf16 steps, reaches
    every cotangent through the experts and the gate); a leaf that the
    reference leaves at zero (the router at E = 1, where the softmax is
    constant; an expert no token chose) zero in the port."""
    cfg = JB.BertConfig.tiny()
    rng = np.random.default_rng(20 + E)
    x = jnp.asarray(rng.normal(size=(3, 12, 64)), jnp.bfloat16)
    ct = jnp.asarray(rng.normal(size=(3, 12, 64)), jnp.bfloat16)
    jm = JB.MoEMlp(cfg, E)
    params = _init(jm, x, seed=E)
    _, vjp = jax.vjp(lambda p, xx: jm.apply(p, xx), params, x)
    grads_j, gx_j = vjp(ct)
    tm = TB.MoEMlp(TB.BertConfig.tiny(), E)
    tm.load_state_dict(TB.params_from_jax(params))
    xt = _bt(x).requires_grad_()
    tm(xt).backward(_bt(ct))
    # the chosen experts
    p = params["params"]["router"]
    xf = np.asarray(x).astype(np.float32).reshape(-1, 64)
    probs = np.asarray(jax.nn.softmax(xf @ p["kernel"] + p["bias"], axis=-1))
    top_t, _ = MO.router(_bt(x).reshape(-1, 64), tm.router.weight, tm.router.bias)
    ranked = np.sort(probs, axis=-1)
    clear = ranked[:, -1] - ranked[:, -2] > 1e-5 if E > 1 else np.ones(len(xf), bool)
    np.testing.assert_array_equal(top_t.numpy()[clear], probs.argmax(-1)[clear])
    ref = TB.params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    got = {name: prm.grad for name, prm in tm.named_parameters()}
    assert set(ref) == set(got) == {"router.weight", "router.bias", "experts_in", "experts_out"}
    pairs = [(name, got[name], ref[name]) for name in sorted(ref)] + [("x", xt.grad, _bt(gx_j))]
    for name, g, r in pairs:
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if not r.float().any():
            assert not g.float().any(), name
        else:
            assert _cos(g.float(), r.float()) >= GRAD_COS, (name, _cos(g.float(), r.float()))
    assert E == 1 or ref["router.weight"].any()


def test_router_backward_plain_keeps_its_arithmetic():
    """router_backward_plain's parameter gradients are the f32 product and
    sum the port took in PyTorch over the logits' cotangent, bit for bit:
    dl.t() @ x.float() and dl.sum(0), with dx = bf16(dl @ w)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(37, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.1, (E_, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, E_).astype(np.float32))
    dgate = torch.from_numpy(rng.normal(size=37).astype(np.float32)).to(torch.bfloat16)
    probs, top, _ = MO.router_plain(x, w, b)
    dx, dw, db = MO.router_backward_plain(x, probs, top, dgate, w)
    idx = top.long()[:, None]
    onehot = torch.zeros_like(probs).scatter_(1, idx, probs.gather(1, idx) * dgate.float()[:, None])
    dl = onehot + probs * (-onehot.sum(dim=-1, keepdim=True))
    assert torch.equal(dw, dl.t() @ x.float()) and torch.equal(db, dl.sum(dim=0))
    assert torch.equal(dx, (dl @ w).to(torch.bfloat16))
    assert dw.dtype == db.dtype == torch.float32 and dx.dtype == torch.bfloat16


# ---- the optimizer and the loss heads ----------------------------------------------------
def test_bf16_adamw_matches_optax_bit_for_bit():
    """optax.adamw over a mixed tree (bf16 experts, f32 weights), 5 steps on
    the same gradients: bf16 parameters and moments bit-equal, f32 ones
    within rtol 1e-6 (as test_adamw_twin_matches_optax)."""
    rng = np.random.default_rng(10)
    params = {"experts": jnp.asarray(rng.normal(0, 0.02, (E_, 8, 16)), jnp.bfloat16),
              "w": jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)}
    grads = [{"experts": jnp.asarray(rng.normal(size=(E_, 8, 16)) * 10.0 ** -i, jnp.bfloat16),
              "w": jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)} for i in range(5)]
    opt = optax.adamw(1e-3)
    jp, state = params, opt.init(params)
    tp = {k: torch.nn.Parameter(_bt(v)) for k, v in params.items()}
    adam = AdamW(tp.values(), 1e-3)
    for gr in grads:
        upd, state = opt.update(gr, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad.copy_(_bt(gr[k]))
        adam.step()
        np.testing.assert_array_equal(_f32(tp["experts"]), _f32(jp["experts"]))
    grp = adam.groups[torch.bfloat16]
    assert grp.m.dtype == torch.bfloat16 and state[0].mu["experts"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(_f32(grp.m), _f32(state[0].mu["experts"]).ravel())
    np.testing.assert_array_equal(_f32(grp.v), _f32(state[0].nu["experts"]).ravel())
    np.testing.assert_allclose(_f32(tp["w"]), _f32(jp["w"]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("distill", [False, True])
def test_pair_loss_head_matches_jax(distill):
    rng = np.random.default_rng(7)
    sp, sn, tp, tn = (rng.normal(0, 3, 16).astype(np.float32) for _ in range(4))

    def ref(a, b):
        loss = JPT.ranking_loss(a, b)
        if distill:
            loss = loss + 0.5 * (jnp.mean((a - tp) ** 2) + jnp.mean((b - tn) ** 2))
        return loss

    loss_j, (ga, gb) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(sp), jnp.asarray(sn))
    a, b = (torch.from_numpy(v).requires_grad_() for v in (sp, sn))
    args = (torch.from_numpy(tp), torch.from_numpy(tn), 0.5) if distill else ()
    loss_t = LO.pair_loss(a, b, *args)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=1e-6, atol=1e-9)
    # the step's own losses go through the head
    assert TPT.ranking_loss(a, b).grad_fn is not None


def test_info_nce_head_matches_optax():
    rng = np.random.default_rng(8)
    logits = (20.0 * rng.normal(0, 0.3, (8, 8))).astype(np.float32)

    def ref(lg):
        return optax.softmax_cross_entropy_with_integer_labels(lg, jnp.arange(8)).mean()

    loss_j, g_j = jax.value_and_grad(ref)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    loss_t = LO.info_nce(lt)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-9)


# ---- 5-step loss curves against the JAX package's train state ------------------------------
@pytest.mark.parametrize("kind", ["pairwise", "distill"])
def test_moe_loss_curves_match_jax_train_state(kind):
    """The JAX package's make_train_state(num_experts=4) on a one-device
    mesh and its jitted train steps (pairwise, or distilled at alpha 0.5)
    against the port's make_train_state(num_experts=4) started from the
    same parameters: the same 5 batches, AdamW at lr 1e-3."""
    mesh = make_mesh(1, axes=("dp", "tp", "sp", "ep"))
    cfg = JB.BertConfig.tiny()
    with mesh:
        jm, params, opt_state, opt, shardings = JPT.make_train_state(cfg, mesh, 1e-3, seed=2,
                                                                     num_experts=E_)
        step = (JPT.make_jitted_distill_step(jm, opt, mesh, shardings, alpha=0.5)
                if kind == "distill" else JPT.make_jitted_train_step(jm, opt, mesh, shardings))
        model, adam = TPT.make_train_state(TB.BertConfig.tiny(), 1e-3, num_experts=E_,
                                           device="cpu")
        model.load_state_dict(TB.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        assert set(adam.groups) == {torch.float32, torch.bfloat16}
        fn, kw = (TPT.distill_loss, {"alpha": 0.5}) if kind == "distill" else \
            (TPT.pairwise_loss, {})
        losses = []
        for i in range(5):
            batch = _batch(kind, seed=i)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            params, opt_state, loss_j = step(params, opt_state, jb)
            loss_t = TPT.train_step(model, adam, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()}, fn, **kw)
            assert abs(float(loss_t) - float(loss_j)) <= CURVE_RTOL * abs(float(loss_j)), i
            losses.append(float(loss_t))
    assert all(np.isfinite(losses))
    assert model.bert.layer_0.moe.experts_in.dtype == torch.bfloat16
