"""Parity of the port's encoder training (stract_tpu_torch/ops/encoder.py
backward twins, optim.py, parallel/train.py, entrypoint/train_encoders.py)
with the JAX package's on the CPU, at BertConfig.tiny(), with inputs made
from numpy seeds and weights carried across by params_from_jax. The kernels
themselves (K14a-d, K5d) are held against these twins on a card in
test_torch_kernels.py.

Tolerances, and why:
  - backward twins against jax.vjp of the reference body: one bf16 step
    relative per element (rtol 2^-7), plus 2^-16 x the largest magnitude
    for elements near zero, where the two sides sum f32 terms in other
    orders before the bf16 rounding. The twins put their bf16 roundings
    where the reference's VJP puts them, so most elements agree exactly.
  - the bias gradient of bias + GELU against the exact column sum of the
    reference's own dy: the reference (XLA on the CPU) sums the bf16
    cotangent in bf16 partials, the twin sums in f32 (as a TPU reduces).
  - AdamW against optax.adamw over 5 steps: rtol 1e-6 (the same f32 ops in
    the same order; the bias correction's power may differ by an ulp).
  - one train step: losses within 1e-2 relative, each parameter's gradient
    at cosine >= 0.999 (bf16 products summed in other orders, and the
    embedding tables' scatter-add accumulating duplicates in other orders).
  - 10 steps of training: losses within 5 % at every step. Parameters are
    not compared after a step: AdamW's first update is about lr x sign(g),
    so a near-zero gradient may legitimately flip sign between packages.
  - a checkpoint trained by the port, loaded by both packages: embeddings at
    cosine >= 0.9999.
"""

from __future__ import annotations

import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_doc
from stract_tpu.entrypoint import train_encoders as JT
from stract_tpu.index import InvertedIndex
from stract_tpu.models import bert as JB
from stract_tpu.models import wordpiece as JW
from stract_tpu.parallel import train as JPT
from stract_tpu_torch.entrypoint import train_encoders as TT
from stract_tpu_torch.models import bert as TB
from stract_tpu_torch.models import store as TS
from stract_tpu_torch.models.dual_encoder import DualEncoder
from stract_tpu_torch.ops import encoder as E
from stract_tpu_torch.optim import AdamW
from stract_tpu_torch.parallel import train as TPT

BF = jnp.bfloat16
STEP_RTOL = 2 ** -7
LOSS_RTOL, GRAD_COS, CURVE_RTOL = 1e-2, 0.999, 0.05


def _bt(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        jnp.asarray(a).astype(jnp.float32))


def assert_one_bf16_step(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=STEP_RTOL, atol=2 ** -16 * np.abs(ref).max())


@pytest.fixture(scope="module")
def corpus_index(tmp_path_factory):
    """The topically clustered corpus of tests/test_encoder_training.py (120
    docs, each drawn from one of 6 topic vocabularies)."""
    rng = np.random.default_rng(2)
    topics = [[f"t{t}w{i}" for i in range(8)] for t in range(6)]
    idx = InvertedIndex(str(tmp_path_factory.mktemp("enc-corpus")))
    for i in range(120):
        toks = list(rng.choice(topics[i % 6], size=10)) + list(
            rng.choice(["shared", "common"], size=2))
        rng.shuffle(toks)
        idx.insert(make_doc(f"https://e{i}.com/p", " ".join(toks[:3]), " ".join(toks)))
    idx.commit()
    return idx


# ---- the backward twins against jax.vjp of the reference bodies --------------------------
def _attention_vjp(q, k, v, mask, dout):
    """jax.vjp of bert.py:97-103 on bf16 q, k, v [B, T, h, d] (f32 arrays
    rounded to bf16), cotangent dout [B, T, h * d] → (dq, dk, dv)."""
    B, T, h, d = q.shape

    def body(q, k, v):
        scores = jnp.einsum("bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32)
        scores = scores / np.sqrt(d)
        scores = jnp.where(jnp.asarray(mask, bool)[:, None, None, :], scores,
                           jnp.finfo(jnp.float32).min)
        probs = jax.nn.softmax(scores, axis=-1).astype(BF)
        ctx = jnp.einsum("bhts,bshd->bthd", probs, v, preferred_element_type=jnp.float32)
        return ctx.astype(BF).reshape(B, T, h * d)

    _, vjp = jax.vjp(body, *(jnp.asarray(a, BF) for a in (q, k, v)))
    return vjp(jnp.asarray(dout, BF))


def test_attention_backward_twin_matches_jax_vjp():
    """bert.py:97-103, with one half- and one fully padded row."""
    rng = np.random.default_rng(5)
    B, T, h, d = 3, 12, 4, 32
    q, k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.normal(size=(B, T, h * d)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    mask[2] = 0

    ref = _attention_vjp(q, k, v, mask, dout)
    got = E.attention_backward_plain(_bt(q), _bt(k), _bt(v), torch.from_numpy(mask), _bt(dout))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert_one_bf16_step(g, r)
    assert not _np(got[0])[2].any()  # the fully padded row: no score gradient


@pytest.mark.parametrize("T", [257, 512, 600, 1100])
@pytest.mark.parametrize("h,d", [(4, 16), (2, 64)])
def test_attention_backward_twin_matches_jax_vjp_at_other_head_dims(h, d, T):
    """The twin at head dim 16 (BertConfig.tiny's) and 64 (BERT-base's),
    past the one-pass kernels' 256 tokens, at 512 and past it; rows half,
    fully and tail masked. One bf16 step relative, plus 2^-12 (not 2^-16) x the
    largest magnitude near zero: dV sums 257-512 bf16 products a element,
    which XLA's CPU dot and torch's einsum take in other orders (2^-12.8 of
    the largest magnitude at most, at T = 512)."""
    rng = np.random.default_rng(T + d)
    B = 4
    q, k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.normal(size=(B, T, h * d)).astype(np.float32)
    mask = _masks(B, T)
    ref = _attention_vjp(q, k, v, mask, dout)
    got = E.attention_backward_plain(_bt(q), _bt(k), _bt(v), torch.from_numpy(mask), _bt(dout))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == (B, T, h, d)
        g, r = _np(g), _np(r)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=STEP_RTOL, atol=2 ** -12 * np.abs(r).max())
    assert not _np(got[0])[2].any()


def _masks(B: int, T: int) -> np.ndarray:
    """Row 0 keeps every key; row 1 half, row 2 fully, row 3 its last fifth masked."""
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask[3, T - max(1, T // 5):] = 0
    return mask


def _chunked_stats(x, exp):
    """Each row's max and sum of exp(x - max) as the chunked kernels take
    them: a 64-key chunk at a time, the running sum scaled by
    exp(old max - new max) when the max grows (x [..., T], keys past T not
    in it) → (max, sum), each [..., 1]."""
    mx = torch.full(x.shape[:-1] + (1,), torch.finfo(torch.float32).min)
    total = torch.zeros_like(mx)
    for c in range(0, x.shape[-1], 64):
        chunk = x[..., c:c + 64]
        m = torch.maximum(mx, chunk.amax(dim=-1, keepdim=True))
        total = total * exp(mx - m) + exp(chunk - m).sum(dim=-1, keepdim=True)
        mx = m
    return mx, total


@pytest.mark.parametrize("T", [257, 512, 600, 1100])
@pytest.mark.parametrize("h,d", [(4, 16), (3, 32), (2, 64)])
def test_chunked_attention_rounding_matches_jax(h, d, T):
    """K5a's chunked form (the row's max and sum from 64-key chunks, the sum
    rescaled as the max grows; p = exp(s - max) / sum rounded to bf16, as
    the reference rounds its normalised probabilities) fits the card test's
    tolerance against the reference body in jnp: rtol 2^-7, atol 2e-2."""
    rng = np.random.default_rng(T * d)
    B = 4
    q, k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(3))
    mask = _masks(B, T)
    qj, kj, vj = (jnp.asarray(a, BF) for a in (q, k, v))
    sc = jnp.einsum("bthd,bshd->bhts", qj, kj, preferred_element_type=jnp.float32) / np.sqrt(d)
    sc = jnp.where(jnp.asarray(mask, bool)[:, None, None, :], sc, jnp.finfo(jnp.float32).min)
    ref = jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(sc, -1).astype(BF), vj,
                     preferred_element_type=jnp.float32).astype(BF).reshape(B, T, h * d)

    qf, kf, vf = (_bt(a).float() for a in (q, k, v))
    x = torch.einsum("bthd,bshd->bhts", qf, kf) / torch.tensor(d, dtype=torch.float32).sqrt()
    x = torch.where(torch.from_numpy(mask != 0)[:, None, None, :], x,
                    torch.finfo(torch.float32).min)
    mx, total = _chunked_stats(x, torch.exp)
    p = (torch.exp(x - mx) / total).to(torch.bfloat16).float()
    got = torch.einsum("bhts,bshd->bthd", p, vf).to(torch.bfloat16).reshape(B, T, h * d)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=STEP_RTOL, atol=2e-2)


def _split_product(eq: str, ds, x):
    """eq's product of an f32 dS with bf16 x as K14a's tensor cores take it:
    dS = hi + lo, two bf16 parts, both summed into one f32 result."""
    hi = ds.to(torch.bfloat16).float()
    return torch.einsum(eq, hi, x) + torch.einsum(eq, (ds - hi).to(torch.bfloat16).float(), x)


def _k14a_emulation(q, k, v, mask, dout, chunked: bool = False):
    """K14a's decomposition in plain torch (test-only, no kernel path calls
    it): the dQ pass takes P as a masked two-pass softmax, the divisions by
    sqrt(d) and by the row sum as multiplications by the f32 reciprocal,
    dP = bf16(dO.V^T) and D = rowsum(P dP), keeps each query row's (max,
    sum, D) in a scratch [B, h, T, 3], and multiplies dS / sqrt(d) by K
    split into bf16 hi + lo; the dK / dV pass forms P from the scratch's max
    and sum and dS from its D, dV = bf16(P)^T.dO and dK = dS^T.Q split
    alike → (dq, dk, dv) bf16. chunked: the dQ pass's max and sum as the
    chunked dQ kernel takes them (_chunked_stats)."""
    B, T, h, d = q.shape
    bf = torch.bfloat16
    qf, kf, vf = (t.float() for t in (q, k, v))
    g = dout.reshape(B, T, h, d).float()
    keep = (mask != 0)[:, None, None, :]
    inv_scale = 1 / torch.tensor(d, dtype=torch.float32).sqrt()
    x = torch.where(keep, torch.einsum("bthd,bshd->bhts", qf, kf) * inv_scale,
                    torch.finfo(torch.float32).min)
    dp = torch.einsum("bthd,bshd->bhts", g, vf).to(bf).float()

    def grad_scores(p, dsum):
        return torch.where(keep, (p * dp - p * dsum) * inv_scale, 0.0)

    # the dQ pass
    if chunked:
        mx, total = _chunked_stats(x, torch.exp)
        e = torch.exp(x - mx)
    else:
        mx = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - mx)
        total = e.sum(dim=-1, keepdim=True)
    p = e * (1 / total)
    dsum = (p * dp).sum(dim=-1, keepdim=True)
    stats = torch.cat([mx, total, dsum], dim=-1)
    dq = _split_product("bhts,bshd->bthd", grad_scores(p, dsum), kf)
    # the dK / dV pass, from the scratch
    p = torch.exp(x - stats[..., :1]) * (1 / stats[..., 1:2])
    dk = _split_product("bhts,bthd->bshd", grad_scores(p, stats[..., 2:]), qf)
    dv = torch.einsum("bhts,bthd->bshd", p.to(bf).float(), g)
    return dq.to(bf), dk.to(bf), dv.to(bf)


@pytest.mark.parametrize("T", [16, 65, 200])
def test_k14a_decomposition_matches_jax_vjp(T):
    """K14a's rounding (dP staged in bf16, dS as bf16 hi + lo into f32 sums,
    the dQ pass's statistics reused by the dK / dV pass) fits the card
    test's tolerance against jax.vjp of the reference: within one bf16 step
    of the largest magnitude; rows half, fully and tail masked."""
    rng = np.random.default_rng(T)
    B, h, d = 4, 3, 32
    q, k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.normal(size=(B, T, h * d)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask[3, T - max(1, T // 5):] = 0
    ref = _attention_vjp(q, k, v, mask, dout)
    got = _k14a_emulation(_bt(q), _bt(k), _bt(v), torch.from_numpy(mask), _bt(dout))
    for g, r in zip(got, ref):
        g, r = _np(g), _np(r)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=STEP_RTOL, atol=STEP_RTOL * np.abs(r).max())
    assert not _np(got[0])[2].any()  # the fully masked row: dQ = 0


@pytest.mark.parametrize("T", [257, 512, 600, 1100])
@pytest.mark.parametrize("h,d", [(4, 16), (2, 64)])
def test_chunked_k14a_decomposition_matches_jax_vjp(h, d, T):
    """The chunked dQ kernel's statistics (_chunked_stats, as K5a's chunked
    pass 1) through K14a's decomposition at head dims 16 and 64 past 256
    tokens, at 512 and past it (the lengths the kernels once refused):
    within one bf16 step of jax.vjp's largest magnitude."""
    rng = np.random.default_rng(T + 7 * d)
    B = 4
    q, k, v = (rng.normal(size=(B, T, h, d)).astype(np.float32) for _ in range(3))
    dout = rng.normal(size=(B, T, h * d)).astype(np.float32)
    mask = _masks(B, T)
    ref = _attention_vjp(q, k, v, mask, dout)
    got = _k14a_emulation(_bt(q), _bt(k), _bt(v), torch.from_numpy(mask), _bt(dout),
                          chunked=True)
    for g, r in zip(got, ref):
        g, r = _np(g), _np(r)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=STEP_RTOL, atol=STEP_RTOL * np.abs(r).max())
    assert not _np(got[0])[2].any()


# (N, M) where a term of ds rounds one bf16 step apart from JAX's (see below)
_LN_TERM_ROUNDING = {(768, 37)}


@pytest.mark.parametrize("M", [40, 37])
@pytest.mark.parametrize("N", [64, 384, 768])
def test_layernorm_backward_twin_matches_jax_vjp(N, M):
    """flax's LayerNorm(dtype=f32) of a bf16 sum, cast to bf16 (bert.py:164-165),
    at the widths of BertConfig.tiny, MiniLM and BERT-base, over 40 rows and
    an odd 37: the forward twin (K5b's) within one bf16 step of the primal
    output, ds, dweight and dbias within one bf16 step of jax.vjp.

    One shape is held otherwise. ds is the bf16 sum of two bf16-rounded terms
    (the (s - mean) path and the statistics' path), each an f32 expression
    whose sums over the row run in another order in JAX: a term that lies on
    a bf16 rounding boundary can round one step apart, which moves ds by a
    step of that term, not of ds. At N = 768, M = 37 this happens to one of
    the 28,416 values, where the terms cancel (4 steps of ds). There ds is
    held within one bf16 step at all but 0.1 % of its values, and those
    within one step of ds plus one of each term."""
    rng = np.random.default_rng(6)
    x, r, dy = (rng.normal(size=(M, N)).astype(np.float32) for _ in range(3))
    w = (1 + 0.1 * rng.normal(size=N)).astype(np.float32)
    b = (0.1 * rng.normal(size=N)).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-12, dtype=jnp.float32)

    def body(x, r, w, b):
        return ln.apply({"params": {"scale": w, "bias": b}}, x + r).astype(BF)

    y, vjp = jax.vjp(body, jnp.asarray(x, BF), jnp.asarray(r, BF), jnp.asarray(w), jnp.asarray(b))
    got = E.add_layernorm_plain(_bt(x), _bt(r), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    assert got.dtype == torch.bfloat16
    assert_one_bf16_step(got, y)
    gx, gr, gw, gb = vjp(jnp.asarray(dy, BF))
    ds, dw, db = E.add_layernorm_backward_plain(_bt(x), _bt(r), torch.from_numpy(w), 1e-12,
                                                _bt(dy))
    assert ds.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    for got, ref in ((dw, gw), (db, gb)):
        assert_one_bf16_step(got, ref)
    if (N, M) not in _LN_TERM_ROUNDING:
        for ref in (gx, gr):
            assert_one_bf16_step(ds, ref)
        return
    # the two terms of ds, in f64 from the same bf16 sum
    sd = _np(_bt(x) + _bt(r)).astype(np.float64)
    mean = sd.mean(-1, keepdims=True)
    z = (sd * sd).mean(-1, keepdims=True) - mean * mean
    rinv = 1 / np.sqrt(np.maximum(z, 0) + 1e-12)
    gd = _np(_bt(dy)).astype(np.float64)
    dxc = gd * rinv * w
    dz = np.where(z > 0, (gd * (sd - mean) * w).sum(-1, keepdims=True) * -0.5 * rinv ** 3, 0)
    stats = (-dxc.sum(-1, keepdims=True) - 2 * mean * dz) / N + dz / N * 2 * sd
    for ref in (gx, gr):
        got, ref = _np(ds), _np(ref)
        assert got.shape == ref.shape and np.isfinite(got).all()
        off = np.abs(got - ref) > STEP_RTOL * np.abs(ref) + 2 ** -16 * np.abs(ref).max()
        assert off.mean() <= 1e-3, off.sum()
        slack = STEP_RTOL * (np.abs(ref) + np.abs(dxc) + np.abs(stats))
        np.testing.assert_array_less(np.abs(got - ref)[off], slack[off])


def test_gelu_backward_twin_matches_jax_vjp():
    """jax.nn.gelu of the bf16 product plus the bias, as nn.Dense adds it
    (bert.py:170-171)."""
    rng = np.random.default_rng(7)
    y, dout = (rng.normal(size=(2, 20, 128)).astype(np.float32) for _ in range(2))
    bias = (0.5 * rng.normal(size=128)).astype(np.float32)

    _, vjp = jax.vjp(lambda y, b: jax.nn.gelu(y + b.astype(BF)), jnp.asarray(y, BF),
                     jnp.asarray(bias))
    gy, _ = vjp(jnp.asarray(dout, BF))
    dy, db = E.bias_gelu_backward_plain(_bt(y), _bt(bias), _bt(dout))
    assert dy.dtype == db.dtype == torch.bfloat16
    assert_one_bf16_step(dy, gy)
    exact = _np(gy).reshape(-1, 128).astype(np.float64).sum(0)
    assert_one_bf16_step(db, exact)


@pytest.mark.parametrize("M,N", [(40, 1000), (12, 3072), (0, 1536)])
def test_gelu_backward_matches_jax_vjp_at_the_kernels_widths(M, N):
    """K14c's dispatcher on CPU tensors (its twin) against jax.vjp at the
    widths its card tests take besides MiniLM's: 1,000 (the kernel's
    single-element path), 3,072 (BERT-base's FFN) and no rows at all (no
    launch on a card; db zeros, as jax's)."""
    rng = np.random.default_rng(M + N)
    y, dout = (rng.normal(0, 2, size=(M, N)).astype(np.float32) for _ in range(2))
    bias = (0.5 * rng.normal(size=N)).astype(np.float32)

    _, vjp = jax.vjp(lambda y, b: jax.nn.gelu(y + b.astype(BF)), jnp.asarray(y, BF),
                     jnp.asarray(bias))
    gy, _ = vjp(jnp.asarray(dout, BF))
    dy, db = E.bias_gelu_backward(_bt(y), _bt(bias), _bt(dout))
    assert dy.dtype == db.dtype == torch.bfloat16 and db.shape == (N,)
    exact = _np(gy).astype(np.float64).sum(0)
    if M == 0:
        assert dy.shape == (0, N) and not db.any() and not exact.any()
        return
    assert_one_bf16_step(dy, gy)
    assert_one_bf16_step(db, exact)


@pytest.mark.parametrize("head", ["pair", "distill", "info_nce"])
@pytest.mark.parametrize("B", [1, 65, 256])
def test_loss_heads_match_jax_at_the_card_tests_batches(B, head):
    """K15c's twins (what the card's kernels are held to) against
    jax.value_and_grad of the reference heads at one pair or row, at 65
    (past the kernels' 32 warps) and at 256: ranking_loss
    (parallel/train.py:26), its distilled form at alpha 2 (:92-99), optax's
    InfoNCE mean (train_encoders.py:249-251)."""
    from stract_tpu_torch.ops import losses as LO

    rng = np.random.default_rng(B)
    if head == "info_nce":
        logits = (20.0 * rng.normal(0, 0.3, (B, B))).astype(np.float32)
        loss_j, g_j = jax.value_and_grad(
            lambda lg: optax.softmax_cross_entropy_with_integer_labels(
                lg, jnp.arange(B)).mean())(jnp.asarray(logits))
        loss_t, g_t = LO.info_nce_forward(torch.from_numpy(logits))
        grads = [(g_t, g_j)]
    else:
        sp, sn, tp, tn = (rng.normal(0, 3, B).astype(np.float32) for _ in range(4))

        def ref(a, b):
            loss = JPT.ranking_loss(a, b)
            if head == "distill":
                loss = loss + 2.0 * (jnp.mean((a - tp) ** 2) + jnp.mean((b - tn) ** 2))
            return loss

        loss_j, (ga, gb) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(sp),
                                                                    jnp.asarray(sn))
        targets = (torch.from_numpy(tp), torch.from_numpy(tn), 2.0) if head == "distill" else ()
        loss_t, da, db = LO.pair_loss_forward(torch.from_numpy(sp), torch.from_numpy(sn),
                                              *targets)
        grads = [(da, ga), (db, gb)]
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for got, want in grads:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-7 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("normalize", [True, False])
def test_pool_backward_twin_matches_jax_vjp(normalize):
    """The masked mean (+ L2 norm) of bert.py:222-226 / :243-245."""
    rng = np.random.default_rng(8)
    h = rng.normal(size=(4, 10, 64)).astype(np.float32)
    g = rng.normal(size=(4, 64)).astype(np.float32)
    mask = np.ones((4, 10), np.int32)
    mask[1, 5:] = 0
    mask[2, 2:] = 0

    def body(h):
        m = jnp.asarray(mask)[:, :, None].astype(h.dtype)
        pooled = ((h * m).sum(axis=1) / jnp.maximum(m.sum(axis=1), 1.0)).astype(jnp.float32)
        if normalize:
            pooled = pooled / jnp.maximum(jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)
        return pooled

    ref_out, vjp = jax.vjp(body, jnp.asarray(h, BF))
    (gh,) = vjp(jnp.asarray(g))
    m = torch.from_numpy(mask)
    pooled, raw = E.mean_pool_forward(_bt(h), m, normalize)
    assert_one_bf16_step(pooled, ref_out)
    dh = E.mean_pool_backward_plain(m, raw, torch.from_numpy(g), normalize, torch.bfloat16)
    assert dh.dtype == torch.bfloat16
    assert_one_bf16_step(dh, gh)
    assert not _np(dh)[1, 5:].any()


@pytest.mark.parametrize("op", ["attention", "add_layernorm", "bias_gelu", "mean_pool"])
def test_autograd_functions_pass_gradcheck_in_f64(op):
    """In f64 the twins round nowhere: each Function's backward twin against
    finite differences of its forward twin."""
    g = torch.Generator().manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=g, dtype=torch.float64, requires_grad=True)  # noqa
    if op == "attention":
        mask = torch.tensor([[1, 1, 1, 1, 1], [1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], dtype=torch.int32)
        args = (rnd(3, 5, 2, 4), rnd(3, 5, 2, 4), rnd(3, 5, 2, 4))
        fn = lambda q, k, v: E.attention(q, k, v, mask)  # noqa: E731
    elif op == "add_layernorm":
        args = (rnd(6, 8), rnd(6, 8), rnd(8), rnd(8))
        fn = lambda x, r, w, b: E.add_layernorm(x, r, w, b, 1e-12)  # noqa: E731
    elif op == "bias_gelu":
        args = (rnd(6, 8), rnd(8))
        fn = E.bias_gelu
    else:
        mask = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.int32)
        args = (rnd(2, 4, 6),)
        fn = lambda h: torch.cat([E.mean_pool(h, mask, True), E.mean_pool(h, mask)])  # noqa
    assert torch.autograd.gradcheck(fn, args)


def test_adamw_twin_matches_optax():
    """Five steps on the same gradients, from the same parameters."""
    rng = np.random.default_rng(10)
    shapes = {"w": (6, 4), "b": (4,), "scale": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i for k, s in shapes.items()}
             for i in range(5)]
    opt = optax.adamw(3e-4)
    jp, state = params, opt.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    adam = AdamW(tp.values(), 3e-4)
    for gr in grads:
        upd, state = opt.update(gr, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad.copy_(torch.from_numpy(gr[k]))
        adam.step()
    mu, nu = state[0].mu, state[0].nu
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(adam.m.numpy(), np.concatenate([np.asarray(mu[k]).ravel()
                                                               for k in tp]), rtol=1e-6)
    np.testing.assert_allclose(adam.v.numpy(), np.concatenate([np.asarray(nu[k]).ravel()
                                                               for k in tp]), rtol=1e-6)


# ---- train steps -------------------------------------------------------------------------
TEXTS = ["quick brown fox", "the lazy dog sleeps", "fox jumps over the dog", "brown dogs",
         "a quick note", "lazy afternoon in the park", "over and over", "jumps"]
def _batch(kind: str, seed: int = 0, B: int = 8, T: int = 16):
    """Token arrays of one batch (numpy) for each loss: unrelated random
    texts on the two sides of each pair."""
    rng = np.random.default_rng(seed)
    words = " ".join(TEXTS).split()
    text = lambda lo, hi: " ".join(rng.choice(words, size=int(rng.integers(lo, hi))))  # noqa
    tok = JW.WordPieceTokenizer.build(TEXTS * 3, vocab_size=JB.BertConfig.tiny().vocab_size)
    if kind == "info_nce":
        q_ids, q_mask, _ = tok.encode_batch([text(1, 4) for _ in range(B)], T)
        d_ids, d_mask, _ = tok.encode_batch([text(2, 12) for _ in range(B)], T)
        return {"q_ids": q_ids, "q_mask": q_mask, "d_ids": d_ids, "d_mask": d_mask}
    p = tok.encode_batch([(text(1, 4), text(2, 12)) for _ in range(B)], T)
    n = tok.encode_batch([(text(1, 4), text(1, 6)) for _ in range(B)], T)
    out = dict(zip(("pos_ids", "pos_mask", "pos_types", "neg_ids", "neg_mask", "neg_types"),
                   (*p, *n)))
    if kind == "distill":
        out["t_pos"] = rng.normal(3.0, 1.0, size=B).astype(np.float32)
        out["t_neg"] = rng.normal(1.0, 1.0, size=B).astype(np.float32)
    return out


def _jax_module(kind: str, **cfg):
    c = JB.BertConfig.tiny(**cfg)
    return JB.BertForEmbedding(c) if kind == "info_nce" else JB.BertForSequenceScore(c)


def _models(kind: str):
    """The JAX module, its params (numpy f32), and the port's training-form
    model holding the same values."""
    jm = _jax_module(kind)
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = nn.meta.unbox(jm.init(jax.random.PRNGKey(12), dummy, jnp.ones((1, 8), jnp.int32)))
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = TB.BertConfig.tiny()
    tm = (TB.BertForEmbedding(cfg, param_dtype=torch.float32) if kind == "info_nce"
          else TB.BertForSequenceScore(cfg, param_dtype=torch.float32))
    tm.load_state_dict(TB.params_from_jax(params))
    return jm, params, tm


def _jax_grad(kind: str, jm):
    """jit(value_and_grad) of the reference loss: fn(params, batch)."""
    if kind == "info_nce":  # train_encoders.py:246-251
        def loss_fn(p, b):
            qe = jm.apply(p, b["q_ids"], b["q_mask"])
            de = jm.apply(p, b["d_ids"], b["d_mask"])
            logits = (qe @ de.T) * 20.0
            labels = jnp.arange(logits.shape[0])
            return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
        return jax.jit(jax.value_and_grad(loss_fn))

    def loss_fn(p, b):  # parallel/train.py:57-65, and :93-99 for the distilled step
        s_pos = jm.apply(p, b["pos_ids"], b["pos_mask"], b["pos_types"])
        s_neg = jm.apply(p, b["neg_ids"], b["neg_mask"], b["neg_types"])
        loss = JPT.ranking_loss(s_pos, s_neg)
        if kind == "distill":
            loss = loss + 2.0 * (jnp.mean((s_pos - b["t_pos"]) ** 2)
                                 + jnp.mean((s_neg - b["t_neg"]) ** 2))
        return loss
    return jax.jit(jax.value_and_grad(loss_fn))


def _port_loss(kind: str):
    if kind == "info_nce":
        return TPT.info_nce_loss, {"temperature": 20.0}
    if kind == "distill":
        return TPT.distill_loss, {"alpha": 2.0}
    return TPT.pairwise_loss, {}


def _cos(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm()))


KINDS = ["info_nce", "pairwise", "distill"]


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_loss_and_gradients_match_jax(kind):
    """Each leaf whose gradient the reference determines (its bf16 gradient
    at cosine >= 0.999 to the same model's computed in f32) agrees with the
    port's at cosine >= 0.999. A leaf the loss hardly sees (the attention
    key biases: softmax ignores a per-row shift; most leaves of the pairwise
    loss at init, where every pair's two [CLS] states nearly coincide and
    s+ - s- cancels) holds rounding noise in the reference: there the port's
    gradient is held to be as close to the f32 gradient as the reference's
    (within twice its distance)."""
    batch = _batch(kind)
    jm, params, tm = _models(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = _jax_grad(kind, jm)(params, jb)
    _, grads_f32 = _jax_grad(kind, _jax_module(kind, dtype=jnp.float32))(params, jb)
    fn, kw = _port_loss(kind)
    loss_t = fn(tm, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    ref, exact = (TB.params_from_jax(jax.tree_util.tree_map(np.asarray, g))
                  for g in (grads_j, grads_f32))
    got = dict(tm.named_parameters())
    assert set(ref) == set(got)
    determined = 0
    for name, r in ref.items():
        g = got[name].grad
        assert g.dtype == torch.float32
        if not r.any():
            assert not g.any(), name
        elif _cos(r, exact[name]) >= GRAD_COS:
            determined += 1
            assert _cos(g, r) >= GRAD_COS, name
        else:
            x = exact[name].double()
            assert (g.double() - x).norm() <= 2 * (r.double() - x).norm(), name
    assert determined >= (8 if kind == "pairwise" else 0.85 * len(ref))


@pytest.mark.parametrize("kind", KINDS)
def test_loss_curves_match_jax_over_ten_steps(kind):
    """The same 10 batches, the same start, AdamW at lr 1e-3 in both."""
    jm, params, tm = _models(kind)
    grad_fn = _jax_grad(kind, jm)
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    adam = AdamW(tm.parameters(), 1e-3)
    fn, kw = _port_loss(kind)
    for i in range(10):
        batch = _batch(kind, seed=i)
        loss_j, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        loss_t = TPT.train_step(tm, adam, {k: torch.from_numpy(v) for k, v in batch.items()},
                                fn, **kw)
        assert abs(float(loss_t) - float(loss_j)) <= CURVE_RTOL * abs(float(loss_j))


# ---- the entry points --------------------------------------------------------------------
def test_synthesize_triples_match_jax(corpus_index):
    for n, seed in ((40, 0), (24, 98)):
        assert TT.synthesize_triples(corpus_index.path, n, seed=seed) == \
            JT.synthesize_triples(corpus_index, n, seed=seed)


def _heldout_acc(enc, held) -> float:
    qs, ps, ns = (enc.embed([t[i] for t in held]) for i in range(3))
    return float(((qs * ps).sum(1) > (qs * ns).sum(1)).mean())


@pytest.fixture(scope="module")
def trained_dual(corpus_index, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dual"))
    losses = TT.train_dual_encoder(corpus_index.path, out, steps=80, batch=16, max_len=32,
                                   n_triples=256, seed=1, lr=1e-3, log=lambda m: None,
                                   device="cpu")
    return out, losses


def test_train_dual_encoder_learns_and_loads_in_jax(corpus_index, trained_dual):
    from stract_tpu.models.dual_encoder import DualEncoder as JaxDual

    out, losses = trained_dual
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss did not decrease"
    port = DualEncoder.load(out, device="cpu")
    held = TT.synthesize_triples(corpus_index.path, 24, seed=98)
    assert _heldout_acc(port, held) > 0.6
    # the checkpoint holds the f32 masters, not bf16-rounded weights
    with open(os.path.join(out, "params.msgpack"), "rb") as fh:
        tree = TS.read_flax_msgpack(fh.read())
    word = tree["params"]["bert"]["word_embeddings"]["embedding"]
    assert word.dtype == np.float32
    assert (torch.from_numpy(word).to(torch.bfloat16).float().numpy() != word).any()
    texts = [t[1] for t in held] + [t[0] for t in held]
    ej, ep = JaxDual.load(out).embed(texts), port.embed(texts)
    assert ((ej * ep).sum(1)).min() >= 0.9999


def test_train_cross_encoder_warm_started_and_distilled(corpus_index, trained_dual,
                                                        tmp_path):
    """The bench recipe: the dual trunk's f32 masters seed the cross encoder,
    the dual teacher's scaled cosines are distilled; the checkpoint scores
    alike in both packages."""
    from stract_tpu.ranking.models.cross_encoder import CrossEncoderModel as JaxCross
    from stract_tpu_torch.ranking.models.cross_encoder import CrossEncoderModel

    dual, _ = trained_dual
    out = str(tmp_path / "cross")
    timing = {}
    losses = TT.train_cross_encoder(corpus_index.path, out, steps=20, batch=8, max_len=32,
                                    n_triples=64, seed=1, lr=1e-3, warm_start=dual,
                                    distill=True, distill_alpha=2.0, log=lambda m: None,
                                    timing=timing, device="cpu")
    assert len(losses) == 20 and np.isfinite(losses).all() and timing["steps"] == 20
    # the trunk came from the dual checkpoint: same vocab, embeddings moved from it
    assert CrossEncoderModel.load(out, device="cpu").tokenizer.vocab == \
        DualEncoder.load(dual, device="cpu").tokenizer.vocab
    held = TT.synthesize_triples(corpus_index.path, 24, seed=98)
    pairs = [(q, p) for q, p, _ in held]
    np.testing.assert_allclose(CrossEncoderModel.load(out, device="cpu").score_pairs(pairs),
                               JaxCross.load(out).score_pairs(pairs), atol=1e-2)
    with pytest.raises(ValueError):
        TT.train_cross_encoder(corpus_index.path, str(tmp_path / "x"), steps=1, batch=4,
                               max_len=16, n_triples=16, distill=True, log=lambda m: None,
                               device="cpu")


def test_main_train_encoders(corpus_index, tmp_path):
    from stract_tpu_torch.main import main

    main(["train-encoders", "both", corpus_index.path, str(tmp_path), "--steps", "2",
          "--batch", "4", "--triples", "16", "--device", "cpu"])
    for kind in ("dual", "cross"):
        with open(tmp_path / f"{kind}_encoder" / "config.json") as fh:
            assert json.load(fh)["kind"] == kind
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["train-encoders", "dual", corpus_index.path, str(tmp_path / "c"),
                  "--steps", "1", "--device", "cuda"])


def test_train_bench_encoders_runs_the_tool_recipe(corpus_index, tmp_path):
    """The port of tools/train_bench_encoders.py end to end at a toy size:
    MiniLM-L6 dual then a warm-started, distilled, mean-read cross encoder,
    both saved, reloaded and evaluated; the reference tool's summary keys."""
    from stract_tpu_torch.entrypoint import train_bench_encoders as TBE

    args = TBE.parser().parse_args([
        "--docs", "120", "--steps", "2", "--batch", "2", "--train-len", "16",
        "--n-triples", "16", "--vocab", "300", "--distill-cross", "--cross-pool", "mean",
        "--device", "cpu"])
    summary, timing = TBE.run(args, corpus_index.path, str(tmp_path), log=lambda m: None)
    assert set(summary) == {
        "shape", "dual_max_len", "cross_max_len", "steps", "n_triples", "cross_steps",
        "cross_triples", "dual_loss", "cross_loss", "dual_heldout_acc", "cross_heldout_acc",
        "cross_vs_teacher_spearman", "cross_pool", "seconds"}
    assert summary["shape"] == "bert-L6-H384-A12-V300" and summary["cross_pool"] == "mean"
    assert 0.0 <= summary["dual_heldout_acc"] <= 1.0 and np.isfinite(summary["cross_loss"]).all()
    assert timing["dual"]["steps"] == timing["cross"]["steps"] == 2
    for kind in ("dual", "cross"):
        with open(tmp_path / f"{kind}_encoder-120" / "config.json") as fh:
            meta = json.load(fh)
        assert meta["kind"] == kind and meta["max_len"] == (256 if kind == "dual" else 128)
