"""The pipeline stage's f32 ops (K16a-d), the port of the body of
stract_tpu/parallel/pipeline.py:42-51 (`_apply_stage`) and :136 (the SGD
update) and of what `jax.value_and_grad` differentiates through them in
`make_pipeline_train_step`. Each piece is a kernel with its plain PyTorch
twin:

  K16a stage attention           softmax(q k^T / f32(sqrt(H))) v over q, k, v,
                                 the three H-wide column blocks of qkv
                                 f32[mb, T, 3H] (one head of width H, no mask,
                                 :46-48): CUDA C++, csrc/stage.cu (3xTF32 on
                                 the tensor cores); any T and H (past
                                 1,024 tokens the keys in chunks)
  K16b  ... backward             dq, dk, dv into the three column blocks of one
                                 dqkv f32[mb, T, 3H]: CUDA C++, csrc/stage.cu
  K16c gelu_tanh, fwd + bwd      jax.nn.gelu(approximate=True) in f32, no bias
                                 (:50): CUDA C++, csrc/stage.cu (a flat pass
                                 each way, 16-byte pieces where aligned)
  K16d sgd_update_many           p - lr * g in place (:136) over all of a
                                 card's parameters in one launch: CUDA C++,
                                 csrc/stage.cu

The autograd Functions StageAttention and GeluTanh call the module-level
dispatchers (`stage_attention_forward` / `_backward`, `gelu_tanh_forward` /
`_backward`) in forward and backward, and `sgd_update_many` is one too: a
CPU tensor takes the plain twin, a CUDA tensor launches the kernel or
raises, on its own card's current stream (the pipeline's stages may sit on
different cards: ops/kernels.py `on_card`).

Numerics follow the reference in f32: the scores are divided by sqrt(H)
rounded to f32 (JAX canonicalises the np.float64 scalar to f32), the
softmax subtracts the row max, exponentiates and divides by the row sum;
the GELU constants are sqrt(2/pi) and 0.044715 in f32, the cube is x*x*x.
The backward twins are the closed-form derivatives (softmax'(g) =
P * (g - rowsum(P * g)), gelu'(x) = cdf + x * 0.5 * (1 - t^2) * c1 *
(1 + 3 c2 x^2)); jax.vjp of the reference rounds in its own order, within
f32 rounding of these. The twins compute in the input's dtype, so float64
inputs round nowhere and torch.autograd.gradcheck can check each backward
against its forward.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels

F32 = torch.float32
# jax.nn.gelu(approximate=True) on an f32 input: its constants in f32
GELU_C1 = float(np.float32(np.sqrt(2 / np.pi)))
GELU_C2 = float(np.float32(0.044715))


def _split_qkv(qkv):
    H = qkv.shape[-1] // 3
    return qkv[..., :H], qkv[..., H:2 * H], qkv[..., 2 * H:]


def _scale(H: int, dtype: torch.dtype) -> float:
    """sqrt(H) as the reference divides by it: rounded to f32 for f32 input
    (kept exact for float64, so gradcheck sees one function)."""
    return float(np.float32(math.sqrt(H))) if dtype == F32 else math.sqrt(H)


# ---- K16a / K16b: single-head attention ---------------------------------------------
def stage_attention_plain(qkv):
    """qkv [mb, T, 3H] → softmax(q k^T / sqrt(H)) v, [mb, T, H]."""
    q, k, v = _split_qkv(qkv)
    scores = torch.einsum("bth,bsh->bts", q, k) / _scale(q.shape[-1], qkv.dtype)
    return torch.einsum("bts,bsh->bth", torch.softmax(scores, dim=-1), v)


def stage_attention_backward_plain(qkv, dout):
    """The VJP of stage_attention_plain: dout [mb, T, H] → dqkv [mb, T, 3H]
    (dq, dk, dv in qkv's column blocks)."""
    q, k, v = _split_qkv(qkv)
    scale = _scale(q.shape[-1], qkv.dtype)
    p = torch.softmax(torch.einsum("bth,bsh->bts", q, k) / scale, dim=-1)
    dv = torch.einsum("bts,bth->bsh", p, dout)
    dp = torch.einsum("bth,bsh->bts", dout, v)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) / scale
    dq = torch.einsum("bts,bsh->bth", ds, k)
    dk = torch.einsum("bts,bth->bsh", ds, q)
    return torch.cat([dq, dk, dv], dim=-1)


def stage_attention_forward(qkv):
    if not qkv.is_cuda:
        return stage_attention_plain(qkv)
    qkv = qkv.contiguous()
    mb, T, H3 = qkv.shape
    out = torch.empty((mb, T, H3 // 3), dtype=F32, device=qkv.device)
    kernels.stage_attention(qkv, out)
    return out


def stage_attention_backward(qkv, dout):
    if not qkv.is_cuda:
        return stage_attention_backward_plain(qkv, dout)
    qkv, dout = qkv.contiguous(), dout.contiguous()
    mb, T, _ = qkv.shape
    probs = torch.empty((mb, T, T), dtype=F32, device=qkv.device)
    dscores = torch.empty_like(probs)
    dqkv = torch.empty_like(qkv)
    kernels.stage_attention_backward(qkv, dout, probs, dscores, dqkv)
    return dqkv


class StageAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        ctx.save_for_backward(qkv)
        return stage_attention_forward(qkv)

    @staticmethod
    def backward(ctx, dout):
        return stage_attention_backward(*ctx.saved_tensors, dout)


def stage_attention(qkv):
    """Single-head attention over qkv [mb, T, 3H], differentiable."""
    return StageAttention.apply(qkv)


# ---- K16c: tanh GELU ------------------------------------------------------------------
def gelu_tanh_plain(x):
    """x * 0.5 * (1 + tanh(c1 * (x + c2 x^3))), jax.nn.gelu(approximate=True)."""
    return x * (0.5 * (1.0 + torch.tanh(GELU_C1 * (x + GELU_C2 * (x * x * x)))))


def gelu_tanh_backward_plain(x, dout):
    """The VJP of gelu_tanh_plain: dout (x's shape) → dx."""
    t = torch.tanh(GELU_C1 * (x + GELU_C2 * (x * x * x)))
    du = GELU_C1 * (1.0 + 3.0 * GELU_C2 * (x * x))
    return dout * (0.5 * (1.0 + t)) + dout * x * (0.5 * (1.0 - t * t)) * du


def gelu_tanh_forward(x):
    if not x.is_cuda:
        return gelu_tanh_plain(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    kernels.gelu_tanh(x, out)
    return out


def gelu_tanh_backward(x, dout):
    if not x.is_cuda:
        return gelu_tanh_backward_plain(x, dout)
    x, dout = x.contiguous(), dout.contiguous()
    dx = torch.empty_like(x)
    kernels.gelu_tanh_backward(x, dout, dx)
    return dx


class GeluTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_tanh_forward(x)

    @staticmethod
    def backward(ctx, dout):
        return gelu_tanh_backward(*ctx.saved_tensors, dout)


def gelu_tanh(x):
    """jax.nn.gelu(x, approximate=True), differentiable."""
    return GeluTanh.apply(x)


# ---- K16d: SGD -------------------------------------------------------------------------
def sgd_update_plain(p, g, lr: float) -> None:
    """p = p - lr * g in place (the product rounded first, as the reference's
    `p - learning_rate * g`)."""
    p.copy_(p - lr * g)


def sgd_update_many_plain(params, grads, lr: float) -> None:
    """sgd_update_plain over each pair in turn."""
    for p, g in zip(params, grads):
        sgd_update_plain(p, g, lr)


def sgd_update_many(params, grads, lr: float) -> None:
    """One SGD step in place on many parameters' data (no autograd): CPU
    pairs take the plain twin, the CUDA ones launch K16d once per card (per
    64 tensors), on that card."""
    by_card: dict = {}
    for p, g in zip(params, grads):
        by_card.setdefault(p.device if p.is_cuda else None, []).append((p, g))
    for dev, pairs in by_card.items():
        ps, gs = [p for p, _ in pairs], [g for _, g in pairs]
        if dev is None:
            sgd_update_many_plain(ps, gs, lr)
        else:
            kernels.sgd_multi(ps, [g.contiguous() for g in gs], lr)

