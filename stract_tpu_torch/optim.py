"""AdamW as the JAX package's trainers run it (`optax.adamw(lr)` at
stract_tpu/entrypoint/train_encoders.py:241 and parallel/train.py:36), with
optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction,
and decoupled weight decay 1e-4 on every leaf (no mask: biases and
LayerNorm scales decay too). Per element, at step t (counting from 1):

    m = (1 - b1) g + b1 m          v = (1 - b2) g^2 + b2 v
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
    p = p + (-lr) u

in the parameter's dtype, in optax's order of operations. For f32 masters
the update is K14d, one fused elementwise pass over every parameter, moment
and gradient. It is bound by device memory: 16 B read and 12 B written per
parameter, 632 MB a step for MiniLM-L6 with a 30,522-piece vocab (22.6M
parameters); one pass instead of optax's chain of tree maps is the whole
design.

bf16 parameters (the MoE experts, which the JAX package creates in bf16)
keep bf16 moments, as optax.adamw gives them (its moments take the
parameter's dtype), and every step of the update is a bf16 operation: each
Python constant is rounded to bf16 first (JAX's weak typing), each product,
sum, quotient and square root rounds to bf16, the bias corrections are
computed in f32 and rounded to bf16, and the new parameter is bf16(p + u)
(optax.apply_updates). That is K15d, the same fused pass over bf16 buffers,
each step rounded on its bits (8 B read, 6 B written per parameter).

The optimizer keeps each dtype's parameters, gradients and both moments in
four flat buffers of that dtype: each parameter's data and .grad become
views into them, autograd accumulates into the gradient views in place, and
the kernels update the flat buffers in place (the JAX package returns new
trees instead).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels

BF16 = torch.bfloat16
_TRITON: dict = {}
BLOCK = 1024


def adamw_update_plain(p, g, m, v, lr: float, b1: float, b2: float, eps: float, wd: float,
                       bc1: float, bc2: float) -> None:
    """One AdamW step in place on flat f32 tensors; bc1 = 1 - b1^t and
    bc2 = 1 - b2^t are the bias corrections of step t."""
    m.mul_(b1).add_((1.0 - b1) * g)
    v.mul_(b2).add_((1.0 - b2) * (g * g))
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
    p.add_((-lr) * u)


def adamw_update(p, g, m, v, lr: float, b1: float, b2: float, eps: float, wd: float,
                 bc1: float, bc2: float) -> None:
    if not p.is_cuda:
        return adamw_update_plain(p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2)
    n = p.numel()
    for t in (p, g, m, v):
        kernels._ptr(t, torch.float32, (n,))
    if n:
        with torch.cuda.device(kernels.card_of(p, g, m, v)):
            _triton_kernel()[(-(-n // BLOCK),)](p, g, m, v, n, lr, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                                               wd, bc1, bc2, BLOCK=BLOCK, num_warps=4)
        kernels.counted("adamw")


def _bf16(x: float) -> float:
    """A Python constant as the bf16 value JAX's weak typing makes of it."""
    return float(torch.tensor(x, dtype=BF16))


def adamw_bf16_update_plain(p, g, m, v, lr: float, b1: float, b2: float, eps: float, wd: float,
                            bc1: float, bc2: float) -> None:
    """One AdamW step in place on flat bf16 tensors, every operation a bf16
    one (torch rounds each bf16 op's result once; the constants are bf16
    tensors); bc1 and bc2 are the f32 bias corrections of the step."""
    c = lambda x: torch.tensor(x, dtype=BF16, device=p.device)  # noqa: E731
    m.copy_(c(1.0 - b1) * g + c(b1) * m)
    v.copy_(c(1.0 - b2) * (g * g) + c(b2) * v)
    u = (m / c(bc1)) / (torch.sqrt(v / c(bc2)) + c(eps))
    u = u + c(wd) * p
    p.copy_(p + c(-lr) * u)


def adamw_bf16_update(p, g, m, v, lr: float, b1: float, b2: float, eps: float, wd: float,
                      bc1: float, bc2: float) -> None:
    if not p.is_cuda:
        return adamw_bf16_update_plain(p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2)
    n = p.numel()
    for t in (p, g, m, v):
        kernels._ptr(t, BF16, (n,))
    if n:
        consts = [_bf16(x) for x in (-lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, bc1, bc2)]
        with torch.cuda.device(kernels.card_of(p, g, m, v)):
            _triton_kernels()["adamw_bf16"][(-(-n // BLOCK),)](p, g, m, v, n, *consts, BLOCK=BLOCK,
                                                               num_warps=4)
        kernels.counted("adamw_bf16")


class _Group:
    """One dtype's parameters in four flat buffers of that dtype."""

    def __init__(self, params: list, dtype: torch.dtype, dev):
        self.params = params
        n = sum(p.numel() for p in params)
        self.flat = torch.empty(n, dtype=dtype, device=dev)
        self.grad = torch.zeros_like(self.flat)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        off = 0
        with torch.no_grad():
            for p in params:
                k = p.numel()
                self.flat[off:off + k].copy_(p.reshape(-1))
                p.data = self.flat[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
                off += k


class AdamW:
    """optax.adamw(lr) over `params` on one device: f32 masters and bf16
    parameters, each in their own dtype's buffers."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params = list(params)
        if not self.params:
            raise ValueError("AdamW needs parameters")
        dev = self.params[0].device
        if any(p.dtype not in (torch.float32, BF16) or p.device != dev for p in self.params):
            raise ValueError("AdamW takes f32 or bf16 parameters on one device")
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        self.groups = {dt: _Group([p for p in self.params if p.dtype == dt], dt, dev)
                       for dt in (torch.float32, BF16)
                       if any(p.dtype == dt for p in self.params)}
        self.count = 0

    # the f32 group's buffers (the whole state of a model without bf16 parameters)
    flat = property(lambda self: self.groups[torch.float32].flat)
    grad = property(lambda self: self.groups[torch.float32].grad)
    m = property(lambda self: self.groups[torch.float32].m)
    v = property(lambda self: self.groups[torch.float32].v)

    def zero_grad(self) -> None:
        for grp in self.groups.values():
            grp.grad.zero_()

    def step(self) -> None:
        """Apply one update from the accumulated gradients."""
        for grp in self.groups.values():
            for p in grp.params:
                if p.grad is None or p.grad.untyped_storage().data_ptr() != \
                        grp.grad.untyped_storage().data_ptr():
                    raise RuntimeError("a parameter's gradient no longer lies in the "
                                       "optimizer's flat buffer (zero gradients with "
                                       "AdamW.zero_grad)")
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for dt, grp in self.groups.items():
            update = adamw_update if dt == torch.float32 else adamw_bf16_update
            update(grp.flat, grp.grad, grp.m, grp.v, self.lr, self.b1, self.b2, self.eps,
                   self.wd, bc1, bc2)


def _triton_kernel():
    """K14d."""
    return _triton_kernels()["adamw"]


def _triton_kernels() -> dict:
    """K14d ("adamw") and K15d ("adamw_bf16"), defined (and triton imported)
    at first use."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_kernel(P, G, M, V, n, lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd, bc1, bc2,
                     BLOCK: tl.constexpr):
        # a flat pass over BLOCK parameters: both moments, the bias-corrected
        # step, decoupled decay, and the parameter, all in f32, in place
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        p = tl.load(P + offs, mask=msk, other=0.0)
        g = tl.load(G + offs, mask=msk, other=0.0)
        m = one_minus_b1 * g + b1 * tl.load(M + offs, mask=msk, other=0.0)
        v = one_minus_b2 * (g * g) + b2 * tl.load(V + offs, mask=msk, other=0.0)
        u = (m / bc1) / (tl.sqrt(v / bc2) + eps) + wd * p
        tl.store(M + offs, m, mask=msk)
        tl.store(V + offs, v, mask=msk)
        tl.store(P + offs, p + (-lr) * u, mask=msk)

    @triton.jit
    def _rd(x):
        # round an f32 value to bf16 (to nearest, ties to even) and widen it
        # back, on the bits: Triton drops some f32 -> bf16 -> f32 round trips
        # written as two casts
        u = x.to(tl.uint32, bitcast=True)
        u = u + (((u >> 16) & 1) + 0x7FFF)
        return ((u >> 16) << 16).to(tl.float32, bitcast=True)

    @triton.jit
    def adamw_bf16_kernel(P, G, M, V, n, neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
                          bc1, bc2, BLOCK: tl.constexpr):
        # the same pass over bf16 buffers: the constants arrive bf16-valued,
        # and every operation's result is rounded to bf16 (optax's bf16 ops)
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        msk = offs < n
        p = tl.load(P + offs, mask=msk, other=0.0).to(tl.float32)
        g = tl.load(G + offs, mask=msk, other=0.0).to(tl.float32)
        m = tl.load(M + offs, mask=msk, other=0.0).to(tl.float32)
        v = tl.load(V + offs, mask=msk, other=0.0).to(tl.float32)
        m = _rd(_rd(one_minus_b1 * g) + _rd(b1 * m))
        v = _rd(_rd(one_minus_b2 * _rd(g * g)) + _rd(b2 * v))
        u = _rd(_rd(m / bc1) / _rd(_rd(tl.sqrt(_rd(v / bc2))) + eps))
        u = _rd(u + _rd(wd * p))
        p = _rd(p + _rd(neg_lr * u))
        tl.store(M + offs, m.to(tl.bfloat16), mask=msk)
        tl.store(V + offs, v.to(tl.bfloat16), mask=msk)
        tl.store(P + offs, p.to(tl.bfloat16), mask=msk)

    _TRITON.update(adamw=adamw_kernel, adamw_bf16=adamw_bf16_kernel)
    return _TRITON
