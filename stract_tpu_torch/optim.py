"""AdamW as the JAX package's trainers run it (`optax.adamw(lr)` at
stract_tpu/entrypoint/train_encoders.py:241 and parallel/train.py:36), with
optax's defaults: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction,
and decoupled weight decay 1e-4 on every leaf (no mask: biases and
LayerNorm scales decay too). Per element, at step t (counting from 1):

    m = (1 - b1) g + b1 m          v = (1 - b2) g^2 + b2 v
    u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
    p = p + (-lr) u

in f32, in optax's order of operations. The update is K14d, one fused
elementwise pass over every parameter, moment and gradient (Triton on a
card, `adamw_update_plain` on the CPU). It is bound by device memory: 16 B
read and 12 B written per parameter, 632 MB a step for MiniLM-L6 with a
30,522-piece vocab (22.6M parameters); one pass instead of optax's chain of
tree maps is the whole design.

The optimizer keeps the parameters, their gradients and both moments in
four flat f32 buffers: each parameter's data and .grad become views into
them, autograd accumulates into the gradient views in place, and the
kernel updates the flat buffers in place (the JAX package returns new
trees instead).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels

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
        _triton_kernel()[(-(-n // BLOCK),)](p, g, m, v, n, lr, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                                           wd, bc1, bc2, BLOCK=BLOCK, num_warps=4)
        kernels.counted("adamw")


class AdamW:
    """optax.adamw(lr) over `params` (f32 tensors on one device)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params = list(params)
        if not self.params:
            raise ValueError("AdamW needs parameters")
        dev = self.params[0].device
        if any(p.dtype != torch.float32 or p.device != dev for p in self.params):
            raise ValueError("AdamW takes f32 master parameters on one device")
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, weight_decay
        n = sum(p.numel() for p in self.params)
        self.flat = torch.empty(n, dtype=torch.float32, device=dev)
        self.grad = torch.zeros_like(self.flat)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.count = 0
        off = 0
        with torch.no_grad():
            for p in self.params:
                k = p.numel()
                self.flat[off:off + k].copy_(p.reshape(-1))
                p.data = self.flat[off:off + k].view_as(p)
                p.grad = self.grad[off:off + k].view_as(p)
                off += k

    def zero_grad(self) -> None:
        self.grad.zero_()

    def step(self) -> None:
        """Apply one update from the accumulated gradients."""
        for p in self.params:
            if p.grad is None or p.grad.untyped_storage().data_ptr() != \
                    self.grad.untyped_storage().data_ptr():
                raise RuntimeError("a parameter's gradient no longer lies in the optimizer's "
                                   "flat buffer (zero gradients with AdamW.zero_grad)")
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        adamw_update(self.flat, self.grad, self.m, self.v, self.lr, self.b1, self.b2, self.eps,
                     self.wd, bc1, bc2)


def _triton_kernel():
    """K14d, defined (and triton imported) at first use."""
    if _TRITON:
        return _TRITON["adamw"]
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

    _TRITON["adamw"] = adamw_kernel
    return adamw_kernel
