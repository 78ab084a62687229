"""The MoE FFN's router and its select-and-scale (K15a-b), the port of
stract_tpu/models/bert.py:108-153 MoEMlp as its non-TPU branch computes it
(what the JAX package runs on the CPU; its TPU branch differs only in the
order of the f32 sums):

    logits = x.f32 @ Wr + br              f32 [N, E]
    probs  = softmax(logits)              f32
    top    = argmax(probs)                ties to the first expert
    gate   = bf16(probs[top])
    h      = gelu_tanh(bf16(x . W_in[e]))  every expert on every token (dense
    out_e  = bf16(h . W_out[e])            dispatch), f32 sums, bf16 results
    out    = bf16(out_e[top] * gate)      the one-hot combine is exact

  K15a  router            logits, softmax, argmax and gate in one pass, and its
        (+ backward)      whole VJP in one call (the gate's cotangent through
                          the softmax to x, to the router's weight and to its
                          bias): CUDA C++, csrc/moe.cu
  K15b  select_scale      out_e[top] * gate, and its backward (the cotangent of
        (+ backward)      the selected expert's rows, zero for the others, and
                          the gate's, an f32 row sum): CUDA C++, csrc/moe.cu

The expert products stay batched bf16 products on cuBLAS (the JAX package
leaves them to XLA as plain dots), and the GELU is K5c / K14c
(ops/encoder.py bias_gelu, with a zero bias). `router` and `select_scale`
are torch.autograd.Functions; their forward and backward each pick by where
the input lies: a CPU tensor takes the plain twin, a CUDA tensor launches
the kernel or raises (the `*_forward` / `*_backward` dispatchers).

Gradients follow jax.vjp of the reference: the softmax VJP is the transpose
of jax.nn.softmax's jvp, y * (t - sum(y * t)); every cotangent of a bf16
value is rounded to bf16; the gate's cotangent is the f32 sum over the row
of out_sel * g (exact products of bf16 values), rounded to bf16.
"""

from __future__ import annotations

import torch

from . import kernels

BF16 = torch.bfloat16


# ---- K15a: the router ------------------------------------------------------------------
def router_plain(x, w, b):
    """x bf16[N, H], w f32[E, H], b f32[E] → (probs f32[N, E], top i32[N],
    gate bf16[N])."""
    logits = x.float() @ w.t() + b
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = ex / ex.sum(dim=-1, keepdim=True)
    top = torch.argmax(probs, dim=-1)  # the first of equal maxima, as jnp.argmax
    gate = probs.gather(1, top[:, None])[:, 0].to(BF16)
    return probs, top.to(torch.int32), gate


def router_backward_plain(x, probs, top, dgate, w):
    """The VJP of the gate through the router: dgate bf16[N] → (dx bf16[N,
    H], dw f32[E, H], db f32[E]), through the logits' cotangent dl f32[N,
    E]."""
    dw = torch.zeros_like(probs).scatter_(1, top.long()[:, None],
                                          probs.gather(1, top.long()[:, None])
                                          * dgate.float()[:, None])
    dl = dw + probs * (-dw.sum(dim=-1, keepdim=True))
    return (dl @ w).to(BF16), dl.t() @ x.float(), dl.sum(dim=0)


def router_forward(x, w, b):
    if not x.is_cuda:
        return router_plain(x, w, b)
    N, H = x.shape
    E = w.shape[0]
    probs = torch.empty((N, E), dtype=torch.float32, device=x.device)
    top = torch.empty(N, dtype=torch.int32, device=x.device)
    gate = torch.empty(N, dtype=BF16, device=x.device)
    kernels.moe_router(x, w, b, probs, top, gate)
    return probs, top, gate


def router_backward(x, probs, top, dgate, w):
    if not probs.is_cuda:
        return router_backward_plain(x, probs, top, dgate, w)
    return kernels.moe_router_backward(x, probs, top, dgate.contiguous(), w)


class _Router(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        probs, top, gate = router_forward(x, w, b)
        ctx.save_for_backward(x, w, probs, top)
        ctx.mark_non_differentiable(top)
        ctx.set_materialize_grads(False)  # no zeros made (a launch) for top's cotangent
        return top, gate

    @staticmethod
    def backward(ctx, _dtop, dgate):
        if dgate is None:
            return None, None, None
        x, w, probs, top = ctx.saved_tensors
        return router_backward(x, probs, top, dgate, w)


def router(x, w, b):
    """The top-1 router: x bf16[N, H], w f32[E, H], b f32[E] (contiguous on
    the card) → (top i32[N], gate bf16[N]), differentiable in x, w and b
    through the gate."""
    return _Router.apply(x, w, b)


# ---- K15b: select and scale ----------------------------------------------------------------
def select_scale_plain(out_e, top, gate):
    """out_e bf16[E, N, H], top i32[N], gate bf16[N] → bf16[N, H]: each
    token's row of its expert, times its gate."""
    n = torch.arange(out_e.shape[1], device=out_e.device)
    return out_e[top.long(), n] * gate[:, None]


def select_scale_backward_plain(out_e, top, gate, g):
    """The VJP of select_scale_plain: g bf16[N, H] → (d out_e bf16[E, N, H],
    d gate bf16[N])."""
    n = torch.arange(out_e.shape[1], device=out_e.device)
    sel = out_e[top.long(), n]
    d_out = torch.zeros_like(out_e)
    d_out[top.long(), n] = g * gate[:, None]
    return d_out, (sel.float() * g.float()).sum(dim=-1).to(BF16)


def select_scale_forward(out_e, top, gate):
    if not out_e.is_cuda:
        return select_scale_plain(out_e, top, gate)
    return kernels.moe_select(out_e, top, gate)


def select_scale_backward(out_e, top, gate, g):
    if not out_e.is_cuda:
        return select_scale_backward_plain(out_e, top, gate, g)
    return kernels.moe_select_backward(out_e, top, gate, g.contiguous())


class _SelectScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out_e, top, gate):
        ctx.save_for_backward(out_e, top, gate)
        return select_scale_forward(out_e, top, gate)

    @staticmethod
    def backward(ctx, g):
        out_e, top, gate = ctx.saved_tensors
        d_out, d_gate = select_scale_backward(out_e, top, gate, g)
        return d_out, None, d_gate


def select_scale(out_e, top, gate):
    """bf16(out_e[top[n], n] * gate[n]) → bf16[N, H], differentiable in
    out_e and gate."""
    return _SelectScale.apply(out_e, top, gate)
