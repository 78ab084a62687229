"""The training steps' loss heads (K15c), value and gradient in one pass:

  pair_loss   the cross encoder's pairwise logistic loss, the mean of
              softplus(-(s+ - s-)) (stract_tpu/parallel/train.py:26), plus,
              when teacher targets are given, alpha x the two MSEs to them
              (the distilled step, parallel/train.py:98)
  info_nce    the dual encoder's in-batch cross-entropy of the B x B
              similarity logits against the diagonal
              (stract_tpu/entrypoint/train_encoders.py:249-251, optax's
              softmax_cross_entropy_with_integer_labels, mean)

Each reduces a few hundred numbers: one Triton program computes the loss
and the gradient of every input at once (bound by launch latency, not by
bytes or operations), and the backward scales that gradient by the incoming
cotangent. Plain twins beside them compute the same expressions in torch;
a CPU tensor takes the twin, a CUDA tensor launches the kernel. Both follow
the reference's expressions: softplus(x) = max(x, 0) + log1p(exp(-|x|))
(jnp.logaddexp(x, 0)) with gradient exp(x - softplus(x)); the cross entropy
as log(sum(exp(l - max))) - (l_ii - max) with gradient (softmax - onehot) / B.
"""

from __future__ import annotations

import torch

from . import kernels

_TRITON: dict = {}


# ---- plain twins ---------------------------------------------------------------------
def pair_loss_plain(s_pos, s_neg, t_pos=None, t_neg=None, alpha: float = 0.0):
    """→ (loss f32[], d s_pos f32[B], d s_neg f32[B])."""
    B = s_pos.shape[0]
    x = -(s_pos - s_neg)
    sp = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
    sig = torch.exp(x - sp)
    loss = sp.sum() / B
    d_pos, d_neg = -sig / B, sig / B
    if t_pos is not None:
        rp, rn = s_pos - t_pos, s_neg - t_neg
        loss = loss + alpha * ((rp * rp).sum() / B + (rn * rn).sum() / B)
        d_pos = d_pos + alpha * (2.0 * rp / B)
        d_neg = d_neg + alpha * (2.0 * rn / B)
    return loss, d_pos, d_neg


def info_nce_plain(logits):
    """logits f32[B, B] → (loss f32[], d logits f32[B, B])."""
    B = logits.shape[0]
    z = logits - logits.amax(dim=1, keepdim=True)
    ez = torch.exp(z)
    s = ez.sum(dim=1)
    diag = torch.arange(B, device=logits.device)
    loss = (torch.log(s) - z[diag, diag]).sum() / B
    d = ez / s[:, None]
    d[diag, diag] -= 1.0
    return loss, d / B


# ---- dispatchers -----------------------------------------------------------------------
def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def pair_loss_forward(s_pos, s_neg, t_pos=None, t_neg=None, alpha: float = 0.0):
    if not s_pos.is_cuda:
        return pair_loss_plain(s_pos, s_neg, t_pos, t_neg, alpha)
    B = s_pos.shape[0]
    f32 = torch.float32
    ins = [t.contiguous() for t in (s_pos, s_neg)]
    for t in ins:
        kernels._ptr(t, f32, (B,))
    distill = t_pos is not None
    tg = [t.to(f32).contiguous() for t in (t_pos, t_neg)] if distill else ins
    for t in tg:
        kernels._ptr(t, f32, (B,))
    loss = torch.empty((), dtype=f32, device=s_pos.device)
    d_pos, d_neg = torch.empty_like(ins[0]), torch.empty_like(ins[0])
    with torch.cuda.device(kernels.card_of(*ins, *tg, loss, d_pos, d_neg)):
        _triton_kernels()["pair"][(1,)](*ins, *tg, loss, d_pos, d_neg, B, float(alpha),
                                        DISTILL=distill, BLOCK=_next_pow2(B), num_warps=4)
    kernels.counted("loss_heads")
    return loss, d_pos, d_neg


def info_nce_forward(logits):
    if not logits.is_cuda:
        return info_nce_plain(logits)
    B = logits.shape[0]
    logits = logits.contiguous()
    kernels._ptr(logits, torch.float32, (B, B))
    loss = torch.empty((), dtype=torch.float32, device=logits.device)
    d = torch.empty_like(logits)
    with torch.cuda.device(kernels.card_of(logits, loss, d)):
        _triton_kernels()["info_nce"][(1,)](logits, loss, d, B, BLOCK=_next_pow2(B), num_warps=4)
    kernels.counted("loss_heads")
    return loss, d


class _PairLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_pos, s_neg, t_pos, t_neg, alpha):
        loss, d_pos, d_neg = pair_loss_forward(s_pos, s_neg, t_pos, t_neg, alpha)
        ctx.save_for_backward(d_pos, d_neg)
        return loss

    @staticmethod
    def backward(ctx, g):
        d_pos, d_neg = ctx.saved_tensors
        return g * d_pos, g * d_neg, None, None, None


class _InfoNCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits):
        loss, d = info_nce_forward(logits)
        ctx.save_for_backward(d)
        return loss

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return g * d


def pair_loss(s_pos, s_neg, t_pos=None, t_neg=None, alpha: float = 0.0):
    """mean softplus(-(s_pos - s_neg)) [+ alpha (mean (s_pos - t_pos)^2 +
    mean (s_neg - t_neg)^2)] over f32[B] scores, differentiable in the
    scores (the targets are data)."""
    return _PairLoss.apply(s_pos, s_neg, t_pos, t_neg, alpha)


def info_nce(logits):
    """Mean cross-entropy of each row of logits f32[B, B] against its
    diagonal entry, differentiable in the logits."""
    return _InfoNCE.apply(logits)


# ---- the Triton kernels ------------------------------------------------------------------
def _triton_kernels() -> dict:
    """K15c, defined (and triton imported) at first use."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def pair_kernel(SP, SN, TP, TN, Loss, DP, DN, B, alpha, DISTILL: tl.constexpr,
                    BLOCK: tl.constexpr):
        # one program: the B pairs' softplus terms (and the MSEs), their
        # means, and the gradient of each score
        i = tl.arange(0, BLOCK)
        m = i < B
        sp = tl.load(SP + i, mask=m, other=0.0)
        sn = tl.load(SN + i, mask=m, other=0.0)
        x = -(sp - sn)
        soft = tl.maximum(x, 0.0) + tl.log(1.0 + tl.exp(-tl.abs(x)))
        sig = tl.exp(x - soft)
        loss = tl.sum(tl.where(m, soft, 0.0), axis=0) / B
        d_pos = -sig / B
        d_neg = sig / B
        if DISTILL:
            rp = sp - tl.load(TP + i, mask=m, other=0.0)
            rn = sn - tl.load(TN + i, mask=m, other=0.0)
            rp = tl.where(m, rp, 0.0)
            rn = tl.where(m, rn, 0.0)
            loss = loss + alpha * (tl.sum(rp * rp, axis=0) / B + tl.sum(rn * rn, axis=0) / B)
            d_pos = d_pos + alpha * (2.0 * rp / B)
            d_neg = d_neg + alpha * (2.0 * rn / B)
        tl.store(Loss, loss)
        tl.store(DP + i, d_pos, mask=m)
        tl.store(DN + i, d_neg, mask=m)

    @triton.jit
    def info_nce_kernel(Logits, Loss, D, B, BLOCK: tl.constexpr):
        # one program walks the B rows: the row's log-sum-exp less its
        # diagonal logit into the loss, (softmax - onehot) / B into D
        cols = tl.arange(0, BLOCK)
        cm = cols < B
        total = 0.0
        for r in range(B):
            row = tl.load(Logits + r * B + cols, mask=cm, other=-float("inf"))
            z = row - tl.max(row, axis=0)
            ez = tl.where(cm, tl.exp(z), 0.0)
            s = tl.sum(ez, axis=0)
            total += tl.log(s) - tl.sum(tl.where(cols == r, z, 0.0), axis=0)
            d = ez / s - tl.where(cols == r, 1.0, 0.0)
            tl.store(D + r * B + cols, d / B, mask=cm)
        tl.store(Loss, total / B)

    _TRITON.update(pair=pair_kernel, info_nce=info_nce_kernel)
    return _TRITON
