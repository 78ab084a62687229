"""The training steps' loss heads (K15c), value and gradient in one pass:

  pair_loss   the cross encoder's pairwise logistic loss, the mean of
              softplus(-(s+ - s-)) (stract_tpu/parallel/train.py:26), plus,
              when teacher targets are given, alpha x the two MSEs to them
              (the distilled step, parallel/train.py:98)
  info_nce    the dual encoder's in-batch cross-entropy of the B x B
              similarity logits against the diagonal
              (stract_tpu/entrypoint/train_encoders.py:249-251, optax's
              softmax_cross_entropy_with_integer_labels, mean)

Each reduces a few hundred numbers, so launch latency bounds it, not bytes
or operations: one CUDA launch (csrc/losses.cu, bound through
ops/kernels.py; two for InfoNCE past 64 rows) computes the loss and the
gradient of every input at once, rows or pairs in parallel and every sum in
a fixed order, and the backward scales that gradient by the incoming
cotangent. Plain twins beside them compute the same expressions in torch; a
CPU tensor takes the twin, a CUDA tensor launches the kernel or raises.
Both follow the reference's expressions: softplus(x) = max(x, 0) +
log1p(exp(-|x|)) (jnp.logaddexp(x, 0)) with gradient exp(x - softplus(x));
the cross entropy as log(sum(exp(l - max))) - (l_ii - max) with gradient
(softmax - onehot) / B.
"""

from __future__ import annotations

import torch

from . import kernels


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
def pair_loss_forward(s_pos, s_neg, t_pos=None, t_neg=None, alpha: float = 0.0):
    if not s_pos.is_cuda:
        return pair_loss_plain(s_pos, s_neg, t_pos, t_neg, alpha)
    f32 = torch.float32
    s_pos, s_neg = s_pos.contiguous(), s_neg.contiguous()
    if t_pos is not None:
        t_pos, t_neg = (t.to(f32).contiguous() for t in (t_pos, t_neg))
    loss = torch.empty((), dtype=f32, device=s_pos.device)
    d_pos, d_neg = torch.empty_like(s_pos), torch.empty_like(s_neg)
    kernels.pair_loss(s_pos, s_neg, t_pos, t_neg, alpha, loss, d_pos, d_neg)
    return loss, d_pos, d_neg


def info_nce_forward(logits):
    if not logits.is_cuda:
        return info_nce_plain(logits)
    logits = logits.contiguous()
    loss = torch.empty((), dtype=torch.float32, device=logits.device)
    d = torch.empty_like(logits)
    kernels.info_nce(logits, loss, d)
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
