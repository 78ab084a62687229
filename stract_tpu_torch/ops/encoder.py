"""The BERT encoder's non-matmul body (K5) and its gradients (K14a-c), the
port of the body of stract_tpu/models/bert.py:81-247 and of what
`jax.value_and_grad` differentiates through it in the training steps
(stract_tpu/entrypoint/train_encoders.py:244, parallel/train.py:87,115).
Each piece is a kernel with its plain PyTorch twin, forward and backward:

  K5a  attention            masked softmax attention (bert.py:97-103): CUDA C++,
  K14a attention backward   csrc/encoder.cu, bound through ops/kernels.py; head
                            dims 16, 32 and 64, any number of tokens (other
                            head dims on a card raise)
  K5b  add_layernorm        bf16 residual add + f32 LayerNorm, cast to bf16
  K14b  ... backward        (bert.py:164-165, :173-174, and the embedding LN at
                            :204-205): CUDA C++, csrc/encoder.cu; rows of up to
                            1,024 columns (wider ones on a card raise)
  K5c  bias_gelu            bf16 bias add + tanh GELU (bert.py:170-171): CUDA
                            C++, csrc/encoder.cu
  K14c  ... backward        CUDA C++, csrc/encoder.cu; any width and any view
  K5d  mean_pool            masked mean pool, optionally L2-normalised
       (+ its backward)     (bert.py:222-226, :243-245): CUDA C++,
                            csrc/encoder.cu; any number of tokens up to the
                            grid's 2,097,120, widths that are multiples of 8
                            up to 1,024 (others on a card raise)

The public functions (attention, add_layernorm, bias_gelu, mean_pool) are
`torch.autograd.Function`s. Their forward and backward each pick by where
the input lies: a CPU tensor takes the plain twin, a CUDA tensor launches
the kernel or raises (the `*_forward` / `*_backward` dispatchers below).
The q/k/v, output and FFN projections and their gradients stay bf16
`torch.nn.functional.linear` products on cuBLAS, as the JAX package leaves
its `nn.Dense` products to XLA; so do the embedding tables' scatter-add
backward and the CLS readout.

Numerics follow the reference (flax on XLA): sums of two bf16 tensors round
to bf16 once; LayerNorm statistics are f32 with var = E[x^2] - E[x]^2
clipped at 0 (flax's fast variance), y = (x - mean) * (rsqrt(var + eps) *
scale) + bias; GELU is jax.nn.gelu's default tanh form, whose constants
sqrt(2/pi) and 0.044715 jax rounds to the input's dtype (bf16) before use.
The backward twins put their roundings where jax.vjp of that body puts
them: every cotangent of a bf16 value is rounded to bf16 (the transpose of
each f32 -> bf16 cast), the softmax gradient uses the f32 probabilities
while dV uses the bf16-rounded ones, the attention cotangent dP = dO.V^T is
rounded to bf16 before the softmax gradient, masked scores get no gradient.

The twins compute in the input's dtype with float32-or-wider sums, so given
float64 inputs they round nowhere, and torch.autograd.gradcheck can check
each backward twin against its forward.

Every kernel is bound through ops/kernels.py, which builds csrc/encoder.cu
at first launch: the CPU tests import this module where there is no nvcc.
"""

from __future__ import annotations

import math

import torch

from . import kernels

BF16 = torch.bfloat16
# jax.nn.gelu(approximate=True) on a bf16 input: its constants in bf16
GELU_C1 = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=BF16))  # 0.796875
GELU_C2 = float(torch.tensor(0.044715, dtype=BF16))                   # 0.044677734375


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The sum dtype of a twin: float32, or the input's when wider."""
    return torch.promote_types(dtype, torch.float32)


# ---- K5a / K14a: masked attention ----------------------------------------------------
def attention_plain(q, k, v, mask):
    """q, k, v bf16[B, T, h, d], mask [B, T] (nonzero = keep) → bf16[B, T, h*d]."""
    B, T, h, d = q.shape
    acc = _acc(q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) / math.sqrt(d)
    keep = (mask != 0)[:, None, None, :]
    scores = torch.where(keep, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs.to(acc), v.to(acc))
    return ctx.to(q.dtype).reshape(B, T, h * d)


def attention_backward_plain(q, k, v, mask, dout):
    """The VJP of attention_plain: dout [B, T, h*d] → (dq, dk, dv), each
    [B, T, h, d] in q's dtype."""
    B, T, h, d = q.shape
    acc = _acc(q.dtype)
    qf, kf, vf = (t.to(acc) for t in (q, k, v))
    keep = (mask != 0)[:, None, None, :]
    scores = torch.einsum("bthd,bshd->bhts", qf, kf) / math.sqrt(d)
    p = torch.softmax(torch.where(keep, scores, torch.finfo(torch.float32).min), dim=-1)
    g = dout.reshape(B, T, h, d).to(acc)
    dv = torch.einsum("bhts,bthd->bshd", p.to(q.dtype).to(acc), g).to(q.dtype)
    dp = torch.einsum("bthd,bshd->bhts", g, vf).to(q.dtype).to(acc)
    ds = p * dp - p * (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(keep, ds, 0.0) / math.sqrt(d)
    dq = torch.einsum("bhts,bshd->bthd", ds, kf).to(q.dtype)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf).to(q.dtype)
    return dq, dk, dv


def attention_forward(q, k, v, mask):
    if not q.is_cuda:
        return attention_plain(q, k, v, mask)
    B, T, h, d = q.shape
    out = torch.empty((B, T, h * d), dtype=BF16, device=q.device)
    kernels.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      mask.to(torch.int32).contiguous(), out)
    return out


def attention_backward(q, k, v, mask, dout):
    if not q.is_cuda:
        return attention_backward_plain(q, k, v, mask, dout)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    kernels.attention_backward(q, k, v, mask.to(torch.int32).contiguous(),
                               dout.contiguous(), dq, dk, dv)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return attention_forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, dout):
        return (*attention_backward(*ctx.saved_tensors, dout), None)


def attention(q, k, v, mask):
    """Masked attention, differentiable in q, k and v."""
    return _Attention.apply(q, k, v, mask)


# ---- K5b / K14b: residual add + LayerNorm --------------------------------------------
def add_layernorm_plain(x, r, weight, bias, eps: float):
    """LN(bf16(x + r)) in f32 with f32 weight and bias → bf16, shape of x."""
    s = (x + r).to(_acc(x.dtype))
    mean = s.mean(dim=-1, keepdim=True)
    var = ((s * s).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((s - mean) * mul + bias).to(x.dtype)


def add_layernorm_backward_plain(x, r, weight, eps: float, dy):
    """The VJP of add_layernorm_plain: dy (x's shape) → (ds, dweight, dbias);
    ds, in x's dtype, is the cotangent of both x and r (the rounded sum's)."""
    N = x.shape[-1]
    acc = _acc(x.dtype)
    s = (x + r).to(acc)
    mean = s.mean(dim=-1, keepdim=True)
    z = (s * s).mean(dim=-1, keepdim=True) - mean * mean
    var = z.clamp_min(0.0)
    rinv = torch.rsqrt(var + eps)
    g = dy.to(acc)
    xc = s - mean
    dbias = g.reshape(-1, N).sum(dim=0)
    dweight = (g * xc * rinv).reshape(-1, N).sum(dim=0)
    dxc = g * (rinv * weight)
    drinv = (g * xc * weight).sum(dim=-1, keepdim=True)
    dz = torch.where(z > 0, drinv * (-0.5 * (rinv / (var + eps))), 0.0)
    dmean = -dxc.sum(dim=-1, keepdim=True) - 2.0 * mean * dz
    # the reference rounds the (s - mean) path and the statistics' path to
    # bf16 apart, then adds them in bf16
    ds = dxc.to(x.dtype) + (dmean / N + (dz / N) * (2.0 * s)).to(x.dtype)
    return ds, dweight.to(weight.dtype), dbias.to(weight.dtype)


def add_layernorm_forward(x, r, weight, bias, eps: float):
    if not x.is_cuda:
        return add_layernorm_plain(x, r, weight, bias, eps)
    N = x.shape[-1]
    kernels._ptr(x, BF16)
    kernels._ptr(r, BF16, x.shape)
    out = torch.empty_like(x)
    kernels.add_layernorm(x.view(-1, N), r.view(-1, N), weight, bias, out.view(-1, N), eps)
    return out


def add_layernorm_backward(x, r, weight, eps: float, dy):
    if not x.is_cuda:
        return add_layernorm_backward_plain(x, r, weight, eps, dy)
    return kernels.add_layernorm_backward(x, r, dy.contiguous(), weight, eps)


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, weight, bias, eps):
        ctx.save_for_backward(x, r, weight)
        ctx.eps = eps
        return add_layernorm_forward(x, r, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, r, weight = ctx.saved_tensors
        ds, dweight, dbias = add_layernorm_backward(x, r, weight, ctx.eps, dy)
        return ds, ds, dweight, dbias, None


def add_layernorm(x, r, weight, bias, eps: float):
    """LN(bf16(x + r)), differentiable in x, r, weight and bias."""
    return _AddLayerNorm.apply(x, r, weight, bias, eps)


# ---- K5c / K14c: bias + GELU ---------------------------------------------------------
def bias_gelu_plain(y, b):
    """gelu_tanh(bf16(y + b)) → bf16; y bf16[..., N], b [N]."""
    s = (y + b.to(y.dtype)).to(_acc(y.dtype))
    cdf = 0.5 * (1.0 + torch.tanh(GELU_C1 * (s + GELU_C2 * (s * s * s))))
    return (s * cdf).to(y.dtype)


def bias_gelu_backward_plain(y, b, dout):
    """The VJP of jax.nn.gelu(y + b) as jax differentiates it: every step of
    the chain rule is an op in y's dtype, rounded on its own (`rd`), in the
    reference's order → (dy, db), both in y's dtype; db is the column sum of
    the rounded dy, taken in f32."""
    acc = _acc(y.dtype)
    rd = lambda t: t.to(y.dtype).to(acc)  # noqa: E731
    f = (y + b.to(y.dtype)).to(acc)
    c = dout.to(acc)
    f2 = rd(f * f)
    m = rd(torch.tanh(rd(GELU_C1 * rd(f + rd(GELU_C2 * rd(f2 * f))))))
    t = rd(rd(0.5 * rd(f * c)) * rd(1.0 - m))
    w = rd(GELU_C1 * rd(t + rd(t * m)))
    dy = rd(rd(rd(c * rd(0.5 * rd(1.0 + m))) + w) + rd(rd(GELU_C2 * w) * rd(3.0 * f2)))
    db = dy.reshape(-1, y.shape[-1]).sum(dim=0)
    return dy.to(y.dtype), db.to(y.dtype)


def bias_gelu_forward(y, b):
    if not y.is_cuda:
        return bias_gelu_plain(y, b)
    N = y.shape[-1]
    kernels._ptr(y, BF16)
    out = torch.empty_like(y)
    kernels.bias_gelu(y.view(-1, N), b, out.view(-1, N), GELU_C1, GELU_C2)
    return out


def bias_gelu_backward(y, b, dout):
    if not y.is_cuda:
        return bias_gelu_backward_plain(y, b, dout)
    dout = dout.contiguous()
    N = y.shape[-1]
    kernels._ptr(y, BF16)
    kernels._ptr(b, BF16, (N,))
    kernels._ptr(dout, BF16, y.shape)
    if y.numel() == 0:  # no rows: no launch, db is zeros
        return torch.empty_like(y), torch.zeros(N, dtype=BF16, device=y.device)
    dy, db = kernels.bias_gelu_backward(y.view(-1, N), b, dout.view(-1, N), GELU_C1, GELU_C2)
    return dy.view(y.shape), db


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, b):
        ctx.save_for_backward(y, b)
        return bias_gelu_forward(y, b)

    @staticmethod
    def backward(ctx, dout):
        return bias_gelu_backward(*ctx.saved_tensors, dout)


def bias_gelu(y, b):
    """gelu_tanh(bf16(y + b)), differentiable in y and b (b in y's dtype)."""
    return _BiasGelu.apply(y, b)


# ---- K5d: masked mean pool (+ L2 norm) -----------------------------------------------
def _pool_count(mask, dtype):
    """max(count of kept tokens, 1) per row, rounded to `dtype` as the
    reference's bf16 mask sum is → [B, 1] in the twin's sum dtype."""
    m = (mask != 0).to(_acc(dtype))
    return m.sum(dim=1, keepdim=True).to(dtype).clamp_min(1.0).to(_acc(dtype))


def mean_pool_plain(h, mask, normalize: bool):
    """h bf16[B, T, H], mask [B, T] → (pooled, raw), both f32[B, H]: raw is
    the reference's masked mean (bf16 sums reduced in f32, divided by
    max(count, 1) in bf16), pooled is raw divided by max(L2 norm, 1e-9) if
    `normalize`, else raw itself."""
    acc = _acc(h.dtype)
    m = (mask != 0)[:, :, None].to(h.dtype)
    total = (h * m).to(acc).sum(dim=1).to(h.dtype)
    raw = (total / _pool_count(mask, h.dtype).to(h.dtype)).to(acc)
    if not normalize:
        return raw, raw
    return raw / torch.linalg.vector_norm(raw, dim=-1, keepdim=True).clamp_min(1e-9), raw


def mean_pool_backward_plain(mask, raw, g, normalize: bool, dtype):
    """The VJP of mean_pool_plain given its un-normalised output `raw`
    ([B, H]) and the cotangent g ([B, H]) → dh [B, T, H] in `dtype`."""
    if normalize:
        nrm = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
        n = nrm.clamp_min(1e-9)
        dn = -(g * raw).sum(dim=-1, keepdim=True) / (n * n)
        # below the 1e-9 floor the norm gets no gradient (an all-zero mean,
        # where the reference's sqrt gradient is 0 * inf: kept finite here)
        g = g / n + raw * torch.where(nrm > 1e-9, dn * 0.5 / nrm * 2.0, 0.0)
    dsum = (g.to(dtype) / _pool_count(mask, dtype).to(dtype))
    m = (mask != 0)[:, :, None].to(dtype)
    return dsum[:, None, :] * m


def mean_pool_forward(h, mask, normalize: bool):
    """→ (pooled, raw) as mean_pool_plain: raw is what the backward reads."""
    if not h.is_cuda:
        return mean_pool_plain(h, mask, normalize)
    B, T, H = h.shape
    out = torch.empty((B, H), dtype=torch.float32, device=h.device)
    raw = torch.empty_like(out) if normalize else out
    kernels.mean_pool(h, mask, out, raw, normalize)
    return out, raw


def mean_pool_backward(mask, raw, g, normalize: bool, dtype):
    if not raw.is_cuda:
        return mean_pool_backward_plain(mask, raw, g, normalize, dtype)
    if dtype != BF16:
        raise ValueError(f"the pool kernel writes bf16 gradients, not {dtype}")
    B, H = raw.shape
    dh = torch.empty((B, mask.shape[1], H), dtype=BF16, device=raw.device)
    kernels.mean_pool_backward(mask, raw, g.contiguous(), dh, normalize)
    return dh


class _MeanPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, mask, normalize):
        pooled, raw = mean_pool_forward(h, mask, normalize)
        ctx.save_for_backward(mask, raw)
        ctx.normalize, ctx.dtype = normalize, h.dtype
        return pooled

    @staticmethod
    def backward(ctx, g):
        mask, raw = ctx.saved_tensors
        return mean_pool_backward(mask, raw, g, ctx.normalize, ctx.dtype), None, None


def mean_pool(h, mask, normalize: bool = False):
    """The masked mean of h over its tokens (f32[B, H]), L2-normalised when
    `normalize`; differentiable in h. mask: int32[B, T]."""
    return _MeanPool.apply(h, mask, normalize)
