"""The BERT encoder's non-matmul body (K5), the port of the body of
stract_tpu/models/bert.py:81-205 — three kernels, each with its plain
PyTorch twin:

  K5a attention      masked softmax attention (bert.py:97-103): CUDA C++,
                     csrc/encoder.cu, bound through ops/kernels.py
  K5b add_layernorm  bf16 residual add + f32 LayerNorm, cast to bf16
                     (bert.py:164-165, :173-174, and the embedding LN at
                     :204-205): Triton
  K5c bias_gelu      bf16 bias add + tanh GELU (bert.py:170-171): Triton

The q/k/v, output and FFN projections stay bf16 `torch.nn.functional.linear`
products outside these kernels, as the JAX package leaves its `nn.Dense`
products to XLA. Each public function picks by where its input lies: a CPU
tensor takes the plain twin, a CUDA tensor launches the kernel or raises.

Numerics follow the reference (flax on XLA): sums of two bf16 tensors round
to bf16 once; LayerNorm statistics are f32 with var = E[x^2] - E[x]^2
clipped at 0 (flax's fast variance), y = (x - mean) * (rsqrt(var + eps) *
scale) + bias; GELU is jax.nn.gelu's default tanh form, whose constants
sqrt(2/pi) and 0.044715 jax rounds to the input's dtype (bf16) before use.

Triton is imported inside the launching function only: the CPU tests import
this module where there is no triton.
"""

from __future__ import annotations

import math

import torch

from . import kernels

BF16 = torch.bfloat16
# jax.nn.gelu(approximate=True) on a bf16 input: its constants in bf16
GELU_C1 = float(torch.tensor(math.sqrt(2.0 / math.pi), dtype=BF16))  # 0.796875
GELU_C2 = float(torch.tensor(0.044715, dtype=BF16))                   # 0.044677734375
_TRITON: dict = {}


# ---- K5a: masked attention ----------------------------------------------------------
def attention_plain(q, k, v, mask):
    """q, k, v bf16[B, T, h, d], mask [B, T] (nonzero = keep) → bf16[B, T, h*d]."""
    B, T, h, d = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(d)
    keep = (mask != 0)[:, None, None, :]
    scores = torch.where(keep, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return ctx.to(q.dtype).reshape(B, T, h * d)


def attention(q, k, v, mask):
    if not q.is_cuda:
        return attention_plain(q, k, v, mask)
    B, T, h, d = q.shape
    out = torch.empty((B, T, h * d), dtype=BF16, device=q.device)
    kernels.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      mask.to(torch.int32).contiguous(), out)
    return out


# ---- K5b: residual add + LayerNorm --------------------------------------------------
def add_layernorm_plain(x, r, weight, bias, eps: float):
    """LN(bf16(x + r)) in f32 with f32 weight and bias → bf16, shape of x."""
    s = (x + r).float()
    mean = s.mean(dim=-1, keepdim=True)
    var = ((s * s).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((s - mean) * mul + bias).to(BF16)


def add_layernorm(x, r, weight, bias, eps: float):
    if not x.is_cuda:
        return add_layernorm_plain(x, r, weight, bias, eps)
    N = x.shape[-1]
    for t, dtype, shape in ((x, BF16, None), (r, BF16, x.shape), (weight, torch.float32, (N,)),
                            (bias, torch.float32, (N,))):
        kernels._ptr(t, dtype, shape)
    xs, rs = x.reshape(-1, N), r.reshape(-1, N)
    out = torch.empty_like(xs)
    if xs.shape[0]:
        kern = _triton_kernels()["add_layernorm"]
        kern[(xs.shape[0],)](xs, rs, weight, bias, out, N, float(eps),
                             BLOCK=max(_next_pow2(N), 32), num_warps=4)
        kernels.counted("add_layernorm")
    return out.reshape(x.shape)


# ---- K5c: bias + GELU -----------------------------------------------------------------
def bias_gelu_plain(y, b):
    """gelu_tanh(bf16(y + b)) → bf16; y bf16[..., N], b [N]."""
    s = (y + b.to(BF16)).float()
    cdf = 0.5 * (1.0 + torch.tanh(GELU_C1 * (s + GELU_C2 * (s * s * s))))
    return (s * cdf).to(BF16)


def bias_gelu(y, b):
    if not y.is_cuda:
        return bias_gelu_plain(y, b)
    N = y.shape[-1]
    kernels._ptr(y, BF16)
    kernels._ptr(b, BF16, (N,))
    out = torch.empty_like(y)
    total = y.numel()
    if total:
        block = 1024
        kern = _triton_kernels()["bias_gelu"]
        kern[(_cdiv(total, block),)](y, b, out, N, total, GELU_C1, GELU_C2, BLOCK=block,
                                     num_warps=4)
        kernels.counted("bias_gelu")
    return out


# ---- the Triton kernels ------------------------------------------------------------------
def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _triton_kernels() -> dict:
    """The two Triton kernels, defined (and triton imported) at first use."""
    if _TRITON:
        return _TRITON
    import triton
    import triton.language as tl

    @triton.jit
    def add_layernorm_kernel(X, R, W, Bias, Y, N, eps, BLOCK: tl.constexpr):
        # one program per row: s = bf16(x + r); f32 statistics; bf16 out
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        m = cols < N
        x = tl.load(X + row * N + cols, mask=m, other=0.0).to(tl.float32)
        r = tl.load(R + row * N + cols, mask=m, other=0.0).to(tl.float32)
        s = (x + r).to(tl.bfloat16).to(tl.float32)
        mean = tl.sum(s, axis=0) / N
        var = tl.maximum(tl.sum(s * s, axis=0) / N - mean * mean, 0.0)
        w = tl.load(W + cols, mask=m, other=0.0)
        b = tl.load(Bias + cols, mask=m, other=0.0)
        mul = (1.0 / tl.sqrt(var + eps)) * w
        tl.store(Y + row * N + cols, ((s - mean) * mul + b).to(tl.bfloat16), mask=m)

    @triton.jit
    def bias_gelu_kernel(Y, Bias, O, N, total, c1, c2, BLOCK: tl.constexpr):
        # a flat pass: s = bf16(y + b[col]); tanh GELU in f32; bf16 out
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < total
        y = tl.load(Y + offs, mask=m, other=0.0).to(tl.float32)
        b = tl.load(Bias + offs % N, mask=m, other=0.0).to(tl.float32)
        s = (y + b).to(tl.bfloat16).to(tl.float32)
        u = c1 * (s + c2 * (s * s * s))
        t = 1.0 - 2.0 / (tl.exp(2.0 * u) + 1.0)  # tanh(u), exact at both tails
        tl.store(O + offs, (s * (0.5 * (1.0 + t))).to(tl.bfloat16), mask=m)

    _TRITON.update(add_layernorm=add_layernorm_kernel, bias_gelu=bias_gelu_kernel)
    return _TRITON
