"""Dense embedding rerank — the port of stract_tpu/ops/dense_rerank.py
(dual-encoder dot product + top-k over candidate sets).

    sims  = cand_emb · q / max(‖cand_emb‖, 1e-6)     (0 where the norm <= 1e-6)
    total = base + weight * sims  →  top-k

The plain version follows the reference; the kernel (K10, csrc/scoring.cu
stract_dense_rerank) takes a grid of (128-candidate tile, query) blocks that
write their keys, and the last block of each query selects its top k. CPU tensors
take the plain version, CUDA tensors launch the kernel or raise. Both order
the totals as lax.top_k does on the CPU: descending, +0 above -0, ties to
the lower index (the plain version sorts the kernel's order keys stably;
torch.topk's order among equal values is not fixed, and a float sort takes
-0 and +0 as equal).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels


def rerank_topk_batch_plain(cand_emb, query_emb, base_scores, weight: float, k: int):
    emb = cand_emb.to(torch.float32)
    sims = torch.einsum("bkh,bh->bk", emb, query_emb.to(torch.float32))
    norms = torch.linalg.norm(emb, dim=2)
    sims = torch.where(norms > 1e-6, sims / torch.clamp(norms, min=1e-6), torch.zeros_like(sims))
    total = base_scores + weight * sims
    order = kernels.top_order(total, k)
    return order.to(torch.int32), torch.gather(total, 1, order)


_on = kernels.on_device


def rerank_topk_batch(cand_emb, query_emb, base_scores, weight: float = 0.01, k: int = 20):
    """cand_emb f32/f16/bf16[B, K, H] (L2-normalised rows or zero), query_emb
    f32[B, H], base_scores f32[B, K] → (top-k indices i32[B, k], combined
    scores f32[B, k]). Runs where cand_emb lies."""
    if not isinstance(cand_emb, torch.Tensor):
        cand_emb = torch.as_tensor(np.asarray(cand_emb))
    cand_emb = cand_emb.contiguous()
    dev = cand_emb.device
    query_emb = _on(query_emb, dev, torch.float32)
    base_scores = _on(base_scores, dev, torch.float32)
    if not cand_emb.is_cuda:
        return rerank_topk_batch_plain(cand_emb, query_emb, base_scores, weight, k)
    B = cand_emb.shape[0]
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    scores = torch.empty((B, k), dtype=torch.float32, device=dev)
    kernels.dense_rerank(cand_emb, query_emb, base_scores, weight, k, idx, scores)
    return idx, scores


def rerank_topk(cand_emb, query_emb, base_scores, weight: float = 0.01, k: int = 20):
    """Single query: cand_emb [K, H], query_emb [H], base_scores [K] →
    (indices i32[k], scores f32[k]), through the batch path with B = 1."""
    if not isinstance(cand_emb, torch.Tensor):
        cand_emb = torch.as_tensor(np.asarray(cand_emb))
    dev = cand_emb.device
    idx, scores = rerank_topk_batch(cand_emb[None], _on(query_emb, dev)[None],
                                    _on(base_scores, dev)[None], weight, k)
    return idx[0], scores[0]
