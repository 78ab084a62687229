"""K4, the LambdaMART forest walk — the port of
stract_tpu/ranking/models/lambdamart.py:195 _gbdt_forward.

`gbdt_forward_plain` is the plain PyTorch version, written step for step
after the JAX program (a [T, K] matrix of node indices advanced one level per
step with gathers, then one leaf value per tree summed over the trees).
`gbdt_forward` picks by where x lies: a CPU tensor takes the plain version, a
CUDA tensor launches the hand-written kernel (csrc/forest.cu) or raises.

Layout (the JAX package's): feature/left/right i32[T, N] and threshold
f32[T, N] per internal node, leaf_value f32[T, L]; children >= 0 are nodes,
leaves are -(leaf + 1).
"""

from __future__ import annotations

import torch

from . import kernels


def gbdt_forward_plain(feature, threshold, left, right, leaf_value, x, max_depth: int):
    """x f32[K, F] → f32[K]."""
    T, N = feature.shape
    K, F = x.shape
    cur = torch.zeros((T, K), dtype=torch.int32, device=x.device)
    rows = torch.arange(K, device=x.device)[None, :].expand(T, K)
    for _ in range(max_depth):
        node = cur.clamp(0, N - 1).long()
        f = torch.gather(feature, 1, node).long()
        f = torch.where(f < 0, f + F, f).clamp(0, F - 1)  # numpy indexing, then the clamp
        thr = torch.gather(threshold, 1, node)
        nxt = torch.where(x[rows, f] <= thr, torch.gather(left, 1, node),
                          torch.gather(right, 1, node))
        cur = torch.where(cur >= 0, nxt, cur)  # leaves stay put
    leaf = (-cur - 1).clamp(0, leaf_value.shape[1] - 1).long()
    return torch.gather(leaf_value, 1, leaf).sum(dim=0)


def gbdt_forward(feature, threshold, left, right, leaf_value, x, max_depth: int):
    """x f32[K, F] → f32[K]; the forest's tensors lie where x lies."""
    if not x.is_cuda:
        return gbdt_forward_plain(feature, threshold, left, right, leaf_value, x, max_depth)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    if x.shape[0]:
        kernels.forest(feature, threshold, left, right, leaf_value, x.contiguous(), out,
                       max_depth)
    return out
