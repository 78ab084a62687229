"""Pipeline parallelism (pp) for encoder training, the port of
stract_tpu/parallel/pipeline.py (K16): a GPipe schedule over the 'pp' axis
of a (pp, dp) Mesh.

Stage s owns one single-head transformer block (`_apply_stage`, f32:
x @ attn_qkv, the attention K16a, @ attn_out and the residual; x @ ffn_in,
the tanh GELU K16c, @ ffn_out and the residual); M microbatches enter
stage 0 and move one stage a step, so after M + S - 1 steps every
microbatch has crossed all S stages. The JAX package runs the schedule
under shard_map: a scan over the steps in which every stage computes
every step, its activations rotated by `ppermute` and the last stage's
outputs summed to all shards by `psum`. The port keeps the single
controller of parallel/mesh.py: one host loop over the same steps, in
which stage s runs microbatch t - s on `mesh.devices[s, d]` for each dp
shard d, the ppermute is `y.to(next stage's device)` and the psum is
`.to` the head's device (no copy where the entries share a card). A
stage whose microbatch index falls outside 0..M-1 (the schedule's bubble)
is skipped: in the reference its result is masked out of the outputs or
emitted after the last step, so it reaches neither the loss nor a
gradient. Nothing in the loop waits for the device, so on a mesh of
several cards each card's launches queue without waiting on the others.

Parameters: a dict of lists, one f32 tensor per stage and key
(`attn_qkv` [H, 3H], `attn_out` [H, H], `ffn_in` [H, F], `ffn_out`
[F, H]) on `mesh.devices[s, 0]`, and the head vector [H] on the last
stage's device. Each dp shard reads its stage's tensors through `.to`, so
autograd sums the shards' gradients into the one tensor: that sum is the
dp all-reduce. The train step takes gradients with torch.autograd.grad
and applies SGD in place (K16d); the JAX package returns new arrays.
`params_from_numpy` / `params_to_numpy` carry the JAX package's stacked
[S, ...] arrays across.

The four matrix products stay torch.matmul (cuBLAS f32 on the card, with
TF32 off), as the JAX package computes them with plain `@`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import stage as ST

STAGE_KEYS = ("attn_qkv", "attn_out", "ffn_in", "ffn_out")


def _devices(devices, n: int) -> list:
    """n torch.devices from one device or a sequence of n."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    out = [torch.device(d) for d in devices]
    if len(out) != n:
        raise ValueError(f"{n} stages need {n} devices, not {len(out)}")
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for and there is no CUDA card")
    return out


def _pipe_axes(mesh) -> tuple:
    if mesh.axis_names != ("pp", "dp"):
        raise ValueError(f"the pipeline runs on a mesh with axes ('pp', 'dp'), not "
                         f"{mesh.axis_names}")
    S, D = mesh.devices.shape
    _devices(list(mesh.devices.flat), S * D)
    return S, D


def init_stage_params(seed: int, hidden: int, ffn: int, num_stages: int,
                      devices="cuda") -> dict:
    """N(0, 0.02) f32 stage parameters from torch.Generator(seed) →
    {key: [one tensor per stage]}, stage s's tensors on devices[s] (one
    device for all, or a sequence)."""
    devs = _devices(devices, num_stages)
    g = torch.Generator().manual_seed(seed)
    shapes = {"attn_qkv": (hidden, 3 * hidden), "attn_out": (hidden, hidden),
              "ffn_in": (hidden, ffn), "ffn_out": (ffn, hidden)}
    return {k: [(0.02 * torch.randn(shape, generator=g)).to(devs[s])
                for s in range(num_stages)] for k, shape in shapes.items()}


def _apply_stage(p, x):
    """One transformer block with single-head attention. p: one stage's
    tensors {key: tensor}; x: [mb, T, H] on their device."""
    x = x + ST.stage_attention(x @ p["attn_qkv"]) @ p["attn_out"]
    return x + ST.gelu_tanh(x @ p["ffn_in"]) @ p["ffn_out"]


def pipeline_apply(mesh, stage_params, microbatches):
    """The GPipe schedule. stage_params: {key: [S tensors]}; microbatches
    [M, B, T, H] (any device), B split into the mesh's dp shards → [M, B, T,
    H] after all S stages, on the last stage's first device (the head's)."""
    S, D = _pipe_axes(mesh)
    M, B = microbatches.shape[:2]
    if B % D:
        raise ValueError(f"{B} rows a microbatch do not split into {D} dp shards")
    shards = microbatches.chunk(D, dim=1)
    out_dev = mesh.devices[S - 1, 0]
    # each (stage, dp shard)'s view of its stage's parameters: the tensor
    # itself on its own device, else a copy whose gradient flows back to it
    local = [[{k: stage_params[k][s].to(mesh.devices[s, d]) for k in STAGE_KEYS}
              for d in range(D)] for s in range(S)]
    state = [[None] * D for _ in range(S)]  # the input of each stage this step
    outputs = [[None] * D for _ in range(M)]
    for t in range(M + S - 1):
        nxt = [[None] * D for _ in range(S)]
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            for d in range(D):
                dev = mesh.devices[s, d]
                x = shards[d][m].to(dev) if s == 0 else state[s][d]
                y = _apply_stage(local[s][d], x)
                if s == S - 1:
                    outputs[m][d] = y.to(out_dev)
                else:
                    nxt[s + 1][d] = y.to(mesh.devices[s + 1, d])
        state = nxt
    return torch.stack([torch.cat(outputs[m], dim=0) for m in range(M)])


def _leaves(params) -> list:
    return [t for k in STAGE_KEYS for t in params[k]] + [params["head"]]


def make_pipeline_train_step(mesh, hidden: int = 32, ffn: int = 64,
                             learning_rate: float = 1e-3):
    """→ (init_fn, step_fn): pipelined regression training over the mesh's
    ('pp', 'dp') axes. A batch [M, B, T, H] with targets [M, B] splits into
    dp shards of each microbatch; loss = MSE of the T-mean-pooled output
    dotted with the head vector. init_fn(seed) → params; step_fn(params,
    mbs, targets) → (params, loss), the parameters updated in place by SGD
    (K16d) and the loss a 0-d tensor on the head's device."""
    S, _ = _pipe_axes(mesh)
    head_dev = mesh.devices[S - 1, 0]

    def init_fn(seed: int) -> dict:
        p = init_stage_params(seed, hidden, ffn, S, list(mesh.devices[:, 0]))
        # the head from its own stream, as the reference folds 7 into its key
        g = torch.Generator().manual_seed(seed + 7)
        p["head"] = (0.02 * torch.randn(hidden, generator=g)).to(head_dev)
        for t in _leaves(p):
            t.requires_grad_(True)
        return p

    def step_fn(params, mbs, targets):
        preds = pipeline_apply(mesh, params, mbs).mean(dim=2) @ params["head"]  # [M, B]
        loss = ((preds - targets.to(head_dev)) ** 2).mean()
        leaves = _leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():  # K16d: one launch per card over all the leaves
            ST.sgd_update_many([p.detach() for p in leaves], grads, learning_rate)
        return params, loss.detach()

    return init_fn, step_fn


def reference_forward(params, mbs):
    """The sequential (non-pipelined) twin: each microbatch through the S
    stages in turn, on each stage's device → [M, B, T, H] on the last's."""
    S = len(params["attn_qkv"])
    out = []
    for m in range(mbs.shape[0]):
        x = mbs[m]
        for s in range(S):
            local = {k: params[k][s] for k in STAGE_KEYS}
            x = _apply_stage(local, x.to(local["attn_qkv"].device))
        out.append(x)
    return torch.stack(out)


def params_from_numpy(params: dict, mesh) -> dict:
    """The JAX package's parameters as numpy ({key: [S, ...]}, "head" [H] if
    present) → the port's: stage s's tensors on mesh.devices[s, 0], the
    head on the last stage's, all leaves that require grad."""
    S, _ = _pipe_axes(mesh)
    out = {k: [torch.from_numpy(np.array(params[k][s], dtype=np.float32))
               .to(mesh.devices[s, 0]).requires_grad_(True) for s in range(S)]
           for k in STAGE_KEYS}
    if "head" in params:
        out["head"] = torch.from_numpy(np.array(params["head"], dtype=np.float32)) \
            .to(mesh.devices[S - 1, 0]).requires_grad_(True)
    return out


def params_to_numpy(params: dict) -> dict:
    """The reverse of params_from_numpy: {key: stacked [S, ...] array}, and
    "head" [H] if present."""
    out = {k: np.stack([t.detach().cpu().numpy() for t in params[k]]) for k in STAGE_KEYS}
    if "head" in params:
        out["head"] = params["head"].detach().cpu().numpy()
    return out
