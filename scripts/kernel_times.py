#!/usr/bin/env python3
"""Times K5a (masked attention) and K16d (the pipeline's SGD update) of the
PyTorch port on one NVIDIA card, each beside the PyTorch call that computes
the same function, in fresh processes over one or more checkouts:

    python3 scripts/kernel_times.py --runs parent,change,change,parent \
        [--tree parent=DIR] [--calls 50]

Each entry of --runs names a checkout (`change` is this one; others come
from --tree NAME=DIR, e.g. a `git archive` of the parent commit unpacked
under data/). Shapes are chip_smoke.py's: attention at B = 32, 12 heads of
32, T in (16, 65, 128, 200, 256), row 1 half masked and row 2 fully masked;
SGD over the 25 f32 tensors of the pipelined train step (6 stages of
attn_qkv, attn_out, ffn_in, ffn_out at H = 384, FFN = 1536, and the head),
10,617,216 entries; and that whole train step on a (pp=6, dp=2) mesh of the
card, 8 microbatches of 16 rows of 128 tokens (3 steps timed). For each: `event_ms`, CUDA events around --calls calls
after 5 warm-ups (what the host can issue and the card finish: the smoke's
measure), and `device_ms`, the card's own time for one call, the sum of the
kernels' device time in a torch.profiler window of --calls calls over the
calls ("not measured" when the profiler saw no device time). The library
calls: scaled_dot_product_attention with an additive bf16 mask, and
torch._foreach_add_. Prints the card's name and power limit, a JSON line a
reading, and a JSON summary last. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_B, ATTN_H, ATTN_T = 32, 12, (16, 65, 128, 200, 256)
PIPE_SIZES = [384 * 1152, 384 * 384, 384 * 1536, 1536 * 384] * 6 + [384]
LR = 5e-2


def measure(fn, calls: int) -> tuple:
    """(event ms, device ms or None) a call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b) / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)  # the kernels' own events
    return event_ms, (us / 1e3 / calls if us else None)


def worker(root: str, calls: int) -> list:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import stage as ST

    kernels.build()
    out = []
    g = torch.Generator().manual_seed(0)
    for T in ATTN_T:
        q, k, v = (torch.randn((ATTN_B, T, ATTN_H, 32), generator=g).to("cuda", torch.bfloat16)
                   for _ in range(3))
        mask = torch.ones((ATTN_B, T), dtype=torch.int32)
        mask[1, T // 2:] = 0
        mask[2] = 0
        mask = mask.cuda()
        add = torch.zeros((ATTN_B, 1, 1, T), dtype=torch.bfloat16, device="cuda")
        add.masked_fill_(mask[:, None, None, :] == 0, torch.finfo(torch.bfloat16).min)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for name, fn in (("K5a", lambda: E.attention_forward(q, k, v, mask)),
                         ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, add))):
            ev, dev = measure(fn, calls)
            out.append({"name": name, "T": T, "event_ms": ev, "device_ms": dev})
    ps = [torch.randn(n, generator=g).cuda() for n in PIPE_SIZES]
    gs = [0.01 * torch.randn(n, generator=g).cuda() for n in PIPE_SIZES]
    if hasattr(ST, "sgd_update_many"):
        sgd = lambda: ST.sgd_update_many(ps, gs, LR)  # noqa: E731
    else:  # a checkout from before the one-launch update: one launch a tensor
        sgd = lambda: [ST.sgd_update(p, gg, LR) for p, gg in zip(ps, gs)]  # noqa: E731
    for name, fn in (("K16d", sgd), ("foreach_add", lambda: torch._foreach_add_(ps, gs,
                                                                             alpha=-LR))):
        ev, dev = measure(fn, calls)
        out.append({"name": name, "tensors": len(ps), "event_ms": ev, "device_ms": dev})
    del ps, gs

    # the whole pipelined train step that K16d ends (chip_smoke.py's pipeline phase)
    from stract_tpu_torch.parallel import pipeline as PL
    from stract_tpu_torch.parallel.mesh import Mesh

    dev0 = torch.device("cuda", 0)
    mesh = Mesh([[dev0] * 2] * 6, axis_names=("pp", "dp"))
    init_fn, step_fn = PL.make_pipeline_train_step(mesh, hidden=384, ffn=1536, learning_rate=LR)
    params = init_fn(0)
    mbs = torch.randn((8, 16, 128, 384), generator=g).to(dev0)
    targets = torch.randn((8, 16), generator=g).to(dev0)
    ev, dev = measure(lambda: step_fn(params, mbs, targets), 3)
    out.append({"name": "pipeline_step", "steps": 3, "event_ms": ev, "device_ms": dev})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="change")
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.calls)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times.py needs an NVIDIA card", file=sys.stderr)
        return 1
    trees = {"change": ROOT, **dict(t.split("=", 1) for t in args.tree)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    summary = {}
    for n, tree in enumerate(args.runs.split(",")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               os.path.abspath(trees[tree]), "--calls", str(args.calls)],
                              capture_output=True, text=True, cwd=trees[tree])
        if proc.returncode:
            print(f"[run {n} {tree}] failed:\n{proc.stderr[-3000:]}", flush=True)
            return proc.returncode
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            rec = {"run": n, "tree": tree, **rec}
            print(json.dumps(rec), flush=True)
            key = f"{tree} {rec['name']} {rec.get('T', rec.get('tensors', ''))}"
            summary.setdefault(key, []).append((rec["event_ms"], rec["device_ms"]))
    print(json.dumps({"card": card.strip().splitlines()[0], "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
