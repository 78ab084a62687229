#!/usr/bin/env python3
"""Where K10's (the dense rerank's) device time goes, on one NVIDIA card:

    python3 scripts/rerank_probe.py [--cut none,tail,ticket] [--calls 50]

Reads K10's device time a call (torch.profiler over --calls calls after 5
warm-ups; CUDA events beside) at SHAPES (B, K, H, k): chip_smoke.py's 32 x
1,024 x 384 f16, k = 20; the same rows at H = 8 (almost no bytes); at K =
128 (one tile a query) and 4,096; and 4 x 5,000 at H = 384 and 1,536 with
k = K; beside the three PyTorch calls that compute it (F.normalize, einsum,
torch.topk). Each --cut names a tree: `none` this checkout; `tail` and
`ticket` copies of its package under data/rerank_probe/ whose kernel skips
the last block's select (the ticket kept) or returns after its keys (no
ticket): the parts by difference. Prints the card's name and power limit
and a JSON line a reading. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((32, 1024, 384, 20), (32, 1024, 8, 20), (32, 128, 384, 20), (32, 4096, 384, 20),
          (4, 5000, 384, 5000), (4, 5000, 1536, 5000))
# the kernel's select, cut from the copies: from the last block's first
# statement after the ticket to the kernel's end
SELECT_FROM = "  const long long o = (long long)b * k;\n  if (k <= 32) {"
TICKET = ("  // the last block of the query to arrive takes its top k\n  __threadfence();\n"
          "  __syncthreads();\n  if (tid == 0) last = atomicAdd(&tickets[b], 1u) == gridDim.x"
          " - 1u;\n  __syncthreads();\n  if (!last) return;\n  __threadfence();\n"
          "  if (tid == 0) tickets[b] = 0u;\n")


def cut_tree(cut: str) -> str:
    """A copy of the package with K10's select (and for `ticket` its ticket)
    cut: the last block (block 0 without a ticket) writes indices 0..k-1."""
    root = os.path.join(ROOT, "data", "rerank_probe", cut)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "stract_tpu_torch"), os.path.join(root, "stract_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(root, "stract_tpu_torch", "csrc", "scoring.cu")
    src = open(path).read()
    a = src.index(SELECT_FROM)
    b = src.index("}\n", src.index("out_scores[o + pos] = key_value(kx);"))
    src = (src[:a] + "  if (tid < k) {\n    out_idx[(long long)b * k + tid] = tid;\n"
           "    out_scores[(long long)b * k + tid] = 0.0f;\n  }\n" + src[b:])
    if cut == "ticket":
        src = src.replace(TICKET, "  if (blockIdx.x != 0) return;\n")
    open(path, "w").write(src)
    return root


def worker(calls: int) -> list:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stract_tpu_torch.ops import dense_rerank as R
    from stract_tpu_torch.ops import kernels

    kernels.build()

    def measure(fn) -> tuple:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3 / calls
        return a.elapsed_time(b) / calls, dev or None

    out, g = [], torch.Generator().manual_seed(0)
    for B, K, H, k in SHAPES:
        emb = F.normalize(torch.randn((B, K, H), generator=g), dim=2).to("cuda", torch.float16)
        q, base = torch.randn((B, H), generator=g).cuda(), torch.randn((B, K), generator=g).cuda()
        e32 = emb.float()
        for name, fn in (("K10", lambda: R.rerank_topk_batch(emb, q, base, 0.01, k)),
                         ("three_calls", lambda: torch.topk(base + 0.01 * torch.einsum(
                             "bkh,bh->bk", F.normalize(e32, dim=2, eps=1e-6), q), k))):
            ev, dev = measure(fn)
            out.append({"name": name, "B": B, "K": K, "H": H, "k": k, "event_ms": ev,
                        "device_ms": dev})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cut", default="none,tail,ticket")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.calls)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("rerank_probe.py needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for cut in args.cut.split(","):
        root = ROOT if cut == "none" else cut_tree(cut)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", "--calls",
                               str(args.calls)], capture_output=True, text=True, cwd=root,
                              env={**os.environ, "PYTHONPATH": root})
        if proc.returncode:
            print(f"[{cut}] failed:\n{proc.stderr[-3000:]}", flush=True)
            return proc.returncode
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            print(json.dumps({"cut": cut, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
