#!/usr/bin/env python3
"""The shard search's configurations served in turns on one NVIDIA card:
the default and each configuration of chip_smoke.CONFIGS (q8 rows, the
device factor join, both, UB scoring) are built once over chip_smoke's
1,000,000-doc corpus, then serve chip_smoke's 128-request mix at 16 clients
over HTTP with the pipeline off, one round per configuration per turn, the
order reversed on every other turn (default, q8, ..., ub, ub, ..., default),
so that host drift falls on all of them alike.

    python3 scripts/serve_configs_ab.py [--turns 4] [--configs default,join]

Prints one line per served round (qps, p50, p99, the host factor join's
seconds and calls) and as its last line a JSON summary: per configuration
the rounds' qps with their mean, minimum and maximum, the mean p50 and the
mean host-join seconds. Every request must be answered and each
configuration's own kernels launched, as in chip_smoke's serve phase. Needs
a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--configs", default="default,q8,join,q8_join,ub")
    ap.add_argument("--data", default=os.path.join(ROOT, "data", "torch_smoke"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("serve_configs_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.ops import kernels

    card = CS.card_line()
    print(f"card: {card}", flush=True)
    kernels.build()
    index_dir = bc.ensure_corpus(args.data, CS.DOCS, seed=CS.SEED, log=CS.log)
    known = {"default": ({}, CS.SCORING), **CS.CONFIGS}
    names = args.configs.split(",")
    searchers = {n: build_searcher(index_dir, "cuda", **known[n][0]) for n in names}
    torch.cuda.synchronize()
    rows: dict = {n: [] for n in names}
    for turn in range(args.turns):
        for n in (names if turn % 2 == 0 else names[::-1]):
            with CS.join_timer() as jt:
                served = CS.serve_phase(searchers[n], known[n][1])
            rows[n].append({"qps": served["qps"], "p50_ms": served["p50_ms"],
                            "p99_ms": served["p99_ms"], "host_join_s": jt["seconds"],
                            "host_join_calls": jt["calls"]})
            print(f"[turn {turn}] {n}: {json.dumps(rows[n][-1])}", flush=True)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    summary = {n: {"qps": [r["qps"] for r in rs], "qps_mean": mean([r["qps"] for r in rs]),
                   "qps_min": min(r["qps"] for r in rs), "qps_max": max(r["qps"] for r in rs),
                   "p50_ms_mean": mean([r["p50_ms"] for r in rs]),
                   "host_join_s_mean": mean([r["host_join_s"] for r in rs])}
               for n, rs in rows.items()}
    print(json.dumps({"card": card, "turns": args.turns, "requests_per_round": CS.N_REQUESTS,
                      "clients": CS.CLIENTS, "configs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
