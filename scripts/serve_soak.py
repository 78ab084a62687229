#!/usr/bin/env python3
"""Pipeline-on serving soak of the PyTorch port on one NVIDIA card: fresh
processes, each serving R rounds of chip_smoke's 128-request mix at 16
clients over HTTP, with the ranking pipeline on (dual encoder, cross
encoder, LambdaMART forest), in the shard-search configuration that
--row-layout and --device-join name.

    python3 scripts/serve_soak.py --runs change,parent,parent,change \
        [--tree parent=DIR] [--rounds 8] [--timeout 600] [--row-layout q8] [--device-join]

Each entry of --runs names a checkout of the repository (`change` is this
one; others come from --tree NAME=DIR, e.g. a `git archive` of the parent
commit unpacked under data/). The corpus (bench_corpus, 1,000,000 docs, seed 0), the models (chip_smoke's
models phase: a 30,522-piece vocab, MiniLM-L6 dual and distilled cross
encoders trained on the card, a 40-tree forest) and the embedding columns
are made once by this tree's code and served by every process. Each
process stops at its first failed round. The last line is a JSON summary:
per run, the rounds finished, qps per round and the first error; per tree,
the processes that finished every round and their mean qps. Needs a card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> int:
    """One serving process over the tree at args.root."""
    sys.path.insert(0, args.root)
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread, build_searcher

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[worker] torch {torch.__version__} cuda {torch.version.cuda} root {args.root}",
          flush=True)
    with open(args.bodies) as fh:
        bodies = json.load(fh)
    searcher = build_searcher(args.index, "cuda", dual_encoder=args.dual,
                              cross_encoder=args.cross, lambdamart=args.forest,
                              row_layout=args.row_layout, device_join=args.device_join)

    from chip_smoke import CLIENTS, post

    server = ServerThread(build_app(searcher, max_concurrency=2 * CLIENTS))
    url = server.url + "/beta/api/search"
    rounds, error = [], None
    try:
        post(url, {"query": "w1 w2"})
        for r in range(args.rounds):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as pool:
                res = list(pool.map(lambda b: _safe_post(post, url, b), bodies))
            wall = time.perf_counter() - t0
            bad = [x for x in res if x[0] != 200]
            torch.cuda.synchronize()
            lat = np.array([x[2] for x in res])
            rounds.append({"qps": len(bodies) / wall, "p50_ms": float(np.median(lat) * 1e3),
                           "failed": len(bad)})
            print(f"[worker] round {r + 1}: {json.dumps(rounds[-1])}", flush=True)
            if bad:
                error = str(bad[0][1])[:400]
                break
    except Exception as e:  # noqa: BLE001 — reported in the summary, exit code 1
        error = f"{type(e).__name__}: {e}"[:400]
        traceback.print_exc()
    finally:
        try:
            server.stop()
        except Exception:  # noqa: BLE001 — a dead card can hang the shutdown
            pass
    finished = sum(1 for x in rounds if x["failed"] == 0)
    print("[worker-result] " + json.dumps({"finished": finished, "rounds": rounds,
                                            "error": error}), flush=True)
    return 0 if finished == args.rounds else 1


def _safe_post(post, url, body):
    try:
        return post(url, body)
    except Exception as e:  # noqa: BLE001 — an HTTP 500 carries the server's error
        detail = e.read().decode()[:400] if hasattr(e, "read") else f"{type(e).__name__}: {e}"
        return getattr(e, "code", -1), detail, 0.0


def prepare(data_dir: str) -> dict:
    """Corpus, models and embedding columns, made by this tree."""
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.embeddings import write_embedding_columns
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.models.dual_encoder import DualEncoder

    t0 = time.perf_counter()
    index_dir = bc.ensure_corpus(data_dir, CS.DOCS, seed=CS.SEED, log=CS.log)
    off = build_searcher(index_dir, "cuda")
    models = CS.models_phase(off, index_dir, os.path.join(data_dir, "models"))
    del off
    dual = DualEncoder.load(models["dual"], device="cuda")
    write_embedding_columns(index_dir, dual, batch=CS.EMB_BATCH, log=CS.log)
    del dual
    bodies = os.path.join(data_dir, "soak_bodies.json")
    with open(bodies, "w") as fh:
        json.dump(CS.requests_mix(CS.N_REQUESTS), fh)
    print(f"[soak] corpus, models and embeddings in {time.perf_counter() - t0:.1f}s", flush=True)
    return {"index": index_dir, "dual": models["dual"], "cross": models["cross"],
            "forest": models["forest"], "bodies": bodies}


def run_process(tree: str, trees: dict, paths: dict, args, n: int) -> dict:
    """One fresh serving process over the checkout `tree` → its row."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT  # chip_smoke's helpers; the tree's package comes first
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--root",
           os.path.abspath(trees[tree]), "--rounds", str(args.rounds),
           "--row-layout", args.row_layout, *(["--device-join"] if args.device_join else []),
           *[x for k in ("index", "dual", "cross", "forest", "bodies")
             for x in (f"--{k}", paths[k])]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=args.timeout)
        out, rc = proc.stdout + proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"").decode(errors="replace") + (e.stderr or b"").decode(
            errors="replace")
        rc = "timeout"
    result = {"finished": 0, "rounds": [], "error": None}
    for line in out.splitlines():
        if line.startswith("[worker-result] "):
            result = json.loads(line[len("[worker-result] "):])
    log_path = os.path.join(ROOT, "chiprun_out", f"soak_{n}_{tree}.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as fh:
        fh.write(out)
    row = {"run": tree, "rc": rc, "seconds": round(time.perf_counter() - t0, 1),
           "of": args.rounds, **result}
    tail = "\n".join(x for x in out.splitlines()
                     if "Error" in x or "error" in x or "failed" in x or "File " in x)[-3000:]
    print(f"[soak] {json.dumps(row)}\n{tail}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="change,change,change,change,change")
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per process")
    ap.add_argument("--data", default=os.path.join(ROOT, "data", "torch_smoke"))
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--row-layout", choices=["q16", "q8"], default="q16")
    ap.add_argument("--device-join", action="store_true")
    for name in ("root", "index", "dual", "cross", "forest", "bodies"):
        ap.add_argument(f"--{name}", default="")
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    import torch

    if not torch.cuda.is_available():
        print("serve_soak: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    trees = {"change": ROOT, **dict(t.split("=", 1) for t in args.tree)}
    print(f"card: {CS.card_line()}", flush=True)
    paths = prepare(args.data)
    torch.cuda.empty_cache()
    summary = [run_process(tree, trees, paths, args, n)
               for n, tree in enumerate(args.runs.split(","))]
    by_tree: dict = {}
    for row in summary:
        v = by_tree.setdefault(row["run"], {"processes": 0, "finished_all": 0, "qps": []})
        v["processes"] += 1
        if row["finished"] == row["of"]:
            v["finished_all"] += 1
            v["qps"].append(sum(r["qps"] for r in row["rounds"]) / len(row["rounds"]))
    for v in by_tree.values():
        v["mean_qps"] = sum(v["qps"]) / len(v["qps"]) if v["qps"] else None
    print(json.dumps({"card": CS.card_line(), "rounds": args.rounds, "runs": summary,
                      "trees": by_tree}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
