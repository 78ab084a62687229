"""Train MiniLM-L6 serving encoders for the bench corpus, the port of
tools/train_bench_encoders.py: 6 layers, hidden 384, 12 heads, FFN 1536, a
30,522-piece WordPiece vocab fit on the corpus, trained at 128 tokens and
saved with the reference's serving truncations (dual encoder 256 tokens,
cross encoder 128). Nothing is downloaded: the models are trained here on
triples synthesised from the corpus (entrypoint/train_encoders.py).

    python -m stract_tpu_torch.entrypoint.train_bench_encoders \\
        [--docs 10000000] [--steps 400] [--distill-cross] [--device cuda]

Writes <cache>/dual_encoder-<docs> and <cache>/cross_encoder-<docs>
(<cache>: --cache, else $BENCH_CACHE, else .bench_cache at the repository
root; the corpus is built there when absent), evaluates the held-out
pos > neg accuracy of both and the cross encoder's Spearman correlation with
its dual teacher on 192 fresh triples, and prints the JSON summary line of
the reference tool. Exits 2 when either accuracy is below 0.65.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from ..bench_corpus import ensure_corpus
from ..models.bert import BertConfig
from ..models.dual_encoder import MAX_TOKENS as DUAL_MAX
from ..ranking.models.cross_encoder import MAX_TOKENS as CROSS_MAX
from .train_encoders import (
    corpus_tokenizer, synthesize_triples, train_cross_encoder, train_dual_encoder,
)

MIN_HELDOUT_ACC = 0.65


def _log(m):
    print(m, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="stract_tpu_torch.entrypoint.train_bench_encoders")
    ap.add_argument("--docs", type=int, default=10_000_000)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--train-len", type=int, default=128)
    ap.add_argument("--n-triples", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=30522)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-dual", action="store_true")
    ap.add_argument("--cross-steps", type=int, default=None)
    ap.add_argument("--cross-triples", type=int, default=None)
    ap.add_argument("--cross-lr", type=float, default=None)
    # seed the cross trunk from the trained dual's
    ap.add_argument("--warm-start-cross", action="store_true")
    # + dense regression toward the dual teacher's scaled cosines
    ap.add_argument("--distill-cross", action="store_true")
    ap.add_argument("--distill-alpha", type=float, default=2.0,
                    help="MSE weight against the pairwise term")
    ap.add_argument("--cross-pool", choices=("cls", "mean"), default="cls",
                    help="score readout; 'mean' matches a mean-pooled warm-start trunk")
    ap.add_argument("--cache", default=None, help="corpus and model directory")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    return ap


def run(args, index_path: str, out_dir: str, tokenizer=None, log=_log) -> tuple:
    """Train the dual then the cross encoder on the corpus at `index_path`
    into `out_dir` and evaluate both → (summary, timing). `tokenizer`: a
    fitted vocab (else one is fit on 50,000 corpus docs); `timing`: the two
    step loops' steps and seconds."""
    from scipy.stats import spearmanr

    from ..index.inverted import InvertedIndex
    from ..models.dual_encoder import DualEncoder
    from ..ranking.models.cross_encoder import CrossEncoderModel

    t0 = time.time()
    index = InvertedIndex(index_path, "cpu")
    cfg = BertConfig.mini_lm(vocab_size=args.vocab)
    if tokenizer is None:
        log(f"[train] fitting {args.vocab}-entry WordPiece vocab on corpus sample")
        tokenizer = corpus_tokenizer(index, vocab_size=args.vocab, seed=args.seed)
        log(f"[train] vocab ready ({len(tokenizer.vocab)} pieces, {time.time() - t0:.0f}s)")

    dual_dir = os.path.join(out_dir, f"dual_encoder-{args.docs}")
    cross_dir = os.path.join(out_dir, f"cross_encoder-{args.docs}")
    timing = {"dual": {}, "cross": {}}
    if args.skip_dual and os.path.exists(os.path.join(dual_dir, "config.json")):
        losses_d = [float("nan")]
    else:
        losses_d = train_dual_encoder(
            index, dual_dir, steps=args.steps, batch=2 * args.batch, max_len=args.train_len,
            n_triples=args.n_triples, cfg=cfg, seed=args.seed, lr=args.lr,
            tokenizer=tokenizer, save_max_len=DUAL_MAX, log=log, device=args.device,
            timing=timing["dual"])
    cross_cfg = dataclasses.replace(cfg, score_pool=args.cross_pool)
    losses_c = train_cross_encoder(
        index, cross_dir, steps=args.cross_steps or args.steps, batch=args.batch,
        max_len=args.train_len, n_triples=args.cross_triples or args.n_triples, cfg=cross_cfg,
        seed=args.seed, lr=args.cross_lr or args.lr, tokenizer=tokenizer,
        save_max_len=CROSS_MAX, log=log,
        warm_start=dual_dir if (args.warm_start_cross or args.distill_cross) else None,
        distill=args.distill_cross, distill_alpha=args.distill_alpha, device=args.device,
        timing=timing["cross"])

    # held-out sanity: the trained models must rank positives above negatives
    # on fresh triples (chance = 0.5)
    held = synthesize_triples(index, 192, seed=args.seed + 991)
    dual = DualEncoder.load(dual_dir, device=args.device)
    qs = dual.embed([t[0] for t in held])
    ps = dual.embed([t[1] for t in held])
    ns = dual.embed([t[2] for t in held])
    dual_acc = float(((qs * ps).sum(1) > (qs * ns).sum(1)).mean())
    cross = CrossEncoderModel.load(cross_dir, device=args.device)
    sp = cross.score_pairs([(q, p) for q, p, _ in held])
    sn = cross.score_pairs([(q, n) for q, _, n in held])
    cross_acc = float((sp > sn).mean())
    # the distilled student's agreement with its teacher's held-out ordering
    t_scores = np.concatenate([(qs * ps).sum(1), (qs * ns).sum(1)])
    teach_rho = float(spearmanr(np.concatenate([sp, sn]), t_scores).statistic)
    log(f"[train] held-out pos>neg: dual {dual_acc:.3f}, cross {cross_acc:.3f} "
        f"(student-vs-teacher spearman {teach_rho:.3f})")

    summary = {
        "shape": f"bert-L{cfg.num_layers}-H{cfg.hidden_size}-A{cfg.num_heads}-V{cfg.vocab_size}",
        "dual_max_len": DUAL_MAX, "cross_max_len": CROSS_MAX,
        "steps": args.steps, "n_triples": args.n_triples,
        "cross_steps": args.cross_steps or args.steps,
        "cross_triples": args.cross_triples or args.n_triples,
        "dual_loss": None if args.skip_dual else
            [round(float(np.mean(losses_d[:10])), 4), round(float(np.mean(losses_d[-10:])), 4)],
        "cross_loss": [round(float(np.mean(losses_c[:10])), 4),
                       round(float(np.mean(losses_c[-10:])), 4)],
        "dual_heldout_acc": round(dual_acc, 4), "cross_heldout_acc": round(cross_acc, 4),
        "cross_vs_teacher_spearman": round(teach_rho, 4),
        "cross_pool": args.cross_pool,
        "seconds": round(time.time() - t0, 1),
    }
    return summary, timing


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cache = args.cache or os.environ.get("BENCH_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".bench_cache")
    index_path = ensure_corpus(cache, args.docs, log=_log)
    summary, _ = run(args, index_path, cache)
    print(json.dumps(summary))
    if summary["dual_heldout_acc"] < MIN_HELDOUT_ACC or \
            summary["cross_heldout_acc"] < MIN_HELDOUT_ACC:
        _log(f"[train] WARNING: held-out accuracy below {MIN_HELDOUT_ACC}: "
             "inspect before serving")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
