"""Command line of the port.

    python -m stract_tpu_torch.main serve --index DIR --port N --device cuda \
        [--dual-encoder DIR] [--cross-encoder DIR] [--lambdamart FILE] \
        [--row-layout {q16,q8}] [--device-join] [--ub-lambda X] [--verify-c N] \
        [--merge-kernel]
    python -m stract_tpu_torch.main train-encoders {dual,cross,both} INDEX OUT \
        [--steps 120] [--batch 16] [--triples 512] [--device cuda]
    python -m stract_tpu_torch.main centrality \
        {harmonic,approx-harmonic,harmonic-nearest-seed} CONFIG [--device cuda]

`serve` is the one-process deployment (index + searcher + coordinator + HTTP
API in one process) restricted to the search route: POST /beta/api/search
and GET /metrics. DIR is an index directory of either package
(index_meta.json + segments/). --device cpu runs the plain PyTorch versions
of the kernels; --device cuda needs a card and runs the hand-written kernels.

--row-layout, --device-join, --ub-lambda, --verify-c and --merge-kernel
choose the shard search's configuration (index/inverted.py InvertedIndex:
the JAX package's STRACT_TPU_ROW_LAYOUT, _DEVICE_JOIN, _UB_LAMBDA,
_VERIFY_C and _MERGE_KERNEL switches); the defaults are q16 rows, the host
factor join, no UB scoring, verify all, stage A's join without the merge.

The model flags are the coordinator's ApiConfig fields dual_encoder_path,
cross_encoder_path and lambdamart_path, loaded as the JAX package's api
entry point loads them: the dual encoder into the recall stage, the cross
encoder into the precision stage, the forest (LightGBM text when the file
holds "Tree=", else JSON) into both. Encoder dirs are native checkpoints of
either package or HF safetensors dirs. Recall's embedding similarity reads
the index's embedding columns (index/embeddings.py writes them).

`train-encoders` is the JAX package's subcommand of the same name
(entrypoint/train_encoders.py): it trains the dual encoder, the cross
encoder or both (each on its own, at the tiny config) on triples
synthesised from INDEX and saves them under OUT/dual_encoder and
OUT/cross_encoder; --device cuda needs a card.

`centrality` is the JAX package's subcommand of the same name
(entrypoint/centrality.py): CONFIG is a CentralityConfig TOML
(configs/centrality.toml); the job reads the webgraph at webgraph_path and
writes the kv store at output_path, and prints what the JAX package prints.
--device cuda needs a card.
"""

from __future__ import annotations

import argparse
import asyncio
import threading

from aiohttp import web


def build_searcher(index_dir: str, device: str, dual_encoder: str | None = None,
                   cross_encoder: str | None = None, lambdamart: str | None = None,
                   row_layout: str = "q16", device_join: bool = False, ub_lambda: float = 0.0,
                   verify_c: int = 0, merge_kernel: bool = False):
    """The serving stack over one local shard, with the ranking pipeline's
    models loaded from the given paths onto `device` and the shard search in
    the given configuration (InvertedIndex's arguments) → ApiSearcher."""
    from .ranking.pipeline import PrecisionStage, RankingPipeline, RecallStage

    from .index.inverted import InvertedIndex
    from .searcher.api import ApiSearcher
    from .searcher.distributed import LocalShardedSearcher
    from .searcher.local import LocalSearcher

    index = InvertedIndex(index_dir, device=device, row_layout=row_layout,
                          device_join=device_join, ub_lambda=ub_lambda, verify_c=verify_c,
                          merge_kernel=merge_kernel)
    for seg in index.segments:
        index.device_segment_for(seg)  # upload before the first request
    recall, precision = RecallStage(), PrecisionStage()
    if dual_encoder:
        from .models.dual_encoder import DualEncoder

        recall.dual_encoder = DualEncoder.load(dual_encoder, device=device)
    if cross_encoder:
        from .ranking.models.cross_encoder import CrossEncoderModel

        precision.cross_encoder = CrossEncoderModel.load(cross_encoder, device=device)
    if lambdamart:
        from .ranking.models.lambdamart import LambdaMART

        recall.lambdamart = precision.lambdamart = LambdaMART.load(lambdamart, device=device)
    return ApiSearcher(LocalShardedSearcher([LocalSearcher(index)]),
                       RankingPipeline(recall, precision))


class ServerThread:
    """The HTTP app on its own event loop in a background thread (tests and
    chip_smoke.py drive the real route in process). stop() shuts the app
    down and joins the thread."""

    def __init__(self, app: web.Application, host: str = "127.0.0.1", port: int = 0):
        self._app = app
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._runner = None
        self.port = port
        self._host = host
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=60) or self._error is not None:
            raise RuntimeError(f"server did not start: {self._error}")

    def _run(self):
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._start())
        except Exception as e:  # noqa: BLE001 — reported by __init__
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self._loop.run_forever()
        self._loop.run_until_complete(self._runner.cleanup())
        self._loop.close()

    async def _start(self):
        self._runner = web.AppRunner(self._app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("server thread did not stop")


def run_centrality(mode: str, config: str, device: str = "cuda",
                   timings: dict | None = None) -> dict:
    """`main.py centrality MODE CONFIG`: the job over the config's paths →
    the centrality of each node (also printed as the JAX package prints it)."""
    from .config import load_config
    from .entrypoint.centrality import (run_approx_harmonic, run_harmonic,
                                        run_harmonic_nearest_seed)

    cfg = load_config("centrality", config)
    if mode == "harmonic":
        c = run_harmonic(cfg.webgraph_path, cfg.output_path, cfg.precision, device=device,
                         timings=timings)
    elif mode == "harmonic-nearest-seed":
        c = run_harmonic_nearest_seed(cfg.webgraph_path, cfg.original_centrality_path,
                                      cfg.output_path, cfg.discount_factor, device=device)
    else:
        c = run_approx_harmonic(cfg.webgraph_path, cfg.output_path, cfg.num_samples,
                                device=device, timings=timings)
    print(f"centrality for {len(c)} nodes → {cfg.output_path}")
    return c


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stract_tpu_torch.main")
    sub = ap.add_subparsers(dest="role", required=True)
    sp = sub.add_parser("serve", help="index + coordinator + HTTP search API in one process")
    sp.add_argument("--index", required=True, help="index directory")
    sp.add_argument("--port", type=int, default=3000)
    sp.add_argument("--host", default="0.0.0.0")
    sp.add_argument("--device", default="cuda", help="cuda or cpu")
    sp.add_argument("--dual-encoder", default="", help="dual encoder dir (recall stage)")
    sp.add_argument("--cross-encoder", default="", help="cross encoder dir (precision stage)")
    sp.add_argument("--lambdamart", default="", help="forest file, LightGBM text or JSON")
    sp.add_argument("--row-layout", choices=["q16", "q8"], default="q16",
                    help="posting rows on the device: 12 or 8 bytes a row")
    sp.add_argument("--device-join", action="store_true",
                    help="join stage B's and pass 2's factors on the device")
    sp.add_argument("--ub-lambda", type=float, default=0.0,
                    help="> 0: block-max UB scoring in stage A, bounds scaled by this")
    sp.add_argument("--verify-c", type=int, default=0,
                    help="> 0: stage B verifies only stage A's top N candidates")
    sp.add_argument("--merge-kernel", action="store_true",
                    help="stage A joins through the P-way bitonic merge of its tiles")
    tp = sub.add_parser("train-encoders", help="fine-tune dual/cross encoders from an index")
    tp.add_argument("kind", choices=["dual", "cross", "both"])
    tp.add_argument("index_path")
    tp.add_argument("out_dir")
    tp.add_argument("--steps", type=int, default=120)
    tp.add_argument("--batch", type=int, default=16)
    tp.add_argument("--triples", type=int, default=512)
    tp.add_argument("--device", default="cuda", help="cuda or cpu")
    cp = sub.add_parser("centrality", help="harmonic centrality jobs")
    cp.add_argument("mode", choices=["harmonic", "approx-harmonic", "harmonic-nearest-seed"])
    cp.add_argument("config")
    cp.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    if args.role == "centrality":
        run_centrality(args.mode, args.config, args.device)
        return

    if args.role == "train-encoders":
        import os

        from .entrypoint import train_encoders as te

        if args.kind in ("dual", "both"):
            te.train_dual_encoder(args.index_path, os.path.join(args.out_dir, "dual_encoder"),
                                  steps=args.steps, batch=args.batch, n_triples=args.triples,
                                  device=args.device)
        if args.kind in ("cross", "both"):
            te.train_cross_encoder(args.index_path, os.path.join(args.out_dir, "cross_encoder"),
                                   steps=args.steps, batch=args.batch, n_triples=args.triples,
                                   device=args.device)
        return

    from .api.server import build_app

    app = build_app(build_searcher(args.index, args.device, args.dual_encoder,
                                   args.cross_encoder, args.lambdamart, args.row_layout,
                                   args.device_join, args.ub_lambda, args.verify_c,
                                   args.merge_kernel))
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
