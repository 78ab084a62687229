"""HTTP API (the port of stract_tpu/api/server.py, search route only):

    POST /beta/api/search   SearchQuery JSON (snake_case or camelCase) →
                            {"type": "websites", "webpages": [...], ...}
    GET  /metrics           Prometheus text: request counters, latency, and
                            the launch count of each CUDA kernel

aiohttp app; searches funnel through a PipelinedBatcher whose two workers run
the coordinator's device half and host half, so concurrent requests share
one batched device search."""

from __future__ import annotations

import asyncio
import json
from concurrent.futures import ThreadPoolExecutor

from aiohttp import web

from ..utils.metrics import PrometheusRegistry

from ..ops import kernels
from ..searcher.api import ApiSearcher
from ..searcher.batcher import PipelinedBatcher
from ..searcher.query import SearchQuery


def build_app(searcher: ApiSearcher, max_concurrency: int = 64) -> web.Application:
    app = web.Application()
    registry = PrometheusRegistry()
    search_ok = registry.counter("search_requests_total", "successful searches", status="ok")
    search_err = registry.counter("search_requests_total", "failed searches", status="error")
    latency = registry.histogram("search_latency_seconds", "search latency")
    launches = {name: registry.gauge("kernel_launches", "CUDA kernel launches", kernel=name)
                for name in kernels.LAUNCHES}
    sem = asyncio.Semaphore(max_concurrency)
    pool = ThreadPoolExecutor(max_workers=max_concurrency, thread_name_prefix="api-blk")
    # batches of half the admission limit, so a second batch can form while
    # the first is in flight
    batcher = PipelinedBatcher(searcher.search_phase1, searcher.search_phase2,
                               max_batch=max(1, max_concurrency // 2), window_ms=4.0)

    async def search(request: web.Request):
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid json"}, status=400)
        if not isinstance(body, dict) or not isinstance(body.get("query"), str):
            return web.json_response({"error": "missing or invalid 'query'"}, status=400)
        sq = SearchQuery.from_json(body)
        if not sq.query.strip():
            return web.json_response({"error": "empty query"}, status=400)
        try:
            with latency.time():
                async with sem:
                    loop = asyncio.get_running_loop()
                    result = await loop.run_in_executor(pool, batcher.submit, sq)
            search_ok.inc()
        except Exception as e:  # noqa: BLE001 — a failed search answers 500
            search_err.inc()
            return web.json_response({"error": f"{type(e).__name__}: {e}"}, status=500)
        return web.json_response(result.to_json())

    async def metrics(request: web.Request):
        for name, gauge in launches.items():
            gauge.set(kernels.LAUNCHES[name])
        return web.Response(text=registry.render(), content_type="text/plain")

    async def close(app_):
        batcher.stop()
        pool.shutdown(wait=True)

    app.router.add_post("/beta/api/search", search)
    app.router.add_get("/metrics", metrics)
    app.on_cleanup.append(close)
    return app
