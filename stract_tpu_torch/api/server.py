"""HTTP API (the port of stract_tpu/api/server.py):

    POST /beta/api/search              SearchQuery JSON (snake_case or camelCase,
                                       `optic` included) → {"type": "websites",
                                       "webpages": [...], ...}
    POST /beta/api/search/widget       {"query"} → {"widget": calculator or
         /beta/api/widget              thesaurus answer, or null}
    POST /beta/api/search/sidebar      {"query"} → {"sidebar": ...}
    POST /beta/api/search/spellcheck   {"query"} → {"correction": ...}
    GET, POST /beta/api/autosuggest    ?q= or {"q"} → [{"raw": suggestion}]
    POST /beta/api/webgraph/host/similar  {"hosts": up to 32, "topN"} → [{"host",
                                       "score"}]; other inputs answer 400
    POST /beta/api/hosts/export        {"hostRankings"} → optic text
    POST /beta/api/explore/export      {"chosenHosts", "similarHosts"} → optic text
    GET  /metrics                      Prometheus text: request counters, latency,
                                       and the launch count of each CUDA kernel

aiohttp app; searches funnel through a PipelinedBatcher whose two workers run
the coordinator's device half and host half, so concurrent requests share
one batched device search. The side answers run in the same executor under
the same admission limit, so none blocks the event loop. The JAX package's
other routes (the page graph, entity images, the improvement log, docs and
the UI) are not ported (ROADMAP queue 1 item 3b)."""

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

# seed hosts per similar-hosts request: each one adds up to 512 x 512
# co-citation lookups to the pool, inside an executor slot searches share
MAX_SIMILAR_HOSTS_SEEDS = 32


def build_app(searcher: ApiSearcher, autosuggest=None, similar_hosts=None,
              max_concurrency: int = 64) -> web.Application:
    """autosuggest: an Autosuggest (or None: no suggestions); similar_hosts:
    an InboundSimilarity over the host graph (or None: no similar hosts)."""
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

    async def blocking(fn, *args):
        async with sem:
            return await asyncio.get_running_loop().run_in_executor(pool, fn, *args)

    async def json_body(request: web.Request) -> dict:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(text="invalid json") from None
        if not isinstance(body, dict):
            raise web.HTTPBadRequest(text="the body is not a JSON object")
        return body

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
                result = await blocking(batcher.submit, sq)
            search_ok.inc()
        except Exception as e:  # noqa: BLE001 — a failed search answers 500
            search_err.inc()
            return web.json_response({"error": f"{type(e).__name__}: {e}"}, status=500)
        return web.json_response(result.to_json())

    # ---- widget / sidebar / spellcheck -------------------------------------------
    async def widget(request: web.Request):
        body = await json_body(request)
        return web.json_response({"widget": await blocking(searcher.widget,
                                                           body.get("query", ""))})

    async def sidebar(request: web.Request):
        body = await json_body(request)
        return web.json_response({"sidebar": await blocking(searcher.sidebar_for,
                                                            body.get("query", ""))})

    async def spellcheck(request: web.Request):
        body = await json_body(request)
        c = await blocking(searcher.spell_correction, body.get("query", ""))
        return web.json_response({"correction": c.to_json() if c else None})

    async def autosuggest_route(request: web.Request):
        q = request.query.get("q", "")
        if not q and request.method == "POST":
            try:
                q = (await request.json()).get("q", "")
            except (json.JSONDecodeError, AttributeError):
                q = ""
        if autosuggest is None:
            return web.json_response([])
        # a short prefix sorts every query that shares it: off the loop
        suggestions = await blocking(autosuggest.suggest, q)
        return web.json_response([{"raw": s} for s in suggestions])

    # ---- similar hosts (the explore page) -------------------------------------------
    async def similar_hosts_route(request: web.Request):
        body = await json_body(request)
        hosts = body.get("hosts", [])
        top_k = body.get("topN", body.get("top_k", 20))
        if not isinstance(hosts, list) or not all(isinstance(h, str) for h in hosts):
            raise web.HTTPBadRequest(text="'hosts' is not a list of strings")
        if len(hosts) > MAX_SIMILAR_HOSTS_SEEDS:
            raise web.HTTPBadRequest(text=f"more than {MAX_SIMILAR_HOSTS_SEEDS} hosts")
        if isinstance(top_k, bool) or not isinstance(top_k, int) or top_k < 1:
            raise web.HTTPBadRequest(text="'topN' is not a positive integer")
        if similar_hosts is None:
            return web.json_response([])
        res = await blocking(similar_hosts.similar_hosts, hosts, top_k)
        return web.json_response([{"host": h, "score": s} for h, s in res])

    # ---- optic export (api/hosts.rs:39-48, api/explore.rs:37-72) -------------------
    async def hosts_export(request: web.Request):
        from ..optics.optic import HostRankings, Optic

        body = await json_body(request)
        hr = HostRankings.from_json(body.get("hostRankings", body.get("host_rankings", {})))
        return web.Response(text=Optic(host_rankings=hr).to_string(), content_type="text/plain")

    async def explore_export(request: web.Request):
        from ..optics.optic import Action, HostRankings, Matching, MatchLocation, Optic, Rule

        body = await json_body(request)
        chosen = body.get("chosenHosts", body.get("chosen_hosts", []))
        similar = body.get("similarHosts", body.get("similar_hosts", []))
        blocks = [[Matching(MatchLocation.DOMAIN, f"|{site}|")]
                  for site in list(similar) + list(chosen)]
        optic = Optic(rules=[Rule(blocks, Action("boost", 0))],
                      host_rankings=HostRankings(liked=list(chosen)), discard_non_matching=True)
        return web.Response(text=optic.to_string(), content_type="text/plain")

    async def metrics(request: web.Request):
        for name, gauge in launches.items():
            gauge.set(kernels.LAUNCHES[name])
        return web.Response(text=registry.render(), content_type="text/plain")

    async def close(app_):
        batcher.stop()
        pool.shutdown(wait=True)

    app.router.add_post("/beta/api/search", search)
    app.router.add_post("/beta/api/search/widget", widget)
    app.router.add_post("/beta/api/widget", widget)  # the older clients' path
    app.router.add_post("/beta/api/search/sidebar", sidebar)
    app.router.add_post("/beta/api/search/spellcheck", spellcheck)
    app.router.add_get("/beta/api/autosuggest", autosuggest_route)
    app.router.add_post("/beta/api/autosuggest", autosuggest_route)
    app.router.add_post("/beta/api/webgraph/host/similar", similar_hosts_route)
    app.router.add_post("/beta/api/hosts/export", hosts_export)
    app.router.add_post("/beta/api/explore/export", explore_export)
    app.router.add_get("/metrics", metrics)
    app.on_cleanup.append(close)
    return app
