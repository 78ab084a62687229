"""HTTP API (the port of stract_tpu/api/server.py):

    POST /beta/api/search              SearchQuery JSON (snake_case or camelCase,
                                       `optic` included) → {"type": "websites",
                                       "webpages": [...], ...}
    POST /beta/api/search/widget       {"query"} → {"widget": calculator or
         /beta/api/widget              thesaurus answer, or null}
    POST /beta/api/search/sidebar      {"query"} → {"sidebar": entity, StackOverflow
                                       answer, or null}
    POST /beta/api/search/spellcheck   {"query"} → {"correction": ...}
    GET, POST /beta/api/autosuggest    ?q= or {"q"} → [{"raw": suggestion}]
    GET  /beta/api/autosuggest/browser ?q= → [q, [suggestions]] (OpenSearch)
    POST /beta/api/webgraph/host/similar  {"hosts": up to 32, "topN"} → [{"host",
                                       "score"}]; other inputs answer 400
    GET  /beta/api/webgraph/host/knows ?host= → {"type": "known" or "unknown", ...}
    POST /beta/api/webgraph/{host,page}/{ingoing,outgoing}
                                       ?host= / ?page= or {"host"} / {"page"} →
                                       [{"from", "to", "relFlags"}], at most 1,024;
                                       a host's scheme is stripped; no key: 400
    POST /beta/api/hosts/export        {"hostRankings"} → optic text
    POST /beta/api/explore/export      {"chosenHosts", "similarHosts"} → optic text
    GET  /beta/api/entity_image        ?imageId= → image/webp bytes, or 404
    POST /improvement/store            {"query", "urls"} → a 32-hex-digit qid
    POST /improvement/click            {"qid", "click"} → {"ok": true}
    GET  /metrics                      Prometheus text: request counters, latency,
                                       the daily and monthly active users, and
                                       the launch count of each CUDA kernel
    GET  /health                       "ok"
    GET  /beta/api/docs, /beta/api/docs/openapi.json   the docs page, the spec
    GET  /, /search, /explore, /settings, /about, /webmasters, /privacy
                                       the UI (frontend/index.html)
    GET  /static/{name}                a file of frontend/ (no path traversal)

aiohttp app with the permissive CORS of the reference; searches funnel
through a PipelinedBatcher whose two workers run the coordinator's device
half and host half, so concurrent requests share one batched device search.
Every other route that reads a model, a graph, a store or a file runs in the
same executor under the same admission limit, so none blocks the event
loop. Each search observes its client in the daily and monthly user counts
(api/user_count.py), which /metrics reads as its `active_users` gauges; the
improvement log stays in memory, as the JAX package's (api/improvement.py). The UI is the port's own copy of the JAX
package's frontend/, byte for byte."""

from __future__ import annotations

import asyncio
import json
import os
from concurrent.futures import ThreadPoolExecutor

from aiohttp import web

from ..ops import kernels
from ..searcher.api import ApiSearcher
from ..searcher.batcher import PipelinedBatcher
from ..searcher.query import SearchQuery
from ..utils.metrics import PrometheusRegistry
from ..webgraph.edge import RelFlags
from .docs import docs_html, openapi_spec
from .improvement import ImprovementLog
from .user_count import UserCount

# seed hosts per similar-hosts request: each one adds up to 512 x 512
# co-citation lookups to the pool, inside an executor slot searches share
MAX_SIMILAR_HOSTS_SEEDS = 32
MAX_LINKS = 1024  # edges a link route answers (api/webgraph.rs)
FRONTEND = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "frontend")
UI_ROUTES = ("/", "/search", "/explore", "/settings", "/about", "/webmasters", "/privacy")
_MIME = {".js": "text/javascript", ".css": "text/css", ".xml": "application/xml",
         ".html": "text/html", ".svg": "image/svg+xml", ".png": "image/png"}


def graph_edges(graph, node: str, direction: str) -> list:
    """The first MAX_LINKS edges into (`in`) or out of (`out`) `node` of a
    Webgraph, as the link routes answer them ([] without a graph)."""
    if graph is None:
        return []
    links = graph.backlinks(node) if direction == "in" else graph.forwardlinks(node)
    out = []
    for other_rank, flags in links[:MAX_LINKS]:
        other = graph.name_of(other_rank)
        frm, to = (other, node) if direction == "in" else (node, other)
        out.append({"from": frm, "to": to,
                    "relFlags": [f.name for f in RelFlags if flags & f.value]})
    return out


def _read(path: str) -> bytes | None:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


def build_app(searcher: ApiSearcher, autosuggest=None, similar_hosts=None, page_graph=None,
              image_store=None, max_concurrency: int = 64) -> web.Application:
    """autosuggest: an Autosuggest (or None: no suggestions); similar_hosts:
    an InboundSimilarity over the host graph, which also serves the host
    link routes (or None: no similar hosts, no host links); page_graph: the
    page-level Webgraph of the page link routes; image_store: an ImageStore
    or a RemoteEntityImageStore (anything with `get(key) -> bytes | None`)."""
    app = web.Application()
    registry = PrometheusRegistry()
    search_ok = registry.counter("search_requests_total", "successful searches", status="ok")
    search_err = registry.counter("search_requests_total", "failed searches", status="error")
    latency = registry.histogram("search_latency_seconds", "search latency")
    launches = {name: registry.gauge("kernel_launches", "CUDA kernel launches", kernel=name)
                for name in kernels.LAUNCHES}
    user_count = UserCount()
    active = {window: registry.gauge("active_users", "distinct users this day / month",
                                     window=window) for window in ("daily", "monthly")}
    improvements = ImprovementLog()
    host_graph = similar_hosts.graph if similar_hosts is not None else None
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
        user_count.observe(request.headers.get("X-Forwarded-For", request.remote or ""))
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

    async def autosuggest_browser(request: web.Request):
        """OpenSearch suggestions (api/autosuggest.rs:107-116)."""
        q = request.query.get("q", "")
        if not q or autosuggest is None:
            return web.json_response(["", []])
        return web.json_response([q, await blocking(autosuggest.suggest, q)])

    # ---- the webgraph: similar hosts, known hosts, links (api/webgraph.rs) ----------
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

    async def knows_host(request: web.Request):
        host = request.query.get("host", "")
        if host_graph is None:
            return web.json_response({"type": "unknown"})
        known = await blocking(host_graph.rank_of, host) is not None
        return web.json_response({"type": "known" if known else "unknown", "host": host})

    def links_route(graph, key: str, direction: str):
        async def route(request: web.Request):
            node = request.query.get(key, "")
            if not node:
                try:
                    node = (await request.json()).get(key, "")
                except (json.JSONDecodeError, AttributeError):
                    node = ""
            if not node:
                return web.json_response({"error": f"missing {key}"}, status=400)
            if key == "host":  # host-graph nodes carry no scheme
                node = node.split("://", 1)[-1].rstrip("/")
            return web.json_response(await blocking(graph_edges, graph, node, direction))
        return route

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

    # ---- entity image (api/search.rs:351-375) --------------------------------------
    async def entity_image(request: web.Request):
        image_id = request.query.get("imageId", request.query.get("image_id", ""))
        if image_store is None or not image_id:
            return web.Response(status=404)
        data = await blocking(image_store.get, image_id)
        if data is None:
            return web.Response(status=404)
        return web.Response(body=data, content_type="image/webp")

    # ---- the improvement log (api/improvement.rs:64-80) -----------------------------
    async def improvement_store(request: web.Request):
        body = await json_body(request)
        return web.Response(text=await blocking(improvements.store, body.get("query", ""),
                                                body.get("urls", [])))

    async def improvement_click(request: web.Request):
        body = await json_body(request)
        await blocking(improvements.log, body.get("qid", ""), body.get("click", ""))
        return web.json_response({"ok": True})

    # ---- metrics, health, docs, the UI ---------------------------------------------
    async def metrics(request: web.Request):
        for name, gauge in launches.items():
            gauge.set(kernels.LAUNCHES[name])
        active["daily"].set(user_count.daily_active())
        active["monthly"].set(user_count.monthly_active())
        return web.Response(text=registry.render(), content_type="text/plain")

    async def health(request: web.Request):
        return web.Response(text="ok")

    async def docs_openapi(request: web.Request):
        return web.json_response(await blocking(openapi_spec))

    async def docs_page(request: web.Request):
        return web.Response(text=await blocking(docs_html), content_type="text/html")

    async def ui(request: web.Request):
        page = await blocking(_read, os.path.join(FRONTEND, "index.html"))
        return web.Response(text=page.decode("utf-8"), content_type="text/html")

    async def static_file(request: web.Request):
        name = os.path.basename(request.match_info["name"])  # no traversal
        data = await blocking(_read, os.path.join(FRONTEND, name))
        if data is None:
            return web.Response(status=404)
        return web.Response(body=data, content_type=_MIME.get(os.path.splitext(name)[1],
                                                              "application/octet-stream"))

    @web.middleware
    async def cors(request, handler):
        """Permissive CORS (reference api/mod.rs:100-113 CorsLayer::permissive)."""
        resp = web.Response() if request.method == "OPTIONS" else await handler(request)
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "*"
        return resp

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
    app.router.add_get("/beta/api/webgraph/host/knows", knows_host)
    for level, graph in (("host", host_graph), ("page", page_graph)):
        for way, direction in (("ingoing", "in"), ("outgoing", "out")):
            app.router.add_post(f"/beta/api/webgraph/{level}/{way}",
                                links_route(graph, level, direction))
    app.router.add_post("/beta/api/hosts/export", hosts_export)
    app.router.add_post("/beta/api/explore/export", explore_export)
    app.router.add_get("/beta/api/entity_image", entity_image)
    app.router.add_get("/beta/api/autosuggest/browser", autosuggest_browser)
    app.router.add_post("/improvement/store", improvement_store)
    app.router.add_post("/improvement/click", improvement_click)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/health", health)
    app.router.add_get("/beta/api/docs/openapi.json", docs_openapi)
    app.router.add_get("/beta/api/docs", docs_page)
    for path in UI_ROUTES:
        app.router.add_get(path, ui)
    app.router.add_get("/static/{name}", static_file)
    app.middlewares.append(cors)
    app.on_cleanup.append(close)
    return app
