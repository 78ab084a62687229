"""API documentation — the port's copy of stract_tpu/api/docs.py, the same
spec and page byte for byte (role of reference api/docs.rs — utoipa-generated OpenAPI
served under /beta/api/docs — plus the docs/api Docusaurus site, rendered here
as a self-contained HTML page with no external assets)."""

from __future__ import annotations

_SEARCH_QUERY_SCHEMA = {
    "type": "object",
    "required": ["query"],
    "properties": {
        "query": {"type": "string", "description": "The search query. Supports site:, "
                  "intitle:, inbody:, inurl:, exacturl, \"phrases\", -exclusion, a||b "
                  "or-patterns and !bangs."},
        "page": {"type": "integer", "default": 0},
        "numResults": {"type": "integer", "default": 20, "maximum": 100},
        "selectedRegion": {"type": "integer", "default": 0},
        "optic": {"type": "string", "description": "Optic source applied to this search."},
        "safeSearch": {"type": "boolean", "default": False},
        "returnRankingSignals": {"type": "boolean", "default": False},
        "countResultsExact": {"type": "boolean", "default": False},
        "signalCoefficients": {"type": "object", "additionalProperties": {"type": "number"}},
    },
}

_WEBPAGE_SCHEMA = {
    "type": "object",
    "properties": {
        "url": {"type": "string"}, "title": {"type": "string"},
        "site": {"type": "string"}, "domain": {"type": "string"},
        "snippet": {"type": "string"},
        "snippet_html": {"type": "string", "description": "Snippet with <b> term highlights."},
        "score": {"type": "number"},
        "rankingSignals": {"type": "object", "additionalProperties": {"type": "number"}},
        "richSnippet": {
            "type": "object",
            "description": "Schema.org-derived rich result (StackOverflow QA "
                           "for stackoverflow.com QAPage pages — reference "
                           "search_prettifier RichSnippet).",
            "properties": {
                "type": {"const": "stackOverflowQA"},
                "question": {"type": "object", "properties": {
                    "body": {"type": "array", "items": {"type": "object", "properties": {
                        "kind": {"enum": ["text", "code"]}, "value": {"type": "string"}}}}}},
                "answers": {"type": "array", "items": {"type": "object", "properties": {
                    "body": {"type": "array"}, "date": {"type": "string"},
                    "upvotes": {"type": "integer"}, "url": {"type": "string"},
                    "accepted": {"type": "boolean"}}}},
            },
        },
    },
}

_SEARCH_RESULT_SCHEMA = {
    "oneOf": [
        {"type": "object", "description": "Websites result", "properties": {
            "type": {"const": "websites"},
            "webpages": {"type": "array", "items": _WEBPAGE_SCHEMA},
            "numHits": {"type": "object", "properties": {
                "value": {"type": "integer"}, "exact": {"type": "boolean"}}},
            "searchDurationMs": {"type": "number"},
            "hasMoreResults": {"type": "boolean"},
        }},
        {"type": "object", "description": "Bang redirect", "properties": {
            "type": {"const": "bang"}, "redirectTo": {"type": "string"}}},
    ]
}

_EDGE_SCHEMA = {
    "type": "object",
    "properties": {"from": {"type": "string"}, "to": {"type": "string"},
                   "relFlags": {"type": "array", "items": {"type": "string"}}},
}


def _post(summary, body_schema=None, response_schema=None, description=""):
    op = {"summary": summary}
    if description:
        op["description"] = description
    if body_schema:
        op["requestBody"] = {"content": {"application/json": {"schema": body_schema}}}
    if response_schema:
        op["responses"] = {"200": {"description": "OK", "content": {
            "application/json": {"schema": response_schema}}}}
    return {"post": op}


def _get(summary, params=(), description=""):
    op = {"summary": summary}
    if description:
        op["description"] = description
    if params:
        op["parameters"] = [
            {"name": n, "in": "query", "schema": {"type": "string"}} for n in params
        ]
    return {"get": op}


def openapi_spec() -> dict:
    paths = {
        "/beta/api/search": _post(
            "Web search", _SEARCH_QUERY_SCHEMA, _SEARCH_RESULT_SCHEMA,
            "The main search endpoint: parses the query, fans out to every index "
            "shard, ranks with the fused multi-signal pipeline and returns the "
            "requested result page with snippets.",
        ),
        "/beta/api/search/widget": _post("Widget", {"type": "object", "properties": {
            "query": {"type": "string"}}}, None,
            "Calculator and thesaurus widgets for applicable queries."),
        "/beta/api/search/sidebar": _post("Entity sidebar", {"type": "object", "properties": {
            "query": {"type": "string"}}}, None,
            "Wikipedia-derived entity card for the query, when confident."),
        "/beta/api/search/spellcheck": _post("Spell correction", {"type": "object", "properties": {
            "query": {"type": "string"}}}),
        "/beta/api/autosuggest": {** _get("Query autosuggest", ["q"]),
                                  **_post("Query autosuggest (POST)")},
        "/beta/api/autosuggest/browser": _get(
            "OpenSearch suggestions", ["q"],
            "Browser suggestion format: [query, [suggestions...]]."),
        "/beta/api/webgraph/host/similar": _post(
            "Similar hosts", {"type": "object", "properties": {
                "hosts": {"type": "array", "items": {"type": "string"}},
                "topN": {"type": "integer"}}}, None,
            "Hosts with similar inbound-link profiles (webgraph inbound similarity)."),
        "/beta/api/webgraph/host/knows": _get("Host known to webgraph", ["host"]),
        "/beta/api/webgraph/host/ingoing": _post(
            "Host backlinks", None,
            {"type": "array", "items": _EDGE_SCHEMA},
            "Incoming host-level edges; ?host= or JSON body {host}."),
        "/beta/api/webgraph/host/outgoing": _post(
            "Host forwardlinks", None, {"type": "array", "items": _EDGE_SCHEMA}),
        "/beta/api/webgraph/page/ingoing": _post(
            "Page backlinks", None, {"type": "array", "items": _EDGE_SCHEMA}),
        "/beta/api/webgraph/page/outgoing": _post(
            "Page forwardlinks", None, {"type": "array", "items": _EDGE_SCHEMA}),
        "/beta/api/hosts/export": _post(
            "Export host rankings as optic", {"type": "object", "properties": {
                "hostRankings": {"type": "object", "properties": {
                    "liked": {"type": "array", "items": {"type": "string"}},
                    "disliked": {"type": "array", "items": {"type": "string"}},
                    "blocked": {"type": "array", "items": {"type": "string"}}}}}},
            None, "Returns .optic source text."),
        "/beta/api/explore/export": _post(
            "Export explored sites as optic", {"type": "object", "properties": {
                "chosenHosts": {"type": "array", "items": {"type": "string"}},
                "similarHosts": {"type": "array", "items": {"type": "string"}}}},
            None, "Returns .optic source text."),
        "/beta/api/entity_image": _get("Entity image blob", ["imageId"]),
        "/improvement/click": _post("Log result click", {"type": "object", "properties": {
            "qid": {"type": "string"}, "click": {"type": "string"}}}),
        "/improvement/store": _post("Store query for LTR", {"type": "object", "properties": {
            "query": {"type": "string"},
            "urls": {"type": "array", "items": {"type": "string"}}}}),
        "/metrics": _get("Prometheus metrics"),
        "/health": _get("Liveness probe"),
    }
    return {
        "openapi": "3.0.0",
        "info": {
            "title": "stract_tpu API",
            "version": "0.2.0",
            "description": "TPU-native open web search engine. All search "
            "endpoints accept camelCase fields; the search body also accepts "
            "snake_case (internal RPC format).",
        },
        "paths": paths,
    }


def docs_html() -> str:
    """Self-contained human-readable API docs (no external assets)."""
    import html as H

    spec = openapi_spec()
    rows = []
    for path, methods in spec["paths"].items():
        for method, op in methods.items():
            body = op.get("requestBody", {}).get("content", {}).get("application/json", {})
            fields = ""
            schema = body.get("schema", {})
            props = schema.get("properties")
            if props:
                fields = "<ul>" + "".join(
                    f"<li><code>{H.escape(k)}</code> <i>{H.escape(v.get('type', ''))}</i>"
                    f" {H.escape(v.get('description', ''))}</li>"
                    for k, v in props.items()
                ) + "</ul>"
            rows.append(
                f"<section><h3><span class=m>{method.upper()}</span> "
                f"<code>{H.escape(path)}</code></h3>"
                f"<p>{H.escape(op.get('summary', ''))}. "
                f"{H.escape(op.get('description', ''))}</p>{fields}</section>"
            )
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>stract_tpu API docs</title><style>
body{{font:15px/1.5 system-ui;max-width:840px;margin:30px auto;padding:0 16px;color:#1b1f24}}
code{{background:#f3f4f6;padding:1px 5px;border-radius:4px}}
.m{{color:#2463eb;font-size:13px;font-weight:700}}
section{{border-bottom:1px solid #e3e6ea;padding:10px 0}}
</style></head><body>
<h1>stract_tpu API</h1>
<p>{H.escape(spec['info']['description'])}
Machine-readable spec: <a href="/beta/api/docs/openapi.json">openapi.json</a>.</p>
{''.join(rows)}
</body></html>"""
