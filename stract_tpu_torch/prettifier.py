"""Rich result snippets from schema.org items (role of reference
search_prettifier/: mod.rs:167 generate_rich_snippet + stack_overflow.rs
stackoverflow_snippet — StackOverflowQA blocks for stackoverflow.com QAPage
results, rendered by the SERP's StackOverflow components)."""

from __future__ import annotations

import json
from urllib.parse import urlparse

ANSWER_LIMIT = 3
CHAR_LIMIT = 512


def _is_stackoverflow(url: str) -> bool:
    """Registrable-domain equality (mod.rs:170 url.root_domain() ==
    "stackoverflow.com") — substring checks let any crawled page whose URL
    merely CONTAINS the string render attacker-authored schema.org."""
    try:
        host = (urlparse(url).hostname or "").lower().rstrip(".")
    except ValueError:
        return False
    parts = host.split(".")
    return ".".join(parts[-2:]) == "stackoverflow.com"


def _many(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _one(v):
    return v[0] if isinstance(v, list) and v else v


def _text_passages(v) -> list:
    """schema 'text' property → [{kind: 'text'|'code', value}] — SO marks code
    blocks as nested items whose own text is the code (stack_overflow.rs:58
    parse_code)."""
    out = []
    for p in _many(v):
        if isinstance(p, dict):
            code = _one(p.get("text"))
            if isinstance(code, str) and code:
                out.append({"kind": "code", "value": code})
        elif isinstance(p, str) and p:
            out.append({"kind": "text", "value": p})
    return out


def _limit_chars(passages: list, limit: int = CHAR_LIMIT) -> list:
    """At least one passage; stop once the running total passes `limit`
    (stack_overflow.rs:146 limit_chars)."""
    out, taken = [], 0
    for p in passages:
        out.append(p)
        if taken + len(p["value"]) > limit:
            break
        taken += len(p["value"])
    return out


def _answer(item: dict, accepted: bool) -> dict | None:
    if not isinstance(item, dict):
        return None
    text = _text_passages(item.get("text"))
    date = _one(item.get("dateCreated"))
    upvotes = _one(item.get("upvoteCount"))
    url = _one(item.get("url"))
    if not text or date is None or upvotes is None or url is None:
        return None
    # answer urls land in an <a href> on the SERP: esc() covers HTML metachars
    # but not javascript:/data: schemes — require http(s)
    if urlparse(str(url)).scheme not in ("http", "https"):
        return None
    try:
        upvotes = int(str(upvotes))
    except ValueError:
        return None
    return {
        "body": _limit_chars(text),
        "date": str(date)[:10],
        "upvotes": upvotes,
        "url": str(url),
        "accepted": accepted,
    }


def stackoverflow_qa(schema_items: list) -> dict | None:
    """QAPage mainEntity → {question, answers} (stack_overflow.rs:170)."""
    qa = next((it for it in schema_items
               if isinstance(it, dict) and "QAPage" in _many(it.get("@type"))), None)
    if qa is None:
        return None
    q = _one(qa.get("mainEntity"))
    if not isinstance(q, dict):
        return None
    question = _text_passages(q.get("text"))
    answers = []
    acc = _one(q.get("acceptedAnswer"))
    if acc is not None:
        a = _answer(acc, accepted=True)
        if a:
            answers.append(a)
    for s in _many(q.get("suggestedAnswer")):
        a = _answer(s, accepted=False)
        if a:
            answers.append(a)
    if not question and not answers:
        return None
    return {
        "type": "stackOverflowQA",
        "question": {"body": _limit_chars(question)},
        "answers": answers[:ANSWER_LIMIT],
    }


def rich_snippet(webpage: dict) -> dict | None:
    """Attach-point for serialized results (search_prettifier/mod.rs:167):
    stackoverflow.com pages whose schema.org contains a QAPage."""
    url = webpage.get("url", "")
    if not _is_stackoverflow(url):
        return None
    raw = webpage.get("schema_org_json") or webpage.get("stored", {}).get("schema_org_json", "")
    if not raw:
        return None
    try:
        items = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(items, list):
        return None
    return stackoverflow_qa(items)
