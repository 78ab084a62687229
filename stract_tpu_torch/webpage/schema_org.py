"""schema.org extraction (role of reference webpage/schema_org/, 1,495 LoC):
JSON-LD script blocks + microdata itemscope/itemprop, flattened into
'path=value' lines for the flattened_schema_org_json field (tokenizer/fields
json tokenizer)."""

from __future__ import annotations

import json


def parse_json_ld(root) -> list[dict]:
    out = []
    for el in root.iter("script"):
        if (el.get("type") or "").lower() != "application/ld+json":
            continue
        try:
            data = json.loads(el.text or "")
        except (ValueError, TypeError):
            continue
        if isinstance(data, list):
            out.extend(d for d in data if isinstance(d, dict))
        elif isinstance(data, dict):
            if "@graph" in data and isinstance(data["@graph"], list):
                out.extend(d for d in data["@graph"] if isinstance(d, dict))
            else:
                out.append(data)
    return out


def parse_microdata(root) -> list[dict]:
    # top-level items per the microdata model: itemscope WITHOUT itemprop —
    # even when nested inside another scope (an un-itemprop'd nested scope is
    # an independent item, not a property of its parent)
    out = []
    for el in root.iter():
        if el.get("itemscope") is None or el.get("itemprop"):
            continue
        item = _microdata_item(el)
        if item:
            out.append(item)
    return out


def _microdata_item(scope) -> dict:
    """One itemscope → dict. Repeated properties collect into lists (the
    reference's OneOrMany<Property>, webpage/schema_org/mod.rs — e.g. a QAPage
    has several suggestedAnswer items); nested scopes own their properties
    (descendants of a nested itemscope must not leak into the parent)."""
    item: dict = {}
    t = scope.get("itemtype")
    if t:
        item["@type"] = t.rsplit("/", 1)[-1]

    def add(prop: str, val) -> None:
        cur = item.get(prop)
        if cur is None:
            item[prop] = val
        elif isinstance(cur, list):
            cur.append(val)
        else:
            item[prop] = [cur, val]

    stack = list(scope)
    while stack:
        el = stack.pop(0)
        prop = el.get("itemprop")
        if prop and el.get("itemscope") is not None:
            add(prop, _microdata_item(el))
            continue  # nested scope owns its subtree
        if prop:
            add(prop, el.get("content") or el.get("href") or " ".join(
                x.strip() for x in el.itertext() if x.strip()))
        if el.get("itemscope") is not None:
            # itemscope without itemprop: an independent top-level item (the
            # outer scan collects it) — its subtree must not leak into us
            continue
        stack[:0] = list(el)
    return item


def flatten(items: list[dict]) -> list[str]:
    """[{'@type': 'Recipe', 'name': 'Pasta'}] → ['Recipe', 'Recipe.name=Pasta']."""
    lines = []

    def walk(prefix: str, obj):
        if isinstance(obj, dict):
            t = obj.get("@type")
            base = f"{prefix}.{t}" if prefix and t else (t or prefix)
            if t:
                lines.append(base)
            for k, v in obj.items():
                if k.startswith("@"):
                    continue
                walk(f"{base}.{k}" if base else k, v)
        elif isinstance(obj, list):
            for v in obj:
                walk(prefix, v)
        elif obj is not None:
            lines.append(f"{prefix}={obj}")

    for it in items:
        walk("", it)
    return lines


def first_ingredient_tag_id(items: list[dict]) -> str:
    for it in items:
        if it.get("@type") == "Recipe":
            ing = it.get("recipeIngredient")
            if isinstance(ing, list) and ing:
                return str(ing[0])[:64]
            if isinstance(ing, str):
                return ing[:64]
    return ""
