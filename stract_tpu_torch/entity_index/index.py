"""Entity index for the sidebar — the port's copy of
stract_tpu/entity_index/index.py (role of reference entity_index/, 726 LoC:
tantivy index of Wikipedia entities with title/abstract schema, built from ZIM
dumps, images via EntityImageStore).

Scale note: entity corpora are ~1e5-1e6 docs with two short fields, so this
uses compact host-side postings rather than the card, as the JAX package
does — the sidebar lookup is a single exact/BM25 title match per query.
entities.bin is the JAX package's msgpack layout in the same insertion order,
so a file written by either package loads in the other."""

from __future__ import annotations

import math
import os
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import msgpack

from ..tokenizer import tokenize


@dataclass
class Entity:
    title: str
    abstract: str = ""
    image: str = ""           # image name/url (EntityImageStore role)
    info: dict = field(default_factory=dict)  # infobox key→value
    links: list = field(default_factory=list)

    def to_json(self):
        return {
            "title": self.title,
            "abstract": self.abstract,
            "image": self.image,
            "info": self.info,
            "links": self.links,
        }


class EntityIndex:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.entities: list[dict] = []
        self.title_postings: dict[str, list] = defaultdict(list)
        self.abstract_postings: dict[str, list] = defaultdict(list)
        self.title_lens: list[int] = []
        self._by_exact_title: dict[str, int] = {}
        f = os.path.join(path, "entities.bin")
        if os.path.exists(f):
            self._load()

    # -- build ------------------------------------------------------------------
    def insert(self, entity: Entity) -> None:
        eid = len(self.entities)
        self.entities.append(entity.to_json())
        t_toks = tokenize(entity.title)
        self.title_lens.append(len(t_toks))
        for tok, tf in Counter(t_toks).items():
            self.title_postings[tok].append((eid, tf))
        for tok, tf in Counter(tokenize(entity.abstract)).items():
            self.abstract_postings[tok].append((eid, tf))
        self._by_exact_title[entity.title.lower()] = eid

    def commit(self) -> None:
        with open(os.path.join(self.path, "entities.bin"), "wb") as fh:
            fh.write(
                msgpack.packb(
                    {
                        "entities": self.entities,
                        "title": {k: v for k, v in self.title_postings.items()},
                        "abstract": {k: v for k, v in self.abstract_postings.items()},
                        "title_lens": self.title_lens,
                    },
                    use_bin_type=True,
                )
            )

    def _load(self) -> None:
        with open(os.path.join(self.path, "entities.bin"), "rb") as fh:
            d = msgpack.unpackb(fh.read(), raw=False)
        self.entities = d["entities"]
        self.title_postings = defaultdict(list, {k: [tuple(x) for x in v] for k, v in d["title"].items()})
        self.abstract_postings = defaultdict(list, {k: [tuple(x) for x in v] for k, v in d["abstract"].items()})
        self.title_lens = d["title_lens"]
        self._by_exact_title = {e["title"].lower(): i for i, e in enumerate(self.entities)}

    # -- search --------------------------------------------------------------------
    def search(self, query: str, top_k: int = 1) -> list[Entity]:
        """BM25 over title (weight 4) + abstract (weight 1); exact title match
        short-circuits (the sidebar behavior, searcher/api/sidebar.rs:171)."""
        q = query.strip().lower()
        if q in self._by_exact_title:
            return [self._entity(self._by_exact_title[q])]
        toks = tokenize(query)
        if not toks or not self.entities:
            return []
        n = len(self.entities)
        avg_title = max(sum(self.title_lens) / n, 1e-6)
        scores: Counter = Counter()
        for tok in set(toks):
            for postings, weight, avg in (
                (self.title_postings.get(tok, []), 4.0, avg_title),
                (self.abstract_postings.get(tok, []), 1.0, 50.0),
            ):
                df = len(postings)
                if not df:
                    continue
                idf = math.log1p((n - df + 0.5) / (df + 0.5))
                for eid, tf in postings:
                    flen = self.title_lens[eid] if weight == 4.0 else 50
                    norm = 1.2 * (1 - 0.75 + 0.75 * flen / avg)
                    scores[eid] += weight * idf * tf * 2.2 / (tf + norm)
        best = scores.most_common(top_k)
        # sidebar threshold: require a meaningful match
        return [self._entity(eid) for eid, s in best if s > 1.0]

    def _entity(self, eid: int) -> Entity:
        d = self.entities[eid]
        return Entity(d["title"], d["abstract"], d.get("image", ""), d.get("info", {}), d.get("links", []))

    def __len__(self):
        return len(self.entities)


class SidebarManager:
    """(role of searcher/api/sidebar.rs:171 SidebarManager)"""

    def __init__(self, entity_index: EntityIndex):
        self.index = entity_index

    def sidebar(self, query: str) -> dict | None:
        hits = self.index.search(query, top_k=1)
        if not hits:
            return None
        e = hits[0]
        return {"type": "entity", "value": e.to_json()}
