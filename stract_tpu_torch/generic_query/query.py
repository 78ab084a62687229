"""GenericQuery protocol + implementations.

Flow (generic_query/mod.rs:17-35):
    coordinator → search(query) on every shard  → per-shard fruit
    coordinator merges fruits                    → merged fruit
    coordinator → retrieve(query, fruit-filter)  → per-shard results
    coordinator merges results                   → final
"""

from __future__ import annotations

from collections import Counter

from ..index.inverted import DocPointer
from ..schema import text_field
from ..utils.hashing import term_hash


class GenericQuery:
    kind = "generic"

    def search(self, searcher) -> object:
        """Phase 1 on one shard → fruit (msgpack-able)."""
        raise NotImplementedError

    def merge_fruits(self, fruits: list) -> object:
        raise NotImplementedError

    def retrieve(self, searcher, fruit) -> object:
        """Phase 2 on one shard, given the merged fruit filtered to the shard."""
        raise NotImplementedError

    def merge_results(self, results: list) -> object:
        raise NotImplementedError


class SizeQuery(GenericQuery):
    kind = "size"

    def search(self, searcher):
        return searcher.index.num_docs

    def merge_fruits(self, fruits):
        return sum(fruits)

    def retrieve(self, searcher, fruit):
        return fruit

    def merge_results(self, results):
        return max(results) if results else 0


class _PostingLookupQuery(GenericQuery):
    """Exact identity-field lookup → stored doc."""

    field_name = ""

    def __init__(self, value: str):
        self.value = value.strip().lower()

    def search(self, searcher):
        th = term_hash(text_field(self.field_name).id, self.value)
        for ord_, seg in enumerate(searcher.index.segments):
            docs, _ = seg.postings(th)
            if len(docs):
                return {"shard": searcher.shard_id, "segment": ord_, "doc": int(docs[0])}
        return None

    def merge_fruits(self, fruits):
        for f in fruits:
            if f is not None:
                return f
        return None

    def retrieve(self, searcher, fruit):
        if fruit is None or fruit["shard"] != searcher.shard_id:
            return None
        return searcher.index.retrieve([DocPointer(fruit["segment"], fruit["doc"])])[0]

    def merge_results(self, results):
        for r in results:
            if r is not None:
                return r
        return None


class GetWebpageQuery(_PostingLookupQuery):
    kind = "get_webpage"
    field_name = "url_no_tokenizer"


class GetHomepageQuery(_PostingLookupQuery):
    kind = "get_homepage"
    field_name = "site_if_homepage_no_tokenizer"


class GetSiteUrlsQuery(GenericQuery):
    kind = "get_site_urls"

    def __init__(self, site: str, offset: int = 0, limit: int = 100):
        self.site = site.strip().lower()
        self.offset = offset
        self.limit = limit

    def search(self, searcher):
        th = term_hash(text_field("site_no_tokenizer").id, self.site)
        out = []
        for ord_, seg in enumerate(searcher.index.segments):
            docs, _ = seg.postings(th)
            out.extend(
                {"shard": searcher.shard_id, "segment": ord_, "doc": int(d)}
                for d in docs[: self.offset + self.limit]
            )
        return out

    def merge_fruits(self, fruits):
        merged = [f for fr in fruits for f in fr]
        return merged[self.offset : self.offset + self.limit]

    def retrieve(self, searcher, fruit):
        ptrs = [DocPointer(f["segment"], f["doc"]) for f in fruit if f["shard"] == searcher.shard_id]
        return [d["url"] for d in searcher.index.retrieve(ptrs)]

    def merge_results(self, results):
        return [u for r in results for u in r]


class TopKeyPhrasesQuery(GenericQuery):
    """Most frequent key phrases across stored docs (role of key_phrase.rs +
    admin top-keyphrases)."""

    kind = "top_key_phrases"

    def __init__(self, top_n: int = 50):
        self.top_n = top_n

    def search(self, searcher):
        counts = Counter()
        for seg in searcher.index.segments:
            for doc_id in range(seg.num_docs):
                kws = seg.stored_doc(doc_id).get("keywords", "")
                for k in kws.split("\n"):
                    if k:
                        counts[k] += 1
        return dict(counts.most_common(self.top_n * 2))

    def merge_fruits(self, fruits):
        total = Counter()
        for f in fruits:
            total.update(f)
        return dict(total.most_common(self.top_n))

    def retrieve(self, searcher, fruit):
        return fruit

    def merge_results(self, results):
        return results[0] if results else {}


def run_generic_query(query: GenericQuery, searchers: list):
    """Executes the two-phase flow over local searchers (the distributed path
    sends the same phases over sonic — entrypoint/search_server.py)."""
    fruits = [query.search(s) for s in searchers]
    merged = query.merge_fruits(fruits)
    results = [query.retrieve(s, merged) for s in searchers]
    return query.merge_results(results)
