"""Text field schema (role of reference crates/core/src/schema/text_field.rs:161-215).

Every variant of the reference's TextFieldEnum is present with the same semantics:
tokenizer choice, homepage-only gating, n-gram variants, backlink label groups.
Field ids are stable (persisted in segment term dictionaries — never reorder).

TPU-relevant properties:
  - `record_len`: field length column is written per doc (dense u32 array) — BM25
    needs it on device.
  - `monogram_field`: which base field an n-gram variant derives from.
  - `search_default` + `bm25_weight`: plain query terms expand over these fields,
    mirroring Query::parse field expansion (reference query/mod.rs:77).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TextField:
    id: int
    name: str
    tokenizer: str = "default"
    stored: bool = False          # raw text kept in the row store
    search_default: bool = False  # expanded for plain query terms
    bm25_weight: float = 1.0      # expansion boost when searched by default
    homepage_only: bool = False   # only populated when page is the site homepage
    source: str = ""              # which Webpage attribute populates it
    ngram: int = 1

    def __str__(self) -> str:
        return self.name


_REGISTRY: dict[str, TextField] = {}


def _tf(name: str, **kw) -> TextField:
    f = TextField(id=len(_REGISTRY), name=name, **kw)
    _REGISTRY[name] = f
    return f


# Mirrors TextFieldEnum order (reference schema/text_field.rs:161-215).
TITLE = _tf("title", stored=True, search_default=True, bm25_weight=4.0, source="title")
CLEAN_BODY = _tf("clean_body", stored=True, search_default=True, bm25_weight=1.0, source="clean_text")
STEMMED_TITLE = _tf("stemmed_title", tokenizer="stemmed", search_default=True, bm25_weight=1.0, source="title")
STEMMED_CLEAN_BODY = _tf(
    "stemmed_clean_body", tokenizer="stemmed", search_default=True, bm25_weight=0.5, source="clean_text"
)
ALL_BODY = _tf("all_body", source="all_text")
URL = _tf("url", tokenizer="url", stored=True, search_default=True, bm25_weight=1.0, source="url")
URL_NO_TOKENIZER = _tf("url_no_tokenizer", tokenizer="identity", source="url")
URL_FOR_SITE_OPERATOR = _tf("url_for_site_operator", tokenizer="url", source="url")
SITE_WITHOUT = _tf("site_without", tokenizer="url", search_default=True, bm25_weight=1.0, source="site")
DOMAIN = _tf("domain", tokenizer="url", search_default=True, bm25_weight=1.0, source="domain")
SITE_NO_TOKENIZER = _tf("site_no_tokenizer", tokenizer="identity", source="site")
DOMAIN_NO_TOKENIZER = _tf("domain_no_tokenizer", tokenizer="identity", source="domain")
DOMAIN_NAME_NO_TOKENIZER = _tf("domain_name_no_tokenizer", tokenizer="identity", source="domain_name")
SITE_IF_HOMEPAGE_NO_TOKENIZER = _tf(
    "site_if_homepage_no_tokenizer", tokenizer="identity", homepage_only=True, source="site"
)
DOMAIN_IF_HOMEPAGE = _tf(
    "domain_if_homepage", tokenizer="url", search_default=True, bm25_weight=6.0, homepage_only=True, source="domain"
)
DOMAIN_NAME_IF_HOMEPAGE_NO_TOKENIZER = _tf(
    "domain_name_if_homepage_no_tokenizer", tokenizer="identity", homepage_only=True, source="domain_name"
)
DOMAIN_IF_HOMEPAGE_NO_TOKENIZER = _tf(
    "domain_if_homepage_no_tokenizer", tokenizer="identity", homepage_only=True, source="domain"
)
TITLE_IF_HOMEPAGE = _tf("title_if_homepage", search_default=False, homepage_only=True, source="title")
BACKLINK_TEXT = _tf("backlink_text", search_default=True, bm25_weight=4.0, source="backlink_text")
DESCRIPTION = _tf("description", stored=True, source="description")
DMOZ_DESCRIPTION = _tf("dmoz_description", source="dmoz_description")
SCHEMA_ORG_JSON = _tf("schema_org_json", tokenizer="identity", stored=True, source="schema_org_json")
FLATTENED_SCHEMA_ORG_JSON = _tf("flattened_schema_org_json", tokenizer="json", source="flattened_schema_org")
CLEAN_BODY_BIGRAMS = _tf(
    "clean_body_bigrams", tokenizer="bigram", search_default=True, bm25_weight=1.0, source="clean_text", ngram=2
)
TITLE_BIGRAMS = _tf("title_bigrams", tokenizer="bigram", search_default=True, bm25_weight=1.0, source="title", ngram=2)
CLEAN_BODY_TRIGRAMS = _tf(
    "clean_body_trigrams", tokenizer="trigram", search_default=True, bm25_weight=1.0, source="clean_text", ngram=3
)
TITLE_TRIGRAMS = _tf(
    "title_trigrams", tokenizer="trigram", search_default=True, bm25_weight=1.0, source="title", ngram=3
)
MICROFORMAT_TAGS = _tf("microformat_tags", source="microformats")
SAFETY_CLASSIFICATION = _tf("safety_classification", tokenizer="identity", source="safety_classification")
INSERTION_TIMESTAMP = _tf("insertion_timestamp", tokenizer="identity", source="insertion_timestamp")
RECIPE_FIRST_INGREDIENT_TAG_ID = _tf(
    "recipe_first_ingredient_tag_id", tokenizer="identity", source="recipe_first_ingredient_tag_id"
)
KEYWORDS = _tf("keywords", tokenizer="newline", stored=True, source="keywords")
KEY_PHRASES = _tf("key_phrases", tokenizer="newline", source="key_phrases")
LINKS = _tf("links", tokenizer="url", source="links")
BACKLINK_LABELS = [
    _tf(f"backlink_labels_group_{i}", search_default=False, source=f"backlink_labels_{i}") for i in range(10)
]
FIRST_H1 = _tf("first_h1", search_default=True, bm25_weight=1.5, source="first_h1")
ALL_H2 = _tf("all_h2", source="all_h2")
ALL_H3 = _tf("all_h3", source="all_h3")

TEXT_FIELDS: list[TextField] = list(_REGISTRY.values())
NUM_TEXT_FIELDS = len(TEXT_FIELDS)
_BY_NAME = dict(_REGISTRY)
_BY_ID = {f.id: f for f in TEXT_FIELDS}


def text_field(key) -> TextField:
    if isinstance(key, TextField):
        return key
    if isinstance(key, int):
        return _BY_ID[key]
    return _BY_NAME[key]


def default_search_fields() -> list[TextField]:
    return [f for f in TEXT_FIELDS if f.search_default]
