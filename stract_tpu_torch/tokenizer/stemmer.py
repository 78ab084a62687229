"""Language-dispatched stemming (role of reference tokenizer/fields stemmed tokenizer,
which uses rust-stemmers per detected language).

The port carries its own copy of the Snowball stemmers (tokenizer/snowball.py,
NLTK's algorithms) for the languages webpage/region.py detect_lang returns
that Snowball covers; it stems as the JAX package does with NLTK installed,
and needs no NLTK. A language without a stemmer here (Polish, or any code
outside the table) keeps its tokens unchanged.
"""

from __future__ import annotations

from functools import lru_cache

from . import snowball

_SNOWBALL = {
    "da": snowball.DanishStemmer, "nl": snowball.DutchStemmer, "en": snowball.EnglishStemmer,
    "fr": snowball.FrenchStemmer, "de": snowball.GermanStemmer, "it": snowball.ItalianStemmer,
    "pt": snowball.PortugueseStemmer, "ru": snowball.RussianStemmer,
    "es": snowball.SpanishStemmer, "sv": snowball.SwedishStemmer,
}


@lru_cache(maxsize=32)
def _stemmer(lang_code: str):
    cls = _SNOWBALL.get(lang_code)
    return None if cls is None else cls()


@lru_cache(maxsize=65536)
def stem(token: str, lang: str = "en") -> str:
    # memoized: snowball stemming is ~40 µs/token of pure Python and the same
    # tokens recur across every snippet/slop call in a serving batch
    s = _stemmer(lang)
    return token if s is None else s.stem(token)


def stem_tokens(tokens: list[str], lang: str = "en") -> list[str]:
    # through stem's memo: a page's body repeats its words, and indexing
    # stems every body token once for the stemmed fields
    if _stemmer(lang) is None:
        return list(tokens)
    return [stem(t, lang) for t in tokens]
