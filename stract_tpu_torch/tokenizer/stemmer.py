"""Language-dispatched stemming (role of reference tokenizer/fields stemmed tokenizer,
which uses rust-stemmers per detected language).

Uses NLTK's Snowball stemmers (pure-Python, no corpus downloads needed). Unknown
languages fall back to identity.
"""

from __future__ import annotations

from functools import lru_cache

_SNOWBALL_LANGS = {
    "ar": "arabic", "da": "danish", "nl": "dutch", "en": "english", "fi": "finnish",
    "fr": "french", "de": "german", "hu": "hungarian", "it": "italian", "no": "norwegian",
    "pt": "portuguese", "ro": "romanian", "ru": "russian", "es": "spanish", "sv": "swedish",
}


@lru_cache(maxsize=32)
def _stemmer(lang_code: str):
    name = _SNOWBALL_LANGS.get(lang_code)
    if name is None:
        return None
    try:
        from nltk.stem import SnowballStemmer

        return SnowballStemmer(name)
    except Exception:
        return None


@lru_cache(maxsize=65536)
def stem(token: str, lang: str = "en") -> str:
    # memoized: snowball stemming is ~40 µs/token of pure Python and the same
    # tokens recur across every snippet/slop call in a serving batch
    s = _stemmer(lang)
    if s is None:
        return token
    try:
        return s.stem(token)
    except Exception:
        return token


def stem_tokens(tokens: list[str], lang: str = "en") -> list[str]:
    s = _stemmer(lang)
    if s is None:
        return list(tokens)
    return [s.stem(t) for t in tokens]
