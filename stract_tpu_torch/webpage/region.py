"""Region detection (role of reference webpage/region.rs).

Region ids are stable (stored in the region column; index ↔ query must agree)."""

from __future__ import annotations

import enum


class Region(enum.IntEnum):
    ALL = 0
    DENMARK = 1
    FRANCE = 2
    GERMANY = 3
    SPAIN = 4
    US = 5
    SWEDEN = 6
    NORWAY = 7
    ITALY = 8
    PORTUGAL = 9
    RUSSIA = 10
    NETHERLANDS = 11
    POLAND = 12

    @classmethod
    def from_id(cls, v: int) -> "Region":
        try:
            return cls(v)
        except ValueError:
            return cls.ALL

    @classmethod
    def from_lang(cls, lang: str) -> "Region":
        return _LANG_TO_REGION.get((lang or "").split("-")[0].lower(), cls.ALL)

    def lang(self) -> str:
        return _REGION_TO_LANG.get(self, "en")

    def name_pretty(self) -> str:
        return self.name.title() if self != Region.US else "US"


_LANG_TO_REGION = {
    "da": Region.DENMARK,
    "fr": Region.FRANCE,
    "de": Region.GERMANY,
    "es": Region.SPAIN,
    "en": Region.US,
    "sv": Region.SWEDEN,
    "no": Region.NORWAY,
    "nb": Region.NORWAY,
    "it": Region.ITALY,
    "pt": Region.PORTUGAL,
    "ru": Region.RUSSIA,
    "nl": Region.NETHERLANDS,
    "pl": Region.POLAND,
}
_REGION_TO_LANG = {v: k for k, v in _LANG_TO_REGION.items()}


# Tiny stopword-profile language detector (role of the reference's whatlang
# dependency; only needs to cover the regions above).
_STOPWORDS = {
    "en": {"the", "and", "of", "to", "in", "is", "that", "for", "with", "you", "this"},
    "de": {"der", "die", "und", "das", "ist", "nicht", "ein", "mit", "für", "auf"},
    "fr": {"le", "la", "les", "et", "des", "est", "pour", "dans", "que", "une"},
    "es": {"el", "la", "los", "de", "que", "y", "en", "un", "por", "con", "para"},
    "da": {"og", "det", "er", "til", "en", "af", "for", "med", "på", "ikke"},
    "sv": {"och", "det", "är", "att", "en", "som", "för", "med", "på", "inte"},
    "it": {"il", "la", "di", "che", "e", "un", "per", "con", "del", "una"},
    "pt": {"o", "a", "de", "que", "e", "um", "para", "com", "não", "uma"},
    "ru": {"и", "в", "не", "на", "что", "это", "как", "с", "по", "из"},
    "nl": {"de", "het", "een", "en", "van", "is", "dat", "op", "voor", "met"},
    "pl": {"i", "w", "nie", "na", "to", "się", "jest", "do", "z", "że"},
}


def detect_lang(text: str, hint: str = "") -> str:
    if hint:
        h = hint.split("-")[0].lower()
        if h in _STOPWORDS:
            return h
    words = set(text.lower().split()[:500])
    best, best_n = "en", 0
    for lang, stops in _STOPWORDS.items():
        n = len(words & stops)
        if n > best_n:
            best, best_n = lang, n
    return best
