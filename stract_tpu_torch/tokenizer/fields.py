"""Field tokenizers (role of reference crates/core/src/tokenizer/fields/).

Each text field in the schema names one of these tokenizers; the same tokenizer
is applied at both index and query time so term hashes line up. Output is a list
of token strings; the indexer hashes them with utils.hashing.term_hash.

Semantics mirror the reference:
  - default:  unicode word segmentation + lowercase (tokenizer/fields/default.rs)
  - stemmed:  default then snowball stem by language (tokenizer/fields/stemmed.rs)
  - identity: the whole input as a single lowercased token ("NoTokenizer" fields)
  - bigram/trigram: n-grams over the default token stream (tokenizer/fields/{bigram,trigram}.rs)
  - url:      splits URLs into scheme-less components (tokenizer/fields/url.rs)
  - newline:  split on newlines, lowercase (keywords / key phrases)
  - json:     flattened schema.org path tokens (tokenizer/fields/json.rs)
"""

from __future__ import annotations

import regex as _re

# Unicode-aware word pattern: runs of letters+digits (close to unicode-segmentation
# word bounds used by the reference's default tokenizer).
_WORD_RE = _re.compile(r"[\p{L}\p{N}]+")
_URL_SPLIT_RE = _re.compile(r"[^\p{L}\p{N}]+")


class FieldTokenizer:
    name = "abstract"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        raise NotImplementedError


class DefaultTokenizer(FieldTokenizer):
    name = "default"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        return [m.group(0).lower() for m in _WORD_RE.finditer(text)]


class StemmedTokenizer(FieldTokenizer):
    name = "stemmed"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        from .stemmer import stem_tokens

        return stem_tokens(DefaultTokenizer().tokenize(text, lang), lang)


class IdentityTokenizer(FieldTokenizer):
    """Whole string = one token (reference's *NoTokenizer fields)."""

    name = "identity"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        t = text.strip().lower()
        return [t] if t else []


class _NgramTokenizer(FieldTokenizer):
    n = 2

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        toks = DefaultTokenizer().tokenize(text, lang)
        if len(toks) < self.n:
            return []
        return ["".join(toks[i : i + self.n]) for i in range(len(toks) - self.n + 1)]


class BigramTokenizer(_NgramTokenizer):
    name = "bigram"
    n = 2


class TrigramTokenizer(_NgramTokenizer):
    name = "trigram"
    n = 3


class UrlTokenizer(FieldTokenizer):
    """Split URL into component tokens. 'https://Sub.Example.com/a/b-c?q=1' →
    ['sub', 'example', 'com', 'a', 'b', 'c', 'q', '1'] (scheme dropped)."""

    name = "url"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        t = text.strip().lower()
        for scheme in ("https://", "http://"):
            if t.startswith(scheme):
                t = t[len(scheme) :]
                break
        return [p for p in _URL_SPLIT_RE.split(t) if p]


class NewlineTokenizer(FieldTokenizer):
    name = "newline"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        return [line.strip().lower() for line in text.split("\n") if line.strip()]


class JsonFieldTokenizer(FieldTokenizer):
    """Tokens for flattened schema.org JSON paths: 'Recipe.name=Pasta' →
    ['recipe.name', 'pasta', 'recipe.name=pasta'] so both path and value match."""

    name = "json"

    def tokenize(self, text: str, lang: str = "en") -> list[str]:
        out: list[str] = []
        for line in text.split("\n"):
            line = line.strip().lower()
            if not line:
                continue
            if "=" in line:
                path, value = line.split("=", 1)
                out.append(path)
                out.extend(DefaultTokenizer().tokenize(value))
                out.append(line)
            else:
                out.append(line)
        return out


_TOKENIZERS: dict[str, FieldTokenizer] = {
    t.name: t
    for t in [
        DefaultTokenizer(),
        StemmedTokenizer(),
        IdentityTokenizer(),
        BigramTokenizer(),
        TrigramTokenizer(),
        UrlTokenizer(),
        NewlineTokenizer(),
        JsonFieldTokenizer(),
    ]
}


def get_tokenizer(name: str) -> FieldTokenizer:
    return _TOKENIZERS[name]


def tokenize(text: str, tokenizer: str = "default", lang: str = "en") -> list[str]:
    return get_tokenizer(tokenizer).tokenize(text, lang)
