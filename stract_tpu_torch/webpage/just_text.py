"""JusText-style main-text extraction (role of reference webpage/just_text.rs:23
and the preprocessor in webpage/html).

Classifies block-level text paragraphs as good/boilerplate by link density,
length and stopword density — the standard JusText heuristics, simplified to a
single pass (no context reclassification)."""

from __future__ import annotations

from .region import _STOPWORDS

BLOCK_TAGS = {
    "p", "div", "article", "section", "main", "li", "td", "blockquote", "pre",
    "h1", "h2", "h3", "h4", "h5", "h6",
}
BAD_ANCESTORS = {"nav", "footer", "header", "aside", "script", "style", "noscript", "form"}

MIN_WORDS = 5
MAX_LINK_DENSITY = 0.5
MIN_STOPWORD_DENSITY = 0.08


def paragraph_is_good(text: str, link_chars: int, lang: str = "en") -> bool:
    words = text.split()
    if len(words) < MIN_WORDS:
        return False
    if link_chars > MAX_LINK_DENSITY * max(len(text), 1):
        return False
    stops = _STOPWORDS.get(lang, _STOPWORDS["en"])
    stop_frac = sum(1 for w in words if w.lower().strip(".,!?;:") in stops) / len(words)
    # headings are kept regardless of stopword density
    return stop_frac >= MIN_STOPWORD_DENSITY or len(words) >= 25


def extract_paragraphs(root, lang: str = "en"):
    """root: an element of webpage/tree.py. → (clean_paragraphs, all_paragraphs, link_density)."""
    clean: list[str] = []
    everything: list[str] = []
    total_chars = 0
    total_link_chars = 0

    def is_bad(el) -> bool:
        cur = el
        while cur is not None:
            if str(getattr(cur, "tag", "")).lower() in BAD_ANCESTORS:
                return True
            cur = cur.getparent()
        return False

    for el in root.iter():
        tag = str(el.tag).lower() if isinstance(el.tag, str) else ""
        if tag not in BLOCK_TAGS:
            continue
        # direct text of this block (children blocks handled separately)
        text = " ".join(t.strip() for t in el.itertext() if t.strip())
        # skip if a child block would repeat the text (only keep leaf-ish blocks)
        if any(
            isinstance(ch.tag, str) and ch.tag.lower() in BLOCK_TAGS for ch in el
        ):
            continue
        if not text:
            continue
        link_chars = sum(len("".join(a.itertext())) for a in el.iter("a"))
        total_chars += len(text)
        total_link_chars += link_chars
        everything.append(text)
        if is_bad(el):
            continue
        if tag.startswith("h") or paragraph_is_good(text, link_chars, lang):
            clean.append(text)

    link_density = total_link_chars / total_chars if total_chars else 0.0
    return clean, everything, link_density
