"""RAKE keyword extraction (role of the reference indexer's set_keywords,
entrypoint/indexer/worker.rs:379 — RAKE over page text)."""

from __future__ import annotations

from collections import defaultdict

from .webpage.region import _STOPWORDS


def rake_keywords(text: str, lang: str = "en", top_k: int = 10) -> list[str]:
    stops = _STOPWORDS.get(lang, _STOPWORDS["en"])
    words = [w.strip(".,!?;:()[]\"'").lower() for w in text.split()]
    # candidate phrases = maximal runs of non-stopwords
    phrases: list[list[str]] = []
    cur: list[str] = []
    for w in words:
        if not w or w in stops or not any(c.isalpha() for c in w):
            if cur:
                phrases.append(cur)
                cur = []
        else:
            cur.append(w)
            if len(cur) >= 4:
                phrases.append(cur)
                cur = []
    if cur:
        phrases.append(cur)

    freq: dict = defaultdict(float)
    degree: dict = defaultdict(float)
    for ph in phrases:
        for w in ph:
            freq[w] += 1
            degree[w] += len(ph) - 1
    word_score = {w: (degree[w] + freq[w]) / freq[w] for w in freq}

    phrase_scores: dict = {}
    for ph in phrases:
        key = " ".join(ph)
        phrase_scores[key] = max(phrase_scores.get(key, 0.0), sum(word_score[w] for w in ph))
    ranked = sorted(phrase_scores.items(), key=lambda kv: -kv[1])
    return [p for p, _ in ranked[:top_k]]
