"""TF-IDF + multinomial Naive Bayes classifier (role of reference naive_bayes.rs:132).

Used by the safety classifier (NSFW/SFW page classification,
webpage/safety.py). Train/predict are vectorized numpy; training a model of this
size on TPU is pointless, prediction at indexing time is a dense dot product.
"""

from __future__ import annotations

import json
import math
from collections import Counter

import numpy as np


class NaiveBayes:
    def __init__(self):
        self.vocab: dict[str, int] = {}
        self.idf: np.ndarray | None = None
        self.log_prior: np.ndarray | None = None
        self.log_likelihood: np.ndarray | None = None  # [num_classes, vocab]
        self.classes: list[str] = []

    @staticmethod
    def _tokenize(text: str) -> list[str]:
        return [t for t in "".join(c.lower() if c.isalnum() else " " for c in text).split() if t]

    def fit(self, texts: list[str], labels: list[str], max_vocab: int = 100_000) -> None:
        tokenized = [self._tokenize(t) for t in texts]
        df = Counter()
        for toks in tokenized:
            df.update(set(toks))
        vocab_terms = [t for t, _ in df.most_common(max_vocab)]
        self.vocab = {t: i for i, t in enumerate(vocab_terms)}
        n_docs = len(texts)
        self.idf = np.array(
            [math.log((1 + n_docs) / (1 + df[t])) + 1.0 for t in vocab_terms], dtype=np.float64
        )
        self.classes = sorted(set(labels))
        cls_idx = {c: i for i, c in enumerate(self.classes)}
        counts = np.zeros((len(self.classes), len(self.vocab)), dtype=np.float64)
        prior = np.zeros(len(self.classes), dtype=np.float64)
        for toks, label in zip(tokenized, labels):
            ci = cls_idx[label]
            prior[ci] += 1
            tf = Counter(toks)
            for t, c in tf.items():
                j = self.vocab.get(t)
                if j is not None:
                    counts[ci, j] += c * self.idf[j]
        self.log_prior = np.log(prior / prior.sum())
        smoothed = counts + 1.0
        self.log_likelihood = np.log(smoothed / smoothed.sum(axis=1, keepdims=True))

    def _vector(self, text: str) -> np.ndarray:
        vec = np.zeros(len(self.vocab), dtype=np.float64)
        for t, c in Counter(self._tokenize(text)).items():
            j = self.vocab.get(t)
            if j is not None:
                vec[j] = c * self.idf[j]
        return vec

    def predict_log_proba(self, text: str) -> np.ndarray:
        scores = self.log_prior + self.log_likelihood @ self._vector(text)
        return scores - np.logaddexp.reduce(scores)

    def predict(self, text: str) -> str:
        return self.classes[int(np.argmax(self.predict_log_proba(text)))]

    def predict_proba(self, text: str) -> dict[str, float]:
        p = np.exp(self.predict_log_proba(text))
        return dict(zip(self.classes, p.tolist()))

    # -- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            idf=self.idf,
            log_prior=self.log_prior,
            log_likelihood=self.log_likelihood,
            vocab=json.dumps(self.vocab),
            classes=json.dumps(self.classes),
        )

    @classmethod
    def load(cls, path: str) -> "NaiveBayes":
        data = np.load(path, allow_pickle=False)
        m = cls()
        m.idf = data["idf"]
        m.log_prior = data["log_prior"]
        m.log_likelihood = data["log_likelihood"]
        m.vocab = json.loads(str(data["vocab"]))
        m.classes = json.loads(str(data["classes"]))
        return m
