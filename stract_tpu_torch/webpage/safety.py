"""Safety (NSFW/SFW) classification (role of reference
webpage/safety_classifier.rs + entrypoint/safety_classifier.rs train/predict:
TF-IDF naive bayes over page text)."""

from __future__ import annotations

from ..utils.naive_bayes import NaiveBayes

LABELS = ("nsfw", "sfw")


class SafetyClassifier:
    def __init__(self, model: NaiveBayes | None = None):
        self.model = model

    @classmethod
    def train(cls, texts: list[str], labels: list[str]) -> "SafetyClassifier":
        m = NaiveBayes()
        m.fit(texts, labels)
        return cls(m)

    @classmethod
    def load(cls, path: str) -> "SafetyClassifier":
        return cls(NaiveBayes.load(path))

    def save(self, path: str) -> None:
        self.model.save(path)

    def classify(self, webpage_text: str) -> str:
        if self.model is None:
            return "sfw"
        return self.model.predict(webpage_text)

    def classify_webpage(self, doc: dict) -> str:
        text = " ".join([doc.get("title", ""), doc.get("clean_text", "")])[:20_000]
        return self.classify(text)
