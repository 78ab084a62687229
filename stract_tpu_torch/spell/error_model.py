"""Trained spelling error model (the port's copy of
stract_tpu/spell/error_model.py; role of reference
crates/web-spell/src/error_model.rs): the probability of a specific EDIT
SEQUENCE (substitutions/insertions/deletions with their characters), learned
from (misspelling → correction) pairs harvested from the corpus — so
candidates reachable via COMMON error patterns (e.g. 'teh'→'the', a t/h
transposition surfacing as two substitutions) outscore equally-distant but
implausible edits, which the uniform edit-distance weighting could not do."""

from __future__ import annotations

import json
import math
import os


def possible_errors(a: str, b: str) -> tuple | None:
    """Edit sequence transforming a → b via the Levenshtein backtrace
    (error_model.rs:42-115): tuple of ('sub', x, y) / ('del', x) / ('ins', y)
    ops, or None when a == b. Deterministic tie-break mirrors the reference's
    (diagonal, then deletion, then insertion)."""
    if a == b:
        return None
    la, lb = len(a), len(b)
    dp = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la + 1):
        dp[i][0] = i
    for j in range(lb + 1):
        dp[0][j] = j
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1, dp[i - 1][j - 1] + cost)
    errors = []
    i, j = la, lb
    while i > 0 and j > 0:
        cost = 0 if a[i - 1] == b[j - 1] else 1
        if dp[i][j] == dp[i - 1][j - 1] + cost:
            if cost == 1:
                errors.append(("sub", a[i - 1], b[j - 1]))
            i -= 1
            j -= 1
        elif dp[i][j] == dp[i - 1][j] + 1:
            errors.append(("del", a[i - 1]))
            i -= 1
        else:
            errors.append(("ins", b[j - 1]))
            j -= 1
    while i > 0:
        errors.append(("del", a[i - 1]))
        i -= 1
    while j > 0:
        errors.append(("ins", b[j - 1]))
        j -= 1
    return tuple(errors) if errors else None


class ErrorModel:
    """Counts of observed error sequences; log2-probability with +1 smoothing
    on the total (error_model.rs:204-216: seen → log2(count)−log2(total+1),
    unseen → −log2(total+1))."""

    def __init__(self):
        self.errors: dict = {}
        self.total = 0

    def add(self, a: str, b: str) -> None:
        seq = possible_errors(a, b)
        if seq is not None:
            self.errors[seq] = self.errors.get(seq, 0) + 1
            self.total += 1

    def log_prob(self, seq: tuple) -> float:
        count = self.errors.get(seq, 0)
        if count:
            return math.log2(count) - math.log2(self.total + 1)
        return 0.0 - math.log2(self.total + 1)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        stored = {json.dumps(list(map(list, k))): v for k, v in self.errors.items()}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"errors": stored, "total": self.total}, fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ErrorModel":
        with open(path) as fh:
            data = json.load(fh)
        m = cls()
        m.errors = {tuple(tuple(op) for op in json.loads(k)): v
                    for k, v in data["errors"].items()}
        m.total = data["total"]
        return m
