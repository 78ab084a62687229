"""Linear regression scorer (the port's copy of
stract_tpu/ranking/models/linear.py; role of reference ranking/models/linear.rs, 54 LoC:
per-signal weight map applied at the shard level)."""

from __future__ import annotations

import json

import numpy as np

from .. import signals as S


class LinearRegression:
    def __init__(self, weights: dict[str, float], intercept: float = 0.0):
        self.weights = dict(weights)
        self.intercept = float(intercept)
        self._vec = np.zeros(S.NUM_SIGNALS, dtype=np.float32)
        for name, w in self.weights.items():
            self._vec[S.signal(name).id] = w

    def predict(self, signal_matrix: np.ndarray) -> np.ndarray:
        """signal_matrix f32[K, NUM_SIGNALS] → scores f32[K]."""
        return signal_matrix @ self._vec + self.intercept

    @classmethod
    def train(cls, x: np.ndarray, y: np.ndarray, l2: float = 1e-3) -> "LinearRegression":
        """Ridge regression over signal features (role of ltr/linear_model.py)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        w = np.linalg.solve(xb.T @ xb + l2 * np.eye(xb.shape[1]), xb.T @ y)
        weights = {s.name: float(w[s.id]) for s in S.SIGNALS if abs(w[s.id]) > 1e-12}
        return cls(weights, intercept=float(w[-1]))

    def to_json(self) -> str:
        return json.dumps({"weights": self.weights, "intercept": self.intercept})

    @classmethod
    def from_json(cls, s: str) -> "LinearRegression":
        d = json.loads(s)
        return cls(d["weights"], d.get("intercept", 0.0))
