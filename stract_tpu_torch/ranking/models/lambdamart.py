"""LambdaMART GBDT inference on torch — the port of
stract_tpu/ranking/models/lambdamart.py (role of reference
ranking/models/lambdamart.rs: a scorer for LightGBM text dumps).

The tree ensemble is tensorized as in the JAX package: every tree's
(feature, threshold, children, leaf values) become fixed-shape tensors, and
evaluation is the forest walk K4 (ops/forest.py: the plain PyTorch version on
the CPU, the hand-written CUDA kernel on a card).

Ensemble sources (the JAX package's, unchanged):
  - `parse_lightgbm(text)`: the LightGBM text dump format;
  - `from_json` / `to_json`: this package's and the JAX package's JSON form;
  - `train(...)`: the self-contained numpy gradient-boosted regression trainer.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ...ops import forest as forest_ops


class LambdaMART:
    """Tensorized GBDT. Internal node children are indices >= 0; leaves are
    encoded as -(leaf_index + 1). The tensors live on `device`."""

    def __init__(self, feature, threshold, left, right, leaf_value, max_depth: int,
                 device="cuda"):
        dev = torch.device(device)
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev).contiguous()  # noqa: E731
        self.feature = as_t(feature, torch.int32)        # [T, N]
        self.threshold = as_t(threshold, torch.float32)  # [T, N]
        self.left = as_t(left, torch.int32)              # [T, N]
        self.right = as_t(right, torch.int32)            # [T, N]
        self.leaf_value = as_t(leaf_value, torch.float32)  # [T, L]
        self.max_depth = max_depth
        self.num_trees = len(self.feature)
        self.device = dev

    def to(self, device) -> "LambdaMART":
        return LambdaMART(*(t.cpu().numpy() for t in self._arrays()), self.max_depth,
                          device=device)

    def _arrays(self):
        return self.feature, self.threshold, self.left, self.right, self.leaf_value

    # -- inference ---------------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        """x: f32[K, F] feature matrix → scores f32[K].

        K is padded to a power-of-2 bucket (>= 256) with zero rows, as the
        JAX package does to bound its compiled shapes; the padded rows walk
        the trees like any row and are sliced off. Kept here so both packages
        evaluate the same matrix."""
        x = np.asarray(x, dtype=np.float32)
        k = len(x)
        b = 256
        while b < k:
            b *= 2
        if b != k:
            x = np.concatenate([x, np.zeros((b - k, x.shape[1]), np.float32)])
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        out = forest_ops.gbdt_forward(*self._arrays(), xt, self.max_depth)
        return out.cpu().numpy()[:k]

    def split_between(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """bool[K]: rows whose two feature vectors a[k] and b[k] (f32[K, F],
        the same rows evaluated twice) fall on two sides of some split, i.e.
        a split threshold t on feature f with min <= t < max of a[k, f] and
        b[k, f]. Exactly these rows can walk to other leaves."""
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        feat = self.feature.cpu().numpy()
        internal = (self.left.cpu().numpy() != -1) | (self.right.cpu().numpy() != -1)
        thr = self.threshold.cpu().numpy()
        out = np.zeros(len(a), dtype=bool)
        for f in np.unique(feat[internal]):
            t = thr[internal & (feat == f)][None, :]
            out |= ((lo[:, f, None] <= t) & (t < hi[:, f, None])).any(axis=1)
        return out

    # -- serialization --------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "feature": self.feature.cpu().numpy().tolist(),
            "threshold": self.threshold.cpu().numpy().tolist(),
            "left": self.left.cpu().numpy().tolist(),
            "right": self.right.cpu().numpy().tolist(),
            "leaf_value": self.leaf_value.cpu().numpy().tolist(),
            "max_depth": self.max_depth,
        })

    @classmethod
    def from_json(cls, s, device="cuda") -> "LambdaMART":
        """Accepts the to_json() string or an already-parsed dict."""
        d = json.loads(s) if isinstance(s, (str, bytes)) else s
        return cls(
            np.array(d["feature"]), np.array(d["threshold"]), np.array(d["left"]),
            np.array(d["right"]), np.array(d["leaf_value"]), d["max_depth"], device=device,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "LambdaMART":
        """A forest file as the coordinator reads it: LightGBM text when it
        holds a "Tree=" section, else JSON."""
        with open(path) as fh:
            text = fh.read()
        if "Tree=" in text:
            return cls.parse_lightgbm(text, device=device)
        return cls.from_json(text, device=device)

    # -- LightGBM text dump ------------------------------------------------------------
    @classmethod
    def parse_lightgbm(cls, text: str, device="cuda") -> "LambdaMART":
        """Parses LightGBM `model.txt` dumps (Tree=K sections with num_leaves,
        split_feature, threshold, left_child, right_child, leaf_value)."""
        trees = []
        cur: dict = {}
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("Tree="):
                if cur.get("num_leaves"):
                    trees.append(cur)
                cur = {}
            elif "=" in line:
                k, v = line.split("=", 1)
                cur[k] = v
        if cur.get("num_leaves"):
            trees.append(cur)

        def ints(s):
            return [int(t) for t in s.split()] if s else []

        def floats(s):
            return [float(t) for t in s.split()] if s else []

        parsed = []
        for t in trees:
            n_leaves = int(t["num_leaves"])
            feat = ints(t.get("split_feature", ""))
            thr = floats(t.get("threshold", ""))
            left = ints(t.get("left_child", ""))
            right = ints(t.get("right_child", ""))
            leaves = floats(t.get("leaf_value", ""))
            # LightGBM leaf refs are encoded as -(leaf_idx)-1 already
            parsed.append((feat, thr, left, right, leaves, n_leaves))

        max_nodes = max(max(len(p[0]), 1) for p in parsed)
        max_leaves = max(p[5] for p in parsed)
        T = len(parsed)
        feature = np.zeros((T, max_nodes), dtype=np.int32)
        threshold = np.zeros((T, max_nodes), dtype=np.float32)
        left = np.full((T, max_nodes), -1, dtype=np.int32)
        right = np.full((T, max_nodes), -1, dtype=np.int32)
        leaf_value = np.zeros((T, max_leaves), dtype=np.float32)
        for i, (feat, thr, l, r, leaves, _) in enumerate(parsed):
            n = len(feat)
            if n == 0:  # single-leaf tree
                continue
            feature[i, :n] = feat
            threshold[i, :n] = thr
            left[i, :n] = l
            right[i, :n] = r
            leaf_value[i, : len(leaves)] = leaves
        depth = int(np.ceil(np.log2(max(max_leaves, 2)))) + 2
        return cls(feature, threshold, left, right, leaf_value, max_depth=max(depth, 4),
                   device=device)

    # -- training ------------------------------------------------------------------------
    @classmethod
    def train(
        cls,
        x: np.ndarray,
        y: np.ndarray,
        num_trees: int = 50,
        max_depth: int = 4,
        learning_rate: float = 0.1,
        min_samples: int = 4,
        device="cuda",
    ) -> "LambdaMART":
        """Gradient-boosted regression trees on (features, targets). For ranking,
        pass NDCG-style gains as targets (the reference trains lambdarank in
        LightGBM offline; this gives the framework a built-in trainer)."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        pred = np.zeros_like(y)
        trees = []
        for _ in range(num_trees):
            resid = y - pred
            tree = _fit_tree(x, resid, max_depth, min_samples)
            trees.append(tree)
            pred += learning_rate * _eval_tree_np(tree, x)

        max_nodes = max(max(len(t["feature"]), 1) for t in trees)
        max_leaves = max(len(t["leaves"]) for t in trees)
        T = len(trees)
        feature = np.zeros((T, max_nodes), dtype=np.int32)
        threshold = np.zeros((T, max_nodes), dtype=np.float32)
        left = np.full((T, max_nodes), -1, dtype=np.int32)
        right = np.full((T, max_nodes), -1, dtype=np.int32)
        leaf_value = np.zeros((T, max_leaves), dtype=np.float32)
        for i, t in enumerate(trees):
            n = len(t["feature"])
            if n:
                feature[i, :n] = t["feature"]
                threshold[i, :n] = t["threshold"]
                left[i, :n] = t["left"]
                right[i, :n] = t["right"]
            leaf_value[i, : len(t["leaves"])] = np.array(t["leaves"]) * learning_rate
        return cls(feature, threshold, left, right, leaf_value, max_depth=max_depth + 2,
                   device=device)


def signal_matrix(webpages: list) -> np.ndarray:
    """f32[len(webpages), NUM_SIGNALS]: the "rankingSignals" of served
    result pages as forest feature rows, each signal at its id (the
    collection step of tools/train_bench_lambdamart.py)."""
    from ...ranking import signals as S

    X = np.zeros((len(webpages), S.NUM_SIGNALS), dtype=np.float32)
    for i, w in enumerate(webpages):
        for name, v in w.get("rankingSignals", {}).items():
            X[i, S.signal(name).id] = v
    return X


# ---- numpy CART fitting (host-side training) --------------------------------

def _fit_tree(x, y, max_depth, min_samples):
    feature, threshold, left, right, leaves = [], [], [], [], []

    def build(idx, depth):
        if depth >= max_depth or len(idx) < min_samples or np.ptp(y[idx]) < 1e-12:
            leaves.append(float(np.mean(y[idx])) if len(idx) else 0.0)
            return -len(leaves)  # -(leaf_idx + 1)
        best = None
        parent_sse = np.var(y[idx]) * len(idx)
        for f in range(x.shape[1]):
            vals = x[idx, f]
            order = np.argsort(vals)
            sv, sy = vals[order], y[idx][order]
            csum = np.cumsum(sy)
            csq = np.cumsum(sy**2)
            n = len(sy)
            for cut in range(min_samples, n - min_samples + 1):
                if sv[cut - 1] == sv[min(cut, n - 1)]:
                    continue
                ls, lq = csum[cut - 1], csq[cut - 1]
                rs, rq = csum[-1] - ls, csq[-1] - lq
                sse = (lq - ls**2 / cut) + (rq - rs**2 / (n - cut))
                if best is None or sse < best[0]:
                    best = (sse, f, (sv[cut - 1] + sv[cut]) / 2.0)
        if best is None or best[0] >= parent_sse - 1e-12:
            leaves.append(float(np.mean(y[idx])))
            return -len(leaves)
        _, f, thr = best
        node_id = len(feature)
        feature.append(f)
        threshold.append(thr)
        left.append(0)
        right.append(0)
        l_idx = idx[x[idx, f] <= thr]
        r_idx = idx[x[idx, f] > thr]
        left[node_id] = build(l_idx, depth + 1)
        right[node_id] = build(r_idx, depth + 1)
        return node_id

    root = build(np.arange(len(y)), 0)
    if root < 0 and not feature:  # single leaf
        return {"feature": [], "threshold": [], "left": [], "right": [], "leaves": leaves}
    return {"feature": feature, "threshold": threshold, "left": left, "right": right, "leaves": leaves}


def _eval_tree_np(tree, x):
    if not tree["feature"]:
        return np.full(len(x), tree["leaves"][0])
    out = np.zeros(len(x))
    for i in range(len(x)):
        node = 0
        while node >= 0:
            f = tree["feature"][node]
            node = tree["left"][node] if x[i, f] <= tree["threshold"][node] else tree["right"][node]
        out[i] = tree["leaves"][-node - 1]
    return out
