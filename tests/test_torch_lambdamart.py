"""Parity of the port's LambdaMART (stract_tpu_torch/ranking/models/
lambdamart.py, ops/forest.py: K4) with the JAX package's _gbdt_forward on the
CPU, on the same forests and the same seeded feature matrices: a trained
forest through the from_json round trip, the LightGBM fixture of
tests/test_models.py, rows exactly at thresholds, K not a power of two, a
tree deeper than max_depth. The K4 kernel itself is held against the plain
twin on a card in test_torch_kernels.py.

Tolerance: both walk the same leaves (the walk is exact: integer indices and
f32 comparisons of the same values), so leaves agree exactly and only the
f32 sum over the trees may be taken in another order: scores within rtol
1e-6 plus an atol of 1e-6 times the sum of |leaf values| along the row's
walk bound (cancellation), rank order equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from stract_tpu.ranking.models.lambdamart import LambdaMART as JaxLM
from stract_tpu.ranking.models.lambdamart import _gbdt_forward
from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

LIGHTGBM = """tree
version=v4
objective=lambdarank

Tree=0
num_leaves=3
split_feature=0 1
threshold=0.5 1.5
left_child=-1 -2
right_child=1 -3
leaf_value=0.1 0.2 0.3

Tree=1
num_leaves=2
split_feature=1
threshold=2.0
left_child=-1
right_child=-2
leaf_value=-0.05 0.05

end of trees
"""


def _jax_scores(jm: JaxLM, x: np.ndarray) -> np.ndarray:
    return np.asarray(_gbdt_forward(jm.feature, jm.threshold, jm.left, jm.right,
                                    jm.leaf_value, jnp.asarray(x), jm.max_depth))


def _assert_same(port: np.ndarray, ref: np.ndarray, leaf_value) -> None:
    atol = 1e-6 * float(np.abs(np.asarray(leaf_value)).max(axis=1).sum())
    assert port.shape == ref.shape and port.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=atol)
    assert np.array_equal(np.argsort(-port, kind="stable"), np.argsort(-ref, kind="stable"))


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = 2 * x[:, 0] + x[:, 5] * x[:, 7] + (x[:, 11] > 0.3)
    return JaxLM.train(x, y, num_trees=40, max_depth=3), rng


@pytest.mark.parametrize("k", [1, 7, 255, 256, 300, 1000])
def test_predict_matches_jax(trained, k):
    jm, rng = trained
    pm = LambdaMART.from_json(jm.to_json(), device="cpu")
    x = rng.normal(size=(k, 46)).astype(np.float32)
    _assert_same(pm.predict(x), np.asarray(jm.predict(x)), jm.leaf_value)
    _assert_same(pm.predict(x), _jax_scores(jm, x), jm.leaf_value)  # unpadded


def test_rows_exactly_at_thresholds(trained):
    """x == threshold goes left (x <= thr) in both."""
    jm, rng = trained
    pm = LambdaMART.from_json(jm.to_json(), device="cpu")
    thr, feat = np.asarray(jm.threshold), np.asarray(jm.feature)
    x = rng.normal(size=(64, 46)).astype(np.float32)
    for i in range(64):
        t = i % thr.shape[0]
        x[i, feat[t, 0]] = thr[t, 0]  # the root split of tree t, exactly
    _assert_same(pm.predict(x), np.asarray(jm.predict(x)), jm.leaf_value)
    above = np.nextafter(x, np.float32(np.inf))
    assert pm.split_between(x, above).all()  # a step up crosses the split
    assert not pm.split_between(x, x).any()


def test_train_and_json_match_jax(trained):
    """The copied numpy trainer grows the same forest; to_json round-trips."""
    jm, _ = trained
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = 2 * x[:, 0] + x[:, 5] * x[:, 7] + (x[:, 11] > 0.3)
    pm = LambdaMART.train(x, y, num_trees=40, max_depth=3, device="cpu")
    assert pm.to_json() == jm.to_json()
    assert LambdaMART.from_json(pm.to_json(), device="cpu").to_json() == pm.to_json()


def test_lightgbm_fixture_matches_jax(tmp_path):
    jm, pm = JaxLM.parse_lightgbm(LIGHTGBM), LambdaMART.parse_lightgbm(LIGHTGBM, device="cpu")
    assert pm.num_trees == 2 and pm.max_depth == jm.max_depth
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, 3.0], [0.5, 1.5], [0.5, 2.0]], np.float32)
    _assert_same(pm.predict(x), np.asarray(jm.predict(x)), jm.leaf_value)
    np.testing.assert_allclose(pm.predict(x[:3]), [0.05, 0.15, 0.35], atol=1e-6)
    (tmp_path / "model.txt").write_text(LIGHTGBM)
    (tmp_path / "model.json").write_text(pm.to_json())
    for f in ("model.txt", "model.json"):  # the coordinator's loader: text or JSON
        np.testing.assert_array_equal(LambdaMART.load(str(tmp_path / f), device="cpu").predict(x),
                                      pm.predict(x))


def test_production_sized_lightgbm_dump_matches_jax(tmp_path):
    """A seeded LightGBM dump of 500 trees of 31 leaves (LightGBM's default
    num_leaves; past one block of the card's shared memory, so K4 walks it
    in chunks of trees), parsed by both packages' parse_lightgbm into the
    same tensors, scored by the port's plain walk and by _gbdt_forward on
    300 seeded rows within the forest tolerance; LambdaMART.load (the
    serving loader of `main.py serve --lambdamart`) reads the same forest."""
    from stract_tpu_torch.bench_corpus import synthetic_lightgbm

    text = synthetic_lightgbm(500, 31, 46, 0)
    jm, pm = JaxLM.parse_lightgbm(text), LambdaMART.parse_lightgbm(text, device="cpu")
    assert pm.feature.shape == (500, 30) and pm.leaf_value.shape == (500, 31)
    assert pm.max_depth == jm.max_depth
    for a, b in zip(pm._arrays(), (jm.feature, jm.threshold, jm.left, jm.right, jm.leaf_value)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(7).normal(size=(300, 46)).astype(np.float32)
    _assert_same(pm.predict(x), _jax_scores(jm, x), jm.leaf_value)
    (tmp_path / "model.txt").write_text(text)
    np.testing.assert_array_equal(LambdaMART.load(str(tmp_path / "model.txt"),
                                                  device="cpu").predict(x), pm.predict(x))


def test_tree_deeper_than_max_depth():
    """A walk still on an internal node after max_depth steps reads
    leaf_value[t, 0] (the reference's clip), in both packages."""
    # one chain tree of depth 5: node i splits feature i at 0 → left leaf i,
    # right node i+1; the last node's right child is leaf 5
    N = 5
    feature = np.arange(N, dtype=np.int32)[None]
    threshold = np.zeros((1, N), np.float32)
    left = -(np.arange(N, dtype=np.int32) + 1)[None]
    right = np.array([[1, 2, 3, 4, -6]], np.int32)
    leaf = np.array([[10.0, 1.0, 2.0, 3.0, 4.0, 5.0]], np.float32)
    x = np.ones((9, N), np.float32)  # always right: five steps to the last leaf
    x[1, 0] = -1.0                   # left at the root: leaf 0
    x[2, 3] = -1.0                   # left at node 3: leaf 3
    for depth in (2, 4, 5, 6):
        jm = JaxLM(feature, threshold, left, right, leaf, depth)
        pm = LambdaMART(feature, threshold, left, right, leaf, depth, device="cpu")
        _assert_same(pm.predict(x), np.asarray(jm.predict(x)), leaf)
    short = LambdaMART(feature, threshold, left, right, leaf, 2, device="cpu").predict(x)
    assert short[0] == 10.0 and short[1] == 10.0  # unfinished walk → leaf_value[t, 0]
