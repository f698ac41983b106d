"""The port's host trainer grows the reference's trees bit for bit.

The reference asserts that its numpy trainer is bit-identical to its native
one; the port carries a copy of the numpy trainer, held here field for field
against ``repro``'s ``tree_backend="numpy"``.
"""
import numpy as np
import pytest

from repro.data.synthetic import friedman1, gaussian_classes
from repro.forest import ensemble as ref_ensemble
from repro.forest.training import Binner as RefBinner
from repro.forest.trees import pack_trees as ref_pack_trees
from repro_torch.forest import ensemble
from repro_torch.forest.training import (Binner, TreeParams,
                                         fit_forest_binned, fit_tree_binned)
from repro_torch.forest.trees import pack_trees, unpack_trees

TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_id", "value",
               "n_node_samples")


def _assert_same_trees(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for a, b in zip(ref_trees, port_trees):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        assert a.depth == b.depth


@pytest.mark.parametrize("model,kw", [
    ("RandomForest", {}),
    ("ExtraTrees", {}),
    ("RandomForest", {"max_depth": 4, "min_samples_leaf": 3}),
    ("RandomForest", {"max_features": None, "n_bins": 16}),
])
def test_classification_trees_bit_identical(model, kw):
    X, y = gaussian_classes(700, d=8, n_classes=4, seed=1)
    ref = getattr(ref_ensemble, model)(n_trees=6, seed=3,
                                       tree_backend="numpy",
                                       routing_backend="numpy", **kw).fit(X, y)
    port = getattr(ensemble, model)(n_trees=6, seed=3, device="cpu",
                                    **kw).fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)
    np.testing.assert_array_equal(ref.inbag_, port.inbag_)
    assert ref.n_classes_ == port.n_classes_
    np.testing.assert_array_equal(ref.binner_.edges_flat,
                                  port.binner_.edges_flat)
    packed = pack_trees(port.trees_)
    ref_packed = ref_pack_trees(ref.trees_)
    for k in ref_packed:
        np.testing.assert_array_equal(packed[k], ref_packed[k], err_msg=k)
    _assert_same_trees(ref.trees_, unpack_trees(packed))


def test_regression_trees_bit_identical():
    X, y = friedman1(500, d=6, seed=2)
    ref = ref_ensemble.RandomForest(n_trees=4, seed=0, task="regression",
                                    tree_backend="numpy",
                                    routing_backend="numpy").fit(X, y)
    port = ensemble.RandomForest(n_trees=4, seed=0, task="regression",
                                 device="cpu").fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)
    np.testing.assert_allclose(port.predict(X).numpy(), ref.predict(X),
                               rtol=0, atol=1e-10)


def test_batched_forest_equals_per_tree_growth():
    """fit_forest_binned (all trees level-synchronous) grows the same trees
    as growing each alone with its own RNG stream."""
    X, y = gaussian_classes(400, d=6, n_classes=3, seed=5)
    rng = np.random.default_rng(0)
    binner = Binner(X, 32, rng)
    Xb = binner.transform(X)
    inbag = np.stack([np.bincount(rng.integers(0, len(X), len(X)),
                                  minlength=len(X)) for _ in range(4)])
    params = TreeParams(n_classes=3, n_bins=32)
    batched = fit_forest_binned(Xb, y, inbag, params,
                                np.random.default_rng(9).spawn(4), binner,
                                tree_block=-1)
    rngs = np.random.default_rng(9).spawn(4)
    single = []
    for t in range(4):
        sel = np.nonzero(inbag[t])[0]
        single.append(fit_tree_binned(Xb[sel], y[sel],
                                      inbag[t, sel].astype(np.float64),
                                      params, rngs[t], binner))
    _assert_same_trees(single, batched)


def test_binner_matches_reference_and_round_trips():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(500, 5))
    X[::7, 1] = np.nan
    X[:, 3] = np.round(X[:, 3])                    # duplicate edges
    ref, port = RefBinner(X, 32), Binner(X, 32)
    np.testing.assert_array_equal(ref.transform(X), port.transform(X))
    back = Binner.from_state(port.edges_flat, port.edge_offset,
                             port.edge_count, port.n_bins)
    np.testing.assert_array_equal(back.transform(X), port.transform(X))


def test_forest_predictions_match_reference():
    X, y = gaussian_classes(600, d=8, n_classes=3, seed=8)
    ref = ref_ensemble.RandomForest(n_trees=5, seed=1, tree_backend="numpy",
                                    routing_backend="numpy").fit(X, y)
    port = ensemble.RandomForest(n_trees=5, seed=1, device="cpu").fit(X, y)
    Xq = X[:200] + 0.1
    np.testing.assert_allclose(port.predict_proba(Xq).numpy(),
                               ref.predict_proba(Xq), rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.oob_predict().numpy(), ref.oob_predict(),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.apply(Xq).numpy(), ref.apply(Xq))
