"""The port's trainers grow the reference's trees bit for bit.

The reference asserts that its numpy trainer is bit-identical to its native
one and, on integer payloads, to its jax one; the port carries a copy of
the driver with a numpy and a torch backend, held here field for field
against ``repro``'s ``tree_backend="numpy"`` (the torch backend on CPU
tensors, through the histogram kernels' plain versions).  Gradient
boosting is held against the reference's, exactly on the host trainers and
within the reference's own bounds on continuous residuals.
"""
import numpy as np
import pytest

from repro.data.synthetic import friedman1, gaussian_classes
from repro.forest import ensemble as ref_ensemble
from repro.forest import training as ref_training
from repro.forest.training import Binner as RefBinner
from repro.forest.trees import pack_trees as ref_pack_trees
from repro_torch.forest import ensemble
from repro_torch.forest import training
from repro_torch.forest.training import (Binner, TreeParams,
                                         fit_forest_binned, fit_tree_binned,
                                         resolve_tree_backend)
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
                                tree_block=-1, device="cpu")
    rngs = np.random.default_rng(9).spawn(4)
    single = []
    for t in range(4):
        sel = np.nonzero(inbag[t])[0]
        single.append(fit_tree_binned(Xb[sel], y[sel],
                                      inbag[t, sel].astype(np.float64),
                                      params, rngs[t], binner,
                                      device="cpu"))
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


# ------------------------------------------------------------ torch backend

def _int_regression(n=700, d=8, seed=5):
    """Integer targets: the (Σw, Σwy, Σwy²) moments are exact in float32,
    so the torch backend's trees equal the numpy trainer's bit for bit."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    return X, np.floor(X[:, 0] * 5 + X[:, 1] * 3).astype(np.float64)


def _data(task, seed=3):
    if task == "classification":
        return gaussian_classes(900, d=10, n_classes=3, seed=seed)
    return _int_regression(seed=seed)


@pytest.mark.parametrize("model,task", [
    ("RandomForest", "classification"), ("ExtraTrees", "classification"),
    ("RandomForest", "regression"), ("ExtraTrees", "regression")])
def test_torch_backend_trees_bit_identical_to_reference(model, task):
    """The four cases of the reference's test_jax_backend_identical_trees,
    through the torch backend on the CPU."""
    X, y = _data(task)
    ref = getattr(ref_ensemble, model)(n_trees=5, seed=0, task=task,
                                       tree_backend="numpy").fit(X, y)
    port = getattr(ensemble, model)(n_trees=5, seed=0, task=task,
                                    device="cpu", tree_backend="torch")
    port.fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)


@pytest.mark.parametrize("block", [1, 0, -1])
def test_torch_batched_equals_per_tree(block):
    X, y = gaussian_classes(700, d=8, n_classes=3, seed=6)
    rng = np.random.default_rng(0)
    binner = Binner(X, 64, rng)
    Xb = binner.transform(X)
    inbag = np.stack([np.bincount(rng.integers(0, len(X), len(X)),
                                  minlength=len(X)) for _ in range(4)])
    params = TreeParams(task="classification", n_classes=3)

    def grow(backend, b):
        return fit_forest_binned(Xb, y, inbag, params,
                                 np.random.default_rng(7).spawn(4), binner,
                                 backend=backend, tree_block=b, device="cpu")
    _assert_same_trees(grow("numpy", 1), grow("torch", block))


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_torch_subtraction_halves_work_and_keeps_trees(task, monkeypatch):
    """Sibling histograms derived as parent − child (float32 on the
    device) leave every tree unchanged and accumulate fewer samples."""
    X, y = _data(task, seed=12)
    seen = []
    real = training.hops

    class Spy:
        def histogram(self, xb, node, *a, **k):
            seen.append(len(a[0]))                 # samples: y's length
            return real.histogram(xb, node, *a, **k)

        def moments(self, xb, node, *a, **k):
            seen.append(len(a[0]))                 # samples: wm's rows
            return real.moments(xb, node, *a, **k)

    monkeypatch.setattr(training, "hops", Spy())
    fits, work = {}, {}
    for sub in (True, False):
        if not sub:
            monkeypatch.setattr(training, "_SUB_MAX_PARENTS", 0)
        seen.clear()
        fits[sub] = ensemble.RandomForest(
            n_trees=4, seed=3, task=task, device="cpu",
            tree_backend="torch").fit(X, y).trees_
        work[sub] = sum(seen)
    _assert_same_trees(fits[False], fits[True])
    assert work[True] < work[False], work


@pytest.mark.parametrize("model", ["RandomForest", "ExtraTrees"])
def test_torch_tiny_hist_budget_many_chunks(model, monkeypatch):
    """A histogram budget of a few nodes splits every level into many
    chunks (and ExtraTrees' split-point and feature draws into many
    interleaved parts): trees still equal the reference's under the same
    budget."""
    X, y = gaussian_classes(500, d=6, n_classes=3, seed=9)
    budget = 6 * 32 * 3 * 4                       # four nodes a chunk
    monkeypatch.setattr(training, "_HIST_BUDGET", budget)
    monkeypatch.setattr(ref_training, "_HIST_BUDGET", budget)
    kw = dict(n_trees=3, seed=1, n_bins=32)
    ref = getattr(ref_ensemble, model)(tree_backend="numpy", **kw).fit(X, y)
    port = getattr(ensemble, model)(device="cpu", tree_backend="torch",
                                    **kw).fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)


def test_torch_backend_matches_reference_jax_backend():
    """One tiny case against the reference's own device trainer (float64
    scoring, set by the test as the reference's tests do)."""
    import jax
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        X, y = gaussian_classes(300, d=6, n_classes=3, seed=2)
        ref = ref_ensemble.RandomForest(n_trees=2, seed=0, max_depth=6,
                                        tree_backend="jax").fit(X, y)
    finally:
        jax.config.update("jax_enable_x64", old)
    port = ensemble.RandomForest(n_trees=2, seed=0, max_depth=6,
                                 device="cpu", tree_backend="torch")
    _assert_same_trees(ref.trees_, port.fit(X, y).trees_)


def test_continuous_regression_agreement():
    """Continuous targets: float32 histograms may flip near-tied splits, so
    the torch backend is held to the reference's jax-backend bounds."""
    X, y = friedman1(800, seed=3)
    ref = ref_ensemble.RandomForest(n_trees=10, seed=0, task="regression",
                                    tree_backend="numpy").fit(X, y)
    port = ensemble.RandomForest(n_trees=10, seed=0, task="regression",
                                 device="cpu", tree_backend="torch")
    pn, pt = ref.predict(X), port.fit(X, y).predict(X).numpy()
    assert np.abs(pn - pt).mean() <= 0.05 * y.std()
    assert np.abs(pn - pt).max() <= 0.5 * y.std()


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_gbt_host_trainer_bit_identical_to_reference(task):
    X, y = _int_regression(seed=9)
    if task == "classification":
        y = (y > 3).astype(np.int64)
    kw = dict(n_trees=8, seed=0, task=task)
    ref = ref_ensemble.GradientBoostedTrees(
        tree_backend="numpy", routing_backend="numpy", **kw).fit(X, y)
    port = ensemble.GradientBoostedTrees(device="cpu", tree_backend="numpy",
                                         **kw).fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)
    np.testing.assert_array_equal(port.tree_weights_, ref.tree_weights_)
    assert port.base_score_ == ref.base_score_
    np.testing.assert_allclose(port.decision_function(X).numpy(),
                               ref.decision_function(X), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.predict(X).numpy(), ref.predict(X))


def test_gbt_torch_backend_agrees_with_reference():
    """GBT stages fit continuous residuals, so the torch backend is held to
    the reference's test_jax_gbt_agreement bound."""
    X, y = _int_regression(seed=9)
    ref = ref_ensemble.GradientBoostedTrees(
        n_trees=8, seed=0, task="regression", tree_backend="numpy").fit(X, y)
    port = ensemble.GradientBoostedTrees(n_trees=8, seed=0,
                                         task="regression", device="cpu",
                                         tree_backend="torch").fit(X, y)
    assert np.abs(port.predict(X).numpy() - ref.predict(X)).max() \
        <= 0.05 * y.std() + 1e-9
    assert port.base_score_ == ref.base_score_
    np.testing.assert_allclose(port.tree_weights_, ref.tree_weights_,
                               rtol=0, atol=0.05)


def test_resolve_tree_backend():
    assert resolve_tree_backend("auto", "cpu") == "numpy"
    assert resolve_tree_backend(None, "cpu") == "numpy"
    assert resolve_tree_backend("torch", "cpu") == "torch"
    assert resolve_tree_backend("numpy", "cpu") == "numpy"
    for bad in ("native", "jax", "pallas"):
        with pytest.raises(ValueError, match="tree backend"):
            resolve_tree_backend(bad, "cpu")
    X, y = gaussian_classes(200, d=4, n_classes=2, seed=0)
    with pytest.raises(ValueError, match="tree backend"):
        ensemble.RandomForest(n_trees=2, device="cpu",
                              tree_backend="native").fit(X, y)


def test_binned_entry_points_default_to_the_card(monkeypatch):
    """fit_forest_binned / fit_tree_binned with no device ask for the card
    and raise when there is none; they never train on the host unasked."""
    X, y = gaussian_classes(200, d=4, n_classes=2, seed=0)
    binner = Binner(X, 16)
    Xb = binner.transform(X)
    inbag = np.ones((2, len(X)), np.int64)
    params = TreeParams(n_classes=2, n_bins=16)
    asked = []
    real = training.resolve_device

    def spy(device="cuda"):
        asked.append(str(device))
        return real(device)

    monkeypatch.setattr(training, "resolve_device", spy)
    monkeypatch.setattr(training.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_forest_binned(Xb, y, inbag, params,
                          np.random.default_rng(0).spawn(2), binner)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_tree_binned(Xb, y, np.ones(len(X)), params,
                        np.random.default_rng(0), binner)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_tree_backend("auto")
    assert asked == ["cuda"] * 3
    # asked for the host, they grow on it
    trees = fit_forest_binned(Xb, y, inbag, params,
                              np.random.default_rng(0).spawn(2), binner,
                              device="cpu")
    assert len(trees) == 2 and asked[-1] == "cpu"


def test_auto_backend_on_the_cpu_grows_on_the_host_trainer(monkeypatch):
    """RandomForest(device='cpu', tree_backend='auto') runs the numpy
    trainer (no histogram wrapper is called) and grows the reference's
    trees."""
    X, y = gaussian_classes(500, d=6, n_classes=3, seed=4)
    calls = []
    real = training.hops

    class Spy:
        def histogram(self, *a, **k):
            calls.append("histogram")
            return real.histogram(*a, **k)

        def moments(self, *a, **k):
            calls.append("moments")
            return real.moments(*a, **k)

    monkeypatch.setattr(training, "hops", Spy())
    port = ensemble.RandomForest(n_trees=3, seed=2, device="cpu",
                                 tree_backend="auto").fit(X, y)
    assert calls == []
    ref = ref_ensemble.RandomForest(n_trees=3, seed=2, tree_backend="numpy",
                                    routing_backend="numpy").fit(X, y)
    _assert_same_trees(ref.trees_, port.trees_)
