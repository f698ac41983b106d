"""The reference's small host-side public names, in the port.

``proximity_predict`` (the paper's Appendix I predict on the host CSR
maps), ``fit_tree``, ``Binner.edges`` / ``Binner.threshold``,
``route_forest_numpy`` and ``Tree.leaf_counts`` are host numpy code in both
packages.  Each is held against the reference: trees, routes, edges and
thresholds bit for bit, the predictions at atol 1e-12 on the fixture
``tests/test_swlc.py`` uses (``rf_kernel_cache``).
"""
import numpy as np
import pytest

from repro.core.factorization import proximity_predict as ref_predict
from repro.data.synthetic import gaussian_classes
from repro.forest import training as ref_training
from repro.forest import trees as ref_trees
from repro_torch.core.api import ForestKernel
from repro_torch.core.factorization import proximity_predict
from repro_torch.forest import training, trees

TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_id", "value",
               "n_node_samples")
ATOL = 1e-12


def _same_tree(a, b):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.depth == b.depth


def _port_tree(t):
    """A reference tree's arrays as the port's ``Tree``."""
    return trees.Tree(**{f: getattr(t, f).copy() for f in TREE_FIELDS},
                      depth=t.depth)


@pytest.fixture(scope="module")
def swlc(rf_kernel_cache):
    """The port's kernel of ``rf_kernel_cache``'s data and settings (its
    trees are the reference's, bit for bit) beside the reference's."""
    X, y = rf_kernel_cache["_data"]
    ref = rf_kernel_cache["gap"]
    port = ForestKernel(kernel_method="gap", n_trees=15, seed=0,
                        device="cpu").fit(X, y)
    return ref, port, X, y


def test_fixture_maps_are_the_references(swlc):
    ref, port, _, _ = swlc
    for a, b in ((ref.Q_, port.Q_), (ref.W_, port.W_)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.data, b.data, rtol=0, atol=ATOL)


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_proximity_predict_matches_reference(swlc, task, exclude_self):
    ref, port, X, y = swlc
    if task == "classification":
        target, kw = y, {"n_classes": int(y.max()) + 1}
    else:
        target, kw = X[:, 0] * 2.0 + y, {}
    want = ref_predict(ref.Q_, ref.W_, target, exclude_self=exclude_self,
                       **kw)
    got = proximity_predict(port.Q_, port.W_, target,
                            exclude_self=exclude_self, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if task == "classification" and not exclude_self:
        # the class scores' argmax is the kernel's OOB-style prediction
        np.testing.assert_array_equal(got.argmax(1),
                                      port.predict().numpy().astype(np.int64))


@pytest.mark.parametrize("seed", [0, 4])
def test_binner_edges_and_threshold_match_reference(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 6))
    X[::5, 2] = np.nan
    X[:, 4] = np.round(X[:, 4])                  # duplicate edges collapse
    X[:, 5] = 1.0                                # a constant feature
    ref = ref_training.Binner(X, 16, np.random.default_rng(seed))
    port = training.Binner(X, 16, np.random.default_rng(seed))
    assert len(port.edges) == len(ref.edges) == X.shape[1]
    for a, b in zip(ref.edges, port.edges):
        np.testing.assert_array_equal(a, b)
    for f in range(X.shape[1]):
        for b in range(-1, 18):
            want = ref.threshold(f, b)
            got = port.threshold(f, b)
            assert got == want or (np.isinf(got) and np.isinf(want)), (f, b)
            vec = port.thresholds(np.array([f]), np.array([max(b, 0)]))[0]
            if b >= 0:
                assert vec == got or (np.isinf(vec) and np.isinf(got))


@pytest.mark.parametrize("task,splitter", [("classification", "best"),
                                           ("classification", "random"),
                                           ("regression", "best")])
def test_fit_tree_matches_reference_and_binned_path(task, splitter):
    X, y = gaussian_classes(300, d=7, n_classes=3, seed=2)
    if task == "regression":
        y = np.round(X[:, 0] * 4.0)              # integer payloads: exact sums
    w = np.random.default_rng(1).integers(1, 4, len(X)).astype(np.float64)
    kw = dict(task=task, n_classes=3, n_bins=32, splitter=splitter,
              min_samples_leaf=2)
    params = training.TreeParams(tree_backend="numpy", **kw)
    ref_params = ref_training.TreeParams(tree_backend="numpy", **kw)
    got = training.fit_tree(X, y, w, params, np.random.default_rng(7),
                            device="cpu")
    want = ref_training.fit_tree(X, y, w, ref_params,
                                 np.random.default_rng(7))
    _same_tree(want, got)
    # the same draw order as binning first and growing on the codes
    rng = np.random.default_rng(7)
    binner = training.Binner(X, params.n_bins, rng)
    binned = training.fit_tree_binned(binner.transform(X), y, w, params, rng,
                                      binner, device="cpu")
    _same_tree(binned, got)
    # a given binner is used as it is, the rng only grows the tree
    b2 = training.Binner(X, params.n_bins, np.random.default_rng(3))
    rb2 = ref_training.Binner(X, params.n_bins, np.random.default_rng(3))
    _same_tree(ref_training.fit_tree(X, y, w, ref_params,
                                     np.random.default_rng(8), rb2),
               training.fit_tree(X, y, w, params, np.random.default_rng(8),
                                 b2, device="cpu"))


def test_fit_tree_defaults_to_the_card():
    X, y = gaussian_classes(40, d=3, n_classes=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        training.fit_tree(X, y, np.ones(len(X)),
                          training.TreeParams(tree_backend="torch"),
                          np.random.default_rng(0))


def test_route_forest_numpy_and_leaf_counts_match_reference(swlc):
    ref, port, X, _ = swlc
    ref_forest = list(ref.forest.trees_)
    port_forest = [_port_tree(t) for t in ref_forest]
    Xq = np.vstack([X[:50], X[:20] + 0.37])
    Xq[3, 2] = np.nan
    want = ref_trees.route_forest_numpy(ref_forest, Xq)
    got = trees.route_forest_numpy(port_forest, Xq)
    assert got.dtype == np.int32 and got.shape == (len(Xq), len(ref_forest))
    np.testing.assert_array_equal(got, want)
    # the batched router agrees with the oracle
    ta = trees.TreeArrays.from_trees(port_forest)
    np.testing.assert_array_equal(
        trees.route_forest_batched(ta, Xq, device="cpu").numpy(), got)
    for a, b in zip(ref_forest, port_forest):
        counts = b.leaf_counts()
        assert counts.dtype == np.int64 and len(counts) == b.n_leaves
        np.testing.assert_array_equal(counts, a.leaf_counts())
