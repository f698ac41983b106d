"""The depth-prefix tier of the port against the reference's.

Truncated trees field for field, the leaf contraction and the prefix
engine's leaf codes bit for bit, and its ops at 1e-8, on the reference's
application fixture (``gaussian_classes(180, d=8, n_classes=3, sep=3.0,
seed=5)``, 12 trees, seed 0) carried across with
``forest_kernel_from_arrays``; the port runs on the CPU.  The prefix tier
contracts the parent's routed states, so its OOS ops never route.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.core.factorization import \
    prefix_leaf_contraction as ref_contraction
from repro.data.synthetic import gaussian_classes
from repro.forest import trees as ref_trees
from repro_torch.core.convert import forest_kernel_from_arrays
from repro_torch.core.engine import PrefixProximityEngine
from repro_torch.core.factorization import prefix_leaf_contraction
from repro_torch.forest import trees as port_trees
from repro_torch.kernels.leaf_route import ops as route_ops

ATOL = 1e-8
N_CLASSES = 3
DEPTHS = (1, 2, 4)
FIELDS = ("feature", "threshold", "left", "right", "leaf_id", "value",
          "n_node_samples", "depth")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    X, y = gaussian_classes(180, d=8, n_classes=N_CLASSES, sep=3.0, seed=5)
    d = tmp_path_factory.mktemp("prefix")
    out, shared = {}, None
    for m in ("gap", "kerf"):
        ref = RefKernel(kernel_method=m, n_trees=12, seed=0,
                        routing_backend="numpy", tree_backend="numpy",
                        engine_backend="scipy")
        if shared is None:
            ref.fit(X, y)
            shared = ref.forest
        else:
            ref.forest = shared
            ref.build_kernel_cache()
        path = d / f"{m}.npz"
        ref.save(path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        config = json.loads(bytes(arrays.pop("manifest")).decode())["config"]
        out[m] = (ref, forest_kernel_from_arrays(arrays, config,
                                                 device="cpu"))
    out["_data"] = (X, y)
    return out


def _oos(kernels):
    X, _ = kernels["_data"]
    return X[:30] + 1e-3


@pytest.mark.parametrize("depth", DEPTHS)
def test_truncated_trees_equal_field_for_field(kernels, depth):
    ref, port = kernels["gap"]
    for a, b in zip(ref.forest.trees_, port.forest.trees_):
        np.testing.assert_array_equal(port_trees.node_depths(b),
                                      ref_trees.node_depths(a))
        ta, tb = ref_trees.truncate_tree(a, depth), \
            port_trees.truncate_tree(b, depth)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tb, f), getattr(ta, f))
        np.testing.assert_array_equal(port_trees.prefix_leaf_map(b, depth),
                                      ref_trees.prefix_leaf_map(a, depth))
    tf, rf = port.forest.truncated(depth), ref.forest.truncated(depth)
    for a, b in zip(rf.trees_, tf.trees_):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    np.testing.assert_array_equal(tf.leaf_values_, rf.leaf_values_)
    assert tf.inbag_ is port.forest.inbag_
    assert tf.route_tables_.device == port.forest.route_tables_.device


def test_truncate_rejects_depth_zero(kernels):
    _, port = kernels["gap"]
    with pytest.raises(ValueError, match="depth"):
        port_trees.truncate_tree(port.forest.trees_[0], 0)


@pytest.mark.parametrize("depth", DEPTHS)
def test_truncated_forest_routes_like_route_tree(kernels, depth):
    """The routing kernel's plain version on the truncated forest's tables
    is bit-exact to the per-tree oracle, and to the contraction of the full
    forest's leaves."""
    X, _ = kernels["_data"]
    _, port = kernels["gap"]
    tf = port.forest.truncated(depth)
    leaves = _np(tf.apply(X))
    for t, tree in enumerate(tf.trees_):
        np.testing.assert_array_equal(leaves[:, t],
                                      port_trees.route_tree(tree, X))
    full = _np(port.forest.apply(X))
    for t, tree in enumerate(port.forest.trees_):
        np.testing.assert_array_equal(
            port_trees.prefix_leaf_map(tree, depth)[full[:, t]],
            leaves[:, t])


@pytest.mark.parametrize("depth", DEPTHS)
def test_prefix_leaf_contraction_bit_for_bit(kernels, depth):
    ref, port = kernels["gap"]
    got = prefix_leaf_contraction(port.forest.trees_, depth)
    want = ref_contraction(ref.forest.trees_, depth)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["gap", "kerf"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_prefix_engine_codes_and_factors(kernels, method, depth):
    ref, port = kernels[method]
    pe, re = port.prefix_engine(depth), ref.prefix_engine(depth)
    assert isinstance(pe, PrefixProximityEngine)
    assert pe.total_leaves == re.total_leaves
    np.testing.assert_array_equal(_np(pe.gl), re.gl)
    np.testing.assert_array_equal(_np(pe.q), re.q)
    np.testing.assert_array_equal(_np(pe.w), re.w)
    np.testing.assert_array_equal(_np(pe.ctx.leaf_mass), re.ctx.leaf_mass)
    Xq = _oos(kernels)
    qs, rqs = pe.query_state(Xq), re.query_state(Xq)
    np.testing.assert_array_equal(_np(qs.gl), rqs.gl)
    np.testing.assert_array_equal(_np(qs.q), rqs.q)
    assert qs.gl.dtype == torch.int32


@pytest.mark.parametrize("side", ["train", "oos"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_prefix_engine_ops_match_reference(kernels, depth, side):
    ref, port = kernels["gap"]
    pe, re = port.prefix_engine(depth), ref.prefix_engine(depth)
    X = None if side == "train" else _oos(kernels)
    y = ref.ctx.y
    _close(pe.predict(y, N_CLASSES, X=X), re.predict(y, N_CLASSES, X=X))
    _close(pe.row_sums(X=X), re.row_sums(X=X))
    _close(pe.kernel_block(None, X_rows=X) if X is not None
           else pe.kernel_block(np.arange(40)),
           re.kernel_block(None, X_rows=X) if X is not None
           else re.kernel_block(np.arange(40)))
    _close(pe.topk(5, X=X)[1], re.topk(5, X=X)[1])
    _close(pe.squared_row_sums(y, N_CLASSES, X=X),
           re.squared_row_sums(y, N_CLASSES, X=X))


def test_prefix_oos_ops_never_route(kernels, monkeypatch):
    """Once the parent has routed a batch, the prefix tier's OOS predict
    launches no routing at all (neither the truncated forest's nor the
    parent's)."""
    ref, port = kernels["gap"]
    pe = port.prefix_engine(4)
    Xq = _oos(kernels) * 1.1
    port.engine.query_state(Xq)

    def forbidden(*a, **k):
        raise AssertionError("the prefix tier routed a batch")
    monkeypatch.setattr(route_ops, "route_ref", forbidden)
    monkeypatch.setattr(type(pe.forest), "apply", forbidden)
    y = ref.ctx.y
    _close(pe.predict(y, N_CLASSES, X=Xq),
           ref.prefix_engine(4).predict(y, N_CLASSES, X=Xq))


def test_prefix_engine_without_forest_raises(kernels):
    _, port = kernels["gap"]
    eng = port.engine
    keep = eng.forest
    try:
        eng.forest = None
        with pytest.raises(ValueError, match="forest"):
            PrefixProximityEngine(eng, 2)
    finally:
        eng.forest = keep


def test_prefix_margins_escalate_less_confident_rows(kernels):
    """The prefix tier's vote margins are the reference's."""
    from repro.core.engine import prediction_margin as ref_margin
    from repro_torch.core.engine import prediction_margin
    ref, port = kernels["gap"]
    Xq = _oos(kernels)
    y = ref.ctx.y
    s = port.prefix_engine(2).predict(y, N_CLASSES, X=Xq)
    r = ref.prefix_engine(2).predict(y, N_CLASSES, X=Xq)
    _close(prediction_margin(s), ref_margin(r))
    np.testing.assert_array_equal(_np(prediction_margin(torch.as_tensor(r))),
                                  ref_margin(r))
