"""The port's kernel wrappers on the CPU, held against the JAX reference.

On a CPU tensor each wrapper runs its kernel's plain PyTorch version; that
version is held here against the reference's own routing (bit-exact) and
against the reference's Pallas kernels run in interpret mode.  The CUDA
kernels themselves run only on the card, where ``chip_smoke.py`` holds them
against the same plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import gaussian_classes
from repro.forest.ensemble import RandomForest as RefForest
from repro.forest.trees import Tree as RefTree
from repro.forest.trees import TreeArrays as RefTreeArrays
from repro.forest.trees import pack_trees as ref_pack_trees
from repro.forest.trees import route_forest_batched as ref_route
from repro.kernels.block_prox.block_prox import block_prox_pallas
from repro.kernels.leaf_route.leaf_route import route_pallas
from repro_torch.forest.trees import (TreeArrays, route_forest_batched,
                                      route_tree, unpack_trees)
from repro_torch.kernels import _build
from repro_torch.kernels.block_prox import ops as bp_ops
from repro_torch.kernels.block_prox.ops import block_prox
from repro_torch.kernels.leaf_route import ops as lr_ops
from repro_torch.kernels.leaf_route.ops import route, route_tables


def _single_node_tree() -> RefTree:
    return RefTree(feature=np.array([-1], np.int32),
                   threshold=np.array([np.inf], np.float32),
                   left=np.zeros(1, np.int32), right=np.zeros(1, np.int32),
                   leaf_id=np.zeros(1, np.int32),
                   value=np.ones((1, 2), np.float32),
                   n_node_samples=np.ones(1, np.int32), depth=0)


def _random_tree(rng: np.random.Generator, n_nodes: int, d: int) -> RefTree:
    """Random full binary tree in id order (children exceed the parent)."""
    feature = np.full(n_nodes, -1, np.int32)
    threshold = np.zeros(n_nodes, np.float32)
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    depth = np.zeros(n_nodes, np.int64)
    next_free = 1
    for node in range(n_nodes):
        if next_free + 1 >= n_nodes or node >= next_free:
            continue
        if rng.random() < 0.8 or node == 0:
            feature[node] = rng.integers(0, d)
            threshold[node] = np.float32(rng.normal())
            left[node], right[node] = next_free, next_free + 1
            depth[next_free:next_free + 2] = depth[node] + 1
            next_free += 2
    leaves = feature == -1
    leaf_id = np.full(n_nodes, -1, np.int32)
    leaf_id[leaves] = np.arange(leaves.sum(), dtype=np.int32)
    return RefTree(feature=feature, threshold=threshold, left=left,
                   right=right, leaf_id=leaf_id,
                   value=np.ones((n_nodes, 2), np.float32),
                   n_node_samples=np.ones(n_nodes, np.int32),
                   depth=int(depth.max()))


def _port_route(ref_trees, X) -> np.ndarray:
    """Carry reference trees across (pack → unpack) and route on the CPU."""
    ta = TreeArrays.from_trees(unpack_trees(ref_pack_trees(ref_trees)))
    out = route_forest_batched(ta, X, device="cpu")
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    return out.numpy()


def _ref_numpy_route(ref_trees, X) -> np.ndarray:
    return ref_route(RefTreeArrays.from_trees(ref_trees), X, backend="numpy")


@pytest.fixture(scope="module")
def fitted_ref_forest():
    X, y = gaussian_classes(900, d=9, n_classes=3, seed=4)
    rf = RefForest(n_trees=9, seed=2, tree_backend="numpy",
                   routing_backend="numpy").fit(X, y)
    return rf, X


# ----------------------------------------------------------------- K1 plain

def test_route_plain_matches_numpy_router_random_data(fitted_ref_forest):
    rf, X = fitted_ref_forest
    rng = np.random.default_rng(0)
    Xq = np.concatenate([X, rng.normal(scale=3.0, size=(300, X.shape[1]))])
    got = _port_route(rf.trees_, Xq)
    np.testing.assert_array_equal(got, _ref_numpy_route(rf.trees_, Xq))
    # and the port's own per-tree oracle
    for t, tr in enumerate(unpack_trees(ref_pack_trees(rf.trees_))):
        np.testing.assert_array_equal(got[:, t], route_tree(tr, Xq))


def test_route_plain_matches_numpy_router_on_thresholds(fitted_ref_forest):
    """Samples exactly on split thresholds (x <= thr goes left), taken from
    every internal node of the fitted trees."""
    rf, X = fitted_ref_forest
    rng = np.random.default_rng(1)
    Xq = np.repeat(X[:60], 4, axis=0)
    for tr in rf.trees_:
        internal = np.flatnonzero(tr.feature >= 0)
        pick = rng.choice(internal, size=len(Xq))
        Xq[np.arange(len(Xq)), tr.feature[pick]] = \
            tr.threshold[pick].astype(np.float64)
    np.testing.assert_array_equal(_port_route(rf.trees_, Xq),
                                  _ref_numpy_route(rf.trees_, Xq))


def test_route_plain_nan_features_go_right():
    rng = np.random.default_rng(11)
    trees = [_random_tree(rng, 31, d=3) for _ in range(4)]
    X = rng.normal(size=(40, 3))
    X[::3, 0] = np.nan
    X[1::4, 2] = np.nan
    np.testing.assert_array_equal(_port_route(trees, X),
                                  _ref_numpy_route(trees, X))


def test_route_plain_stumps_and_padding():
    """All-stump ensembles land in leaf 0; stumps padded next to a deep
    tree stay inert."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(64, 4))
    stumps = [_single_node_tree() for _ in range(3)]
    np.testing.assert_array_equal(_port_route(stumps, X),
                                  np.zeros((64, 3), np.int32))
    mixed = [_single_node_tree(), _random_tree(rng, 63, d=4),
             _single_node_tree()]
    np.testing.assert_array_equal(_port_route(mixed, X),
                                  _ref_numpy_route(mixed, X))


def test_route_plain_matches_route_pallas_on_float32_exact_data(
        fitted_ref_forest):
    """route_pallas compares in float32; on data exact in float32 the
    float64 comparison gives the same leaves."""
    rf, X = fitted_ref_forest
    Xf = X.astype(np.float32).astype(np.float64)
    ta = RefTreeArrays.from_trees(rf.trees_)
    got = np.asarray(route_pallas(
        jnp.asarray(Xf, jnp.float32), jnp.asarray(ta.feature),
        jnp.asarray(ta.threshold), jnp.asarray(ta.left),
        jnp.asarray(ta.right), jnp.asarray(ta.leaf_id),
        max_depth=int(ta.max_depth), block_n=256, interpret=True))
    np.testing.assert_array_equal(_port_route(rf.trees_, Xf), got)


def test_route_rejects_bad_inputs(fitted_ref_forest):
    rf, X = fitted_ref_forest
    ta = TreeArrays.from_trees(unpack_trees(ref_pack_trees(rf.trees_)))
    tables = route_tables(ta, "cpu")
    with pytest.raises(TypeError):
        route(torch.as_tensor(X, dtype=torch.float32), tables)
    with pytest.raises(ValueError, match="features"):
        route(torch.as_tensor(X[:, :2]), tables)


# ----------------------------------------------------------------- K2 plain

def _block_inputs(seed, nq, nw, T, n_leaf=5):
    rng = np.random.default_rng(seed)
    gl_q = rng.integers(0, n_leaf, size=(nq, T)).astype(np.int32)
    gl_w = rng.integers(0, n_leaf, size=(nw, T)).astype(np.int32)
    q = rng.random((nq, T)) * (rng.random((nq, T)) < 0.7)
    w = rng.random((nw, T))
    return gl_q, q, gl_w, w


@pytest.mark.parametrize("nq,nw,T", [(300, 517, 13), (37, 260, 8),
                                     (1, 3, 1)])
def test_block_prox_plain_matches_pallas_interpret_f64(nq, nw, T):
    """T not a multiple of the Pallas tree chunk (8), rows not multiples
    of its 256 block: the plain version stays within 1e-12 of the float64
    interpret-mode Pallas kernel."""
    gl_q, q, gl_w, w = _block_inputs(nq + nw + T, nq, nw, T)
    got = block_prox(*(torch.as_tensor(a) for a in (gl_q, q, gl_w, w)))
    assert got.dtype == torch.float64 and got.shape == (nq, nw)
    with jax.enable_x64(True):
        want = np.asarray(block_prox_pallas(
            jnp.asarray(gl_q), jnp.asarray(q), jnp.asarray(gl_w),
            jnp.asarray(w), interpret=True, dtype=jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_block_prox_rejects_bad_inputs():
    gl_q, q, gl_w, w = (torch.as_tensor(a)
                        for a in _block_inputs(0, 4, 5, 3))
    with pytest.raises(TypeError):
        block_prox(gl_q.long(), q, gl_w, w)
    with pytest.raises(TypeError):
        block_prox(gl_q, q.float(), gl_w, w)
    with pytest.raises(ValueError):
        block_prox(gl_q, q, gl_w[:, :2], w[:, :2])


# ------------------------------------------------------------ no fallback

def test_wrappers_never_take_the_plain_version_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the kernel (CUDA) or raises."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(lr_ops, "route_ref", forbidden)
    monkeypatch.setattr(bp_ops, "block_prox_ref", forbidden)
    meta = torch.device("meta")
    g = torch.empty((4, 3), dtype=torch.int32, device=meta)
    v = torch.empty((4, 3), dtype=torch.float64, device=meta)
    with pytest.raises(ValueError, match="cuda"):
        block_prox(g, v, g, v)
    rng = np.random.default_rng(0)
    ta = TreeArrays.from_trees(unpack_trees(ref_pack_trees(
        [_random_tree(rng, 15, d=3)])))
    tables = route_tables(ta, meta)
    with pytest.raises(ValueError, match="cuda"):
        route(torch.empty((5, 3), dtype=torch.float64, device=meta), tables)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: building a kernel raises instead of selecting the plain
    version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("block_prox")
    with pytest.raises(ValueError):
        _build.build(["no_such_kernel"])
