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
from repro_torch.kernels.block_prox.ops import (LEAF_DENSITY_MAX, block_prox,
                                               build_leaf_index, leaf_density,
                                               leaf_plan)
from repro_torch.kernels.histogram import ops as h_ops
from repro_torch.kernels.histogram.ops import histogram, moments
from repro_torch.kernels.leaf_route import ops as lr_ops
from repro_torch.kernels.leaf_route.ops import (pack_nodes, route, route_plan,
                                               route_tables)


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


def test_packed_route_records_encode_every_node():
    """One 16-byte record a node: the float32 threshold's bits, the
    feature, global child ids on internal nodes, the leaf id (and 0) on
    leaves; padding and stumps included.  ``RouteTables.flat`` gives back
    what the plain version reads."""
    rng = np.random.default_rng(5)
    trees = [_single_node_tree(), _random_tree(rng, 63, d=4),
             _random_tree(rng, 15, d=4), _single_node_tree()]
    ta = TreeArrays.from_trees(unpack_trees(ref_pack_trees(trees)))
    T, M = ta.feature.shape
    rec = pack_nodes(ta).reshape(T, M, 4)
    assert rec.dtype == np.int32
    np.testing.assert_array_equal(rec[..., 1], ta.feature)
    np.testing.assert_array_equal(rec[..., 0].view(np.float32), ta.threshold)
    base = (np.arange(T) * M)[:, None]
    internal = ta.feature >= 0
    assert internal.sum() > 0 and (~internal).sum() > T   # leaves, padding
    np.testing.assert_array_equal(rec[..., 2][internal],
                                  (ta.left + base)[internal])
    np.testing.assert_array_equal(rec[..., 3][internal],
                                  (ta.right + base)[internal])
    np.testing.assert_array_equal(rec[..., 2][~internal],
                                  ta.leaf_id[~internal])
    assert not rec[..., 3][~internal].any()
    feature, threshold, lr, leaf_id = route_tables(ta, "cpu").flat()
    f_ref, thr_ref, lr_ref, leaf_ref = ta.flat()
    np.testing.assert_array_equal(feature.numpy(), f_ref)
    np.testing.assert_array_equal(threshold.numpy(), thr_ref)
    inner = np.repeat(internal.ravel(), 2)
    np.testing.assert_array_equal(lr.numpy()[inner], lr_ref[inner])
    leaf = ~internal.ravel()
    np.testing.assert_array_equal(leaf_id.numpy()[leaf], leaf_ref[leaf])


@pytest.mark.parametrize("n,d,T,want", [
    (50_000, 20, 100, (64, True, 32)),    # acceptance: 782 x 4 blocks
    (5_000, 20, 100, (64, True, 16)),     # an OOS batch: fewer trees a block
    (50_000, 20, 1, (64, True, 32)),      # a GBT stage: one tree
    (50_000, 96, 100, (64, True, 32)),    # 64 x 96 x 8 B = 48 KB
    (50_000, 97, 100, (32, True, 32)),
    (50_000, 192, 100, (32, True, 32)),
    (50_000, 193, 100, (64, False, 32)),  # too wide: through L2
    (100, 300, 40, (64, False, 8))])
def test_route_plan(n, d, T, want):
    tile, staged, tb = route_plan(n, d, T, 132)
    assert (tile, staged, tb) == want
    assert not staged or tile * d * 8 <= 48 * 1024
    assert tb >= 256 // tile


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


def _members(gl_col, w_col, leaf):
    """Columns with ``leaf`` and a nonzero weight, ascending, and their
    weights."""
    j = np.flatnonzero((gl_col == leaf) & (w_col != 0))
    return j, w_col[j]


@pytest.mark.parametrize("nw,T,n_leaf", [(20_000, 5, 7), (1000, 9, 40),
                                         (3, 2, 2), (17_000, 3, 1)])
def test_leaf_index_lists_each_leaf_in_column_order(nw, T, n_leaf):
    """For every leaf the index lists exactly the columns with that leaf
    and a nonzero weight, ascending, with their weights; each column
    range's offset is its first member at or past the range's start, on
    ragged ranges too; leaves no column reaches are empty."""
    rng = np.random.default_rng(nw + T)
    gl = (rng.integers(0, n_leaf, size=(nw, T))
          + np.arange(T) * (n_leaf + 1)).astype(np.int32)   # global ids
    n_leaves = T * (n_leaf + 1)
    w = rng.random((nw, T)) * (rng.random((nw, T)) < 0.6)
    idx = build_leaf_index(torch.as_tensor(gl), torch.as_tensor(w), n_leaves)
    assert (idx.n_ref, idx.n_trees, idx.n_leaves) == (nw, T, n_leaves)
    assert idx.n_ranges == -(-nw // idx.range_w) and idx.n_ranges <= 16
    assert idx.range_w % 1024 == 0
    col, mw, offs = idx.col.numpy(), idx.w.numpy(), idx.offs.numpy()
    starts = np.minimum(np.arange(idx.n_ranges + 1) * idx.range_w, nw)
    assert col.size == (w != 0).sum()
    for leaf in range(n_leaves):
        t = leaf // (n_leaf + 1)
        j, wj = _members(gl[:, t], w[:, t], leaf)
        a, b = offs[leaf, 0], offs[leaf, -1]
        np.testing.assert_array_equal(col[a:b], j)
        np.testing.assert_array_equal(mw[a:b], wj)
        np.testing.assert_array_equal(offs[leaf],
                                      a + np.searchsorted(j, starts))


def test_leaf_index_of_global_ids_is_the_csc_of_w():
    """With global leaf ids (the engine's), slot = leaf id and the members
    of each leaf are the CSC form of the reference map W."""
    X, y = gaussian_classes(600, d=6, n_classes=3, seed=3)
    from repro_torch.core.api import ForestKernel
    fk = ForestKernel(kernel_method="gap", n_trees=7, seed=1,
                      device="cpu").fit(X, y)
    eng = fk.engine
    idx = build_leaf_index(eng.gl, eng.w, n_leaves=eng.total_leaves)
    Wc = eng.W.tocsc()
    Wc.sort_indices()
    offs = idx.offs.numpy()
    assert offs.shape == (eng.total_leaves, idx.n_ranges + 1)
    np.testing.assert_array_equal(offs[:, 0], Wc.indptr[:-1])
    np.testing.assert_array_equal(offs[:, -1], Wc.indptr[1:])
    np.testing.assert_array_equal(idx.col.numpy(), Wc.indices)
    np.testing.assert_array_equal(idx.w.numpy(), Wc.data)


@pytest.mark.parametrize("kind,leaf", [("deep", True), ("gbt", False)])
def test_leaf_density_picks_the_form(kind, leaf):
    """``leaf_density`` is Σ m² / Σ m / Nw over the leaves' nonzero-weight
    member counts m (the CSC column counts of W); an engine walks the leaf
    index when it is at most ``LEAF_DENSITY_MAX``: one-sample leaves of a
    random-label forest do, depth-2 boosting stages do not."""
    from repro_torch.core.api import ForestKernel
    rng = np.random.default_rng(4)
    X = rng.normal(size=(800, 6))
    if kind == "deep":
        fk = ForestKernel(kernel_method="gap", n_trees=6, seed=0,
                          device="cpu").fit(X, rng.integers(0, 4, 800))
    else:
        fk = ForestKernel(model_type="gbt", task="regression",
                          kernel_method="boosted", n_trees=6, max_depth=2,
                          seed=0, device="cpu").fit(X, X[:, 0] + X[:, 1])
    eng = fk.engine
    m = np.diff(eng.W.tocsc().indptr).astype(np.float64)
    want = (m * m).sum() / m.sum() / eng.n_ref
    got = leaf_density(eng.gl, eng.w, eng.total_leaves)
    assert got == pytest.approx(want, rel=1e-12)
    assert eng.leaf_mode() is leaf
    assert (got <= LEAF_DENSITY_MAX) is leaf


def _walk_index(gl_q, q, idx, tile):
    """The kernel's walk in numpy: for each query row and column range, a
    cursor per tree advanced tile by tile, adding q·w for the members that
    fall in the tile, trees in ascending order."""
    nq, T = gl_q.shape
    nw = idx.n_ref
    offs, col, mw = idx.offs.numpy(), idx.col.numpy(), idx.w.numpy()
    out = np.full((nq, nw), np.nan)
    for i in range(nq):
        for r in range(idx.n_ranges):
            j0, j1 = r * idx.range_w, min((r + 1) * idx.range_w, nw)
            cur = np.zeros(T, np.int64)
            end = np.zeros(T, np.int64)
            for t in range(T):
                if q[i, t] != 0 and 0 <= gl_q[i, t] < idx.n_leaves:
                    cur[t], end[t] = offs[gl_q[i, t], r:r + 2]
            for a in range(j0, j1, tile):
                row = np.zeros(min(tile, j1 - a))
                for t in range(T):
                    while cur[t] < end[t] and col[cur[t]] < a + row.size:
                        assert col[cur[t]] >= a
                        row[col[cur[t]] - a] += q[i, t] * mw[cur[t]]
                        cur[t] += 1
                out[i, a:a + row.size] = row
            assert (cur == end).all()
    return out


@pytest.mark.parametrize("nq,nw,T,tile", [(5, 20_000, 4, 1024),
                                          (9, 2100, 6, 128),
                                          (3, 7, 3, 128)])
def test_leaf_index_walk_gives_the_block(nq, nw, T, tile):
    """The kernel's tile-by-tile walk over the index (in numpy) gives the
    plain version's block, every element written once."""
    gl_q, q, gl_w, w = _block_inputs(nq * T, nq, nw, T, n_leaf=6)
    off = (np.arange(T) * 6).astype(np.int32)            # global leaf ids
    gl_q, gl_w = gl_q + off, gl_w + off
    w = w * (np.random.default_rng(1).random(w.shape) < 0.7)
    idx = build_leaf_index(torch.as_tensor(gl_w), torch.as_tensor(w), 6 * T)
    got = _walk_index(gl_q, q, idx, tile)
    want = block_prox(*(torch.as_tensor(a) for a in (gl_q, q, gl_w, w)))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("T,want", [(100, (1024, 75_136)),
                                    (1500, (1024, 209_536)),
                                    (2000, (512, 224_768)),
                                    (2300, (128, 228_992))])
def test_leaf_plan(T, want):
    """The widest tile from 1,024 columns down to 128 whose rows and
    per-(row, tree) cursors fit the card's shared memory; past that the
    launch is refused."""
    assert leaf_plan(T, 232_448) == want
    with pytest.raises(ValueError, match="shared memory"):
        leaf_plan(T, 128 * 64 + T * 96 - 1)


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
    monkeypatch.setattr(h_ops, "histogram_ref", forbidden)
    monkeypatch.setattr(h_ops, "moments_ref", forbidden)
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
    xb = torch.empty((6, 2), dtype=torch.uint8, device=meta)
    i32 = torch.empty(6, dtype=torch.int32, device=meta)
    f32 = torch.empty(6, dtype=torch.float32, device=meta)
    with pytest.raises(ValueError, match="cuda"):
        histogram(xb, i32, i32, f32, 3, 4, 2)
    with pytest.raises(ValueError, match="cuda"):
        moments(xb, i32, torch.empty((6, 3), dtype=torch.float32,
                                     device=meta), 3, 4)


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
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("histogram")
    with pytest.raises(ValueError):
        _build.build(["no_such_kernel"])
