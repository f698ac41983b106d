"""The port's CUDA kernels against their plain versions, on the card.

Edge cases the acceptance-size run in ``chip_smoke.py`` does not reach:
NaN features, stumps and padding, features too wide to stage, ragged
tiles and column ranges, a single tree, leaves of one sample and of
thousands, many zero weights, the exact fma order of the block kernel.  Marked
``cuda``; on a machine without a card every test skips (the fixture
decides, at run time).  On the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.forest.trees import Tree, TreeArrays
from repro_torch.kernels.block_prox.ops import block_prox, build_leaf_index
from repro_torch.kernels.block_prox.ref import block_prox_ref
from repro_torch.kernels.leaf_route.ops import route, route_plan, route_tables
from repro_torch.kernels.leaf_route.ref import route_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tree(rng, n_nodes, d, p_split=0.8):
    feature = np.full(n_nodes, -1, np.int32)
    threshold = np.zeros(n_nodes, np.float32)
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    depth = np.zeros(n_nodes, np.int64)
    nxt = 1
    for node in range(n_nodes):
        if nxt + 1 >= n_nodes or node >= nxt:
            continue
        if rng.random() < p_split or node == 0:
            feature[node] = rng.integers(0, d)
            threshold[node] = np.float32(rng.normal())
            left[node], right[node] = nxt, nxt + 1
            depth[nxt:nxt + 2] = depth[node] + 1
            nxt += 2
    leaf = feature == -1
    leaf_id = np.full(n_nodes, -1, np.int32)
    leaf_id[leaf] = np.arange(leaf.sum(), dtype=np.int32)
    return Tree(feature, threshold, left, right, leaf_id,
                np.ones((n_nodes, 2), np.float32),
                np.ones(n_nodes, np.int32), int(depth.max()))


def _stump():
    return Tree(np.array([-1], np.int32), np.array([np.inf], np.float32),
                np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.ones((1, 2), np.float32),
                np.ones(1, np.int32), 0)


def _check_route(trees, X, dev):
    tables = route_tables(TreeArrays.from_trees(trees), dev)
    Xd = torch.as_tensor(X, dtype=torch.float64, device=dev)
    n0 = route.launches
    got = route(Xd, tables)
    torch.cuda.synchronize()
    assert route.launches == n0 + 1
    want = route_ref(Xd, *tables.flat(), tables.n_trees, tables.max_nodes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,T,nodes", [(1, 1, 3), (257, 9, 63),
                                       (1000, 17, 511)])
def test_route_kernel_small_trees(dev, n, T, nodes):
    rng = np.random.default_rng(n + T)
    X = rng.normal(size=(n, 5))
    X[::5, 1] = np.nan                                # NaN goes right
    thr = [_tree(rng, nodes, 5) for _ in range(T)]
    X[: min(n, 50), 0] = thr[0].threshold[0]          # exactly on a split
    _check_route(thr, X, dev)


def test_route_kernel_stumps_next_to_a_deep_tree(dev):
    rng = np.random.default_rng(3)
    _check_route([_stump(), _tree(rng, 255, 4), _stump()],
                 rng.normal(size=(300, 4)), dev)


def test_route_kernel_deep_trees(dev):
    """Trees whose node tables exceed a block's shared memory."""
    rng = np.random.default_rng(4)
    trees = [_tree(rng, 20_001, 6, p_split=1.0) for _ in range(3)]
    _check_route(trees, rng.normal(size=(700, 6)), dev)


@pytest.mark.parametrize("d", [48, 49, 100, 192, 193, 300])
def test_route_kernel_wide_features(dev, d):
    """Samples staged 128, 64 or 32 a block, and past 192 features read
    through L2 (``route_plan``); NaN features and stumps alike."""
    rng = np.random.default_rng(d)
    staged = route_plan(700, d, 6, 132)[1]
    assert staged == (d <= 192)
    trees = [_tree(rng, 511, d) for _ in range(5)] + [_stump()]
    X = rng.normal(size=(700, d))
    X[::3, trees[0].feature[0]] = np.nan
    X[1::5] = np.nan
    _check_route(trees, X, dev)


def test_route_kernel_nan_and_stumps_next_to_deep_trees(dev):
    rng = np.random.default_rng(8)
    trees = [_stump(), _tree(rng, 20_001, 6, p_split=1.0), _stump(),
             _tree(rng, 4001, 6), _tree(rng, 7, 6)]
    X = rng.normal(size=(3000, 6))
    for f in range(6):
        X[f::7, f] = np.nan
    _check_route(trees, X, dev)


@pytest.mark.parametrize("n,T", [(50, 70), (20_000, 70), (4097, 33)])
def test_route_kernel_tree_groups(dev, n, T):
    """Groups of 8 to 32 trees a block, ragged in trees and samples."""
    rng = np.random.default_rng(n + T)
    _check_route([_tree(rng, 127, 5) for _ in range(T)],
                 rng.normal(size=(n, 5)), dev)


@pytest.mark.parametrize("nq,nw,T", [(1, 1, 1), (63, 65, 15), (64, 64, 16),
                                     (130, 1000, 33), (700, 129, 100)])
def test_block_prox_kernel_ragged(dev, nq, nw, T):
    rng = np.random.default_rng(nq * nw + T)
    gl_q = torch.as_tensor(rng.integers(0, 4, (nq, T)), dtype=torch.int32,
                           device=dev)
    gl_w = torch.as_tensor(rng.integers(0, 4, (nw, T)), dtype=torch.int32,
                           device=dev)
    q = torch.as_tensor(rng.random((nq, T)), device=dev)
    w = torch.as_tensor(rng.random((nw, T)), device=dev)
    n0 = block_prox.launches
    got = _k2_check(gl_q, q, gl_w, w)
    torch.cuda.synchronize()
    assert block_prox.launches == n0 + 3


def _global(gl_q, gl_w):
    """Per-tree leaf ids made global (tree t's ids shifted by t·L), as the
    leaf index wants them; collisions are unchanged.  Returns the shifted
    ids and the number of global leaves."""
    L = int(max(gl_q.max(), gl_w.max())) + 1 if gl_w.numel() else 1
    off = torch.arange(gl_w.shape[1], dtype=torch.int32,
                       device=gl_w.device) * L
    return gl_q + off, gl_w + off, L * gl_w.shape[1]


def _k2_check(gl_q, q, gl_w, w, index=None):
    """K2's leaf-collision form (on ``index``, or on an index of global ids
    built here) within 1e-12 of the plain version, the same bits on a
    second launch and in the dense form."""
    if index is None:
        gl_q, gl_w, n_leaves = _global(gl_q, gl_w)
        index = build_leaf_index(gl_w, w, n_leaves)
    got = block_prox(gl_q, q, gl_w, w, index=index)
    torch.testing.assert_close(got, block_prox_ref(gl_q, q, gl_w, w),
                               rtol=0, atol=1e-12)
    assert torch.equal(block_prox(gl_q, q, gl_w, w, index=index), got)
    assert torch.equal(block_prox(gl_q, q, gl_w, w), got)
    return got


@pytest.mark.parametrize("nq,nw,T", [(37, 40_000, 12), (9, 17_409, 3),
                                     (20, 300, 700), (3, 50, 2000)])
def test_block_prox_kernel_ranges_and_many_trees(dev, nq, nw, T):
    """Several ragged column ranges of the index; and so many trees that
    the cursors shrink the shared-memory tile (700 trees: 128 columns;
    2000: one block an SM)."""
    rng = np.random.default_rng(nw + T)
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    gl_q = as_t(rng.integers(0, 9, (nq, T)), torch.int32)
    gl_w = as_t(rng.integers(0, 9, (nw, T)), torch.int32)
    q = as_t(rng.random((nq, T)) * (rng.random((nq, T)) < 0.5))
    w = as_t(rng.random((nw, T)) * (rng.random((nw, T)) < 0.8))
    _k2_check(gl_q, q, gl_w, w)


def _engine(kind, n=3000):
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import friedman1, gaussian_classes
    rng = np.random.default_rng(7)
    if kind == "deep":                 # random labels: one-sample leaves
        X = rng.normal(size=(n, 8))
        fk = ForestKernel(kernel_method="gap", n_trees=8, seed=1,
                          device="cuda").fit(X, rng.integers(0, 5, n))
    elif kind == "gbt":                # depth 6: leaves of hundreds
        X, y = friedman1(n, d=8, seed=2)
        fk = ForestKernel(model_type="gbt", task="regression",
                          kernel_method="boosted", n_trees=20, max_depth=6,
                          seed=0, device="cuda").fit(X, y)
    else:                              # gap: q = 0 on in-bag trees
        X, y = gaussian_classes(n, d=8, n_classes=7, seed=2)
        fk = ForestKernel(kernel_method="gap", n_trees=16, seed=3,
                          device="cuda").fit(X, y)
    return fk.engine


@pytest.mark.parametrize("kind,leaf", [("deep", True), ("gbt", False),
                                       ("gap", True)])
def test_block_prox_kernel_on_forests(dev, kind, leaf):
    """The engine's factors: the form its leaf density picks (the index is
    built only for the leaf form), both forms on its cached index at a
    ragged row count, and a column subset (dense form) equal bit for bit to
    those columns of the full block."""
    eng = _engine(kind)
    assert eng.leaf_mode() is leaf
    blk = eng.kernel_block(np.arange(77))
    assert (eng._leaf_index is not None) is leaf
    gq, qq = eng.gl[:77], eng.q[:77]
    assert torch.equal(blk, block_prox(gq, qq, eng.gl, eng.w))
    _k2_check(gq, qq, eng.gl, eng.w, index=eng.leaf_index())
    assert eng.memory_bytes()["leaf_index"] == eng.leaf_index().nbytes
    cols = np.sort(np.random.default_rng(0).choice(eng.n_ref, 900,
                                                   replace=False))
    c = torch.as_tensor(cols, device=dev)
    got = eng.kernel_block(np.arange(77), cols)
    torch.testing.assert_close(got, block_prox_ref(gq, qq, eng.gl[c],
                                                   eng.w[c]),
                               rtol=0, atol=1e-12)
    assert torch.equal(got, blk[:, c])


def test_block_prox_kernel_many_zero_weights(dev):
    """Zero q skips a (row, tree), zero w leaves a member out of the index;
    all-zero rows and columns give exact zeros."""
    rng = np.random.default_rng(12)
    nq, nw, T = 130, 2000, 40
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    q = rng.random((nq, T)) * (rng.random((nq, T)) < 0.1)
    w = rng.random((nw, T)) * (rng.random((nw, T)) < 0.4)
    q[:7] = 0.0
    w[:, :3] = 0.0
    w[100:150] = 0.0
    gl_q = as_t(rng.integers(0, 3, (nq, T)), torch.int32)
    gl_w = as_t(rng.integers(0, 3, (nw, T)), torch.int32)
    got = _k2_check(gl_q, as_t(q), gl_w, as_t(w))
    assert not got[:7].any() and not got[:, 100:150].any()
    _, gw, n_leaves = _global(gl_q, gl_w)
    assert build_leaf_index(gw, as_t(w), n_leaves).col.numel() \
        == (w != 0).sum()


def _fma(a, b, c):
    """Correctly rounded a·b + c in float64 (exact rationals, one
    rounding)."""
    from fractions import Fraction
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def test_block_prox_kernel_fma_order(dev):
    """Each P[i,j] is fma(q, w, acc) over the colliding trees in ascending
    order from 0.0, bit for bit: the dense form's sequence."""
    rng = np.random.default_rng(13)
    nq, nw, T = 24, 700, 30
    gl_q = rng.integers(0, 3, (nq, T)).astype(np.int32)
    gl_w = rng.integers(0, 3, (nw, T)).astype(np.int32)
    q = rng.normal(size=(nq, T)) * (rng.random((nq, T)) < 0.7)
    w = rng.normal(size=(nw, T)) * 1e3
    got = block_prox(*(torch.as_tensor(a, device=dev)
                       for a in (gl_q, q, gl_w, w))).cpu().numpy()
    want = np.zeros((nq, nw))
    for i in range(nq):
        for j in range(nw):
            acc = 0.0
            for t in np.flatnonzero(gl_q[i] == gl_w[j]):
                acc = _fma(q[i, t], w[j, t], acc)
            want[i, j] = acc
    assert np.array_equal(got.view(np.int64), want.view(np.int64))



# ------------------------------------------------ K2 in float32

def _k2_check_f32(gl_q, q, gl_w, w, index=None):
    """K2's float32 instantiation: the leaf-collision form (on ``index``,
    or on an index of global ids built here) within 1e-5 x max|P| of the
    plain float32 version (which sums products in chunks, not by fma), the
    same bits on a second launch and in the dense form; counted in
    ``launches_f32`` and not in the float64 count."""
    if index is None:
        gl_q, gl_w, n_leaves = _global(gl_q, gl_w)
        index = build_leaf_index(gl_w, w, n_leaves)
    assert index.w.dtype == torch.float32
    n64, n32 = block_prox.launches, block_prox.launches_f32
    got = block_prox(gl_q, q, gl_w, w, index=index)
    assert got.dtype == torch.float32
    want = block_prox_ref(gl_q, q, gl_w, w)
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(block_prox(gl_q, q, gl_w, w, index=index), got)
    assert torch.equal(block_prox(gl_q, q, gl_w, w), got)
    torch.cuda.synchronize()
    assert block_prox.launches_f32 == n32 + 3 and block_prox.launches == n64
    return got


@pytest.mark.parametrize("nq,nw,T", [(1, 1, 1), (63, 65, 15), (64, 64, 16),
                                     (130, 1000, 33), (700, 129, 100),
                                     (37, 40_000, 12), (20, 300, 700),
                                     (3, 50, 2000)])
def test_block_prox_kernel_float32_forms(dev, nq, nw, T):
    """Ragged tiles, several column ranges, and enough trees that the
    cursors shrink the (float32, twice as wide) shared tile."""
    rng = np.random.default_rng(nq * nw + T)
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    gl_q = as_t(rng.integers(0, 9, (nq, T)), torch.int32)
    gl_w = as_t(rng.integers(0, 9, (nw, T)), torch.int32)
    q = as_t(rng.random((nq, T)) * (rng.random((nq, T)) < 0.5),
             torch.float32)
    w = as_t(rng.random((nw, T)) * (rng.random((nw, T)) < 0.8),
             torch.float32)
    _k2_check_f32(gl_q, q, gl_w, w)


def _round32(x):
    """A rational ``x`` rounded once to the nearest float32 (ties to an
    even significand)."""
    from fractions import Fraction
    f = np.float32(float(x))          # within an ulp of the answer
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(err)
    near = [c for c, e in zip(cands, err) if e == best]
    if len(near) > 1:
        near = [c for c in near if not np.array([c]).view(np.uint32)[0] & 1]
    return near[0]


def test_block_prox_kernel_float32_fma_order(dev):
    """In float32 too each P[i,j] is fmaf(q, w, acc), one rounding, over
    the colliding trees in ascending order from 0, bit for bit, in both
    forms."""
    from fractions import Fraction
    rng = np.random.default_rng(14)
    nq, nw, T = 16, 300, 30
    gl_q = rng.integers(0, 3, (nq, T)).astype(np.int32)
    gl_w = rng.integers(0, 3, (nw, T)).astype(np.int32)
    q = (rng.normal(size=(nq, T)) * (rng.random((nq, T)) < 0.7)).astype(
        np.float32)
    w = (rng.normal(size=(nw, T)) * 1e3).astype(np.float32)
    t = [torch.as_tensor(a, device=dev) for a in (gl_q, q, gl_w, w)]
    dense = block_prox(*t).cpu().numpy()
    gq, gw, n_leaves = _global(t[0], t[2])
    leaf = block_prox(gq, t[1], gw, t[3], index=build_leaf_index(
        gw, t[3], n_leaves)).cpu().numpy()
    want = np.zeros((nq, nw), np.float32)
    for i in range(nq):
        for j in range(nw):
            acc = np.float32(0)
            for k in np.flatnonzero(gl_q[i] == gl_w[j]):
                acc = _round32(Fraction(float(q[i, k])) * Fraction(
                    float(w[j, k])) + Fraction(float(acc)))
            want[i, j] = acc
    assert np.array_equal(dense.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(leaf.view(np.uint32), want.view(np.uint32))


def test_block_prox_kernel_refuses_mixed_types(dev):
    rng = np.random.default_rng(15)
    as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    gl_q = as_t(rng.integers(0, 3, (4, 5)), torch.int32)
    gl_w = as_t(rng.integers(0, 3, (9, 5)), torch.int32)
    q32 = as_t(rng.random((4, 5)), torch.float32)
    w32 = as_t(rng.random((9, 5)), torch.float32)
    n64, n32 = block_prox.launches, block_prox.launches_f32
    with pytest.raises(TypeError):
        block_prox(gl_q, q32, gl_w, w32.double())
    with pytest.raises(TypeError):
        block_prox(gl_q, q32.double(), gl_w, w32)
    gq, gw, n_leaves = _global(gl_q, gl_w)
    index64 = build_leaf_index(gw, w32.double(), n_leaves)
    with pytest.raises(TypeError, match="index.w"):
        block_prox(gq, q32, gw, w32, index=index64)
    assert (block_prox.launches, block_prox.launches_f32) == (n64, n32)


def test_float32_engine_on_the_card(dev):
    """``ForestKernel(dtype=np.float32)`` on the card: its factors are the
    float64 card factors rounded once and equal the CPU float32 kernel's;
    its ops within 1e-5 of the largest value of the CPU float32 engine's,
    in the same dtypes; K2 runs its float32 instantiation."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    X, y = gaussian_classes(3000, d=8, n_classes=4, seed=6)
    Xtr, ytr, Xte, _ = train_test_split(X, y, test_frac=0.2, seed=1)
    kw = dict(kernel_method="gap", n_trees=12, seed=3)
    g32 = ForestKernel(device="cuda", dtype=np.float32, **kw).fit(Xtr, ytr)
    c32 = ForestKernel(device="cpu", dtype=np.float32, **kw).fit(Xtr, ytr)
    g64 = ForestKernel(device="cuda", **kw)
    g64.forest = g32.forest
    g64.build_kernel_cache()
    assert torch.equal(g64.engine.q.float(), g32.engine.q)
    assert torch.equal(g32.engine.q.cpu(), c32.engine.q)
    assert torch.equal(g32.engine.w.cpu(), c32.engine.w)
    n32 = block_prox.launches_f32
    pairs = [(g32.engine.predict(ytr, 4, X=Xte), c32.engine.predict(
                 ytr, 4, X=Xte)),
             (g32.row_sums(), c32.row_sums()),
             (g32.kernel_block(np.arange(100)), c32.kernel_block(
                 np.arange(100))),
             (g32.kernel_block(None, X_rows=Xte), c32.kernel_block(
                 None, X_rows=Xte)),
             (g32.engine.squared_row_sums(ytr, 4, X=Xte),
              c32.engine.squared_row_sums(ytr, 4, X=Xte)),
             (g32.topk(5, X=Xte)[1], c32.topk(5, X=Xte)[1])]
    torch.cuda.synchronize()
    assert block_prox.launches_f32 > n32
    for a, b in pairs:
        assert a.dtype == b.dtype
        scale = float(b.abs().max())
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("C", [7, 64])
def test_sharded_matmat_on_a_grid_of_one_card(dev, C):
    """``sharded_swlc_matmat`` on a (2, 2) grid of cuda:0 within 1e-12 of
    the segment product (float64); the engine reports the segment path on
    one card, and the sharded one with the grid as its mesh."""
    from repro_torch.core import torch_ops
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes
    X, y = gaussian_classes(2000, d=8, n_classes=3, seed=2)
    fk = ForestKernel(kernel_method="gap", n_trees=12, seed=0,
                      device="cuda").fit(X, y)
    e = fk.engine
    V = torch.as_tensor(np.random.default_rng(C).normal(size=(e.n_ref, C)),
                        device=dev)
    want = e.matmat(V)
    assert e.last_matmat_path == "segment"
    mesh = np.empty((2, 2), dtype=object)
    mesh[:] = [[dev, dev], [dev, dev]]
    got = torch_ops.sharded_swlc_matmat(mesh, e.gl, e.q, e.w, V,
                                        e.total_leaves)
    assert got.device == want.device
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    grid = np.empty((2, 1), dtype=object)
    grid[:] = [[dev], [dev]]
    real = torch_ops.default_mesh
    try:
        torch_ops.default_mesh = lambda: grid
        torch.testing.assert_close(e.matmat(V), want, rtol=0, atol=1e-12)
        assert e.last_matmat_path == "sharded"
    finally:
        torch_ops.default_mesh = real

def test_forest_kernel_runs_on_the_card(dev):
    """The slice on the card equals the slice on the CPU: same leaves and
    factors bit for bit, ops within 1e-8."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    X, y = gaussian_classes(2000, d=10, n_classes=4, seed=2)
    Xtr, ytr, Xte, _ = train_test_split(X, y, test_frac=0.25, seed=1)
    kw = dict(kernel_method="kerf", n_trees=10, seed=3)
    gpu = ForestKernel(device="cuda", **kw).fit(Xtr, ytr)
    cpu = ForestKernel(device="cpu", **kw).fit(Xtr, ytr)
    assert torch.equal(gpu.engine.gl.cpu(), cpu.engine.gl)
    assert torch.equal(gpu.engine.q.cpu(), cpu.engine.q)
    for a, b in [(gpu.predict(Xte), cpu.predict(Xte)),
                 (gpu.row_sums(Xte), cpu.row_sums(Xte)),
                 (gpu.kernel_block(None, X_rows=Xte), cpu.kernel_block(
                     None, X_rows=Xte)),
                 (gpu.topk(5, X=Xte)[1], cpu.topk(5, X=Xte)[1])]:
        torch.testing.assert_close(a.cpu().double(), b.double(), rtol=0,
                                   atol=1e-8)


def test_large_train_side_jobs_stay_on_the_card(dev, monkeypatch):
    """Above the CPU engine's sparse cutover, a CUDA engine still computes
    train-side top-k and squared row sums on the card, in block-kernel row
    blocks or, in collision mode, on the collision path (the rule forced
    each way here), and both match the CPU engine's host CSR results."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes
    from repro_torch.obs.metrics import global_registry
    X, y = gaussian_classes(1500, d=8, n_classes=3, seed=5)
    kw = dict(kernel_method="gap", n_trees=12, seed=4)
    gpu = ForestKernel(device="cuda", **kw).fit(X, y)
    cpu = ForestKernel(device="cpu", **kw).fit(X, y)
    monkeypatch.setattr(eng_mod.ProximityEngine, "_SPARSE_TRAIN_CUTOVER", 10)
    want_s = cpu.engine.squared_row_sums(y, 3)
    want_v = cpu.engine.topk(6)[1]
    P = cpu.engine.kernel_block()

    def served():
        snap = global_registry().snapshot()
        return snap.get("engine_collide_rows_total", {}).get(
            "series", {}).get("", 0.0)
    for share_max in (float("-inf"), float("inf")):
        monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", share_max)
        n0, s0 = block_prox.launches, served()
        got_s = gpu.engine.squared_row_sums(y, 3)
        got_i, got_v = gpu.engine.topk(6)
        torch.cuda.synchronize()
        if share_max < 0:
            assert block_prox.launches >= n0 + 2 and served() == s0
        else:
            assert block_prox.launches == n0
            assert served() == s0 + 2 * len(X)
        torch.testing.assert_close(got_s.cpu(), want_s, rtol=0, atol=1e-8)
        torch.testing.assert_close(got_v.cpu(), want_v, rtol=0, atol=1e-8)
        torch.testing.assert_close(P.gather(1, got_i.cpu()), got_v.cpu(),
                                   rtol=0, atol=1e-8)


# ------------------------------------------------ applications, views

def _fit_pair(method="gap", n=3000, n_trees=12):
    """A card kernel and a CPU kernel fitted alike (card trees equal host
    trees, so both have the same leaves) and an OOS batch."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    X, y = gaussian_classes(n, d=10, n_classes=5, seed=8)
    Xtr, ytr, Xte, _ = train_test_split(X, y, test_frac=0.2, seed=3)
    kw = dict(kernel_method=method, n_trees=n_trees, seed=5)
    gpu = ForestKernel(device="cuda", **kw).fit(Xtr, ytr)
    cpu = ForestKernel(device="cpu", **kw).fit(Xtr, ytr)
    assert torch.equal(gpu.engine.gl.cpu(), cpu.engine.gl)
    return gpu, cpu, Xte


def test_block_prox_kernel_on_the_compressed_engine(dev):
    """The prototype-compressed engine's blocks (an OOS batch against its
    prototype columns): its own leaf index, both forms with the same bits,
    within 1e-12 of the plain version; its OOS ops match the CPU view."""
    from repro_torch.applications.prototypes import CompressedProximityEngine
    gpu, cpu, Xte = _fit_pair()
    idx = np.sort(np.random.default_rng(1).choice(gpu.engine.n_ref, 70,
                                                  replace=False))
    ce = CompressedProximityEngine(gpu.engine, idx)
    hce = CompressedProximityEngine(cpu.engine, idx)
    assert ce._leaf_index is None
    qs = gpu.engine.query_state(Xte)
    _k2_check(qs.gl, qs.q, ce.gl, ce.w, index=ce.leaf_index())
    assert ce.leaf_index().n_ref == 70
    n0 = block_prox.launches
    got = ce.kernel_block(None, X_rows=Xte)
    assert block_prox.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), hce.kernel_block(None, X_rows=Xte),
                               rtol=0, atol=1e-12)
    gi, gv = ce.topk(10, X=Xte)
    hi, hv = hce.topk(10, X=Xte)
    torch.testing.assert_close(gv.cpu(), hv, rtol=0, atol=1e-8)
    lab = gpu.ctx.y[idx]
    torch.testing.assert_close(ce.predict(lab, 5, X=Xte).cpu(),
                               hce.predict(lab, 5, X=Xte), rtol=0, atol=1e-8)


def test_block_prox_kernel_on_the_prefix_engine(dev):
    """The depth-4 prefix engine's big leaves take the dense form; the leaf
    form on its own index gives the same bits; its OOS predict routes
    nothing."""
    from repro_torch.kernels.leaf_route import ops as route_ops
    gpu, cpu, Xte = _fit_pair()
    pe, hpe = gpu.prefix_engine(4), cpu.prefix_engine(4)
    assert not pe.leaf_mode()
    gq, qq = pe.gl[:77], pe.q[:77]
    blk = pe.kernel_block(np.arange(77))
    assert pe._leaf_index is None
    torch.testing.assert_close(blk, block_prox_ref(gq, qq, pe.gl, pe.w),
                               rtol=0, atol=1e-12)
    _k2_check(gq, qq, pe.gl, pe.w, index=pe.leaf_index())
    gpu.engine.query_state(Xte)
    n0 = route_ops.route.launches
    s = pe.predict(gpu.ctx.y, 5, X=Xte)
    torch.cuda.synchronize()
    assert route_ops.route.launches == n0
    torch.testing.assert_close(s.cpu(), hpe.predict(cpu.ctx.y, 5, X=Xte),
                               rtol=0, atol=1e-8)


@pytest.mark.parametrize("depth", [1, 4, 9])
def test_route_kernel_on_truncated_forests(dev, depth):
    """K1 on a truncated forest's own records: bit-exact to the per-tree
    oracle and to the contraction of the full forest's leaves."""
    from repro_torch.forest.trees import prefix_leaf_map, route_tree
    gpu, _, Xte = _fit_pair()
    tf = gpu.forest.truncated(depth)
    n0 = route.launches
    leaves = tf.apply(Xte).cpu().numpy()
    assert route.launches == n0 + 1
    full = gpu.forest.apply(Xte).cpu().numpy()
    for t, tree in enumerate(tf.trees_):
        np.testing.assert_array_equal(leaves[:, t], route_tree(tree, Xte))
        np.testing.assert_array_equal(
            prefix_leaf_map(gpu.forest.trees_[t], depth)[full[:, t]],
            leaves[:, t])


@pytest.mark.parametrize("broadcast_max", [5e7, 0])
def test_ih_weights_on_the_card(dev, broadcast_max):
    """Card ``ih`` weights equal the host's, except where a row's 5th and
    6th nearest squared distances lie within 1e-9 relative (sums in
    another order may pick the other neighbour); both distance forms."""
    from repro_torch.core.weights import InstanceHardness
    gpu, cpu, _ = _fit_pair(method="gap", n=2500, n_trees=6)
    got = InstanceHardness(gpu.ctx)
    want = InstanceHardness(cpu.ctx)
    got._BROADCAST_MAX = want._BROADCAST_MAX = broadcast_max
    w = got.reference_weights(gpu.ctx.leaves).cpu()
    hw = want.reference_weights(cpu.ctx.leaves)
    ctx = cpu.ctx
    refs = np.random.default_rng(0).choice(ctx.n_train, min(
        2048, ctx.n_train), replace=False)
    for t, feats in enumerate(ctx.tree_features):
        A = ctx.X[:, feats]
        d2 = np.sort(((A[:, None, :] - A[refs][None]) ** 2).sum(-1), axis=1)
        near = d2[:, 5] - d2[:, 4] <= 1e-9 * d2[:, 5]
        diff = (w[:, t] != hw[:, t]).numpy()
        assert not (diff & ~near).any()


def test_applications_on_the_card_match_a_cpu_engine(dev):
    """Outlier scores (raw at 1e-10 relative, normalized at 1e-8) and label
    propagation (labels equal away from a top-two margin below 1e-9,
    scores at 1e-8) on the card against the CPU engine on the same
    leaves."""
    gpu, cpu, Xte = _fit_pair()
    raw, hraw = gpu.outlier_scores(normalize=False).cpu(), \
        cpu.outlier_scores(normalize=False)
    torch.testing.assert_close(raw, hraw, rtol=1e-10, atol=0)
    torch.testing.assert_close(gpu.outlier_scores().cpu(),
                               cpu.outlier_scores(), rtol=0, atol=1e-8)
    torch.testing.assert_close(gpu.oos_outlier_scores(Xte).cpu(),
                               cpu.oos_outlier_scores(Xte), rtol=0,
                               atol=1e-8)
    labeled = np.random.default_rng(4).random(gpu.ctx.n_train) < 0.1
    lab, sc = gpu.propagate_labels(labeled)
    hlab, hsc = cpu.propagate_labels(labeled)
    torch.testing.assert_close(sc.cpu(), hsc, rtol=0, atol=1e-8)
    top2 = torch.topk(hsc, 2, dim=1).values
    close = top2[:, 0] - top2[:, 1] < 1e-9
    assert not ((lab.cpu() != hlab) & ~close).any()


# ------------------------------------------------------------ K3 / K4

def _hist_inputs(rng, n, n_nodes, d, n_bins, C, dev, sort=True,
                 integer=True, n_rows=None):
    """Codes (uint8, or int16 past 256 bins), node ids with some nodes
    empty, labels, weights (bootstrap-like integers or continuous), row ids
    into a larger code matrix."""
    code_dt = torch.uint8 if n_bins <= 256 else torch.int16
    n_rows = n_rows or n
    xb = torch.as_tensor(rng.integers(0, n_bins, (n_rows, d)),
                         dtype=code_dt, device=dev)
    node = rng.integers(0, n_nodes, n)
    node[node % 4 == 1] = 0                      # leaves odd nodes empty
    if sort:
        node = np.sort(node)
    y = rng.integers(0, C, n)
    w = rng.integers(0, 4, n).astype(np.float32) if integer else \
        rng.normal(size=n).astype(np.float32)
    rows = rng.integers(0, n_rows, n)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa
    return (xb, as_t(node, torch.int32), as_t(y, torch.int32),
            as_t(w, torch.float32), as_t(rows, torch.int64))


def _f64_moments(xb, node, wm, n_nodes, n_bins):
    """The moments in float64 on the host: the exact sums to within
    float64 rounding."""
    xb, node, wm = xb.cpu(), node.cpu(), wm.cpu().double()
    n, d = xb.shape
    k = wm.shape[1]
    flat = (node.long()[:, None] * d + torch.arange(d)) * n_bins + xb.long()
    out = torch.zeros((n_nodes * d * n_bins, k), dtype=torch.float64)
    out.index_add_(0, flat.reshape(-1),
                   wm[:, None, :].expand(n, d, k).reshape(-1, k))
    return out.reshape(n_nodes, d, n_bins, k)


def _plain_hist(xb, node, y, w, n_nodes, n_bins, C, rows):
    from repro_torch.kernels.histogram.ref import histogram_ref
    return histogram_ref(xb[rows], node, y, w, n_nodes, n_bins, C)


@pytest.mark.parametrize("n,n_nodes,d,n_bins,C", [
    (1, 1, 1, 2, 2), (1000, 3, 5, 16, 3), (5000, 65, 20, 64, 7),
    (3000, 300, 7, 300, 2), (777, 2, 1, 2, 3), (30_000, 3, 20, 64, 7),
    (300_000, 1, 4, 16, 2)])
@pytest.mark.parametrize("sort", [True, False])
def test_histogram_kernel_exact_on_integer_weights(dev, n, n_nodes, d,
                                                   n_bins, C, sort):
    from repro_torch.kernels.histogram.ops import histogram
    rng = np.random.default_rng(n + d + n_bins)
    xb, node, y, w, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, C, dev,
                                        sort=sort, n_rows=n + 17)
    n0 = histogram.launches
    got = histogram(xb, node, y, w, n_nodes, n_bins, C, rows=rows)
    torch.cuda.synchronize()
    assert histogram.launches == n0 + 1
    assert torch.equal(got, _plain_hist(xb, node, y, w, n_nodes, n_bins, C,
                                        rows))


@pytest.mark.parametrize("n,n_nodes,d,n_bins,K", [
    (1, 1, 1, 2, 1), (4000, 3, 5, 16, 3), (50_000, 1, 20, 64, 3),
    (3000, 65, 6, 300, 2)])
def test_moments_kernel_exact_and_deterministic(dev, n, n_nodes, d, n_bins,
                                                K):
    from repro_torch.kernels.histogram.ops import moments
    from repro_torch.kernels.histogram.ref import moments_ref
    rng = np.random.default_rng(n + K)
    xb, node, _, _, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, 2, dev,
                                        n_rows=n)
    wm_int = torch.as_tensor(rng.integers(-3, 9, (n, K)),
                             dtype=torch.float32, device=dev)
    got = moments(xb, node, wm_int, n_nodes, n_bins, rows=rows)
    assert torch.equal(got, moments_ref(xb[rows], node, wm_int, n_nodes,
                                        n_bins, K))
    wm = torch.as_tensor(rng.normal(size=(n, K)) * 5, dtype=torch.float32,
                         device=dev)
    a = moments(xb, node, wm, n_nodes, n_bins, rows=rows)
    b = moments(xb, node, wm, n_nodes, n_bins, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)                         # same bits every launch
    want = _f64_moments(xb[rows], node, wm, n_nodes, n_bins)
    scale = _f64_moments(xb[rows], node, wm.abs(), n_nodes, n_bins)
    # float32 sums of up to n terms: each add rounds by <= 2^-24 of the
    # running |sum| <= the bin's sum of |payload|
    assert torch.all((a.cpu().double() - want).abs()
                     <= n * 2.0 ** -24 * scale + 1e-6)


def test_histogram_kernel_slices_features_past_shared_memory(dev):
    """40 features x 256 bins x 7 classes need 287 KB a node, more than a
    block's shared memory: the kernel slices features.  300 bins x 200
    classes do not fit even one feature: the warps accumulate in device
    memory.  Both equal the plain version."""
    from repro_torch.kernels.histogram.ops import histogram, slice_plan
    limit = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    for n, n_nodes, d, n_bins, C, want_smem in [
            (6000, 5, 40, 256, 7, True), (3000, 3, 3, 300, 200, False)]:
        ds, smem = slice_plan(d, n_bins, C, 1, True, limit)
        assert smem is want_smem and (ds < d or not smem)
        rng = np.random.default_rng(d)
        xb, node, y, w, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, C,
                                            dev)
        got = histogram(xb, node, y, w, n_nodes, n_bins, C, rows=rows)
        assert torch.equal(got, _plain_hist(xb, node, y, w, n_nodes, n_bins,
                                            C, rows))


def test_histogram_kernel_empty_and_zero_weights(dev):
    from repro_torch.kernels.histogram.ops import histogram
    rng = np.random.default_rng(5)
    xb, node, y, w, rows = _hist_inputs(rng, 500, 9, 4, 16, 3, dev)
    zero = histogram(xb, node, y, torch.zeros_like(w), 9, 16, 3, rows=rows)
    assert torch.equal(zero, torch.zeros_like(zero))
    e = histogram(xb, node[:0], y[:0], w[:0], 9, 16, 3, rows=rows[:0])
    assert e.shape == (9, 4, 16, 3) and not e.any()
    with pytest.raises(IndexError):
        histogram(xb, node, y, w, 9, 16, 3, rows=rows + xb.shape[0])


def _ordered_case(xb, node, rows, n_nodes):
    """The order in which the wrapper hands the samples to the kernel
    (stably sorted by node), their codes there and their node bounds."""
    node_h = node.cpu().numpy()
    order = np.argsort(node_h, kind="stable")
    bounds = np.searchsorted(node_h[order], np.arange(n_nodes + 1))
    return order, xb.cpu().numpy()[rows.cpu().numpy()[order]], bounds


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


ORACLE_SHAPES = [(1000, 3, 5, 16, 3), (5000, 65, 20, 64, 7),
                 (30_000, 3, 20, 64, 7), (300_000, 1, 4, 16, 2),
                 (3000, 300, 7, 300, 2), (6000, 5, 40, 256, 7),
                 (3000, 3, 3, 300, 200), (60_000, 500, 20, 64, 7),
                 (20_000, 700, 6, 16, 3)]


def _force_mode(monkeypatch, mode):
    """Make every launch take the fold mode (where the histogram fits
    shared memory) or the rank mode."""
    from repro_torch.kernels.histogram import ops
    monkeypatch.setattr(ops, "_FOLD_UNITS_PER_SM",
                        0 if mode == "fold" else 1 << 30)


@pytest.mark.parametrize("n,n_nodes,d,n_bins,C", ORACLE_SHAPES)
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("mode", ["fold", "rank"])
def test_kernels_equal_ordered_oracle_on_continuous_payloads(
        dev, monkeypatch, n, n_nodes, d, n_bins, C, sort, mode):
    """K3 and K4 give the ordered oracle's bits on continuous payloads
    (sums in sample order within a segment, then segment by segment), the
    same bits on two launches, in both kernel modes; int32 and int64 row
    ids alike.  The shapes cover cut nodes, empty nodes, unaligned rows
    (D = 5, 7, 3, 6), int16 codes, sliced features (D = 40), global-memory
    accumulation and launches of many units."""
    from repro_torch.kernels.histogram.ops import (histogram, moments,
                                                   work_items)
    from repro_torch.kernels.histogram.ref import (histogram_ordered,
                                                   moments_ordered)
    _force_mode(monkeypatch, mode)
    rng = np.random.default_rng(n + d + C)
    xb, node, y, w, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, C, dev,
                                        sort=sort, integer=False,
                                        n_rows=n + 17)
    w = w * 37.0
    order, codes, bounds = _ordered_case(xb, node, rows, n_nodes)
    items, red, _ = work_items(bounds)
    o = torch.as_tensor(order, device=dev)
    want = histogram_ordered(codes, y[o].cpu().numpy(), w[o].cpu().numpy(),
                             items, red, n_nodes, n_bins, C)
    for r in (rows, rows.int()):
        got = histogram(xb, node, y, w, n_nodes, n_bins, C, rows=r)
        again = histogram(xb, node, y, w, n_nodes, n_bins, C, rows=r)
        assert np.array_equal(_bits(got), _bits(want))
        assert np.array_equal(_bits(again), _bits(got))
    wm = torch.as_tensor(rng.normal(size=(n, 3)) * 5, dtype=torch.float32,
                         device=dev)
    want_m = moments_ordered(codes, wm[o].cpu().numpy(), items, red,
                             n_nodes, n_bins)
    got_m = moments(xb, node, wm, n_nodes, n_bins, rows=rows)
    assert np.array_equal(_bits(got_m), _bits(want_m))


def test_library_plan_equals_work_items(dev):
    """The wrapper takes its work plan from the library's host copy of
    ``work_items``: the two agree item for item on every layout."""
    import ctypes
    from repro_torch.kernels.histogram.ops import _lib, work_items
    lib = _lib()
    rng = np.random.default_rng(11)
    layouts = [[0], [5, 0, 256, 257, 0], [100_000, 3], [1] * 70 + [10_000],
               [50_000], [31_600] * 100, [10_000_000, 5], [3] * 20_000]
    layouts += [list(rng.integers(0, rng.choice([10, 300, 5000, 200_000]),
                                  rng.integers(1, 400))) for _ in range(200)]
    for counts in layouts:
        bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        items, red, n_partial = work_items(bounds)
        size = lib.histogram_plan(bounds.ctypes.data, len(counts), None)
        assert (size >> 32, size & 0xFFFFFFFF) == (len(items), len(red))
        got = np.zeros((len(items) + len(red), 3), np.int64)
        lib.histogram_plan(bounds.ctypes.data, len(counts),
                           got.ctypes.data_as(ctypes.c_void_p))
        np.testing.assert_array_equal(got[:len(items)], items)
        np.testing.assert_array_equal(got[len(items):], red)
        assert n_partial == len(items) - len(counts) + len(red)


@pytest.mark.parametrize("mode", ["fold", "rank"])
def test_bounds_call_does_not_synchronise(dev, monkeypatch, mode):
    """With host bounds and the row ids' host range, a wrapper call issues
    device work only: under ``set_sync_debug_mode("error")`` any hidden
    synchronisation would raise.  Its result equals the node-id path's bit
    for bit, in shared memory, in sliced features and in global memory."""
    from repro_torch.kernels.histogram.ops import histogram, moments
    _force_mode(monkeypatch, mode)
    for n, n_nodes, d, n_bins, C in [(50_000, 100, 20, 64, 7),
                                     (6000, 5, 40, 256, 7),
                                     (3000, 3, 3, 300, 200)]:
        rng = np.random.default_rng(n_nodes)
        xb, node, y, w, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, C,
                                            dev, integer=False,
                                            n_rows=n + 5)
        node_h = node.cpu().numpy()
        bounds = np.searchsorted(node_h, np.arange(n_nodes + 1))
        span = (int(rows.min()), int(rows.max()))
        wm = torch.stack([w, w * 2, w * w], 1)
        want = histogram(xb, node, y, w, n_nodes, n_bins, C, rows=rows)
        want_m = moments(xb, node, wm, n_nodes, n_bins, rows=rows)
        n0 = histogram.launches + moments.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = histogram(xb, None, y, w, n_nodes, n_bins, C, rows=rows,
                            bounds=bounds, row_range=span)
            got_m = moments(xb, None, wm, n_nodes, n_bins, rows=rows,
                            bounds=bounds, row_range=span)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert histogram.launches + moments.launches == n0 + 2
        assert torch.equal(got, want) and torch.equal(got_m, want_m)
        with pytest.raises(IndexError):
            histogram(xb, None, y, w, n_nodes, n_bins, C, rows=rows,
                      bounds=bounds, row_range=(0, xb.shape[0]))
        with pytest.raises(ValueError, match="bounds"):
            histogram(xb, None, y, w, n_nodes, n_bins, C, rows=rows,
                      bounds=bounds[:-1])


@pytest.mark.parametrize("mode", ["fold", "rank"])
def test_staged_codes_call_equals_device_resident(dev, monkeypatch, mode):
    """The trainer's memmap path: the call's rows gathered on the host in
    node order, staged from pinned memory and read with ``rows=None``,
    give the bits of the same call on the device-resident code matrix
    through row ids, K3 and K4, in both kernel modes; neither the staging
    copy nor the calls synchronise."""
    from repro_torch.kernels.histogram.ops import histogram, moments
    _force_mode(monkeypatch, mode)
    for n, n_nodes, d, n_bins, C in [(50_000, 100, 20, 64, 7),
                                     (6000, 5, 40, 256, 7),
                                     (3000, 3, 3, 300, 200)]:
        rng = np.random.default_rng(n_nodes + 1)
        xb, node, y, w, rows = _hist_inputs(rng, n, n_nodes, d, n_bins, C,
                                            dev, integer=False,
                                            n_rows=n + 5)
        bounds = np.searchsorted(node.cpu().numpy(), np.arange(n_nodes + 1))
        span = (int(rows.min()), int(rows.max()))
        wm = torch.stack([w, w * 2, w * w], 1)
        pinned = torch.from_numpy(
            xb.cpu().numpy()[rows.cpu().numpy()]).pin_memory()
        n0 = histogram.launches + moments.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            staged = pinned.to(dev, non_blocking=True)
            want = histogram(xb, None, y, w, n_nodes, n_bins, C, rows=rows,
                             bounds=bounds, row_range=span)
            got = histogram(staged, None, y, w, n_nodes, n_bins, C,
                            bounds=bounds)
            want_m = moments(xb, None, wm, n_nodes, n_bins, rows=rows,
                             bounds=bounds, row_range=span)
            got_m = moments(staged, None, wm, n_nodes, n_bins,
                            bounds=bounds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert histogram.launches + moments.launches == n0 + 4
        assert torch.equal(got, want) and torch.equal(got_m, want_m)


@pytest.mark.parametrize("model", ["RandomForest", "GradientBoostedTrees"])
def test_memmap_fit_on_the_card_stages_codes(dev, tmp_path, model):
    """A fit whose codes stream to a memmap (``xb_scratch``) runs K3/K4 on
    the card on codes staged per call, grows the in-memory fit's trees bit
    for bit and leaves the scratch directory empty."""
    from repro_torch.data.synthetic import gaussian_classes
    from repro_torch.forest import ensemble, training
    from repro_torch.kernels.histogram.ops import histogram, moments
    X, y = gaussian_classes(4000, d=12, n_classes=2, seed=6)
    kw = dict(n_trees=4, seed=1, device="cuda")
    card = getattr(ensemble, model)(**kw).fit(X, y)
    real = training.device_codes

    def whole_copy(Xb, *a, **k):
        assert not isinstance(Xb, np.memmap), "memmap copied up whole"
        return real(Xb, *a, **k)
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(training, "device_codes", whole_copy)
    monkeypatch.setattr(ensemble, "device_codes", whole_copy)
    try:
        n0 = histogram.launches + moments.launches
        staged = getattr(ensemble, model)(xb_scratch=str(tmp_path),
                                          **kw).fit(X, y)
        assert histogram.launches + moments.launches > n0
    finally:
        monkeypatch.undo()
    for a, b in zip(card.trees_, staged.trees_):
        for f in ("feature", "threshold", "left", "right", "leaf_id",
                  "value", "n_node_samples"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert list(tmp_path.iterdir()) == []


def test_budgeted_engine_keeps_the_bits_on_the_card(dev, tmp_path):
    """Under a memory budget a CUDA engine's K2 blocks hold 32 rows
    instead of 4,096 and its products go a few columns at a time: blocks,
    top-k and (class-bucketed) squared row sums keep the in-memory
    engine's bits (the sums reduce 32 aligned rows at a time, whatever the
    block height), products agree within 1e-15."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes
    X, y = gaussian_classes(5000, d=10, n_classes=4, seed=3)
    kw = dict(n_trees=20, seed=0, device="cuda")
    a = ForestKernel(**kw).fit(X, y)
    b = ForestKernel(scratch_dir=str(tmp_path), memory_budget_bytes=1 << 20,
                     **kw).fit(X, y)
    ea, eb = a.engine, b.engine
    assert (ea._op_row_chunk(4096), eb._op_row_chunk(4096)) == (4096, 32)
    assert eb._col_chunk(40) < 40
    Xq = X[:300] + 1e-3
    for u, v in [(ea.squared_row_sums(y, 4), eb.squared_row_sums(y, 4)),
                 (ea.squared_row_sums(), eb.squared_row_sums()),
                 (ea.squared_row_sums(y, 4, X=Xq),
                  eb.squared_row_sums(y, 4, X=Xq)),
                 (ea.kernel_block(np.arange(100)),
                  eb.kernel_block(np.arange(100)))] + \
            list(zip(ea.topk(7), eb.topk(7))):
        assert torch.equal(u, v)
    V = np.random.default_rng(0).random((5000, 40))
    assert float((ea.matmat(V) - eb.matmat(V)).abs().max()) <= 1e-15
    assert float((ea.predict(y, 4) - eb.predict(y, 4)).abs().max()) <= 1e-15


@pytest.mark.parametrize("model,task", [("RandomForest", "classification"),
                                        ("ExtraTrees", "classification"),
                                        ("RandomForest", "regression"),
                                        ("ExtraTrees", "regression")])
def test_card_trees_equal_host_trees(dev, model, task):
    """The trainer on the card (K3/K4) grows the host trainer's trees bit
    for bit on integer payloads."""
    from repro_torch.data.synthetic import gaussian_classes
    from repro_torch.forest import ensemble
    from repro_torch.kernels.histogram.ops import histogram, moments
    rng = np.random.default_rng(1)
    if task == "classification":
        X, y = gaussian_classes(3000, d=12, n_classes=5, seed=2)
    else:
        X = rng.random((3000, 12))
        y = np.floor(X[:, 0] * 5 + X[:, 1] * 3)
    kw = dict(n_trees=6, seed=3, task=task)
    n0 = histogram.launches + moments.launches
    card = getattr(ensemble, model)(device="cuda", **kw).fit(X, y)
    assert histogram.launches + moments.launches > n0
    host = getattr(ensemble, model)(device="cuda", tree_backend="numpy",
                                    **kw).fit(X, y)
    for a, b in zip(card.trees_, host.trees_):
        for f in ("feature", "threshold", "left", "right", "leaf_id",
                  "value", "n_node_samples"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_gbt_on_the_card_is_deterministic_and_agrees(dev):
    from repro_torch.data.synthetic import friedman1
    from repro_torch.forest.ensemble import GradientBoostedTrees
    X, y = friedman1(4000, d=10, seed=4)
    kw = dict(n_trees=12, seed=0, task="regression")
    a = GradientBoostedTrees(device="cuda", **kw).fit(X, y)
    b = GradientBoostedTrees(device="cuda", **kw).fit(X, y)
    for s, t in zip(a.trees_, b.trees_):
        assert np.array_equal(s.threshold, t.threshold)
        assert np.array_equal(s.value, t.value)
    host = GradientBoostedTrees(device="cuda", tree_backend="numpy",
                                **kw).fit(X, y)
    err = (a.predict(X) - host.predict(X)).abs().max().item()
    assert err <= 0.05 * y.std()


# ------------------------------------------------ snapshots and serving

def _serving_pair():
    """A card kernel with its online propagation and embedding states, and
    an OOS batch."""
    from repro_torch.applications.embed import ProximityEmbedding
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    X, y = gaussian_classes(3000, d=10, n_classes=4, seed=6)
    Xtr, ytr, Xte, _ = train_test_split(X, y, test_frac=0.2, seed=2)
    gpu = ForestKernel(kernel_method="gap", n_trees=12, seed=1,
                       device="cuda").fit(Xtr, ytr)
    labeled = np.random.default_rng(1).random(len(ytr)) < 0.2
    prop = gpu.propagate_labels(labeled, online=True)
    emb = ProximityEmbedding(n_components=2).fit(gpu.engine)
    return gpu, prop, emb, np.ascontiguousarray(Xte[:60])


def test_server_tick_routes_once_on_the_card(dev):
    """A tick holding all five kinds launches K1 once (the tick's batch)
    and K2 for ``topk`` and ``outlier``; results are host numpy arrays
    that share no memory with the slot buffer, and equal direct engine
    calls on the card."""
    from repro_torch.applications.outliers import train_outlier_stats
    gpu, prop, emb, Xq = _serving_pair()
    srv = gpu.serve(n_slots=64, propagator=prop, embedding=emb)
    train_outlier_stats(gpu.engine, gpu.ctx.y)      # training-side stats
    reqs = [("predict", Xq[:5]), ("topk", Xq[5:13], 4),
            ("outlier", Xq[13:20]), ("propagate", Xq[20:30]),
            ("embed", Xq[30:40])]
    torch.cuda.synchronize()
    k1, k2 = route.launches, block_prox.launches
    res = srv.serve(reqs)
    torch.cuda.synchronize()
    assert srv.ticks == 1
    assert route.launches - k1 == 1
    assert block_prox.launches - k2 >= 2
    for r in srv.finished:
        for v in r.result.values():
            assert isinstance(v, np.ndarray)
            assert not np.shares_memory(v, srv._slot_X)
    want = gpu.engine.predict(gpu.ctx.y, n_classes=4,
                              X=np.ascontiguousarray(Xq[:5])).argmax(1)
    np.testing.assert_array_equal(res[0]["labels"], want.cpu().numpy())
    idx, val = gpu.engine.topk(k=4, X=np.ascontiguousarray(Xq[5:13]))
    np.testing.assert_array_equal(res[1]["indices"], idx.cpu().numpy())
    np.testing.assert_allclose(res[1]["values"], val.cpu().numpy(),
                               rtol=0, atol=1e-12)
    # the engine timer runs to the end of the card's work and is labelled
    # with the device type
    h = srv.registry.histogram("engine_op_seconds",
                               labels=("op", "backend", "tier"))
    assert h.labels(op="predict", backend="cuda", tier="server").count == 1


def test_async_tiered_on_the_card_matches_sync(dev):
    """Worker threads on the default stream give the synchronous drain's
    answers, and every request is answered."""
    gpu, prop, emb, Xq = _serving_pair()
    ce = gpu.compress(n_prototypes=5, k=40)
    reqs = [("predict", Xq[i * 6:(i + 1) * 6]) for i in range(8)] + \
        [("topk", Xq[48:56], 4), ("outlier", Xq[:8]),
         ("embed", Xq[8:16])]

    def fresh():
        return gpu.serve_tiered(prefix_depth=3, compressed_engine=ce,
                                n_slots=16, escalate_margin=0.5,
                                propagator=prop, embedding=emb)

    sync_res = fresh().serve(reqs)
    srv = fresh().start()
    try:
        out = srv.wait([srv.submit(*r) for r in reqs], timeout=120.0)
    finally:
        srv.stop()
    assert not any(t.is_alive() for t in srv._worker_threads.values())
    for a, b in zip(sync_res, out):
        assert b is not None
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-10)


def test_snapshot_round_trip_on_the_card(dev, tmp_path):
    """Save on the card, load on the card: same digests, the load routes
    nothing, the block kernel's ops give the saved kernel's bits, and the
    segment-sum products (``index_add_`` atomics: last bits vary from run
    to run) agree within 1e-12."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.factorization import factor_digest
    gpu, _, _, Xq = _serving_pair()
    path = tmp_path / "card.npz"
    manifest = gpu.save(path)
    k1 = route.launches
    back = ForestKernel.load(path, device="cuda")
    torch.cuda.synchronize()
    assert route.launches == k1
    assert back.engine.device.type == "cuda"
    assert back.ctx.digest() == manifest["ctx_digest"]
    assert factor_digest(back.engine.gl, back.engine.q, back.engine.w) == \
        manifest["factor_digest"]
    y = gpu.ctx.y
    for a, b in [(gpu.kernel_block(np.arange(64)),
                  back.kernel_block(np.arange(64))),
                 (gpu.engine.squared_row_sums(y, 4, X=Xq),
                  back.engine.squared_row_sums(y, 4, X=Xq))]:
        assert torch.equal(a, b)
    torch.testing.assert_close(back.engine.predict(y, 4, X=Xq),
                               gpu.engine.predict(y, 4, X=Xq), rtol=0,
                               atol=1e-12)
    assert torch.equal(back.predict(Xq), gpu.predict(Xq))
    i1, v1 = gpu.topk(k=7, X=Xq)
    i2, v2 = back.topk(k=7, X=Xq)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)


# ----------------------------------------------------------- LM serving ---
LM_ARCHS = ("granite_34b", "minicpm_2b", "granite_8b", "command_r_35b",
            "mamba2_2p7b", "qwen3_moe_235b_a22b", "granite_moe_3b_a800m",
            "musicgen_large", "hymba_1p5b")       # vlm: forward only


def _lm_cfg(arch):
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":      # drop-free: teacher-forced = incremental
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


@pytest.fixture
def lm_f32(monkeypatch):
    """The port's LM computing in float32, TF32 off."""
    from repro_torch.models import lm
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_matches_forward_on_the_card(dev, arch):
    """The reference's own criterion (bf16): greedy decode logits agree
    with the teacher-forced forward's argmax at > 90% of positions."""
    from repro_torch.models import lm
    cfg = _lm_cfg(arch)
    params = lm.init_params(cfg, 0, device=dev)
    B, S = 2, 12
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    full, _ = lm.forward(params, cfg, tokens, attn_chunk=4)
    cache = lm.init_cache(cfg, B, 32, dtype=torch.float32, device=dev)
    outs = []
    for pos in range(S):
        lg, cache = lm.decode_step(params, cfg, tokens[:, pos:pos + 1],
                                   cache, pos)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    assert torch.isfinite(dec.float()).all()
    assert (full.argmax(-1) == dec.argmax(-1)).float().mean() > 0.9


@pytest.mark.parametrize("arch", LM_ARCHS + ("paligemma_3b",))
def test_lm_on_the_card_matches_the_cpu_in_float32(dev, arch, lm_f32):
    """Float32 compute: forward, decode logits and caches on the card
    within 1e-4 of the port's CPU path on the same weights."""
    import copy
    from repro_torch.models import lm
    cfg = _lm_cfg(arch)
    params = lm.init_params(cfg, 1, device=dev)
    host = copy.deepcopy(params).to("cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 12))
    img = None
    if cfg.family == "vlm":
        img = torch.from_numpy(rng.normal(
            size=(2, cfg.prefix_len, cfg.d_model)).astype(np.float32))
    kw = dict(attn_chunk=4)
    a, aux_a = lm.forward(params, cfg, tokens, image_embed=img, **kw)
    b, aux_b = lm.forward(host, cfg, tokens, image_embed=img, **kw)
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux_a.cpu(), aux_b, atol=1e-4, rtol=1e-4)
    if cfg.family == "vlm":
        return
    ca = lm.init_cache(cfg, 2, 16, dtype=torch.float32, device=dev)
    cb = lm.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for pos in range(12):
        la, ca = lm.decode_step(params, cfg, tokens[:, pos:pos + 1], ca, pos)
        lb, cb = lm.decode_step(host, cfg, tokens[:, pos:pos + 1], cb, pos)
        torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-4)
    for k in cb:
        torch.testing.assert_close(ca[k].cpu(), cb[k], atol=1e-4, rtol=1e-4)


def test_lm_engine_per_slot_decode_on_the_card(dev, lm_f32):
    """The engine's lanes at different positions (5 requests of 3-9 prompt
    tokens through 2 slots): on granite each request gets its
    single-request greedy tokens, on the card; on hymba (whose admission
    steps advance the other lanes' SSM states, as the reference's engine
    does) the card's engine gives the CPU engine's tokens."""
    import copy
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServingEngine

    def drain(cfg, params):
        rng = np.random.default_rng(2)
        eng = ServingEngine(cfg, params, n_slots=2, max_seq=32)
        for i, n in enumerate((6, 3, 9, 4, 7)):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n)
                               .astype(np.int32), max_new_tokens=12))
        done = eng.run_until_drained()
        assert len(done) == 5
        return {r.uid: r for r in done}

    cfg = _lm_cfg("granite_8b")
    params = lm.init_params(cfg, 2, device=dev)
    for r in drain(cfg, params).values():
        cache = lm.init_cache(cfg, 1, 32, device=dev)
        seq = list(r.prompt)
        for pos in range(len(r.prompt) + len(r.generated) - 1):
            lg, cache = lm.decode_step(params, cfg,
                                       np.array([[seq[pos]]], np.int32),
                                       cache, pos)
            if pos >= len(r.prompt) - 1:
                seq.append(int(lg[0, -1].argmax()))
        assert seq[len(r.prompt):] == r.generated, r.uid
    cfg = _lm_cfg("hymba_1p5b")            # SWA ring buffers + globals
    params = lm.init_params(cfg, 2, device=dev)
    card = drain(cfg, params)
    host = drain(cfg, copy.deepcopy(params).to("cpu"))
    for uid, r in card.items():
        assert r.generated == host[uid].generated, uid


def test_moe_combine_is_deterministic_on_the_card(dev):
    """Each token's expert contributions are summed in a fixed order (no
    atomics): two runs give the same bits, at granite-moe's widths."""
    from repro_torch.models.layers import Initializer
    from repro_torch.models.moe import init_moe, moe_forward
    ini = Initializer(torch.Generator(device=dev).manual_seed(3), dev)
    p = init_moe(ini, 1536, 40, 512)
    x = torch.randn(4, 512, 1536, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4)
                    ).to(torch.bfloat16)
    a, aux_a = moe_forward(p, x, n_experts=40, top_k=8)
    b, aux_b = moe_forward(p, x, n_experts=40, top_k=8)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(aux_a, aux_b)
    assert torch.isfinite(a.float()).all() and a.abs().max() > 0


def _train_pair(arch, dev, seed=0):
    """A reduced arch's parameters on the card and a CPU copy, and a
    seeded batch (labels the next tokens)."""
    import copy
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed, device=dev)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, 20))
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    return cfg, params, copy.deepcopy(params).to("cpu"), batch


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch, lm_f32):
    """Float32 compute: the loss, every leaf's gradient (within 1e-4 of its
    largest), the metrics and the parameters after one AdamW step, on the
    card against the port's CPU path from the same weights and batch."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step, value_and_grad
    cfg, params, host, batch = _train_pair(arch, dev)
    la, ga = value_and_grad(cfg, params, batch, attn_chunk=8)
    lb, gb = value_and_grad(cfg, host, batch, attn_chunk=8)
    torch.testing.assert_close(la.cpu(), lb, atol=1e-4, rtol=1e-4)
    for a, b in zip(ga, gb):
        assert torch.isfinite(a).all()
        tol = 1e-4 * float(b.abs().max())
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=1e-4)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, schedule="const")
    out = []
    for p in (params, host):
        state = {"params": p, "opt": adamw_init(p)}
        state, m = make_train_step(cfg, opt, attn_chunk=8)(state, batch)
        out.append((state, {k: float(v) for k, v in m.items()}))
    for k in ("loss", "grad_norm", "lr"):
        assert out[0][1][k] == pytest.approx(out[1][1][k], rel=1e-4), k
    for a, b in zip(out[0][0]["opt"]["m"].parameters(),
                    out[1][0]["opt"]["m"].parameters()):
        tol = 1e-4 * float(b.abs().max())
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=1e-4)


def test_moe_remat_routes_and_differentiates_as_without(dev, lm_f32,
                                                        monkeypatch):
    """``torch.topk`` promises no order among ties on the card, so the
    backward pass's recomputation could route a token elsewhere than the
    forward did.  Each layer's recomputed routing equals its first pass,
    and the gradients equal those without remat up to the atomics of the
    backward's scatter-adds (1e-5 of each leaf's largest)."""
    from repro_torch.train.steps import value_and_grad
    cfg, params, _, batch = _train_pair("granite_moe_3b_a800m", dev, seed=3)
    seen = []
    topk = torch.topk

    def spy(x, k, *a, **kw):
        out = topk(x, k, *a, **kw)
        seen.append(out.indices.clone())
        return out
    monkeypatch.setattr(torch, "topk", spy)
    la, ga = value_and_grad(cfg, params, batch, attn_chunk=8, remat=True)
    L = cfg.n_layers
    assert len(seen) == 2 * L
    for first, again in zip(seen[:L], reversed(seen[L:])):
        assert torch.equal(first, again)
    lb, gb = value_and_grad(cfg, params, batch, attn_chunk=8, remat=False)
    assert torch.equal(la, lb)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("shape", [(255,), (1000,), (32001, 1600),
                                   (1600, 5504)], ids=str)
def test_int8_compression_bits_on_the_card(dev, shape):
    """Codes, scales and error-feedback residuals on the card equal the
    CPU's bit for bit (hymba's embedding and MLP leaves among them)."""
    from repro_torch.distributed.compression import (EFState, ef_compress,
                                                     quantize_int8)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    g.view(-1)[::13] = 0
    qa, sa = quantize_int8(g.to(dev))
    qb, sb = quantize_int8(g)
    assert torch.equal(qa.cpu(), qb)
    assert torch.equal(sa.cpu().view(torch.int32), sb.view(torch.int32))
    r = torch.randn(shape, generator=torch.Generator().manual_seed(8)) * 1e-3
    (oa,), efa = ef_compress([g.to(dev)], EFState([r.to(dev)]))
    (ob,), efb = ef_compress([g], EFState([r]))
    assert torch.equal(oa.cpu().view(torch.int32), ob.view(torch.int32))
    assert torch.equal(efa.residual[0].cpu().view(torch.int32),
                       efb.residual[0].view(torch.int32))


@pytest.fixture(scope="module")
def cuda_mesh():
    """A one-rank NCCL mesh ``("data", "model")`` of (1, 1) on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(1, 1, device="cuda")


def test_shard_hint_is_identity_at_tp1_on_the_card(dev, cuda_mesh):
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed.logical import (axis_env, distribute_full,
                                                 shard_hint, tp_size_of)
    x = torch.randn(4, 32, 16, device=dev)
    d = distribute_full(x, cuda_mesh, [Replicate(), Replicate()])
    with axis_env(cuda_mesh):
        assert tp_size_of() == 1
        assert shard_hint(x, "batch", "sp", None) is x
        for axes in (("batch", "sp", None), ("batch", None, "tp")):
            got = shard_hint(d, *axes)
            assert got is d
    assert torch.equal(d.to_local(), x)


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m",
                                  "hymba_1p5b"])
def test_param_specs_place_and_gather_bits_on_the_card(dev, cuda_mesh,
                                                       arch):
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (distribute_params,
                                                  param_specs)
    from repro_torch.models import lm
    cfg = get_config(arch).reduced()
    want = {n: p.detach().clone()
            for n, p in lm.init_params(cfg, 0, device=dev).named_parameters()}
    params = lm.init_params(cfg, 0, device=dev)
    distribute_params(params, param_specs(params, cuda_mesh), cuda_mesh)
    for n, p in params.named_parameters():
        assert p.device_mesh is cuda_mesh and p.requires_grad
        full = p.full_tensor()
        assert full.is_cuda and torch.equal(full, want[n]), n
        assert torch.equal(p.to_local(), want[n]), n


def test_one_rank_mesh_train_step_matches_the_plain_step(dev, cuda_mesh,
                                                         lm_f32):
    from repro_torch.configs.base import get_config
    from repro_torch.distributed.logical import (axis_env, distribute_full,
                                                 placements_for)
    from repro_torch.distributed.sharding import batch_specs
    from repro_torch.train import steps
    cfg = get_config("granite_8b").reduced()
    tok = torch.randint(0, cfg.vocab, (4, 32),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    batch = {"tokens": tok, "labels": tok}
    one = steps.init_train_state(cfg, 0, device=dev)
    l1, g1 = steps.value_and_grad(cfg, one["params"], batch, attn_chunk=16)
    two = steps.distribute_train_state(
        steps.init_train_state(cfg, 0, device=dev), cuda_mesh)
    bs = batch_specs(cuda_mesh)
    b2 = {k: distribute_full(v, cuda_mesh, placements_for(bs[k], cuda_mesh))
          for k, v in batch.items()}
    with axis_env(cuda_mesh):
        l2, g2 = steps.value_and_grad(cfg, two["params"], b2, attn_chunk=16)
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    for a, b in zip(g1, g2):
        b = b.full_tensor()
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
