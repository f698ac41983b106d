"""The port's out-of-core pipeline against its in-memory twin and against
the reference's.

Counterparts of ``tests/test_outofcore.py`` — streamed binning, memmap
training, the streamed CSR build, the chunked context and the budgeted
engine — each on the port's two trainer backends (``numpy``, and ``torch``
on CPU tensors, where a memmap's rows are staged per histogram call), plus
cases across the packages at small sizes on inputs made from a seed:
the two ``streamed_leaf_map`` give the same CSR, the two binners the same
streamed codes, and a budgeted ``ForestKernel`` in each package the same
digest strings and ops within 1e-8 (the reference's ``scipy`` engine).
Every disk-resident path must give its in-memory twin's bits; the scratch
directory is empty after a fit, whether it succeeded or raised.
"""
import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _hyp import given, settings, st
from repro.core.api import ForestKernel as RefKernel
from repro.core.factorization import streamed_leaf_map as ref_streamed
from repro.forest.training import Binner as RefBinner
from repro_torch.core import engine as eng_mod
from repro_torch.core.api import ForestKernel
from repro_torch.core.context import EnsembleContext
from repro_torch.core.engine import ProximityEngine
from repro_torch.core.factorization import factor_digest, streamed_leaf_map
from repro_torch.core.leafmap import build_leaf_map
from repro_torch.core.snapshot import SnapshotError, _checksum
from repro_torch.core.weights import get_assignment
from repro_torch.data.synthetic import gaussian_classes
from repro_torch.forest import ensemble as ens
from repro_torch.forest.bootstrap import bootstrap_counts
from repro_torch.forest.ensemble import GradientBoostedTrees, RandomForest
from repro_torch.forest.training import Binner, TreeParams, fit_forest_binned

BACKENDS = ("numpy", "torch")
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_id", "value",
               "n_node_samples")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _random_factors(n, T, leaves_per_tree, seed=0, zero_rows=(),
                    zero_frac=0.4):
    """(global_leaves, weights, total_leaves) with per-tree leaf ranges."""
    rng = np.random.default_rng(seed)
    gl = np.zeros((n, T), dtype=np.int64)
    off = 0
    for t in range(T):
        nl = leaves_per_tree[t % len(leaves_per_tree)]
        gl[:, t] = rng.integers(0, nl, n) + off
        off += nl
    w = rng.random((n, T))
    w[rng.random((n, T)) < zero_frac] = 0.0
    for r in zero_rows:
        w[r] = 0.0
    return gl, w, off


def _assert_same_csr(a: sp.csr_matrix, b: sp.csr_matrix):
    assert a.shape == b.shape
    for attr in ("indptr", "indices", "data"):
        va, vb = np.asarray(getattr(a, attr)), np.asarray(getattr(b, attr))
        assert va.dtype == vb.dtype, (attr, va.dtype, vb.dtype)
        np.testing.assert_array_equal(va, vb, err_msg=attr)


def _assert_same_trees(a, b):
    assert len(a) == len(b)
    for t1, t2 in zip(a, b):
        for f in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f),
                                          err_msg=f)
        assert t1.depth == t2.depth


def _same(a, b):
    """Equal bit for bit (tensors or arrays)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# streamed binner
# ---------------------------------------------------------------------------

def test_binner_streamed_transform_identity(tmp_path):
    X, _ = gaussian_classes(700, d=9, seed=0)
    b = Binner(X, 64, np.random.default_rng(0))
    assert b.code_dtype == np.uint8
    ref = b.transform(X)
    mm = b.transform_memmap(X, tmp_path / "xb.mm")
    assert isinstance(mm, np.memmap) and mm.dtype == ref.dtype
    np.testing.assert_array_equal(np.asarray(mm), ref)


def test_binner_int16_codes(tmp_path):
    X, _ = gaussian_classes(600, d=4, seed=1)
    b = Binner(X, 300, np.random.default_rng(0))
    assert b.code_dtype == np.int16
    ref = b.transform(X)
    assert ref.dtype == np.int16
    mm = b.transform_memmap(X, tmp_path / "xb.mm")
    np.testing.assert_array_equal(np.asarray(mm), ref)


def test_binner_transform_out_validation():
    X, _ = gaussian_classes(50, d=3, seed=0)
    b = Binner(X, 32, np.random.default_rng(0))
    with pytest.raises(ValueError, match="out must be"):
        b.transform(X, out=np.empty((50, 3), dtype=np.int32))
    with pytest.raises(ValueError, match="out must be"):
        b.transform(X, out=np.empty((49, 3), dtype=np.uint8))


@pytest.mark.parametrize("n_bins", [64, 300])
def test_streamed_codes_equal_reference(tmp_path, n_bins):
    """Both packages' binners stream the same codes from a memmapped X."""
    X, _ = gaussian_classes(900, d=7, seed=4)
    X[::13, 2] = np.nan
    Xm = np.memmap(tmp_path / "X.mm", dtype=np.float64, mode="w+",
                   shape=X.shape)
    Xm[:] = X
    port = Binner(Xm, n_bins, np.random.default_rng(3))
    ref = RefBinner(Xm, n_bins, np.random.default_rng(3))
    a = port.transform_memmap(Xm, tmp_path / "a.mm")
    b = ref.transform_memmap(Xm, tmp_path / "b.mm")
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# memmap training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_forest_binned_memmap_bit_identity(backend, tmp_path):
    X, y = gaussian_classes(900, d=7, n_classes=3, seed=2)
    rng = np.random.default_rng(0)
    binner = Binner(X, 64, rng)
    Xb = binner.transform(X)
    mm = binner.transform_memmap(X, tmp_path / "xb.mm")
    inbag = bootstrap_counts(len(X), 4, rng, True)
    params = TreeParams(task="classification", n_classes=3, max_depth=12,
                        min_samples_leaf=1, min_samples_split=2,
                        max_features="sqrt", n_bins=64, splitter="best",
                        tree_backend=backend)
    ta = fit_forest_binned(Xb, y.astype(np.int64), inbag, params,
                           np.random.default_rng(7).spawn(4), binner,
                           backend=backend, device="cpu")
    tb = fit_forest_binned(mm, y.astype(np.int64), inbag, params,
                           np.random.default_rng(7).spawn(4), binner,
                           backend=backend, device="cpu")
    _assert_same_trees(ta, tb)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", ["RandomForest", "ExtraTrees"])
def test_forest_xb_scratch_bit_identity_and_cleanup(backend, model, tmp_path):
    X, y = gaussian_classes(800, d=6, n_classes=3, seed=3)
    scratch = tmp_path / "scr"
    kw = dict(n_trees=5, seed=0, device="cpu", tree_backend=backend)
    a = getattr(ens, model)(**kw).fit(X, y)
    b = getattr(ens, model)(xb_scratch=str(scratch), **kw).fit(X, y)
    _assert_same_trees(a.trees_, b.trees_)
    assert list(scratch.iterdir()) == []     # cleaned on success


def test_torch_trainer_stages_memmap_rows(tmp_path, monkeypatch):
    """On the torch backend a memmap is never copied whole: every
    histogram call gets codes staged for its own rows (a ``rows=None`` call
    on a code matrix of exactly the call's samples), and the device copy
    of the whole matrix is never made."""
    from repro_torch.forest import training
    X, y = gaussian_classes(600, d=5, n_classes=3, seed=8)
    calls = []
    real = training.hops.histogram

    def spy(xb, node, yv, w, n_nodes, n_bins, C, rows=None, **kw):
        calls.append((xb.shape[0], yv.shape[0], rows is None))
        return real(xb, node, yv, w, n_nodes, n_bins, C, rows=rows, **kw)

    def no_device_codes(*a, **k):
        raise AssertionError("memmap codes copied to the device whole")
    monkeypatch.setattr(training.hops, "histogram", spy)
    monkeypatch.setattr(training, "device_codes", no_device_codes)
    monkeypatch.setattr(ens, "device_codes", no_device_codes)
    f = RandomForest(n_trees=3, seed=0, device="cpu", tree_backend="torch",
                     xb_scratch=str(tmp_path)).fit(X, y)
    assert calls and all(n == m and staged for n, m, staged in calls)
    monkeypatch.undo()
    g = RandomForest(n_trees=3, seed=0, device="cpu",
                     tree_backend="torch").fit(X, y)
    _assert_same_trees(f.trees_, g.trees_)


@pytest.mark.parametrize("backend", BACKENDS)
def test_xb_scratch_cleanup_on_failure(tmp_path, monkeypatch, backend):
    X, y = gaussian_classes(300, d=5, n_classes=2, seed=4)
    scratch = tmp_path / "scr"

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(ens, "fit_forest_binned", boom)
    monkeypatch.setattr(ens, "fit_tree_binned", boom)
    with pytest.raises(RuntimeError, match="injected"):
        RandomForest(n_trees=3, seed=0, device="cpu", tree_backend=backend,
                     xb_scratch=str(scratch)).fit(X, y)
    assert list(scratch.iterdir()) == []     # cleaned on failure too


@pytest.mark.parametrize("backend", BACKENDS)
def test_gbt_xb_scratch_bit_identity(tmp_path, backend):
    X, y = gaussian_classes(500, d=6, n_classes=2, sep=3.0, seed=5)
    kw = dict(n_trees=4, seed=0, device="cpu", tree_backend=backend)
    a = GradientBoostedTrees(**kw).fit(X, y)
    b = GradientBoostedTrees(xb_scratch=str(tmp_path), **kw).fit(X, y)
    _assert_same_trees(a.trees_, b.trees_)
    np.testing.assert_array_equal(a.tree_weights_, b.tree_weights_)
    assert not any(p.name.startswith("xb_") for p in tmp_path.iterdir())


# ---------------------------------------------------------------------------
# streamed CSR factor construction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_chunk", [1, 13, 450, 463, 10_000])
def test_streamed_leaf_map_bit_identity(row_chunk):
    gl, w, L = _random_factors(450, 8, [30, 1, 17], seed=6,
                               zero_rows=(0, 7, 449))
    got = streamed_leaf_map(gl, w, L, row_chunk=row_chunk)
    _assert_same_csr(build_leaf_map(gl, w, L), got)
    assert got.has_sorted_indices
    # the reference's streamed build gives the same CSR
    _assert_same_csr(ref_streamed(gl, w, L, row_chunk=row_chunk), got)


def test_streamed_leaf_map_single_leaf_trees():
    # every tree has exactly one leaf -> every row maps to the same columns
    gl, w, L = _random_factors(60, 5, [1], seed=7, zero_frac=0.5)
    assert L == 5
    got = streamed_leaf_map(gl, w, L, row_chunk=7)
    _assert_same_csr(build_leaf_map(gl, w, L), got)
    _assert_same_csr(ref_streamed(gl, w, L, row_chunk=7), got)


def test_streamed_leaf_map_all_zero_weights():
    gl, w, L = _random_factors(40, 4, [6], seed=8)
    w[:] = 0.0
    got = streamed_leaf_map(gl, w, L, row_chunk=9)
    _assert_same_csr(build_leaf_map(gl, w, L), got)
    _assert_same_csr(ref_streamed(gl, w, L, row_chunk=9), got)
    assert got.nnz == 0


@pytest.mark.parametrize("row_chunk", [37, 300])
def test_streamed_leaf_map_memmap_backed(tmp_path, row_chunk):
    gl, w, L = _random_factors(300, 6, [25], seed=9)
    ref = build_leaf_map(gl, w, L)
    got = streamed_leaf_map(gl, w, L, row_chunk=row_chunk,
                            memmap_threshold_bytes=0,
                            scratch_dir=str(tmp_path))
    assert isinstance(got.data, np.memmap)
    _assert_same_csr(ref, got)
    other = ref_streamed(gl, w, L, row_chunk=row_chunk,
                         memmap_threshold_bytes=0,
                         scratch_dir=str(tmp_path))
    _assert_same_csr(other, got)
    # scratch files are unlinked at once: nothing on disk afterwards
    assert list(tmp_path.iterdir()) == []
    # the memmap-backed matrix still computes like a normal CSR
    v = np.random.default_rng(0).random((L, 2))
    np.testing.assert_allclose(got @ v, ref @ v)


def test_streamed_leaf_map_memmap_input(tmp_path):
    gl, w, L = _random_factors(200, 5, [12], seed=10)
    glm = np.memmap(tmp_path / "gl.mm", dtype=gl.dtype, mode="w+",
                    shape=gl.shape)
    glm[:] = gl
    wm = np.memmap(tmp_path / "w.mm", dtype=w.dtype, mode="w+",
                   shape=w.shape)
    wm[:] = w
    got = streamed_leaf_map(glm, wm, L, row_chunk=41)
    _assert_same_csr(build_leaf_map(gl, w, L), got)
    _assert_same_csr(ref_streamed(glm, wm, L, row_chunk=41), got)


def test_streamed_leaf_map_from_device_rows():
    """The engine feeds the streamed build row slices of its device factors
    (``_HostRows``): the same CSR as whole host arrays."""
    gl, w, L = _random_factors(250, 7, [9, 4], seed=12)
    got = streamed_leaf_map(
        eng_mod._HostRows(torch.as_tensor(gl, dtype=torch.int32), np.int64),
        eng_mod._HostRows(torch.as_tensor(w), np.float64), L, row_chunk=19)
    _assert_same_csr(build_leaf_map(gl, w, L), got)


@settings(deadline=None, max_examples=20)
@given(n=st.integers(min_value=1, max_value=120),
       row_chunk=st.integers(min_value=1, max_value=150),
       seed=st.integers(min_value=0, max_value=50))
def test_streamed_leaf_map_chunk_boundary_property(n, row_chunk, seed):
    gl, w, L = _random_factors(n, 3, [5, 1], seed=seed,
                               zero_rows=(0,) if n > 1 else ())
    got = streamed_leaf_map(gl, w, L, row_chunk=row_chunk)
    _assert_same_csr(build_leaf_map(gl, w, L), got)
    _assert_same_csr(ref_streamed(gl, w, L, row_chunk=row_chunk), got)


# ---------------------------------------------------------------------------
# chunked context + budgeted engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    X, y = gaussian_classes(700, d=6, n_classes=3, seed=0)
    return RandomForest(n_trees=8, seed=0, device="cpu").fit(X, y), X, y


@pytest.mark.parametrize("row_chunk", [1, 97, 700, 5000])
def test_context_row_chunk_digest_identity(fitted, row_chunk):
    f, _, _ = fitted
    a = EnsembleContext.from_forest(f)
    b = EnsembleContext.from_forest(f, row_chunk=row_chunk)
    assert a.digest() == b.digest()
    assert torch.equal(a.leaves, b.leaves)


def test_context_row_chunk_reads_a_memmap(fitted, tmp_path):
    """A disk-backed X routes chunk by chunk to the in-memory leaves."""
    f, X, _ = fitted
    Xm = np.memmap(tmp_path / "X.mm", dtype=np.float64, mode="w+",
                   shape=X.shape)
    Xm[:] = X
    a = EnsembleContext.from_forest(f)
    b = EnsembleContext.from_forest(f, X=Xm, row_chunk=64)
    assert a.digest() == b.digest()


@pytest.mark.parametrize("method", ["original", "oob", "gap"])
def test_engine_budget_bit_identity(fitted, method):
    f, X, y = fitted
    ctx = EnsembleContext.from_forest(f)
    a = ProximityEngine(ctx, get_assignment(method, ctx), forest=f)
    b = ProximityEngine(ctx, get_assignment(method, ctx), forest=f,
                        memory_budget_bytes=1 << 20)
    _assert_same_csr(a.Q, b.Q)
    _assert_same_csr(a.W, b.W)
    V = np.random.default_rng(0).random((len(X), 3))
    _same(a.matmat(V), b.matmat(V))
    # wide V under a tiny budget forces the column-chunked bucket table and
    # blocks of a few rows
    c = ProximityEngine(ctx, get_assignment(method, ctx), forest=f,
                        memory_budget_bytes=1 << 14)
    Vw = np.random.default_rng(1).random((len(X), 40))
    assert c._col_chunk(40) < 40
    assert c._op_row_chunk(4096) < len(X)
    _same(a.matmat(Vw), c.matmat(Vw))
    mask = (np.arange(len(X)) % 3 == 0).astype(float)
    _same(a.matmat(Vw, col_mask=mask), c.matmat(Vw, col_mask=mask))
    for e in (b, c):
        _same(a.squared_row_sums(class_ids=y, n_classes=3),
              e.squared_row_sums(class_ids=y, n_classes=3))
        _same(a.squared_row_sums(), e.squared_row_sums())
        for u, v in zip(a.topk(5), e.topk(5)):
            _same(u, v)
        _same(a.predict(y, n_classes=3), e.predict(y, n_classes=3))
        _same(a.row_sums(), e.row_sums())
        _same(a.kernel_block(np.arange(50)), e.kernel_block(np.arange(50)))


def test_engine_budget_host_csr_paths(fitted, monkeypatch):
    """A CPU engine's host CSR paths (large train-side jobs) take the
    budget's row blocks, with the same results."""
    f, X, y = fitted
    monkeypatch.setattr(ProximityEngine, "_SPARSE_TRAIN_CUTOVER", 10)
    ctx = EnsembleContext.from_forest(f)
    asg = get_assignment("gap", ctx)
    a = ProximityEngine(ctx, asg, forest=f)
    b = ProximityEngine(ctx, asg, forest=f, memory_budget_bytes=1 << 16)
    assert b._budget_block(4096) < len(X)
    _same(a.squared_row_sums(class_ids=y, n_classes=3),
          b.squared_row_sums(class_ids=y, n_classes=3))
    for u, v in zip(a.topk(7), b.topk(7)):
        _same(u, v)


def test_engine_memory_bytes_budget_fields(fitted):
    f, _, _ = fitted
    ctx = EnsembleContext.from_forest(f)
    asg = get_assignment("gap", ctx)
    plain = ProximityEngine(ctx, asg, forest=f).memory_bytes()
    assert "budget" not in plain
    tight = ProximityEngine(ctx, asg, forest=f,
                            memory_budget_bytes=1).memory_bytes()
    assert tight["budget"] == 1 and tight["within_budget"] is False
    roomy = ProximityEngine(ctx, asg, forest=f,
                            memory_budget_bytes=1 << 30).memory_bytes()
    assert roomy["within_budget"] is True
    from repro_torch.obs.metrics import global_registry
    expo = global_registry().exposition()
    assert "engine_memory_bytes" in expo
    assert "engine_memory_budget_bytes" in expo


def test_factor_views_keep_the_budget(tmp_path):
    """The prefix engine and the compressed engine keep their parent's
    budget and factor scratch directory."""
    X, y = gaussian_classes(400, d=6, n_classes=3, seed=13)
    fk = ForestKernel(n_trees=5, seed=0, device="cpu",
                      scratch_dir=str(tmp_path),
                      memory_budget_bytes=1 << 12).fit(X, y)
    for view in (fk.prefix_engine(3), fk.compress(n_prototypes=2, k=10)):
        assert view.memory_budget_bytes == 1 << 12
        assert view._factor_scratch_dir == str(tmp_path)
        assert view.memory_bytes()["budget"] == 1 << 12
    plain = ForestKernel(n_trees=5, seed=0, device="cpu").fit(X, y)
    _same(fk.prefix_engine(3).predict(y, n_classes=3),
          plain.prefix_engine(3).predict(y, n_classes=3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_forest_kernel_out_of_core_end_to_end(tmp_path, backend):
    """ForestKernel plumbing: scratch_dir + memory_budget_bytes give the
    in-memory kernel: trees, digests, CSR factors and every op's bits."""
    X, y = gaussian_classes(600, d=6, n_classes=3, seed=11)
    kw = dict(n_trees=6, seed=0, kernel_method="gap", device="cpu",
              tree_backend=backend)
    a = ForestKernel(**kw).fit(X, y)
    scratch = tmp_path / "scr"
    b = ForestKernel(scratch_dir=str(scratch), memory_budget_bytes=1 << 12,
                     **kw).fit(X, y)
    assert b._context_row_chunk() == 1024
    _assert_same_trees(a.forest.trees_, b.forest.trees_)
    assert a.ctx.digest() == b.ctx.digest()
    assert factor_digest(a.engine.gl, a.engine.q, a.engine.w) == \
        factor_digest(b.engine.gl, b.engine.q, b.engine.w)
    assert isinstance(b.Q_.data, np.memmap)       # spilled past the budget
    _assert_same_csr(a.Q_, b.Q_)
    _assert_same_csr(a.W_, b.W_)
    Xq = X[:40] + 1e-3
    _same(a.predict(), b.predict())
    _same(a.engine.predict(y, n_classes=3, X=Xq),
          b.engine.predict(y, n_classes=3, X=Xq))
    for u, v in zip(a.topk(5, X=Xq), b.topk(5, X=Xq)):
        _same(u, v)
    _same(a.outlier_scores(), b.outlier_scores())
    assert list(scratch.iterdir()) == []


def test_impute_refits_under_the_budget(tmp_path, monkeypatch):
    """``impute`` hands the out-of-core settings to its refits and gives
    the in-memory imputation's bits."""
    X, y = gaussian_classes(300, d=5, n_classes=3, seed=14)
    Xm = X.copy()
    Xm[np.random.default_rng(0).random(X.shape) < 0.05] = np.nan
    kw = dict(n_trees=4, seed=0, device="cpu")
    seen = []
    real = ens.BaseForest._binned_codes

    def spy(self, X_):
        seen.append(self.xb_scratch)
        return real(self, X_)
    monkeypatch.setattr(ens.BaseForest, "_binned_codes", spy)
    a = ForestKernel(**kw).impute(Xm, y, n_iter=2)
    b = ForestKernel(scratch_dir=str(tmp_path), memory_budget_bytes=1 << 12,
                     **kw).impute(Xm, y, n_iter=2)
    assert str(tmp_path) in seen
    assert b.kernel_.memory_budget_bytes == 1 << 12
    np.testing.assert_array_equal(a.X_imputed_, b.X_imputed_)
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_budgeted_kernel_equals_reference(tmp_path, backend):
    """A budgeted ForestKernel in each package, on the same memmapped
    data: the same trees, codes, digest strings and CSR factors, and ops
    within 1e-8 of the reference's scipy engine."""
    X, y = gaussian_classes(500, d=6, n_classes=3, seed=15)
    Xm = np.memmap(tmp_path / "X.mm", dtype=np.float64, mode="w+",
                   shape=X.shape)
    Xm[:] = X
    budget = 1 << 12
    ref = RefKernel(n_trees=6, seed=0, kernel_method="gap",
                    routing_backend="numpy", tree_backend="numpy",
                    engine_backend="scipy", scratch_dir=str(tmp_path / "r"),
                    memory_budget_bytes=budget).fit(Xm, y)
    port = ForestKernel(n_trees=6, seed=0, kernel_method="gap",
                        device="cpu", tree_backend=backend,
                        scratch_dir=str(tmp_path / "p"),
                        memory_budget_bytes=budget).fit(Xm, y)
    _assert_same_trees(ref.forest.trees_, port.forest.trees_)
    np.testing.assert_array_equal(ref.forest.binner_.transform(X),
                                  port.forest.binner_.transform(X))
    assert port.ctx.digest() == ref.ctx.digest()
    from repro.core.factorization import factor_digest as ref_digest
    assert factor_digest(port.engine.gl, port.engine.q, port.engine.w) == \
        ref_digest(ref.engine.gl, ref.engine.q, ref.engine.w)
    _assert_same_csr(ref.Q_, port.Q_)
    _assert_same_csr(ref.W_, port.W_)
    Xq = X[:30] + 1e-3

    def close(got, want):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-8)
    close(port.engine.predict(y, n_classes=3),
          ref.engine.predict(y, n_classes=3))
    close(port.engine.predict(y, n_classes=3, X=Xq),
          ref.engine.predict(y, n_classes=3, X=Xq))
    V = np.random.default_rng(2).random((len(X), 20))
    close(port.engine.matmat(V), ref.engine.matmat(V))
    close(port.topk(5)[1], ref.topk(5)[1])
    close(port.kernel_block(np.arange(40)), ref.kernel_block(np.arange(40)))
    close(port.engine.squared_row_sums(y, n_classes=3),
          ref.engine.squared_row_sums(y, n_classes=3))
    assert port.engine.memory_bytes()["budget"] == \
        ref.engine.memory_bytes()["budget"]
    assert list((tmp_path / "p").iterdir()) == []


# ---------------------------------------------------------------------------
# snapshot v2 (CSR factors) + v1 migration
# ---------------------------------------------------------------------------

def test_snapshot_v2_roundtrip_stores_csr(tmp_path):
    X, y = gaussian_classes(400, d=6, n_classes=3, seed=12)
    fk = ForestKernel(n_trees=6, seed=0, kernel_method="gap",
                      device="cpu").fit(X, y)
    p = tmp_path / "k.npz"
    manifest = fk.save(p)
    assert manifest["version"] == 2
    with np.load(p) as data:
        assert "factor_q_data" in data.files
        assert "factor_q" not in data.files
    fk2 = ForestKernel.load(p, device="cpu")
    _same(fk2.engine.q, fk.engine.q)
    _same(fk2.engine.w, fk.engine.w)
    _assert_same_csr(fk.Q_, fk2.Q_)


def test_snapshot_v1_dense_archive_accepted(tmp_path):
    """A crafted v1 (dense-factor) archive loads with a one-time note."""
    import repro_torch.core.snapshot as snap

    X, y = gaussian_classes(350, d=6, n_classes=3, seed=13)
    fk = ForestKernel(n_trees=5, seed=0, kernel_method="gap",
                      device="cpu").fit(X, y)
    p2 = tmp_path / "v2.npz"
    fk.save(p2)
    with np.load(p2) as data:
        arrays = {k: data[k] for k in data.files if k != "manifest"}
        manifest = json.loads(bytes(data["manifest"].tobytes()).decode())
    for k in ("factor_q_data", "factor_q_indices", "factor_q_indptr",
              "factor_w_data", "factor_w_indices", "factor_w_indptr"):
        arrays.pop(k, None)
        manifest["checksums"].pop(k, None)
    arrays["factor_q"] = _np(fk.engine.q)
    arrays["factor_w"] = _np(fk.engine.w)
    manifest["version"] = 1
    manifest["checksums"]["factor_q"] = _checksum(arrays["factor_q"])
    manifest["checksums"]["factor_w"] = _checksum(arrays["factor_w"])
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    p1 = tmp_path / "v1.npz"
    np.savez_compressed(p1, **arrays)
    snap._v1_migration_noted = False
    with pytest.warns(UserWarning, match="v1"):
        fk1 = ForestKernel.load(p1, device="cpu")
    _same(fk1.engine.q, fk.engine.q)
    assert ForestKernel.load(p1, device="cpu") is not None   # note once


def test_snapshot_unknown_version_rejected(tmp_path):
    X, y = gaussian_classes(200, d=5, n_classes=2, seed=14)
    fk = ForestKernel(n_trees=4, seed=0, device="cpu").fit(X, y)
    p = tmp_path / "k.npz"
    fk.save(p)
    with np.load(p) as data:
        arrays = {k: data[k] for k in data.files if k != "manifest"}
        manifest = json.loads(bytes(data["manifest"].tobytes()).decode())
    manifest["version"] = 99
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, **arrays)
    with pytest.raises(SnapshotError, match="version"):
        ForestKernel.load(bad, device="cpu")


def test_snapshot_records_out_of_core_settings(tmp_path):
    """``save`` records the kernel's scratch directory and budget, and
    ``load`` builds the engine under them."""
    X, y = gaussian_classes(300, d=5, n_classes=3, seed=16)
    scratch = str(tmp_path / "scr")
    fk = ForestKernel(n_trees=4, seed=0, device="cpu", scratch_dir=scratch,
                      memory_budget_bytes=1 << 12).fit(X, y)
    p = tmp_path / "k.npz"
    manifest = fk.save(p)
    assert manifest["config"]["scratch_dir"] == scratch
    assert manifest["config"]["memory_budget_bytes"] == 1 << 12
    back = ForestKernel.load(p, device="cpu")
    assert back.engine.memory_budget_bytes == 1 << 12
    assert back.engine._factor_scratch_dir == scratch
    _same(back.topk(5)[1], fk.topk(5)[1])
    assert os.listdir(scratch) == []
