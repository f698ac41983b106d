"""The port's float32 factors against the reference's float32 engine.

The reference's ``ForestKernel(dtype=np.float32)`` rounds the float64 SWLC
weights once to float32 and computes every engine op in float32 (its
Pallas block kernel's own default precision).  A reference kernel at
float32 (numpy router and trainer, scipy engine) on one forest (2,000 x 8,
20 trees, 3 classes) is saved by its own snapshot writer and carried across
with ``forest_kernel_from_arrays``; the port then runs on the CPU, through
its kernels' plain versions, in float32.

- Factors: ``q``, ``w`` and the CSR maps ``Q``/``W`` bit for bit.
- Ops: within ``RTOL`` times the op's largest magnitude, with the
  reference's output dtypes op by op (float32 everywhere but ``topk``'s
  values, which the scipy engine returns in float64).  The two packages sum
  float32 products in other orders (CSR products against tree-ordered
  segment sums and the block kernel's tree chunks), so bits are not
  expected; ``RTOL`` (``_f32_contract.RTOL_F32``, shared with
  ``chip_smoke.py``) is 1e-5, 84 float32 ulps at 2^-23, for sums of at
  most a few hundred terms.
- ``topk``: values within the tolerance; ids equal exactly on every row
  whose order is decided — each of its top k + 1 values more than the
  tolerance above the next (the reference leaves ties to
  ``argpartition``/``argsort``, the port orders them by column); the
  other rows are counted and printed.
- K2's plain version in float32 against ``block_prox_pallas(...,
  interpret=True, dtype=jnp.float32)``: within 1e-5 x max|P| (the Pallas
  kernel adds chunks of 8 trees, the plain version too but in torch's
  reduction order).
- The prefix engine, the applications and the servers at float32, with the
  tolerances of their float64 tests widened to ``RTOL`` of the largest
  magnitude where a float32 sum enters (stated at each test).
- Snapshots in both directions: a float32 archive, factors and digests
  equal.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.applications import embed as r_embed
from repro.applications import imputation as r_imp
from repro.applications.outliers import oos_outlier_scores as ref_oos
from repro.core.api import ForestKernel as RefKernel
from repro.core.factorization import factor_digest as ref_factor_digest
from repro.data.synthetic import gaussian_classes, train_test_split
from repro.kernels.block_prox.block_prox import block_prox_pallas
from repro_torch.applications import embed as p_embed
from repro_torch.applications import imputation as p_imp
from repro_torch.applications import outliers as p_out
from repro_torch.applications import prototypes as p_proto
from repro_torch.core.api import ForestKernel
from repro_torch.core.convert import forest_kernel_from_arrays
from repro_torch.core.factorization import factor_digest
from repro_torch.kernels.block_prox.ops import (block_prox, build_leaf_index,
                                               leaf_plan)

from _f32_contract import RTOL_F32 as RTOL, decided_rows

N_CLASSES = 3
METHODS = ("original", "kerf", "oob", "gap")
REF_KW = dict(routing_backend="numpy", tree_backend="numpy",
              engine_backend="scipy")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close32(got, want):
    """``got`` within RTOL x max|want| of ``want``, in want's dtype."""
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _arrays(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    config = json.loads(bytes(arrays.pop("manifest")).decode())["config"]
    return arrays, config


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """{method: (reference float32 kernel, port float32 kernel)} on one
    forest, plus the train / OOS data."""
    X, y = gaussian_classes(2500, d=8, n_classes=N_CLASSES, seed=21)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.2, seed=2)
    d = tmp_path_factory.mktemp("f32")
    out, shared = {}, None
    for m in METHODS:
        ref = RefKernel(kernel_method=m, n_trees=20, seed=0,
                        dtype=np.float32, **REF_KW)
        if shared is None:
            ref.fit(Xtr, ytr)
            shared = ref.forest
        else:
            ref.forest = shared
            ref.build_kernel_cache()
        path = d / f"{m}.npz"
        ref.save(path)
        arrays, config = _arrays(path)
        assert config["dtype"] == "float32"
        out[m] = (ref, forest_kernel_from_arrays(arrays, config,
                                                 device="cpu"), path)
    out["_data"] = (Xtr, ytr, Xte[:300], yte[:300])
    return out


# ------------------------------------------------------------ K2, plain ---
def _block_inputs(seed, nq, nw, T, n_leaf=5):
    rng = np.random.default_rng(seed)
    gl_q = rng.integers(0, n_leaf, size=(nq, T)).astype(np.int32)
    gl_w = rng.integers(0, n_leaf, size=(nw, T)).astype(np.int32)
    q = (rng.random((nq, T)) * (rng.random((nq, T)) < 0.7)).astype(
        np.float32)
    w = rng.random((nw, T)).astype(np.float32)
    return gl_q, q, gl_w, w


@pytest.mark.parametrize("nq,nw,T", [(300, 517, 13), (37, 260, 8),
                                     (1, 3, 1), (70, 129, 100)])
def test_block_prox_plain_matches_pallas_interpret_f32(nq, nw, T):
    """Ragged rows (not multiples of the Pallas 256 blocks) and trees (not
    multiples of its 8-tree chunk): the plain version in float32 stays
    within 1e-5 x max|P| of the float32 interpret-mode Pallas kernel."""
    gl_q, q, gl_w, w = _block_inputs(nq + nw + T, nq, nw, T)
    got = block_prox(*(torch.as_tensor(a) for a in (gl_q, q, gl_w, w)))
    assert got.dtype == torch.float32 and got.shape == (nq, nw)
    want = np.asarray(block_prox_pallas(
        jnp.asarray(gl_q), jnp.asarray(q), jnp.asarray(gl_w),
        jnp.asarray(w), interpret=True, dtype=jnp.float32))
    assert want.dtype == np.float32
    _close32(got, want)


def test_block_prox_refuses_mixed_and_other_types():
    gl_q, q, gl_w, w = (torch.as_tensor(a) for a in
                        _block_inputs(0, 5, 7, 3))
    with pytest.raises(TypeError, match="w must be torch.float32"):
        block_prox(gl_q, q, gl_w, w.double())
    with pytest.raises(TypeError, match="w must be torch.float64"):
        block_prox(gl_q, q.double(), gl_w, w)
    with pytest.raises(TypeError, match="float64 or torch.float32"):
        block_prox(gl_q, q.half(), gl_w, w.half())
    with pytest.raises(TypeError, match="float64 or torch.float32"):
        build_leaf_index(gl_w, w.half(), 5)


def test_leaf_index_and_plan_follow_the_value_type():
    """The index keeps the factors' float32; a float32 launch plan fits
    twice the columns of a float64 one in the same shared bytes."""
    gl_q, q, gl_w, w = _block_inputs(1, 5, 300, 4)
    off = np.arange(4, dtype=np.int32) * 5
    index = build_leaf_index(torch.as_tensor(gl_w + off), torch.as_tensor(w),
                             20)
    assert index.w.dtype == torch.float32
    assert index.nbytes == (index.offs.numel() + index.col.numel()) * 4 \
        + index.w.numel() * 4
    limit = 227 * 1024
    tile64, smem64 = leaf_plan(100, limit)
    tile32, smem32 = leaf_plan(100, limit, elem=4)
    assert tile32 == 2 * tile64 and smem32 == smem64


# -------------------------------------------------------------- factors ---
@pytest.mark.parametrize("method", METHODS)
def test_factors_bit_for_bit(kernels, method):
    ref, port, _ = kernels[method]
    e, r = port.engine, ref.engine
    assert e.dtype == np.float32 and port.dtype == np.float32
    for got, want in ((e.q, r.q), (e.w, r.w)):
        got = _np(got)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (e.w is e.q) == (r.w is r.q)
    for got, want in ((e.Q, r.Q), (e.W, r.W)):
        assert got.dtype == want.dtype == np.float32
        for part in ("data", "indices", "indptr"):
            a, b = getattr(got, part), getattr(want, part)
            assert a.dtype == b.dtype and np.array_equal(a, b), part


def test_float32_factors_are_the_float64_ones_rounded_once(kernels):
    """A float64 port kernel on the same saved arrays: its factors rounded
    once to float32 are the float32 kernel's, bit for bit."""
    ref, port, path = kernels["gap"]
    arrays, config = _arrays(path)
    p64 = forest_kernel_from_arrays(arrays, dict(config, dtype="float64"),
                                    device="cpu")
    assert p64.engine.q.dtype == torch.float64
    for a, b in ((p64.engine.q, port.engine.q), (p64.engine.w,
                                                 port.engine.w)):
        assert torch.equal(a.to(torch.float32), b)


def test_port_fit_at_float32_equals_reference_fit(kernels):
    """``ForestKernel(dtype=np.float32)`` fitted by the port itself (host
    trainer, CPU) gives the reference's float32 factors."""
    Xtr, ytr, _, _ = kernels["_data"]
    ref, _, _ = kernels["gap"]
    fk = ForestKernel(kernel_method="gap", n_trees=20, seed=0,
                      dtype=np.float32, device="cpu").fit(Xtr, ytr)
    assert fk._config_kwargs()["dtype"] is np.float32
    assert np.array_equal(_np(fk.engine.q).view(np.uint32),
                          ref.engine.q.view(np.uint32))
    assert np.array_equal(_np(fk.engine.w).view(np.uint32),
                          ref.engine.w.view(np.uint32))


def test_engine_refuses_other_dtypes(kernels):
    from repro_torch.core.engine import ProximityEngine
    _, port, _ = kernels["gap"]
    with pytest.raises(ValueError, match="float64 or float32"):
        ProximityEngine(port.ctx, port.assignment, forest=port.forest,
                        dtype=np.float16)


# ------------------------------------------------------------------ ops ---
def _op_matmat(ref, port, X, ytr):
    rng = np.random.default_rng(0)
    n = ref.engine.W.shape[0]
    V = rng.normal(size=(n, 3))
    mask = rng.random(n) < 0.5
    v = rng.normal(size=n)
    for kw in ({}, {"col_mask": mask}, {"normalized": True},
               {"col_mask": mask, "normalized": True}):
        _close32(port.engine.matmat(V, X=X, **kw),
                 ref.engine.matmat(V, X=X, **kw))
        _close32(port.engine.matvec(v, X=X, **kw),
                 ref.engine.matvec(v, X=X, **kw))


def _op_row_sums(ref, port, X, ytr):
    _close32(port.row_sums(X), ref.row_sums(X))


def _op_predict(ref, port, X, ytr):
    choices = [None, False] if X is None else [None]
    for ex in choices:
        _close32(port.engine.predict(ytr, N_CLASSES, X=X, exclude_self=ex),
                 ref.engine.predict(ytr, N_CLASSES, X=X, exclude_self=ex))
    with np.errstate(invalid="ignore"):
        want = ref.engine.predict(ytr.astype(np.float64), X=X)
    got = _np(port.engine.predict(ytr.astype(np.float64), X=X))
    # a row with no proximity mass is 0 / 0 in both (float32 rounds the
    # reference's 1e-300 floor to 0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    _close32(got[ok], want[ok])
    np.testing.assert_array_equal(_np(port.predict(X)), ref.predict(X))


def _op_kernel_block(ref, port, X, ytr):
    rows = np.arange(0, 300, 3)
    cols = np.arange(5, 1500, 2)
    if X is None:
        _close32(port.kernel_block(rows, cols), ref.kernel_block(rows, cols))
        _close32(port.kernel_block(rows), ref.kernel_block(rows))
    else:
        _close32(port.kernel_block(None, cols, X_rows=X),
                 ref.kernel_block(None, cols, X_rows=X))
        _close32(port.kernel_block(None, X_rows=X),
                 ref.kernel_block(None, X_rows=X))


def _op_squared_row_sums(ref, port, X, ytr):
    _close32(port.engine.squared_row_sums(ytr, N_CLASSES, X=X),
             ref.engine.squared_row_sums(ytr, N_CLASSES, X=X))
    _close32(port.engine.squared_row_sums(X=X),
             ref.engine.squared_row_sums(X=X))


def _op_query_map(ref, port, X, ytr):
    got, want = port.query_map(X), ref.query_map(X)
    assert got.dtype == want.dtype == np.float32
    for part in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(got, part), getattr(want, part))


OPS = {"matmat": _op_matmat, "row_sums": _op_row_sums,
       "predict": _op_predict, "kernel_block": _op_kernel_block,
       "squared_row_sums": _op_squared_row_sums,
       "query_map": _op_query_map}


@pytest.mark.parametrize("side", ["train", "oos"])
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("method", METHODS)
def test_engine_op_matches_float32_reference(kernels, method, op, side):
    ref, port, _ = kernels[method]
    _, ytr, Xte, _ = kernels["_data"]
    OPS[op](ref, port, None if side == "train" else Xte, ytr)


@pytest.mark.parametrize("side", ["train", "oos"])
@pytest.mark.parametrize("method", ["gap", "kerf"])
def test_topk_matches_float32_reference(kernels, method, side):
    """(Not ``original``: its proximities are multiples of 1/T, so no row's
    order is decided.)"""
    ref, port, _ = kernels[method]
    _, _, Xte, _ = kernels["_data"]
    X = None if side == "train" else Xte
    k = 7
    ri, rv = ref.engine.topk(k, X=X)
    pi, pv = port.engine.topk(k, X=X)
    assert _np(pi).dtype == ri.dtype == np.int64
    _close32(pv, rv)
    P = np.sort((ref.query_map(X) @ ref.W_.T).toarray(), axis=1)[:, ::-1]
    tol = RTOL * float(P[:, 0].max())
    decided = decided_rows(P, k, tol)
    np.testing.assert_array_equal(_np(pi)[decided], ri[decided])
    print(f"topk {method} {side}: ids compared on {int(decided.sum())} "
          f"rows; {int((~decided).sum())} rows with values within "
          f"{tol:.2e} of the next not compared")
    assert decided.sum() >= 10


def test_operator_and_memory(kernels):
    ref, port, _ = kernels["gap"]
    op = port.operator()
    assert op.dtype == np.float32
    v = np.random.default_rng(3).normal(size=op.shape[0])
    _close32(op.matvec(v), ref.engine.matvec(v))
    got, want = port.engine.memory_bytes(), ref.engine.memory_bytes()
    for comp in ("Q", "W", "leaf_values"):
        assert got[comp] == want[comp], comp
    # gl int32 here (int64 in the reference); q and w at 4 bytes each
    n, T = ref.engine.gl.shape
    assert got["dense_factors"] == n * T * (4 + 4 + 4)


# ------------------------------------------------------ prefix, apps ---
@pytest.mark.parametrize("side", ["train", "oos"])
@pytest.mark.parametrize("depth", [2, 5])
def test_prefix_engine_at_float32(kernels, depth, side):
    """The prefix tier inherits float32: factors bit for bit, ops within
    RTOL (float64 tests: 1e-8)."""
    ref, port, _ = kernels["gap"]
    _, ytr, Xte, _ = kernels["_data"]
    pr, pp = ref.prefix_engine(depth), port.prefix_engine(depth)
    assert pp.dtype == pr.dtype == np.float32
    assert np.array_equal(_np(pp.q), pr.q) and np.array_equal(_np(pp.w),
                                                              pr.w)
    X = None if side == "train" else Xte
    _close32(pp.predict(ytr, N_CLASSES, X=X), pr.predict(ytr, N_CLASSES, X=X))
    _close32(pp.kernel_block(np.arange(40), X_rows=X),
             pr.kernel_block(np.arange(40), X_rows=X))
    _close32(pp.topk(5, X=X)[1], pr.topk(5, X=X)[1])
    _close32(pp.squared_row_sums(X=X), pr.squared_row_sums(X=X))


@pytest.mark.parametrize("method", ["gap", "original"])
def test_outlier_scores_at_float32(kernels, method):
    """Scores are float64 in both (float32 squared sums widened); raw
    scores within RTOL relative (float64 tests: 1e-10), normalized ones
    within RTOL of the largest (float64 tests: 1e-8)."""
    ref, port, _ = kernels[method]
    raw = _np(port.outlier_scores(normalize=False))
    want = ref.outlier_scores(normalize=False)
    assert raw.dtype == want.dtype == np.float64
    np.testing.assert_allclose(raw, want, rtol=RTOL, atol=0)
    _close32(port.outlier_scores(), ref.outlier_scores())


def test_oos_outlier_scores_at_float32(kernels):
    ref, port, _ = kernels["gap"]
    _, _, Xte, yte = kernels["_data"]
    for yq in (None, yte):
        s, c = p_out.oos_outlier_scores(port.engine, port.ctx.y, Xte,
                                        y_query=yq, normalize=False,
                                        return_classes=True)
        rs, rc = ref_oos(ref.engine, ref.ctx.y, Xte, y_query=yq,
                         normalize=False, return_classes=True)
        # the densest class is an argmax of float32 sums: equal where the
        # two best classes are not within RTOL of each other
        np.testing.assert_array_equal(_np(c), rc)
        np.testing.assert_allclose(_np(s), rs, rtol=RTOL, atol=0)


@pytest.mark.parametrize("side", ["train", "oos"])
def test_compressed_engine_at_float32(kernels, side):
    ref, port, _ = kernels["gap"]
    _, _, Xte, _ = kernels["_data"]
    rce = ref.compress(n_prototypes=3, k=40)
    pce = p_proto.CompressedProximityEngine(
        port.engine, rce.prototype_indices_, labels=rce.prototype_labels_)
    assert pce.dtype == rce.dtype == np.float32
    X = None if side == "train" else Xte
    lab = rce.prototype_labels_
    _close32(pce.predict(lab, N_CLASSES, X=X), rce.predict(lab, N_CLASSES,
                                                            X=X))
    _close32(pce.row_sums(X=X), rce.row_sums(X=X))
    _close32(pce.kernel_block(None, X_rows=X), rce.kernel_block(None,
                                                                X_rows=X))
    _close32(pce.topk(5, X=X)[1], rce.topk(5, X=X)[1])
    _close32(pce.squared_row_sums(lab, N_CLASSES, X=X),
             rce.squared_row_sums(lab, N_CLASSES, X=X))


@pytest.mark.parametrize("method", ["gap", "original"])
def test_propagation_at_float32(kernels, method):
    """Scores float64 in both (float64 labels widen the float32 products);
    within RTOL (float64 tests: 1e-8), labels equal."""
    ref, port, _ = kernels[method]
    y = ref.ctx.y
    labeled = np.random.default_rng(7).random(len(y)) < 0.15
    la, sa = ref.propagate_labels(labeled, n_iter=30)
    lb, sb = port.propagate_labels(labeled, n_iter=30)
    np.testing.assert_array_equal(_np(lb), la)
    _close32(sb, sa)
    _, _, Xte, _ = kernels["_data"]
    ra = ref.propagate_labels(labeled, n_iter=3, online=True)
    pa = port.propagate_labels(labeled, n_iter=3, online=True)
    la, sa = ra.partial_fit(Xte)
    lb, sb = pa.partial_fit(Xte)
    np.testing.assert_array_equal(_np(lb), la)
    _close32(sb, sa)


def _sign_aligned(a, b):
    a, b = _np(a), _np(b)
    j = np.abs(b).argmax(axis=0)
    s = np.sign(a[j, np.arange(a.shape[1])] * b[j, np.arange(b.shape[1])])
    return a * s[None, :]


@pytest.mark.parametrize("method,how", [("original", "eigs"),
                                        ("gap", "eigs"),
                                        ("gap", "leafpca")])
def test_embedding_at_float32(kernels, method, how):
    """Eigenvalues within 1e-4 relative and coordinates within 1e-3 of the
    largest (float64 tests: 1e-8): the Lanczos solver runs in float32 on
    the float32 operator in both, and its residual tolerance is float32's,
    so each package stops at its own float32 Ritz vectors."""
    ref, port, _ = kernels[method]
    ea = r_embed.ProximityEmbedding(n_components=3, method=how).fit(
        ref.engine)
    eb = p_embed.ProximityEmbedding(n_components=3, method=how).fit(
        port.engine)
    assert _np(eb.embedding_).dtype == _np(ea.embedding_).dtype
    np.testing.assert_allclose(eb.eigvals_, ea.eigvals_, rtol=1e-4, atol=0)
    got = _sign_aligned(eb.embedding_, ea.embedding_)
    scale = float(np.abs(ea.embedding_).max())
    np.testing.assert_allclose(got, ea.embedding_, rtol=0, atol=1e-3 * scale)


def test_imputation_at_float32(kernels):
    """The imputer refits at the caller's float32; filled values within
    RTOL of the largest (float64 tests: 1e-8)."""
    Xtr, ytr, _, _ = kernels["_data"]
    X, y = Xtr[:400], ytr[:400]
    Xm = X.copy()
    Xm[np.random.default_rng(3).random(X.shape) < 0.1] = np.nan
    kw = dict(kernel_method="gap", n_trees=10, seed=0, dtype=np.float32)
    a = r_imp.ProximityImputer(n_iter=2, kernel_kwargs=dict(kw, **REF_KW))
    b = p_imp.ProximityImputer(n_iter=2, kernel_kwargs=dict(kw, device="cpu"))
    xa, xb = a.fit_transform(Xm, y), b.fit_transform(Xm, y)
    assert b.kernel_.engine.dtype == np.float32
    _close32(xb, xa)
    np.testing.assert_array_equal(xb[~np.isnan(Xm)], X[~np.isnan(Xm)])


def test_server_at_float32_matches_reference_server(kernels):
    """Served answers: predict labels equal, scores and top-k values within
    RTOL of the largest, ids equal on rows whose order is decided."""
    from repro.serve.proximity import ProximityServer as RefServer
    ref, port, _ = kernels["gap"]
    _, ytr, Xte, _ = kernels["_data"]
    Xq = np.ascontiguousarray(Xte[:40])
    k = 5
    reqs = [("predict", Xq[:8]), ("topk", Xq[8:24], k),
            ("outlier", Xq[24:32]), ("predict", Xq[32:40])]
    got = port.serve(n_slots=32).serve(reqs)
    want = RefServer(ref.engine, y=ytr, n_slots=32).serve(reqs)
    for (kind, X, *_), g, w in zip(reqs, got, want):
        if kind == "predict":
            np.testing.assert_array_equal(g["labels"], w["labels"])
            _close32(g["scores"], w["scores"])
        elif kind == "outlier":
            _close32(g["scores"], w["scores"])
        else:
            _close32(g["values"], w["values"])
            P = np.sort((ref.query_map(X) @ ref.W_.T).toarray(),
                        axis=1)[:, ::-1]
            decided = decided_rows(P, k, RTOL * float(P[:, 0].max()))
            np.testing.assert_array_equal(g["indices"][decided],
                                          w["indices"][decided])


# ------------------------------------------------------------ snapshots ---
def test_reference_float32_archive_loads_into_the_port(kernels):
    ref, _, path = kernels["gap"]
    port = ForestKernel.load(path, device="cpu")
    assert port.dtype == np.float32 and port.engine.dtype == np.float32
    for got, want in ((port.engine.q, ref.engine.q),
                      (port.engine.w, ref.engine.w)):
        assert np.array_equal(_np(got).view(np.uint32),
                              want.view(np.uint32))
    assert factor_digest(port.engine.gl, port.engine.q, port.engine.w) == \
        ref_factor_digest(ref.engine.gl, ref.engine.q, ref.engine.w)
    _, ytr, Xte, _ = kernels["_data"]
    _close32(port.engine.predict(ytr, N_CLASSES, X=Xte),
             ref.engine.predict(ytr, N_CLASSES, X=Xte))


def test_port_float32_archive_loads_into_the_reference(kernels, tmp_path):
    """A float32 kernel the port fitted saves with ``dtype="float32"``;
    the reference loads it with the same factors and digests, and it
    loads back into the port bit for bit."""
    Xtr, ytr, Xte, _ = kernels["_data"]
    fk = ForestKernel(kernel_method="gap", n_trees=20, seed=0,
                      dtype=np.float32, device="cpu").fit(Xtr, ytr)
    out = tmp_path / "port32.npz"
    manifest = fk.save(out)
    assert manifest["config"]["dtype"] == "float32"
    back = RefKernel.load(out, engine_backend="scipy")
    assert back.dtype == np.float32 and back.engine.q.dtype == np.float32
    assert np.array_equal(back.engine.q.view(np.uint32),
                          _np(fk.engine.q).view(np.uint32))
    assert np.array_equal(back.engine.w.view(np.uint32),
                          _np(fk.engine.w).view(np.uint32))
    assert ref_factor_digest(back.engine.gl, back.engine.q, back.engine.w) \
        == manifest["factor_digest"]
    again = ForestKernel.load(out, device="cpu")
    assert again.dtype == np.float32
    assert torch.equal(again.engine.q, fk.engine.q)
    assert torch.equal(again.engine.w, fk.engine.w)
    assert torch.equal(again.kernel_block(np.arange(50)),
                       fk.kernel_block(np.arange(50)))
    _close32(fk.engine.predict(ytr, N_CLASSES, X=Xte),
             back.engine.predict(ytr, N_CLASSES, X=Xte))
