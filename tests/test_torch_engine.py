"""Every engine op of the port against the reference's scipy engine.

A reference ``ForestKernel(engine_backend="scipy")`` is fitted once, saved
with its own snapshot writer, and carried across with
``forest_kernel_from_arrays`` from the ``np.load`` dict of that snapshot.
Each op × {train, OOS} × kernel method then agrees at atol 1e-8, the
reference's own cross-backend contract (the port runs here on the CPU,
through its kernels' plain versions).
"""
import json

import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.data.synthetic import gaussian_classes, train_test_split
from repro_torch.core.convert import forest_kernel_from_arrays
from repro_torch.core.factorization import (kernel_matvec_operator,
                                            naive_swlc)

METHODS = ("original", "kerf", "oob", "gap")
ATOL = 1e-8
N_CLASSES = 3


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    """{method: (reference kernel, port kernel)} on one shared forest, plus
    the train / OOS data."""
    X, y = gaussian_classes(1000, d=8, n_classes=N_CLASSES, seed=21)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.2, seed=2)
    out, shared = {}, None
    d = tmp_path_factory.mktemp("snap")
    for m in METHODS:
        ref = RefKernel(kernel_method=m, n_trees=12, seed=0,
                        engine_backend="scipy")
        if shared is None:
            ref.fit(Xtr, ytr)
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
    out["_data"] = (Xtr, ytr, Xte, yte)
    return out


def _op_matmat(ref, port, X, ytr):
    rng = np.random.default_rng(0)
    n = ref.engine.W.shape[0]
    V = rng.normal(size=(n, 3))
    mask = rng.random(n) < 0.5
    v = rng.normal(size=n)
    for kw in ({}, {"col_mask": mask}, {"normalized": True},
               {"col_mask": mask, "normalized": True}):
        _close(port.engine.matmat(V, X=X, **kw), ref.engine.matmat(V, X=X, **kw))
        _close(port.engine.matvec(v, X=X, **kw), ref.engine.matvec(v, X=X, **kw))


def _op_row_sums(ref, port, X, ytr):
    _close(port.row_sums(X), ref.row_sums(X))


def _op_predict(ref, port, X, ytr):
    choices = [None, False] if X is None else [None]
    for ex in choices:
        _close(port.engine.predict(ytr, N_CLASSES, X=X, exclude_self=ex),
               ref.engine.predict(ytr, N_CLASSES, X=X, exclude_self=ex))
    _close(port.engine.predict(ytr.astype(np.float64), X=X),
           ref.engine.predict(ytr.astype(np.float64), X=X))
    np.testing.assert_array_equal(_np(port.predict(X)), ref.predict(X))


def _op_kernel_block(ref, port, X, ytr):
    rows = np.arange(0, 200, 3)
    cols = np.arange(5, 700, 2)
    if X is None:
        _close(port.kernel_block(rows, cols), ref.kernel_block(rows, cols))
        _close(port.kernel_block(rows), ref.kernel_block(rows))
    else:
        _close(port.kernel_block(None, cols, X_rows=X),
               ref.kernel_block(None, cols, X_rows=X))
        _close(port.kernel_block(None, X_rows=X),
               ref.kernel_block(None, X_rows=X))


def _op_squared_row_sums(ref, port, X, ytr):
    _close(port.engine.squared_row_sums(ytr, N_CLASSES, X=X),
           ref.engine.squared_row_sums(ytr, N_CLASSES, X=X))
    _close(port.engine.squared_row_sums(X=X),
           ref.engine.squared_row_sums(X=X))


def _op_topk(ref, port, X, ytr):
    """Values agree; every returned index carries its value in P (ties may
    be ordered differently by argpartition and torch.topk)."""
    k = 7
    ri, rv = ref.engine.topk(k, X=X)
    pi, pv = port.engine.topk(k, X=X)
    _close(pv, rv)
    P = (ref.query_map(X) @ ref.W_.T).toarray()
    _close(np.take_along_axis(P, _np(pi), axis=1), pv)
    # a value that occurs once in its row of P names one index: they agree
    rv = _np(rv)
    unique = (np.abs(P[:, None, :] - rv[:, :, None]) <= 1e-12).sum(-1) == 1
    assert unique.any()
    np.testing.assert_array_equal(_np(pi)[unique], ri[unique])


def _op_query_map(ref, port, X, ytr):
    a, b = port.query_map(X), ref.query_map(X)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    _close(a.data, b.data)


OPS = {f.__name__[4:]: f for f in (_op_matmat, _op_row_sums, _op_predict,
                                   _op_kernel_block, _op_squared_row_sums,
                                   _op_topk, _op_query_map)}


@pytest.mark.parametrize("side", ["train", "oos"])
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("method", METHODS)
def test_engine_op_matches_scipy_engine(kernels, method, op, side):
    ref, port = kernels[method]
    Xtr, ytr, Xte, _ = kernels["_data"]
    X = None if side == "train" else Xte
    OPS[op](ref, port, X, ytr)


@pytest.mark.parametrize("method", METHODS)
def test_factors_and_full_kernel_match(kernels, method):
    """Carried-across factors are the reference's bit for bit, and the full
    kernel has the same sparsity pattern and values."""
    ref, port = kernels[method]
    np.testing.assert_array_equal(_np(port.engine.gl),
                                  ref.engine.gl.astype(np.int32))
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    np.testing.assert_array_equal(_np(port.engine.w), ref.engine.w)
    for diag in (True, False):
        a, b = port.kernel(set_diagonal=diag), ref.kernel(set_diagonal=diag)
        a.sort_indices()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        _close(a.data, b.data)


def test_block_against_naive_oracle(kernels):
    """kernel_block against the O(N² T) definition itself."""
    ref, port = kernels["gap"]
    eng = port.engine
    rows = np.arange(40)
    want = naive_swlc(_np(eng.gl)[rows], _np(eng.gl), _np(eng.q)[rows],
                      _np(eng.w))
    _close(port.kernel_block(rows), want)


def test_operator_and_memory(kernels):
    ref, port = kernels["gap"]
    v = np.random.default_rng(3).normal(size=ref.engine.W.shape[0])
    op, rop = port.operator(), ref.operator()
    _close(op.matvec(v), rop.matvec(v))
    _close(op.rmatvec(v), rop.rmatvec(v))
    host = kernel_matvec_operator(port.Q_, port.W_)
    _close(host.matvec(v), op.matvec(v))
    mem, rmem = port.memory_bytes(), ref.memory_bytes()
    assert mem["Q"] == rmem["Q"] and mem["W"] == rmem["W"]
    assert port.engine.memory_bytes()["total"] > 0


def test_oos_states_are_cached_and_q_built_lazily(kernels):
    ref, port = kernels["kerf"]
    Xte = kernels["_data"][2]
    eng = port.engine
    qs = eng.query_state(Xte[:50] * 1.01)
    assert qs._Q is None                      # device path needs no CSR
    hits = eng.qs_cache_hits
    assert eng.query_state(Xte[:50] * 1.01) is qs
    assert eng.qs_cache_hits == hits + 1
    assert qs.Q.shape == (50, eng.total_leaves)
