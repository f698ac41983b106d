"""The proximity applications of the port against the reference's.

The fixture mirrors the reference's ``app_kernel_cache``
(``gaussian_classes(180, d=8, n_classes=3, sep=3.0, seed=5)``, 12 trees,
seed 0): a reference ``ForestKernel`` fitted with the numpy router and
trainer on the scipy engine, saved by its own snapshot writer and carried
across with ``forest_kernel_from_arrays``, for the ``gap``, ``original``
and ``ih`` rules on one forest.  The port runs on the CPU, through its
kernels' plain versions.

Tolerances: raw outlier scores 1e-10 (relative and absolute, as the
reference's own test), normalized ones and every other float 1e-8;
labels, prototype ids, predictions and margins exactly.

The reference orders tied proximities in ``topk`` as ``argpartition``
leaves them; the port orders them by column (so that the card and the host
agree).  On this fixture many rows tie at the k-th place, so the prototype
tests hand both greedy covers the reference's neighbourhoods, and the
port's own top-k is held to its tie rule separately.
"""
import json

import numpy as np
import pytest
import torch

from repro.applications import embed as r_embed
from repro.applications import imputation as r_imp
from repro.applications import prototypes as r_proto
from repro.core.api import ForestKernel as RefKernel
from repro.core.engine import prediction_margin as ref_margin
from repro.data.synthetic import gaussian_classes
from repro_torch.applications import embed as p_embed
from repro_torch.applications import imputation as p_imp
from repro_torch.applications import outliers as p_out
from repro_torch.applications import propagate as p_prop
from repro_torch.applications import prototypes as p_proto
from repro_torch.core import engine as p_engine
from repro_torch.core import factorization as p_fact
from repro_torch.core.convert import forest_kernel_from_arrays
from repro_torch.core.weights import InstanceHardness
from repro_torch.kernels.row_topk.ops import row_topk

ATOL = 1e-8
N_CLASSES = 3


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    X, y = gaussian_classes(180, d=8, n_classes=N_CLASSES, sep=3.0, seed=5)
    d = tmp_path_factory.mktemp("apps")
    out, shared = {}, None
    for m in ("gap", "original", "ih"):
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
    return X[:25] + 1e-3


# ------------------------------------------------------------------ outliers
@pytest.mark.parametrize("method", ["gap", "original"])
def test_outlier_scores_match_reference(kernels, method):
    ref, port = kernels[method]
    raw = port.outlier_scores(normalize=False)
    assert isinstance(raw, torch.Tensor)
    np.testing.assert_allclose(_np(raw), ref.outlier_scores(normalize=False),
                               rtol=1e-10, atol=1e-10)
    _close(port.outlier_scores(), ref.outlier_scores())
    # small row blocks give the same scores
    _close(port.outlier_scores(block=16), ref.outlier_scores())


@pytest.mark.parametrize("given_classes", [False, True])
def test_oos_outlier_scores_match_reference(kernels, given_classes):
    from repro.applications.outliers import oos_outlier_scores as ref_oos
    ref, port = kernels["gap"]
    Xq = _oos(kernels)
    yq = kernels["_data"][1][:25] if given_classes else None
    for normalize in (True, False):
        s, c = p_out.oos_outlier_scores(port.engine, port.ctx.y, Xq,
                                        y_query=yq, normalize=normalize,
                                        return_classes=True)
        rs, rc = ref_oos(ref.engine, ref.ctx.y, Xq, y_query=yq,
                         normalize=normalize, return_classes=True)
        np.testing.assert_array_equal(_np(c), rc)
        np.testing.assert_allclose(_np(s), rs, rtol=1e-10, atol=ATOL)
    _close(port.oos_outlier_scores(Xq), ref.oos_outlier_scores(Xq))


def test_train_outlier_stats_are_cached_on_the_engine(kernels):
    _, port = kernels["gap"]
    eng = port.engine
    a = p_out.train_outlier_stats(eng, port.ctx.y)
    assert p_out.train_outlier_stats(eng, port.ctx.y) is a
    raw = port.outlier_scores(normalize=False)
    y = port.ctx.y
    for c in range(N_CLASSES):
        r = _np(raw)[y == c]
        assert float(a["median"][c]) == np.median(r)
        assert float(a["mad"][c]) == np.median(np.abs(r - np.median(r)))


def test_median_is_numpys_on_even_counts():
    x = torch.tensor([4.0, 1.0, 3.0, 10.0])
    assert float(p_out._median(x)) == np.median(_np(x)) == 3.5
    assert float(p_out._median(x[:3])) == np.median(_np(x)[:3])


# ---------------------------------------------------------------- prototypes
def _boundary_ties(val, k):
    """Rows whose k-th and (k+1)-th proximities are equal and positive."""
    return int(((val[:, k - 1] == val[:, k]) & (val[:, k] > 0)).sum())


def test_fixture_ties_at_the_kth_place(kernels):
    """Why the prototype tests share neighbourhoods: tied proximities
    straddle the k-th place in many rows of this fixture, and the
    reference leaves their order to ``argpartition``."""
    ref, _ = kernels["gap"]
    _, val = ref.engine.topk(41)
    assert _boundary_ties(val, 40) > 0


class _Neighbourhoods:
    """An engine whose ``topk`` serves a fixed (indices, values) table."""

    def __init__(self, idx, val, as_tensors):
        self.idx, self.val, self.as_tensors = idx, val, as_tensors

    def topk(self, k):
        idx, val = self.idx[:, :k], self.val[:, :k]
        if self.as_tensors:
            return torch.as_tensor(idx), torch.as_tensor(val)
        return idx, val


@pytest.mark.parametrize("n_prototypes,k", [(3, 40), (4, 30), (2, 30),
                                            (10, 50)])
def test_prototype_ids_match_reference(kernels, n_prototypes, k):
    """The greedy cover picks the reference's ids from the same
    neighbourhoods."""
    ref, port = kernels["gap"]
    y = ref.ctx.y
    idx, val = ref.engine.topk(k)
    a, ca = r_proto.select_prototypes(_Neighbourhoods(idx, val, False), y,
                                      n_prototypes=n_prototypes, k=k)
    b, cb = p_proto.select_prototypes(_Neighbourhoods(idx, val, True), y,
                                      n_prototypes=n_prototypes, k=k)
    assert sorted(a) == sorted(b)
    for c in a:
        np.testing.assert_array_equal(b[c], a[c])
        assert cb[c] == ca[c]


@pytest.mark.parametrize("n_prototypes,k", [(3, 40), (4, 30)])
def test_prototypes_from_the_ports_topk(kernels, n_prototypes, k):
    """On the port's own top-k the cover is the reference's algorithm on
    the port's neighbourhoods, and each class keeps its members."""
    ref, port = kernels["gap"]
    y = ref.ctx.y
    idx, val = (_np(t) for t in port.engine.topk(k))
    want, _ = r_proto.select_prototypes(_Neighbourhoods(idx, val, False), y,
                                        n_prototypes=n_prototypes, k=k)
    got, cov = port.prototypes(n_prototypes=n_prototypes, k=k)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
        assert (y[got[c]] == c).all() and 0 < cov[c] <= 1


@pytest.mark.parametrize("side", ["train", "oos"])
def test_topk_ties_break_by_column(kernels, side):
    """Values descending, equal values by ascending column, on the dense
    block path and on the host CSR path; values match the reference."""
    ref, port = kernels["gap"]
    X = None if side == "train" else _oos(kernels)
    k = 12
    eng = port.engine
    P = _np(eng.kernel_block(None, X_rows=X)) if X is not None else \
        _np(eng.kernel_block(np.arange(eng.n_ref)))
    order = np.lexsort((np.broadcast_to(np.arange(P.shape[1]), P.shape), -P),
                       axis=1)[:, :k]
    idx, val = eng.topk(k, X=X)
    np.testing.assert_array_equal(_np(idx), order)
    np.testing.assert_array_equal(_np(val), np.take_along_axis(P, order, 1))
    _close(val, ref.engine.topk(k, X=X)[1])
    qs = eng.query_state(X)
    cidx, cval = p_fact.topk_neighbors(qs.Q, eng.W, k)
    np.testing.assert_array_equal(cidx, order)
    _close(cval, val)


@pytest.mark.parametrize("k", [1, 5, 12, 40, 100])
def test_topk_rule_on_ties_of_every_length(kernels, k):
    """Rows whose ties at the k-th place reach a few columns past it and
    rows where most columns tie there give the lexicographic (value
    descending, column ascending) order, through ``row_topk`` and through
    a CPU engine's ``topk`` selecting the block in row blocks (k = 100
    past ``row_topk``'s MAX_K: the plain version, as on the card)."""
    rng = np.random.default_rng(k)
    P = rng.integers(0, 4, (60, 100)) * (rng.random((60, 100)) < 0.5) * 1.0
    want = np.lexsort((np.broadcast_to(np.arange(100), P.shape), -P),
                      axis=1)[:, :k]
    B = torch.as_tensor(P)
    eng = kernels["gap"][1].engine
    assert eng.n_ref >= P.shape[1]
    eng.query_state = lambda X=None: p_engine.QueryState(
        eng.gl[:60], eng.q[:60], eng.total_leaves)
    eng._dense_blocks = lambda qs, block: (
        (i0, min(i0 + 32, 60), B[i0:i0 + 32]) for i0 in range(0, 60, 32))
    try:
        got = (row_topk(B, k), eng.topk(k))
    finally:
        del eng.query_state, eng._dense_blocks
    for ix, v in got:
        np.testing.assert_array_equal(_np(ix), want)
        np.testing.assert_array_equal(_np(v), np.take_along_axis(P, want, 1))


def test_nearest_prototype_classifier_matches_reference(kernels):
    ref, port = kernels["gap"]
    y = ref.ctx.y
    idx, val = ref.engine.topk(40)
    rc = r_proto.NearestPrototypeClassifier(n_prototypes=3, k=40).fit(
        _Neighbourhoods(idx, val, False), y)
    pc = p_proto.NearestPrototypeClassifier(n_prototypes=3, k=40).fit(
        _Neighbourhoods(idx, val, True), y)
    np.testing.assert_array_equal(pc.prototype_indices_,
                                  rc.prototype_indices_)
    rc.engine_, pc.engine_ = ref.engine, port.engine
    Xq = _oos(kernels)
    for X in (None, Xq):
        _close(pc.decision_function(X, block=64),
               rc.decision_function(X, block=64))
        np.testing.assert_array_equal(_np(pc.predict(X)), rc.predict(X))
    assert (_np(pc.predict()) == y).mean() > 0.85


def _compressed(kernels):
    ref, port = kernels["gap"]
    rce = ref.compress(n_prototypes=3, k=40)
    pce = p_proto.CompressedProximityEngine(
        port.engine, rce.prototype_indices_, labels=rce.prototype_labels_,
        coverage=rce.coverage_)
    return rce, pce


@pytest.mark.parametrize("side", ["train", "oos"])
def test_compressed_engine_ops_match_reference(kernels, side):
    rce, pce = _compressed(kernels)
    X = None if side == "train" else _oos(kernels)
    lab = rce.prototype_labels_
    _close(pce.predict(lab, N_CLASSES, X=X), rce.predict(lab, N_CLASSES, X=X))
    _close(pce.row_sums(X=X), rce.row_sums(X=X))
    _close(pce.kernel_block(None, X_rows=X), rce.kernel_block(None, X_rows=X))
    _close(pce.topk(5, X=X)[1], rce.topk(5, X=X)[1])
    _close(pce.squared_row_sums(lab, N_CLASSES, X=X),
           rce.squared_row_sums(lab, N_CLASSES, X=X))
    V = np.random.default_rng(1).normal(size=(len(lab), 2))
    _close(pce.matmat(V, X=X, normalized=True),
           rce.matmat(V, X=X, normalized=True))
    mem, rmem = pce.memory_bytes(), rce.memory_bytes()
    assert mem["Q"] == rmem["Q"] and mem["W"] == rmem["W"]
    assert mem["dense_factors"] < kernels["gap"][1].engine.memory_bytes()[
        "dense_factors"]


def test_compress_surface(kernels):
    _, port = kernels["gap"]
    ce = port.compress(n_prototypes=3, k=40)
    assert isinstance(ce, p_proto.CompressedProximityEngine)
    assert ce.n_ref == len(ce.prototype_indices_) == len(ce.prototype_labels_)
    protos, _ = port.prototypes(n_prototypes=3, k=40)
    np.testing.assert_array_equal(
        ce.prototype_indices_, np.concatenate([protos[c] for c in
                                               sorted(protos)]))


def test_views_keep_their_own_index_and_share_routed_states(kernels):
    """A compressed view shares its parent's OOS cache together with its
    lock and has leaf-index state of its own; the prefix tier contracts
    the parent's routed (cached) states and has its own index too."""
    _, port = kernels["gap"]
    parent = port.engine
    parent.leaf_index()
    ce = p_proto.CompressedProximityEngine(parent, np.arange(0, 180, 9))
    assert ce._oos_cache is parent._oos_cache
    assert ce._qs_lock is parent._qs_lock
    assert ce._leaf_index is None and ce._leaf_density is None
    assert ce._index_lock is not parent._index_lock
    assert ce.leaf_index().n_ref == ce.n_ref != parent.n_ref
    assert ce._ref_cache is not parent._ref_cache
    assert ce._app_cache is not parent._app_cache
    pe = port.prefix_engine(2)
    assert pe._leaf_index is None and pe._index_lock is not parent._index_lock
    assert pe._oos_cache is not parent._oos_cache
    Xq = _oos(kernels) * 1.5
    misses = parent.qs_cache_misses
    pe.query_state(Xq)
    assert parent.qs_cache_misses == misses + 1      # routed once, by parent
    ce.query_state(Xq)
    assert parent.query_state(Xq) is ce.query_state(Xq)


# ----------------------------------------------------------------- propagate
@pytest.mark.parametrize("method", ["gap", "original"])
def test_propagate_matches_reference(kernels, method):
    ref, port = kernels[method]
    y = ref.ctx.y
    labeled = np.random.default_rng(7).random(len(y)) < 0.15
    la, sa = ref.propagate_labels(labeled, n_iter=30)
    lb, sb = port.propagate_labels(labeled, n_iter=30)
    np.testing.assert_array_equal(_np(lb), la)
    _close(sb, sa)


def test_online_propagation_matches_reference(kernels):
    ref, port = kernels["gap"]
    y = ref.ctx.y
    labeled = np.random.default_rng(8).random(len(y)) < 0.1
    ra = ref.propagate_labels(labeled, n_iter=3, online=True)
    pa = port.propagate_labels(labeled, n_iter=3, online=True)
    assert pa.converged_ == ra.converged_
    Xq = _oos(kernels)
    for _ in range(2):
        la, sa = ra.partial_fit(Xq)
        lb, sb = pa.partial_fit(Xq)
        np.testing.assert_array_equal(_np(lb), la)
        _close(sb, sa)
    assert pa.refine_steps_ == ra.refine_steps_
    np.testing.assert_array_equal(_np(pa.labels_), ra.labels_)
    _close(pa.scores_, ra.scores_)


# --------------------------------------------------------------------- embed
def _sign_aligned(a, b):
    """``a`` with each column's sign flipped to agree with ``b``'s."""
    a, b = _np(a), _np(b)
    j = np.abs(b).argmax(axis=0)
    s = np.sign(a[j, np.arange(a.shape[1])] * b[j, np.arange(b.shape[1])])
    return a * s[None, :]


@pytest.mark.parametrize("method,how", [("original", "eigs"),
                                        ("gap", "eigs"),
                                        ("original", "leafpca"),
                                        ("gap", "leafpca")])
def test_embedding_matches_reference(kernels, method, how):
    ref, port = kernels[method]
    ea = r_embed.ProximityEmbedding(n_components=3, method=how).fit(
        ref.engine)
    eb = p_embed.ProximityEmbedding(n_components=3, method=how).fit(
        port.engine)
    np.testing.assert_allclose(eb.eigvals_, ea.eigvals_, rtol=1e-8, atol=0)
    _close(_sign_aligned(eb.embedding_, ea.embedding_), ea.embedding_)
    Xq = _oos(kernels)
    got = eb.transform(Xq)
    assert isinstance(got, torch.Tensor)
    want = ea.transform(Xq)
    # the columns' signs are fixed by the training coordinates
    s = np.sign(np.sum(_sign_aligned(eb.embedding_, ea.embedding_) *
                       eb.embedding_, axis=0))
    _close(_np(got) * s[None, :], want)
    _close(eb.transform(), ea.embedding_ * s[None, :])


def test_embed_surface_and_nystrom_basis_is_cached(kernels):
    _, port = kernels["original"]
    emb = port.embed(n_components=2)
    Xq = _oos(kernels)
    eng = port.engine
    a = emb.transform(Xq)
    n = len(eng._ref_cache)
    b = emb.transform(Xq)
    assert len(eng._ref_cache) == n and torch.equal(a, b)
    X, _ = kernels["_data"]
    _close(emb.transform(X[:30]), emb.embedding_[:30])


# ---------------------------------------------------------------- imputation
def _knockout(X, frac, seed):
    rng = np.random.default_rng(seed)
    Xm = X.copy()
    Xm[rng.random(X.shape) < frac] = np.nan
    return Xm


@pytest.mark.parametrize("categorical", [False, True])
def test_imputation_matches_reference(kernels, categorical):
    X, y = kernels["_data"]
    if categorical:
        X = np.concatenate([X, y[:, None].astype(np.float64)], axis=1)
    Xm = _knockout(X, 0.1, seed=3)
    cat = (X.shape[1] - 1,) if categorical else ()
    kw = dict(kernel_method="gap", n_trees=10, seed=0)
    a = r_imp.ProximityImputer(n_iter=2, categorical=cat, kernel_kwargs=dict(
        kw, routing_backend="numpy", tree_backend="numpy",
        engine_backend="scipy"))
    b = p_imp.ProximityImputer(n_iter=2, categorical=cat,
                               kernel_kwargs=dict(kw, device="cpu"))
    xa, xb = a.fit_transform(Xm, y), b.fit_transform(Xm, y)
    _close(xb, xa)
    np.testing.assert_array_equal(xb[~np.isnan(Xm)], X[~np.isnan(Xm)])
    np.testing.assert_array_equal(b.missing_mask_, a.missing_mask_)
    assert len(b.history_) == len(a.history_)
    _close(b.history_, a.history_)


def test_impute_surface_refits_with_the_callers_config(kernels):
    from repro_torch.core.api import ForestKernel
    X, y = kernels["_data"]
    Xm = _knockout(X, 0.08, seed=6)
    imp = ForestKernel(kernel_method="gap", n_trees=8, seed=0,
                       device="cpu").impute(Xm, y, n_iter=1)
    assert np.isfinite(imp.X_imputed_).all()
    assert imp.kernel_.n_trees == 8 and imp.kernel_.device == "cpu"


# ------------------------------------------------------------------------ ih
def test_ih_reference_weights_equal(kernels):
    """Every ``ih`` weight equals the reference's; the fixture has no
    near-tie between the k-th and the next nearest reference row, where
    sums in another order could pick another neighbour."""
    ref, port = kernels["ih"]
    ctx = ref.ctx
    rng = np.random.default_rng(0)
    refs = rng.choice(ctx.n_train, min(2048, ctx.n_train), replace=False)
    for t, feats in enumerate(ctx.tree_features):
        if len(feats) == 0:
            continue
        A, B = ctx.X[:, feats], ctx.X[refs][:, feats]
        d2 = np.sort(((A[:, None, :] - B[None]) ** 2).sum(-1), axis=1)
        gap = d2[:, 5] - d2[:, 4]
        assert (gap > 1e-9 * d2[:, 5]).all(), f"near-tie in tree {t}"
    np.testing.assert_array_equal(_np(port.engine.w), ref.engine.w)
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    for t, f in enumerate(ref.ctx.tree_features):
        np.testing.assert_array_equal(port.ctx.tree_features[t], f)


def test_ih_expansion_form_matches_broadcast_form(kernels):
    """Past the reference's size threshold the distances take the
    expansion form, in row chunks; the picked neighbours are the same."""
    _, port = kernels["ih"]
    want = _np(port.engine.w)
    for broadcast_max in (5e7, 0):
        ih = InstanceHardness(port.ctx)
        ih._BROADCAST_MAX = broadcast_max
        ih._CHUNK_BYTES = 8 * 180 * 8 * 7          # several row chunks
        got = ih.reference_weights(port.ctx.leaves)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("side", ["train", "oos"])
def test_ih_engine_ops_match_reference(kernels, side):
    ref, port = kernels["ih"]
    X = None if side == "train" else _oos(kernels)
    y = ref.ctx.y
    _close(port.engine.predict(y, N_CLASSES, X=X),
           ref.engine.predict(y, N_CLASSES, X=X))
    _close(port.topk(6, X=X)[1] if X is not None else port.topk(6)[1],
           ref.engine.topk(6, X=X)[1])
    _close(port.row_sums(X), ref.row_sums(X))
    np.testing.assert_array_equal(_np(port.predict(X)), ref.predict(X))


# ------------------------------------------------------ margins, ref tables
def test_prediction_margin_equal(kernels):
    ref, port = kernels["gap"]
    y = ref.ctx.y
    for X in (None, _oos(kernels)):
        s = ref.engine.predict(y, N_CLASSES, X=X)
        np.testing.assert_array_equal(
            _np(p_engine.prediction_margin(torch.as_tensor(s))),
            ref_margin(s))
    np.testing.assert_array_equal(
        _np(p_engine.prediction_margin(torch.ones((4, 1)))), np.full(4,
                                                                     np.inf))


def test_predict_hits_the_reference_table_on_the_second_call(kernels):
    _, port = kernels["gap"]
    eng = port.engine
    eng._ref_cache.clear()
    eng._ref_cache_bytes = 0
    eng._label_cache.clear()
    y = port.ctx.y
    Xq = _oos(kernels)
    a = eng.predict(y, N_CLASSES, X=Xq)
    assert len(eng._ref_cache) == 1
    (key, (_, S)), = eng._ref_cache.items()
    calls = []
    real = p_engine.torch_ops.swlc_bucket
    try:
        p_engine.torch_ops.swlc_bucket = lambda *a, **k: calls.append(1) \
            or real(*a, **k)
        b = eng.predict(y, N_CLASSES, X=Xq)
        c = eng.predict(y, N_CLASSES, X=Xq[:5])
    finally:
        p_engine.torch_ops.swlc_bucket = real
    assert not calls and eng._ref_cache[key][1] is S
    assert torch.equal(a, b) and torch.equal(c, a[:5])
    # the same labels in a new array share the content key
    eng.predict(y.copy(), N_CLASSES, X=Xq)
    assert len(eng._ref_cache) == 1


def test_wide_and_masked_products_bypass_the_reference_tables(kernels):
    _, port = kernels["gap"]
    eng = port.engine
    eng._ref_cache.clear()
    eng._ref_cache_bytes = 0
    rng = np.random.default_rng(2)
    eng.matmat(rng.normal(size=(eng.n_ref, 33)))
    eng.matmat(rng.normal(size=(eng.n_ref, 2)),
               col_mask=rng.random(eng.n_ref) < 0.5)
    assert len(eng._ref_cache) == 0 and eng._ref_cache_bytes == 0
    V = rng.normal(size=(eng.n_ref, 32))
    eng.matmat(V)
    assert eng._ref_cache[("id", id(V))][0] is V        # kept alive


def test_reference_tables_are_bounded_in_bytes_and_entries(kernels):
    _, port = kernels["gap"]
    eng = port.engine
    eng._ref_cache.clear()
    eng._ref_cache_bytes = 0
    table = eng.total_leaves * 8 * 4
    budget = eng._ref_cache_byte_budget
    try:
        eng._ref_cache_byte_budget = 3 * table
        Vs = [np.random.default_rng(i).normal(size=(eng.n_ref, 4))
              for i in range(5)]
        for V in Vs:
            eng.matmat(V)
        assert len(eng._ref_cache) == 3
        assert eng._ref_cache_bytes == 3 * table
        assert ("id", id(Vs[0])) not in eng._ref_cache
        assert ("id", id(Vs[-1])) in eng._ref_cache
        eng._ref_cache_byte_budget = budget
        for i in range(20):
            eng.matmat(np.ones((eng.n_ref, 1)) * i)
        assert len(eng._ref_cache) == eng._ref_cache_size
    finally:
        eng._ref_cache_byte_budget = budget


def test_reference_tables_do_not_change_results(kernels):
    ref, port = kernels["gap"]
    eng = port.engine
    V = np.random.default_rng(4).normal(size=(eng.n_ref, 3))
    Xq = _oos(kernels)
    first = [eng.matmat(V), eng.matmat(V, X=Xq), eng.row_sums(Xq)]
    again = [eng.matmat(V), eng.matmat(V, X=Xq), eng.row_sums(Xq)]
    eng._ref_cache.clear()
    eng._ref_cache_bytes = 0
    fresh = [eng.matmat(V.copy()), eng.matmat(V.copy(), X=Xq),
             eng.row_sums(Xq)]
    for a, b, c in zip(first, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    _close(first[1], ref.engine.matmat(V, X=Xq))


# ------------------------------------------------- acceptance: no dense P ---
BLOCK = 64


def test_applications_never_densify_P(kernels, monkeypatch):
    """Every workload with ``full_kernel`` forbidden and the dense-block
    and matmat shapes instrumented: P is never materialized beyond a
    ≤BLOCK-row streaming chunk, and no product is wider than 32 columns."""
    X, y = kernels["_data"]
    shapes = {"block_rows": 0, "matmat_cols": 0}
    Eng = p_engine.ProximityEngine

    def forbidden(*a, **k):
        raise AssertionError("dense/full P materialized")

    orig_block, orig_matmat = Eng._block, Eng.matmat

    def spy_block(self, gl_q, q, cols=None):
        shapes["block_rows"] = max(shapes["block_rows"], gl_q.shape[0])
        return orig_block(self, gl_q, q, cols)

    def spy_matmat(self, V, X=None, col_mask=None, normalized=False):
        shapes["matmat_cols"] = max(shapes["matmat_cols"], V.shape[1])
        return orig_matmat(self, V, X=X, col_mask=col_mask,
                           normalized=normalized)

    monkeypatch.setattr(Eng, "full_kernel", forbidden)
    monkeypatch.setattr(p_fact, "full_kernel", forbidden)
    monkeypatch.setattr(Eng, "_block", spy_block)
    monkeypatch.setattr(Eng, "matmat", spy_matmat)

    _, port = kernels["gap"]
    eng = port.engine
    p_out.outlier_scores(eng, y, block=BLOCK)
    p_prop.propagate_labels(eng, y, y >= 0, n_iter=5)
    clf = p_proto.NearestPrototypeClassifier(n_prototypes=2, k=20)
    monkeypatch.setattr(eng, "topk", lambda k: Eng.topk(eng, k, block=BLOCK))
    clf.fit(eng, y)
    clf.predict(block=BLOCK)
    clf.predict(X[:10] + 1e-3, block=BLOCK)
    emb = p_embed.ProximityEmbedding(n_components=2).fit(eng)
    emb.transform(X[:10] + 1e-3)
    p_imp.ProximityImputer(n_iter=1, kernel_kwargs=dict(
        kernel_method="gap", n_trees=6, seed=0, device="cpu")).fit_transform(
            _knockout(X, 0.05, seed=9), y)
    assert 0 < shapes["block_rows"] <= BLOCK, shapes
    assert 0 < shapes["matmat_cols"] <= 32, shapes
