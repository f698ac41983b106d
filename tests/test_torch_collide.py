"""Train-side all-pairs ops over leaf collisions (``core/collide.py``).

The collision path against the dense-block path of the same engine (the
plain block kernel adds a pair's products in the collision path's order,
so on the CPU the answers are equal bit for bit) and against the
benchmark's plain reference (``perfbench/reference/prox.py`` with
``methods/gap.py``, loaded by path): top-k columns exactly, values and
squared sums within 1e-12 of each row's largest; rows with fewer than k
nonzeros, all-zero rows and ties; the same bits at every block height and
under a budget; the rule (``ProximityEngine.collision_mode``) on a deep
RF-GAP forest and on a booster; the spans and counters; the collision-pair
kernel's warp walk (``kernels/collide/csrc/collide.cu``) replayed in numpy
against its plain version, on forests' products and on products built to
break it.  A CPU engine keeps its own paths, so the
tests send train-side calls down the collision path by patching
``_train_path``; the marked tests hold the kernel on the card to its
plain version bit for bit and the card's collision path to its K2 blocks.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import collide
from repro_torch.core import engine as eng_mod
from repro_torch.core.api import ForestKernel
from repro_torch.core.engine import ProximityEngine
from repro_torch.data.synthetic import friedman1, gaussian_classes
from repro_torch.kernels.block_prox.ops import (build_leaf_index,
                                                leaf_members)
from repro_torch.kernels.collide import ops as pair_ops
from repro_torch.kernels.block_prox.ref import block_prox_ref
from repro_torch.obs import MetricsRegistry, global_registry, set_regions
from repro_torch.obs.metrics import set_global_registry

from _warp_topk import INT_MAX, WarpTopK

REF = Path(__file__).resolve().parents[1] / "perfbench" / "reference"
TOL = 1e-12
TOL_F32 = 1e-5


def _load(path: Path):
    """A reference file as a module, as ``pb/common.py::load_module``
    loads the harness's files."""
    spec = importlib.util.spec_from_file_location(
        f"ref_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


prox = _load(REF / "prox.py")
gap = _load(REF / "methods" / "gap.py")

# (rows, trees, min_samples_leaf, factor dtype): deep RF-GAP forests with
# small leaves
FORESTS = {
    "rf_leaf3": (1500, 15, 3, np.float64),
    "rf_leaf1": (900, 40, 1, np.float64),
    "rf_two_trees": (600, 2, 1, np.float64),
    "rf_leaf3_f32": (1500, 15, 3, np.float32),
}


def _rf(name, **kw):
    n, T, leaf, dtype = FORESTS[name]
    X, y = gaussian_classes(n, d=10, n_classes=5, sep=0.8, seed=3)
    fk = ForestKernel(kernel_method="gap", n_trees=T, max_depth=32,
                      min_samples_leaf=leaf, seed=0, dtype=dtype,
                      device="cpu", **kw).fit(X, y)
    return fk, y


def _booster():
    X, y = friedman1(1200, d=8, seed=2)
    fk = ForestKernel(model_type="gbt", task="regression",
                      kernel_method="boosted", n_trees=20, max_depth=6,
                      seed=0, device="cpu").fit(X, y)
    return fk, (np.arange(1200) % 3)


@pytest.fixture(scope="module")
def forests():
    return {name: _rf(name) for name in FORESTS}


# Between the small forests' collision shares (at most ~0.14) and the
# booster's (~0.7): the rule's side of each, whatever the measured constant
SMALL_SHARE_MAX = 0.3


@pytest.fixture
def collide_on_cpu(monkeypatch):
    """Train-side calls of an engine in collision mode take the path, with
    the threshold at ``SMALL_SHARE_MAX``."""
    monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", SMALL_SHARE_MAX)
    def train_path(self, X, k=None):
        return "collide" if X is None and self.collision_mode() and (
            k is None or min(k, self.n_ref) <= pair_ops.MAX_K) else "dense"
    monkeypatch.setattr(ProximityEngine, "_train_path", train_path)


@pytest.fixture
def fresh_global():
    old = set_global_registry(MetricsRegistry())
    try:
        yield global_registry()
    finally:
        set_global_registry(old)


@pytest.fixture
def regions_off():
    old = set_regions(False)
    try:
        yield
    finally:
        set_regions(old)


def _gap(eng, y):
    """(engine answers on the collision path, on dense blocks)."""
    C = int(y.max()) + 1
    args = eng._collide_args()
    got = (*collide.topk(*args, 10),
           collide.squared_row_sums(*args, torch.as_tensor(y), C),
           collide.squared_row_sums(*args))
    want = (*eng.topk(k=10), eng.squared_row_sums(class_ids=y, n_classes=C),
            eng.squared_row_sums())
    return got, want


def _row_rel(a, b):
    """Largest gap of ``a`` from ``b`` over each row's largest |b|."""
    a, b = a.double(), b.double()
    if b.dim() == 1:
        a, b = a[:, None], b[:, None]
    s = b.abs().max(dim=1).values.clamp_min(1e-300)
    return float(((a - b).abs() / s[:, None]).max())


@pytest.mark.parametrize("name", list(FORESTS))
def test_collision_path_equals_dense_blocks(forests, name):
    fk, y = forests[name]
    eng = fk.engine
    assert eng._train_path(None) == "dense"  # a CPU engine keeps its paths
    (idx, val, sq, s), (idx0, val0, sq0, s0) = _gap(eng, y)
    assert idx.dtype == torch.int64 and val.dtype == torch.float64
    assert sq.dtype == s.dtype == eng._torch_dtype
    assert sq.shape == sq0.shape and s.shape == s0.shape
    assert torch.equal(idx, idx0)
    assert _row_rel(val, val0) <= TOL
    # the sums add in another order than the dense GEMM: float32 rounds a
    # sum of a row's ~60 squares to ~1e-6 of its largest
    tol = TOL if eng.dtype == np.float64 else TOL_F32
    assert _row_rel(sq, sq0) <= tol and _row_rel(s, s0) <= tol


@pytest.mark.parametrize("name", ["rf_leaf3", "rf_leaf1", "rf_two_trees"])
def test_collision_path_against_the_plain_reference(forests, name):
    """q and w from ``methods/gap.py`` on the engine's leaves and in-bag
    counts, P whole from ``prox.Reference``: the top-k (values descending,
    ties by ascending column) and the class-bucketed squared sums."""
    fk, y = forests[name]
    eng = fk.engine
    st = {"total_leaves": eng.total_leaves, "inbag": fk.forest.inbag_}
    q, w = gap.train_factors(torch, st, eng.gl, y)
    P = prox.Reference(torch, eng.gl, w, eng.total_leaves).rows(eng.gl, q)
    ri, rv = prox.topk(torch, P, 10)
    Y = prox.onehot(torch, y, 5, torch.float64, "cpu")
    (idx, val, sq, s), _ = _gap(eng, y)
    at = P.gather(1, idx)
    want = P.gather(1, ri)
    wrong = (idx != ri) & ((at - want).abs() / want[:, :1].clamp_min(1e-300)
                           > TOL)
    assert int(wrong.sum()) == 0
    assert _row_rel(val, rv) <= TOL
    assert _row_rel(sq, prox.class_sq_sums(P, Y)) <= TOL
    assert _row_rel(s, (P * P).sum(dim=1)) <= TOL


def _index_case():
    """Hand-made factors, 3 trees over 12 reference columns: row 0 meets
    no column (q all zero); row 1 two columns of equal value; row 2 three
    (one leaf, equal values); rows 3 and 4 four columns each, some met in
    two trees, with ties between columns met once and twice."""
    gl_w = torch.tensor([[0, 4, 8], [0, 4, 8], [1, 5, 9], [1, 5, 9],
                         [1, 6, 10], [2, 6, 10], [2, 7, 11], [3, 7, 11],
                         [3, 7, 11], [3, 5, 9], [2, 6, 8], [0, 4, 10]],
                        dtype=torch.int32)
    w = torch.tensor([[.5, .3, .2], [.5, .3, .2], [.25, .5, .25],
                      [.25, .25, .25], [.25, .25, .25], [.5, .25, .25],
                      [.5, .25, .25], [1 / 3, .25, 1 / 3],
                      [1 / 3, .25, 1 / 3], [1 / 3, .25, .25], [0., .25, .5],
                      [0., .4, .25]], dtype=torch.float64)
    gl_q = torch.tensor([[0, 4, 8], [0, 5, 9], [3, 6, 8], [1, 5, 10],
                         [2, 6, 10]], dtype=torch.int32)
    q = torch.tensor([[0., 0., 0.], [1., 0., 0.], [1., 0., 0.],
                      [.5, .5, 0.], [.5, 0., .5]], dtype=torch.float64)
    return gl_q, q, gl_w, w


@pytest.mark.parametrize("k", [1, 3, 10, 12, 15])
@pytest.mark.parametrize("cap", [1, 1 << 20])
def test_short_zero_and_tied_rows(k, cap):
    """Rows with fewer than k nonzeros are filled with value 0 at the
    smallest columns they do not hold; an all-zero row reads columns
    0..k-1; ties go by ascending column; ranks past the reference count
    read column 0, value 0 — the dense path's answer."""
    gl_q, q, gl_w, w = _index_case()
    ix = build_leaf_index(gl_w, w, 12)
    members = leaf_members(gl_w, w, 12)
    per = collide.row_products(members, gl_q, q).numpy()
    assert list(per) == [0, 2, 3, 6, 5]
    cum = np.concatenate([[0], np.cumsum(per)])
    blocks = collide.row_blocks(cum, cap)
    assert len(blocks) == (5 if cap == 1 else 1)
    idx, val = collide.topk(ix, gl_q, q, cum, blocks, 3, k)
    P = block_prox_ref(gl_q, q, gl_w, w)
    kk = min(k, 12)
    ri, rv = prox.topk(torch, P, kk)
    assert torch.equal(idx[:, :kk], ri) and torch.equal(val[:, :kk], rv)
    assert not idx[:, kk:].any() and not val[:, kk:].any()
    assert idx[0, :kk].tolist() == list(range(kk))
    Y = prox.onehot(torch, np.arange(12) % 4, 4, torch.float64, "cpu")
    sq = collide.squared_row_sums(ix, gl_q, q, cum, blocks, 3,
                                  torch.arange(12) % 4, 4)
    assert torch.allclose(sq, prox.class_sq_sums(P, Y), rtol=0, atol=1e-15)


def test_row_blocks_hold_the_cap():
    cum = np.concatenate([[0], np.cumsum([5, 0, 7, 1, 100, 2, 2])])
    cap = 8 * collide.PRODUCT_BYTES + 2 * collide.ROW_BYTES
    blocks = collide.row_blocks(cum, cap)
    assert blocks[0][0] == 0 and blocks[-1][1] == 7
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for i0, i1 in blocks:
        cost = (cum[i1] - cum[i0]) * collide.PRODUCT_BYTES + \
            (i1 - i0) * collide.ROW_BYTES
        assert cost <= cap or i1 == i0 + 1


@pytest.mark.parametrize("block_bytes", [1 << 30, 1 << 18, 1 << 14])
def test_same_bits_at_every_block_height_and_budget(
        collide_on_cpu, monkeypatch, tmp_path, forests, block_bytes):
    """The engine's collision path in one block, in many, and under a 32
    MiB budget with a scratch directory: the same bits."""
    fk, y = forests["rf_leaf3"]
    want = (*fk.topk(k=10), fk.engine.squared_row_sums(y, 5),
            fk.engine.squared_row_sums())
    monkeypatch.setattr(eng_mod, "_COLLIDE_BYTES", block_bytes)
    bk, _ = _rf("rf_leaf3", scratch_dir=str(tmp_path),
                memory_budget_bytes=32 << 20)
    for e in (fk.engine, bk.engine):
        got = (*e.topk(k=10), e.squared_row_sums(y, 5),
               e.squared_row_sums())
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        n_blocks = len(e._collide_blocks[1])
        assert (n_blocks > 1) == (block_bytes < 1 << 30)


@pytest.mark.parametrize("name", list(FORESTS) + ["booster"])
def test_rule_picks_the_path(forests, monkeypatch, name):
    """The share is the products a training row enumerates over the
    reference columns; the rule compares it with ``COLLIDE_SHARE_MAX``. A
    booster's depth-6 stages meet most columns: the dense path, at the
    measured threshold too."""
    fk, _ = _booster() if name == "booster" else forests[name]
    eng = fk.engine
    share = eng.collision_share()
    per_row = collide.row_products(
        leaf_members(eng.gl, eng.w, eng.total_leaves), eng.gl,
        eng.q)
    assert eng._collide_cum[-1] == int(per_row.sum())
    assert share == pytest.approx(float(per_row.double().mean())
                                  / eng.n_ref, rel=1e-12)
    assert (share <= SMALL_SHARE_MAX) is (name != "booster")
    if name == "booster":
        assert share > 0.5 and not eng.collision_mode()
    for limit in (share * 0.99, share):
        monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", limit)
        assert eng.collision_mode() is (limit >= share)


def test_booster_stays_on_dense_blocks(fresh_global, collide_on_cpu):
    """With the path open, a booster's train-side top-k still selects from
    dense blocks."""
    fk, _ = _booster()
    fk.topk(k=10)
    snap = fresh_global.snapshot()
    assert snap["engine_topk_rows_total"]["series"][""] == fk.engine.n_ref
    assert "engine_collide_rows_total" not in snap


def test_counters_and_spans(fresh_global, regions_off, collide_on_cpu,
                            forests, monkeypatch):
    """Rows served and products enumerated once a call; the dense top-k
    counter untouched; ``engine.collide`` in every block of both ops,
    ``engine.collide_select`` under ``engine.topk`` and
    ``engine.collide_sums`` under ``engine.squared_row_sums``; the answers
    keep their bits with the regions on."""
    fk, y = forests["rf_leaf3"]
    eng = fk.engine
    monkeypatch.setattr(eng_mod, "_COLLIDE_BYTES", 1 << 18)
    off = (*eng.topk(k=10), eng.squared_row_sums(y, 5))
    n_blocks = len(eng._collide_blocks[1])
    set_regions(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = (*eng.topk(k=10), eng.squared_row_sums(y, 5))
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    ranges = [(e.name()[6:], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro:")]
    names = [r[0] for r in ranges]
    assert names.count("engine.collide") == 2 * n_blocks
    assert names.count("engine.collide_select") == n_blocks
    assert names.count("engine.collide_sums") == n_blocks
    assert {"engine.k2", "engine.select", "engine.class_sums"}.isdisjoint(
        names)
    outer = {r[0]: r for r in ranges
             if r[0] in ("engine.topk", "engine.squared_row_sums")}
    for name, parent in (("engine.collide_select", "engine.topk"),
                         ("engine.collide_sums", "engine.squared_row_sums")):
        p = outer[parent]
        assert all(p[1] <= r[1] and r[2] <= p[2] for r in ranges
                   if r[0] == name)
    snap = fresh_global.snapshot()
    n, total = eng.n_ref, int(eng._collide_cum[-1])
    assert snap["engine_collide_rows_total"]["series"][""] == 4 * n
    assert snap["engine_collisions_total"]["series"][""] == 4 * total
    assert "engine_topk_rows_total" not in snap


def _kernel_replay(key, prod, n_ref, rows, depth, k, classes=((None, 1),)):
    """The CUDA source's warp walk in numpy (``csrc/collide.cu``), lane by
    lane: a slice of a row's products 32 a chunk, lane 0 comparing with the
    entry before the chunk; each run's head adding the run forward,
    unfused, across chunks.  Top-k: a row of at most ``split_products``
    products in one warp (``WarpTopK``: threshold, buffer, bitonic merges;
    the fill of a row holding fewer than k pairs by ballot), a longer row's
    slices (its first ``split``, then the segments ``[g split, (g + 1)
    split)`` past them) each in its own, their lists merged as stage 2
    does.  Class sums: a lane a class, the pairs in column order, for each
    ``(class_of, C)`` of ``classes`` (a split row's slices write their
    pairs in column order and one warp adds them: the same adds, so one
    walk of the row replays both).  Returns (idx, val, [sums (rows, C),
    ...])."""
    key, prod = key.numpy(), prod.numpy()
    dt, n = prod.dtype.type, key.size
    lanes = np.arange(32)
    split = pair_ops.split_products(depth)
    idx = np.zeros((rows, k), np.int64)
    val = np.zeros((rows, k))
    sums = [np.zeros((rows, C), dt) for _, C in classes]
    cls = [np.zeros(n_ref, np.int64) if c is None else c.numpy()
           for c, _ in classes]

    def at(p, hi):
        ok = p < hi
        p = np.minimum(p, n - 1)
        return np.where(ok, key[p], -1), np.where(ok, prod[p], 0).astype(dt)

    def walk(s0, s1, lo, hi, base):
        """(head, col, v) a chunk, for the pairs headed in [s0, s1)."""
        prev = key[s0 - 1] if s0 > lo else -1
        for p0 in range(s0, s1, 32):
            kc, vc = at(p0 + lanes, hi)
            head = (kc >= 0) & (kc != np.concatenate([[prev], kc[:-1]])) \
                & (p0 + lanes < s1)
            v, more, d = vc.copy(), head.copy(), 1
            while more.any():
                kq, vq = at(p0 + lanes + d, hi)
                more &= kq == kc
                v = np.where(more, v + vq, v)
                d += 1
            yield head, np.where(head, kc - base, 0), v
            prev = kc[31]

    def listed(s0, s1, lo, hi, base):
        top, held = WarpTopK(k, dt), 0
        for head, col, v in walk(s0, s1, lo, hi, base):
            held += int(head.sum())
            top.push(v, col, head)
        top.flush()
        return top, held

    for r in range(rows):
        base = r * n_ref
        lo, hi = np.searchsorted(key, [base, base + n_ref])
        if hi - lo <= split:
            top, held = listed(lo, hi, lo, hi, base)
            tv, tc = top.entries()
            m = min(held, k)
            held_cols = set(tc[:m].tolist())
            fill = [c for c in range(k) if c not in held_cols][:k - m]
            idx[r] = np.concatenate([tc[:m], fill])
            val[r, :m] = tv[:m]
        else:
            slices = [(lo, lo + split)] + [
                (max(g * split, lo + split), min((g + 1) * split, hi))
                for g in range(lo // split + 1, (hi - 1) // split + 1)]
            merged = WarpTopK(k, dt)
            for s0, s1 in slices:
                tv, tc = listed(s0, s1, lo, hi, base)[0].entries()
                for j0 in range(0, -(-k // 32) * 32, 32):
                    j = j0 + lanes
                    ok = j < k
                    jj = np.minimum(j, k - 1)
                    merged.push(np.where(ok, tv[jj], 0).astype(dt),
                                np.where(ok, tc[jj], INT_MAX), ok)
            merged.flush()
            tv, tc = merged.entries()
            idx[r], val[r] = tc, tv
        for head, col, v in walk(lo, hi, lo, hi, base):
            sq = v * v
            for c, out in zip(cls, sums):
                for j in np.flatnonzero(head):      # lanes: column order
                    out[r, c[col[j]]] = dt(out[r, c[col[j]]] + sq[j])
    return idx, val, sums


@pytest.mark.parametrize("name", list(FORESTS))
@pytest.mark.parametrize("k", [1, 10, 50])
def test_kernel_walk_gives_the_plain_version(forests, name, k):
    """The kernel's warp walk (replayed in numpy) against the plain version
    on a forest's sorted products: top-k bit for bit, the sums too,
    unbucketed and by the forest's 5 classes (the plain version adds them
    in column order on the CPU)."""
    fk, y = forests[name]
    eng = fk.engine
    index, gl, q, cum, blocks, depth = eng._collide_args()
    rows = min(eng.n_ref, 300)
    from repro_torch.core.collide import _collide
    key, prod = _collide(index, gl[:rows], q[:rows], int(cum[rows]))
    cls = torch.as_tensor(y, dtype=torch.int64)
    _against_the_plain_version(key, prod, eng.n_ref, rows, depth,
                               min(k, eng.n_ref), ((None, 1), (cls, 5)))


def _against_the_plain_version(key, prod, n_ref, rows, depth, k, classes):
    idx = torch.zeros((rows, k), dtype=torch.int64)
    val = torch.zeros((rows, k), dtype=torch.float64)
    pair_ops.pair_topk(key, prod, n_ref, rows, depth, idx, val)
    ri, rv, rs = _kernel_replay(key, prod, n_ref, rows, depth, k, classes)
    assert np.array_equal(idx.numpy(), ri)
    assert np.array_equal(val.numpy(), rv)
    for (c, C), want in zip(classes, rs):
        out = torch.zeros(rows * C, dtype=prod.dtype)
        pair_ops.pair_sums(key, prod, n_ref, rows, depth, c, C, out)
        assert np.array_equal(out.numpy().reshape(rows, C), want)


def _synthetic(long_row, dtype, seed=5):
    """One row block's sorted products, built against the warp walk: (key,
    prod, n_ref, rows, depth).  Row 0 holds none; row 1 three pairs (fewer
    than k); row 2 runs that cross 32-entry chunks, one in 70 trees (past
    the next chunk too) and one in 33; row 3 ``long_row`` products (past
    ``split_products(70)`` = 4,480, the kernel's top-k splits it); row 4
    pairs of two values made to tie, at the k-th place too; row 5 random
    pairs."""
    rng = np.random.default_rng(seed)
    n_ref = max(4096, 2 * long_row)

    def random_row(n_products, levels=None):
        runs = []
        while sum(runs) < n_products:
            runs.append(int(rng.integers(1, 6)))
        cols = np.sort(rng.choice(n_ref, len(runs), replace=False))
        if levels is None:
            vals = [rng.random(m) + 1e-3 for m in runs]
        else:
            vals = [rng.choice(levels, m) for m in runs]
        return list(zip(cols.tolist(), vals))

    crossing = [1] * 30 + [5] + [1] * 20 + [70] + [1] * 9 + [33] + [2] * 40
    rows = [
        [],
        [(2, rng.random(2)), (7, rng.random(1)), (11, rng.random(3))],
        [(3 * j, rng.random(m)) for j, m in enumerate(crossing)],
        random_row(long_row),
        random_row(600, levels=np.array([0.25, 0.5])),
        random_row(1500),
    ]
    key = np.concatenate([[r * n_ref + c] * len(v) for r, pairs in
                          enumerate(rows) for c, v in pairs])
    prod = np.concatenate([v for pairs in rows for _, v in pairs])
    return (torch.as_tensor(key, dtype=torch.int64),
            torch.as_tensor(prod.astype(dtype)), n_ref, len(rows), 70)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("C", [1, 5, 40])
@pytest.mark.parametrize("k", [1, 10, 50, 64])
def test_kernel_walk_on_synthetic_products(dtype, C, k):
    """The warp walk against the plain version on built products: a row
    of none, one of fewer than k pairs, runs across chunk boundaries (one
    past the next chunk), a row of more than 32 x 64 products (its top-k
    split over two warps and merged), ties at the k-th value; top-k and
    the sums by C classes (one: unbucketed; 40: two classes a lane) bit
    for bit."""
    key, prod, n_ref, rows, depth = _synthetic(5000, dtype)
    cls = None if C == 1 else torch.as_tensor(
        np.random.default_rng(C).integers(0, C, n_ref))
    _against_the_plain_version(key, prod, n_ref, rows, depth, k,
                               ((cls, C),))


def test_pair_wrappers_check_their_inputs():
    key = torch.arange(6, dtype=torch.int64)
    prod = torch.ones(6, dtype=torch.float64)
    idx = torch.zeros((2, 3), dtype=torch.int64)
    val = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(TypeError):
        pair_ops.pair_topk(key.int(), prod, 3, 2, 1, idx, val)
    with pytest.raises(TypeError):
        pair_ops.pair_topk(key, prod.half(), 3, 2, 1, idx, val)
    with pytest.raises(ValueError):
        pair_ops.pair_topk(key, prod, 2, 2, 1, idx, val)   # k beyond n_ref
    with pytest.raises(ValueError):
        pair_ops.pair_sums(key, prod, 3, 2, 1, None, 1,
                           torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        pair_ops.pair_sums(key, prod, 3, 2, 1, None, 1,
                           torch.zeros(2, dtype=torch.float32))


def test_pair_wrappers_never_take_the_plain_version_off_the_cpu(
        monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the kernel (CUDA) or raises."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(pair_ops, "pair_topk_ref", forbidden)
    monkeypatch.setattr(pair_ops, "pair_sums_ref", forbidden)
    meta = torch.device("meta")
    key = torch.empty(6, dtype=torch.int64, device=meta)
    prod = torch.empty(6, dtype=torch.float64, device=meta)
    with pytest.raises(ValueError, match="cuda"):
        pair_ops.pair_topk(key, prod, 3, 2, 1,
                           torch.empty((2, 3), dtype=torch.int64,
                                       device=meta),
                           torch.empty((2, 3), dtype=torch.float64,
                                       device=meta))
    with pytest.raises(ValueError, match="cuda"):
        pair_ops.pair_sums(key, prod, 3, 2, 1, None, 1,
                           torch.empty(2, dtype=torch.float64, device=meta))


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["forest", "synthetic"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_card_kernel_equals_the_plain_version(dtype, block):
    """The kernel on the card against its plain version on the CPU, on one
    block of sorted products: top-k and the class sums bit for bit (both
    add in tree order, then column order, unfused), one launch each.  A
    forest's block at k = 10, 50 and 5 classes; the synthetic block
    (``_synthetic``, its long row 100,000 products) at k = 1, 64 and 40
    classes, and unbucketed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if block == "forest":
        fk, y = _rf("rf_leaf3_f32" if dtype == np.float32 else "rf_leaf3")
        eng = fk.engine
        index, gl, q, cum, blocks, depth = eng._collide_args()
        from repro_torch.core.collide import _collide
        n_ref = rows = eng.n_ref
        key, prod = _collide(index, gl, q, int(cum[rows]))
        ks, classes = (10, 50), ((torch.as_tensor(y, dtype=torch.int64), 5),)
    else:
        key, prod, n_ref, rows, depth = _synthetic(100_000, dtype)
        cls = torch.as_tensor(np.random.default_rng(40).integers(0, 40,
                                                                 n_ref))
        ks, classes = (1, 64), ((cls, 40), (None, 1))
    dev = torch.device("cuda", 0)
    for k in ks:
        want = (torch.zeros((rows, k), dtype=torch.int64),
                torch.zeros((rows, k), dtype=torch.float64))
        pair_ops.pair_topk(key, prod, n_ref, rows, depth, *want)
        got = tuple(t.to(dev) for t in (torch.zeros_like(want[0]),
                                        torch.zeros_like(want[1])))
        n0 = pair_ops.pair_topk.launches
        pair_ops.pair_topk(key.to(dev), prod.to(dev), n_ref, rows,
                           depth, *got)
        torch.cuda.synchronize()
        assert pair_ops.pair_topk.launches == n0 + 1
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
    for cls, C in classes:
        want = torch.zeros(rows * C, dtype=prod.dtype)
        pair_ops.pair_sums(key, prod, n_ref, rows, depth, cls, C, want)
        got = torch.full((rows * C,), 7.0, dtype=prod.dtype, device=dev)
        pair_ops.pair_sums(key.to(dev), prod.to(dev), n_ref, rows, depth,
                           None if cls is None else cls.to(dev), C, got)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_card_collision_path_against_k2_blocks(monkeypatch, dtype):
    """On the card: the engine's collision path against its K2 blocks
    (each pair's adds fused into fmas there: values within 1e-12 of the
    row's largest, columns equal where the values differ by more), and
    the same bits at another block height."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", SMALL_SHARE_MAX)
    X, y = gaussian_classes(20_000, d=10, n_classes=5, sep=0.8, seed=3)
    fk = ForestKernel(kernel_method="gap", n_trees=15, max_depth=32,
                      min_samples_leaf=3, seed=0, dtype=dtype,
                      device="cuda").fit(X, y)
    eng = fk.engine
    assert eng.collision_mode() and eng._train_path(None) == "collide"
    tol = TOL if dtype == np.float64 else TOL_F32
    got = (*eng.topk(k=10), eng.squared_row_sums(y, 5))
    B = eng.kernel_block()
    ri, rv = prox.topk(torch, B, 10)
    Y = prox.onehot(torch, y, 5, B.dtype, B.device)
    assert _row_rel(got[1], rv) <= tol
    at, want = B.gather(1, got[0]), B.gather(1, ri)
    wrong = (got[0] != ri) & ((at - want).abs().double()
                              / want[:, :1].double().clamp_min(1e-300) > tol)
    assert int(wrong.sum()) == 0
    assert _row_rel(got[2], prox.class_sq_sums(B, Y)) <= tol
    monkeypatch.setattr(eng_mod, "_COLLIDE_BYTES", 1 << 20)
    again = (*eng.topk(k=10), eng.squared_row_sums(y, 5))
    assert len(eng._collide_blocks[1]) > 1
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_split_rows_keep_their_bits_and_are_counted(monkeypatch,
                                                        fresh_global):
    """On the card, with ``SPLIT`` at 0 (rows past 64 times the depth
    split) and at a size no row reaches: the engine's collision path gives
    the same bits (top-k and class sums), and
    ``engine_collide_split_rows_total`` counts the rows past the threshold,
    from ``cum``, once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", SMALL_SHARE_MAX)
    X, y = gaussian_classes(20_000, d=10, n_classes=5, sep=0.8, seed=3)
    fk = ForestKernel(kernel_method="gap", n_trees=15, max_depth=32,
                      min_samples_leaf=3, seed=0, device="cuda").fit(X, y)
    eng = fk.engine
    assert eng._train_path(None) == "collide"
    answers = []
    for split in (1 << 40, 0):
        monkeypatch.setattr(pair_ops, "SPLIT", split)
        before = fresh_global.snapshot().get(
            "engine_collide_split_rows_total", {"series": {"": 0}})
        answers.append((*eng.topk(k=10), eng.squared_row_sums(y, 5)))
        after = fresh_global.snapshot()["engine_collide_split_rows_total"]
        per = np.diff(eng._collide_cum)
        want = int((per > pair_ops.split_products(eng._collide_depth)).sum())
        assert after["series"][""] - before["series"][""] == 2 * want
    assert want > 0
    for a, b in zip(*answers):
        assert torch.equal(a, b)
