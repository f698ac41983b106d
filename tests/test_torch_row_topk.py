"""The row top-k kernel's plain version and its algorithm, on the CPU; the
kernel itself on the card.

The plain version (``kernels/row_topk/ref.py``) is held against the
engine's ``torch.topk`` path (``_topk_rows``, with ``_topk_rows_exact`` for
the rows it flags) and against ``np.lexsort`` on (-value, column), on rows
built to break a tie rule: ties at the k-th place within the 16 spare
candidates and past them, rows with fewer than k nonzeros, all-equal rows,
rows shorter than k, ascending and descending runs.  A numpy replay of the
CUDA source's two stages (the 16-byte split of a row into lists, each
warp's threshold, buffer and bitonic merges, the lists' merge) is held
against the plain version, so the algorithm is tested where the kernel
cannot run.  The tests marked ``cuda`` (skipped without a card) hold the
kernel bit for bit against the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import _topk_rows, _topk_rows_exact
from repro_torch.kernels.row_topk import ops as rt_ops
from repro_torch.kernels.row_topk.ops import (MAX_K, MIN_LIST, lists_per_row,
                                              row_topk)
from repro_torch.kernels.row_topk.ref import row_topk_ref

from _warp_topk import INT_MAX, WarpTopK

KS = [1, 5, 10, 26, 50, 64]
DTYPES = [torch.float64, torch.float32]
SLACK = 16                       # the engine's spare candidates


def _rows(rng, n, k):
    """(name, row) pairs, each a float64 row of ``n`` built to test the
    order at the k-th place."""
    out = []
    v = rng.random(n)
    out.append(("distinct", v))
    kth = np.sort(v)[::-1][min(k, n) - 1]
    w = v.copy()                 # k-th value tied by a few more columns
    pick = rng.choice(np.flatnonzero(v < kth), min(SLACK // 2, n - k),
                      replace=False) if n > k else []
    w[pick] = kth
    out.append(("ties_within", w))
    w = np.where(v < kth, 0.0, v)   # ties past the spare candidates
    below = np.flatnonzero(v < kth)
    w[below[rng.random(below.size) < 0.7]] = kth
    out.append(("ties_spill", w))
    w = np.zeros(n)                 # fewer than k nonzeros
    w[rng.choice(n, max(0, min(k, n) // 2), replace=False)] = \
        rng.random(max(0, min(k, n) // 2)) + 0.5
    out.append(("sparse", w))
    out.append(("all_equal", np.full(n, 0.25)))
    out.append(("ascending", np.linspace(0.0, 1.0, n)))
    out.append(("descending", np.linspace(1.0, 0.0, n)))
    out.append(("few_levels", rng.integers(0, 3, n) / 4.0))
    return out


def _block(rng, n, k, dtype, reps=2):
    rows = [r for _ in range(reps) for _, r in _rows(rng, n, k)]
    return torch.as_tensor(np.stack(rows)).to(dtype)


def _engine_order(B, kk):
    """The engine's ``torch.topk`` path: ``_topk_rows``, and
    ``_topk_rows_exact`` for the rows it flags."""
    idx, val, spill = _topk_rows(B, kk)
    idx, val = idx.clone(), val.to(torch.float64)
    rows = spill.nonzero()[:, 0]
    if rows.numel():
        ix, v = _topk_rows_exact(B[rows], kk)
        idx[rows], val[rows] = ix, v.to(torch.float64)
    return idx, val, int(spill.sum())


def _lexsort(B, kk):
    a = B.numpy()
    cols = np.arange(a.shape[1])
    order = np.stack([np.lexsort((cols, -r))[:kk] for r in a])
    return order, np.take_along_axis(a, order, 1).astype(np.float64)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("k", KS)
def test_plain_version_keeps_the_engine_order(k, dtype):
    """The plain version equals the engine's torch.topk path and a lexsort
    on (-value, column), ties within and past the spare candidates
    included, and rows shorter than k give all their columns."""
    rng = np.random.default_rng(k)
    spilled = 0
    for n in (300, max(1, k // 2)):
        B = _block(rng, n, k, dtype)
        kk = min(k, n)
        idx, val = row_topk(B, k)
        assert idx.dtype == torch.int64 and val.dtype == torch.float64
        assert idx.shape == val.shape == (B.shape[0], kk)
        e_idx, e_val, n_spill = _engine_order(B, kk)
        spilled += n_spill
        assert torch.equal(idx, e_idx)
        assert torch.equal(val, e_val)
        l_idx, l_val = _lexsort(B, kk)
        np.testing.assert_array_equal(idx.numpy(), l_idx)
        np.testing.assert_array_equal(val.numpy(), l_val)
    if k + SLACK < 300:          # the rows do reach the tie rule's redo
        assert spilled > 0


def test_plain_version_writes_into_column_slices():
    """``idx``/``val`` may be column slices of wider outputs, as the
    engine's are; what lies beside them is left alone."""
    rng = np.random.default_rng(3)
    B = _block(rng, 200, 10, torch.float64)
    idx = torch.full((B.shape[0], 12), -7, dtype=torch.int64)
    val = torch.full((B.shape[0], 12), -7.0, dtype=torch.float64)
    row_topk(B, 10, idx=idx[:, :10], val=val[:, :10])
    want_i, want_v = row_topk_ref(B, 10)
    assert torch.equal(idx[:, :10], want_i)
    assert torch.equal(val[:, :10], want_v)
    assert (idx[:, 10:] == -7).all() and (val[:, 10:] == -7.0).all()


def test_wrapper_checks_its_arguments():
    B = torch.zeros((4, 100), dtype=torch.float64)
    with pytest.raises(TypeError):
        row_topk(B.to(torch.int64), 3)
    with pytest.raises(ValueError):
        row_topk(B[0], 3)
    with pytest.raises(ValueError, match="contiguous"):
        row_topk(B, 3, idx=torch.zeros((3, 4), dtype=torch.int64).T[:4])
    with pytest.raises(ValueError):
        row_topk(B, 3, idx=torch.zeros((4, 5), dtype=torch.int64))
    with pytest.raises(TypeError):
        row_topk(B, 3, val=torch.zeros((4, 3), dtype=torch.float32))


def test_wrapper_never_falls_back_off_the_cpu(monkeypatch):
    """A tensor on neither the CPU nor a card raises; the plain version is
    never called for it."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(rt_ops, "row_topk_ref", forbidden)
    B = torch.empty((4, 100), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        row_topk(B, 3)


@pytest.mark.parametrize("rows,n,want", [
    (320, 100_000, 13),          # the engine's block: 13 x 7,693 columns
    (64, 100_000, 48),           # a serving tick: capped at MIN_LIST
    (1, 100_000, 48),
    (333, 100_000, 12),
    (4225, 100_000, 1),          # more rows than warps: one list
    (320, 1_000, 1),             # short rows: one list
    (0, 100_000, 48),
])
def test_lists_per_row(rows, n, want):
    """The first stage's warps fit four blocks of eight on each of 132 SMs
    (one wave), and no list is shorter than MIN_LIST unless it is the
    row's only one."""
    got = lists_per_row(rows, n, 132)
    assert got == want
    assert got == 1 or n // got >= MIN_LIST
    assert got == 1 or -(-rows * got // 8) <= 4 * 132


# ---------------- a replay of the CUDA source's algorithm ----------------

def _replay_row(row, mis, k, lists, unroll=4):
    """Stage 1 over ``lists`` warps and stage 2 for one row whose first
    element lies ``mis`` elements past a 16-byte boundary."""
    dt = row.dtype.type
    vn = 16 // row.itemsize
    n = row.size
    head = min(n, vn - mis if mis else 0)
    nvec = (n - head) // vn
    tail0 = head + nvec * vn
    per = -(-nvec // lists)
    lanes = np.arange(32)
    cand_v, cand_c = [], []
    for li in range(lists):
        v0 = min(nvec, li * per)
        v1 = min(nvec, v0 + per)
        top = WarpTopK(k, dt)
        if li == 0:
            extra = head + (n - tail0)
            c = np.where(lanes < head, lanes, tail0 + lanes - head)
            ok = lanes < extra
            top.push(np.where(ok, row[np.clip(c, 0, n - 1)], 0).astype(dt),
                     c, ok)
        for vb in range(v0, v1, 32 * unroll):
            vis = [vb + u * 32 + lanes for u in range(unroll)]
            oks = [vi < v1 for vi in vis]
            xs = []
            for vi, ok in zip(vis, oks):
                cols = head + np.clip(vi, 0, max(nvec - 1, 0)) * vn
                xs.append([(np.where(ok, row[np.minimum(cols + e, n - 1)],
                                     0).astype(dt), head + vi * vn + e)
                           for e in range(vn)])
            if any((ok & top.passes(v, c)).any() for ok, x in zip(oks, xs)
                   for v, c in x):
                for ok, x in zip(oks, xs):
                    for v, c in x:
                        top.push(v, c, ok)
        top.flush()
        v, c = top.entries()
        cand_v.append(v)
        cand_c.append(c)
    cv, cc = np.concatenate(cand_v), np.concatenate(cand_c)
    top = WarpTopK(k, dt)
    for j0 in range(0, cv.size, 32):
        j = j0 + lanes
        ok = j < cv.size
        top.push(np.where(ok, cv[np.minimum(j, cv.size - 1)], 0).astype(dt),
                 np.where(ok, cc[np.minimum(j, cc.size - 1)], INT_MAX), ok)
    top.flush()
    return top.entries()


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("k,lists", [(1, 3), (10, 1), (10, 7), (33, 2),
                                     (64, 5)])
def test_kernel_algorithm_replay_matches_plain_version(k, lists, dtype):
    """Both stages of row_topk.cu replayed lane by lane give the plain
    version's columns and values on every adversarial row, at every
    16-byte misalignment of the row's start and at ragged lengths."""
    rng = np.random.default_rng(100 + k)
    vn = 16 // np.dtype(dtype).itemsize
    for n in (k, 517, 1031):
        for name, row in _rows(rng, n, k):
            row = row.astype(dtype)
            want_i, want_v = row_topk_ref(torch.as_tensor(row[None]), k)
            for mis in range(vn):
                v, c = _replay_row(row, mis, k, lists)
                assert np.array_equal(c, want_i[0].numpy()), (name, n, mis)
                assert np.array_equal(v.astype(np.float64),
                                      want_v[0].numpy()), (name, n, mis)


# ---------------- on the card ----------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_block(rows, n, k, dtype, dev, seed):
    """Adversarial rows, repeated to ``rows``, as the engine's blocks lie:
    a (rows, n) block on the card."""
    rng = np.random.default_rng(seed)
    base = np.stack([r for _, r in _rows(rng, n, k)])
    reps = -(-rows // base.shape[0])
    return torch.as_tensor(np.tile(base, (reps, 1))[:rows],
                           device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("rows,n", [(1, 100_000), (7, 100_000),
                                    (320, 100_000), (333, 100_000),
                                    (5, 99_999), (9, 4_097), (3, 65)])
@pytest.mark.parametrize("k", [10, 50])
def test_card_kernel_bit_equal_to_plain_version(dev, rows, n, k, dtype):
    B = _card_block(rows, n, k, dtype, dev, seed=rows + n + k)
    before = row_topk.launches
    idx, val = row_topk(B, k)
    torch.cuda.synchronize()
    assert row_topk.launches == before + 1
    want_i, want_v = row_topk_ref(B, k)
    assert torch.equal(idx, want_i)
    assert torch.equal(val, want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("k", KS)
def test_card_kernel_every_k_and_odd_strides(dev, k):
    """Every k of the CPU test; a block whose rows start off 16-byte
    boundaries (a column slice of a wider block) and outputs that are
    column slices of wider ones."""
    for dtype in DTYPES:
        wide = _card_block(40, 3_001, k, dtype, dev, seed=k)
        B = wide[:, 1:2_998]
        idx = torch.full((40, k + 3), -1, dtype=torch.int64, device=dev)
        val = torch.zeros((40, k + 3), dtype=torch.float64, device=dev)
        row_topk(B, k, idx=idx[:, 1:k + 1], val=val[:, 1:k + 1])
        want_i, want_v = row_topk_ref(B, k)
        assert torch.equal(idx[:, 1:k + 1], want_i)
        assert torch.equal(val[:, 1:k + 1], want_v)
        assert (idx[:, 0] == -1).all() and (idx[:, k + 1:] == -1).all()


@pytest.mark.cuda
def test_card_kernel_refuses_k_beyond_its_range(dev):
    B = torch.zeros((2, 200), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="beyond"):
        row_topk(B, MAX_K + 1)
