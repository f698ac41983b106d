"""The split-histogram wrappers on the CPU, held against the JAX reference.

On a CPU tensor ``histogram``/``moments`` run their plain PyTorch versions;
those are held here against the reference's Pallas kernels
(``histogram_pallas``/``moments_pallas``, run in interpret mode) and its jnp
oracles: exact on integer weights, 1e-6 relative on continuous payloads.
The ordered oracles (``histogram_ordered``/``moments_ordered``), which give
the CUDA kernels' bits on every payload, are held to both on integer
payloads, and the host-bounds layout (``bounds=``) to the node-id one.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``), against the same plain versions.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram.histogram import histogram_pallas, moments_pallas
from repro.kernels.histogram.ref import histogram_ref as jnp_histogram_ref
from repro.kernels.histogram.ref import moments_ref as jnp_moments_ref
from repro_torch.kernels.histogram import ops as h_ops
from repro_torch.kernels.histogram.ops import (histogram, moments,
                                               slice_plan, work_items)
from repro_torch.kernels.histogram.ref import (histogram_ordered,
                                               moments_ordered, moments_ref)

H100_SMEM = 232_448          # a block's opt-in shared memory on the H100


def _inputs(seed, n, n_nodes, d, n_bins, C, integer=True):
    """Codes (int16 past 256 bins, as the Binner emits), node ids with the
    odd ones left empty, labels and weights (integers, zeros included)."""
    rng = np.random.default_rng(seed)
    code_dt = np.uint8 if n_bins <= 256 else np.int16
    xb = rng.integers(0, n_bins, (n, d)).astype(code_dt)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    if n_nodes > 2:
        node[node % 2 == 1] = 0
    y = rng.integers(0, C, n).astype(np.int32)
    if integer:
        w = rng.integers(0, 4, n).astype(np.float32)
    else:
        w = (rng.normal(size=n) * 3).astype(np.float32)
    return xb, node, y, w


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


GRID = [(nn, d, b, c) for nn in (1, 3, 65) for d in (1, 5)
        for b in (2, 16, 300) for c in (2, 3)]


@pytest.mark.parametrize("n_nodes,d,n_bins,C", GRID)
def test_histogram_plain_matches_pallas_and_oracle(n_nodes, d, n_bins, C):
    xb, node, y, w = _inputs(n_nodes * 7 + d + n_bins + C, 600, n_nodes, d,
                             n_bins, C)
    got = histogram(*_t(xb, node, y, w), n_nodes, n_bins, C)
    assert got.dtype == torch.float32
    assert got.shape == (n_nodes, d, n_bins, C)
    args = (jnp.asarray(xb.astype(np.int32)), jnp.asarray(node),
            jnp.asarray(y), jnp.asarray(w))
    pallas = np.asarray(histogram_pallas(*args, n_nodes, n_bins, C,
                                         interpret=True))
    oracle = np.asarray(jnp_histogram_ref(*args, n_nodes, n_bins, C))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("n_nodes,d,n_bins,K", GRID)
def test_moments_plain_matches_pallas_and_oracle(n_nodes, d, n_bins, K):
    xb, node, y, w = _inputs(n_nodes + d * 3 + n_bins + K, 600, n_nodes, d,
                             n_bins, K)
    yf = y.astype(np.float64)
    for integer in (True, False):
        wv = w.astype(np.float64) if integer else \
            np.random.default_rng(K).normal(size=len(w)) * 3
        wm = np.stack([wv, wv * yf, wv * (yf * yf)][:K], 1).astype(
            np.float32)
        got = moments(*_t(xb, node, wm), n_nodes, n_bins).numpy()
        assert got.shape == (n_nodes, d, n_bins, K)
        args = (jnp.asarray(xb.astype(np.int32)), jnp.asarray(node),
                jnp.asarray(wm))
        pallas = np.asarray(moments_pallas(*args, n_nodes, n_bins, K,
                                           interpret=True))
        oracle = np.asarray(jnp_moments_ref(*args, n_nodes, n_bins, K))
        if integer:
            np.testing.assert_array_equal(got, pallas)
            np.testing.assert_array_equal(got, oracle)
        else:
            # float32 sums in another order: 1e-6 of the bin's Σ|payload|
            scale = np.asarray(jnp_moments_ref(
                args[0], args[1], jnp.abs(args[2]), n_nodes, n_bins, K))
            for want in (pallas, oracle):
                assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


def test_wrappers_handle_empty_input_zero_weights_and_empty_nodes():
    xb, node, y, w = _inputs(1, 400, 9, 4, 16, 3)
    e = histogram(*_t(xb[:0], node[:0], y[:0], w[:0]), 9, 16, 3)
    assert e.shape == (9, 4, 16, 3) and not e.any()
    e = moments(*_t(xb[:0], node[:0]), torch.zeros((0, 3)), 9, 16)
    assert e.shape == (9, 4, 16, 3) and not e.any()
    z = histogram(*_t(xb, node, y, np.zeros_like(w)), 9, 16, 3)
    assert not z.any()
    h = histogram(*_t(xb, node, y, w), 9, 16, 3)
    assert not h[1::2].any()                     # odd nodes have no samples
    np.testing.assert_array_equal(h.sum((1, 2, 3)).numpy() / 4,
                                  np.bincount(node, weights=w, minlength=9))


def test_rows_select_code_rows_and_unsorted_nodes_are_fine():
    """``rows`` reads sample i's codes from row rows[i] of a larger code
    matrix, as the trainer passes its frontier; node order is free."""
    rng = np.random.default_rng(4)
    xb, node, y, w = _inputs(2, 300, 7, 5, 16, 3)
    big = rng.integers(0, 16, (1000, 5)).astype(np.uint8)
    rows = rng.integers(0, 1000, 300)
    got = histogram(*_t(big, node, y, w), 7, 16, 3, rows=torch.as_tensor(rows))
    want = histogram(*_t(big[rows], node, y, w), 7, 16, 3)
    assert torch.equal(got, want)
    order = np.argsort(node, kind="stable")
    assert torch.equal(histogram(*_t(big[rows][order], node[order], y[order],
                                     w[order]), 7, 16, 3), want)
    wm = torch.as_tensor(rng.integers(0, 5, (300, 3)), dtype=torch.float32)
    assert torch.equal(
        moments(torch.as_tensor(big), torch.as_tensor(node), wm, 7, 16,
                rows=torch.as_tensor(rows, dtype=torch.int32)),
        moments_ref(torch.as_tensor(big[rows]), torch.as_tensor(node), wm, 7,
                    16, 3))


def test_wrappers_reject_bad_inputs():
    xb, node, y, w = _t(*_inputs(3, 50, 3, 2, 8, 2))
    with pytest.raises(TypeError):
        histogram(xb.float(), node, y, w, 3, 8, 2)
    with pytest.raises(TypeError):
        histogram(xb, node.long(), y, w, 3, 8, 2)
    with pytest.raises(TypeError):
        histogram(xb, node, y, w.double(), 3, 8, 2)
    with pytest.raises(ValueError):
        histogram(xb, node, y[:10], w, 3, 8, 2)
    with pytest.raises(ValueError):
        histogram(xb[:10], node, y, w, 3, 8, 2)
    with pytest.raises(TypeError):
        histogram(xb, node, y, w, 3, 8, 2, rows=torch.zeros(50))
    with pytest.raises(ValueError):
        moments(xb, node, w, 3, 8)                   # wm must be (m, K)
    with pytest.raises(IndexError):
        histogram(xb, node, y, w, 3, 8, 2, rows=torch.arange(50) + 1)


@pytest.mark.parametrize("d,n_bins,C,values,classes,want_ds,want_smem", [
    (20, 64, 7, 1, True, 20, True),       # acceptance: one slice a node
    (20, 64, 3, 3, False, 20, True),      # GBT moments
    (40, 256, 7, 1, True, 20, True),      # 287 KB a node: two slices of 20
    (33, 2, 2, 1, True, 17, True),        # more features than warps
    (3, 300, 200, 1, True, 3, False),     # one feature is past the limit
    (1, 16, 2, 1, True, 1, True),
])
def test_slice_plan_fits_shared_memory(d, n_bins, C, values, classes,
                                       want_ds, want_smem):
    ds, smem = slice_plan(d, n_bins, C, values, classes, H100_SMEM)
    assert (ds, smem) == (want_ds, want_smem)
    assert 1 <= ds <= 32
    code_bytes = 1 if n_bins <= 256 else 2
    assert (ds, smem) == slice_plan(d, n_bins, C, values, classes, H100_SMEM,
                                    code_bytes)
    if smem:      # the slice's histogram, tags and staged tiles fit a block
        assert h_ops.smem_bytes(ds, n_bins, C, values, classes, code_bytes,
                                True) <= H100_SMEM
    # the staging alone (two code tiles, three of row ids, labels and
    # payloads, the tag tables) fits beside any slice
    assert h_ops.smem_bytes(32, n_bins, C, values, classes, 4, False) \
        <= H100_SMEM


@pytest.mark.parametrize("d,n_bins,C,values,classes,want_ds,want_smem", [
    (20, 64, 7, 1, True, 20, True),       # acceptance: a lane a feature
    (20, 64, 3, 3, False, 10, True),      # GBT moments: a lane a column
    (40, 256, 7, 1, True, 20, True),      # 287 KB a node: two slices of 20
    (33, 2, 2, 1, True, 17, True),        # more features than lanes
    (5, 16, 40, 40, False, 1, True),      # more columns than lanes
    (3, 300, 200, 1, True, 3, False),     # one feature is past the limit
])
def test_fold_slice_plan_fits_shared_memory(d, n_bins, C, values, classes,
                                            want_ds, want_smem):
    ds, smem = slice_plan(d, n_bins, C, values, classes, H100_SMEM,
                          fold=True)
    assert (ds, smem) == (want_ds, want_smem)
    per = 1 if classes else min(values, 32)
    assert 1 <= ds * per <= 32 or (ds == 1 and per == 32)
    if smem:
        assert h_ops.smem_bytes(ds, n_bins, C, values, classes, 1, True,
                                fold=True) <= H100_SMEM


@pytest.mark.parametrize("d,n_bins,C,values,classes,n_items,want", [
    (20, 64, 7, 1, True, 600, (True, 20, True)),    # RF level 1: fold
    (20, 64, 3, 3, False, 128, (False, 20, True)),  # GBT root: rank
    (20, 64, 3, 3, False, 600, (True, 10, True)),   # many units: fold
    (3, 300, 200, 1, True, 5000, (False, 3, False)),  # global memory: rank
])
def test_launch_plan_picks_the_mode_by_units(d, n_bins, C, values, classes,
                                             n_items, want):
    """The fold mode (a warp a unit) when its units fill the SMs at least
    twice over, else the rank mode; never the fold mode in global
    memory."""
    assert h_ops.launch_plan(d, n_bins, C, values, classes, 1, n_items,
                             H100_SMEM, 132) == want


@pytest.mark.parametrize("counts", [
    [0], [5, 0, 256, 257, 0], [100_000, 3], [1] * 70 + [10_000],
    [50_000], [31_600] * 100, [10_000_000, 5]])
def test_work_items_cover_every_node_once(counts):
    """Items cover each node's samples exactly once, in order; a node of at
    most one segment writes its own row, a larger one writes consecutive
    partial rows that the reduce pass sums into its row."""
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n_nodes = len(counts)
    items, red, n_partial = work_items(bounds)
    seg = max(h_ops._MIN_SEGMENT, -(-sum(counts) // h_ops._TARGET_ITEMS))
    assert items.dtype == np.int64 and items.shape[1] == 3
    assert np.all(items[:, 0] <= items[:, 1])
    np.testing.assert_array_equal(items[1:, 0], items[:-1, 1])
    assert items[0, 0] == 0 and items[-1, 1] == bounds[-1]
    rows = items[:, 2]
    assert len(np.unique(rows)) == len(rows)
    assert n_partial == int((rows >= n_nodes).sum())
    for node, first, count in red:
        assert counts[node] > seg
        assert 1 < count <= h_ops._MAX_SEGMENTS
        sel = (rows >= first) & (rows < first + count)
        assert items[sel, 0].min() == bounds[node]
        assert items[sel, 1].max() == bounds[node + 1]
        np.testing.assert_array_equal(rows[sel], np.arange(first,
                                                           first + count))
    direct = rows[rows < n_nodes]
    cut = set(red[:, 0].tolist())
    assert sorted(direct.tolist() + list(cut)) == list(range(n_nodes))


# ------------------------------------------------- ordered oracle, bounds=

def _node_ordered(seed, n_nodes, counts, d, n_bins, C, n_code_rows=1000):
    """Samples in node order (``counts`` a node, zeros included), row ids
    into a larger code matrix, labels and integer weights."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    assert len(counts) == n_nodes
    m = int(counts.sum())
    big = rng.integers(0, n_bins, (n_code_rows, d)).astype(np.uint8)
    rows = rng.integers(0, n_code_rows, m)
    node = np.repeat(np.arange(n_nodes), counts).astype(np.int32)
    y = rng.integers(0, C, m).astype(np.int32)
    w = rng.integers(0, 4, m).astype(np.float32)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return big, rows, node, y, w, bounds


ORDERED = [(1, [900]),                           # one node, cut in 4
           (3, [600, 0, 40]),                    # a cut node, an empty one
           (65, [0] * 30 + [300] + [7] * 34)]    # many small nodes, one cut


@pytest.mark.parametrize("n_nodes,counts", ORDERED)
def test_ordered_oracle_matches_plain_and_pallas(n_nodes, counts):
    """On integer payloads every order gives the same sums, so the ordered
    oracle equals the plain version and the Pallas kernels there."""
    d, n_bins, C = 4, 16, 3
    big, rows, node, y, w, bounds = _node_ordered(n_nodes, n_nodes, counts,
                                                  d, n_bins, C)
    items, red, _ = work_items(bounds)
    assert len(red) == 1                         # a node is cut in segments
    codes = big[rows]
    want = histogram_ordered(codes, y, w, items, red, n_nodes, n_bins, C)
    plain = histogram(*_t(big, node, y, w), n_nodes, n_bins, C,
                      rows=torch.as_tensor(rows))
    np.testing.assert_array_equal(want, plain.numpy())
    jx = (jnp.asarray(codes.astype(np.int32)), jnp.asarray(node))
    np.testing.assert_array_equal(want, np.asarray(histogram_pallas(
        *jx, jnp.asarray(y), jnp.asarray(w), n_nodes, n_bins, C,
        interpret=True)))
    yf = y.astype(np.float32)
    wm = np.stack([w, w * yf, w * yf * yf], 1)
    want_m = moments_ordered(codes, wm, items, red, n_nodes, n_bins)
    plain_m = moments(*_t(big, node, wm), n_nodes, n_bins,
                      rows=torch.as_tensor(rows))
    np.testing.assert_array_equal(want_m, plain_m.numpy())
    np.testing.assert_array_equal(want_m, np.asarray(moments_pallas(
        *jx, jnp.asarray(wm), n_nodes, n_bins, 3, interpret=True)))


def test_ordered_oracle_sums_in_the_contract_order():
    """On continuous payloads the oracle's bits are those of float32 adds
    in sample order within a segment, then segment by segment from 0."""
    rng = np.random.default_rng(7)
    m = 700
    codes = np.zeros((m, 1), np.uint8)           # every sample in one bin
    w = (rng.normal(size=m) * 1e3).astype(np.float32)
    bounds = np.array([0, m])
    items, red, _ = work_items(bounds)
    want = np.float32(0)
    for s, e, _row in items:
        part = np.float32(0)
        for v in w[s:e]:
            part = np.float32(part + v)
        want = np.float32(want + part)
    got = histogram_ordered(codes, np.zeros(m, np.int32), w, items, red, 1,
                            2, 1)
    assert got[0, 0, 0, 0] == want and got[0, 0, 1, 0] == 0
    got_m = moments_ordered(codes, w[:, None], items, red, 1, 2)
    assert got_m[0, 0, 0, 0] == want


@pytest.mark.parametrize("n_nodes,counts", ORDERED)
def test_bounds_path_equals_node_path(n_nodes, counts):
    big, rows, node, y, w, bounds = _node_ordered(n_nodes + 1, n_nodes,
                                                  counts, 5, 16, 3)
    r = torch.as_tensor(rows)
    by_node = histogram(*_t(big, node, y, w), n_nodes, 16, 3, rows=r)
    for rr in (None, (int(rows.min()), int(rows.max())), (0, 999)):
        got = histogram(torch.as_tensor(big), None, *_t(y, w), n_nodes, 16,
                        3, rows=r, bounds=bounds, row_range=rr)
        assert torch.equal(got, by_node)
    wm = torch.as_tensor(np.stack([w, 2 * w], 1))
    assert torch.equal(
        moments(torch.as_tensor(big), None, wm, n_nodes, 16, rows=r,
                bounds=bounds, row_range=(0, 999)),
        moments(*_t(big, node), wm, n_nodes, 16, rows=r))
    codes = big[rows]                            # no rows: codes in order
    assert torch.equal(
        histogram(torch.as_tensor(codes), None, *_t(y, w), n_nodes, 16, 3,
                  bounds=bounds),
        histogram(*_t(codes, node, y, w), n_nodes, 16, 3))


def test_bounds_path_rejects_bad_layouts_and_rows():
    big, rows, node, y, w, bounds = _node_ordered(5, 3, [30, 0, 20], 2, 8, 2)
    xb, r, yt, wt = _t(big, rows, y, w)
    call = functools.partial(histogram, xb, None, yt, wt, 3, 8, 2, rows=r)
    for bad in (bounds[:-1], bounds + 1, np.array([0, 30, 10, 50]),
                np.array([0, 30, 30, 49]), bounds.astype(np.float64)):
        with pytest.raises(ValueError, match="bounds"):
            call(bounds=bad)
    with pytest.raises(ValueError, match="exactly one"):
        histogram(xb, torch.as_tensor(node), yt, wt, 3, 8, 2, rows=r,
                  bounds=bounds)
    with pytest.raises(ValueError, match="exactly one"):
        histogram(xb, None, yt, wt, 3, 8, 2, rows=r)
    with pytest.raises(IndexError):
        call(bounds=bounds, rows=r + 1000)
    with pytest.raises(IndexError):
        call(bounds=bounds, rows=r - 1000, row_range=(-1000, 0))
    with pytest.raises(ValueError, match="row_range"):
        call(bounds=bounds, row_range=(0, 3))     # the ids reach past 3
    with pytest.raises(ValueError, match="bounds"):
        moments(xb, None, torch.ones((50, 3)), 3, 8, rows=r,
                bounds=np.array([0, 30, 30, 51]))
