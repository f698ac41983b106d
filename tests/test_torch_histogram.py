"""The split-histogram wrappers on the CPU, held against the JAX reference.

On a CPU tensor ``histogram``/``moments`` run their plain PyTorch versions;
those are held here against the reference's Pallas kernels
(``histogram_pallas``/``moments_pallas``, run in interpret mode) and its jnp
oracles: exact on integer weights, 1e-6 relative on continuous payloads.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``), against the same plain versions.
"""
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
from repro_torch.kernels.histogram.ref import moments_ref

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
    if smem:      # the slice's histogram and the staged tile fit a block
        stage = 4 * h_ops._TILE * (values + classes)
        assert ds * 4 * (n_bins * C + h_ops._TILE + 1) + stage <= H100_SMEM


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
