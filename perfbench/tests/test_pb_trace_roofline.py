"""The trace reduction (busy union, idle gaps named by the host span they
fall in) and the roofline counts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pb import roofline, trace


def test_union_counts_overlaps_once():
    s = np.array([0, 5, 2, 20], dtype=np.int64)
    e = np.array([4, 10, 6, 25], dtype=np.int64)
    gs, ge = trace.union(s, e)
    assert list(gs) == [0, 20] and list(ge) == [10, 25]


def test_summarize_window_busy_gaps_and_spans():
    ns = 1_000_000_000
    spans = [("window", 0, 10 * ns), ("step", 0, 4 * ns),
             ("idle", 6 * ns, 9 * ns)]
    dev = [("k2", 1 * ns, 2 * ns), ("topk", 1 * ns, 3 * ns),
           ("k1", 5 * ns, 6 * ns), ("late", 11 * ns, 12 * ns)]
    t = trace.summarize(dev, spans)
    assert t["window_s"] == 10 and t["busy_s"] == 3
    assert t["ops"]["k2"] == [1.0, 1] and "late" not in t["ops"]
    assert t["gaps"][0] == ["idle", 4.0]           # 6 s to 10 s, in idle
    assert ["step", 1.0] in t["gaps"]              # 0 to 1 s, in step
    assert trace.seconds_of(t, "k2") == 1.0
    assert trace.seconds_of(t, "k2", invert=True) == 3.0
    assert trace.top_ops(t, 1) == [["topk", 2.0]]


def _factors(seed=0, n=300, T=6, leaves=20, sparse=True):
    g = torch.Generator().manual_seed(seed)
    gl = torch.randint(0, leaves, (n, T), generator=g, dtype=torch.int32) \
        + torch.arange(T, dtype=torch.int32)[None, :] * leaves
    q = torch.rand((n, T), generator=g, dtype=torch.float64)
    w = torch.rand((n, T), generator=g, dtype=torch.float64)
    if sparse:
        q[q < 0.5] = 0
        w[w < 0.3] = 0
    return gl, q, w, T * leaves


def test_allpairs_work_is_collisions_and_reached_members():
    gl, q, w, L = _factors()
    nbytes, fmas = roofline.allpairs_work(torch, gl, q, gl, w, L, 10, 3)
    hit = (gl[:, None, :] == gl[None, :, :]) & (q[:, None, :] != 0) \
        & (w[None, :, :] != 0)
    assert fmas == float(hit.sum())
    reached = set(gl[q != 0].tolist())
    members = sum(int(((gl == l) & (w != 0)).sum()) for l in reached)
    n = gl.shape[0]
    assert nbytes == gl.numel() * 12 + members * 12 + n * 10 * 16 + n * 3 * 8


def test_allpairs_work_is_the_same_for_leaf_and_dense_forms():
    """The count reads the inputs, not the form K2 took: on the same
    inputs, the leaf index the leaf form walks holds exactly the members
    the count charges, and the dense form's inputs give the same count."""
    from repro_torch.kernels.block_prox.ops import block_prox, \
        build_leaf_index
    gl, q, w, L = _factors(seed=3)
    idx = build_leaf_index(gl, w, n_leaves=L)
    per_leaf = (idx.offs[:, -1] - idx.offs[:, 0]).long()
    members = torch.bincount(gl.reshape(-1)[w.reshape(-1) != 0].long(),
                             minlength=L)
    assert torch.equal(per_leaf, members)
    dense = block_prox(gl, q, gl, w)
    leafy = block_prox(gl, q, gl, w, index=idx)
    assert torch.equal(dense, leafy)
    a = roofline.allpairs_work(torch, gl, q, gl, w, L, 10, 3)
    b = roofline.allpairs_work(torch, gl.clone(), q.clone(), gl.clone(),
                               w.clone(), L, 10, 3)
    assert a == b


def test_least_time():
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 33.5e12) == pytest.approx(1.0)
