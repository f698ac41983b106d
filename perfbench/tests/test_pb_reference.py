"""The plain reference against the port at a tiny size on the CPU: routing
bit for bit, weights, proximity rows (both of the reference's forms), the
top-k with its tie rule, class sums, and the fit's leaf tallies."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pb import checks, common, program
from pb.spans import Spans
from reference import forest as rforest
from reference.pipeline import Forest
from reference.prox import Reference, class_sq_sums, onehot, topk

CPU = torch.device("cpu")


def _built(config):
    man = common.manifest()
    cfg = dict(common.config(man, config))
    cfg.update(n_train=900, n_trees=10)
    b = program.build(cfg, 77, CPU, Spans())
    return cfg, b


@pytest.fixture(scope="module", params=["rf_gap_covtype",
                                        "gbt_boosted_higgs"])
def case(request):
    cfg, b = _built(request.param)
    st = program.model_state(b.fk, cfg)
    ref = Forest(torch, st, b.X, b.y, cfg["kernel_method"], CPU)
    return cfg, b, st, ref


def test_routing_and_weights(case):
    cfg, b, st, ref = case
    pf = program.program_factors(b.fk)
    assert np.array_equal(pf["leaves"], ref.leaves.numpy())
    assert np.allclose(pf["q"], ref.q.numpy(), rtol=1e-15, atol=0)
    assert np.allclose(pf["w"], ref.w.numpy(), rtol=1e-15, atol=0)


def test_rows_topk_and_class_sums(case):
    cfg, b, st, ref = case
    C = cfg["n_classes"]
    rows = np.arange(0, 900, 7)
    P = ref.ref.rows(ref.gl[rows], ref.q[rows])
    got = b.fk.kernel_block(rows)
    assert torch.allclose(got, P, rtol=1e-12, atol=1e-15)
    # the other form gives the same rows
    other = Reference(torch, ref.gl, ref.w, st["total_leaves"],
                      dense_max_bytes=0 if ref.ref.form == "dense"
                      else 1 << 40)
    assert other.form != ref.ref.form
    assert torch.allclose(other.rows(ref.gl[rows], ref.q[rows]), P,
                          rtol=1e-12, atol=1e-15)
    idx, val = b.fk.topk(k=10)
    ri, rv = topk(torch, P, 10)
    assert torch.allclose(val[rows], rv, rtol=1e-12, atol=1e-15)
    tied = torch.isclose(P.gather(1, idx[rows]), rv, rtol=1e-12, atol=1e-15)
    assert bool(tied.all())
    Y = onehot(torch, b.y, C, torch.float64, CPU)
    sq = b.fk.engine.squared_row_sums(class_ids=b.y, n_classes=C)
    assert torch.allclose(sq[rows], class_sq_sums(P, Y), rtol=1e-12,
                          atol=1e-15)


def test_fit_tallies(case):
    """Routed by the fit's own float64 edges, the training rows give every
    leaf its stored in-bag count and class histogram."""
    cfg, b, st, ref = case
    edges = rforest.fit_edges(b.X, cfg["n_bins"])
    for f, e in enumerate(b.fk.forest.binner_.edges):
        assert np.isin(e, edges[:, f]).all()
    thr, unmatched = rforest.fit_thresholds(st, edges)
    assert unmatched == 0
    gl = rforest.global_leaves(torch, st,
                               rforest.route(torch, st, b.X, CPU, thr=thr))
    classes = cfg["model_type"] != "gbt"
    count, hist = rforest.leaf_tallies(torch, st, gl, b.y,
                                       cfg["n_classes"] if classes else 0)
    assert checks.fit_mismatch(st, count, hist, classes) == 0
    st2 = dict(st, leaf_count=st["leaf_count"].copy())
    st2["leaf_count"][::7] += 1
    assert checks.fit_mismatch(st2, count, hist, classes) == \
        len(st["leaf_count"][::7])


def test_topk_index_mismatch_keeps_the_tie_rule():
    P = np.array([[0.5, 0.25, 0.25, 0.25 + 1e-15, 0.0]])
    ri, rv = topk(torch, torch.as_tensor(P), 4)
    ri, rv = ri.numpy(), rv.numpy()
    assert ri.tolist() == [[0, 3, 1, 2]]

    def count(idx, val=None):
        idx = np.array([idx])
        val = np.take_along_axis(P, np.clip(idx, 0, 4), 1) if val is None \
            else np.array([val])
        return checks.topk_index_mismatch(idx, val, P, ri)
    assert count(ri[0]) == 0
    # within rounding either order stands, also where the reference ties
    assert count([0, 1, 3, 2]) == 0
    assert count([0, 3, 2, 1], [0.5, 0.25 + 1e-15, 0.25 + 1e-16, 0.25]) == 0
    # equal values in the program's answer by descending column
    assert count([0, 3, 2, 1]) == 1
    # a wrong column, and one out of range
    assert count([4, 3, 1, 2]) == 1
    assert count([0, 3, 1, 9], [0.5, 0.25 + 1e-15, 0.25, 0.0]) == 1
