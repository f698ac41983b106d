"""The comparison that decides ``correct`` has to fail: the lower-precision
control (the program's own float32 factors) and the faults each cell can
have, planted in the fit or under the timed path, each come out not
correct, while the sound run comes out correct.  CPU, tiny sizes; the control's readings at
the cells' own sizes come from the card (``PERF.md``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny_run

ALLPAIRS = ["rf_gap_covtype.allpairs", "gbt_boosted_higgs.allpairs"]


@pytest.mark.parametrize("cell", ALLPAIRS)
def test_sound_run_is_correct(cell):
    ok, checks, res, _ = tiny_run(cell)
    assert ok, checks
    assert res["attempted"] > 0


@pytest.mark.parametrize("cell", ALLPAIRS)
def test_float32_control_is_not_correct(cell):
    ok, checks, _, _ = tiny_run(cell, dtype="float32")
    assert not ok
    over = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert over, checks


def _half_block(monkeypatch):
    """K2 computes the first half of each block's rows; the rest read 0."""
    from repro_torch.core import engine as eng
    real = eng.block_prox

    def half(gl_q, q, gl_w, w, index=None):
        out = real(gl_q, q, gl_w, w, index=index)
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(eng, "block_prox", half)


def _altered_topk(monkeypatch):
    """One neighbour of one row altered where top-k produces it."""
    from repro_torch.core.engine import ProximityEngine
    real = ProximityEngine.topk

    def topk(self, *a, **kw):
        idx, val = real(self, *a, **kw)
        idx, val = idx.clone(), val.clone()
        idx[:, 0] = (idx[:, 0] + 1) % self.n_ref
        return idx, val
    monkeypatch.setattr(ProximityEngine, "topk", topk)


def _reversed_ties(monkeypatch):
    """Top-k's equal values ordered by descending column."""
    from repro_torch.core.engine import ProximityEngine
    real = ProximityEngine.topk

    def topk(self, *a, **kw):
        idx, val = real(self, *a, **kw)
        i, v = idx.cpu().numpy(), val.cpu().numpy()
        order = np.stack([np.lexsort((-i[r], -v[r])) for r in range(len(i))])
        return (torch.as_tensor(np.take_along_axis(i, order, 1),
                                device=idx.device),
                torch.as_tensor(np.take_along_axis(v, order, 1),
                                device=val.device))
    monkeypatch.setattr(ProximityEngine, "topk", topk)


@pytest.mark.parametrize("cell", ALLPAIRS)
@pytest.mark.parametrize("fault", [_half_block, _altered_topk])
def test_allpairs_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, checks, _, _ = tiny_run(cell)
    assert not ok, checks


@pytest.mark.parametrize("cell", ALLPAIRS)
def test_tie_order_fault_is_not_correct(cell, monkeypatch):
    """The values stay right; only the columns' order among ties moves."""
    _reversed_ties(monkeypatch)
    ok, checks, _, _ = tiny_run(cell)
    assert not ok and checks["topk_index_mismatch"]["value"] >= 1, checks
    assert checks["topk_gap"]["value"] <= checks["topk_gap"]["limit"]


def _half_fit(monkeypatch):
    """Every tree grown on the first half of its in-bag rows; the forest
    keeps its in-bag counts of them all."""
    from repro_torch.forest import ensemble, training
    real = training._grow_trees

    def grow(Xb, y, tasks, *a, **kw):
        half = [(r[:len(r) // 2], w[:len(r) // 2], g) for r, w, g in tasks]
        return real(Xb, y, half, *a, **kw)
    monkeypatch.setattr(training, "_grow_trees", grow)
    monkeypatch.setattr(ensemble, "_grow_trees", grow)


@pytest.mark.parametrize("cell", ALLPAIRS)
def test_fit_fault_is_not_correct(cell, monkeypatch):
    _half_fit(monkeypatch)
    ok, checks, _, _ = tiny_run(cell)
    assert not ok and checks["fit_leaf_mismatch"]["value"] >= 1, checks


def _altered_leaf(monkeypatch):
    """One (row, tree) leaf altered where K1 produces it."""
    from repro_torch.forest.ensemble import BaseForest
    real = BaseForest.apply

    def apply(self, X):
        out = real(self, X).clone()
        out[0, 0] = (out[0, 0] + 1) % self.trees_[0].n_leaves
        return out
    monkeypatch.setattr(BaseForest, "apply", apply)


@pytest.mark.parametrize("cell", ALLPAIRS)
def test_routing_fault_is_not_correct(cell, monkeypatch):
    _altered_leaf(monkeypatch)
    ok, checks, _, _ = tiny_run(cell)
    assert not ok and checks["route_mismatch"]["value"] >= 1, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ALLPAIRS)
def test_card_sound_and_control(cell, card):
    """On the card at a small size: the sound run is correct, the float32
    control is not."""
    ok, checks, _, _ = tiny_run(cell, device=str(card),
                                cfg={"n_train": 8000, "n_trees": 50})
    assert ok, checks
    ok, checks, _, _ = tiny_run(cell, device=str(card), dtype="float32",
                                cfg={"n_train": 8000, "n_trees": 50})
    assert not ok, checks
