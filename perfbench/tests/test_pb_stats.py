"""The metric arithmetic and the seeded draws: the rate runs over the whole
window, so a stall moves it; every seed draws its own stream and the same
shares."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import tiny_run
from pb import rng, stats


def test_exact_shares():
    lab = rng.exact_shares(7, {"a": 0.5, "b": 0.5})
    assert sorted(lab) in (["a"] * 4 + ["b"] * 3, ["a"] * 3 + ["b"] * 4)
    lab = rng.exact_shares(1000, {0: 0.365, 1: 0.488, 2: 0.147})
    assert [lab.count(c) for c in range(3)] == [365, 488, 147]


def test_streams_are_the_seeds_alone():
    a = rng.stream(2 ** 31 + 7, 7).integers(0, 1 << 30, 8)
    assert np.array_equal(a, rng.stream(2 ** 31 + 7, 7).integers(0, 1 << 30,
                                                                 8))
    assert not np.array_equal(a, rng.stream(2 ** 31 + 7, 8)
                              .integers(0, 1 << 30, 8))
    assert rng.derive(2 ** 33, "train") != rng.derive(2 ** 33, "other")
    assert rng.derive(-5, "train") != rng.derive(5, "train")


def test_rate():
    assert stats.rate(10, 2.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_stall_moves_the_rate(monkeypatch):
    """A 50 ms stall in each all-pairs pass moves the rate by its size."""
    import time
    _, _, _, base = tiny_run("rf_gap_covtype.allpairs", seconds=1.0)
    from repro_torch.core.engine import ProximityEngine
    topk = ProximityEngine.topk

    def slow_topk(self, *a, **kw):
        time.sleep(0.05)
        return topk(self, *a, **kw)
    monkeypatch.setattr(ProximityEngine, "topk", slow_topk)
    _, _, _, slow = tiny_run("rf_gap_covtype.allpairs", seconds=1.0)
    assert slow["allpairs_rows_per_s"] < 0.9 * base["allpairs_rows_per_s"]
