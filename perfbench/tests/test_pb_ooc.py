"""The out-of-core cell (``rf_gap_ooc_1m.allpairs_ooc``): its files load
from ``BENCHMARK.json``, its generator keeps the source's shape, its driver
exits before the fit on a program without the collision rule and leaves no
scratch behind, its four readers read a record, the sampled bin edges the
checks route by are the trainer's, and the comparison that decides
``correct`` passes the sound run and fails the float32 control.  CPU, tiny
sizes (the CPU engine keeps its dense path)."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_run
from pb import common

CELL = "rf_gap_ooc_1m.allpairs_ooc"
CPU = torch.device("cpu")
SCRATCH = os.path.join(ROOT, ".bench_cache", "scratch")


def _scratch_dirs():
    if not os.path.isdir(SCRATCH):
        return set()
    return {d for d in os.listdir(SCRATCH) if d.startswith("ooc_")}


def test_config_mix_and_cell_load():
    man = common.manifest()
    cell = common.cell(man, CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "allpairs_ooc"
    cfg = common.config(man, cell["config"])
    assert (cfg["n_train_published"], cfg["n_features"], cfg["n_classes"]) \
        == (1_000_000, 20, 5)
    assert (cfg["model_type"], cfg["kernel_method"], cfg["n_trees"],
            cfg["max_depth"], cfg["min_samples_leaf"]) == \
        ("rf", "gap", 15, 32, 3)
    assert cfg["memory_budget_bytes"] == 512 << 20
    # the deployment's own rows, nothing cut
    assert cfg["reduced"] == [] and cfg["n_train"] == 1_000_000
    mix = common.mix(cell["traffic"])
    assert (mix["driver"], mix["k"], mix["check_rows"]) == \
        ("allpairs_ooc", 10, 1024)
    limits = common.cell_data(CELL)["limits"]
    for other in ("rf_gap_covtype.allpairs", "gbt_boosted_higgs.allpairs"):
        assert common.cell_data(other)["limits"] == limits
    e2e = [m["name"] for m in common.end_to_end(man, CELL)]
    assert e2e == ["setup_s", "allpairs_rows_per_s"]
    assert sorted(m["name"] for m in common.per_layer(man, CELL)) == sorted(
        f"{n}.allpairs_ooc" for n in ("collide_ms_per_pass",
                                      "collisions_per_row",
                                      "prox_roofline_pct",
                                      "device_idle_pct"))


def test_generator_shape_classes_and_seed():
    cfg = common.config(common.manifest(), "rf_gap_ooc_1m")
    gen = common.load_module("data", cfg["generator"])
    seed = 2 ** 33 + 5
    X, y = gen.generate(cfg, seed, "train", 5000, CPU)
    assert X.shape == (5000, 20) and X.dtype == np.float64
    assert np.array_equal(np.bincount(y), [1000] * 5)
    X2, y2 = gen.generate(cfg, seed, "train", 5000, CPU)
    assert np.array_equal(X, X2) and np.array_equal(y, y2)
    X3, y3 = gen.generate(cfg, seed + 1, "train", 5000, CPU)
    assert not np.array_equal(X, X3) and not np.array_equal(y, y3)
    # the classes differ in the 10 informative features only, and overlap
    means = np.stack([X[y == c].mean(0) for c in range(5)])
    spread = means.max(0) - means.min(0)
    assert spread[:10].min() > 0.2 and spread[10:].max() < 0.2
    assert spread[:10].max() < 4.0


def test_the_deployment_is_fixed_and_the_seed_draws_the_check_rows(
        monkeypatch):
    """Every seed fits the same rows and forest (the configuration's
    ``deployment_seed``), so every run does the same work; ``--seed``
    draws the rows the checks compare."""
    from pb import rng
    from repro_torch.core.api import ForestKernel
    fits, kept = [], []
    fit, stream = ForestKernel.fit_forest, rng.stream

    def seen_fit(self, X, y):
        fits.append((X.copy(), y.copy(), self.seed))
        return fit(self, X, y)

    def seen_stream(seed, key):
        kept.append(seed)
        return stream(seed, key)
    monkeypatch.setattr(ForestKernel, "fit_forest", seen_fit)
    monkeypatch.setattr(rng, "stream", seen_stream)
    seeds = (2 ** 33 + 1, 2 ** 31 + 7)
    for seed in seeds:
        ok, checks, _, _ = tiny_run(CELL, seed=seed)
        assert ok, checks
    cfg = common.config(common.manifest(), "rf_gap_ooc_1m")
    (X0, y0, s0), (X1, y1, s1) = fits
    assert s0 == s1 == cfg["deployment_seed"] == 0
    assert np.array_equal(X0, X1) and np.array_equal(y0, y1)
    assert tuple(kept) == seeds


def test_driver_exits_before_the_fit_without_the_rule(monkeypatch):
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.engine import ProximityEngine
    monkeypatch.delattr(ProximityEngine, "collision_mode")

    def fit(*a, **kw):
        raise AssertionError("the fit ran")
    monkeypatch.setattr(ForestKernel, "fit_forest", fit)
    with pytest.raises(SystemExit, match="no collision rule"):
        tiny_run(CELL)


def test_scratch_removed_after_success_and_failure(monkeypatch):
    before = _scratch_dirs()
    ok, checks, res, _ = tiny_run(CELL)
    assert ok, checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert _scratch_dirs() == before
    from repro_torch.core.api import ForestKernel

    def fit(*a, **kw):
        raise RuntimeError("a failed fit")
    monkeypatch.setattr(ForestKernel, "fit_forest", fit)
    with pytest.raises(RuntimeError, match="a failed fit"):
        tiny_run(CELL)
    assert _scratch_dirs() == before


def test_float32_control_is_not_correct():
    ok, checks, _, _ = tiny_run(CELL, dtype="float32")
    assert not ok
    assert [k for k, c in checks.items() if c["value"] > c["limit"]]


def _record():
    ops = {"collide_gather": [0.03, 40], "sort": [0.05, 20]}
    program = {"spans": {
        "engine.collide": {"calls": 8, "host_s": .1, "self_s": .1,
                           "device_s": 0.06},
        "engine.collide_select": {"calls": 4, "host_s": .1, "self_s": .1,
                                  "device_s": 0.012},
        "engine.collide_sums": {"calls": 4, "host_s": .1, "self_s": .1,
                                "device_s": 0.008},
        "engine.topk": {"calls": 4, "host_s": .3, "self_s": .1,
                        "device_s": 0.0}},
        "unspanned_device_s": 0.0, "unmatched_ops": 0}
    c0 = {"engine_collide_rows_total": 2e6, "engine_collisions_total": 6e7,
          "engine_topk_rows_total": 0.0}
    c1 = {"engine_collide_rows_total": 1e7, "engine_collisions_total": 3e8,
          "engine_topk_rows_total": 0.0}
    return {"passes": 4, "rows": 1_000_000, "window_s": 1.0,
            "trace": {"window_s": 1.0, "busy_s": 0.08, "ops": ops,
                      "gaps": [], "program": program},
            "work": {"pass_bytes": 3.35e9, "pass_fmas": 1e6},
            "counters": {"before": c0, "after": c1}}


def test_readers_on_a_synthetic_record():
    rec = _record()

    def read(name, r=rec):
        return common.load_module("metrics", f"{name}.allpairs_ooc").read(r)
    assert read("collide_ms_per_pass") == pytest.approx(80.0 / 4)
    assert read("collisions_per_row") == pytest.approx(2.4e8 / 8e6)
    # least time 1 ms a pass (bytes), 4 passes over 0.08 s on the device
    assert read("prox_roofline_pct") == pytest.approx(5.0)
    assert read("device_idle_pct") == pytest.approx(92.0)
    # a program without the spans or the counters: nothing read, no raise
    bare = dict(rec, trace=dict(rec["trace"], program=None),
                counters={"before": {k: 0.0 for k in rec["counters"]
                                     ["before"]},
                          "after": {k: 0.0 for k in rec["counters"]
                                    ["before"]}})
    assert read("collide_ms_per_pass", bare) is None
    assert read("collisions_per_row", bare) is None
    assert read("collisions_per_row", dict(rec, counters=None)) is None
    assert read("device_idle_pct", dict(rec, trace=None)) is None


def test_sampled_edges_are_the_trainers():
    """Above 200,000 rows the trainer's Binner takes its quantiles over the
    row sample its seed draws first; ``reference/edges.py`` draws the same
    rows (continuous rows: every quantile is an edge)."""
    from reference import edges
    from reference import forest as rforest
    from repro_torch.forest.training import Binner
    seed = 2 ** 32 + 77
    X = np.random.default_rng(1).normal(size=(edges.SAMPLE_ROWS + 1234, 3))
    b = Binner(X, 64, np.random.default_rng(seed))
    Q = edges.fit_edges(X, 64, seed)
    assert Q.shape == (63, 3)
    for f in range(3):
        assert np.array_equal(b.edges[f], Q[:, f])
    assert not np.array_equal(Q, rforest.fit_edges(X, 64))
    assert not np.array_equal(Q, edges.fit_edges(X, 64, seed + 1))
