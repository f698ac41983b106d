"""The data generators: the source's shape, exact class shares, the seed
alone decides the rows."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from pb import common

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", ["rf_gap_covtype", "gbt_boosted_higgs"])
def test_shape_shares_and_seed(config):
    cfg = common.config(common.manifest(), config)
    gen = common.load_module("data", cfg["generator"])
    X, y = gen.generate(cfg, 2 ** 33 + 5, "train", 4000, CPU)
    assert X.shape == (4000, cfg["n_features"]) and X.dtype == np.float64
    assert np.all(np.isfinite(X))
    assert y.min() == 0 and y.max() == cfg["n_classes"] - 1
    X2, y2 = gen.generate(cfg, 2 ** 33 + 5, "train", 4000, CPU)
    assert np.array_equal(X, X2) and np.array_equal(y, y2)
    X3, y3 = gen.generate(cfg, 2 ** 33 + 6, "train", 4000, CPU)
    assert not np.array_equal(X, X3)
    assert np.array_equal(np.bincount(y), np.bincount(y3))
    Xp, _ = gen.generate(cfg, 2 ** 33 + 5, "other", 4000, CPU)
    assert not np.array_equal(X, Xp)


def test_covtype_one_hot_groups():
    cfg = common.config(common.manifest(), "rf_gap_covtype")
    gen = common.load_module("data", cfg["generator"])
    X, y = gen.generate(cfg, 3, "train", 20000, CPU)
    q = cfg["n_quantitative"]
    for a, b in ((q, q + 4), (q + 4, q + 44)):
        assert np.all(X[:, a:b].sum(1) == 1)
    share = np.bincount(y, minlength=7) / len(y)
    want = np.asarray(cfg["class_shares"]) / sum(cfg["class_shares"])
    assert np.allclose(share, want, atol=1e-4)


def test_higgs_signal_share_and_masses():
    cfg = common.config(common.manifest(), "gbt_boosted_higgs")
    gen = common.load_module("data", cfg["generator"])
    X, y = gen.generate(cfg, 3, "train", 20000, CPU)
    assert abs(y.mean() - cfg["signal_share"]) < 1e-4
    assert np.all(X[:, 21:] >= 0)                  # masses
    # the label is learnable but not trivially: a class mean differs
    d = np.abs(X[y == 1].mean(0) - X[y == 0].mean(0)) / X.std(0)
    assert d.max() > 0.05
