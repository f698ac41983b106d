"""Rows in the shape of UCI Covertype (Blackard 1998): 10 quantitative
features, 4 wilderness-area and 40 soil-type one-hot groups, 7 classes in
Covertype's shares.  No dataset ships with the benchmark, so this stands
in (the configuration lists it under ``assumed``).

Each class has its own distribution, fixed by the configuration's
``structure_seed``: the quantitative features a two-component Gaussian
mixture with class means and scales, each one-hot group a categorical draw
with class probabilities.  The rows themselves come from ``--seed``, made
on the device in a few large calls; every seed has exactly the same
number of rows of each class, in its own order.
"""
from __future__ import annotations

import numpy as np

from pb.rng import device_generator, exact_shares


def _structure(cfg: dict):
    rng = np.random.default_rng(cfg["structure_seed"])
    C, d = cfg["n_classes"], cfg["n_quantitative"]
    mu = rng.normal(0.0, cfg["class_spread"], size=(C, 2, d))
    sd = rng.uniform(0.6, 1.4, size=(C, 2, d))
    groups = [rng.dirichlet(np.full(k, a), size=C)
              for k, a in zip(cfg["onehot_groups"], cfg["onehot_alpha"])]
    return mu, sd, groups


def generate(cfg: dict, seed: int, stream: str, n: int, device):
    import torch
    mu, sd, groups = _structure(cfg)
    C = cfg["n_classes"]
    g = device_generator(torch, device, seed, stream)
    f64 = dict(dtype=torch.float64, device=device)
    labels = exact_shares(n, {c: s for c, s in
                              enumerate(cfg["class_shares"])})
    y = torch.as_tensor(np.asarray(labels, np.int64), device=device)
    y = y[torch.randperm(n, generator=g, device=device)]
    comp = (torch.rand(n, generator=g, **f64) < 0.5).long()
    mu_t = torch.as_tensor(mu, **f64)[y, comp]
    sd_t = torch.as_tensor(sd, **f64)[y, comp]
    cols = [mu_t + sd_t * torch.randn(mu_t.shape, generator=g, **f64)]
    for probs in groups:
        cdf = torch.as_tensor(np.cumsum(probs, axis=1), **f64)[y]
        u = torch.rand((n, 1), generator=g, **f64) * cdf[:, -1:]
        pick = torch.searchsorted(cdf, u).clamp_max(probs.shape[1] - 1)
        hot = torch.zeros((n, probs.shape[1]), **f64)
        hot.scatter_(1, pick, 1.0)
        cols.append(hot)
    X = torch.cat(cols, dim=1)
    if X.shape[1] != cfg["n_features"]:
        raise ValueError(f"made {X.shape[1]} features, the configuration "
                         f"states {cfg['n_features']}")
    return X.cpu().numpy(), y.cpu().numpy()
