"""Rows in the shape of the repository's ``gaussian_classes``, as its
documented out-of-core run draws them: ``n_classes`` classes, each a
mixture of ``clusters_per_class`` unit Gaussians in the first
``n_informative`` features around centres drawn from N(0, sep²), and unit
Gaussian noise in the other features.

The centres are fixed by the configuration's ``structure_seed``; the rows
come from the seed given, made on the device in a few large calls, with
every class holding the same number of rows (to one) in the seed's order.
"""
from __future__ import annotations

import numpy as np

from pb.rng import device_generator


def centres(cfg: dict) -> np.ndarray:
    """(n_classes, clusters_per_class, n_informative) cluster centres."""
    rng = np.random.default_rng(cfg["structure_seed"])
    return rng.normal(0.0, cfg["sep"], size=(
        cfg["n_classes"], cfg["clusters_per_class"], cfg["n_informative"]))


def generate(cfg: dict, seed: int, stream: str, n: int, device):
    import torch
    C, K = cfg["n_classes"], cfg["clusters_per_class"]
    g = device_generator(torch, device, seed, stream)
    f64 = dict(dtype=torch.float64, device=device)
    y = torch.arange(n, device=device) % C
    y = y[torch.randperm(n, generator=g, device=device)]
    cluster = torch.randint(0, K, (n,), generator=g, device=device)
    X = torch.randn((n, cfg["n_features"]), generator=g, **f64)
    X[:, :cfg["n_informative"]] += torch.as_tensor(centres(cfg),
                                                   **f64)[y, cluster]
    return X.cpu().numpy(), y.cpu().numpy()
