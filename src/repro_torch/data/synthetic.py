"""Synthetic tabular datasets (copy of the reference's generators used by
the proximity pipeline)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["gaussian_classes", "friedman1", "train_test_split"]


def gaussian_classes(n: int, d: int = 20, n_classes: int = 7, informative: int = 10,
                     clusters_per_class: int = 2, sep: float = 2.5,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Covertype-like: multi-class Gaussian mixture, noise dims appended."""
    rng = np.random.default_rng(seed)
    informative = min(informative, d)
    centers = rng.normal(0, sep, size=(n_classes, clusters_per_class, informative))
    y = rng.integers(0, n_classes, size=n)
    ci = rng.integers(0, clusters_per_class, size=n)
    X = np.empty((n, d))
    X[:, :informative] = centers[y, ci] + rng.normal(0, 1.0, size=(n, informative))
    X[:, informative:] = rng.normal(0, 1.0, size=(n, d - informative))
    return X, y


def friedman1(n: int, d: int = 10, noise: float = 1.0, seed: int = 0):
    """Friedman #1 regression: 5 informative uniform features, the rest
    noise, plus Gaussian target noise."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, max(d, 5)))
    y = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - 0.5) ** 2
         + 10 * X[:, 3] + 5 * X[:, 4] + rng.normal(0, noise, n))
    return X, y


def train_test_split(X, y, test_frac: float = 0.1, seed: int = 0):
    rng = np.random.default_rng(seed)
    p = rng.permutation(len(X))
    k = int(len(X) * (1 - test_frac))
    tr, te = p[:k], p[k:]
    return X[tr], y[tr], X[te], y[te]
