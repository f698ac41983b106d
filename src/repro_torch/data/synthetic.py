"""Synthetic datasets (copies of the reference's generators): class
mixtures with informative and noise dimensions, two spirals, image-like
class templates, and Friedman #1 regression."""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["gaussian_classes", "two_spirals", "image_classes", "friedman1",
           "train_test_split"]


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


def two_spirals(n: int, noise: float = 0.2, seed: int = 0):
    """Two interleaved noisy spirals in the plane, labels 0 and 1."""
    rng = np.random.default_rng(seed)
    m = n // 2
    t = np.sqrt(rng.random(m)) * 3 * np.pi
    d1 = np.stack([t * np.cos(t), t * np.sin(t)], 1)
    X = np.concatenate([d1, -d1]) + rng.normal(0, noise, size=(2 * m, 2))
    y = np.concatenate([np.zeros(m, np.int64), np.ones(m, np.int64)])
    p = rng.permutation(2 * m)
    return X[p], y[p]


def image_classes(n: int, side: int = 12, n_classes: int = 10, seed: int = 0):
    """FashionMNIST-like: per-class smooth random templates + pixel noise."""
    rng = np.random.default_rng(seed)
    g = np.arange(side)
    xx, yy = np.meshgrid(g, g)
    templates = []
    for c in range(n_classes):
        tpl = np.zeros((side, side))
        for _ in range(4):
            cx, cy = rng.uniform(0, side, 2)
            s = rng.uniform(1.0, 3.0)
            a = rng.uniform(0.5, 1.5)
            tpl += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
        templates.append(tpl)
    templates = np.stack(templates)
    y = rng.integers(0, n_classes, size=n)
    X = templates[y].reshape(n, -1) + rng.normal(0, 0.35, size=(n, side * side))
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
