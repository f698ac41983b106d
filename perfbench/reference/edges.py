"""The fit's bin edges at any number of training rows.

The trainer takes its quantile edges over at most 200,000 rows: above
that, over a sample of 200,000 rows drawn without replacement by the first
call of ``numpy.random.default_rng(seed)``, the forest's seed.  The edges
are then ``forest.py::fit_edges`` of the rows it took.
"""
from __future__ import annotations

import numpy as np

from . import forest as rforest

SAMPLE_ROWS = 200_000


def fit_edges(X, n_bins: int, seed: int) -> np.ndarray:
    X = np.asarray(X, dtype=np.float64)
    if len(X) > SAMPLE_ROWS:
        X = X[np.random.default_rng(seed).choice(len(X), SAMPLE_ROWS,
                                                 replace=False)]
    return rforest.fit_edges(X, n_bins)
