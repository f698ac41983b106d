"""Bootstrap machinery: in-bag multiplicities and OOB indicators.

RF-GAP and the (separable) OOB kernels need, per (sample, tree):
  - ``c_t(x)``: in-bag multiplicity (how many times x was drawn for tree t),
  - ``o_t(x) = 1[c_t(x) == 0]``: the OOB indicator,
and the per-sample OOB tree count ``S(x) = Σ_t o_t(x)``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bootstrap_counts", "oob_mask"]


def bootstrap_counts(n: int, n_trees: int, rng: np.random.Generator,
                     bootstrap: bool = True) -> np.ndarray:
    """(T, N) int32 in-bag multiplicities. Without bootstrap: all ones."""
    if not bootstrap:
        return np.ones((n_trees, n), dtype=np.int32)
    out = np.empty((n_trees, n), dtype=np.int32)
    for t in range(n_trees):
        draws = rng.integers(0, n, size=n)
        out[t] = np.bincount(draws, minlength=n)
    return out


def oob_mask(inbag: np.ndarray) -> np.ndarray:
    """(T, N) bool: True where the sample is out-of-bag for the tree."""
    return inbag == 0
