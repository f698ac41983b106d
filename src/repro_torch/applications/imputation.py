"""Iterative proximity-weighted missing-value imputation (Breiman & Cutler).

The classic RF imputation loop, through the factored kernel:

  1. rough fill — column median (numeric) / column mode (categorical),
  2. fit a forest + kernel cache on the filled matrix (on the caller's
     device: a card imputer grows its forests on the card),
  3. replace every missing entry by its proximity-weighted estimate over the
     *observed* entries of that column:

        x̂[i,f] = Σ_j m_jf P(i,j) x[j,f] / Σ_j m_jf P(i,j)      (numeric)
        x̂[i,f] = argmax_k Σ_j m_jf 1[x_jf = k] P(i,j)          (categorical)

     where m_jf = 1 iff (j,f) was observed,
  4. repeat from 2 until the imputed entries stop moving.

Every update is a masked ``ProximityEngine.matmat`` on the device — one
factored kernel pass per iteration covers all numeric columns at once
(values and mask denominators stacked into a single V), categorical
columns vote through the class-masked matmat on their observed one-hot
codes — and its result comes back to the host once, where the filled
matrix lives.  Since m_if = 0 for a missing entry, the query's own (large)
self-proximity never feeds its own estimate.  On the card the products
sum with atomics, so two runs may differ in the last bits of an estimate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ProximityImputer"]

_TINY = np.finfo(np.float64).tiny


@dataclasses.dataclass
class ProximityImputer:
    """Proximity-weighted imputer; missing entries are NaN.

    ``kernel_kwargs`` is the ForestKernel config used for the per-iteration
    refits (``ForestKernel.impute`` fills it from its own config, ``device``
    included).  Categorical columns hold integer codes ≥ 0 stored as floats.
    """

    n_iter: int = 5
    categorical: Sequence[int] = ()
    tol: float = 1e-3
    kernel_kwargs: Optional[Dict] = None

    missing_mask_: Optional[np.ndarray] = None   # (N, d) bool
    history_: Optional[List[float]] = None       # per-iter relative deltas
    kernel_: object = None                       # last fitted ForestKernel
    X_imputed_: Optional[np.ndarray] = None

    def _rough_fill(self, X: np.ndarray, miss: np.ndarray) -> np.ndarray:
        cat = set(self.categorical)
        for f in range(X.shape[1]):
            m = miss[:, f]
            if not m.any():
                continue
            obs = X[~m, f]
            if len(obs) == 0:
                raise ValueError(f"column {f} has no observed values")
            if f in cat:
                vals, counts = np.unique(obs, return_counts=True)
                X[m, f] = vals[np.argmax(counts)]
            else:
                X[m, f] = np.median(obs)
        return X

    def fit_transform(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        from ..core.api import ForestKernel
        X = np.array(X, dtype=np.float64, copy=True)
        miss = ~np.isfinite(X)
        self.missing_mask_ = miss
        self.history_ = []
        if not miss.any():
            self.X_imputed_ = X
            return X
        obs = ~miss
        cat = set(self.categorical)
        num_cols = [f for f in range(X.shape[1])
                    if miss[:, f].any() and f not in cat]
        cat_cols = [f for f in range(X.shape[1])
                    if miss[:, f].any() and f in cat]
        X = self._rough_fill(X, miss)
        prev = X[miss].copy()

        fk = None
        for _ in range(self.n_iter):
            fk = ForestKernel(**(self.kernel_kwargs or {}))
            fk.fit(X, y)
            eng = fk.engine

            if num_cols:
                Fm = len(num_cols)
                V = np.empty((len(X), 2 * Fm), dtype=np.float64)
                V[:, Fm:] = obs[:, num_cols]                 # mask M
                V[:, :Fm] = X[:, num_cols]
                V[:, :Fm] *= V[:, Fm:]                       # X ⊙ M
                S = eng.matmat(V).cpu().numpy()              # one kernel pass
                del V
                numer, denom = S[:, :Fm], S[:, Fm:]
                for j, f in enumerate(num_cols):
                    m = miss[:, f]
                    ok = denom[m, j] > _TINY
                    est = numer[m, j] / np.maximum(denom[m, j], _TINY)
                    X[m, f] = np.where(ok, est, X[m, f])

            for f in cat_cols:
                codes = X[:, f].astype(np.int64)
                K = int(codes.max()) + 1
                onehot = np.zeros((len(X), K))
                onehot[np.arange(len(X)), codes] = 1.0
                votes = eng.matmat(onehot, col_mask=obs[:, f]).cpu().numpy()
                m = miss[:, f]
                vm = votes[m]
                # zero proximity mass to every observed row: keep the
                # rough fill rather than argmax of an all-zero vote
                ok = vm.max(axis=1) > _TINY
                X[m, f] = np.where(ok, vm.argmax(axis=1).astype(np.float64),
                                   X[m, f])

            cur = X[miss]
            delta = float(np.linalg.norm(cur - prev) /
                          max(np.linalg.norm(prev), _TINY))
            self.history_.append(delta)
            prev = cur.copy()
            if delta < self.tol:
                break

        self.kernel_ = fk
        self.X_imputed_ = X
        return X
