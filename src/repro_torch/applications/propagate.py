"""Semi-supervised label propagation on the proximity graph, on the device.

Zhu–Ghahramani-style propagation with clamped labels: with the row-stochastic
operator S = D⁻¹ P (D = kernel row sums), iterate

    F ← α S F + (1 − α) Y₀,   then   F[labeled] ← Y₀[labeled]

until the class scores stop moving.  Each step is one row-normalized
``ProximityEngine.matmat`` — a bucket pass and a gather through the
factors, so the proximity graph itself is never materialized — and the
field ``F`` stays on the device; the only host read a step is the
convergence test's maximum.

``online=True`` returns an :class:`OnlineLabelPropagation` state instead of
the final arrays: the converged training field is kept warm, and each
``partial_fit(X_batch)`` folds a new unlabeled batch in — a bounded
warm-started refinement of the training field (usually 0–1 steps once
converged) followed by one out-of-sample row-normalized matmat (the batch
routed through the routing kernel) that projects the batch onto the field.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["propagate_labels", "OnlineLabelPropagation"]


def _solve(engine, Y0: torch.Tensor, labeled: torch.Tensor, alpha: float,
           n_iter: int, tol: float, F: Optional[torch.Tensor] = None
           ) -> tuple:
    """Clamped propagation iterations from a (warm) start; returns
    (F, n_steps_run, last_delta)."""
    F = Y0.clone() if F is None else F
    steps = 0
    delta = np.inf
    for _ in range(n_iter):
        Fn = alpha * engine.matmat(F, normalized=True) + (1 - alpha) * Y0
        Fn[labeled] = Y0[labeled]
        delta = float((Fn - F).abs().max())
        F = Fn
        steps += 1
        if delta < tol:
            break
    return F, steps, delta


def _to_scores(F: torch.Tensor) -> torch.Tensor:
    # float64 for a float32 field too, as the reference's scores are (its
    # float64 ``tiny`` widens the row sums)
    rs = F.sum(dim=1, keepdim=True).to(torch.float64)
    return F / rs.clamp_min(np.finfo(np.float64).tiny)


def propagate_labels(engine, y, labeled, n_classes: Optional[int] = None,
                     alpha: float = 0.8, n_iter: int = 50, tol: float = 1e-5,
                     online: bool = False):
    """Propagate the labels of ``labeled`` rows to the rest of the training
    set.  ``y`` entries outside the labeled mask are ignored (may be -1).

    Returns ``(labels, scores)`` on the engine's device: hard labels (N,)
    and the propagated class scores (N, C) normalized to row-sum 1 where
    possible.  With ``online=True`` returns an
    :class:`OnlineLabelPropagation` whose ``partial_fit(X_batch)`` serves
    new unlabeled batches from the warm-started field.
    """
    y = np.asarray(y, dtype=np.int64)
    labeled = np.asarray(labeled, dtype=bool)
    if not labeled.any():
        raise ValueError("need at least one labeled sample")
    if n_classes is None:
        n_classes = int(y[labeled].max()) + 1
    Y0 = np.zeros((len(y), n_classes))
    Y0[labeled, y[labeled]] = 1.0
    Y0 = torch.as_tensor(Y0, device=engine.device)
    lab = torch.as_tensor(labeled, device=engine.device)
    F, _, delta = _solve(engine, Y0, lab, alpha, n_iter, tol)
    if online:
        return OnlineLabelPropagation(engine, Y0, lab, F, alpha=alpha,
                                      tol=tol, converged=delta < tol)
    return F.argmax(dim=1), _to_scores(F)


class OnlineLabelPropagation:
    """Warm-started label-propagation state for mini-batch / online serving.

    Holds the converged training field F on the device; ``partial_fit``
    refines it with a bounded number of warm-started clamped iterations
    (no-ops once converged, so the steady-state serving cost is the batch
    projection alone) and then projects the incoming batch through one
    out-of-sample row-normalized matmat  F_batch = S_oos F.
    """

    def __init__(self, engine, Y0: torch.Tensor, labeled: torch.Tensor,
                 F: torch.Tensor, alpha: float = 0.8, tol: float = 1e-5,
                 converged: bool = False):
        self.engine = engine
        self.alpha = alpha
        self.tol = tol
        self.Y0 = Y0
        self.labeled = labeled
        self.F = F
        self.converged_ = converged
        self.n_batches_ = 0
        self.refine_steps_ = 0

    @property
    def labels_(self) -> torch.Tensor:
        return self.F.argmax(dim=1)

    @property
    def scores_(self) -> torch.Tensor:
        return _to_scores(self.F)

    def refine(self, n_iter: int = 1) -> int:
        """Run up to ``n_iter`` warm-started training iterations; a no-op
        once converged (OOS batches are not reference columns, so a
        converged field stays converged).  Returns the steps run."""
        if self.converged_:
            return 0
        F, steps, delta = _solve(self.engine, self.Y0, self.labeled,
                                 self.alpha, n_iter, self.tol, F=self.F)
        self.F = F
        self.converged_ = delta < self.tol
        self.refine_steps_ += steps
        return steps

    def partial_fit(self, X, refine_iter: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fold a new unlabeled batch in: warm-started refinement, then the
        OOS projection.  Returns ``(labels, scores)`` for the batch rows."""
        if refine_iter:
            self.refine(refine_iter)
        Fb = self.engine.matmat(self.F, X=X, normalized=True)
        self.n_batches_ += 1
        return Fb.argmax(dim=1), _to_scores(Fb)
