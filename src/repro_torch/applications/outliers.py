"""Within-class proximity outlier scores (Breiman & Cutler), on the device.

The raw outlyingness of sample i with class c = y_i is

    raw(i) = n_c / Σ_{j: y_j = c} P(i, j)²

— a point whose proximities to its own class are uniformly small gets a
large score.  Scores are then normalized per class by median/MAD so they
are comparable across classes.  The class-bucketed squared row sums come
from ``ProximityEngine.squared_row_sums`` (block-kernel row blocks, never
a dense P); the medians are exact on the device (the mean of the two middle
values of an even count, as ``np.median`` takes it; ``torch.median`` would
return the lower one).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["outlier_scores", "oos_outlier_scores", "train_outlier_stats"]

_TINY = np.finfo(np.float64).tiny


def _median(x: torch.Tensor) -> torch.Tensor:
    """``np.median`` of a 1-d tensor, as a 0-d tensor on its device."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2


def _class_stats(raw: torch.Tensor, y: torch.Tensor, n_classes: int):
    """Per-class (median, MAD) of ``raw``, (C,) each; classes without
    members keep median 0 and MAD ``tiny``."""
    med = torch.zeros(n_classes, dtype=torch.float64, device=raw.device)
    mad = torch.full((n_classes,), _TINY, dtype=torch.float64,
                     device=raw.device)
    present = torch.bincount(y, minlength=n_classes).cpu().numpy() > 0
    for c in np.flatnonzero(present):
        r = raw[y == int(c)]
        med[c] = _median(r)
        mad[c] = _median((r - med[c]).abs()).clamp_min(_TINY)
    return med, mad


def _raw_scores(engine, y: torch.Tensor, n_classes: int,
                block: int) -> torch.Tensor:
    n = y.shape[0]
    sq = engine.squared_row_sums(class_ids=y.cpu().numpy(),
                                 n_classes=n_classes, block=block)  # (N, C)
    own = sq[torch.arange(n, device=sq.device), y]    # Σ_{j∈class(i)} P²
    counts = torch.bincount(y, minlength=n_classes).to(torch.float64)
    # a zero within-class sum (possible for zero-diagonal kernels like GAP)
    # is maximal outlyingness — cap the score at n² to keep it finite
    return (counts[y] / own.clamp_min(_TINY)).clamp_max(float(n) ** 2)


def _labels(engine, y) -> torch.Tensor:
    return torch.as_tensor(np.asarray(y, dtype=np.int64),
                           device=engine.device)


def outlier_scores(engine, y, normalize: bool = True,
                   n_classes: Optional[int] = None,
                   block: int = 4096) -> torch.Tensor:
    """Per-sample within-class outlier scores on the training set, (N,)
    float64 on the engine's device.

    ``y`` holds the (N,) integer class labels of the training samples;
    ``normalize`` subtracts the class median and divides by the class MAD
    (raw scores otherwise); ``block`` is the row-chunk size of the
    squared-proximity sums.
    """
    yd = _labels(engine, y)
    if n_classes is None:
        n_classes = int(yd.max()) + 1
    raw = _raw_scores(engine, yd, n_classes, block)
    if not normalize:
        return raw
    med, mad = _class_stats(raw, yd, n_classes)
    return (raw - med[yd]) / mad[yd]


def train_outlier_stats(engine, y, n_classes: Optional[int] = None,
                        block: int = 4096) -> dict:
    """Per-class training statistics for outlier scoring, cached on the
    engine (``engine._app_cache``): class counts and the median/MAD of the
    raw training scores per class, as device tensors.  Serving calls reuse
    them, so an OOS batch never triggers a training-set pass."""
    y = np.asarray(y, dtype=np.int64)
    if n_classes is None:
        n_classes = int(y.max()) + 1
    key = ("outlier_stats", y.tobytes(), n_classes)
    hit = engine._app_cache.get(key)
    if hit is not None:
        return hit
    yd = _labels(engine, y)
    raw = _raw_scores(engine, yd, n_classes, block)
    med, mad = _class_stats(raw, yd, n_classes)
    stats = {"counts": torch.bincount(yd, minlength=n_classes)
             .to(torch.float64), "median": med, "mad": mad,
             "n_train": len(y), "n_classes": n_classes}
    engine._app_cache[key] = stats
    return stats


def oos_outlier_scores(engine, y, X, y_query=None, normalize: bool = True,
                       n_classes: Optional[int] = None, block: int = 4096,
                       return_classes: bool = False):
    """Out-of-sample outlier scores against the *training* class statistics.

    raw(x) = n_c / Σ_{j: y_j = c} P(x, j)² with c the query's class —
    ``y_query`` when given, otherwise the class maximizing the mean squared
    proximity (the densest class neighbourhood).  Normalization subtracts
    the **train** per-class median and divides by the **train** per-class
    MAD (cached by :func:`train_outlier_stats`), so OOS scores compare
    directly with the training scores.  Device tensors: the scores, and
    with ``return_classes`` the classes.
    """
    y = np.asarray(y, dtype=np.int64)
    stats = train_outlier_stats(engine, y, n_classes=n_classes, block=block)
    n_classes = stats["n_classes"]
    sq = engine.squared_row_sums(class_ids=y, n_classes=n_classes, X=X,
                                 block=block)             # (Nq, C)
    counts = stats["counts"]
    if y_query is not None:
        cls = _labels(engine, y_query)
    else:
        cls = (sq / counts.clamp_min(1.0)[None, :]).argmax(dim=1)
    own = sq[torch.arange(sq.shape[0], device=sq.device), cls]
    raw = (counts[cls] / own.clamp_min(_TINY)).clamp_max(
        float(stats["n_train"]) ** 2)
    if normalize:
        # a degenerate class MAD can push capped raw scores past float64
        # range; the cap keeps the score's meaning (maximal outlyingness)
        scores = ((raw - stats["median"][cls]) / stats["mad"][cls]) \
            .clamp_max(np.finfo(np.float64).max)
    else:
        scores = raw
    return (scores, cls) if return_classes else scores
