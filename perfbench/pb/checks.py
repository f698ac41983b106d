"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference works out (lower is better),
and the verdict against the cell's limits (``cells/<cell>.json``).

Relative gaps are taken per row, against the largest reference value of
that row (its first top-k value, its largest class sum); a row whose
reference is all zeros is compared absolutely.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_BIG = float(np.finfo(np.float64).max)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


def row_scale(ref: np.ndarray) -> np.ndarray:
    s = np.abs(ref).max(axis=1) if ref.ndim > 1 else np.abs(ref)
    return np.where(s > 0, s, 1.0)


def rel_gap(got, ref, scale=None) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    if not np.all(np.isfinite(got)):
        return float("inf")
    s = row_scale(ref) if scale is None else scale
    d = np.abs(got - ref)
    d = d / (s[:, None] if d.ndim > 1 else s)
    return float(d.max())


def topk_gap(idx, val, ref_P: np.ndarray, ref_val: np.ndarray) -> float:
    """The gap of one top-k answer: the larger of the program's values
    against the reference's, rank by rank, and the reference's proximity
    at each column the program chose against the reference's value at
    that rank (a wrong column shows there, a column tied with the right
    one does not)."""
    idx, val = np.asarray(idx), np.asarray(val, np.float64)
    if idx.shape != ref_val.shape:
        return float("inf")
    scale = row_scale(ref_val[:, :1])
    bad = (idx < 0) | (idx >= ref_P.shape[1])
    at = np.take_along_axis(ref_P, np.where(bad, 0, idx), axis=1)
    at = np.where(bad, np.inf, at)
    return max(rel_gap(val, ref_val, scale), rel_gap(at, ref_val, scale))


def topk_index_mismatch(idx, val, ref_P: np.ndarray, ref_idx: np.ndarray,
                        tol: float = 1e-12) -> int:
    """Ranks whose column is wrong or breaks the tie rule: where the
    program's column is not the reference's and the reference's values at
    the two differ by more than rounding (``tol`` of the row's largest),
    and where two neighbouring ranks hold values equal bit for bit in the
    program's own answer but their columns descend (equal values go by
    ascending column).  Columns whose values differ only by rounding may
    come in either order: the two sides round their sums differently."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    val = np.asarray(val)
    if idx.shape != ref_idx.shape or val.shape != idx.shape:
        return int(ref_idx.size)
    bad = (idx < 0) | (idx >= ref_P.shape[1])
    at = np.take_along_axis(ref_P, np.where(bad, 0, idx), axis=1)
    want = np.take_along_axis(ref_P, ref_idx, axis=1)
    d = np.abs(at - want) / row_scale(want[:, :1])[:, None]
    wrong = (idx != ref_idx) & (bad | (d > tol))
    ties = (val[:, 1:] == val[:, :-1]) & (idx[:, 1:] < idx[:, :-1])
    return int(wrong.sum() + ties.sum())


def route_mismatch(prog_leaves, ref_leaves) -> int:
    a, b = _np(prog_leaves), _np(ref_leaves)
    if a.shape != b.shape:
        return int(b.size)
    return int((a != b).sum())


def weight_gap(prog, ref) -> float:
    a, b = np.asarray(prog, np.float64), _np(ref).astype(np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def fit_mismatch(st: dict, count, hist, classes: bool) -> int:
    """Leaves whose stored in-bag count (and, for a classification forest,
    class histogram) differs from the reference's tally of the routed
    training rows."""
    c = _np(count)
    bad = st["leaf_count"] != c
    if classes and hist is not None:
        bad |= np.any(st["leaf_hist"] != _np(hist), axis=1)
    return int(bad.sum())


def verdict(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}); a number without a limit, or
    a limit without a number, is not correct."""
    checks = {}
    ok = set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v = values.get(name, float("inf"))
        lim = limits.get(name, float("-inf"))
        ok = ok and bool(np.isfinite(v)) and v <= lim
        # printed as a JSON number: a missing or infinite gap reads as the
        # largest float
        checks[name] = {"value": float(np.nan_to_num(v, nan=_BIG,
                                                     posinf=_BIG)),
                        "limit": float(lim) if np.isfinite(lim) else -_BIG}
    return ok, checks
