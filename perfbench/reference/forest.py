"""Plain routing of rows through a fitted forest's trees, and the per-leaf
tallies that check the fit by itself.

The trees arrive as plain arrays padded to (T, M): ``feature`` (-1 at a
leaf and in the padding), ``threshold`` (float32, in raw feature units),
``left``, ``right`` and ``leaf_id``.  A row goes left where
``x[feature] <= threshold`` (so NaN goes right).  Plain torch, no kernel.

The fit splits on bins: a row goes left where it lies at or below a
float64 quantile edge of its feature, over the training rows
(``fit_edges``), and the tree keeps that edge rounded to float32.  The
fit's own partition is found again by routing against the edge whose
float32 rounding is the stored threshold (``fit_thresholds``).
"""
from __future__ import annotations

import numpy as np


def route(torch, st: dict, X, device, chunk: int = 1 << 16, thr=None):
    """(n, T) int32 within-tree leaf ids of the rows of ``X``, against
    the stored thresholds or the float64 ``thr`` (T, M) given."""
    T = st["feature"].shape[0]
    feat = torch.as_tensor(st["feature"], device=device).long()
    thr = torch.as_tensor(st["threshold"] if thr is None else thr,
                          device=device).double()
    left = torch.as_tensor(st["left"], device=device).long()
    right = torch.as_tensor(st["right"], device=device).long()
    leaf_id = torch.as_tensor(st["leaf_id"], device=device).long()
    Xd = torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)
    tt = torch.arange(T, device=device)[None, :]
    out = []
    for i0 in range(0, Xd.shape[0], chunk):
        x = Xd[i0:i0 + chunk]
        node = torch.zeros((x.shape[0], T), dtype=torch.long, device=device)
        while True:
            f = feat[tt, node]
            internal = f >= 0
            if not bool(internal.any()):
                break
            go_left = x.gather(1, f.clamp_min(0)) <= thr[tt, node]
            nxt = torch.where(go_left, left[tt, node], right[tt, node])
            node = torch.where(internal, nxt, node)
        out.append(leaf_id[tt, node].to(torch.int32))
    return torch.cat(out)


def fit_edges(X, n_bins: int) -> np.ndarray:
    """(n_bins - 1, d) float64 quantile edges of the training rows at
    ``1/n_bins, ..., (n_bins-1)/n_bins`` (numpy's linear rule), from which
    the fit's bins are cut."""
    qs = np.linspace(0.0, 1.0, int(n_bins) + 1)[1:-1]
    return np.quantile(np.asarray(X, dtype=np.float64), qs, axis=0)


def fit_thresholds(st: dict, edges: np.ndarray):
    """(thr, unmatched): float64 (T, M) thresholds, each internal node's
    the one edge of its feature whose float32 rounding is the stored
    threshold; ``unmatched`` counts the nodes where no edge, or more than
    one distinct edge, rounds to it (those keep the stored value)."""
    feat, t32 = st["feature"], st["threshold"]
    thr = t32.astype(np.float64)
    unmatched = 0
    for f in np.unique(feat[feat >= 0]):
        at = np.nonzero(feat == f)
        e = edges[:, f]
        e32 = e.astype(np.float32)
        lo = np.searchsorted(e32, t32[at], side="left")
        hi = np.searchsorted(e32, t32[at], side="right")
        one = (hi > lo) & (e[np.minimum(lo, len(e) - 1)]
                           == e[np.maximum(hi - 1, 0)])
        thr[at[0][one], at[1][one]] = e[lo[one]]
        unmatched += int((~one).sum())
    return thr, unmatched


def global_leaves(torch, st: dict, leaves):
    off = torch.as_tensor(st["leaf_offset"], device=leaves.device)
    return (leaves.long() + off[None, :]).to(torch.int32)


def leaf_tallies(torch, st: dict, gl, y, n_classes: int):
    """Per global leaf: the in-bag weighted count of training rows, and
    (classification forests) the in-bag weighted class counts."""
    L = int(st["total_leaves"])
    inbag = torch.as_tensor(st["inbag"], device=gl.device).t().double()
    flat = gl.reshape(-1).long()
    count = torch.bincount(flat, weights=inbag.reshape(-1), minlength=L)
    if not n_classes:
        return count, None
    yy = torch.as_tensor(np.asarray(y, np.int64), device=gl.device)
    key = flat * n_classes + yy[:, None].expand_as(gl).reshape(-1)
    hist = torch.bincount(key, weights=inbag.reshape(-1),
                          minlength=L * n_classes).view(L, n_classes)
    return count, hist
