"""Plain PyTorch versions of the split-histogram kernels, and their
ordered numpy oracles.

The plain versions are the scatter form of the reference's
``kernels/histogram/ref.py``: a flat (node, feature, bin[, class]) index
per (sample, feature) pair and one ``index_add_`` of the broadcast weights
into a float32 table.  Their adds run in no fixed order, so they equal the
kernels only where every order gives the same sum (integer payloads).

The ordered oracles (``histogram_ordered``, ``moments_ordered``) add in
the order the kernels' contract fixes: float32 ``np.add.at`` over each
work item's samples in sample order, then each cut node's partial rows
summed in segment order from 0.  They give the kernels' bits on every
payload, continuous ones included.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["histogram_ref", "moments_ref", "histogram_ordered",
           "moments_ordered"]


def _flat_bins(xb: torch.Tensor, node: torch.Tensor, n_bins: int
               ) -> torch.Tensor:
    """(N, D) int64 index of each (sample, feature) pair's (node, feature,
    bin) slot."""
    d = xb.shape[1]
    feat = torch.arange(d, device=xb.device)
    return (node.long()[:, None] * d + feat[None, :]) * n_bins + xb.long()


def histogram_ref(xb: torch.Tensor, node: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor, n_nodes: int, n_bins: int,
                  n_classes: int) -> torch.Tensor:
    """Weighted class histograms per (node, feature, bin).

    xb (N, D) integer bin codes, node (N,) node slot in [0, n_nodes),
    y (N,) class in [0, n_classes), w (N,) float32 weights; returns
    (n_nodes, D, n_bins, n_classes) float32.
    """
    n, d = xb.shape
    flat = _flat_bins(xb, node, n_bins) * n_classes + y.long()[:, None]
    out = torch.zeros(n_nodes * d * n_bins * n_classes, dtype=torch.float32,
                      device=xb.device)
    out.index_add_(0, flat.reshape(-1),
                   w.float()[:, None].expand(n, d).reshape(-1))
    return out.reshape(n_nodes, d, n_bins, n_classes)


def moments_ref(xb: torch.Tensor, node: torch.Tensor, wm: torch.Tensor,
                n_nodes: int, n_bins: int, n_mom: int) -> torch.Tensor:
    """Payload-sum histograms per (node, feature, bin, moment).

    wm (N, n_mom) float32 payload columns (the trainer's w, w·y, w·y²);
    returns (n_nodes, D, n_bins, n_mom) float32.
    """
    n, d = xb.shape
    flat = _flat_bins(xb, node, n_bins)
    out = torch.zeros((n_nodes * d * n_bins, n_mom), dtype=torch.float32,
                      device=xb.device)
    out.index_add_(0, flat.reshape(-1),
                   wm.float()[:, None, :].expand(n, d, n_mom)
                   .reshape(-1, n_mom))
    return out.reshape(n_nodes, d, n_bins, n_mom)


def _ordered(flat: np.ndarray, vals: np.ndarray, items: np.ndarray,
             red: np.ndarray, n_nodes: int, width: int) -> np.ndarray:
    """Per-item float32 sums of ``vals`` rows into ``flat`` slots (``-1``
    adds nothing), each in sample order; then the cut nodes' partial rows
    in segment order.  flat (m, D) int64, vals (m, K) float32; returns
    (n_nodes, width, K)."""
    k = vals.shape[1]
    n_rows = max(n_nodes, int(items[:, 2].max(initial=-1)) + 1)
    out = np.zeros((n_rows, width, k), np.float32)
    for s, e, row in items:
        f = flat[s:e]
        ok = f >= 0                               # (samples, D), row-major
        v = np.broadcast_to(vals[s:e, None, :], f.shape + (k,))
        np.add.at(out[row], f[ok], v[ok])
    for node, first, count in red:
        acc = np.zeros((width, k), np.float32)
        for s in range(count):
            acc += out[first + s]
        out[node] = acc
    return out[:n_nodes]


def histogram_ordered(xb: np.ndarray, y: np.ndarray, w: np.ndarray,
                      items: np.ndarray, red: np.ndarray, n_nodes: int,
                      n_bins: int, n_classes: int) -> np.ndarray:
    """The class histograms in the kernels' order (module docstring).

    xb (m, D) codes of the samples in node order, y (m,) labels, w (m,)
    weights; ``items``/``red`` the plan of ``ops.work_items`` over the
    node bounds.  Codes outside [0, n_bins) and labels outside
    [0, n_classes) add nothing.  Returns (n_nodes, D, n_bins, n_classes)
    float32.
    """
    xb = np.asarray(xb).astype(np.int64)
    y = np.asarray(y).astype(np.int64)
    d = xb.shape[1]
    ok = (xb >= 0) & (xb < n_bins) & ((y >= 0) & (y < n_classes))[:, None]
    flat = np.where(ok, (np.arange(d) * n_bins + xb) * n_classes
                    + y[:, None], -1)
    out = _ordered(flat, np.asarray(w, np.float32)[:, None], items, red,
                   n_nodes, d * n_bins * n_classes)
    return out.reshape(n_nodes, d, n_bins, n_classes)


def moments_ordered(xb: np.ndarray, wm: np.ndarray, items: np.ndarray,
                    red: np.ndarray, n_nodes: int, n_bins: int
                    ) -> np.ndarray:
    """The payload sums in the kernels' order: wm (m, K) float32 payload
    columns; otherwise as :func:`histogram_ordered`.  Returns (n_nodes, D,
    n_bins, K) float32."""
    xb = np.asarray(xb).astype(np.int64)
    wm = np.asarray(wm, np.float32)
    d = xb.shape[1]
    flat = np.where((xb >= 0) & (xb < n_bins),
                    np.arange(d) * n_bins + xb, -1)
    out = _ordered(flat, wm, items, red, n_nodes, d * n_bins)
    return out.reshape(n_nodes, d, n_bins, wm.shape[1])
