"""Plain PyTorch versions of the split-histogram kernels.

The scatter form of the reference's ``kernels/histogram/ref.py``: a flat
(node, feature, bin[, class]) index per (sample, feature) pair and one
``index_add_`` of the broadcast weights into a float32 table.
"""
from __future__ import annotations

import torch

__all__ = ["histogram_ref", "moments_ref"]


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
