"""Plain PyTorch version of the row top-k kernel.

Each row's entries sorted by value, descending, with a stable sort: columns
come in ascending order, so equal values keep it.  That is a lexsort on
(-value, column), the order the kernel keeps, at ``n log n`` a row.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["row_topk_ref"]


def row_topk_ref(B: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(columns int64, values float64) of each row's ``min(k, n)`` largest
    entries of ``B`` (rows, n), values descending and equal values by
    ascending column."""
    v, ix = torch.sort(B, dim=1, descending=True, stable=True)
    kk = min(k, B.shape[1])
    return ix[:, :kk], v[:, :kk].to(torch.float64)
