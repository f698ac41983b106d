"""Train-side all-pairs ops over leaf collisions: each row's exact top-k and
its squared row sums, without writing a dense block of P.

A training row meets few reference columns in a deep forest with small
leaves: in each tree where its query weight is nonzero, the members of its
leaf.  For a block of query rows every such product ``q_t(i)·w_t(j)`` is
enumerated from the engine's leaf index
(``kernels/block_prox/ops.py::LeafIndex``: each leaf's nonzero-weight
members, columns ascending) in the order of the key ``row · n_ref +
column``, each pair's products in ascending tree order
(``kernels/collide/ops.py::collide_enumerate``: on the card a kernel that
writes each product at its rank in the merge of its row's leaf lists, from
the rows' cumulative products on the device; on the CPU its plain version,
a row-major enumeration and a stable sort).  The collision-pair kernel
(``kernels/collide``, its plain version on the CPU) then adds each pair's
products in that order from 0.0, unfused, so P(i, j) is the same sum
whatever else the block holds, and reduces the pairs:

- :func:`topk`: each row's pairs by value descending, equal values by
  ascending column, the first ``k`` kept; a row holding fewer than ``k``
  is filled with value 0 at the smallest columns it does not hold, as the
  dense path returns it (an all-zero row: columns ``0..k-1``);
- :func:`squared_row_sums`: Σ_j P(i, j)² per row, or per (row, class of
  j), added in column order.

The dense plain version (``block_prox_ref``) adds in the same order, so on
the CPU the two paths agree bit for bit; the CUDA block kernel fuses each
add into an fma, so on the card they differ in the last bits where a pair
collides in more than one tree.  A row's answer depends on its own
products only, so neither the block height nor a memory budget changes a
bit.  Blocks are cut by the products they hold (:func:`row_blocks`, from
the rows' cumulative product counts the engine keeps on the host, and a
copy of them on the device), so their transients stay within a cap, and
the host reads nothing back and copies nothing over in the block loop.

With regions on (``obs.trace.set_regions``), ``engine.collide`` marks each
block's enumeration, ``engine.collide_select`` its pair values and
top-k, and ``engine.collide_sums`` its pair values and sums.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.collide.ops import collide_enumerate, pair_sums, pair_topk
from ..obs.trace import region

__all__ = ["row_products", "row_blocks", "topk", "squared_row_sums"]

# Device bytes a block holds at its peak per enumerated product (the plain
# enumeration's indices and values, the sort's keys, order and scratch; the
# kernel's keys and values take less) and per row (the top-k's fill
# candidates and block outputs at k up to ~40).
PRODUCT_BYTES = 96
ROW_BYTES = 1024
# Rows a time when counting each row's products (an (rows, T) gather).
_COUNT_ROWS = 1 << 16


def row_products(members: torch.Tensor, gl_q: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """(n,) int64: the products each query row enumerates, Σ_t [q_t ≠ 0] ·
    members[gl_t], for the leaves' member counts ``members``
    (``kernels/block_prox/ops.py::leaf_members``)."""
    out = torch.empty(gl_q.shape[0], dtype=torch.int64, device=gl_q.device)
    for i0 in range(0, gl_q.shape[0], _COUNT_ROWS):
        g, v = gl_q[i0:i0 + _COUNT_ROWS], q[i0:i0 + _COUNT_ROWS]
        out[i0:i0 + g.shape[0]] = torch.where(v != 0, members[g.long()],
                                              0).sum(dim=1)
    return out


def row_blocks(cum: np.ndarray, cap_bytes: int) -> List[Tuple[int, int]]:
    """Row blocks ``[(i0, i1), ...]`` covering ``len(cum) - 1`` rows, each
    holding at most ``cap_bytes`` (at least one row) by ``PRODUCT_BYTES``
    a product and ``ROW_BYTES`` a row, from the cumulative product counts
    ``cum`` (``cum[i]``: the products of the rows before row i)."""
    cost = cum * PRODUCT_BYTES + np.arange(len(cum)) * ROW_BYTES
    n, out, i0 = len(cum) - 1, [], 0
    while i0 < n:
        i1 = int(np.searchsorted(cost, cost[i0] + cap_bytes,
                                 side="right")) - 1
        i1 = min(max(i1, i0 + 1), n)
        out.append((i0, i1))
        i0 = i1
    return out


def topk(index, gl_q: torch.Tensor, q: torch.Tensor, cum: np.ndarray,
         row_start: torch.Tensor, blocks, depth: int,
         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices int64, values float64), each (n, k): every query row's ``k``
    largest proximities, values descending and equal values by ascending
    column (ranks past the reference count read column 0, value 0), over
    the row ``blocks`` of :func:`row_blocks` on ``cum`` (``row_start``:
    ``cum`` as an int64 tensor on the index's device); ``depth`` bounds the
    trees of a pair (the most nonzero query weights of a row)."""
    n, dev = gl_q.shape[0], gl_q.device
    kk = min(k, index.n_ref)
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    val = torch.zeros((n, k), dtype=torch.float64, device=dev)
    for i0, i1 in blocks:
        with region("engine.collide"):
            key, prod = collide_enumerate(
                index, gl_q[i0:i1], q[i0:i1], row_start[i0:i1 + 1],
                int(cum[i1] - cum[i0]))
        with region("engine.collide_select"):
            pair_topk(key, prod, index.n_ref, i1 - i0, depth,
                      idx[i0:i1, :kk], val[i0:i1, :kk])
    return idx, val


def squared_row_sums(index, gl_q: torch.Tensor, q: torch.Tensor,
                     cum: np.ndarray, row_start: torch.Tensor, blocks,
                     depth: int,
                     class_of: Optional[torch.Tensor] = None,
                     n_classes: Optional[int] = None) -> torch.Tensor:
    """Σ_j P(i, j)² per query row, (n,); with ``class_of`` (the reference
    columns' int64 classes on the device), per (row, class), (n,
    n_classes); in the factors' dtype, over the row ``blocks`` of
    :func:`row_blocks` on ``cum`` (``row_start`` as in :func:`topk`)."""
    n, dev = gl_q.shape[0], gl_q.device
    C = 1 if class_of is None else int(n_classes)
    out = torch.zeros(n * C, dtype=index.w.dtype, device=dev)
    for i0, i1 in blocks:
        with region("engine.collide"):
            key, prod = collide_enumerate(
                index, gl_q[i0:i1], q[i0:i1], row_start[i0:i1 + 1],
                int(cum[i1] - cum[i0]))
        with region("engine.collide_sums"):
            pair_sums(key, prod, index.n_ref, i1 - i0, depth, class_of, C,
                      out[i0 * C:i1 * C])
    return out if class_of is None else out.view(n, C)
