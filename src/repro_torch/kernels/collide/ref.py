"""Plain PyTorch versions of the collision kernels.

:func:`collide_enumerate_ref` enumerates one row block's products from the
leaf index, row-major (row, tree, member), and sorts them by the key ``row
· n_ref + column`` with a stable sort, so a pair's products stay in
ascending tree order: the order the enumeration kernel writes them in.

One row block's products, sorted by the key ``row · n_ref + column`` (a
pair's products in ascending tree order), are added per pair from its
first, one elementwise fused multiply-add a tree rank over every product
(the multiplier is 1.0 where the product ``r`` places on is the same
pair's, 0.0 elsewhere, so each add rounds once, as the kernel's unfused
add does).  Then every array keeps one entry a product, a pair's later
entries passed over, so nothing is read back to the host:

- :func:`pair_topk_ref`: pairs by row, then value descending, equal values
  by ascending column (two stable sorts); each row's first ``kk`` over a
  fill of the smallest columns it does not hold, with value 0;
- :func:`pair_sums_ref`: one ``segment_reduce`` a (row, class), columns
  ascending (a stable sort), and one segment past them for the other
  entries.
"""
from __future__ import annotations

import torch

__all__ = ["collide_enumerate_ref", "pair_topk_ref", "pair_sums_ref"]


def collide_enumerate_ref(index, gl_q: torch.Tensor, q: torch.Tensor,
                          n_products: int):
    """(key, prod), one entry a product of the block's rows: ``key`` = row
    · n_ref + column (rows the block's own, from 0) sorted, ``prod`` the
    products ``q·w`` in that order, a pair's in ascending tree order."""
    dev = gl_q.device
    i64 = dict(dtype=torch.int64, device=dev)
    n, T = gl_q.shape
    leaf = gl_q.reshape(-1).long()                    # row-major: trees up
    start = index.offs[leaf, 0].long()
    cnt = torch.where(q.reshape(-1) != 0, index.offs[leaf, -1].long() - start,
                      0)
    rep = torch.repeat_interleave(torch.arange(n * T, **i64), cnt,
                                  output_size=n_products)
    pos = torch.arange(n_products, **i64) + \
        (start - (torch.cumsum(cnt, 0) - cnt))[rep]
    key = (rep // T) * index.n_ref + index.col[pos].long()
    prod = q.reshape(-1)[rep] * index.w[pos]
    del rep, pos, leaf, start, cnt
    # stable: each (row, column)'s products stay in ascending tree order
    key, order = torch.sort(key, stable=True)
    return key, prod[order]


def _pairs(key: torch.Tensor, prod: torch.Tensor, n_ref: int, depth: int):
    """(rows, cols, values, head), one entry a product: ``head`` marks each
    pair's first product, whose entry holds the pair's value."""
    n = key.numel()
    head = torch.ones(n, dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    val = prod.clone()
    same = (~head[1:]).to(prod.dtype)
    for r in range(1, min(depth, n)):
        val[:-r].addcmul_(same, prod[r:])
        same = same[:-1] * same[1:]
    return key // n_ref, key % n_ref, val, head


def pair_topk_ref(key: torch.Tensor, prod: torch.Tensor, n_ref: int,
                  rows: int, depth: int, idx: torch.Tensor,
                  val: torch.Tensor) -> None:
    """Each of the block's ``rows`` rows' ``kk = idx.shape[1]`` largest pair
    values (float64) and their columns, written into ``idx``/``val``;
    ``depth`` bounds the products of a pair."""
    dev, kk = key.device, idx.shape[1]
    i64 = dict(dtype=torch.int64, device=dev)
    r, c, v, head = _pairs(key, prod, n_ref, depth)
    n = key.numel()
    width = min(2 * kk, n_ref)
    v = torch.where(head, v, float("-inf"))
    o = torch.sort(v, descending=True, stable=True).indices
    o = o[torch.sort(r[o], stable=True).indices]
    r, c, v, head = r[o], c[o], v[o], head[o]
    held = torch.zeros(rows, **i64).scatter_add_(0, r, head.long())
    every = torch.zeros(rows, **i64).scatter_add_(0, r, torch.ones_like(r))
    rank = torch.arange(n, **i64) - (torch.cumsum(every, 0) - every)[r]
    # the fill: the smallest columns a row does not hold, ascending
    taken = torch.zeros(rows * width + 1, dtype=torch.bool, device=dev)
    taken.scatter_(0, torch.where(head & (c < width), r * width + c,
                                  rows * width), True)
    free = torch.sort(torch.where(taken[:-1].view(rows, width), width,
                                  torch.arange(width, device=dev)),
                      dim=1).values
    at = (torch.arange(kk, **i64)[None, :]
          - held.clamp_max(kk)[:, None]).clamp_min(0)
    # then each row's first kk pairs over the fill, one write each
    dst = torch.where(head & (rank < kk), r * kk + rank, rows * kk)
    bi = torch.empty(rows * kk + 1, **i64)
    bi[:-1] = free.gather(1, at).view(-1)
    bi.scatter_(0, dst, c)
    bv = torch.zeros(rows * kk + 1, dtype=torch.float64, device=dev)
    bv.scatter_(0, dst, v.to(torch.float64))
    idx.copy_(bi[:-1].view(rows, kk))
    val.copy_(bv[:-1].view(rows, kk))


def pair_sums_ref(key: torch.Tensor, prod: torch.Tensor, n_ref: int,
                  rows: int, depth: int, class_of, n_classes: int,
                  out: torch.Tensor) -> None:
    """Each row's Σ_j P(i, j)², by the class ``class_of[j]`` (int64 on the
    device, or None: one class), written into ``out`` (rows · n_classes,)
    in the products' dtype."""
    r, c, v, head = _pairs(key, prod, n_ref, depth)
    C = int(n_classes)
    seg = r if class_of is None else r * C + class_of[c]
    seg, o = torch.sort(torch.where(head, seg, rows * C), stable=True)
    size = torch.zeros(rows * C + 1, dtype=torch.int64, device=key.device)
    size.scatter_add_(0, seg, torch.ones_like(seg))
    out.copy_(torch.segment_reduce((v * v)[o], "sum", lengths=size,
                                   unsafe=True)[:-1])
