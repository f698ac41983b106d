"""Collision wrappers: the CUDA kernels for CUDA tensors, the plain versions
for CPU tensors, and nothing else.

The collision path (``core/collide.py``) enumerates each row block's
products with :func:`collide_enumerate`, in the order of the key ``row ·
n_ref + column`` with a pair's products in ascending tree order (the kernel
writes each product at its rank in the merge of its row's leaf lists; the
plain version sorts), and hands them to the pair
wrappers.  :func:`pair_topk` writes each row's exact top-k (values
descending, equal values by ascending column, a row holding fewer than
``k`` pairs filled with value 0 at the smallest columns it does not hold);
:func:`pair_sums` each row's squared pair values summed by class in column
order.  Kernel and plain version give a pair's value the same bits (unfused
adds in tree order), so their top-k agree bit for bit; the class sums add
in column order from 0 in both, bit for bit on the CPU's plain version.  On
the card a row of more than :func:`split_products` products is split over
several warps: for the top-k each slice keeps its own list and a second
launch merges them (the order is total, so the answer is the same); for the
sums each slice writes its pairs' squares and classes, and a second launch
adds them a lane a class in column order (the same adds).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..._tensor import require
from .ref import collide_enumerate_ref, pair_sums_ref, pair_topk_ref

__all__ = ["MAX_K", "ENUM_SPLIT", "split_products", "collide_enumerate",
           "pair_topk", "pair_sums"]

MAX_K = 64               # the kernel's widest top-k (two entries a lane)
# Products a warp takes of a row: a launch lasts as long as its longest
# warp, and in the million-row deployment a block's longest row (about
# 20,000 products) alone took 60-80% of its top-k and sums in one warp on
# the H100; slices of 1,024 products took 6% off a block's sums and 15%
# off its top-k against slices of 2,048 there.
SPLIT = 1024
# Products a warp of the enumeration takes: a launch lasts as long as its
# longest warp, and a row in large pure leaves searches long lists for each
# product; in the million-row deployment on the H100 an op's enumeration
# took 70 ms in slices of 1,024 products, 37 in slices of 256, 32 in slices
# of 128 and 32 in slices of 64.
ENUM_SPLIT = 128

_LIB: Optional[ctypes.CDLL] = None
_TOPK = {torch.float64: "collide_topk_f64", torch.float32: "collide_topk_f32"}
_SUMS = {torch.float64: "collide_sums_f64", torch.float32: "collide_sums_f32"}
_ENUM = {torch.float64: "collide_enumerate_f64",
         torch.float32: "collide_enumerate_f32"}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("collide")
        for name in _TOPK.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
                ctypes.c_int] * 2 + [ctypes.c_longlong] + [
                ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in _SUMS.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong] + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        for name in _ENUM.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
                ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
                ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_products(key: torch.Tensor, prod: torch.Tensor) -> None:
    require(key, torch.int64, "key")
    if not isinstance(prod, torch.Tensor) or prod.dtype not in _TOPK:
        raise TypeError(f"prod must be a torch.float64 or torch.float32 "
                        f"tensor, got {getattr(prod, 'dtype', type(prod))}")
    require(prod, prod.dtype, "prod", key.device)
    if key.dim() != 1 or prod.shape != key.shape:
        raise ValueError(f"need key and prod (n,); got {tuple(key.shape)}, "
                         f"{tuple(prod.shape)}")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def split_products(depth: int) -> int:
    """Rows with more products than this are split over warps on the card:
    ``SPLIT``, or ``MAX_K`` times ``depth`` (the most products of a pair)
    where that is more, so a split row holds at least ``MAX_K`` pairs."""
    return max(SPLIT, MAX_K * int(depth))


def collide_enumerate(index, gl_q: torch.Tensor, q: torch.Tensor,
                      row_start: torch.Tensor, n_products: int):
    """(key int64, prod), each (n_products,): every product ``q_t(i) ·
    w_t(j)`` of the block's query rows ``gl_q``/``q`` (n, T) against the
    leaf index ``index`` (a ``LeafIndex``), with its key ``i · n_ref + j``
    (rows the block's own, from 0), in key order, a pair's products in
    ascending tree order.  ``row_start`` (n + 1,) int64 holds the rows'
    cumulative product counts on the index's device (the block's slice of
    the engine's; its first need not be 0) and ``n_products`` their total
    (from the host's copy).  CPU tensors take the plain version (which
    needs no ``row_start``); CUDA tensors launch the kernel, a warp every
    ``ENUM_SPLIT`` products of a row (counted in
    ``collide_enumerate.launches``), which reads nothing back to the
    host."""
    dev, dtype = index.col.device, index.w.dtype
    if dtype not in _ENUM:
        raise TypeError(f"the index's weights must be torch.float64 or "
                        f"torch.float32, got {dtype}")
    require(index.offs, torch.int32, "index.offs", dev)
    require(index.col, torch.int32, "index.col", dev)
    require(gl_q, torch.int32, "gl_q", dev)
    require(q, dtype, "q", dev)
    require(row_start, torch.int64, "row_start", dev)
    n = gl_q.shape[0]
    if gl_q.dim() != 2 or q.shape != gl_q.shape or \
            row_start.shape != (n + 1,):
        raise ValueError(f"need gl_q/q (n, T) and row_start (n + 1,); got "
                         f"{tuple(gl_q.shape)}, {tuple(q.shape)}, "
                         f"{tuple(row_start.shape)}")
    if n_products < 0:
        raise ValueError(f"n_products must be >= 0, got {n_products}")
    if dev.type == "cpu":
        return collide_enumerate_ref(index, gl_q, q, n_products)
    if dev.type != "cuda":
        raise ValueError(f"collide_enumerate runs on 'cuda' or 'cpu', got "
                         f"{dev}")
    key = torch.empty(n_products, dtype=torch.int64, device=dev)
    prod = torch.empty(n_products, dtype=dtype, device=dev)
    if n == 0 or n_products == 0:
        return key, prod
    gl_q, q, lib = gl_q.contiguous(), q.contiguous(), _lib()
    offs, row_start = index.offs.contiguous(), row_start.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _ENUM[dtype])(
            offs.data_ptr(), offs.shape[1], index.col.data_ptr(),
            index.w.data_ptr(), gl_q.data_ptr(), q.data_ptr(), gl_q.shape[1],
            n, row_start.data_ptr(), n_products, index.n_ref, ENUM_SPLIT,
            key.data_ptr(), prod.data_ptr(), stream)
    _build.check(lib, err, "collide_enumerate launch")
    collide_enumerate.launches += 1
    return key, prod


def pair_topk(key: torch.Tensor, prod: torch.Tensor, n_ref: int, rows: int,
              depth: int, idx: torch.Tensor, val: torch.Tensor) -> None:
    """Write each of ``rows`` rows' ``kk = idx.shape[1]`` (at most
    ``n_ref``) largest pair values into ``val`` (float64) and their columns
    into ``idx`` (int64), both (rows, kk) with contiguous rows.  ``depth``
    bounds a pair's products (the plain version's loop).  CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted in
    ``pair_topk.launches``), or raise for ``kk`` beyond ``MAX_K``."""
    _check_products(key, prod)
    dev, kk = key.device, idx.shape[1]
    require(idx, torch.int64, "idx", dev)
    require(val, torch.float64, "val", dev)
    if idx.shape != (rows, kk) or val.shape != (rows, kk) or kk > n_ref:
        raise ValueError(f"need idx/val ({rows}, k <= {n_ref}); got "
                         f"{tuple(idx.shape)}, {tuple(val.shape)}")
    if dev.type == "cpu":
        return pair_topk_ref(key, prod, n_ref, rows, depth, idx, val)
    if dev.type != "cuda":
        raise ValueError(f"pair_topk runs on 'cuda' or 'cpu', got {dev}")
    if kk > MAX_K:
        raise ValueError(f"pair_topk: k = {kk} beyond the kernel's {MAX_K}")
    if rows == 0 or kk == 0:
        return None
    key, prod, lib = key.contiguous(), prod.contiguous(), _lib()
    split = split_products(depth)
    # the lists of a split row's slices: a row's first, then a segment's
    lists = (rows + -(-key.numel() // split)) * kk
    sv = torch.empty(lists, dtype=prod.dtype, device=dev)
    sc = torch.empty(lists, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _TOPK[prod.dtype])(
            key.data_ptr(), prod.data_ptr(), key.numel(), n_ref, rows, kk,
            split, sv.data_ptr(), sc.data_ptr(), idx.data_ptr(),
            _row_stride(idx), val.data_ptr(), _row_stride(val), stream)
    _build.check(lib, err, "pair_topk launch")
    pair_topk.launches += 1
    return None


def pair_sums(key: torch.Tensor, prod: torch.Tensor, n_ref: int, rows: int,
              depth: int, class_of: Optional[torch.Tensor], n_classes: int,
              out: torch.Tensor) -> None:
    """Write each of ``rows`` rows' Σ_j P(i, j)², by the class
    ``class_of[j]`` (int64, or None for one class), into ``out`` (rows ·
    n_classes,) in ``prod``'s dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``pair_sums.launches``)."""
    _check_products(key, prod)
    dev, C = key.device, 1 if class_of is None else int(n_classes)
    require(out, prod.dtype, "out", dev)
    if class_of is not None:
        require(class_of, torch.int64, "class_of", dev)
    if out.shape != (rows * C,):
        raise ValueError(f"need out ({rows * C},); got {tuple(out.shape)}")
    if dev.type == "cpu":
        return pair_sums_ref(key, prod, n_ref, rows, depth, class_of, C,
                             out)
    if dev.type != "cuda":
        raise ValueError(f"pair_sums runs on 'cuda' or 'cpu', got {dev}")
    if rows == 0:
        return None
    key, prod, lib = key.contiguous(), prod.contiguous(), _lib()
    if class_of is not None:
        class_of = class_of.contiguous()
    n, split = key.numel(), split_products(depth)
    # a split row's pairs: squares and classes, and their count a slice
    pv = torch.empty(n, dtype=prod.dtype, device=dev)
    pc = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty(rows + -(-n // split), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _SUMS[prod.dtype])(
            key.data_ptr(), prod.data_ptr(), n, n_ref, rows,
            None if class_of is None else class_of.data_ptr(), C, split,
            pv.data_ptr(), pc.data_ptr(), count.data_ptr(), out.data_ptr(),
            stream)
    _build.check(lib, err, "pair_sums launch")
    pair_sums.launches += 1
    return None


collide_enumerate.launches = 0
pair_topk.launches = 0
pair_sums.launches = 0
