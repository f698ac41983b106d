"""Row top-k wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else.

Each row's ``k`` largest entries of a dense block as (columns int64,
values float64), values descending and equal values by ascending column:
the engine's order for ``topk`` (``core/engine.py``).  The kernel reads the
block once and takes any ``k`` up to ``MAX_K``; the engine selects a wider
``k`` with the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from ..._tensor import require
from .ref import row_topk_ref

__all__ = ["MAX_K", "lists_per_row", "row_topk"]

MAX_K = 64               # the kernel's widest top-k (two entries a lane)
# Warps a launch puts on each SM at most: four blocks of eight, which both
# instantiations hold at once (k > 32 takes ~63 registers a thread), so the
# first stage runs in one wave.  On the H100 a 320 x 100,000 float64 block
# split 13 ways (520 blocks) took 0.090 ms and 14 ways (560 blocks, a
# second wave) 0.115 (PERF.md).
WARPS_PER_SM = 32
MIN_LIST = 2048          # elements a warp streams at least

_LIB: Optional[ctypes.CDLL] = None
_SM: Dict[int, int] = {}
_ENTRY = {torch.float64: "row_topk_f64", torch.float32: "row_topk_f32"}


def lists_per_row(rows: int, n: int, n_sm: int) -> int:
    """Slices ("lists") each row of a (rows, n) block is split over, a warp
    each: as many as keep the warps within ``WARPS_PER_SM`` on each of
    ``n_sm`` SMs, but no slice below ``MIN_LIST`` elements (at least
    one)."""
    return max(1, min(n_sm * WARPS_PER_SM // max(rows, 1), n // MIN_LIST))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("row_topk")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
                ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _n_sm(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM:
        _SM[idx] = int(torch.cuda.get_device_properties(idx)
                       .multi_processor_count)
    return _SM[idx]


def _out(t: Optional[torch.Tensor], shape, dtype, dev, name: str):
    """The caller's output ``t`` checked (rows contiguous, any row stride),
    or a new tensor."""
    if t is None:
        return torch.empty(shape, dtype=dtype, device=dev)
    require(t, dtype, name, dev)
    if tuple(t.shape) != tuple(shape) or (shape[0] > 1 and shape[1] > 1
                                          and t.stride(1) != 1):
        raise ValueError(f"{name} must be {tuple(shape)} with contiguous "
                         f"rows; got {tuple(t.shape)}, strides "
                         f"{t.stride()}")
    return t


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def row_topk(B: torch.Tensor, k: int, idx: Optional[torch.Tensor] = None,
             val: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(columns int64, values float64) of each row's ``min(k, n)`` largest
    entries of ``B`` (rows, n) in float64 or float32, values descending and
    equal values by ascending column; written into ``idx``/``val`` when
    given ((rows, min(k, n)), rows contiguous, e.g. column slices of wider
    outputs).

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    instantiation for ``B``'s type (counted in ``row_topk.launches``), or
    raise for ``k`` beyond ``MAX_K``.  A failed launch raises.
    """
    if not isinstance(B, torch.Tensor) or B.dtype not in _ENTRY:
        raise TypeError(f"B must be a torch.float64 or torch.float32 tensor,"
                        f" got {getattr(B, 'dtype', type(B))}")
    if B.dim() != 2:
        raise ValueError(f"need B (rows, n); got {tuple(B.shape)}")
    dev = B.device
    rows, n = B.shape
    kk = min(int(k), n)
    if kk < 0:
        raise ValueError(f"k must be at least 0, got {k}")
    idx = _out(idx, (rows, kk), torch.int64, dev, "idx")
    val = _out(val, (rows, kk), torch.float64, dev, "val")
    if dev.type == "cpu":
        ix, v = row_topk_ref(B, kk)
        idx.copy_(ix)
        val.copy_(v)
        return idx, val
    if dev.type != "cuda":
        raise ValueError(f"row_topk runs on 'cuda' or 'cpu', got {dev}")
    if kk > MAX_K:
        raise ValueError(f"row_topk: k = {kk} beyond the kernel's {MAX_K}")
    if rows == 0 or kk == 0:
        return idx, val
    if B.stride(1) != 1 and n > 1:
        B = B.contiguous()
    lists = lists_per_row(rows, n, _n_sm(dev))
    sv = torch.empty(rows * lists * kk, dtype=B.dtype, device=dev)
    sc = torch.empty(rows * lists * kk, dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _ENTRY[B.dtype])(
            B.data_ptr(), _row_stride(B), rows, n, kk, lists, sv.data_ptr(),
            sc.data_ptr(), idx.data_ptr(), _row_stride(idx), val.data_ptr(),
            _row_stride(val), stream)
    _build.check(lib, err, "row_topk launch")
    row_topk.launches += 1
    return idx, val


row_topk.launches = 0
