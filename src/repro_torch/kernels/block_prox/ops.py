"""Proximity-block wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else.

Replaces ``repro/kernels/block_prox/ops.py::block_prox``, which downgrades
float64 to float32 for the TPU; here the kernel runs in the factors' own
type, float64 or float32 (an engine with ``dtype=np.float32``: the TPU
kernel's precision).

The kernel has two forms with the same bits.  Given a :class:`LeafIndex`
(the reference side grouped by leaf: each leaf's member columns in
ascending order, with their weights) it works in the leaf-collision form
and adds ``q·w`` only where leaves collide; without one it works in the
dense form on ``(gl_w, w)``, comparing every (row, column, tree).  The
engine builds an index once, with ``build_leaf_index``, where its leaves
are small enough (``leaf_density`` at most ``LEAF_DENSITY_MAX``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from ..._tensor import require
from .ref import block_prox_ref

__all__ = ["LeafIndex", "build_leaf_index", "leaf_density", "leaf_plan",
           "LEAF_DENSITY_MAX", "block_prox"]

# Reference columns are split into at most this many ranges, each a
# multiple of the widest tile; the index keeps a member offset per (leaf,
# range), so its size grows with the leaves, not with leaves x columns.
MAX_RANGES = 16
TILE_MAX = 1024          # float64 columns of the widest shared-memory tile
TILE_MIN = 128
ROWS = 8                 # query rows (warps) per block, as in the source
# Above this share of the reference columns met by one (query row, tree),
# the dense form is the faster one: on the H100 the leaf form took 0.19 ms
# against 0.63 at a share of 0.015 and 1.8 ms against 0.66 at 0.16 (512 x
# 50,000 x 100; PERF.md).
LEAF_DENSITY_MAX = 0.05


@dataclasses.dataclass(frozen=True)
class LeafIndex:
    """The reference side of P grouped by leaf, on one device.

    Leaf ``l`` (a global leaf id, below ``n_leaves``) has the members
    ``col[offs[l, 0]:offs[l, -1]]`` (ascending reference columns, zero
    weights left out) with weights ``w`` at the same positions, and
    ``offs[l, r]`` is its first member at or past column ``r * range_w``.
    """

    offs: torch.Tensor        # (n_leaves, n_ranges + 1) int32
    col: torch.Tensor         # (nnz,) int32
    w: torch.Tensor           # (nnz,) the factors' float64 or float32
    n_ref: int
    n_trees: int
    range_w: int

    @property
    def n_leaves(self) -> int:
        return int(self.offs.shape[0])

    @property
    def n_ranges(self) -> int:
        return int(self.offs.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.col.device

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.offs, self.col, self.w))


def _ranges(nw: int) -> Tuple[int, int]:
    """(range width, number of ranges) for ``nw`` reference columns."""
    per = max(1, math.ceil(nw / MAX_RANGES))
    width = math.ceil(per / TILE_MAX) * TILE_MAX
    return width, max(1, math.ceil(nw / width))


def build_leaf_index(gl_w: torch.Tensor, w: torch.Tensor,
                     n_leaves: int) -> LeafIndex:
    """Group the reference factors ``gl_w``/``w`` (Nw, T) by leaf.

    ``gl_w`` holds global leaf ids below ``n_leaves`` (each tree's leaves a
    disjoint range, as the engine's are).  ``w`` is float64 or float32,
    and the index keeps its type.  Torch ops on the factors' device, and
    one host read: the member count.
    """
    require(gl_w, torch.int32, "gl_w")
    require(w, _value_type(w, "w"), "w", gl_w.device)
    if gl_w.dim() != 2 or w.shape != gl_w.shape:
        raise ValueError(f"need gl_w/w (Nw, T); got {tuple(gl_w.shape)}, "
                         f"{tuple(w.shape)}")
    nw, T = gl_w.shape
    width, n_ranges = _ranges(nw)
    if n_leaves * (n_ranges + 1) >= 2 ** 31 or nw * T >= 2 ** 31:
        raise ValueError("leaf index too large for int32 offsets")
    i64 = dict(dtype=torch.int64, device=gl_w.device)
    # key = leaf·Nw + column: sorted, members come grouped by leaf and in
    # column order; zero weights sort past every leaf and are cut off
    cols = torch.arange(nw, **i64)[:, None]
    key = torch.where(w != 0, gl_w.long() * nw + cols,
                      n_leaves * nw).reshape(-1)
    key, order = torch.sort(key)
    nnz = int((w != 0).sum())
    key, order = key[:nnz], order[:nnz]
    starts = (torch.arange(n_ranges + 1, **i64) * width).clamp_max(nw)
    bounds = torch.arange(n_leaves, **i64)[:, None] * nw + starts[None, :]
    offs = torch.searchsorted(key, bounds.reshape(-1)).to(torch.int32)
    return LeafIndex(
        offs=offs.view(n_leaves, n_ranges + 1),
        col=(key % max(nw, 1)).to(torch.int32),
        w=w.reshape(-1)[order].contiguous(), n_ref=int(nw), n_trees=int(T),
        range_w=width)


def leaf_density(gl_w: torch.Tensor, w: torch.Tensor, n_leaves: int) -> float:
    """The share of the ``Nw`` reference columns that one (query row, tree)
    meets, for queries that fall into leaves as the references do: the
    size-biased mean of the leaves' nonzero-weight member counts, Σ m² /
    Σ m, over Nw.  ``gl_w`` holds global leaf ids below ``n_leaves``."""
    nw = gl_w.shape[0]
    key = torch.where(w != 0, gl_w.long(), n_leaves).reshape(-1)
    m = torch.bincount(key, minlength=n_leaves + 1)[:n_leaves].double()
    total = float(m.sum())
    return float((m * m).sum()) / total / nw if total else 0.0


def leaf_plan(n_trees: int, smem_limit: int,
              elem: int = 8) -> Tuple[int, int]:
    """(tile columns, dynamic shared bytes) of a launch over ``n_trees``
    trees with ``elem``-byte values (8 for float64, 4 for float32):
    ``ROWS`` rows of tile plus three int32 cursors per (row, tree).  The
    widest tile, from the ``TILE_MAX`` float64 columns' bytes (so twice the
    columns in float32) halving down to ``TILE_MIN`` columns, that fits
    ``smem_limit``; raises when none does."""
    state = ROWS * n_trees * 12
    tile = TILE_MAX * 8 // elem
    while tile > TILE_MIN and ROWS * tile * elem + state > smem_limit:
        tile //= 2
    smem = ROWS * tile * elem + state
    if smem > smem_limit:
        raise ValueError(f"block_prox: {n_trees} trees need {smem} bytes of "
                         f"shared memory, more than the card's {smem_limit}")
    return tile, smem


_LIB: Optional[ctypes.CDLL] = None
_SMEM: Dict[int, int] = {}
# each value type's (leaf form, dense form) entry points of the source
_ENTRY = {torch.float64: ("block_prox_leaf", "block_prox_dense"),
          torch.float32: ("block_prox_leaf_f32", "block_prox_dense_f32")}


def _value_type(t, name: str) -> torch.dtype:
    """The value type of the factor tensor ``t``: float64 or float32, else
    raise."""
    dt = getattr(t, "dtype", None)
    if not isinstance(t, torch.Tensor) or dt not in _ENTRY:
        raise TypeError(f"{name} must be a torch.float64 or torch.float32 "
                        f"tensor, got {dt if dt is not None else type(t)}")
    return dt


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("block_prox")
        for leaf, dense in _ENTRY.values():
            fn = getattr(lib, leaf)
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p] + [
                ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = getattr(lib, dense)
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _smem_limit(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMEM:
        _SMEM[idx] = int(torch.cuda.get_device_properties(idx)
                         .shared_memory_per_block_optin)
    return _SMEM[idx]


def block_prox(gl_q: torch.Tensor, q: torch.Tensor, gl_w: torch.Tensor,
               w: torch.Tensor,
               index: Optional[LeafIndex] = None) -> torch.Tensor:
    """(Nq, Nw) block P[i,j] = Σ_t q[i,t]·w[j,t]·1[gl_q[i,t] == gl_w[j,t]]
    for int32 leaf ids (Nq, T), (Nw, T) and weights of the same shapes,
    all on one device.  The weights (and ``index.w``) are all float64 or
    all float32, and the block is in their type; a mix raises.

    CPU tensors take the plain version (``index`` unused); CUDA tensors
    launch the kernel's instantiation for that type (counted in
    ``block_prox.launches`` for float64, ``block_prox.launches_f32`` for
    float32): in the leaf-collision form on ``index``, a
    :class:`LeafIndex` of ``(gl_w, w)``, or in the dense form without one.
    A failed launch raises.
    """
    dev = gl_q.device
    vt = _value_type(q, "q")
    for t, dt, name in ((gl_q, torch.int32, "gl_q"), (q, vt, "q"),
                        (gl_w, torch.int32, "gl_w"), (w, vt, "w")):
        require(t, dt, name, dev)
    if gl_q.dim() != 2 or gl_w.dim() != 2 or q.shape != gl_q.shape \
            or w.shape != gl_w.shape or gl_q.shape[1] != gl_w.shape[1]:
        raise ValueError(
            f"need gl_q/q (Nq, T) and gl_w/w (Nw, T); got {tuple(gl_q.shape)}"
            f", {tuple(q.shape)}, {tuple(gl_w.shape)}, {tuple(w.shape)}")
    if dev.type == "cpu":
        return block_prox_ref(gl_q, q, gl_w, w)
    if dev.type != "cuda":
        raise ValueError(f"block_prox runs on 'cuda' or 'cpu', got {dev}")
    nq, T = gl_q.shape
    nw = gl_w.shape[0]
    if index is not None and (index.n_ref != nw or index.n_trees != T
                              or index.device != dev):
        raise ValueError(f"index of {index.n_ref} x {index.n_trees} on "
                         f"{index.device} does not fit gl_w {(nw, T)} on "
                         f"{dev}")
    if index is not None:
        require(index.w, vt, "index.w")
    if T == 0:
        return torch.zeros((nq, nw), dtype=vt, device=dev)
    gl_q, q = gl_q.contiguous(), q.contiguous()
    out = torch.empty((nq, nw), dtype=vt, device=dev)
    lib = _lib()
    leaf_fn, dense_fn = (getattr(lib, n) for n in _ENTRY[vt])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if index is None:
            gl_w, w = gl_w.contiguous(), w.contiguous()
            err = dense_fn(
                gl_q.data_ptr(), q.data_ptr(), gl_w.data_ptr(), w.data_ptr(),
                out.data_ptr(), nq, nw, T, stream)
        else:
            tile, smem = leaf_plan(T, _smem_limit(dev), out.element_size())
            err = leaf_fn(
                gl_q.data_ptr(), q.data_ptr(), nq, T, index.offs.data_ptr(),
                index.n_leaves, index.n_ranges, index.range_w,
                index.col.data_ptr(), index.w.data_ptr(), out.data_ptr(), nw,
                tile, smem, stream)
    _build.check(lib, err, "block_prox launch")
    if vt == torch.float64:
        block_prox.launches += 1
    else:
        block_prox.launches_f32 += 1
    return out


block_prox.launches = 0
block_prox.launches_f32 = 0
