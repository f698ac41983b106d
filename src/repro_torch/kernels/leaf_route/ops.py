"""Routing wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else.

Replaces ``repro/kernels/leaf_route/ops.py::route``, which casts X to
float32 for the TPU; here X stays float64, as in the reference's default
routing, so leaves are bit-identical to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..._tensor import require
from .ref import route_ref

__all__ = ["RouteTables", "pack_nodes", "route_tables", "route_plan",
           "route"]

THREADS = 256            # threads a block, as in the source
TREES_MAX = 32           # trees a block at most (the source's RT_TREES)
STAGE_BYTES = 48 * 1024  # shared memory a block may stage samples in


def pack_nodes(ta) -> np.ndarray:
    """A ``TreeArrays``' nodes as one 16-byte int32 record each, (T·M, 4):
    the float32 threshold's bits, the feature (-1 for a leaf), and the left
    and right children as global ids ``t·M + n``; a leaf (padding included)
    keeps its leaf id in the left field and 0 in the right."""
    T, M = ta.feature.shape
    if 2 * T * M >= np.iinfo(np.int32).max:
        raise ValueError("ensemble too large for int32 node ids")
    base = (np.arange(T, dtype=np.int32) * M)[:, None]
    leaf = ta.feature < 0
    rec = np.empty((T, M, 4), dtype=np.int32)
    rec[..., 0] = np.ascontiguousarray(ta.threshold, np.float32) \
        .view(np.int32)
    rec[..., 1] = ta.feature
    rec[..., 2] = np.where(leaf, ta.leaf_id, ta.left + base)
    rec[..., 3] = np.where(leaf, 0, ta.right + base)
    return rec.reshape(T * M, 4)


@dataclasses.dataclass(frozen=True)
class RouteTables:
    """``pack_nodes`` on a device, plus the ensemble's shape."""

    nodes: torch.Tensor       # (T·M, 4) int32 node records
    n_trees: int
    max_nodes: int
    n_features: int           # 1 + the largest split feature

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def flat(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """The flat fields ``route_ref`` reads, from the records: feature
        (int32), the threshold widened to float64, the interleaved children
        ``lr`` (int32, 2·T·M) and the leaf id (int32, -1 off the leaves)."""
        nd = self.nodes
        feature = nd[:, 1].contiguous()
        threshold = nd[:, 0].contiguous().view(torch.float32).double()
        lr = nd[:, 2:4].reshape(-1).contiguous()
        leaf_id = torch.where(feature < 0, nd[:, 2], -1).to(torch.int32)
        return feature, threshold, lr, leaf_id


def route_tables(ta, device) -> RouteTables:
    """Pack a ``TreeArrays``' nodes and copy them to ``device``."""
    T, M = ta.feature.shape
    return RouteTables(
        nodes=torch.as_tensor(pack_nodes(ta), device=torch.device(device)),
        n_trees=int(T), max_nodes=int(M),
        n_features=int(ta.feature.max(initial=-1)) + 1)


def route_plan(n: int, d: int, n_trees: int,
               n_sm: int) -> Tuple[int, bool, int]:
    """(samples a block, staged, trees a block) of a launch.

    The block's samples are staged in shared memory, ``THREADS / tile``
    threads a sample, in a tile of 64 samples, or 32 when ``64 · d``
    float64 values exceed ``STAGE_BYTES``; past that (d > 192) the kernel
    reads each sample's features through L2 instead.  A block takes
    ``TREES_MAX`` trees, halved (down to 8) while the grid holds fewer than
    four blocks an SM.  (On the H100, 64 samples and 32 trees routed the
    50,000 x 100-tree acceptance forest fastest, and 16 trees a block the
    5,000-row batches; PERF.md.)
    """
    tile, staged = 64, False
    for t in (64, 32):
        if t * d * 8 <= STAGE_BYTES:
            tile, staged = t, True
            break
    tb = TREES_MAX
    while tb > 8 and \
            math.ceil(n / tile) * math.ceil(n_trees / tb) < 4 * n_sm:
        tb //= 2
    return tile, staged, tb


_LIB: Optional[ctypes.CDLL] = None
_N_SM: Dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("leaf_route")
        lib.leaf_route.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.leaf_route.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _n_sm(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = int(torch.cuda.get_device_properties(idx)
                         .multi_processor_count)
    return _N_SM[idx]


def route(X: torch.Tensor, tables: RouteTables) -> torch.Tensor:
    """(N, T) int32 within-tree leaf ids of float64 samples ``X`` (N, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``route.launches``) or raise.
    """
    if X.dim() != 2:
        raise ValueError(f"X must be (N, D), got {tuple(X.shape)}")
    if X.shape[1] < tables.n_features:
        # flat-index routing would read out of row bounds
        raise ValueError(f"X has {X.shape[1]} features but the ensemble "
                         f"splits on feature {tables.n_features - 1}")
    require(X, torch.float64, "X", tables.device)
    X = X.contiguous()
    T, M = tables.n_trees, tables.max_nodes
    if X.device.type == "cpu":
        return route_ref(X, *tables.flat(), T, M)
    if X.device.type != "cuda":
        raise ValueError(f"route runs on 'cuda' or 'cpu', got {X.device}")
    n, d = X.shape
    out = torch.empty((n, T), dtype=torch.int32, device=X.device)
    if n == 0 or T == 0:
        return out
    tile, staged, tb = route_plan(n, d, T, _n_sm(X.device))
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.leaf_route(X.data_ptr(), tables.nodes.data_ptr(),
                             out.data_ptr(), n, d, T, M,
                             tile.bit_length() - 1, tb, int(staged), stream)
    _build.check(lib, err, "leaf_route launch")
    route.launches += 1
    return out


route.launches = 0
