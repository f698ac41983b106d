"""Routing wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing else.

Replaces ``repro/kernels/leaf_route/ops.py::route``, which casts X to
float32 for the TPU; here X stays float64, as in the reference's default
routing, so leaves are bit-identical to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import torch

from .. import _build
from ..._tensor import require
from .ref import route_ref

__all__ = ["RouteTables", "route_tables", "route"]


@dataclasses.dataclass(frozen=True)
class RouteTables:
    """``TreeArrays.flat()`` on a device, plus the ensemble's shape."""

    feature: torch.Tensor     # (T·M,) int32, -1 = leaf
    threshold: torch.Tensor   # (T·M,) float64 (float32 thresholds widened)
    lr: torch.Tensor          # (2·T·M,) int32 interleaved children, global ids
    leaf_id: torch.Tensor     # (T·M,) int32
    n_trees: int
    max_nodes: int
    n_features: int           # 1 + the largest split feature

    @property
    def device(self) -> torch.device:
        return self.feature.device


def route_tables(ta, device) -> RouteTables:
    """Copy a ``TreeArrays``' flat node tables to ``device``."""
    feature_f, threshold_f, lr, leaf_f = ta.flat()
    T, M = ta.feature.shape
    dev = torch.device(device)
    return RouteTables(
        feature=torch.as_tensor(feature_f, device=dev),
        threshold=torch.as_tensor(threshold_f, device=dev),
        lr=torch.as_tensor(lr, device=dev),
        leaf_id=torch.as_tensor(leaf_f, device=dev),
        n_trees=int(T), max_nodes=int(M),
        n_features=int(ta.feature.max(initial=-1)) + 1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("leaf_route")
    lib.leaf_route.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.leaf_route.restype = ctypes.c_int
    return lib


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
        return route_ref(X, tables.feature, tables.threshold, tables.lr,
                         tables.leaf_id, T, M)
    if X.device.type != "cuda":
        raise ValueError(f"route runs on 'cuda' or 'cpu', got {X.device}")
    n, d = X.shape
    out = torch.empty((n, T), dtype=torch.int32, device=X.device)
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.leaf_route(
            X.data_ptr(), tables.feature.data_ptr(),
            tables.threshold.data_ptr(), tables.lr.data_ptr(),
            tables.leaf_id.data_ptr(), out.data_ptr(), n, d, T, M, stream)
    _build.check(lib, err, "leaf_route launch")
    route.launches += 1
    return out


route.launches = 0
