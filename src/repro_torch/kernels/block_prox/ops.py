"""Proximity-block wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else.

Replaces ``repro/kernels/block_prox/ops.py::block_prox``, which downgrades
float64 to float32 for the TPU; here the engine's float64 is kept.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..._tensor import require
from .ref import block_prox_ref

__all__ = ["block_prox"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_prox")
    lib.block_prox.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.block_prox.restype = ctypes.c_int
    return lib


def block_prox(gl_q: torch.Tensor, q: torch.Tensor, gl_w: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """(Nq, Nw) float64 block P[i,j] = Σ_t q[i,t]·w[j,t]·1[gl_q[i,t] ==
    gl_w[j,t]] for int32 leaf ids (Nq, T), (Nw, T) and float64 weights of
    the same shapes, all on one device.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``block_prox.launches``) or raise.
    """
    dev = gl_q.device
    for t, dt, name in ((gl_q, torch.int32, "gl_q"), (q, torch.float64, "q"),
                        (gl_w, torch.int32, "gl_w"), (w, torch.float64, "w")):
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
    gl_q, q, gl_w, w = (t.contiguous() for t in (gl_q, q, gl_w, w))
    nq, T = gl_q.shape
    nw = gl_w.shape[0]
    out = torch.empty((nq, nw), dtype=torch.float64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.block_prox(gl_q.data_ptr(), q.data_ptr(), gl_w.data_ptr(),
                             w.data_ptr(), out.data_ptr(), nq, nw, T, stream)
    _build.check(lib, err, "block_prox launch")
    block_prox.launches += 1
    return out


block_prox.launches = 0
