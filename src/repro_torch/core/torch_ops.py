"""SWLC products on the device via segment sums (counterpart of the
reference's ``core/jax_ops.py``).

The factored kernel apply ``P V = Q (Wᵀ V)`` becomes two dense-indexable
primitives over the (N, T) factors, with no CSR on the device:

  1. bucket:  S[leaf] = Σ_{(j,t): gl_w[j,t]=leaf} w[j,t] · V[j]   (index_add_)
  2. gather:  (P V)[i] = Σ_t q[i,t] · S[gl_q[i,t]]                  (gather)

Both are O(N·T·C) and run in the factors' dtype (float64, or float32 for
a float32 engine).  The reference computes this in plain jax (no Pallas
kernel), so plain torch ops are its counterpart here.  On the card
``index_add_`` accumulates with atomics, so the last bits of a bucket vary
from run to run; results hold to the engine's 1e-8 contract, not bitwise.
On the CPU both halves sum in a fixed order that does not depend on how
many columns V has, so a product computed a few columns at a time (an
engine under a memory budget) has the bits of the whole one.

``sharded_swlc_matmat`` is the multi-device product of the reference's
``jax_ops.sharded_swlc_matmat``: rows split over the data axis of a grid of
devices and trees over its model axis, in one process, as the reference's
``shard_map`` over local devices runs (no process group).
"""
from __future__ import annotations

from typing import Optional

import time

import numpy as np
import torch

from ..obs.metrics import global_registry

__all__ = ["swlc_matvec", "swlc_matmat", "swlc_predict", "swlc_bucket",
           "swlc_gather", "auto_t_chunk", "auto_c_chunk", "default_mesh",
           "sharded_swlc_matmat"]


def default_mesh():
    """The (n_devices, 1) data-parallel grid of the local CUDA devices, as
    a 2-D numpy array of ``torch.device``, or None below two — the gate
    for the engine's sharded product (the reference's ``default_mesh``
    over ``jax.devices()``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        return None
    return np.array([[torch.device("cuda", i)] for i in range(n)],
                    dtype=object)


def auto_t_chunk(n: int, T: int, C: int,
                 budget_elems: int = 1 << 24) -> Optional[int]:
    """Tree-chunk size keeping the (n, t_chunk, C) collision intermediate of
    the segment-sum product under ~budget elements (None = no chunking)."""
    if n * T * C <= budget_elems:
        return None
    return max(1, min(T, budget_elems // max(n * C, 1)))


def auto_c_chunk(n_local: int, T: int, C: int,
                 budget_elems: int = 1 << 24) -> Optional[int]:
    """Column-chunk size for the sharded product, whose per-shard
    (n_local, T, c_chunk) intermediate cannot tree-chunk (the bucket sum
    over the data axis spans all trees); wide V is split into column blocks
    instead (None = no chunking)."""
    if n_local * T * C <= budget_elems:
        return None
    return max(1, min(C, budget_elems // max(n_local * T, 1)))


def swlc_matvec(gl: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                v: torch.Tensor, total_leaves: int) -> torch.Tensor:
    """(P v)[i] for P = SWLC(q, w);  gl/q/w: (N, T), v: (N,)."""
    return _swlc_product(gl, q, gl, w, v[:, None], total_leaves, None)[:, 0]


def _step(T: int, t_chunk: Optional[int]) -> int:
    return T if t_chunk is None else max(1, int(t_chunk))


def swlc_bucket(gl_w: torch.Tensor, w: torch.Tensor, V: torch.Tensor,
                total_leaves: int, t_chunk: Optional[int]) -> torch.Tensor:
    """The reference half of ``P V = Q (Wᵀ V)``: the (total_leaves, C)
    bucket table ``S = Wᵀ V``, summed with ``index_add_`` over tree chunks
    of ``t_chunk`` (which bounds the (N_w, t_chunk, C) intermediate).  Each
    leaf belongs to one tree, so the chunking does not change a bucket's
    order of summation."""
    C = V.shape[1]
    step = _step(gl_w.shape[1], t_chunk)
    S = torch.zeros((total_leaves, C), dtype=V.dtype, device=V.device)
    for t0 in range(0, gl_w.shape[1], step):
        contrib = w[:, t0:t0 + step, None] * V[:, None, :]   # (N_w, t, C)
        S.index_add_(0, gl_w[:, t0:t0 + step].reshape(-1),
                     contrib.reshape(-1, C))
    return S


def swlc_gather(gl_q: torch.Tensor, q: torch.Tensor, S: torch.Tensor,
                t_chunk: Optional[int]) -> torch.Tensor:
    """The query half: ``(P V)[i] = Σ_t q[i,t] · S[gl_q[i,t]]``, summed over
    tree chunks of ``t_chunk`` on the card; on the CPU tree by tree in tree
    order (a reduction over trees would take another order for one column
    than for several)."""
    nq, T = gl_q.shape
    out = torch.zeros((nq, S.shape[1]), dtype=S.dtype, device=S.device)
    if S.device.type == "cpu":
        for t in range(T):
            out += q[:, t, None] * S[gl_q[:, t]]
        return out
    step = _step(T, t_chunk)
    for t0 in range(0, T, step):
        qq = q[:, t0:t0 + step]
        out += (qq[:, :, None] * S[gl_q[:, t0:t0 + step]]).sum(dim=1)
    return out


def _swlc_product(gl_q: torch.Tensor, q: torch.Tensor, gl_w: torch.Tensor,
                  w: torch.Tensor, V: torch.Tensor, total_leaves: int,
                  t_chunk: Optional[int]) -> torch.Tensor:
    """(P V) for P = SWLC(q, w) with query rows (gl_q, q) and reference rows
    (gl_w, w); V: (N_w, C).

    The loops are eager, so the last tree chunk is simply narrower; the
    reference's padding trees (sentinel bucket ``total_leaves``) exist only
    to give jax's ``fori_loop`` static shapes and have no counterpart here.
    """
    return swlc_gather(gl_q, q, swlc_bucket(gl_w, w, V, total_leaves,
                                            t_chunk), t_chunk)


def swlc_matmat(gl: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                V: torch.Tensor, total_leaves: int,
                t_chunk: Optional[int] = None) -> torch.Tensor:
    """(P V) for V: (N, C) — the proximity-weighted prediction primitive."""
    return _swlc_product(gl, q, gl, w, V, total_leaves, t_chunk)


def swlc_predict(gl_q, q, gl_w, w, Y, total_leaves: int,
                 t_chunk: Optional[int] = None) -> torch.Tensor:
    """OOS proximity prediction: rows = queries, refs = (gl_w, w, Y)."""
    return _swlc_product(gl_q, q, gl_w, w, Y, total_leaves, t_chunk)


def sharded_swlc_matmat(mesh, gl: torch.Tensor, q: torch.Tensor,
                        w: torch.Tensor, V: torch.Tensor,
                        total_leaves: int) -> torch.Tensor:
    """P V over a (data, model) grid of devices: rows of ``gl``/``q``/``w``
    (N, T) and of ``V`` (N, C) split evenly over data, trees over model.

    ``mesh`` is a 2-D array of ``torch.device`` (cells may repeat one
    device).  Each shard copies its (N/dp, T/mp) slice to its device and
    buckets it into a full (total_leaves, C) table; the tables are summed
    over data, each shard gathers its rows from its model column's sum, and
    the partial outputs are summed over model — the reference's two
    psums.  A sum is copies to the first cell of its row or column plus
    adds in ascending shard order, so a CPU grid gives the same bits on
    every run (on the card each bucket's ``index_add_`` atomics vary in
    the last bits, as the segment product's do).  The result is on
    ``gl``'s device.  Raises where the reference's ``shard_map`` cannot
    split evenly.  Each call is observed in ``engine_op_seconds`` and
    ``engine_op_calls_total`` (``op="sharded_matmat"``, ``backend`` the
    grid's device type) after every device of the grid has finished.
    """
    if mesh.ndim != 2:
        raise ValueError(f"mesh must be a 2-D grid of devices, got shape "
                         f"{mesh.shape}")
    dp, mp = mesh.shape
    n, T = gl.shape
    if q.shape != gl.shape or w.shape != gl.shape or V.dim() != 2 \
            or V.shape[0] != n:
        raise ValueError(f"need gl/q/w (N, T) and V (N, C); got "
                         f"{tuple(gl.shape)}, {tuple(q.shape)}, "
                         f"{tuple(w.shape)}, {tuple(V.shape)}")
    if n % dp or T % mp:
        raise ValueError(f"{n} rows x {T} trees do not split evenly over a "
                         f"{dp} x {mp} grid")
    nl, tl = n // dp, T // mp
    t0 = time.perf_counter()
    tables = [[None] * mp for _ in range(dp)]
    for a in range(dp):
        rows = slice(a * nl, (a + 1) * nl)
        for b in range(mp):
            d = mesh[a, b]
            trees = slice(b * tl, (b + 1) * tl)
            tables[a][b] = swlc_bucket(gl[rows, trees].to(d),
                                       w[rows, trees].to(d), V[rows].to(d),
                                       total_leaves, None)
    sums = []                                    # psum over data
    for b in range(mp):
        S = tables[0][b]
        for a in range(1, dp):
            S = S + tables[a][b].to(S.device)
        sums.append(S)
    parts = []                                   # gather, psum over model
    for a in range(dp):
        rows = slice(a * nl, (a + 1) * nl)
        out = None
        for b in range(mp):
            d = mesh[a, b]
            trees = slice(b * tl, (b + 1) * tl)
            o = swlc_gather(gl[rows, trees].to(d), q[rows, trees].to(d),
                            sums[b].to(d), None)
            out = o if out is None else out + o.to(out.device)
        parts.append(out.to(gl.device))
    out = torch.cat(parts, dim=0)
    for d in {mesh[a, b] for a in range(dp) for b in range(mp)} \
            | {gl.device}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    reg = global_registry()
    backend = mesh[0, 0].type
    reg.histogram("engine_op_seconds", "engine op latency (s)",
                  labels=("op", "backend", "tier")).labels(
        op="sharded_matmat", backend=backend, tier="").observe(dt)
    reg.counter("engine_op_calls_total", "engine op invocations",
                labels=("op", "backend", "tier")).labels(
        op="sharded_matmat", backend=backend, tier="").inc()
    return out
