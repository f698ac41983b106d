"""SWLC products on the device via segment sums (counterpart of the
reference's ``core/jax_ops.py``).

The factored kernel apply ``P V = Q (Wᵀ V)`` becomes two dense-indexable
primitives over the (N, T) factors, with no CSR on the device:

  1. bucket:  S[leaf] = Σ_{(j,t): gl_w[j,t]=leaf} w[j,t] · V[j]   (index_add_)
  2. gather:  (P V)[i] = Σ_t q[i,t] · S[gl_q[i,t]]                  (gather)

Both are O(N·T·C) and run in float64.  The reference computes this in plain
jax (no Pallas kernel), so plain torch ops are its counterpart here.  On the
card ``index_add_`` accumulates with atomics, so the last bits of a bucket
vary from run to run; results hold to the engine's 1e-8 contract, not
bitwise.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["swlc_matvec", "swlc_matmat", "swlc_predict", "auto_t_chunk"]


def auto_t_chunk(n: int, T: int, C: int,
                 budget_elems: int = 1 << 24) -> Optional[int]:
    """Tree-chunk size keeping the (n, t_chunk, C) collision intermediate of
    the segment-sum product under ~budget elements (None = no chunking)."""
    if n * T * C <= budget_elems:
        return None
    return max(1, min(T, budget_elems // max(n * C, 1)))


def swlc_matvec(gl: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                v: torch.Tensor, total_leaves: int) -> torch.Tensor:
    """(P v)[i] for P = SWLC(q, w);  gl/q/w: (N, T), v: (N,)."""
    return _swlc_product(gl, q, gl, w, v[:, None], total_leaves, None)[:, 0]


def _swlc_product(gl_q: torch.Tensor, q: torch.Tensor, gl_w: torch.Tensor,
                  w: torch.Tensor, V: torch.Tensor, total_leaves: int,
                  t_chunk: Optional[int]) -> torch.Tensor:
    """(P V) for P = SWLC(q, w) with query rows (gl_q, q) and reference rows
    (gl_w, w); V: (N_w, C).

    ``t_chunk`` bounds the dense (N, t_chunk, C) intermediate: both the
    bucket and the gather stage run over tree chunks.  The loop is eager,
    so the last chunk is simply narrower; the reference's padding trees
    (sentinel bucket ``total_leaves``) exist only to give jax's
    ``fori_loop`` static shapes and have no counterpart here.
    """
    nq, T = gl_q.shape
    C = V.shape[1]
    step = T if t_chunk is None else max(1, int(t_chunk))
    S = torch.zeros((total_leaves, C), dtype=torch.float64, device=V.device)
    for t0 in range(0, T, step):
        ww = w[:, t0:t0 + step]
        contrib = ww[:, :, None] * V[:, None, :]             # (N_w, t, C)
        S.index_add_(0, gl_w[:, t0:t0 + step].reshape(-1),
                     contrib.reshape(-1, C))
    out = torch.zeros((nq, C), dtype=torch.float64, device=V.device)
    for t0 in range(0, T, step):
        qq = q[:, t0:t0 + step]
        out += (qq[:, :, None] * S[gl_q[:, t0:t0 + step]]).sum(dim=1)
    return out


def swlc_matmat(gl: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                V: torch.Tensor, total_leaves: int,
                t_chunk: Optional[int] = None) -> torch.Tensor:
    """(P V) for V: (N, C) — the proximity-weighted prediction primitive."""
    return _swlc_product(gl, q, gl, w, V, total_leaves, t_chunk)


def swlc_predict(gl_q, q, gl_w, w, Y, total_leaves: int,
                 t_chunk: Optional[int] = None) -> torch.Tensor:
    """OOS proximity prediction: rows = queries, refs = (gl_w, w, Y)."""
    return _swlc_product(gl_q, q, gl_w, w, Y, total_leaves, t_chunk)
