"""Plain PyTorch version of the dense proximity-block kernel.

The tree-chunked broadcast of the reference's ``jax_ops.swlc_block``: per
chunk of ``t_chunk`` trees, a (rows, Nw, t_chunk) collision mask selects
``q ⊗ w`` products, which are added to the block one tree at a time in
ascending order from 0.0 (the kernel's order; the kernel fuses each add
into an fma, and ``core/collide.py`` adds a pair's products in this order
too).  That intermediate is what the plain version pays and the kernel
does not, so rows are processed in chunks keeping it near ``budget``
elements.
"""
from __future__ import annotations

import torch

__all__ = ["block_prox_ref"]


def block_prox_ref(gl_q: torch.Tensor, q: torch.Tensor, gl_w: torch.Tensor,
                   w: torch.Tensor, t_chunk: int = 8,
                   budget: int = 1 << 25) -> torch.Tensor:
    """P[i,j] = Σ_t q[i,t]·w[j,t]·1[gl_q[i,t] == gl_w[j,t]], (Nq, Nw) in
    the weights' type (float64 or float32), summed in that type over the
    trees in ascending order."""
    nq, T = gl_q.shape
    nw = gl_w.shape[0]
    out = torch.zeros((nq, nw), dtype=q.dtype, device=q.device)
    step = max(1, budget // max(nw * t_chunk, 1))
    for i0 in range(0, nq, step):
        i1 = min(i0 + step, nq)
        acc = out[i0:i1]
        for t0 in range(0, T, t_chunk):
            t1 = min(t0 + t_chunk, T)
            coll = gl_q[i0:i1, None, t0:t1] == gl_w[None, :, t0:t1]
            prod = q[i0:i1, None, t0:t1] * w[None, :, t0:t1]
            part = torch.where(coll, prod, 0.0)
            for t in range(t1 - t0):
                acc += part[..., t]
    return out
