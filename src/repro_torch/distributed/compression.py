"""Gradient compression: int8 block quantization with error feedback.

Each leaf is quantized to int8 with a per-block float32 scale (blocks of
256, ``scale = max|block| / 127 + 1e-12``, round half to even, clipped to
±127) and dequantized again, the JAX package's wire format.  Leaves under
256 elements pass through.  Every step is an elementwise float32 operation
or an exact max, so the codes and scales are the reference's bit for bit
on the CPU, and the card's equal the CPU's: divisions are tensor by tensor
(torch on the card multiplies by a reciprocal when it divides by a Python
scalar).

``compress_decompress_grads`` models the numerical effect on one step;
``EFState`` carries the quantization error into the next step's gradient
(``ef_compress``).  Both work on lists of tensors.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_int8", "dequantize_int8", "compress_decompress_grads",
           "ef_compress", "EFState"]

_BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (n_blocks, 256) int8, scales (n_blocks, 1) float32)."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    peak = blocks.abs().amax(dim=1, keepdim=True)
    scale = peak / torch.full_like(peak, 127.0) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    out = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= int(s)
    return out[:n].reshape(tuple(shape)).to(dtype)


def compress_decompress_grads(grads: Sequence[torch.Tensor]
                              ) -> List[torch.Tensor]:
    """Quantize -> dequantize every leaf (the numerical effect of int8 on
    the wire)."""
    out = []
    for g in grads:
        if g.numel() < _BLOCK:      # tiny leaves (norms, biases): as they are
            out.append(g)
            continue
        q, s = quantize_int8(g)
        out.append(dequantize_int8(q, s, g.shape, g.dtype))
    return out


class EFState(NamedTuple):
    residual: List[torch.Tensor]


def ef_compress(grads: Sequence[torch.Tensor], ef: EFState
                ) -> Tuple[List[torch.Tensor], EFState]:
    """Error-feedback compression: compress(g + r); r' = (g + r) - decomp."""
    out, res = [], []
    for g, r in zip(grads, ef.residual):
        if g.numel() < _BLOCK:
            out.append(g)
            res.append(torch.zeros_like(g))
            continue
        corrected = g.float() + r
        q, s = quantize_int8(corrected)
        dq = dequantize_int8(q, s, g.shape, torch.float32)
        out.append(dq.to(g.dtype))
        res.append(corrected - dq)
    return out, EFState(res)
