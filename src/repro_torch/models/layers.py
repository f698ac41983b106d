"""Shared model layers: norms, rotary embeddings, initializers.

Parameters live in ``PARAM_DTYPE`` (float32) and every use casts them to
``COMPUTE_DTYPE`` (bfloat16), as in the JAX package, so both compute the
same thing from the same weights.  :class:`Initializer` draws leaves from
an explicit ``torch.Generator``: the reference's distributions (normal
scaled by 1/sqrt(fan_in), zeros, ones), not its values.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["Initializer", "rms_norm", "rotary_embedding", "apply_rope",
           "silu", "PARAM_DTYPE", "COMPUTE_DTYPE"]

PARAM_DTYPE = torch.float32
COMPUTE_DTYPE = torch.bfloat16


class Initializer:
    """Creates parameter tensors on ``device`` from ``generator``."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 scale: float = 0.02):
        self.generator = generator
        self.device = device
        self.scale = scale

    def normal(self, shape: Sequence[int], fan_in: Optional[int] = None,
               dtype=PARAM_DTYPE) -> torch.Tensor:
        std = self.scale if fan_in is None else 1.0 / math.sqrt(fan_in)
        t = torch.randn(tuple(shape), generator=self.generator,
                        device=self.device, dtype=dtype)
        return t.mul_(std)

    def zeros(self, shape: Sequence[int], dtype=PARAM_DTYPE) -> torch.Tensor:
        return torch.zeros(tuple(shape), device=self.device, dtype=dtype)

    def ones(self, shape: Sequence[int], dtype=PARAM_DTYPE) -> torch.Tensor:
        return torch.ones(tuple(shape), device=self.device, dtype=dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * gamma.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10_000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for given positions: (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd/2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    # broadcast tables over the head axis: (S, 1, hd/2)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
