"""Prefill and decode steps (the serving half of the reference's
``train/steps.py``; the train step comes with the training slice).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..models import lm

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ArchConfig, attn_chunk: int = 512,
                      block_causal: bool = True) -> Callable:
    """Batched prefill: logits for a full prompt (inference forward)."""

    def prefill_step(params, batch):
        logits, _ = lm.forward(params, cfg, batch["tokens"],
                               image_embed=batch.get("image_embed"),
                               block_causal=block_causal,
                               attn_chunk=attn_chunk)
        return logits

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """One-token serve step against a KV/SSM cache: ``(params, token,
    cache, pos) -> (next_token (B, 1) int32, logits, cache)``."""

    def decode_step(params, token, cache, pos):
        logits, cache = lm.decode_step(params, cfg, token, cache, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return decode_step
