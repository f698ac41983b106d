"""Abstract inputs for every (arch × shape) cell, as ``meta`` tensors.

``input_specs(cfg, cell)`` returns the inputs of the step kind the cell
traces (train/prefill: a token + label batch; decode: token, cache, pos)
with the reference's shapes and dtypes, on torch's ``meta`` device:
nothing is allocated.  Modality frontends are stubs, as in the
reference: paligemma receives precomputed SigLIP patch embeddings, musicgen
receives EnCodec token ids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeCell
from ..models.layers import COMPUTE_DTYPE
from ..models.lm import abstract_cache

__all__ = ["input_specs", "batch_struct"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, batch: int, seq: int
                 ) -> Dict[str, torch.Tensor]:
    """int32 ``tokens``/``labels`` (B, S); a VLM's text is shortened by its
    image prefix, whose ``image_embed`` (B, prefix_len, d_model) comes in
    the compute dtype."""
    text = seq - cfg.prefix_len if cfg.family == "vlm" else seq
    out = {"tokens": _meta((batch, text), torch.int32),
           "labels": _meta((batch, text), torch.int32)}
    if cfg.family == "vlm":
        out["image_embed"] = _meta((batch, cfg.prefix_len, cfg.d_model),
                                   COMPUTE_DTYPE)
    return out


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    B, S = cell.global_batch, cell.seq_len
    if cell.step in ("train", "prefill"):
        return {"batch": batch_struct(cfg, B, S)}
    # decode: one new token against a seq_len cache
    return {"token": _meta((B, 1), torch.int32),
            "cache": abstract_cache(cfg, B, S),
            "pos": _meta((), torch.int32)}
