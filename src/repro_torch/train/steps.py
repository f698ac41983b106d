"""Train, prefill and decode steps.

``make_train_step(cfg, opt_cfg)`` returns ``(state, batch) -> (state,
metrics)``: the loss and its gradients (autograd through ``lm.loss_fn``,
each block rematerialized in the backward pass unless ``remat=False``),
optionally the int8 compression round trip (over the reference's stacked
leaves, ``compress_stacked``), then the AdamW update in place.  The state is ``{"params": LM, "opt": {"m", "v", "step"}}``, the
reference's names; ``m`` and ``v`` are modules of the LM's layout.  The
metrics ``loss`` and ``grad_norm`` stay 0-d tensors on the device until
the caller reads them.

The prefill and decode steps run under ``torch.no_grad()`` (not
``inference_mode``: a DTensor view of a parameter, such as a tied head's
transpose, fails inside it).

Sharded: ``distribute_train_state(state, mesh)`` places the parameters and
moments by ``distributed.sharding.param_specs`` as DTensors; the same step
then runs under ``axis_env(mesh)`` on a batch placed by ``batch_specs``.
The loss is the global batch's, each gradient is brought to its leaf's
placements, ``grad_norm`` is the global norm, and int8 compression works
on each whole (gathered) stacked leaf, so its block scales are the
one-device ones.  ``abstract_train_state`` gives the state's shapes and
dtypes on the ``meta`` device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed.compression import compress_decompress_grads
from ..distributed.logical import (distribute_full, full_tensor, is_dtensor,
                                   shard_hint)
from ..distributed.sharding import distribute_params, param_specs
from ..models import lm
from ..models.convert import reference_path
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["init_train_state", "abstract_train_state",
           "distribute_train_state", "value_and_grad", "compress_stacked",
           "make_train_step", "make_prefill_step", "make_decode_step"]


def init_train_state(cfg: ArchConfig, seed: int = 0,
                     device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``seed`` on ``device`` and zero moments."""
    params = lm.init_params(cfg, seed, device=device)
    return {"params": params, "opt": adamw_init(params)}


def abstract_train_state(cfg: ArchConfig) -> Dict[str, Any]:
    """The train state's structure on ``meta``: parameters and moments of
    the parameters' shapes (float32) and an int32 step; nothing is
    allocated."""
    params = lm.abstract_params(cfg)
    opt = adamw_init(params)
    opt["step"] = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": params, "opt": opt}


def distribute_train_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Place a full train state (every rank holding the same one) on
    ``mesh`` in place: parameters by ``param_specs``, the moments by the
    same specs (``opt_state_specs``); the step stays a host scalar."""
    specs = param_specs(state["params"], mesh)
    distribute_params(state["params"], specs, mesh)
    distribute_params(state["opt"]["m"], specs, mesh)
    distribute_params(state["opt"]["v"], specs, mesh)
    return state


def value_and_grad(cfg: ArchConfig, params: lm.LM, batch: Dict, *,
                   block_causal: bool = True, attn_chunk: int = 512,
                   remat: bool = True
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss on ``batch`` and its gradient for each of
    ``params.parameters()``, in that order (float32, as the leaves)."""
    with torch.enable_grad():
        loss = lm.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                          image_embed=batch.get("image_embed"),
                          block_causal=block_causal, attn_chunk=attn_chunk,
                          remat=remat)
        leaves = list(params.parameters())
        grads = list(torch.autograd.grad(loss, leaves))
    for i, (g, p) in enumerate(zip(grads, leaves)):
        if is_dtensor(g):
            grads[i] = g.redistribute(p.device_mesh, p.placements)
    return full_tensor(loss.detach()), grads


def compress_stacked(params: lm.LM, grads: List[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """``compress_decompress_grads`` over the reference's leaves: each
    leaf's per-layer gradients stacked on a leading ``L`` axis first, so a
    256-block may span layers and a per-layer leaf under 256 elements is
    compressed when its stack is not, as the reference's stacked pytree
    has it.  Returns the gradients per layer again, in ``grads``' order."""
    groups: Dict[tuple, List[int]] = {}
    for i, (name, _) in enumerate(params.named_parameters()):
        path, layer = reference_path(name)
        groups.setdefault(path, []).append(i)
    out = list(grads)
    whole = [full_tensor(g) for g in grads]
    for path, idx in groups.items():
        stacked = whole[idx[0]] if path[0] != "layers" else \
            torch.stack([whole[i] for i in idx])
        (done,) = compress_decompress_grads([stacked])
        for l, i in enumerate(idx):
            d = done if path[0] != "layers" else done[l]
            out[i] = distribute_full(d, grads[i].device_mesh,
                                     grads[i].placements) \
                if is_dtensor(grads[i]) else d
    return out


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    block_causal: bool = True, attn_chunk: int = 512,
                    compress_grads: bool = False,
                    remat: bool = True) -> Callable:
    opt_cfg = opt_cfg or AdamWConfig(schedule=cfg.lr_schedule)

    def train_step(state, batch):
        params = state["params"]
        loss, grads = value_and_grad(cfg, params, batch,
                                     block_causal=block_causal,
                                     attn_chunk=attn_chunk, remat=remat)
        if compress_grads:
            grads = compress_stacked(params, grads)
        om = adamw_update(opt_cfg, grads, state["opt"], params)
        om["grad_norm"] = full_tensor(om["grad_norm"])
        return state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig, attn_chunk: int = 512,
                      block_causal: bool = True) -> Callable:
    """Batched prefill: logits for a full prompt (inference forward)."""

    @torch.no_grad()
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
        # under a mesh each rank's rows whole over the vocab first: DTensor's
        # argmax over a vocab-sharded dim fails on a (pod, data, model) mesh
        last = shard_hint(logits[:, -1], "batch", None)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return decode_step
