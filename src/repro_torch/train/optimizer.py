"""AdamW with cosine / WSD schedules and global-norm clipping, the JAX
package's math on lists of tensors.

Not ``torch.optim.AdamW``: the reference corrects ``m`` and ``v`` for bias
before adding ``eps`` (``mh / (sqrt(vh) + eps)``), decays every leaf (norms
and embedding included) by ``lr * wd * p`` inside the same step, and clips
by a float32 global norm with ``scale = min(1, clip / (gnorm + 1e-9))``.
The schedule and the bias corrections are computed on the host in float32,
as the reference computes them on the device, so no step waits for the
device; the step counter is a host int32 scalar.  The leaves may be
DTensors (a sharded state, ``train.steps.distribute_train_state``): the
same foreach ops then run shard by shard, and the clipping norm is the
global one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn

from ..models.lm import map_params

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_at"]

Leaves = Union[nn.Module, Sequence[torch.Tensor]]
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # 'cosine' | 'wsd' | 'const'
    wsd_decay_frac: float = 0.1     # MiniCPM-style warmup-stable-decay


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


def lr_at(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (an int or a 0-d tensor), computed in
    float32 op for op as the reference computes it."""
    s = _f32(int(step))
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        mult = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1 - cfg.wsd_decay_frac)
        t = torch.clamp((s - _f32(decay_start))
                        / _f32(max(cfg.total_steps - decay_start, 1)), 0, 1)
        mult = 1.0 - t                      # linear decay tail; stable before
    else:
        mult = _f32(1.0)
    return float(_f32(cfg.lr) * warm * mult)


def _leaves(x: Leaves) -> list:
    return list(x.parameters()) if isinstance(x, nn.Module) else list(x)


def adamw_init(params: Leaves) -> Dict:
    """``{"m", "v", "step"}``: zero moments shaped like ``params`` (a module
    of the LM's layout gives modules of that layout, so the checkpoint keys
    them as the reference does; a list gives lists) and step 0."""
    if isinstance(params, nn.Module):
        def zeros():
            return map_params(params, lambda _, p: torch.zeros_like(
                p, dtype=_F32)).requires_grad_(False)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32)}
    return {"m": [torch.zeros_like(p, dtype=_F32) for p in params],
            "v": [torch.zeros_like(p, dtype=_F32) for p in params],
            "step": torch.zeros((), dtype=torch.int32)}


# temporaries of one update are made for at most this many elements at a
# time, so a 1.6B-parameter model's update does not double its memory
_GROUP_ELEMS = 1 << 26


def _groups(leaves: list):
    start, n = 0, 0
    for i, p in enumerate(leaves):
        if n and n + p.numel() > _GROUP_ELEMS:
            yield slice(start, i)
            start, n = i, 0
        n += p.numel()
    if start < len(leaves):
        yield slice(start, len(leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Sequence[torch.Tensor], opt: Dict,
                 params: Leaves) -> Dict[str, object]:
    """One step, in place: ``params`` and ``opt["m"]``/``opt["v"]`` are
    updated, ``opt["step"]`` advanced.  ``grads`` align with ``params``
    (a module's ``parameters()`` order).  Returns the metrics
    ``grad_norm`` (a 0-d float32 tensor on the grads' device) and ``lr``."""
    ps, ms, vs = _leaves(params), _leaves(opt["m"]), _leaves(opt["v"])
    gs = [g.float() for g in grads]
    if not (len(gs) == len(ps) == len(ms) == len(vs)):
        raise ValueError(f"{len(gs)} grads for {len(ps)} params, "
                         f"{len(ms)}/{len(vs)} moments")
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
    # a tensor divided, not ``scalar / tensor`` (torch takes a reciprocal)
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm)
                        / (gnorm + 1e-9), max=1.0)
    step = int(opt["step"]) + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas
    bc1 = float(1 - _f32(b1) ** _f32(step))
    bc2 = float(1 - _f32(b2) ** _f32(step))
    for sl in _groups(ps):
        p, g, m, v = ps[sl], gs[sl], ms[sl], vs[sl]
        g = torch._foreach_mul(g, scale)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, 1 - b2), g))
        mh = torch._foreach_div(m, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(mh, den)
        torch._foreach_add_(upd, torch._foreach_mul(p, cfg.weight_decay))
        torch._foreach_sub_(p, torch._foreach_mul(upd, lr))
    opt["step"] = torch.tensor(step, dtype=torch.int32)
    return {"grad_norm": gnorm, "lr": lr}
