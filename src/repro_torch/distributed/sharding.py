"""Sharding rules: parameter / input / cache placements per architecture.

Strategy, the reference's rule for rule:
  - batch over ("pod", "data"); params FSDP(ZeRO-3)-sharded over the same
    axes on a large non-TP dim; tensor-parallel over "model" on heads /
    d_ff / vocab / experts / d_inner.
  - Head counts that don't divide the model axis (minicpm H=36, hymba H=25,
    paligemma H=8, granite-moe E=40) fall back to the first dimension that
    *does* divide — head_dim, expert d_ff, etc. — instead of relying on
    uneven-shard padding.
  - decode KV caches shard their *sequence* dim over "model", which is
    what makes 500k-token caches and MQA (kv=1) caches fit per device.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of two or more axis names — ``tuple(PartitionSpec)`` in the
reference's terms (which writes a one-name tuple as the name).  The reference keys each rule on a stacked leaf's path and shape;
the port keeps one block per layer, so a layer leaf takes the same spec
without the leading ``L`` entry (which is never sharded).  Parameter
specs are keyed by the :class:`~..models.lm.LM`'s parameter names
(``layers.3.attn.wq``).  Every rule takes a ``DeviceMesh`` with named
dims or an :class:`~.logical.AbstractMesh`; ``placements_for`` turns a
spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..models.convert import reference_path
from .logical import distribute_full, mesh_axes, placements_for

__all__ = ["param_specs", "batch_specs", "cache_specs", "opt_state_specs",
           "with_named_sharding", "tp_size", "placements_for",
           "distribute_params", "ShardedMeta", "NamedSharding"]

Spec = Tuple[Any, ...]


def _spec(entries) -> Spec:
    """A spec in ``PartitionSpec``'s normal form: a one-name tuple is the
    name, an empty one ``None``."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in entries)


def tp_size(mesh) -> int:
    return mesh_axes(mesh)["model"]


def _axes(mesh) -> Tuple[Tuple[str, ...], str]:
    fsdp = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    return fsdp, "model"


def _fsdp_size(mesh) -> int:
    fsdp, _ = _axes(mesh)
    sizes = mesh_axes(mesh)
    n = 1
    for a in fsdp:
        n *= sizes[a]
    return n


def _pick(shape, idx_candidates, size) -> Optional[int]:
    """First candidate dim whose extent divides `size`."""
    for i in idx_candidates:
        if shape[i] % size == 0 and shape[i] >= size:
            return i
    return None


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of one parameter leaf, keyed on its reference path; a
    layer leaf's ``shape`` is one layer's (no leading ``L``)."""
    fsdp, tp = _axes(mesh)
    tps = tp_size(mesh)
    fs = _fsdp_size(mesh)
    spec = [None] * len(shape)

    def assign(i, ax):
        if i is not None:
            spec[i] = ax

    name = path[-1]
    group = path[-2] if len(path) > 1 else ""

    if name == "embed":
        assign(_pick(shape, [0], tps), tp)                 # vocab
        assign(_pick(shape, [1], fs), fsdp)                # d_model
    elif name == "lm_head":
        assign(_pick(shape, [1], tps), tp)                 # vocab
        assign(_pick(shape, [0], fs), fsdp)
    elif name in ("wq", "wk", "wv"):                       # (D, H|KV, hd)
        # heads over model only when divisible; never shard head_dim
        assign(_pick(shape, [1], tps), tp)
        assign(_pick(shape, [0], fs), fsdp)
    elif name == "wo":                                     # (H, hd, D)
        assign(_pick(shape, [0], tps), tp)
        assign(_pick(shape, [2], fs), fsdp)
    elif group == "mlp" and name in ("w_gate", "w_up"):    # (D, F)
        assign(_pick(shape, [1], tps), tp)
        assign(_pick(shape, [0], fs), fsdp)
    elif group == "mlp" and name == "w_down":              # (F, D)
        assign(_pick(shape, [0], tps), tp)
        assign(_pick(shape, [1], fs), fsdp)
    elif name == "router":                                 # (D, E)
        assign(_pick(shape, [0], fs), fsdp)
    elif group == "moe" and name in ("w_gate", "w_up"):    # (E, D, Fe)
        assign(_pick(shape, [0, 2], tps), tp)
        assign(_pick(shape, [1], fs), fsdp)
    elif group == "moe" and name == "w_down":              # (E, Fe, D)
        assign(_pick(shape, [0, 1], tps), tp)
        assign(_pick(shape, [2], fs), fsdp)
    elif name == "in_proj":                                # (D, Z)
        assign(_pick(shape, [1], tps), tp)
        assign(_pick(shape, [0], fs), fsdp)
    elif name == "out_proj":                               # (di, D)
        assign(_pick(shape, [0], tps), tp)
        assign(_pick(shape, [1], fs), fsdp)
    # norms / biases / conv / A_log / dt / out_norm: replicated
    return _spec(spec)


def param_specs(params: nn.Module, mesh) -> Dict[str, Spec]:
    """``{parameter name: spec}`` for an LM (or a module of its layout:
    the optimizer's moments)."""
    return {n: _leaf_spec(reference_path(n)[0], tuple(p.shape), mesh)
            for n, p in params.named_parameters()}


def opt_state_specs(params: nn.Module, mesh) -> Dict[str, Spec]:
    """Adam m/v mirror the param sharding."""
    return param_specs(params, mesh)


def batch_specs(mesh, with_image: bool = False) -> Dict[str, Spec]:
    b = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    out = {"tokens": _spec((b, None)), "labels": _spec((b, None))}
    if with_image:
        out["image_embed"] = _spec((b, None, None))
    return out


def _batch_axes_for(mesh, dim: int):
    """Batch-sharding axes that evenly divide `dim` (long_500k has B=1)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    if axes and dim % n == 0 and dim >= n:
        return axes if len(axes) > 1 else axes[0]
    # try data alone (pod dropped)
    if "data" in sizes and dim % sizes["data"] == 0 and dim >= sizes["data"]:
        return "data"
    return None


def cache_specs(cfg: ArchConfig, cache: Dict[str, Any], mesh
                ) -> Dict[str, Spec]:
    """Decode cache specs: batch→data axes, seq→model (flash-decode).
    ``cache`` maps names to tensors of the reference's stacked layout."""
    tps = tp_size(mesh)

    def fn(name, leaf):
        shape = tuple(leaf.shape)
        b = _batch_axes_for(mesh, shape[1]) if len(shape) > 1 else None
        if name in ("k", "v", "k_swa", "v_swa", "k_glob", "v_glob"):
            # (L, B, S, KV, hd): seq over model if divisible
            seq_ok = shape[2] % tps == 0 and shape[2] >= tps
            return (None, b, "model" if seq_ok else None, None, None)
        if name == "conv":
            return (None, b, None, None)
        if name == "ssm":
            # (L, B, H, hd, state)
            h_ok = shape[2] % tps == 0 and shape[2] >= tps
            return (None, b, "model" if h_ok else None, None, None)
        return (None,) * len(shape)

    return {k: fn(k, v) for k, v in cache.items()}


class NamedSharding(NamedTuple):
    """A spec on a ``DeviceMesh``: where a restored leaf goes
    (``train.checkpoint.restore_checkpoint(shardings=...)``)."""
    mesh: Any
    spec: Spec

    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)


class ShardedMeta(NamedTuple):
    """A leaf's global shape on ``meta``, its spec and the meta tensor one
    rank holds (each sharded dim divided by the product of its axes)."""
    full: torch.Tensor
    spec: Spec
    local: torch.Tensor


def with_named_sharding(tree: Dict[str, torch.Tensor],
                        specs: Dict[str, Spec], mesh
                        ) -> Dict[str, ShardedMeta]:
    """Attach specs to a mapping of tensors (the dry-run inputs): each
    leaf becomes a :class:`ShardedMeta` on ``meta``, nothing allocated."""
    sizes = mesh_axes(mesh)

    def one(t, spec):
        shape = list(t.shape)
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            shape[d] = -(-shape[d] // n)
        full = torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        local = torch.empty(tuple(shape), dtype=t.dtype, device="meta")
        return ShardedMeta(full, tuple(spec), local)

    return {k: one(t, specs[k]) for k, t in tree.items()}


def distribute_params(module: nn.Module, specs: Dict[str, Spec], mesh
                      ) -> nn.Module:
    """Replace every parameter of ``module`` in place by a DTensor on
    ``mesh`` (a ``DeviceMesh``) with its spec's placements, keeping its
    ``requires_grad``.  Each rank holds the full leaf first (drawn from the
    same seed everywhere) and keeps its shard of it, so the sharded state
    equals the one-device state bit for bit."""
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        d = distribute_full(p.detach(), mesh,
                            placements_for(specs[name], mesh))
        new = nn.Parameter(d, requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)
    return module
