"""Logical-axis sharding hints for activations.

``shard_hint(x, "batch", "sp", None)`` constrains an activation to the
ambient mesh using logical axis names:

  batch -> ("pod", "data")     sp -> "model" (sequence parallel)
  tp    -> "model"             None -> unsharded

Hints are no-ops when no mesh is set (unit tests, one-device runs), when
``x`` is a plain tensor, or, per dim, when the dimension's extent does not
divide the target axis size (or is smaller than it) — so model code can
hint unconditionally and stay correct for every arch (minicpm's 36 heads,
hymba's 25, granite-moe's 40 experts simply leave that dim unsharded).
On a ``DTensor`` a hint redistributes to the resolved placements, the
counterpart of the reference's ``with_sharding_constraint``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
or an :class:`AbstractMesh` (axis names and sizes, no devices), set with
``axis_env(mesh)``; the padding paths read its model-axis size through
``tp_size_of()`` either way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["axis_env", "shard_hint", "current_mesh", "perf_env", "get_opt",
           "tp_size_of", "AbstractMesh", "mesh_axes", "placements_for",
           "is_dtensor", "replicate_like", "group_local", "distribute_full",
           "full_tensor", "hint_spec", "captured_env", "replicated"]

_state = threading.local()

# compute-side padding that buys clean tensor-parallel sharding for head
# and expert counts that don't divide the model axis.  Defaults on;
# ``perf_env(head_pad=False, expert_pad=False)`` turns them off.
_DEFAULT_OPTS = {"head_pad": True, "expert_pad": True}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it: what the
    placement rules need (the reference's tests use
    ``jax.sharding.AbstractMesh`` for the same)."""
    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape_tuple) != len(self.axis_names):
            raise ValueError(f"{self.shape_tuple} against {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape_tuple))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh`, in the mesh's dim order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims need names (mesh_dim_names)")
    return dict(zip(names, tuple(mesh.shape)))


@contextlib.contextmanager
def axis_env(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


@contextlib.contextmanager
def perf_env(**opts):
    prev = getattr(_state, "opts", None)
    merged = dict(_DEFAULT_OPTS)
    if prev:
        merged.update(prev)
    merged.update(opts)
    _state.opts = merged
    try:
        yield
    finally:
        _state.opts = prev


def captured_env():
    """A factory of context managers that re-enter this thread's mesh and
    perf options on whichever thread enters them: the autograd engine
    recomputes a checkpointed block on its own device thread for CUDA
    tensors, where this thread's ``axis_env`` would not be seen."""
    mesh, opts = current_mesh(), getattr(_state, "opts", None)

    @contextlib.contextmanager
    def env():
        prev = getattr(_state, "mesh", None), getattr(_state, "opts", None)
        _state.mesh, _state.opts = mesh, opts
        try:
            yield
        finally:
            _state.mesh, _state.opts = prev

    return env


def get_opt(name: str):
    opts = getattr(_state, "opts", None) or _DEFAULT_OPTS
    return opts.get(name, _DEFAULT_OPTS.get(name))


def current_mesh():
    return getattr(_state, "mesh", None)


def tp_size_of() -> int:
    mesh = current_mesh()
    return int(mesh_axes(mesh).get("model", 1)) if mesh is not None else 1


def _resolve(name, axes: Dict[str, int]):
    if name is None:
        return None, 1
    if name == "batch":
        names = tuple(a for a in ("pod", "data") if a in axes)
        n = 1
        for a in names:
            n *= axes[a]
        return (names if len(names) > 1 else names[0]), n
    if name in ("tp", "sp"):
        return "model", axes.get("model", 1)
    raise KeyError(name)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements_for(spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for a per-dim
    spec in the reference's form: each entry ``None``, an axis name, or a
    tuple of axis names.  A tuple shards its tensor dim over each named
    mesh dim in the tuple's order (``("pod", "data")`` is pod-major).  A
    mesh dim of size 1 stays ``Replicate``: its one shard is the whole
    tensor either way, and no sharded or partial dim of size 1 then
    reaches an op (torch 2.11's DTensor cannot flatten one in the
    backward of a batched matmul)."""
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return out


def replicate_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` (a plain tensor made inside a forward: positions, masks,
    tables) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor; ``t`` itself otherwise."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def distribute_full(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor on ``mesh`` with ``placements`` from the full tensor
    ``t``, which every rank holds (the same values): each rank keeps its
    own shard, and nothing is sent."""
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` replicated on its mesh (each rank then holds the
    whole: an all-gather, differentiable); a plain ``t`` as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` as a plain tensor (a collective on a DTensor:
    every rank of its mesh must call it); ``t`` itself otherwise."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def hint_spec(shape, logical_axes, mesh) -> tuple:
    """The spec a hint resolves to for a tensor of ``shape`` on ``mesh``:
    each logical name's axes, or ``None`` where the extent does not divide
    the axis size (or is smaller than it)."""
    if len(logical_axes) != len(shape):
        raise ValueError(f"{logical_axes} for a tensor of shape "
                         f"{tuple(shape)}")
    axes = mesh_axes(mesh)
    spec = []
    for dim, name in zip(shape, logical_axes):
        ax, size = _resolve(name, axes)
        if ax is None or size <= 1 or dim % size != 0 or dim < size:
            spec.append(None)
        else:
            spec.append(ax)
    return tuple(spec)


def shard_hint(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements_for(hint_spec(x.shape, logical_axes, x.device_mesh),
                          x.device_mesh)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def group_local(fn, *args):
    """``fn(*args)`` for an op without a DTensor sharding rule (top-k,
    sort, scatter, gather).  Plain tensors: a plain call.  DTensors: each
    argument is redistributed to dim 0 sharded over the batch axes (when
    the leading extent divides them, else replicated) and replicated over
    the model axis, ``fn`` runs on the local shards — so it must treat
    dim-0 rows independently, as the MoE's per-sequence groups are — and
    its outputs come back as DTensors with those placements."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    ax, size = _resolve("batch", mesh_axes(mesh))
    n0 = args[0].shape[0]
    spec0 = ax if size > 1 and n0 % size == 0 and n0 >= size else None
    pl = placements_for((spec0,), mesh)
    local = [a.redistribute(mesh, pl).to_local()
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local)

    def wrap(o):
        return DTensor.from_local(o, mesh, pl, run_check=False)
    return tuple(wrap(o) for o in out) if isinstance(out, tuple) \
        else wrap(out)
