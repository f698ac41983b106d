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

DTensor has no rule for some layouts XLA reshards without complaint, so
the model code places its tensors explicitly there: ``reshape_hinted``
splits or merges dims (heads out of a projection's columns, back into
them) with both sides placed so the view has a rule; ``local_map`` runs
a per-shard computation (the chunked attention, the SSD scan, the MoE
dispatch) on each rank's local tensors; ``pad_zeros`` pads by
concatenation (torch 2.11's ``F.pad`` rule fails on a DTensor).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
or an :class:`AbstractMesh` (axis names and sizes, no devices), set with
``axis_env(mesh)``; the padding paths read its model-axis size through
``tp_size_of()`` either way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = ["axis_env", "shard_hint", "current_mesh", "perf_env", "get_opt",
           "tp_size_of", "AbstractMesh", "mesh_axes", "placements_for",
           "is_dtensor", "replicate_like", "group_local", "distribute_full",
           "full_tensor", "hint_spec", "captured_env", "replicated",
           "reshape_hinted", "local_map", "pad_zeros", "spec_of",
           "fsdp_gather"]

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


def fsdp_gather(w: torch.Tensor) -> torch.Tensor:
    """A parameter (or its cast) whole over the batch axes, still sharded
    over the model axis: ZeRO-3's all-gather before use, so each rank
    multiplies its own batch rows by it (its backward is the gradient's
    reduce-scatter).  Left to itself DTensor may shard a small batch's
    GEMM over the contraction instead (a decode step), multiplying every
    row on every rank.  A plain tensor, or no mesh: ``w`` itself."""
    if current_mesh() is None or not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    pl = [Replicate() if name in ("pod", "data") else p
          for name, p in zip(mesh_axes(mesh), w.placements)]
    return w.redistribute(mesh, pl)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` as a plain tensor (a collective on a DTensor:
    every rank of its mesh must call it); ``t`` itself otherwise."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def spec_of(t) -> tuple:
    """A DTensor's placements as a spec (each tensor dim's mesh axes in the
    mesh's order, ``None`` where it is not sharded); ``None`` for a plain
    tensor."""
    if not isinstance(t, DTensor):
        return None
    names = list(mesh_axes(t.device_mesh))
    spec = []
    for d in range(t.dim()):
        axes = tuple(n for n, p in zip(names, t.placements)
                     if isinstance(p, Shard) and p.dim == d)
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return tuple(spec)


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
    """``x`` placed by ``logical_axes``; a redistribute even where the
    placements already agree, so the gradient takes them too (its
    backward), as ``with_sharding_constraint`` constrains the cotangent."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements_for(hint_spec(x.shape, logical_axes, x.device_mesh),
                          x.device_mesh)
    return x.redistribute(x.device_mesh, want)


def _runs(fine, coarse):
    """For a reshape that merges runs of adjacent dims of ``fine`` into the
    dims of ``coarse``: each coarse dim's run of fine dims."""
    runs, i = [], 0
    for c in coarse:
        run, n = [], 1
        while i < len(fine) and (n < c or not run) and n * fine[i] <= c:
            run.append(i)
            n *= fine[i]
            i += 1
        if n != c:
            raise ValueError(f"{tuple(fine)} -> {tuple(coarse)} is not a "
                             "merge of adjacent dims")
        runs.append(run)
    if i != len(fine):
        raise ValueError(f"{tuple(fine)} -> {tuple(coarse)} is not a "
                         "merge of adjacent dims")
    return runs


def reshape_hinted(x: torch.Tensor, shape, *logical_axes) -> torch.Tensor:
    """``x.reshape(shape)``, a split or a merge of adjacent dims, with
    ``logical_axes`` naming the dims of the finer side (the one with more
    dims).  Under a mesh both sides are placed so that DTensor has a rule
    for the view in either direction (the backward too): the finer side by
    the hint, and each merged run of dims sharded only on its leading dim,
    which the coarse dim inherits.  A head count that does not divide the
    model axis leaves its dim replicated there, so a projection's columns
    are gathered over the model axis before they split into heads, as XLA
    does.  No mesh or a plain ``x``: a plain reshape."""
    shape = tuple(int(s) for s in shape)
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x.reshape(shape)
    split = len(shape) >= x.dim()
    fine, coarse = (shape, tuple(x.shape)) if split \
        else (tuple(x.shape), shape)
    spec = list(hint_spec(fine, logical_axes, x.device_mesh))
    runs = _runs(fine, coarse)
    for run in runs:
        for d in run[1:]:
            spec[d] = None
    cspec = tuple(spec[run[0]] for run in runs)
    fmesh = x.device_mesh
    fine_pl, coarse_pl = placements_for(spec, fmesh), \
        placements_for(cspec, fmesh)
    first, then = (coarse_pl, fine_pl) if split else (fine_pl, coarse_pl)
    # redistributes even where the placements already agree: their
    # backwards bring the gradient to them before the view's backward runs
    return x.redistribute(fmesh, first).reshape(shape).redistribute(fmesh,
                                                                    then)


def pad_zeros(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to ``size``: a concatenation
    with zeros, which torch 2.11's DTensor places where its ``F.pad`` rule
    fails; the same values as ``F.pad``.  On a DTensor the zeros take
    ``t``'s placements (``dim`` whole on every rank), so each rank makes
    only its own shard of them."""
    dim = dim % t.dim()
    if not isinstance(t, DTensor):
        shape = list(t.shape)
        shape[dim] = size - shape[dim]
        return torch.cat([t, t.new_zeros(shape)], dim=dim)
    mesh = t.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in t.placements]
    t = t.redistribute(mesh, pl)
    local = list(t.to_local().shape)
    glob = list(t.shape)
    local[dim] = glob[dim] = size - glob[dim]
    zeros = DTensor.from_local(t.to_local().new_zeros(local), mesh, pl,
                               run_check=False, shape=torch.Size(glob),
                               stride=torch.empty(glob,
                                                  device="meta").stride())
    return torch.cat([t, zeros], dim=dim)


def local_map(fn, args, specs, out_specs):
    """``fn(*args)`` on each rank's shards, for a computation that is
    independent along every sharded dim (sequences, heads, groups): the
    counterpart of XLA running the reference's per-shard code where DTensor
    has no rule (sort, scatter, cumsum's backward, a batched matmul over a
    sharded non-leading dim on torch 2.11).

    No argument a DTensor: a plain call.  Otherwise DTensor argument ``i``
    is placed by ``specs[i]`` (a resolved spec as ``hint_spec`` gives it;
    ``None`` keeps its placements, for a tensor ``fn`` writes in place),
    ``fn`` runs on the local tensors (plain arguments as they are), and its
    outputs (a tensor or a tuple) become DTensors with ``out_specs[j]``'s
    placements.  An argument replicated over a mesh dim that shards another
    argument gets its gradient as a partial sum there (each rank's share
    of the computation adds to it)."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    placed = []
    for a, spec in zip(args, specs):
        if isinstance(a, DTensor) and spec is not None:
            # always: its backward brings the gradient back to a's layout
            a = a.redistribute(mesh, placements_for(spec, mesh))
        placed.append(a)
    sharded = [any(isinstance(a, DTensor) and isinstance(a.placements[m],
                                                         Shard)
                   for a in placed) for m in range(mesh.ndim)]
    local = []
    for a in placed:
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        grad_pl = [Partial() if sharded[m] and isinstance(p, Replicate)
                   else p for m, p in enumerate(a.placements)]
        local.append(a.to_local(grad_placements=grad_pl))
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(DTensor.from_local(o, mesh, placements_for(sp, mesh),
                                       run_check=False)
                    for o, sp in zip(outs, out_specs))
    return wrapped[0] if single else wrapped


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
    spec = hint_spec(args[0].shape[:1], ("batch",), ref.device_mesh)
    return local_map(fn, args, [spec] * len(args), itertools.repeat(spec))
