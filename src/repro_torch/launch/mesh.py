"""Mesh construction: the reference's axis names and shapes as torch
``DeviceMesh``es.

A function, not a module-level constant — importing this module never
touches a process group.  ``make_local_mesh`` needs one: a world of
``data x model`` ranks (``torchrun``, or ``torch.distributed``'s
``init_process_group`` called by the caller); it starts a one-rank world
itself when none exists and the mesh is (1, 1).  ``make_production_mesh``
gives the production shapes; without a ``device`` it returns an
:class:`~..distributed.logical.AbstractMesh` of them, which the placement
rules take as they take a ``DeviceMesh``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ..distributed.logical import AbstractMesh, mesh_axes

__all__ = ["make_production_mesh", "make_local_mesh", "batch_axes",
           "fsdp_axes", "MODEL_AXIS"]

MODEL_AXIS = "model"


def _one_rank_world(device_type: str):
    """A world of one rank, rendezvoused through a file in a fresh
    temporary directory (no port is opened)."""
    path = os.path.join(tempfile.mkdtemp(prefix="repro_mesh_"), "store")
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{path}",
                            rank=0, world_size=1)


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= int(s)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {tuple(shape)} mesh needs a world of {n} ranks; start "
                "them with torchrun or init_process_group first")
        _one_rank_world(device_type)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``: an ``AbstractMesh`` unless
    ``device`` names a device type, then a ``DeviceMesh`` over the world
    (which must have 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None:
        return AbstractMesh(shape, axes)
    return _device_mesh(torch.device(device).type, shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``(data, model)`` ``DeviceMesh`` named ``("data", "model")`` over
    the world's ranks, on ``device``'s type (NCCL on cards, gloo on the
    CPU when this call starts the world)."""
    return _device_mesh(torch.device(device).type, (data, model),
                        ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def fsdp_axes(mesh) -> tuple:
    """Mesh axes parameters are fully-sharded (ZeRO-3) over."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
