"""Step-atomic checkpoints in the JAX package's on-disk format.

Layout:  <dir>/step_<N>/
            shard_0.npz         — flat {leafpath: array}
            MANIFEST.json       — leaf shapes/dtypes, step, structure
         <dir>/LATEST           — atomic pointer (written last via rename)

Leaf paths join the reference's keys with ``::``; an :class:`~..models.lm.LM`
in the state (the parameters, the optimizer's ``m`` and ``v``) is written
in the reference's stacked layout (``params::layers::attn::wq`` is
``(L, D, H, hd)``), so a checkpoint written by either package restores in
the other.  The reference reads only the npz by key path; its manifest's
``treedef`` is a JAX object's text, for which the port writes its own
structure string (nothing reads the field).  The ``keep`` newest
checkpoints are retained, older ones pruned.

A sharded state (DTensor leaves) is saved whole, in the same format: the
save is a collective — every rank calls it, each leaf is gathered, rank 0
writes and the others wait for it.  ``restore_checkpoint`` places each
leaf as ``like``'s DTensor leaf is placed, or by ``shardings`` (the
reference's ``shardings=``: specs on a mesh, which may differ from the
saving one), so a checkpoint restores onto another grid or one device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.logical import (distribute_full, full_tensor, is_dtensor,
                                   placements_for)
from ..models.convert import params_to_reference, reference_path
from ..models.lm import LM, map_params

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "::"


def _items(tree: Any):
    """(key, child) pairs of a mapping or a sequence, as the reference's
    paths name them (dict keys, list indices)."""
    if isinstance(tree, Mapping):
        return [(str(k), v) for k, v in tree.items()]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(x) -> bool:
    return isinstance(x, (Mapping, list, tuple))


def _flatten(tree: Any, prefix=()) -> dict:
    flat = {}
    if isinstance(tree, LM):
        tree = params_to_reference(tree)
    if _is_node(tree):
        for k, v in _items(tree):
            flat.update(_flatten(v, prefix + (k,)))
    elif isinstance(tree, torch.Tensor):
        flat[_SEP.join(prefix)] = full_tensor(tree.detach()).cpu().numpy()
    else:
        flat[_SEP.join(prefix)] = np.asarray(tree)
    return flat


def _structure(flat: dict) -> dict:
    """The nesting of the flat leaf paths, each leaf shown as ``*``."""
    tree: dict = {}
    for key in flat:
        *path, leaf = key.split(_SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = "*"
    return tree


def _sharded(tree: Any) -> bool:
    if isinstance(tree, LM):
        return any(is_dtensor(p) for p in tree.parameters())
    if _is_node(tree):
        return any(_sharded(v) for _, v in _items(tree))
    return is_dtensor(tree)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    keep: int = 2) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _sharded(state):
        flat = _flatten(state)                 # gathers: every rank
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, flat, keep)
        dist.barrier()
        return final
    _write(ckpt_dir, step, _flatten(state), keep)
    return final


def _write(ckpt_dir: str, step: int, flat: dict, keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
    manifest = {
        "step": int(step),
        "leaves": {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()},
        "treedef": json.dumps(_structure(flat)),
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # step-atomic publish
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep)


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
        return None
    return int(name.split("_")[1])


def _tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       device=None, shardings: Optional[Any] = None) -> Any:
    """Restore into the structure of ``like`` (the latest step unless
    ``step``).  Leaves come back as tensors on ``device``; without one, a
    tensor or :class:`LM` leaf of ``like`` keeps its device and any other
    leaf comes back as a numpy array.  Shapes must match ``like``'s.

    A DTensor leaf of ``like`` comes back with its mesh and placements.
    ``shardings`` mirrors ``like`` (an :class:`LM` node takes a mapping of
    its parameter names) with a ``distributed.sharding.NamedSharding`` or
    ``None`` at each leaf: a leaf with one comes back as a DTensor on that
    mesh, which may differ from the one the checkpoint was saved from."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    dev = None if device is None else torch.device(device)
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        cache: dict = {}

        def read(path):
            key = _SEP.join(path)
            if key not in cache:
                cache[key] = data[key]
            return cache[key]

        def put(arr, like_leaf, path, sharding=None):
            if tuple(arr.shape) != tuple(like_leaf.shape):
                raise ValueError(f"{_SEP.join(path)}: checkpoint shape "
                                 f"{arr.shape}, expected "
                                 f"{tuple(like_leaf.shape)}")
            if sharding is None and is_dtensor(like_leaf):
                mesh, pl = like_leaf.device_mesh, like_leaf.placements
            elif sharding is not None:
                mesh = sharding.mesh
                pl = placements_for(sharding.spec, mesh)
            else:
                mesh = None
            if mesh is not None:
                return distribute_full(_tensor(arr, _mesh_device(mesh)),
                                       mesh, pl)
            if dev is None and not isinstance(like_leaf, torch.Tensor):
                return arr
            return _tensor(arr, like_leaf.device if dev is None else dev)

        def lm_leaf(prefix, name, p, sh):
            path, layer = reference_path(name)
            arr = read(prefix + path)
            return put(arr if layer is None else arr[layer], p,
                       prefix + path, None if sh is None else sh.get(name))

        def walk(node, prefix, sh):
            if isinstance(node, LM):
                out = map_params(node,
                                 lambda n, p: lm_leaf(prefix, n, p, sh))
                return out.requires_grad_(
                    any(p.requires_grad for p in node.parameters()))
            if isinstance(node, Mapping):
                return {k: walk(v, prefix + (str(k),),
                                None if sh is None else sh.get(k))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, prefix + (str(i),),
                                       None if sh is None else sh[i])
                                  for i, v in enumerate(node))
            like_leaf = node if hasattr(node, "shape") else np.asarray(node)
            return put(read(prefix), like_leaf, prefix, sh)

        return walk(like, (), shardings)
