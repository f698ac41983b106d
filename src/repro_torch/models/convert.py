"""The JAX package's parameter pytree as the port's :class:`~.lm.LM`, and
back.

The reference stacks every layer's leaves on a leading ``L`` axis
(``tree["layers"]["attn"]["wq"]`` is ``(L, D, H, hd)``); the port keeps one
:class:`~.lm.Block` per layer.  ``params_from_reference`` slices the stack
layer by layer, so both packages compute from the same weights;
``params_to_reference`` stacks the port's blocks again, for the gradient
comparisons and the checkpoint format both packages share.  Any module of
the LM's layout maps the same way (the optimizer's ``m`` and ``v``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.logical import full_tensor
from .lm import LM, Block

__all__ = ["params_from_reference", "params_to_reference", "reference_path"]


def params_from_reference(cfg: ArchConfig, tree: Mapping,
                          device="cuda") -> LM:
    """``tree``: the reference's parameters as nested mappings of numpy
    arrays (``jax.tree.map(np.asarray, params)``)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def layer(sub, l):
        return {k: layer(v, l) if isinstance(v, Mapping) else t(v[l])
                for k, v in sub.items()}

    blocks = [Block(layer(tree["layers"], l)) for l in range(cfg.n_layers)]
    head = tree.get("lm_head")
    return LM(t(tree["embed"]), blocks, t(tree["final_norm"]),
              None if head is None else t(head))


def reference_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """An :class:`LM` parameter name as the reference's key path and layer:
    ``layers.3.attn.wq`` -> ``(("layers", "attn", "wq"), 3)``,
    ``embed`` -> ``(("embed",), None)``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def params_to_reference(params: LM) -> dict:
    """The reference's pytree of ``params`` (or of a module of its layout):
    nested dicts of float32 numpy arrays, the layers stacked on a leading
    ``L`` axis under the reference's leaf names.  The module carries its
    depth, so no config is needed.  DTensor leaves are gathered whole (a
    collective: every rank of their mesh calls this)."""
    tree: dict = {}
    stacks: dict = {}
    for name, p in params.named_parameters():
        path, layer = reference_path(name)
        a = full_tensor(p.detach()).cpu().numpy()
        if layer is None:
            tree[path[0]] = a
        else:
            stacks.setdefault(path, {})[layer] = a
    for path, by_layer in stacks.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack([by_layer[l] for l in sorted(by_layer)])
    return tree
