"""The JAX package's parameter pytree as the port's :class:`~.lm.LM`.

The reference stacks every layer's leaves on a leading ``L`` axis
(``tree["layers"]["attn"]["wq"]`` is ``(L, D, H, hd)``); the port keeps one
:class:`~.lm.Block` per layer.  ``params_from_reference`` slices the stack
layer by layer, so both packages compute from the same weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .lm import LM, Block

__all__ = ["params_from_reference"]


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
