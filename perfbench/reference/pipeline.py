"""The reference's factors for one fitted forest: the training rows routed
again, the weights of the configuration's kernel method
(``reference/methods/<kernel_method>.py``) and the reference side of P."""
from __future__ import annotations

import importlib.util
from pathlib import Path

from . import forest as rforest
from .prox import Reference

_METHODS = Path(__file__).resolve().parent / "methods"


def method(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_method_{name}", _METHODS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Forest:
    def __init__(self, torch, st: dict, X, y, kernel_method: str, device):
        self.torch, self.st = torch, st
        self.m = method(kernel_method)
        self.leaves = rforest.route(torch, st, X, device)
        self.gl = rforest.global_leaves(torch, st, self.leaves)
        self.q, self.w = self.m.train_factors(torch, st, self.gl, y)
        self.ref = Reference(torch, self.gl, self.w, st["total_leaves"])
