"""PyTorch/CUDA port of the SWLC tree-ensemble proximity pipeline.

A second package beside the JAX reference ``repro``: it imports ``torch``,
``numpy`` and ``scipy`` only, never ``jax`` and nothing of ``repro``.  The
host code it needs (binner, trees, trainer, weight rules, CSR build) is
carried as its own copy, so the two packages can be held against each other.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run every op through the kernels' plain
PyTorch versions on the host.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
