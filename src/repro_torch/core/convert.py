"""Carry a fitted reference kernel across to the port.

``forest_kernel_from_arrays`` rebuilds a port :class:`ForestKernel` from the
arrays the reference's snapshot writer stores (``repro/core/snapshot.py``):
``tree_*`` as ``pack_trees`` gives them, ``inbag``, ``tree_weights``,
``binner_*``, ``X``, ``y`` and the routed training ``leaves``, plus the
manifest's ``base_score`` for a gradient-boosted kernel.  The dict an
``np.load`` of a v2 snapshot returns works as input.  The training set is
not routed again and the SWLC factors are recomputed on the device from the
saved leaves (for ``kernel_method="ih"`` from the saved ``X``, ``y`` and the
trees' split features too), so the result computes the same kernel as the
source.  It validates no checksum: ``core.snapshot.load_kernel`` reads
whole archives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..forest.training import Binner
from ..forest.trees import unpack_trees
from .api import ForestKernel
from .context import EnsembleContext
from .engine import ProximityEngine
from .weights import get_assignment

__all__ = ["forest_kernel_from_arrays"]

_TREE_KEYS = ("node_offset", "depth", "feature", "threshold", "left",
              "right", "leaf_id", "value", "n_node_samples")


def forest_kernel_from_arrays(arrays, config: dict, device="cuda",
                              base_score: Optional[float] = None
                              ) -> ForestKernel:
    """A port ``ForestKernel`` on ``device`` from saved reference arrays.

    ``config`` is the reference kernel's constructor config (a snapshot
    manifest's ``"config"``); its ``dtype`` (a type or its name, float64
    or float32) and out-of-core settings are kept, and the engine is built
    under them.  Keys the port has no counterpart for (engine, routing and
    trainer backends) are ignored, because the port has one path for each:
    in particular the reference's ``tree_backend`` ('native', 'jax', ...)
    is dropped, and the port's resolves from ``device``.  ``base_score`` is
    the manifest's ``"base_score"`` (a gradient-boosted kernel's initial
    score).
    """
    names = {f.name for f in dataclasses.fields(ForestKernel)}
    kw = {k: v for k, v in config.items()
          if k in names and k not in ("device", "tree_backend")}
    if "dtype" in kw:
        kw["dtype"] = np.dtype(kw["dtype"]).type
    fk = ForestKernel(**kw, device=device)
    forest = fk._forest()
    forest.trees_ = unpack_trees({k: np.asarray(arrays[f"tree_{k}"])
                                  for k in _TREE_KEYS})
    forest.inbag_ = np.ascontiguousarray(arrays["inbag"], dtype=np.int32)
    # classification payloads are class-count rows; regression stores
    # (count, mean)
    value = np.asarray(arrays["tree_value"])
    forest.n_classes_ = int(value.shape[1]) if fk.task == "classification" \
        else 0
    count = np.asarray(arrays["binner_edge_count"])
    forest.binner_ = Binner.from_state(
        arrays["binner_edges_flat"], arrays["binner_edge_offset"], count,
        max(2, int(count.max(initial=0)) + 1))
    forest.X_ = np.asarray(arrays["X"], dtype=np.float64)
    forest.y_ = np.asarray(arrays["y"])
    forest.tree_weights_ = np.asarray(arrays["tree_weights"],
                                      dtype=np.float64)
    if base_score is not None and hasattr(forest, "base_score_"):
        forest.base_score_ = float(base_score)
    forest._cache_tables()
    fk.forest = forest
    fk.ctx = EnsembleContext.from_forest(
        forest, leaves=np.ascontiguousarray(arrays["leaves"], dtype=np.int32))
    fk.assignment = get_assignment(fk.kernel_method, fk.ctx)
    fk.engine = ProximityEngine(
        fk.ctx, fk.assignment, forest=forest, dtype=fk.dtype,
        memory_budget_bytes=fk.memory_budget_bytes,
        factor_scratch_dir=fk.scratch_dir)
    fk.Q_, fk.W_ = fk.engine.Q, fk.engine.W
    return fk
