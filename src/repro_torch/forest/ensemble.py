"""Forest ensembles: RandomForest and ExtraTrees.

The "ensemble context" providers of the paper (§2.2): trees and routing plus
the in-bag multiplicities and leaf payloads the SWLC weight assignments
consume.  Trees grow on the host (numpy trainer, bit-identical to the
reference's); routing and leaf-table gathers run on the forest's ``device``
through the routing kernel.  ``GradientBoostedTrees`` comes with the trainer
slice.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.leaf_route.ops import RouteTables, route, route_tables
from .bootstrap import bootstrap_counts, oob_mask
from .trees import Tree, TreeArrays, stack_leaf_values
from .training import Binner, TreeParams, fit_tree_binned

__all__ = ["RandomForest", "ExtraTrees", "BaseForest"]


def _resolve_jobs(n_jobs: Optional[int], n_tasks: int) -> int:
    if n_jobs is None or n_jobs == 0:
        n_jobs = min(8, os.cpu_count() or 1)
    return max(1, min(n_jobs, n_tasks))


def _gather_sum(table: torch.Tensor, gl: torch.Tensor,
                weights: Optional[torch.Tensor] = None,
                chunk: int = 8192) -> torch.Tensor:
    """Σ_t table[gl[i, t]] (optionally × weights[i, t]), chunked over samples
    so the (chunk, T, C) gather stays bounded."""
    n = gl.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=torch.float64,
                      device=table.device)
    for i0 in range(0, n, chunk):
        g = table[gl[i0:i0 + chunk]]                       # (c, T, C)
        if weights is not None:
            g = g * weights[i0:i0 + chunk, :, None]
        out[i0:i0 + chunk] = g.sum(dim=1)
    return out


@dataclasses.dataclass
class BaseForest:
    n_trees: int = 100
    max_depth: int = 64
    min_samples_leaf: int = 1
    min_samples_split: int = 2
    max_features: Optional[str] = "sqrt"
    n_bins: int = 64
    bootstrap: bool = True
    task: str = "classification"
    seed: int = 0
    splitter: str = "best"
    n_jobs: int = 0                  # 0 -> auto (min(8, cpus)), 1 -> serial
    device: str = "cuda"             # where routing and leaf gathers run

    # fitted state
    trees_: Optional[List[Tree]] = None
    inbag_: Optional[np.ndarray] = None          # (T, N) int32
    n_classes_: int = 0
    binner_: Optional[Binner] = None
    X_: Optional[np.ndarray] = None
    y_: Optional[np.ndarray] = None
    tree_weights_: Optional[np.ndarray] = None   # (T,)
    tree_arrays_: Optional[TreeArrays] = None    # padded SoA, cached at fit
    leaf_values_: Optional[np.ndarray] = None    # (L, value_dim) global table
    route_tables_: Optional[RouteTables] = None  # flat node tables on device
    leaf_table_: Optional[torch.Tensor] = None   # (L, C) probs or (L,) means

    def _params(self) -> TreeParams:
        return TreeParams(
            task=self.task, n_classes=self.n_classes_, max_depth=self.max_depth,
            min_samples_leaf=self.min_samples_leaf,
            min_samples_split=self.min_samples_split,
            max_features=self.max_features, n_bins=self.n_bins,
            splitter=self.splitter)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BaseForest":
        resolve_device(self.device)          # fail before training, not after
        rng = np.random.default_rng(self.seed)
        X = np.asarray(X, dtype=np.float64)
        self.X_, self.y_ = X, y
        if self.task == "classification":
            y = np.asarray(y, dtype=np.int64)
            self.n_classes_ = int(y.max()) + 1
        else:
            y = np.asarray(y, dtype=np.float64)
            self.n_classes_ = 0
        self.binner_ = Binner(X, self.n_bins, rng)
        self.inbag_ = bootstrap_counts(len(X), self.n_trees, rng, self.bootstrap)
        params = self._params()
        # Independent per-tree RNG streams (SeedSequence spawn) keep results
        # deterministic under any worker-pool schedule.
        child_rngs = rng.spawn(self.n_trees)
        Xb = self.binner_.transform(X)

        def fit_one(t: int) -> Tree:
            w = self.inbag_[t]
            sel = np.nonzero(w)[0]
            return fit_tree_binned(Xb[sel], y[sel], w[sel].astype(np.float64),
                                   params, child_rngs[t], self.binner_)

        jobs = _resolve_jobs(self.n_jobs, self.n_trees)
        if jobs == 1:
            self.trees_ = [fit_one(t) for t in range(self.n_trees)]
        else:
            with ThreadPoolExecutor(max_workers=jobs) as ex:
                self.trees_ = list(ex.map(fit_one, range(self.n_trees)))
        self.tree_weights_ = np.ones(self.n_trees, dtype=np.float64)
        self._cache_tables()
        return self

    def _cache_tables(self) -> None:
        """Routing tables and the global leaf-value table, built once and
        kept on the forest's device."""
        dev = resolve_device(self.device)
        self.tree_arrays_ = TreeArrays.from_trees(self.trees_)
        self.leaf_values_ = stack_leaf_values(self.trees_)
        self.route_tables_ = route_tables(self.tree_arrays_, dev)
        v = self.leaf_values_
        if self.task == "classification" and self.n_classes_:
            table = v / np.maximum(v.sum(1, keepdims=True), 1e-12)
        else:
            table = v[:, 1:2]                               # (count, mean)
        self.leaf_table_ = torch.as_tensor(table, device=dev)

    # ----- routing / prediction -----
    def tree_arrays(self) -> TreeArrays:
        if self.tree_arrays_ is None:
            self._cache_tables()
        return self.tree_arrays_

    def apply(self, X) -> torch.Tensor:
        """(N, T) int32 within-tree leaf ids on the forest's device."""
        self.tree_arrays()
        tables = self.route_tables_
        return route(torch.as_tensor(X, dtype=torch.float64,
                                     device=tables.device), tables)

    def _global_leaves(self, leaves: torch.Tensor) -> torch.Tensor:
        off = torch.as_tensor(self.tree_arrays().leaf_offset,
                              device=leaves.device)
        return leaves.long() + off[None, :]

    def predict_proba(self, X) -> torch.Tensor:
        gl = self._global_leaves(self.apply(X))
        return _gather_sum(self.leaf_table_, gl) / gl.shape[1]

    def predict(self, X) -> torch.Tensor:
        if self.task == "classification":
            return self.predict_proba(X).argmax(1)
        gl = self._global_leaves(self.apply(X))
        return _gather_sum(self.leaf_table_, gl)[:, 0] / gl.shape[1]

    def oob_predict(self, X=None) -> torch.Tensor:
        """Forest OOB class probabilities on the training set."""
        gl = self._global_leaves(self.apply(self.X_ if X is None else X))
        m = torch.as_tensor(oob_mask(self.inbag_).T, dtype=torch.float64,
                            device=gl.device)                 # (N, T)
        probs = _gather_sum(self.leaf_table_, gl, weights=m)
        return probs / m.sum(1).clamp_min(1e-12)[:, None]


class RandomForest(BaseForest):
    pass


@dataclasses.dataclass
class ExtraTrees(BaseForest):
    bootstrap: bool = False
    splitter: str = "random"
