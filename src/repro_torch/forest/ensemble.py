"""Forest ensembles: RandomForest, ExtraTrees, GradientBoostedTrees.

The "ensemble context" providers of the paper (§2.2): trees and routing plus
the in-bag multiplicities, leaf payloads and tree weights the SWLC weight
assignments consume.  Trees grow on the forest's ``device``
(``tree_backend="auto"``): on the card as one level-synchronous batch
through the histogram kernels, on the CPU with the host numpy trainer (both
bit-identical to the reference's numpy trainer on integer payloads).
Routing and leaf-table gathers run on the device through the routing
kernel.  With ``xb_scratch`` the binned codes stream into a disk-backed
memmap under that directory (out of core): the card trainer then stages
each histogram call's rows instead of copying the code matrix up, and the
file is removed when the fit ends, whether it succeeds or raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.leaf_route.ops import RouteTables, route, route_tables
from .bootstrap import bootstrap_counts, oob_mask
from .trees import Tree, TreeArrays, stack_leaf_values, truncate_tree
from .training import (Binner, TreeParams, _grow_trees, _is_streamed,
                       device_codes, fit_forest_binned, fit_tree_binned,
                       resolve_tree_backend)

__all__ = ["RandomForest", "ExtraTrees", "GradientBoostedTrees",
           "BaseForest"]


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
    n_jobs: int = 0                  # host trainer: 0 -> auto (min(8,
    #                                  cpus)), 1 -> serial
    device: str = "cuda"             # where trees grow, route and gather
    tree_backend: str = "auto"       # trainer: 'auto' | 'numpy' | 'torch'
    tree_block: int = 0              # torch batch width (0 auto, <0 all)
    xb_scratch: Optional[str] = None  # out-of-core fit: directory for the
    #                                   disk-backed binned-code file (streamed
    #                                   in, trained from, removed on success
    #                                   and on failure)

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
            splitter=self.splitter, tree_backend=self.tree_backend)

    @contextlib.contextmanager
    def _binned_codes(self, X: np.ndarray):
        """The fit's binned codes: in memory by default, or, when
        ``xb_scratch`` names a directory, streamed chunk by chunk into a
        uniquely named memmap there (concurrent fits never collide).  The
        file is unlinked when the block exits, success or failure; the live
        mapping stays valid until its last reference drops."""
        if self.xb_scratch is None:
            yield self.binner_.transform(X)
            return
        os.makedirs(self.xb_scratch, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix="xb_", suffix=".mm",
                                    dir=self.xb_scratch)
        os.close(fd)
        try:
            yield self.binner_.transform_memmap(X, path)
        finally:
            os.unlink(path)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BaseForest":
        dev = resolve_device(self.device)    # fail before training, not after
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

        with self._binned_codes(X) as Xb:
            if resolve_tree_backend(self.tree_backend, dev) == "torch":
                # one level-synchronous batch: each level's histograms for
                # every tree's frontier in one kernel launch per node chunk,
                # with no thread pool on top
                self.trees_ = fit_forest_binned(
                    Xb, y, self.inbag_, params, child_rngs, self.binner_,
                    backend="torch", tree_block=self.tree_block, device=dev)
            else:
                def fit_one(t: int) -> Tree:
                    w = self.inbag_[t]
                    sel = np.nonzero(w)[0]
                    return fit_tree_binned(Xb[sel], y[sel],
                                           w[sel].astype(np.float64), params,
                                           child_rngs[t], self.binner_, dev)

                jobs = _resolve_jobs(self.n_jobs, self.n_trees)
                if jobs == 1:
                    self.trees_ = [fit_one(t) for t in range(self.n_trees)]
                else:
                    with ThreadPoolExecutor(max_workers=jobs) as ex:
                        self.trees_ = list(ex.map(fit_one,
                                                  range(self.n_trees)))
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

    def truncated(self, depth: int) -> "BaseForest":
        """The depth-``depth`` prefix of this fitted forest (DiNo/RanBu):
        every tree replaced by :func:`~.trees.truncate_tree`'s prefix, the
        in-bag counts, binner and training set shared with this forest, and
        the routing tables rebuilt on this forest's device, so the routing
        kernel routes it.  No refit."""
        out = dataclasses.replace(
            self, trees_=[truncate_tree(t, depth) for t in self.trees_],
            tree_arrays_=None, leaf_values_=None, route_tables_=None,
            leaf_table_=None)
        out._cache_tables()
        return out

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


@dataclasses.dataclass
class GradientBoostedTrees(BaseForest):
    """Squared-loss (regression) / logistic (binary) gradient boosting.

    Per-tree contribution weights ``tree_weights_`` record the training-loss
    improvement of each stage (clamped at >= 0), the empirical weighting used
    by boosted proximities (Tan et al. 2020; paper §B.6).  Each stage's tree
    grows on the forest's device and routes the training set through the
    routing kernel; the stage update of ``F`` and the losses are the
    reference's float64 host arithmetic, in its order.
    """
    learning_rate: float = 0.1
    bootstrap: bool = False
    max_features: Optional[str] = None
    max_depth: int = 6

    base_score_: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedTrees":
        dev = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        X = np.asarray(X, dtype=np.float64)
        self.X_, self.y_ = X, y
        binary = self.task == "classification"
        yf = np.asarray(y, dtype=np.float64)
        if binary:
            if not set(np.unique(yf)) <= {0.0, 1.0}:
                raise ValueError("GBT classification is binary (labels 0/1)")
            p0 = np.clip(yf.mean(), 1e-6, 1 - 1e-6)
            self.base_score_ = float(np.log(p0 / (1 - p0)))
            self.n_classes_ = 2
        else:
            self.base_score_ = float(yf.mean())
            self.n_classes_ = 0
        self.binner_ = Binner(X, self.n_bins, rng)
        self.inbag_ = bootstrap_counts(len(X), self.n_trees, rng,
                                       self.bootstrap)

        params = self._params()
        params.task = "regression"   # boosting fits residuals
        params.n_classes = 0
        backend = resolve_tree_backend(self.tree_backend, dev)
        X_dev = torch.as_tensor(X, device=dev)
        F = np.full(len(X), self.base_score_)
        self.trees_ = []
        tw = []

        def loss(F):
            if binary:
                return float(np.mean(np.logaddexp(0.0, F) - yf * F))
            return float(np.mean((yf - F) ** 2))

        prev = loss(F)
        with self._binned_codes(X) as Xb:
            # in-memory codes go to the device once a fit; streamed codes
            # are staged by every stage's histogram calls
            codes = device_codes(Xb, self.binner_, dev) \
                if backend == "torch" and not _is_streamed(Xb) else None
            for t in range(self.n_trees):
                resid = (yf - 1.0 / (1.0 + np.exp(-F))) if binary \
                    else (yf - F)
                w = self.inbag_[t]
                sel = np.nonzero(w)[0].astype(np.int64)
                task = (sel, w[sel].astype(np.float64), rng)
                tr = _grow_trees(Xb, resid, [task], params, self.binner_,
                                 backend, dev, codes)[0]
                self.trees_.append(tr)
                leaves = route(X_dev, route_tables(
                    TreeArrays.from_trees([tr]), dev))[:, 0].cpu().numpy()
                F = F + self.learning_rate * tr.leaf_values()[leaves, 1]
                cur = loss(F)
                tw.append(max(prev - cur, 0.0))
                prev = cur
        tw = np.asarray(tw)
        self.tree_weights_ = tw / max(tw.sum(), 1e-12)
        self._cache_tables()
        return self

    def _cache_tables(self) -> None:
        super()._cache_tables()
        # every stage is a regression tree: the table is its leaf means
        self.leaf_table_ = torch.as_tensor(self.leaf_values_[:, 1:2],
                                           device=self.leaf_table_.device)

    def decision_function(self, X) -> torch.Tensor:
        """(N,) float64 raw scores on the forest's device."""
        gl = self._global_leaves(self.apply(X))
        return self.base_score_ + \
            self.learning_rate * _gather_sum(self.leaf_table_, gl)[:, 0]

    def predict(self, X) -> torch.Tensor:
        F = self.decision_function(X)
        if self.task == "classification":
            return (F > 0).to(torch.int64)
        return F
