"""ForestKernel — the paper's unified user-facing API (Appendix D), on the
card.

Three stages:
  1. ``fit_forest(X, y)``        — train the forest (on the card through the
                                   histogram kernels; the host numpy
                                   trainer on the CPU).
  2. ``build_kernel_cache()``    — route the training set on the device,
                                   compute θ and the SWLC factors there, and
                                   build the host CSR maps Q/W.
  3. kernel ops                  — full kernel / blocks / operator / OOS
                                   query maps / proximity-weighted
                                   prediction / top-k / leaf-PCA.

``fit`` = fit_forest + build_kernel_cache.  ``device="cuda"`` (the default)
raises when no card is present; ``device="cpu"`` runs the same path through
the kernels' plain versions.  Covered here: ``model_type`` "rf", "et" and
"gbt", ``kernel_method`` "original", "kerf", "oob", "gap" and "boosted".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device
from ..forest.ensemble import (BaseForest, ExtraTrees, GradientBoostedTrees,
                               RandomForest)
from .context import EnsembleContext
from .engine import ProximityEngine
from .leafmap import sparse_bytes
from .spectral import LeafPCA
from .weights import WeightAssignment, get_assignment

__all__ = ["ForestKernel"]

_MODEL_TYPES = {"rf": RandomForest, "et": ExtraTrees,
                "gbt": GradientBoostedTrees}


@dataclasses.dataclass
class ForestKernel:
    model_type: str = "rf"           # 'rf' | 'et' | 'gbt'
    kernel_method: str = "gap"       # 'original'|'kerf'|'oob'|'gap'|'boosted'
    task: str = "classification"
    n_trees: int = 100
    max_depth: int = 64
    min_samples_leaf: int = 1
    max_features: Optional[str] = "sqrt"
    n_bins: int = 64
    seed: int = 0
    n_jobs: int = 0                  # host tree-fitting workers (0 = auto)
    device: str = "cuda"             # 'cuda' | 'cpu' (no silent fallback)
    tree_backend: str = "auto"       # trainer: 'auto' | 'numpy' | 'torch'

    forest: Optional[BaseForest] = None
    ctx: Optional[EnsembleContext] = None
    assignment: Optional[WeightAssignment] = None
    engine: Optional[ProximityEngine] = None
    Q_: Optional[sp.csr_matrix] = None   # training query map (N, L)
    W_: Optional[sp.csr_matrix] = None   # reference map (N, L)

    # ---------------- fitting ----------------
    def _forest(self) -> BaseForest:
        if self.model_type not in _MODEL_TYPES:
            raise ValueError(f"unknown model_type {self.model_type!r}; have "
                             f"{sorted(_MODEL_TYPES)}")
        return _MODEL_TYPES[self.model_type](
            n_trees=self.n_trees, max_depth=self.max_depth,
            min_samples_leaf=self.min_samples_leaf,
            max_features=self.max_features, n_bins=self.n_bins,
            task=self.task, seed=self.seed, n_jobs=self.n_jobs,
            device=str(resolve_device(self.device)),
            tree_backend=self.tree_backend)

    def fit_forest(self, X: np.ndarray, y: np.ndarray) -> "ForestKernel":
        self.forest = self._forest()
        self.forest.fit(X, y)
        return self

    def build_kernel_cache(self) -> "ForestKernel":
        if self.forest is None:
            raise ValueError("call fit_forest first")
        self.ctx = EnsembleContext.from_forest(self.forest)
        self.assignment = get_assignment(self.kernel_method, self.ctx)
        self.engine = ProximityEngine(self.ctx, self.assignment,
                                      forest=self.forest)
        self.Q_ = self.engine.Q
        self.W_ = self.engine.W
        return self

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ForestKernel":
        return self.fit_forest(X, y).build_kernel_cache()

    # ---------------- maps ----------------
    def reference_map(self) -> sp.csr_matrix:
        return self.W_

    def query_map(self, X=None) -> sp.csr_matrix:
        """Training query map (X=None) or the OOS query map of new samples
        (routed on the device, cached in the engine)."""
        return self.engine.query_state(X).Q

    # ---------------- kernel ops ----------------
    def kernel(self, set_diagonal: bool = True) -> sp.csr_matrix:
        d = self.assignment.diagonal if set_diagonal else None
        return self.engine.full_kernel(diagonal=d)

    def kernel_block(self, rows, cols=None, X_rows=None) -> torch.Tensor:
        r = None if X_rows is not None else rows
        return self.engine.kernel_block(r, cols, X_rows=X_rows)

    def operator(self):
        return self.engine.operator()

    def topk(self, k: int = 10, X=None):
        """(indices, values) of each query row's k largest proximities."""
        return self.engine.topk(k, X=X)

    # ---------------- downstream ----------------
    def predict(self, X=None) -> torch.Tensor:
        """Proximity-weighted prediction (train-set if X is None, else OOS)."""
        y = self.ctx.y
        if self.task == "classification":
            scores = self.engine.predict(y, n_classes=self.forest.n_classes_,
                                         X=X)
            return scores.argmax(1)
        return self.engine.predict(y, X=X)

    def leaf_pca(self, n_components: int = 50) -> LeafPCA:
        return LeafPCA(n_components=n_components).fit(self.Q_)

    def row_sums(self, X=None) -> torch.Tensor:
        """Kernel row sums Σ_j P(i,j) (proximity-graph degrees)."""
        return self.engine.row_sums(X=X)

    # ---------------- accounting ----------------
    def memory_bytes(self) -> dict:
        """Bytes of cached metadata + factors (the paper's reported memory)."""
        ctx = self.ctx

        def nbytes(a):
            if isinstance(a, torch.Tensor):
                return a.numel() * a.element_size()
            return a.nbytes
        meta = sum(nbytes(a) for a in [
            ctx.leaves, ctx.leaf_mass, ctx.leaf_mass_inbag, ctx.leaf_offset]
            if a is not None)
        if ctx.inbag is not None:
            meta += nbytes(ctx.inbag) + nbytes(ctx.oob) + nbytes(ctx.oob_count)
        out = {"metadata": int(meta), "Q": sparse_bytes(self.Q_),
               "W": 0 if self.W_ is self.Q_ else sparse_bytes(self.W_)}
        out["total"] = sum(out.values())
        return out
