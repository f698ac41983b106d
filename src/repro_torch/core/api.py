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
"gbt", ``kernel_method`` "original", "kerf", "oob", "gap", "ih" and
"boosted", the proximity applications (imputation, outlier scores,
prototypes and compression, label propagation, embedding), the
depth-prefix engine, durable snapshots (``save``/``load``, in the
reference's archive format, read and written by both packages) and
serving (``serve``: a ``ProximityServer``; ``serve_tiered``: the
shallow → compressed → full ladder).

Out of core: ``scratch_dir`` streams the binned codes into a memmap there
(removed when the fit ends) and is where the CSR factors spill;
``memory_budget_bytes`` bounds the transients of the context build (K1
routes the training set in row chunks), of the CSR build, and of the
engine's ops.  The answers are the in-memory kernel's.
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
    kernel_method: str = "gap"  # 'original'|'kerf'|'oob'|'gap'|'ih'|'boosted'
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
    scratch_dir: Optional[str] = None        # out-of-core: disk scratch for
    #                                          binned codes / factor spill
    memory_budget_bytes: Optional[int] = None  # out-of-core: bound transient
    #                                            build + op intermediates

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
            tree_backend=self.tree_backend, xb_scratch=self.scratch_dir)

    def fit_forest(self, X: np.ndarray, y: np.ndarray) -> "ForestKernel":
        self.forest = self._forest()
        self.forest.fit(X, y)
        return self

    def _context_row_chunk(self) -> Optional[int]:
        """Routing and mass-accumulation chunk under the memory budget:
        ~32 transient bytes a (row, tree) cell during the context build."""
        if self.memory_budget_bytes is None:
            return None
        return max(1024, self.memory_budget_bytes // max(32 * self.n_trees,
                                                         1))

    def build_kernel_cache(self) -> "ForestKernel":
        if self.forest is None:
            raise ValueError("call fit_forest first")
        self.ctx = EnsembleContext.from_forest(
            self.forest, row_chunk=self._context_row_chunk())
        self.assignment = get_assignment(self.kernel_method, self.ctx)
        self.engine = ProximityEngine(
            self.ctx, self.assignment, forest=self.forest,
            memory_budget_bytes=self.memory_budget_bytes,
            factor_scratch_dir=self.scratch_dir)
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

    # ---------------- durable snapshots ----------------
    def save(self, path) -> dict:
        """Snapshot the fitted kernel (trees, binner, θ, weight factors) to
        a single checksummed npz archive in the reference's format (the
        reference's ``ForestKernel.load`` reads it too); see
        ``repro_torch.core.snapshot``.  Returns the written manifest."""
        from .snapshot import save_kernel
        return save_kernel(self, path)

    @classmethod
    def load(cls, path, device="cuda") -> "ForestKernel":
        """Warm-start a ForestKernel on ``device`` from :meth:`save` output
        or from an archive the reference wrote — validates checksums and
        version, rebuilds the engine from the saved factors (no refit, no
        routing of the training set, no weight recomputation), and verifies
        that the result is structurally identical to the saved engine."""
        from .snapshot import load_kernel
        return load_kernel(path, device=device)

    # ---------------- serving ----------------
    def serve(self, n_slots: int = 64, engine=None, **kw):
        """A ``ProximityServer`` over this kernel's engine (or a compressed
        engine passed via ``engine=``); see ``repro_torch.serve.proximity``.

        Extra keyword arguments pass through — notably ``registry=``
        (a ``repro_torch.obs.metrics.MetricsRegistry``; one is created by
        default) and ``tracer=`` (a ``repro_torch.obs.trace.Tracer`` for
        per-request span trees)."""
        from ..serve.proximity import ProximityServer
        eng = self.engine if engine is None else engine
        y = getattr(eng, "prototype_labels_", None)
        if y is None:
            y = self.ctx.y
        return ProximityServer(eng, y=y, n_slots=n_slots, **kw)

    def serve_tiered(self, prefix_depth: Optional[int] = 4,
                     compressed_engine=None, n_prototypes: int = 10,
                     proto_k: int = 50, n_slots: int = 64,
                     escalate_margin: float = 0.1, clock=None,
                     propagator=None, embedding=None, **reliability_kw):
        """A ``TieredProximityServer`` over the engine ladder
        shallow (depth-prefix) → prototype-compressed → full.

        ``prefix_depth=None`` drops the shallow tier;
        ``compressed_engine=None`` builds one via :meth:`compress`.
        ``propagate`` / ``embed`` requests (when enabled) route straight to
        the full tier — they are fitted against the full reference set.
        Extra keyword arguments (``fault_injector``, ``retry``,
        ``breaker_threshold``, ``spill_watermark``, ``adaptive_margin``,
        ``registry``, ``tracer``, ...) pass through to
        ``TieredProximityServer`` — the ladder shares one metrics
        registry across its tiers and traces every request by default
        (``srv.tracer.export(path)`` writes Chrome-trace JSON).
        """
        import time as _time
        from ..serve.proximity import Tier, TieredProximityServer
        y = self.ctx.y
        C = self.forest.n_classes_
        tiers = []
        if prefix_depth is not None:
            tiers.append(Tier("shallow", self.prefix_engine(prefix_depth),
                              y=y, kinds=("predict",), n_slots=n_slots,
                              n_classes=C))
        ce = compressed_engine
        if ce is None:
            ce = self.compress(n_prototypes=n_prototypes, k=proto_k)
        tiers.append(Tier("compressed", ce, y=ce.prototype_labels_,
                          kinds=("predict", "topk", "outlier"),
                          n_slots=n_slots, n_classes=C))
        full_kinds = ["predict", "topk", "outlier"]
        if propagator is not None:
            full_kinds.append("propagate")
        if embedding is not None:
            full_kinds.append("embed")
        tiers.append(Tier("full", self.engine, y=y,
                          kinds=tuple(full_kinds), n_slots=n_slots,
                          n_classes=C, propagator=propagator,
                          embedding=embedding))
        return TieredProximityServer(tiers, escalate_margin=escalate_margin,
                                     clock=_time.time if clock is None
                                     else clock, **reliability_kw)

    # ---------------- proximity applications ----------------
    def _config_kwargs(self) -> dict:
        """The constructor config (for subsystems that refit internally)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("forest", "ctx", "assignment", "engine",
                                  "Q_", "W_")}

    def impute(self, X: np.ndarray, y: np.ndarray, n_iter: int = 5,
               categorical=(), tol: float = 1e-3):
        """Iterative proximity-weighted imputation of NaN entries in X.

        Uses this kernel's config, ``device`` included, for the
        per-iteration refits (callable on an unfitted ForestKernel).
        Returns the fitted ProximityImputer — the filled matrix is
        ``.X_imputed_``, convergence in ``.history_``.
        """
        from ..applications.imputation import ProximityImputer
        imp = ProximityImputer(n_iter=n_iter, categorical=categorical,
                               tol=tol, kernel_kwargs=self._config_kwargs())
        imp.fit_transform(X, y)
        return imp

    def outlier_scores(self, normalize: bool = True,
                       block: int = 4096) -> torch.Tensor:
        """Within-class outlier scores n_c / Σ_{j∈c} P(i,j)², median/MAD
        normalized per class."""
        from ..applications.outliers import outlier_scores
        return outlier_scores(self.engine, self.ctx.y, normalize=normalize,
                              block=block)

    def oos_outlier_scores(self, X, y_query=None, normalize: bool = True,
                           block: int = 4096) -> torch.Tensor:
        """Out-of-sample outlier scores against cached per-class *training*
        statistics (see ``applications.outliers.oos_outlier_scores``)."""
        from ..applications.outliers import oos_outlier_scores
        return oos_outlier_scores(self.engine, self.ctx.y, X,
                                  y_query=y_query, normalize=normalize,
                                  block=block)

    def compress(self, n_prototypes: int = 10, k: int = 50):
        """Prototype-compressed engine (k·C reference columns instead of N)
        for low-memory serving; see ``applications.prototypes.compress``."""
        from ..applications.prototypes import compress
        return compress(self.engine, self.ctx.y, n_prototypes=n_prototypes,
                        k=k)

    def prefix_engine(self, depth: int):
        """Depth-``depth`` prefix-factorization engine (DiNo/RanBu tier):
        proximities of the depth-truncated forest, contracted from this
        kernel's fitted factors — no refit, and OOS batches reuse the full
        engine's routed states."""
        from .engine import PrefixProximityEngine
        return PrefixProximityEngine(self.engine, depth)

    def prototypes(self, n_prototypes: int = 3, k: int = 50):
        """Greedy tree-space prototypes per class: (prototypes, coverage)."""
        from ..applications.prototypes import select_prototypes
        return select_prototypes(self.engine, self.ctx.y,
                                 n_prototypes=n_prototypes, k=k)

    def propagate_labels(self, labeled, y=None, alpha: float = 0.8,
                         n_iter: int = 50, tol: float = 1e-5,
                         online: bool = False):
        """Semi-supervised label propagation: (labels, class scores), or an
        ``OnlineLabelPropagation`` serving state when ``online=True``."""
        from ..applications.propagate import propagate_labels
        yy = self.ctx.y if y is None else y
        return propagate_labels(self.engine, yy, labeled, alpha=alpha,
                                n_iter=n_iter, tol=tol, online=online)

    def embed(self, n_components: int = 2, method: str = "auto",
              seed: int = 0):
        """Proximity-MDS embedding; returns the fitted ProximityEmbedding
        (training coords in ``.embedding_``, OOS via ``.transform(X)``)."""
        from ..applications.embed import ProximityEmbedding
        return ProximityEmbedding(n_components=n_components, method=method,
                                  seed=seed).fit(self.engine)

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
