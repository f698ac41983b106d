"""Proximity-MDS embeddings with Nyström out-of-sample transform (§4.3).

Classical MDS on a similarity kernel is its spectral embedding
Z = U Λ^{1/2}; here the eigenpairs of P come from the factors, with scipy's
solvers on the host:

- symmetric kernels (q = w):  P = QQᵀ, so ``kernel_eigs`` on the host CSR
  Q gives (λ, U) exactly from Q's SVD — never forming P;
- asymmetric kernels (e.g. GAP): Lanczos on the symmetrized operator
  ``½(P + Pᵀ)v``, whose ``P v`` runs on the device (segment sums) and
  ``Pᵀ v`` through the host CSR factors;
- ``method='leafpca'``: mean-centered Leaf-PCA coordinates (centered kernel
  PCA), with OOS points embedded through their sparse ``query_map``.

The Nyström OOS transform for the eigen path embeds a query row p = P[x, :]
as  z = Λ^{-1/2} Uᵀ p  — one factored ``matmat`` on the device with
V = U Λ^{-1/2} (its bucket table cached by the engine), after routing the
batch through the routing kernel.  For symmetric kernels this reproduces
the training embedding on training rows.  For asymmetric kernels it is an
approximation: fit eigendecomposes ½(P + Pᵀ) but an OOS query only has the
query-side row Q_x Wᵀ (reference-role weights are undefined for unseen
samples), so re-embedded training rows will not land exactly on
``embedding_``.

``eigvals_`` and ``embedding_`` are host arrays (the solvers' output);
``transform`` returns a tensor on the engine's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from scipy.sparse.linalg import LinearOperator

from ..core.spectral import LeafPCA, kernel_eigs, operator_eigs

__all__ = ["ProximityEmbedding"]


@dataclasses.dataclass
class ProximityEmbedding:
    """Spectral proximity embedding (kernel MDS) on the factored kernel."""

    n_components: int = 2
    method: str = "auto"        # 'auto' | 'eigs' | 'leafpca'
    seed: int = 0

    eigvals_: Optional[np.ndarray] = None
    embedding_: Optional[np.ndarray] = None       # (N, k) training coords
    _pca: Optional[LeafPCA] = None
    _nystrom: Optional[np.ndarray] = None         # (N, k) U Λ^{-1/2}
    engine_: object = None

    def fit(self, engine) -> "ProximityEmbedding":
        self.engine_ = engine
        method = "eigs" if self.method == "auto" else self.method
        k = self.n_components
        if method == "leafpca":
            self._pca = LeafPCA(n_components=k, seed=self.seed).fit(engine.Q)
            self.embedding_ = self._pca.transform(engine.Q)
            self.eigvals_ = self._pca.singular_values_ ** 2
            return self
        if method != "eigs":
            raise ValueError(f"unknown embedding method {method!r}")
        if engine.assignment.symmetric:
            vals, vecs = kernel_eigs(engine.Q, k=k, seed=self.seed)
        else:
            op = engine.operator()
            sym = LinearOperator(
                op.shape,
                matvec=lambda v: 0.5 * (op.matvec(v) + op.rmatvec(v)),
                dtype=op.dtype)
            vals, vecs = operator_eigs(sym, k=k, seed=self.seed)
        vals = np.maximum(vals, 0.0)
        self.eigvals_ = vals
        self.embedding_ = vecs * np.sqrt(vals)[None, :]
        with np.errstate(divide="ignore"):
            inv = np.where(vals > 0, 1.0 / np.sqrt(vals), 0.0)
        self._nystrom = vecs * inv[None, :]
        return self

    def transform(self, X=None) -> torch.Tensor:
        """Embed OOS samples (or give the training embedding for X=None) as
        a tensor on the engine's device.

        Exact on training rows for symmetric kernels; a query-side Nyström
        approximation for asymmetric ones (see the module docstring).
        """
        dev = self.engine_.device
        if X is None:
            return torch.as_tensor(self.embedding_, device=dev)
        if self._pca is not None:
            return torch.as_tensor(
                self._pca.transform(self.engine_.query_state(X).Q),
                device=dev)
        return self.engine_.matmat(self._nystrom, X=X)

    def fit_transform(self, engine) -> np.ndarray:
        return self.fit(engine).embedding_
