"""Spectral methods on sparse leaf coordinates (paper §4.3), on the host.

Leaf-PCA: principal components of the (implicitly mean-centered) leaf map
Q ∈ R^{N×L}, computed with ARPACK/Lanczos via a LinearOperator so the dense
centered matrix is never formed.  ``kernel_eigs`` (P = QQᵀ from Q's SVD)
and ``operator_eigs`` (Lanczos on a symmetric LinearOperator, whose
products may run on the device) are the eigen-solvers of the proximity
embedding.  Copies of the reference's code, with its ``v0`` seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, eigsh, svds

__all__ = ["LeafPCA", "kernel_eigs", "operator_eigs"]


@dataclasses.dataclass
class LeafPCA:
    n_components: int = 50
    center: bool = True
    seed: int = 0

    mean_: Optional[np.ndarray] = None          # (L,) column means
    components_: Optional[np.ndarray] = None    # (k, L) right singular vectors
    singular_values_: Optional[np.ndarray] = None

    def fit(self, Q: sp.csr_matrix) -> "LeafPCA":
        n, L = Q.shape
        k = min(self.n_components, min(n, L) - 1)
        mean = np.asarray(Q.mean(axis=0)).ravel() if self.center else np.zeros(L)
        ones = np.ones(n)

        def mv(v):          # (Q - 1 meanᵀ) v     — robust to (L,) and (L,1)
            v = np.asarray(v).ravel()
            return Q @ v - ones * float(mean @ v)

        def rmv(v):         # (Q - 1 meanᵀ)ᵀ v
            v = np.asarray(v).ravel()
            return Q.T @ v - mean * float(ones @ v)

        op = LinearOperator((n, L), matvec=mv, rmatvec=rmv,
                            matmat=lambda V: Q @ V - np.outer(ones, mean @ V),
                            dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        v0 = rng.normal(size=min(n, L))
        u, s, vt = svds(op, k=k, v0=v0)
        order = np.argsort(-s)
        self.mean_ = mean
        self.components_ = vt[order]
        self.singular_values_ = s[order]
        return self

    def transform(self, Q: sp.csr_matrix) -> np.ndarray:
        Z = Q @ self.components_.T
        if self.center:
            Z = Z - self.mean_ @ self.components_.T
        return np.asarray(Z)

    def fit_transform(self, Q: sp.csr_matrix) -> np.ndarray:
        return self.fit(Q).transform(Q)


def kernel_eigs(Q: sp.csr_matrix, k: int = 10, seed: int = 0):
    """Top eigenpairs of the (uncentered) Gram kernel P = QQᵀ from Q's SVD:
    (eigvals = s², eigvecs = U), descending; never forms P."""
    rng = np.random.default_rng(seed)
    u, s, _ = svds(Q.astype(np.float64), k=k,
                   v0=rng.normal(size=min(Q.shape)))
    order = np.argsort(-s)
    return (s ** 2)[order], u[:, order]


def operator_eigs(op: LinearOperator, k: int = 10, seed: int = 0):
    """Top-k eigenpairs of a symmetric LinearOperator via Lanczos, for the
    asymmetric kernels (the caller symmetrizes P through its factored
    products, ½(P + Pᵀ)v).  Returns (eigvals, eigvecs), descending."""
    rng = np.random.default_rng(seed)
    vals, vecs = eigsh(op, k=k, v0=rng.normal(size=op.shape[0]))
    order = np.argsort(-vals)
    return vals[order], vecs[:, order]
