"""Exact finite-sample sparse factorization P = Q Wᵀ (Prop 3.6, row-wise),
on the host (copy of the reference's scipy code).

With row-stacked leaf maps Q, W ∈ R^{N×L}, the proximity matrix is
``P = Q @ W.T`` — a sparse·sparseᵀ product whose work is restricted to
leaf-colliding pairs: O(N T λ̄) (paper §3.3).  The engine uses these for
the full kernel, the operator's transpose, and train-side all-pairs jobs
(top-k, squared row sums) above its sparse cutover; they are also the
host reference ``chip_smoke.py`` holds the device ops against.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator

__all__ = ["full_kernel", "kernel_block", "kernel_matvec_operator",
           "topk_neighbors", "naive_swlc"]


def full_kernel(Q: sp.csr_matrix, W: sp.csr_matrix,
                diagonal: Optional[float] = None) -> sp.csr_matrix:
    """Materialize the full sparse proximity matrix P = Q Wᵀ, with the
    diagonal optionally overridden by an O(nnz) diagonal correction."""
    P = (Q @ W.T).tocsr()
    if diagonal is not None:
        n = min(P.shape)
        ii = np.arange(n)
        delta = diagonal - P.diagonal()
        D = sp.csr_matrix((delta, (ii, ii)), shape=P.shape)
        P = (P + D).tocsr()
        if diagonal == 0.0:
            P.eliminate_zeros()
    return P


def kernel_block(Q: sp.csr_matrix, W: sp.csr_matrix, rows: np.ndarray,
                 cols: Optional[np.ndarray] = None, dense: bool = True):
    """P[rows, cols] without forming P: (Q[rows] @ W[cols].T)."""
    B = Q[rows] @ (W if cols is None else W[cols]).T
    return np.asarray(B.todense()) if dense else B.tocsr()


def kernel_matvec_operator(Q: sp.csr_matrix, W: sp.csr_matrix) -> LinearOperator:
    """LinearOperator for P = Q Wᵀ: Pv = Q (Wᵀ v); O(nnz) per apply."""
    n_q, n_w = Q.shape[0], W.shape[0]

    def mv(v):
        return Q @ (W.T @ v)

    def rmv(v):
        return W @ (Q.T @ v)

    return LinearOperator((n_q, n_w), matvec=mv, rmatvec=rmv,
                          matmat=lambda V: Q @ (W.T @ V), dtype=Q.dtype)


def topk_neighbors(Q: sp.csr_matrix, W: sp.csr_matrix, k: int,
                   block: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query top-k proximities, streamed in row blocks (never dense NxN);
    a per-row ``argpartition`` keeps the selection O(nnz_row)."""
    n = Q.shape[0]
    idx = np.zeros((n, k), dtype=np.int64)
    val = np.zeros((n, k))
    WT = W.T.tocsc() if not sp.isspmatrix_csc(W.T) else W.T
    for i0 in range(0, n, block):
        B = (Q[i0:i0 + block] @ WT).tocsr()
        for r in range(B.shape[0]):
            lo, hi = B.indptr[r], B.indptr[r + 1]
            cols, vals = B.indices[lo:hi], B.data[lo:hi]
            if len(vals) > k:
                sel = np.argpartition(vals, -k)[-k:]
                cols, vals = cols[sel], vals[sel]
            order = np.argsort(-vals)
            idx[i0 + r, :len(cols)] = cols[order]
            val[i0 + r, :len(vals)] = vals[order]
    return idx, val


def naive_swlc(leaves_q: np.ndarray, leaves_w: np.ndarray, q: np.ndarray,
               w: np.ndarray) -> np.ndarray:
    """O(N² T) direct evaluation of Def 3.1 — the test oracle."""
    coll = leaves_q[:, None, :] == leaves_w[None, :, :]        # (Nq, Nw, T)
    return np.einsum("it,jt,ijt->ij", q, w, coll.astype(np.float64))
