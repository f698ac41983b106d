"""Weighted leaf-incidence maps φ_q (Def 3.1/3.3) in host CSR form.

Each sample's representation is a T-sparse vector in R^L (Lemma 3.4),
stacked **row-wise** (N × L).  Zero weights (e.g. in-bag trees for the OOB
query map) are dropped, which is where the extra sparsity of OOB/GAP
kernels comes from.  Copy of the reference's host code.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["build_leaf_map", "sparse_bytes"]


def build_leaf_map(global_leaves: np.ndarray, weights: np.ndarray,
                   total_leaves: int, dtype=np.float64) -> sp.csr_matrix:
    """CSR (N, L) with row i = φ(x_i) = Σ_t weights[i,t] e_{gl[i,t]}.

    global_leaves : (N, T) int64 — global leaf index per (sample, tree)
    weights       : (N, T) float — q_t(x_i) (zeros dropped)
    """
    n, T = global_leaves.shape
    w = np.ascontiguousarray(weights, dtype=dtype)
    nz = w != 0
    counts = nz.sum(1)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = global_leaves[nz]
    data = w[nz]
    # Rows are emitted in order because nz/global_leaves are row-major.
    m = sp.csr_matrix((data, indices, indptr), shape=(n, total_leaves))
    m.sort_indices()
    return m


def sparse_bytes(m: sp.spmatrix) -> int:
    """Actual bytes held by a scipy sparse matrix (data + index structure)."""
    if sp.issparse(m):
        parts = []
        if hasattr(m, "data"):
            parts.append(m.data)
        if hasattr(m, "indices"):
            parts.append(m.indices)
        if hasattr(m, "indptr"):
            parts.append(m.indptr)
        if hasattr(m, "row"):
            parts += [m.row, m.col]
        return int(sum(p.nbytes for p in parts))
    return int(np.asarray(m).nbytes)
