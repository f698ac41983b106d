"""Exact finite-sample sparse factorization P = Q Wᵀ (Prop 3.6, row-wise),
on the host (copy of the reference's scipy code).

With row-stacked leaf maps Q, W ∈ R^{N×L}, the proximity matrix is
``P = Q @ W.T`` — a sparse·sparseᵀ product whose work is restricted to
leaf-colliding pairs: O(N T λ̄) (paper §3.3).  The engine uses these for
the full kernel, the operator's transpose, and train-side all-pairs jobs
(top-k, squared row sums) above its sparse cutover; they are also the
host reference ``chip_smoke.py`` holds the device ops against.
``streamed_leaf_map`` is the out-of-core CSR build: row chunks in, and
indices and data spilled to unlinked scratch memmaps past a threshold.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import LinearOperator

from ..forest.trees import prefix_leaf_map

__all__ = ["factor_digest", "full_kernel", "kernel_block",
           "kernel_matvec_operator", "topk_neighbors",
           "prefix_leaf_contraction", "naive_swlc", "streamed_leaf_map"]


def _scratch_array(shape, dtype, scratch_dir: Optional[str]) -> np.ndarray:
    """Anonymous disk-backed array: the scratch file is unlinked as soon as
    the mapping is live, so the space is reclaimed when the array dies and
    nothing leaks even if the process is killed mid-build (Linux)."""
    os.makedirs(scratch_dir or tempfile.gettempdir(), exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="leafmap_", suffix=".mm",
                                dir=scratch_dir)
    os.close(fd)
    try:
        return np.memmap(path, dtype=dtype, mode="w+", shape=shape)
    finally:
        os.unlink(path)


def streamed_leaf_map(global_leaves, weights, total_leaves: int,
                      dtype=np.float64, row_chunk: int = 65536,
                      memmap_threshold_bytes: Optional[int] = None,
                      scratch_dir: Optional[str] = None) -> sp.csr_matrix:
    """Out-of-core :func:`~repro_torch.core.leafmap.build_leaf_map` (copy
    of the reference's).

    Builds the same CSR (N, L) leaf map from row chunks of
    ``global_leaves``/``weights`` (anything whose row slices convert to
    arrays: an ``np.memmap``, or the engine's view of device factors)
    without materializing the (N, T) mask or the whole nonzero scatter at
    once.  Two passes: chunked nonzero counts fix ``indptr``/nnz exactly,
    then each chunk's entries are sorted per row by column (global leaf
    ranges are disjoint per tree, so the order is unambiguous) and written
    into the preallocated ``indices``/``data``.

    Bit-identical to the in-memory build: scipy's constructor picks the
    index dtype (int32 when everything fits, int64 otherwise), which is
    replicated by probing an empty matrix of the same shape.  When
    ``memmap_threshold_bytes`` is set and indices + data would exceed it,
    they are backed by unlinked scratch memmaps under ``scratch_dir``.
    """
    n, T = global_leaves.shape
    indptr64 = np.zeros(n + 1, dtype=np.int64)
    for i0 in range(0, n, row_chunk):
        i1 = min(i0 + row_chunk, n)
        w_c = np.ascontiguousarray(np.asarray(weights[i0:i1]), dtype=dtype)
        indptr64[i0 + 1:i1 + 1] = (w_c != 0).sum(1)
    np.cumsum(indptr64, out=indptr64)
    nnz = int(indptr64[-1])

    # scipy's csr_matrix((data, indices, indptr), shape) downcasts the index
    # arrays via get_index_dtype; probe its choice on this shape and only
    # override when the nnz itself demands 64-bit
    probe = sp.csr_matrix((np.zeros(0, dtype=dtype),
                           np.zeros(0, dtype=np.int64),
                           np.zeros(n + 1, dtype=np.int64)),
                          shape=(n, total_leaves))
    idx_dtype = np.dtype(np.int64 if nnz > np.iinfo(np.int32).max
                         else probe.indices.dtype)

    total_bytes = nnz * (idx_dtype.itemsize + np.dtype(dtype).itemsize)
    if memmap_threshold_bytes is not None and \
            total_bytes > memmap_threshold_bytes:
        indices = _scratch_array((nnz,), idx_dtype, scratch_dir)
        data = _scratch_array((nnz,), np.dtype(dtype), scratch_dir)
    else:
        indices = np.empty(nnz, dtype=idx_dtype)
        data = np.empty(nnz, dtype=dtype)

    for i0 in range(0, n, row_chunk):
        i1 = min(i0 + row_chunk, n)
        gl_c = np.asarray(global_leaves[i0:i1])
        w_c = np.ascontiguousarray(np.asarray(weights[i0:i1]), dtype=dtype)
        nz = w_c != 0
        cnt = nz.sum(1)
        if not cnt.any():
            continue
        rr = np.repeat(np.arange(i1 - i0), cnt)
        ii = gl_c[nz]
        dd = w_c[nz]
        # per-row column sort == csr.sort_indices() on this slice
        order = np.lexsort((ii, rr))
        lo, hi = int(indptr64[i0]), int(indptr64[i1])
        indices[lo:hi] = ii[order]
        data[lo:hi] = dd[order]

    m = sp.csr_matrix((n, total_leaves), dtype=dtype)
    m.data, m.indices = data, indices
    m.indptr = indptr64.astype(idx_dtype, copy=False)
    m.has_sorted_indices = True
    return m


def factor_digest(gl, q, w=None) -> str:
    """Structural sha256 of the factored form of P = Q Wᵀ — the reference's
    ``factor_digest``, string for string.

    Hashes shapes, dtypes and exact bytes of the dense factor arrays
    (global leaves, query weights, reference weights when asymmetric), so
    two engines with equal digests produce identical kernels.  Tensors are
    hashed as host copies in the reference's dtypes (``gl`` int64, ``q`` and
    ``w`` in their own float64 or float32, as the engine's ``dtype``), so
    the digest of a port engine equals the reference's for the same
    factors.
    """
    h = hashlib.sha256()
    parts = ((gl, np.int64), (q, None))
    if w is not None and w is not q:
        parts += ((w, None),)
    for a, dt in parts:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a, dtype=dt)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


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
    """Per-query top-k proximities, streamed in row blocks (never dense
    NxN): values descending, equal values (zeros too) by ascending
    column."""
    n, n_cols = Q.shape[0], W.shape[0]
    idx = np.zeros((n, k), dtype=np.int64)
    val = np.zeros((n, k))
    WT = W.T.tocsc() if not sp.isspmatrix_csc(W.T) else W.T
    for i0 in range(0, n, block):
        B = (Q[i0:i0 + block] @ WT).tocsr()
        for r in range(B.shape[0]):
            lo, hi = B.indptr[r], B.indptr[r + 1]
            cols, vals = B.indices[lo:hi], B.data[lo:hi]
            # values descending, equal values by ascending column (the
            # order the engine's device top-k gives), zeros included
            order = np.lexsort((cols, -vals))[:k]
            c = cols[order]
            m = min(k, n_cols) - len(c)
            if m > 0:
                c = np.concatenate(
                    [c, np.setdiff1d(np.arange(len(cols) + m), cols)[:m]])
            idx[i0 + r, :len(c)] = c
            val[i0 + r, :len(order)] = vals[order]
    return idx, val


def prefix_leaf_contraction(trees, depth: int
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global leaf-contraction map for the depth-``depth`` prefix forest.

    Every leaf of a fitted tree has a unique ancestor at depth <= ``depth``
    which becomes a leaf of the truncated tree, so the prefix forest's
    (N, T) leaf codes are a gather of the full forest's,
    ``gl_k = gmap[gl_full]``.  Returns ``(gmap, n_leaves_k,
    leaf_offset_k)``: the (L_full,) int64 map from global full-forest leaf
    to global prefix-forest leaf, and the per-tree prefix leaf counts and
    offsets (``truncate_tree``'s numbering).
    """
    maps = [prefix_leaf_map(t, depth) for t in trees]
    n_leaves_k = np.array([int(m.max()) + 1 for m in maps], dtype=np.int32)
    leaf_offset_k = np.concatenate(
        [[0], np.cumsum(n_leaves_k[:-1])]).astype(np.int64)
    gmap = np.concatenate(
        [m + off for m, off in zip(maps, leaf_offset_k)]).astype(np.int64)
    return gmap, n_leaves_k, leaf_offset_k


def naive_swlc(leaves_q: np.ndarray, leaves_w: np.ndarray, q: np.ndarray,
               w: np.ndarray) -> np.ndarray:
    """O(N² T) direct evaluation of Def 3.1 — the test oracle."""
    coll = leaves_q[:, None, :] == leaves_w[None, :, :]        # (Nq, Nw, T)
    return np.einsum("it,jt,ijt->ij", q, w, coll.astype(np.float64))
