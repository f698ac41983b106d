"""Device-resident proximity engine.

``ProximityEngine`` is built **once** per fitted kernel and owns every array
the hot paths need:

- dense ``(gl, q, w)`` factors on the device (``gl`` int32 global leaf ids,
  ``q``/``w`` float64 SWLC weights of Def 3.1),
- the host CSR leaf maps ``Q``/``W`` (Lemma 3.4 factors) for the full
  kernel, the operator's transpose and train-side all-pairs jobs,
- an LRU of out-of-sample query states, so repeated ``predict(X=...)``
  calls on one batch never re-route.

Products ``P V`` run as device segment sums (``core.torch_ops``); dense
blocks, top-k and squared row sums run through the ``block_prox`` kernel,
which a CUDA engine whose leaves are small feeds its reference side grouped
by leaf (``leaf_index``, built on the device at the first such call); with
big leaves it runs the kernel's dense form.
On a CPU engine the same calls take the kernels' plain versions, and large
train-side top-k and squared row sums take the host CSR factors instead.
Results are tensors on the engine's device.

Not in this slice: the reference bucket-table LRU, the memory budget and
``PrefixProximityEngine`` (serving and out-of-core slices).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import LinearOperator

from ..kernels.block_prox.ops import (LEAF_DENSITY_MAX, LeafIndex,
                                      block_prox, build_leaf_index,
                                      leaf_density)
from . import torch_ops
from .factorization import full_kernel, topk_neighbors
from .leafmap import build_leaf_map, sparse_bytes

__all__ = ["ProximityEngine", "QueryState"]

# Dense blocks are computed this many output bytes at a time by the ops that
# reduce them (top-k, squared row sums); the kernel itself holds no
# intermediate beyond its output.
_BLOCK_BYTES = 1 << 28


class QueryState:
    """Everything needed to use a sample batch as the query side of P.

    ``gl``/``q`` live on the device; the host CSR map ``Q`` is built from
    them the first time it is read, so the device path never waits on it.
    """

    def __init__(self, gl: torch.Tensor, q: torch.Tensor, total_leaves: int,
                 Q: Optional[sp.csr_matrix] = None):
        self.gl = gl                 # (Nq, T) int32 global leaf ids
        self.q = q                   # (Nq, T) float64 query weights
        self._total_leaves = total_leaves
        self._Q = Q
        self._lock = threading.Lock()

    @property
    def n(self) -> int:
        return int(self.gl.shape[0])

    @property
    def Q(self) -> sp.csr_matrix:
        with self._lock:
            if self._Q is None:
                self._Q = build_leaf_map(
                    self.gl.cpu().numpy().astype(np.int64),
                    self.q.cpu().numpy(), self._total_leaves)
            return self._Q


class ProximityEngine:
    """Serves matvec / matmat / predict / topk / kernel_block for P = Q Wᵀ."""

    # On a CPU engine, above this reference-set size, train-side (X=None)
    # topk and squared row sums take the host CSR path: those are all-pairs
    # batch jobs where CSR restricts work to colliding pairs, while the
    # plain dense block pays the full N·N_ref·T.  A CUDA engine keeps them
    # on the card, in ``block_prox`` row blocks, at every size.
    _SPARSE_TRAIN_CUTOVER = 8192

    def __init__(self, ctx, assignment, forest=None, oos_cache_size: int = 8):
        self.ctx = ctx
        self.assignment = assignment
        self.forest = forest
        self.device = ctx.device
        self.total_leaves = int(ctx.total_leaves)
        self.gl = ctx.global_leaves()                        # (N, T) int32
        self.q = assignment.query_weights(ctx.leaves).contiguous()
        self.w = self.q if assignment.symmetric else \
            assignment.reference_weights(ctx.leaves).contiguous()

        # host CSR factors: int64 leaf ids and float64 weights copied back
        gl_host = self.gl.cpu().numpy().astype(np.int64)
        self.Q = build_leaf_map(gl_host, self.q.cpu().numpy(),
                                self.total_leaves)
        self.W = self.Q if self.w is self.q else build_leaf_map(
            gl_host, self.w.cpu().numpy(), self.total_leaves)
        self.leaf_values = None if forest is None else forest.leaf_values_

        self._train_state = QueryState(self.gl, self.q, self.total_leaves,
                                       Q=self.Q)
        # routed OOS query states; the tiered server will touch the cache
        # from one worker thread per tier, so bookkeeping is locked
        self._oos_cache: "OrderedDict[str, QueryState]" = OrderedDict()
        self._oos_cache_size = oos_cache_size
        self._qs_lock = threading.Lock()
        self.qs_cache_hits = 0
        self.qs_cache_misses = 0
        self._train_row_sums: Optional[torch.Tensor] = None
        self._leaf_index: Optional[LeafIndex] = None
        self._leaf_density: Optional[float] = None
        self._index_lock = threading.Lock()

    @property
    def n_ref(self) -> int:
        return int(self.gl.shape[0])

    def _tensor(self, a, dtype=torch.float64) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ---------------- query-state management ----------------
    @staticmethod
    def _batch_key(X) -> str:
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()          # hashed on the host
        X = np.ascontiguousarray(X)
        h = hashlib.sha1()
        h.update(str(X.shape).encode())
        h.update(str(X.dtype).encode())
        h.update(X.tobytes())
        return h.hexdigest()

    def query_state(self, X=None) -> QueryState:
        """Training state (X=None) or a cached OOS state for a new batch,
        routed on the device through the routing kernel."""
        if X is None:
            return self._train_state
        key = self._batch_key(X)
        with self._qs_lock:
            hit = self._oos_cache.get(key)
            if hit is not None:
                self._oos_cache.move_to_end(key)
                self.qs_cache_hits += 1
                return hit
            self.qs_cache_misses += 1
        if self.forest is None:
            raise ValueError("OOS queries need the backing forest")
        leaves = self.forest.apply(X)
        state = QueryState(self.ctx.global_leaves(leaves),
                           self.assignment.oos_query_weights(leaves)
                           .contiguous(), self.total_leaves)
        # built outside the lock: two threads racing on one new batch
        # duplicate work, never corrupt the dict
        with self._qs_lock:
            self._oos_cache[key] = state
            while len(self._oos_cache) > self._oos_cache_size:
                self._oos_cache.popitem(last=False)
        return state

    # ---------------- core products ----------------
    def matvec(self, v, X=None, col_mask=None,
               normalized: bool = False) -> torch.Tensor:
        v = self._tensor(v)
        return self.matmat(v[:, None], X=X, col_mask=col_mask,
                           normalized=normalized)[:, 0]

    def matmat(self, V, X=None, col_mask=None,
               normalized: bool = False) -> torch.Tensor:
        """(P V) where P's rows are the train (X=None) or OOS query batch.

        ``col_mask`` (N_ref,) restricts the reference side:
        Σ_j m_j P(i,j) V[j], folded into V as Q (Wᵀ (m ⊙ V)).
        ``normalized`` divides each output row by the *unmasked* kernel row
        sum Σ_j P(i,j), i.e. applies D⁻¹ P.
        """
        V = self._tensor(V)
        if col_mask is not None:
            V = V * self._tensor(col_mask)[:, None]
        out = self._product(self.query_state(X), V)
        if normalized:
            d = self.row_sums(X=X)
            out = out / d.clamp_min(np.finfo(np.float64).tiny)[:, None]
        return out

    def _product(self, qs: QueryState, V: torch.Tensor) -> torch.Tensor:
        t_chunk = torch_ops.auto_t_chunk(self.n_ref, self.gl.shape[1],
                                         V.shape[1])
        return torch_ops.swlc_predict(qs.gl, qs.q, self.gl, self.w, V,
                                      self.total_leaves, t_chunk=t_chunk)

    def row_sums(self, X=None) -> torch.Tensor:
        """Kernel row sums Σ_j P(i,j) = P·1 through the factors (the degree
        vector of the proximity graph); cached for the training state."""
        if X is None and self._train_row_sums is not None:
            return self._train_row_sums
        ones = torch.ones((self.n_ref, 1), dtype=torch.float64,
                          device=self.device)
        out = self._product(self.query_state(X), ones)[:, 0]
        if X is None:
            self._train_row_sums = out
        return out

    def operator(self) -> LinearOperator:
        """Host LinearOperator of P: device products, host transpose."""
        return LinearOperator(
            (self.n_ref, self.n_ref),
            matvec=lambda v: self.matvec(np.ravel(v)).cpu().numpy(),
            matmat=lambda V: self.matmat(V).cpu().numpy(),
            rmatvec=lambda v: np.asarray(self.W @ (self.Q.T @ v)),
            dtype=np.float64)

    # ---------------- kernel views ----------------
    def full_kernel(self, diagonal: Optional[float] = None) -> sp.csr_matrix:
        return full_kernel(self.Q, self.W, diagonal=diagonal)

    def leaf_index(self) -> LeafIndex:
        """The reference factors grouped by leaf, as the block kernel reads
        them: built on the engine's device at first use and kept (its bytes
        are in ``memory_bytes``)."""
        with self._index_lock:
            if self._leaf_index is None:
                self._leaf_index = build_leaf_index(
                    self.gl, self.w, n_leaves=self.total_leaves)
            return self._leaf_index

    def leaf_mode(self) -> bool:
        """Whether the block kernel walks the leaf index rather than
        comparing densely: when one (query row, tree) meets at most
        ``LEAF_DENSITY_MAX`` of the reference columns (``leaf_density``,
        taken once)."""
        if self._leaf_density is None:
            self._leaf_density = leaf_density(self.gl, self.w,
                                              self.total_leaves)
        return self._leaf_density <= LEAF_DENSITY_MAX

    def _block(self, gl_q: torch.Tensor, q: torch.Tensor,
               cols=None) -> torch.Tensor:
        """P for query factors ``gl_q``/``q`` against every reference row
        (or ``cols``): in the kernel's leaf-collision form through the
        cached index on a CUDA engine in leaf mode, else in its dense
        form."""
        if cols is not None:
            c = self._tensor(cols, torch.int64)
            return block_prox(gl_q, q, self.gl[c], self.w[c])
        index = self.leaf_index() if self.device.type == "cuda" \
            and self.leaf_mode() else None
        return block_prox(gl_q, q, self.gl, self.w, index=index)

    def kernel_block(self, rows=None, cols=None, X_rows=None) -> torch.Tensor:
        """Dense P[rows, cols] (rows may be an OOS batch via X_rows)."""
        qs = self.query_state(X_rows)
        gl_q, q = qs.gl, qs.q
        if rows is not None:
            r = self._tensor(rows, torch.int64)
            gl_q, q = gl_q[r], q[r]
        return self._block(gl_q, q, cols)

    def _dense_blocks(self, qs: QueryState):
        """Row chunks of P[qs, :] as (i0, i1, block), sized by output
        bytes."""
        step = max(1, _BLOCK_BYTES // (8 * max(self.n_ref, 1)))
        for i0 in range(0, qs.n, step):
            i1 = min(i0 + step, qs.n)
            yield i0, i1, self._block(qs.gl[i0:i1], qs.q[i0:i1])

    def _sparse_train(self, X) -> bool:
        return (self.device.type == "cpu" and X is None
                and self.n_ref > self._SPARSE_TRAIN_CUTOVER)

    def squared_row_sums(self, class_ids=None, n_classes: Optional[int] = None,
                         X=None, block: int = 4096) -> torch.Tensor:
        """Σ_j P(i,j)² per query row — the outlier-score primitive.

        With ``class_ids`` (N_ref,) the sum is bucketed by reference class:
        out[i, c] = Σ_{j: class_ids[j]=c} P(i,j)², shape (Nq, n_classes).
        Dense device blocks, or host CSR row blocks for large train-side
        jobs on a CPU engine — never a full dense P.
        """
        qs = self.query_state(X)
        if class_ids is not None:
            class_ids = np.asarray(class_ids, dtype=np.int64)
            if n_classes is None:
                n_classes = int(class_ids.max()) + 1
        if self._sparse_train(X):
            return self._tensor(self._squared_row_sums_csr(
                qs.Q, class_ids, n_classes, block))
        onehot = None
        if class_ids is not None:
            onehot = torch.zeros((self.n_ref, n_classes), dtype=torch.float64,
                                 device=self.device)
            onehot[torch.arange(self.n_ref, device=self.device),
                   self._tensor(class_ids, torch.int64)] = 1.0
        shape = (qs.n,) if onehot is None else (qs.n, n_classes)
        out = torch.zeros(shape, dtype=torch.float64, device=self.device)
        for i0, i1, B in self._dense_blocks(qs):
            B2 = B * B
            out[i0:i1] = B2.sum(dim=1) if onehot is None else B2 @ onehot
        return out

    def _squared_row_sums_csr(self, Q, class_ids, n_classes,
                              block: int) -> np.ndarray:
        n = Q.shape[0]
        out = np.zeros(n if class_ids is None else (n, n_classes))
        WT = self.W.T.tocsc()
        for i0 in range(0, n, block):
            B = (Q[i0:i0 + block] @ WT).tocsr()
            nb = B.shape[0]
            rows = np.repeat(np.arange(nb), np.diff(B.indptr))
            d2 = B.data ** 2
            if class_ids is None:
                out[i0:i0 + nb] = np.bincount(rows, weights=d2, minlength=nb)
            else:
                comb = rows * n_classes + class_ids[B.indices]
                out[i0:i0 + nb] = np.bincount(
                    comb, weights=d2,
                    minlength=nb * n_classes).reshape(nb, n_classes)
        return out

    # ---------------- downstream ----------------
    def predict(self, y, n_classes: Optional[int] = None, X=None,
                exclude_self: Optional[bool] = None) -> torch.Tensor:
        """Proximity-weighted prediction scores (Appendix I) via P·Y."""
        if exclude_self is None:
            exclude_self = X is None
        if exclude_self and X is not None:
            # the self-term pairs query row i with training row i, which is
            # only meaningful for the training query state
            raise ValueError("exclude_self is only defined for training-set "
                             "queries (X=None)")
        qs = self.query_state(X)
        y = np.asarray(y)
        if n_classes is not None:
            Y = torch.zeros((len(y), n_classes), dtype=torch.float64,
                            device=self.device)
            Y[torch.arange(len(y), device=self.device),
              self._tensor(y.astype(np.int64), torch.int64)] = 1.0
        else:
            Y = torch.stack([self._tensor(y.astype(np.float64)),
                             torch.ones(len(y), dtype=torch.float64,
                                        device=self.device)], dim=1)
        out = self._product(qs, Y)
        if exclude_self:
            # own-row contribution: same gl on both sides -> Σ_t q_t w_t
            diag = (qs.q * self.w).sum(dim=1)
            out = out - diag[:, None] * Y
        if n_classes is not None:
            return out
        return out[:, 0] / out[:, 1].clamp_min(1e-300)

    def topk(self, k: int = 10, X=None,
             block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query top-k proximities (values descending): dense device
        blocks reduced by ``torch.topk``, or host CSR for large train-side
        jobs on a CPU engine.  Returns (indices int64, values float64)."""
        qs = self.query_state(X)
        if self._sparse_train(X):
            idx, val = topk_neighbors(qs.Q, self.W, k, block=block)
            return self._tensor(idx, torch.int64), self._tensor(val)
        kk = min(k, self.n_ref)
        idx = torch.zeros((qs.n, k), dtype=torch.int64, device=self.device)
        val = torch.zeros((qs.n, k), dtype=torch.float64, device=self.device)
        for i0, i1, B in self._dense_blocks(qs):
            v, ix = torch.topk(B, kk, dim=1)
            idx[i0:i1, :kk] = ix
            val[i0:i1, :kk] = v
        return idx, val

    # ---------------- accounting ----------------
    def memory_bytes(self) -> dict:
        """Resident factor bytes per component (dense factors and, once
        built, the block kernel's leaf index on the device; CSR maps and
        leaf values on the host)."""
        def nbytes(t):
            return t.numel() * t.element_size()
        dense = nbytes(self.gl) + nbytes(self.q) + \
            (0 if self.w is self.q else nbytes(self.w))
        out = {"dense_factors": int(dense), "Q": sparse_bytes(self.Q),
               "W": 0 if self.W is self.Q else sparse_bytes(self.W)}
        if self.leaf_values is not None:
            out["leaf_values"] = int(self.leaf_values.nbytes)
        index = self._leaf_index
        out["leaf_index"] = 0 if index is None else index.nbytes
        out["total"] = sum(out.values())
        return out
