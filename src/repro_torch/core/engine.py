"""Device-resident proximity engine.

``ProximityEngine`` is built **once** per fitted kernel and owns every array
the hot paths need:

- dense ``(gl, q, w)`` factors on the device (``gl`` int32 global leaf ids,
  ``q``/``w`` the SWLC weights of Def 3.1 in the engine's ``dtype``,
  float64 by default or float32: computed in float64 and rounded once, as
  the reference's are),
- the host CSR leaf maps ``Q``/``W`` (Lemma 3.4 factors) for the full
  kernel, the operator's transpose and train-side all-pairs jobs,
- an LRU of out-of-sample query states, so repeated ``predict(X=...)``
  calls on one batch never re-route.

Products ``P V = Q (Wᵀ V)`` run as device segment sums
(``core.torch_ops``): the reference-side bucket table ``S = Wᵀ V`` (LRU-
cached for narrow ``V``, so a serving loop that applies the same labels
every tick pays only the query-side gather) and the query-side gather.
Dense blocks, top-k and squared row sums run through the ``block_prox``
kernel, which a CUDA engine whose leaves are small feeds its reference
side grouped by leaf (``leaf_index``, built on the device at the first
such call); with big leaves it runs the kernel's dense form.  Each dense
block's top-k is selected by ``row_topk`` (the kernel on a CUDA engine, its
plain version on a CPU one; a k wider than the kernel's ``MAX_K`` takes the
plain version on either).  One method, ``_train_path``, picks the path of
every all-pairs call: dense blocks, the leaf collisions of
``core/collide.py`` (train-side (X=None) calls of a CUDA engine whose
training rows meet few reference columns, ``collision_mode``: no dense
block is written), or the host CSR factors (large train-side calls of a
CPU engine).  A CPU engine runs the kernels' plain versions.
Results are tensors on the engine's device, in the engine's dtype (top-k
values in float64, as the reference's scipy engine gives them).

With regions on (``obs.trace.set_regions``), ``topk`` and
``squared_row_sums`` mark their phases as ``torch.profiler`` ranges:
``engine.topk`` / ``engine.squared_row_sums`` around each call,
``engine.k2`` around each block kernel call, ``engine.select`` around each
block's top-k selection, ``engine.class_ids`` around the class one-hot's
build and ``engine.class_sums`` around each block's squares and class
sums; on the collision path ``engine.collide``, ``engine.collide_select``
and ``engine.collide_sums`` (``core/collide.py``).  Each ``topk`` call on
dense blocks adds its rows to the process-wide counter
``engine_topk_rows_total`` (and 0 to ``engine_topk_spill_rows_total``,
which the benchmark still reads); each call on the collision path adds its
rows and the products it enumerated to ``engine_collide_rows_total`` and
``engine_collisions_total`` and, on the card, the rows the pair kernels
split over warps (more than ``split_products`` products, from the
cumulative counts) to ``engine_collide_split_rows_total``.

With several cards, products on the training rows take the sharded path
(``torch_ops.sharded_swlc_matmat`` over ``torch_ops.default_mesh()``: rows
split over the cards), as the reference's jax engine does over its
devices; ``last_matmat_path`` says which path the last product took.

Out of core, ``memory_budget_bytes`` bounds the transients: the CSR maps
are built from row chunks of the device factors (``streamed_leaf_map``,
indices and data spilled to scratch memmaps under ``factor_scratch_dir``
when they alone exceed the budget), a block kernel call's rows shrink so a
block and its squared copy fit half the budget (a collision block's
transients too), the bucket table of a wide
product is built a few columns at a time, and the host CSR row blocks
shrink.  None of it changes a result: the CSR maps, blocks, top-k and
squared row sums keep their bits; products keep theirs on the CPU (on the
card their ``index_add_`` atomics vary in the last bits either way).

``PrefixProximityEngine`` is the depth-prefix tier: the engine of the
depth-truncated forest, contracted from a fitted parent engine without
routing again; like the compressed view, it keeps its parent's budget
and dtype.
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
                                      leaf_density, leaf_members)
from ..kernels.collide.ops import MAX_K as PAIR_TOPK_MAX_K
from ..kernels.collide.ops import split_products
from ..kernels.row_topk.ops import MAX_K as ROW_TOPK_MAX_K
from ..kernels.row_topk.ops import row_topk
from ..kernels.row_topk.ref import row_topk_ref
from ..obs.metrics import global_registry
from ..obs.trace import region
from . import collide, torch_ops
from .context import EnsembleContext
from .factorization import (full_kernel, prefix_leaf_contraction,
                            streamed_leaf_map, topk_neighbors)
from .leafmap import build_leaf_map, sparse_bytes
from .weights import get_assignment

__all__ = ["ProximityEngine", "PrefixProximityEngine", "QueryState",
           "prediction_margin"]

# Dense blocks are computed this many output bytes at a time by the ops that
# reduce them (top-k, squared row sums); the kernel itself holds no
# intermediate beyond its output.
_BLOCK_BYTES = 1 << 28
# Bucket tables of products with at most this many columns are cached, at
# most this many tables and bytes of them (above the distinct fixed tables
# a serving tick touches, so iterative solvers cannot thrash them).
_REF_CACHE_COLS = 32
_REF_CACHE_SIZE = 16
_REF_CACHE_BYTES = 1 << 27
# A block's squared row sums are reduced this many rows at a time, at rows
# aligned to multiples of it, so each row's sum has the same shape (and
# bits) however many rows its block kernel call held; block heights are
# multiples of it.
_SUM_ROWS = 32
# Train-side top-k and squared row sums of a CUDA engine take the collision
# path (``core/collide.py``) when a training row's products reach at most
# this share of the reference columns (``collision_share``): on the H100 a
# pass there took 0.31 of the dense path's time at a share of 0.0054 and
# 0.91 at 0.0143 (100,000 rows, 15 trees), crossing at ~0.0157 (PERF.md
# §6, PR 27).
COLLIDE_SHARE_MAX = 0.015
# A collision block's transients without a budget (under one: half of it).
_COLLIDE_BYTES = 1 << 30
# the factor dtypes an engine takes (the block kernel's two instantiations)
_TORCH_DTYPE = {np.dtype(np.float64): torch.float64,
                np.dtype(np.float32): torch.float32}


class _HostRows:
    """Row slices of a device tensor as host arrays in ``dtype``: what the
    streamed CSR build reads, so the whole (N, T) matrix is never copied to
    the host at once."""

    def __init__(self, t: torch.Tensor, dtype):
        self.t, self.dtype, self.shape = t, dtype, tuple(t.shape)

    def __getitem__(self, rows) -> np.ndarray:
        return self.t[rows].cpu().numpy().astype(self.dtype, copy=False)


class QueryState:
    """Everything needed to use a sample batch as the query side of P.

    ``gl``/``q`` live on the device; the host CSR map ``Q`` (in ``q``'s
    dtype) is built from them the first time it is read, so the device
    path never waits on it.
    """

    def __init__(self, gl: torch.Tensor, q: torch.Tensor, total_leaves: int,
                 Q: Optional[sp.csr_matrix] = None):
        self.gl = gl                 # (Nq, T) int32 global leaf ids
        self.q = q                   # (Nq, T) query weights, engine dtype
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
                q = self.q.cpu().numpy()
                self._Q = build_leaf_map(
                    self.gl.cpu().numpy().astype(np.int64), q,
                    self._total_leaves, q.dtype)
            return self._Q


class ProximityEngine:
    """Serves matvec / matmat / predict / topk / kernel_block for P = Q Wᵀ."""

    # On a CPU engine, above this reference-set size, train-side (X=None)
    # topk and squared row sums take the host CSR path (``_train_path``):
    # those are all-pairs batch jobs where CSR restricts work to colliding
    # pairs, while the plain dense block pays the full N·N_ref·T.
    _SPARSE_TRAIN_CUTOVER = 8192

    def __init__(self, ctx, assignment, forest=None, dtype=np.float64,
                 oos_cache_size: int = 8, factors=None,
                 memory_budget_bytes: Optional[int] = None,
                 factor_scratch_dir: Optional[str] = None):
        self.ctx = ctx
        self.assignment = assignment
        self.forest = forest
        self.device = ctx.device
        self.dtype = np.dtype(dtype)
        if self.dtype not in _TORCH_DTYPE:
            raise ValueError(f"engine dtype must be float64 or float32, got "
                             f"{self.dtype}")
        self.total_leaves = int(ctx.total_leaves)
        self.memory_budget_bytes = None if memory_budget_bytes is None \
            else int(memory_budget_bytes)
        self._factor_scratch_dir = factor_scratch_dir
        self.gl = ctx.global_leaves()                        # (N, T) int32
        # ``factors=(q, w)`` injects precomputed weights (w may be None for
        # a symmetric rule) instead of running the assignment again; the
        # assignment's float64 weights are rounded once to the dtype
        if factors is not None:
            q, w = factors
            self.q = self._tensor(q).contiguous()
            self.w = self.q if (assignment.symmetric or w is None) else \
                self._tensor(w).contiguous()
        else:
            self.q = self._tensor(
                assignment.query_weights(ctx.leaves)).contiguous()
            self.w = self.q if assignment.symmetric else self._tensor(
                assignment.reference_weights(ctx.leaves)).contiguous()

        # host CSR factors: int64 leaf ids and the weights copied back,
        # whole or, under a budget, in row chunks
        gl_host = _HostRows(self.gl, np.int64)
        if self.memory_budget_bytes is None:
            gl_host = gl_host[:]
        self.Q = self._build_factor(gl_host, self.q)
        self.W = self.Q if self.w is self.q else \
            self._build_factor(gl_host, self.w)
        self.leaf_values = None if forest is None else forest.leaf_values_
        self._init_runtime_state(oos_cache_size=oos_cache_size)

    def _factor_row_chunk(self) -> Optional[int]:
        """Rows the streamed CSR build reads at a time under a budget
        (about 32 bytes of transient a (row, tree) cell); None without
        one."""
        if self.memory_budget_bytes is None:
            return None
        return max(1024, self.memory_budget_bytes //
                   max(32 * self.gl.shape[1], 1))

    def _build_factor(self, gl_host, weights: torch.Tensor) -> sp.csr_matrix:
        """One CSR leaf map.  Under a budget the streamed build reads
        ``_factor_row_chunk`` rows at a time and spills indices and data to
        scratch memmaps when they alone exceed the budget; the result is
        the same CSR."""
        if self.memory_budget_bytes is None:
            return build_leaf_map(gl_host, weights.cpu().numpy(),
                                  self.total_leaves, self.dtype)
        return streamed_leaf_map(
            gl_host, _HostRows(weights, self.dtype), self.total_leaves,
            self.dtype, row_chunk=self._factor_row_chunk(),
            memmap_threshold_bytes=self.memory_budget_bytes,
            scratch_dir=self._factor_scratch_dir)

    def _init_runtime_state(self, oos_cache=None, oos_cache_size: int = 8,
                            oos_lock: Optional[threading.Lock] = None) -> None:
        """Per-engine mutable state; the one place where both the primary
        constructor and factor-slicing views (``CompressedProximityEngine``)
        set it, so a new runtime attribute cannot go missing on one of them.
        Expects the factor attributes (gl/q/w/Q/W, device) to be set.

        The block kernel's leaf index describes this engine's reference
        columns, so every engine and view starts without one.  A view may
        share its parent's routed OOS states, but only together with the
        lock that guards them: two locks on one dict protect nothing.
        """
        self._train_state = QueryState(self.gl, self.q, self.total_leaves,
                                       Q=self.Q)
        # routed OOS query states; the tiered server touches the cache from
        # one worker thread per tier, so bookkeeping is locked
        self._oos_cache: "OrderedDict[str, QueryState]" = \
            OrderedDict() if oos_cache is None else oos_cache
        self._oos_cache_size = oos_cache_size
        self._qs_lock = threading.Lock() if oos_lock is None else oos_lock
        self.qs_cache_hits = 0
        self.qs_cache_misses = 0
        self._train_row_sums: Optional[torch.Tensor] = None
        self.last_matmat_path: Optional[str] = None   # 'sharded' | 'segment'
        # reference bucket tables S = Wᵀ V on the device, LRU of key ->
        # (keepalive V | None, S); bounded in entries and in bytes
        self._ref_cache: "OrderedDict[object, tuple]" = OrderedDict()
        self._ref_cache_size = _REF_CACHE_SIZE
        self._ref_cache_bytes = 0
        self._ref_cache_byte_budget = _REF_CACHE_BYTES
        # predict's label tables, memoized by label-array identity
        self._label_cache: "OrderedDict[object, tuple]" = OrderedDict()
        self._app_cache: dict = {}    # application-level per-engine caches
        self._leaf_index: Optional[LeafIndex] = None
        self._leaf_density: Optional[float] = None
        self._index_lock = threading.Lock()
        # the collision path's plan: the training rows' cumulative products
        # on the host, their share, the most trees a pair can meet in, the
        # row blocks of a cap and the rows longer than a split
        self._collide_cum: Optional[np.ndarray] = None
        self._collide_share: Optional[float] = None
        self._collide_depth = 0
        self._collide_blocks: Tuple[int, list] = (0, [])
        self._collide_split: Tuple[int, int] = (0, 0)

    @property
    def n_ref(self) -> int:
        return int(self.gl.shape[0])

    @property
    def _torch_dtype(self) -> torch.dtype:
        """The engine's ``dtype`` as a torch dtype."""
        return _TORCH_DTYPE[self.dtype]

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """``a`` on the engine's device, in ``dtype`` (the engine's by
        default)."""
        return torch.as_tensor(a, device=self.device,
                               dtype=self._torch_dtype if dtype is None
                               else dtype)

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
        hit = self._qs_cache_get(key)
        if hit is not None:
            return hit
        if self.forest is None:
            raise ValueError("OOS queries need the backing forest")
        leaves = self.forest.apply(X)
        return self._qs_cache_put(key, QueryState(
            self.ctx.global_leaves(leaves),
            self._tensor(self.assignment.oos_query_weights(leaves))
            .contiguous(), self.total_leaves))

    def _qs_cache_get(self, key: str) -> Optional[QueryState]:
        with self._qs_lock:
            hit = self._oos_cache.get(key)
            if hit is not None:
                self._oos_cache.move_to_end(key)
                self.qs_cache_hits += 1
            else:
                self.qs_cache_misses += 1
            return hit

    def _qs_cache_put(self, key: str, state: QueryState) -> QueryState:
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
        Vt = self._tensor(V)
        key = None
        if col_mask is not None:
            Vt = Vt * self._tensor(col_mask)[:, None]
        elif Vt.shape[1] <= _REF_CACHE_COLS:
            # keyed by the caller's object, which the entry keeps alive
            key = ("id", id(V))
        out = self._product(self.query_state(X), Vt, key=key, keepalive=V)
        if normalized:
            d = self.row_sums(X=X)
            out = out / d.clamp_min(np.finfo(self.dtype).tiny)[:, None]
        return out

    def _product(self, qs: QueryState, V: torch.Tensor, key=None,
                 keepalive=None) -> torch.Tensor:
        """P V for the query rows of ``qs``: on the training rows, over the
        cards of ``torch_ops.default_mesh()`` when it has any and they
        split the rows evenly (:meth:`_sharded_product`); else the segment
        product on the engine's device."""
        mesh = self._mesh() if qs is self._train_state else None
        if mesh is not None:
            self.last_matmat_path = "sharded"
            return self._sharded_product(mesh, V)
        self.last_matmat_path = "segment"
        cb = self._col_chunk(V.shape[1])
        if cb < V.shape[1]:
            # bound the (total_leaves, C) bucket table under the budget:
            # the columns of P V are independent, so V goes a few at a
            # time (uncached tables)
            out = torch.empty((qs.n, V.shape[1]), dtype=self._torch_dtype,
                              device=self.device)
            for j0 in range(0, V.shape[1], cb):
                Vj = V[:, j0:j0 + cb].contiguous()
                out[:, j0:j0 + cb] = torch_ops.swlc_gather(
                    qs.gl, qs.q, self._ref_table(Vj),
                    self._t_chunk(Vj.shape[1]))
            return out
        return torch_ops.swlc_gather(qs.gl, qs.q,
                                     self._ref_table(V, key, keepalive),
                                     self._t_chunk(V.shape[1]))

    def _mesh(self):
        """The device grid of the sharded product, or None: the
        reference's gate — a ``default_mesh()`` whose data axis divides the
        training rows — and a grid of the engine's device type (a CPU
        engine stays on the CPU)."""
        mesh = torch_ops.default_mesh()
        if mesh is None or self.n_ref % mesh.shape[0] \
                or mesh[0, 0].type != self.device.type:
            return None
        return mesh

    def _sharded_product(self, mesh, V: torch.Tensor) -> torch.Tensor:
        """P V on the training rows over ``mesh``, as the reference's
        engine computes it: the budget's column blocks (``_col_chunk``)
        first, then within each the ``auto_c_chunk`` blocks that bound a
        shard's (rows / data, T, c) intermediate.  The bucket tables are not
        cached (the reference's sharded path caches none), and a budget
        bounds only the column blocks: each shard still holds a whole
        (total_leaves, c) table."""
        n_dev = mesh.shape[0]
        T = self.gl.shape[1]
        out = []
        cb = self._col_chunk(V.shape[1])
        for b0 in range(0, V.shape[1], cb):
            Vb = V[:, b0:b0 + cb]
            c = torch_ops.auto_c_chunk(self.n_ref // n_dev, T, Vb.shape[1])
            c = Vb.shape[1] if c is None else c
            out += [torch_ops.sharded_swlc_matmat(
                mesh, self.gl, self.q, self.w,
                Vb[:, j0:j0 + c].contiguous(), self.total_leaves)
                for j0 in range(0, Vb.shape[1], c)]
        return torch.cat(out, dim=1)

    def _col_chunk(self, n_cols: int) -> int:
        """Columns of V a product's bucket table holds at once: the dense
        (total_leaves, C) table dwarfs every other working set out of core
        (millions of leaves), so under a budget it is kept within half of
        it."""
        if self.memory_budget_bytes is None or n_cols <= 1:
            return n_cols
        per_col = 8 * max(self.total_leaves, 1)
        return max(1, min(n_cols, self.memory_budget_bytes // (2 * per_col)))

    def _t_chunk(self, C: int) -> Optional[int]:
        return torch_ops.auto_t_chunk(self.n_ref, self.gl.shape[1], C)

    def _ref_table(self, V: torch.Tensor, key=None,
                   keepalive=None) -> torch.Tensor:
        """Reference bucket table S = Wᵀ V of P V = Q (Wᵀ V) on the device —
        the half that does not depend on the query rows.

        Narrow V (≤ 32 columns: labels, class scores, Nyström bases) is
        LRU-cached, so a serving loop applying the same V every tick pays
        the O(N_ref·T) bucket pass once and only the O(n_query·T) gather
        after.  ``key`` is the caller's: a content key for tables built
        anew per call (label tables, the ones vector), or ``("id", id(V))``
        for the caller's own object, kept alive in the entry as
        ``keepalive`` so its id cannot be reused while cached (no hashing
        per call; iterative solvers whose V changes every call rotate
        through the LRU).  Cached V is treated as immutable.  Without a key
        (wide or masked V) the table is not cached.  The device bytes of
        the cached tables are bounded.
        """
        if key is not None:
            hit = self._ref_cache.get(key)
            if hit is not None:
                self._ref_cache.move_to_end(key)
                return hit[1]
        S = torch_ops.swlc_bucket(self.gl, self.w, V, self.total_leaves,
                                  self._t_chunk(V.shape[1]))
        if key is not None:
            self._ref_cache[key] = (keepalive, S)
            self._ref_cache_bytes += S.numel() * S.element_size()
            while len(self._ref_cache) > self._ref_cache_size or \
                    self._ref_cache_bytes > self._ref_cache_byte_budget:
                _, (_, old) = self._ref_cache.popitem(last=False)
                self._ref_cache_bytes -= old.numel() * old.element_size()
        return S

    def row_sums(self, X=None) -> torch.Tensor:
        """Kernel row sums Σ_j P(i,j) = P·1 through the factors (the degree
        vector of the proximity graph); cached for the training state."""
        if X is None and self._train_row_sums is not None:
            return self._train_row_sums
        ones = torch.ones((self.n_ref, 1), dtype=self._torch_dtype,
                          device=self.device)
        # a content key: OOS row sums cost the query-side gather only
        out = self._product(self.query_state(X), ones,
                            key=("ones", self.n_ref))[:, 0]
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
            dtype=self.dtype)

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

    def collision_share(self) -> float:
        """The mean share of the reference columns whose products a
        training row enumerates on the collision path (Σ_t [q_t ≠ 0] times
        its leaf's nonzero-weight members, over ``n_ref``), taken once;
        infinite where a factor is negative (the path's zero fill assumes
        none)."""
        if self._collide_share is None:
            per_row = collide.row_products(
                leaf_members(self.gl, self.w, self.total_leaves), self.gl,
                self.q)
            self._collide_cum = np.concatenate(
                [[0], np.cumsum(per_row.cpu().numpy())])
            self._collide_depth = int((self.q != 0).sum(dim=1).max()) \
                if self.n_ref else 0
            negative = bool((self.q < 0).any()) or bool((self.w < 0).any())
            self._collide_share = float("inf") if negative else \
                float(self._collide_cum[-1]) / max(self.n_ref, 1) ** 2
        return self._collide_share

    def collision_mode(self) -> bool:
        """Whether train-side top-k and squared row sums enumerate leaf
        collisions rather than compare densely: when
        ``collision_share`` is at most ``COLLIDE_SHARE_MAX``.  A CUDA
        engine takes the path for them (:meth:`_train_path`)."""
        return self.collision_share() <= COLLIDE_SHARE_MAX

    def _train_path(self, X, k: Optional[int] = None) -> str:
        """The path of an all-pairs call on the query rows of ``X``
        (``topk`` passes its ``k``, ``squared_row_sums`` none):
        ``"csr"``, the host CSR factors, for a train-side (X=None) call of
        a CPU engine above ``_SPARSE_TRAIN_CUTOVER`` rows; ``"collide"``,
        the leaf collisions, for a train-side call of a CUDA engine in
        ``collision_mode`` (a top-k only up to the pair kernel's
        ``MAX_K``); else ``"dense"``, ``block_prox`` row blocks, every OOS
        batch included."""
        if X is not None:
            return "dense"
        if self.device.type == "cpu" and \
                self.n_ref > self._SPARSE_TRAIN_CUTOVER:
            return "csr"
        if self.device.type == "cuda" and self.collision_mode() and \
                (k is None or min(k, self.n_ref) <= PAIR_TOPK_MAX_K):
            return "collide"
        return "dense"

    def _collide_args(self) -> tuple:
        """The collision path's arguments for the training rows: the leaf
        index, the query factors, their cumulative products, the row blocks
        (``_COLLIDE_BYTES`` of transients each, or half the budget) and the
        most trees a pair can collide in; counts the call's rows and
        products in ``engine_collide_rows_total`` and
        ``engine_collisions_total``, and on the card the rows the pair
        kernels split in ``engine_collide_split_rows_total``."""
        self.collision_share()
        cap = _COLLIDE_BYTES if self.memory_budget_bytes is None \
            else min(_COLLIDE_BYTES, self.memory_budget_bytes // 2)
        if self._collide_blocks[0] != cap:
            self._collide_blocks = (cap, collide.row_blocks(
                self._collide_cum, cap))
        split = split_products(self._collide_depth)
        if self._collide_split[0] != split:
            self._collide_split = (split, int(
                (np.diff(self._collide_cum) > split).sum()))
        reg = global_registry()
        reg.counter("engine_collide_rows_total",
                    "query rows served on the collision path").inc(self.n_ref)
        reg.counter("engine_collisions_total",
                    "products the collision path enumerated"
                    ).inc(int(self._collide_cum[-1]))
        if self.device.type == "cuda":
            reg.counter("engine_collide_split_rows_total",
                        "rows the collision-pair kernels split over warps"
                        ).inc(self._collide_split[1])
        return (self.leaf_index(), self.gl, self.q, self._collide_cum,
                self._collide_blocks[1], self._collide_depth)

    def _block(self, gl_q: torch.Tensor, q: torch.Tensor,
               cols=None) -> torch.Tensor:
        """P for query factors ``gl_q``/``q`` against every reference row
        (or ``cols``): in the kernel's leaf-collision form through the
        cached index on a CUDA engine in leaf mode, else in its dense
        form."""
        with region("engine.k2"):
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

    def _op_row_chunk(self, block: int) -> int:
        """Rows of one block kernel call in the ops that reduce its output
        (top-k, squared row sums): at most ``block`` and ``_BLOCK_BYTES`` of
        output, and under a budget at most half of it (the block and its
        squared copy), in whole multiples of ``_SUM_ROWS`` (at least one)."""
        cap = _BLOCK_BYTES if self.memory_budget_bytes is None \
            else min(_BLOCK_BYTES, self.memory_budget_bytes // 2)
        rows = min(block, cap // (8 * max(self.n_ref, 1)))
        return max(_SUM_ROWS, rows - rows % _SUM_ROWS)

    def _budget_block(self, block: int) -> int:
        """Row block of the host CSR products under a budget: a product
        block holds ~16 bytes a nonzero, and a row's nonzeros scale with T
        times the mean reference rows a leaf, so a quarter of the budget
        covers the block."""
        if self.memory_budget_bytes is None:
            return block
        T = self.gl.shape[1]
        per_row = 16 * T * max(1, int(self.W.nnz) // max(self.total_leaves,
                                                         1))
        return max(256, min(block, self.memory_budget_bytes // (4 * per_row)))

    def _dense_blocks(self, qs: QueryState, block: int):
        """Row chunks of P[qs, :] as (i0, i1, block), ``_op_row_chunk``
        rows each."""
        step = self._op_row_chunk(block)
        for i0 in range(0, qs.n, step):
            i1 = min(i0 + step, qs.n)
            yield i0, i1, self._block(qs.gl[i0:i1], qs.q[i0:i1])

    def squared_row_sums(self, class_ids=None, n_classes: Optional[int] = None,
                         X=None, block: int = 4096) -> torch.Tensor:
        """Σ_j P(i,j)² per query row — the outlier-score primitive.

        With ``class_ids`` (N_ref,) the sum is bucketed by reference class:
        out[i, c] = Σ_{j: class_ids[j]=c} P(i,j)², shape (Nq, n_classes).
        Dense device blocks, leaf collisions or host CSR row blocks, as
        ``_train_path`` picks — never a full dense P.
        """
        with region("engine.squared_row_sums"):
            qs = self.query_state(X)
            path = self._train_path(X)
            if path == "csr":
                class_ids, n_classes = _class_array(class_ids, n_classes)
                return self._tensor(self._squared_row_sums_csr(
                    qs.Q, class_ids, n_classes, self._budget_block(block)))
            if path == "collide":
                return self._collide_squared_row_sums(class_ids, n_classes)
            onehot = None
            if class_ids is not None:
                with region("engine.class_ids"):
                    class_ids, n_classes = _class_array(class_ids, n_classes)
                    onehot = torch.zeros((self.n_ref, n_classes),
                                         dtype=self._torch_dtype,
                                         device=self.device)
                    onehot[torch.arange(self.n_ref, device=self.device),
                           self._tensor(class_ids, torch.int64)] = 1.0
            shape = (qs.n,) if onehot is None else (qs.n, n_classes)
            out = torch.zeros(shape, dtype=self._torch_dtype,
                              device=self.device)
            for i0, i1, B in self._dense_blocks(qs, block):
                with region("engine.class_sums"):
                    B2 = B * B
                    # _SUM_ROWS rows a reduction, at rows aligned to its
                    # multiples
                    for r0 in range(0, i1 - i0, _SUM_ROWS):
                        part = B2[r0:r0 + _SUM_ROWS]
                        out[i0 + r0:i0 + r0 + part.shape[0]] = \
                            part.sum(dim=1) if onehot is None \
                            else part @ onehot
            return out

    def _collide_squared_row_sums(self, class_ids, n_classes) -> torch.Tensor:
        """Train-side squared row sums on the collision path."""
        class_of = None
        if class_ids is not None:
            with region("engine.class_ids"):
                class_ids, n_classes = _class_array(class_ids, n_classes)
                class_of = self._tensor(class_ids, torch.int64)
        return collide.squared_row_sums(*self._collide_args(), class_of,
                                        n_classes)

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
        Y, ref_key = self._label_table(y, n_classes)
        out = self._product(qs, Y, key=ref_key)
        if exclude_self:
            # own-row contribution: same gl on both sides -> Σ_t q_t w_t
            diag = (qs.q * self.w).sum(dim=1)
            out = out - diag[:, None] * Y
        if n_classes is not None:
            return out
        return out[:, 0] / out[:, 1].clamp_min(1e-300)

    def _label_table(self, y, n_classes: Optional[int]):
        """(Y, ref_key) for predict's P·Y: one-hot classes or stacked
        (target, ones) regression columns, on the device.

        Serving calls predict with the *same* label array every tick, so
        the table is memoized on the array's identity (holding a reference,
        so the id cannot be reused while cached) and its bucket table keyed
        by content: steady-state prediction builds nothing and hashes
        nothing.  A small LRU; cached label arrays are treated as
        immutable.
        """
        memo_key = (id(y), n_classes)
        hit = self._label_cache.get(memo_key)
        if hit is not None and hit[0] is y:
            self._label_cache.move_to_end(memo_key)
            return hit[1], hit[2]
        ya = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) \
            else np.asarray(y)
        if n_classes is not None:
            Y = np.zeros((len(ya), n_classes))
            Y[np.arange(len(ya)), ya.astype(np.int64)] = 1.0
        else:
            Y = np.stack([ya.astype(np.float64), np.ones(len(ya))], axis=1)
        ref_key = ("labels", self._batch_key(Y))
        Yd = self._tensor(Y)
        self._label_cache[memo_key] = (y, Yd, ref_key)
        while len(self._label_cache) > 4:
            self._label_cache.popitem(last=False)
        return Yd, ref_key

    def topk(self, k: int = 10, X=None,
             block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-query top-k proximities, values descending and equal values
        by ascending column (so the card and the host pick the same
        columns): dense device blocks selected by ``row_topk``, leaf
        collisions or host CSR, as ``_train_path`` picks.  Returns
        (indices int64, values float64: a float32 engine's values widened,
        as the reference's scipy engine returns them)."""
        with region("engine.topk"):
            qs = self.query_state(X)
            path = self._train_path(X, k)
            if path == "csr":
                idx, val = topk_neighbors(qs.Q, self.W, k,
                                          block=self._budget_block(block))
                return (self._tensor(idx, torch.int64),
                        self._tensor(val, torch.float64))
            if path == "collide":
                return collide.topk(*self._collide_args(), k)
            kk = min(k, self.n_ref)
            idx = torch.zeros((qs.n, k), dtype=torch.int64, device=self.device)
            val = torch.zeros((qs.n, k), dtype=torch.float64,
                              device=self.device)
            for i0, i1, B in self._dense_blocks(qs, block):
                with region("engine.select"):
                    if kk <= ROW_TOPK_MAX_K:
                        row_topk(B, kk, idx=idx[i0:i1, :kk],
                                 val=val[i0:i1, :kk])
                    else:       # wider than the kernel: its plain version
                        idx[i0:i1, :kk], val[i0:i1, :kk] = row_topk_ref(B, kk)
            reg = global_registry()
            reg.counter("engine_topk_rows_total",
                        "query rows top-k selected from dense blocks"
                        ).inc(qs.n)
            # always 0: perfbench/metrics/topk_spill_pct.allpairs.py reads it
            reg.counter("engine_topk_spill_rows_total",
                        "of those, rows a tie rule redid (none)").inc(0)
            return idx, val

    # ---------------- accounting ----------------
    def memory_bytes(self) -> dict:
        """Resident factor bytes per component (dense factors and, once
        built, the block kernel's leaf index on the device; CSR maps and
        leaf values on the host).  The dense factors, Q, W and the total
        are also pushed to the process-wide metrics registry (the
        ``engine_memory_bytes{component}`` gauge family).  Under a
        ``memory_budget_bytes`` the report also carries the budget and
        whether the total fits it, and the budget goes to the
        ``engine_memory_budget_bytes`` gauge."""
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
        if self.memory_budget_bytes is not None:
            out["budget"] = int(self.memory_budget_bytes)
            out["within_budget"] = bool(out["total"] <= out["budget"])
        g = global_registry().gauge("engine_memory_bytes",
                                    "resident engine factor bytes",
                                    labels=("component",))
        for comp in ("dense_factors", "Q", "W", "total"):
            g.labels(component=comp).set(float(out[comp]))
        if self.memory_budget_bytes is not None:
            global_registry().gauge(
                "engine_memory_budget_bytes",
                "configured engine memory budget").set(float(out["budget"]))
        return out


def _class_array(class_ids, n_classes: Optional[int]):
    """(``class_ids`` as an int64 host array, the class count: one past the
    largest id unless given); (None, n_classes) without ids."""
    if class_ids is None:
        return None, n_classes
    class_ids = np.asarray(class_ids, dtype=np.int64)
    if n_classes is None:
        n_classes = int(class_ids.max()) + 1
    return class_ids, n_classes


def prediction_margin(scores) -> torch.Tensor:
    """Per-row confidence of proximity-vote class scores, on their device.

    margin_i = (top1_i - top2_i) / Σ_c scores[i, c] — the normalized vote
    gap, in [0, 1].  The tiered server escalates a request to a heavier
    engine when ``min_i margin_i`` falls below its threshold.  Rows with a
    single class column (or none) are fully confident by convention.
    """
    s = torch.as_tensor(scores, dtype=torch.float64)
    if s.dim() != 2 or s.shape[1] < 2:
        return torch.full((s.shape[0] if s.dim() else 1,), float("inf"),
                          dtype=torch.float64, device=s.device)
    top2 = torch.topk(s, 2, dim=1).values
    tot = s.sum(dim=1).clamp_min(np.finfo(np.float64).tiny)
    return (top2[:, 0] - top2[:, 1]) / tot


class PrefixProximityEngine(ProximityEngine):
    """Depth-k prefix tier: the proximity engine of the depth-truncated
    forest (DiNo/RanBu), derived from a fitted parent engine.

    Truncating every tree at depth k maps each full leaf to its unique
    ancestor at depth <= k, so the prefix forest's leaf codes are a gather
    ``gl_k = gmap[gl_full]`` of the parent's global codes, on the device.
    Training factors are contracted once here; an OOS batch reuses the
    parent's routed (and cached) query state, so the prefix tier never
    routes: one forest pass a batch serves every tier.
    """

    def __init__(self, parent: ProximityEngine, depth: int):
        if parent.forest is None:
            raise ValueError("prefix tiers need the backing forest")
        self.parent = parent
        self.depth = int(depth)
        gmap, _, leaf_offset_k = prefix_leaf_contraction(
            parent.forest.trees_, self.depth)
        dev = parent.device
        self._gmap = torch.as_tensor(gmap, device=dev)            # int64
        self._leaf_offset_k = torch.as_tensor(leaf_offset_k, device=dev)
        trunc = parent.forest.truncated(self.depth)
        pctx = parent.ctx
        ctx_k = EnsembleContext.from_forest(
            trunc, X=pctx.X, y=pctx.y,
            leaves=self._contract(pctx.global_leaves())[1])
        super().__init__(ctx_k, get_assignment(parent.assignment.name, ctx_k),
                         forest=trunc, dtype=parent.dtype,
                         memory_budget_bytes=parent.memory_budget_bytes,
                         factor_scratch_dir=parent._factor_scratch_dir)

    def _contract(self, gl_full: torch.Tensor):
        """(global, within-tree) int32 prefix leaves of the parent's global
        leaves."""
        gl = self._gmap[gl_full.long()]
        return (gl.to(torch.int32),
                (gl - self._leaf_offset_k[None, :]).to(torch.int32))

    def query_state(self, X=None) -> QueryState:
        """Contract the parent's routed state instead of routing again."""
        if X is None:
            return self._train_state
        key = self._batch_key(X)
        hit = self._qs_cache_get(key)
        if hit is not None:
            return hit
        gl, leaves = self._contract(self.parent.query_state(X).gl)
        return self._qs_cache_put(key, QueryState(
            gl, self._tensor(self.assignment.oos_query_weights(leaves))
            .contiguous(), self.total_leaves))
