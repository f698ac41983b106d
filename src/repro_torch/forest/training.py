"""Level-wise histogram CART training, on the host (numpy) or on a device
(torch).

Copy of the reference trainer's level-synchronous driver: features are
pre-binned to ``n_bins`` quantile bins, and at each tree level the
class/moment histograms of *all* active nodes are accumulated in one pass
over a flattened (node, feature, bin[, class]) index, so growing to purity
costs ``O(N d depth)`` per tree.  Sibling histograms are derived as
``parent − smaller child`` while a tree's level is narrow (the
histogram-subtraction trick), and children that can never split are dropped
from the next frontier's sample set (early-leaf pruning).

Two backends, chosen by ``TreeParams.tree_backend`` (``resolve_tree_backend``):

  ``numpy``  tiled ``np.bincount`` histograms and vectorized float64
             scoring on the host (the reference's ``numpy`` backend);
  ``torch``  the port of the reference's ``jax`` branch: the code matrix is
             put on the device once, each level's histograms come from the
             histogram kernels (``kernels/histogram``: K3 for classes, K4 for
             the (w, w·y, w·y²) moments), sibling histograms are subtracted
             in float32 on the device, the retained parent histograms stay
             there, and splits are scored there in float64 in numpy's
             operation order (``_score_torch``); only (nodes,)-sized results
             come back.  On a CPU device the kernels' plain versions run;
  ``auto``   ``torch`` on a CUDA device, ``numpy`` otherwise.

Out of core: ``Binner.transform_memmap`` streams the codes into a
disk-backed ``np.memmap`` chunk by chunk, and both backends train from it
without holding the whole code matrix in memory.  The numpy backend reads
each feature tile's rows from the memmap; the torch backend never copies
the memmap to the device as a whole: each histogram call gathers its
frontier rows' codes on the host, in node order, into a fresh pinned
buffer and stages only those to the device.  Trees are bit-identical to
the in-memory codes' on either backend.

Every RNG draw, the partition, early-leaf pruning and the split decisions
stay on the host, per tree in the same chunked order as the reference, and
split scores use the same float64 operation order with first-maximum
tie-breaking.  So both backends grow trees bit-identical to the reference's
numpy (and native) backend on integer payloads (bootstrap counts, class
labels, integer targets), which float32 histograms hold exactly; on
continuous payloads (gradient-boosting residuals) the float32 device
histograms agree within the reference's ``jax`` backend bounds.  The
reference's native C branch is not part of this copy.  Each level is timed
into the process-wide metrics registry (``train_level_seconds{backend}``,
``train_levels_total{backend}``, ``train_frontier_nodes``,
``train_frontier_rows``) from host values alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.histogram import ops as hops
from ..obs.metrics import global_registry
from .trees import Tree

__all__ = ["TreeParams", "Binner", "fit_tree", "fit_tree_binned",
           "fit_forest_binned", "resolve_tree_backend"]

_HIST_BUDGET = 1 << 26  # max float64 elements per histogram chunk (~512MB)
_TILE_ELEMS = 1 << 20   # max elements per transient index tile
_BATCH_BUDGET = 1 << 28  # resident frontier bytes per multi-tree batch
_SUB_MAX_PARENTS = 16   # retain parent hists only while a tree's level is
#                         this narrow (bounds stash memory; shallow levels
#                         scan the full sample set, so that's where the
#                         halved histogram work pays anyway)


@dataclasses.dataclass
class TreeParams:
    task: str = "classification"      # "classification" | "regression"
    n_classes: int = 2
    max_depth: int = 64
    min_samples_leaf: int = 1
    min_samples_split: int = 2
    max_features: Optional[str] = "sqrt"   # "sqrt" | "log2" | None (all) | int
    n_bins: int = 64
    splitter: str = "best"            # "best" (CART) | "random" (ExtraTrees)
    tree_backend: str = "auto"        # "auto" | "numpy" | "torch"

    def n_feature_subset(self, d: int) -> int:
        mf = self.max_features
        if mf is None:
            return d
        if mf == "sqrt":
            return max(1, int(np.sqrt(d)))
        if mf == "log2":
            return max(1, int(np.log2(d)))
        return max(1, min(int(mf), d))


def resolve_tree_backend(backend: Optional[str], device="cuda") -> str:
    """Resolve 'auto' | 'numpy' | 'torch' to a concrete trainer backend.

    'auto' is 'torch' when ``device`` (the card by default; a missing card
    raises) is a CUDA device and 'numpy' (the host trainer) when it is the
    CPU.  'torch' on a CUDA device runs the histogram kernels and never
    their plain versions.  The reference's 'native' and 'jax' have no
    counterpart here and raise.
    """
    if backend in (None, "auto"):
        return "torch" if resolve_device(device).type == "cuda" else "numpy"
    if backend in ("numpy", "torch"):
        return backend
    raise ValueError(f"unknown tree backend {backend!r}; have "
                     "'auto' | 'numpy' | 'torch'")


class Binner:
    """Quantile pre-binning of a feature matrix to small integer codes.

    All quantile edges come from a single ``np.quantile(sub, qs, axis=0)``
    call, stored offset-concatenated (``edges_flat`` / ``edge_offset`` /
    ``edge_count``), and ``transform`` bins every feature in one broadcast
    pass per sample chunk.  Codes are ``uint8`` whenever ``n_bins <= 256``,
    ``int16`` otherwise.
    """

    def __init__(self, X: np.ndarray, n_bins: int = 64,
                 rng: Optional[np.random.Generator] = None):
        n, d = X.shape
        rng = rng or np.random.default_rng(0)
        sub = X if n <= 200_000 else X[rng.choice(n, 200_000, replace=False)]
        qs = np.linspace(0, 1, n_bins + 1)[1:-1]
        Q = np.quantile(sub, qs, axis=0)           # (n_q, d), monotone per col
        # Dedupe per column and drop the global max as an edge (it would
        # create an empty bin).
        keep = np.ones(Q.shape, dtype=bool)
        if len(Q) > 1:
            keep[1:] = Q[1:] != Q[:-1]
        keep &= Q < sub.max(axis=0)[None, :]
        cnt = keep.sum(axis=0).astype(np.int64)
        self.edge_count = cnt
        self.edge_offset = np.concatenate(
            [[0], np.cumsum(cnt)]).astype(np.int64)
        self.edges_flat = np.ascontiguousarray(Q.T[keep.T], dtype=np.float64)
        self.n_bins = int(max(2, cnt.max(initial=0) + 1))
        self._build_pad_edges()

    def _build_pad_edges(self) -> None:
        """Padded (d, E) edge matrix for the one-pass transform; NaN pads
        never count in >= comparisons."""
        d, cnt = len(self.edge_count), self.edge_count
        E = max(int(cnt.max(initial=0)), 1)
        pad = np.full((d, E), np.nan)
        if len(self.edges_flat):
            rr = np.repeat(np.arange(d), cnt)
            cc = np.arange(len(self.edges_flat)) - np.repeat(
                self.edge_offset[:-1], cnt)
            pad[rr, cc] = self.edges_flat
        self._pad_edges = pad

    @classmethod
    def from_state(cls, edges_flat: np.ndarray, edge_offset: np.ndarray,
                   edge_count: np.ndarray, n_bins: int) -> "Binner":
        """Rebuild a fitted Binner from its saved edge arrays; ``transform``
        is bit-identical to the original."""
        self = cls.__new__(cls)
        self.edge_count = np.asarray(edge_count, dtype=np.int64)
        self.edge_offset = np.asarray(edge_offset, dtype=np.int64)
        self.edges_flat = np.ascontiguousarray(edges_flat, dtype=np.float64)
        self.n_bins = int(n_bins)
        self._build_pad_edges()
        return self

    @property
    def edges(self) -> List[np.ndarray]:
        """Per-feature edge arrays (views into ``edges_flat``)."""
        return [self.edges_flat[self.edge_offset[f]:self.edge_offset[f + 1]]
                for f in range(len(self.edge_count))]

    @property
    def code_dtype(self) -> np.dtype:
        """Dtype of the emitted bin codes (uint8 iff they fit a byte)."""
        return np.dtype(np.uint8 if self.n_bins <= 256 else np.int16)

    def transform(self, X: np.ndarray, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Map raw features to bin codes; bin(x) <= b  <=>  x <= edges[b].

        Exact ``searchsorted(edges_f, x, side='left')`` semantics including
        NaN (which bins past the last edge), one broadcast comparison pass
        per row chunk.  ``out`` streams the codes into a preallocated (n, d)
        array of :attr:`code_dtype` (typically an ``np.memmap``), so only one
        (chunk, d, E) comparison transient is resident; ``X`` may be
        disk-backed too and is read in the same chunks.  The sweep is the
        same with or without ``out``, so streamed codes equal the in-memory
        ones bit for bit.
        """
        n, d = X.shape
        dt = self.code_dtype
        if out is None:
            out = np.empty((n, d), dtype=dt)
        elif out.shape != (n, d) or out.dtype != dt:
            raise ValueError(
                f"out must be shape {(n, d)} dtype {dt}, got "
                f"{out.shape} {out.dtype}")
        pe = self._pad_edges
        cnt = self.edge_count[None, :]
        chunk = max(1, int(_TILE_ELEMS * 4) // max(pe.shape[1] * d, 1))
        for i0 in range(0, n, chunk):
            x = np.asarray(X[i0:i0 + chunk])
            ge = pe[None, :, :] >= x[:, :, None]     # (c, d, E)
            out[i0:i0 + chunk] = (cnt - ge.sum(axis=2)).astype(dt)
        return out

    def transform_memmap(self, X: np.ndarray, path) -> np.memmap:
        """Stream-bin ``X`` into a disk-backed code matrix at ``path``: an
        ``np.memmap`` (mode ``w+``) of shape (n, d) and :attr:`code_dtype`,
        filled chunk by chunk through :meth:`transform`, flushed, and
        returned live.  Both trainer backends take it as it is."""
        n, d = X.shape
        mm = np.memmap(path, dtype=self.code_dtype, mode="w+", shape=(n, d))
        self.transform(X, out=mm)
        mm.flush()
        return mm

    def threshold(self, f: int, b: int) -> float:
        """The raw-unit split threshold of feature ``f`` at bin ``b``."""
        c = int(self.edge_count[f])
        if not c:
            return np.inf
        return float(self.edges_flat[self.edge_offset[f] + min(b, c - 1)])

    def thresholds(self, f: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Raw-unit split thresholds of (feature, bin) arrays."""
        f = np.asarray(f, dtype=np.int64)
        b = np.asarray(b, dtype=np.int64)
        if not len(self.edges_flat):
            return np.full(f.shape, np.inf)
        c = self.edge_count[f]
        idx = self.edge_offset[f] + np.minimum(b, np.maximum(c - 1, 0))
        out = self.edges_flat[np.minimum(idx, len(self.edges_flat) - 1)]
        return np.where(c > 0, out, np.inf)


def _as_code_matrix(Xb) -> np.ndarray:
    """A binned-code matrix as an array, keeping an ``np.memmap`` one:
    ``np.asarray`` would return a plain view and the trainer could no
    longer tell that the codes are disk-backed (:func:`_is_streamed`)."""
    return Xb if isinstance(Xb, np.ndarray) else np.asarray(Xb)


def _is_streamed(Xb: np.ndarray) -> bool:
    """True when the code matrix is disk-backed: the trainer then reads it
    in bounded row gathers and never copies it whole."""
    return isinstance(Xb, np.memmap)


def _check_codes(Xb: np.ndarray, n_bins: int) -> None:
    """Raise unless every code lies in ``[0, n_bins)``: the histogram
    kernel indexes its tables by code.  ``_TILE_ELEMS`` rows at a time, so
    a memmap is read in bounded pieces."""
    for i0 in range(0, Xb.shape[0], _TILE_ELEMS):
        c = np.asarray(Xb[i0:i0 + _TILE_ELEMS])
        if c.size and (int(c.max()) >= n_bins or int(c.min()) < 0):
            raise ValueError(f"bin codes outside [0, {n_bins})")


def _node_values(y: np.ndarray, w: np.ndarray, params: TreeParams) -> np.ndarray:
    if params.task == "classification":
        return np.bincount(y, weights=w, minlength=params.n_classes).astype(np.float32)
    tot = w.sum()
    return np.array([tot, (w * y).sum() / max(tot, 1e-12)], dtype=np.float32)


def fit_tree(X: np.ndarray, y: np.ndarray, w: np.ndarray, params: TreeParams,
             rng: np.random.Generator, binner: Optional[Binner] = None,
             device="cuda") -> Tree:
    """Bin ``X`` (with a new :class:`Binner` drawn from ``rng`` unless one
    is given) and grow one tree on the codes (:func:`fit_tree_binned`)."""
    binner = binner or Binner(X, params.n_bins, rng)
    Xb = binner.transform(X)
    return fit_tree_binned(Xb, y, w, params, rng, binner, device=device)


def fit_tree_binned(Xb: np.ndarray, y: np.ndarray, w: np.ndarray,
                    params: TreeParams, rng: np.random.Generator,
                    binner: Binner, device="cuda") -> Tree:
    """Grow one tree level-wise on pre-binned features.

    ``w`` are per-sample weights (bootstrap multiplicities); samples with
    ``w == 0`` must be excluded by the caller (they are OOB).  The backend
    is ``params.tree_backend`` resolved against ``device`` (the card unless
    the caller asks for the CPU).
    """
    backend = resolve_tree_backend(params.tree_backend, device)
    rows = np.arange(Xb.shape[0], dtype=np.int64)
    task = (rows, np.asarray(w, dtype=np.float64), rng)
    return _grow_trees(_as_code_matrix(Xb), np.asarray(y), [task], params,
                       binner, backend, device)[0]


def fit_forest_binned(Xb: np.ndarray, y: np.ndarray, inbag: np.ndarray,
                      params: TreeParams, rngs: Sequence[np.random.Generator],
                      binner: Binner, backend: Optional[str] = None,
                      tree_block: int = 0, device="cuda") -> List[Tree]:
    """Grow a whole forest as level-synchronous batches of trees.

    Each level issues one histogram/score/partition pass spanning every
    tree's frontier.  ``backend`` (default ``params.tree_backend``) is
    resolved against ``device`` (the card unless the caller asks for the
    CPU).  ``tree_block`` caps how many trees share a batch: 0 auto-sizes
    the cap so resident frontier state (~48 bytes per in-bag instance)
    stays under ``_BATCH_BUDGET``; negative means all trees in one batch.
    Trees are bit-identical to growing each alone with its own RNG stream,
    on either backend, from in-memory or from memmap codes (the torch
    backend stages a memmap's rows per histogram call instead of copying
    it to the device).
    """
    backend = resolve_tree_backend(
        backend if backend is not None else params.tree_backend, device)
    T = inbag.shape[0]
    if tree_block == 0:
        m_avg = max(1.0, float((inbag > 0).sum()) / max(T, 1))
        block = int(max(1, min(T, _BATCH_BUDGET // int(48 * m_avg))))
    elif tree_block < 0:
        block = T
    else:
        block = max(1, int(tree_block))
    Xb = _as_code_matrix(Xb)
    codes = device_codes(Xb, binner, device) \
        if backend == "torch" and not _is_streamed(Xb) else None
    trees: List[Tree] = []
    for b0 in range(0, T, block):
        tasks = []
        for t in range(b0, min(b0 + block, T)):
            rows = np.nonzero(inbag[t])[0].astype(np.int64)
            tasks.append((rows, inbag[t, rows].astype(np.float64), rngs[t]))
        trees += _grow_trees(Xb, y, tasks, params, binner, backend, device,
                             codes)
    return trees


def device_codes(Xb: np.ndarray, binner: Binner, device="cuda"
                 ) -> torch.Tensor:
    """The code matrix on the device, once per fit, as ``uint8`` (``int16``
    past 256 bins) codes checked against ``binner.n_bins``.  In-memory
    codes only: a memmap is staged per histogram call instead."""
    Xb = np.asarray(Xb)
    if Xb.dtype not in (np.uint8, np.int16):
        Xb = Xb.astype(binner.code_dtype)
    _check_codes(Xb, binner.n_bins)
    return torch.as_tensor(np.ascontiguousarray(Xb),
                           device=resolve_device(device))


# --------------------------------------------------------------------------
# level-wise growth
# --------------------------------------------------------------------------

class _TreeStore:
    """Growable struct-of-arrays node store for one tree."""

    __slots__ = ("feat", "thr", "left", "right", "val", "cnt", "n",
                 "last_level")

    def __init__(self, value_dim: int):
        cap = 64
        self.feat = np.full(cap, -2, np.int64)   # -2 unresolved, -1 leaf
        self.thr = np.full(cap, np.inf, np.float64)
        self.left = np.zeros(cap, np.int64)
        self.right = np.zeros(cap, np.int64)
        self.val = np.zeros((cap, value_dim), np.float32)
        self.cnt = np.zeros(cap, np.float64)
        self.n = 0
        self.last_level = 0

    def alloc(self, m: int) -> int:
        need = self.n + m
        cap = len(self.feat)
        if need > cap:
            new = max(need, 2 * cap)

            def grow(a, fill):
                b = np.empty((new,) + a.shape[1:], a.dtype)
                b[:cap] = a
                b[cap:] = fill
                return b

            self.feat = grow(self.feat, -2)
            self.thr = grow(self.thr, np.inf)
            self.left = grow(self.left, 0)
            self.right = grow(self.right, 0)
            self.val = grow(self.val, 0)
            self.cnt = grow(self.cnt, 0.0)
        base = self.n
        self.n = need
        return base

    def to_tree(self) -> Tree:
        n = self.n
        return Tree.from_growth(
            self.feat[:n], self.thr[:n], self.left[:n], self.right[:n],
            self.val[:n], self.cnt[:n],
            depth=self.last_level + 1 if self.last_level else 1)


class _LevelDraws:
    """Per-level RNG draws for one tree, generated chunk-by-chunk in the
    tree's own chunk order — the conformance-critical stream order: per
    chunk, splitter-u first, then the feature-subset mask — but served
    lazily for ascending node-range slices, so only the window between the
    last consumed node and the highest requested one is resident."""

    __slots__ = ("rng", "n_act", "d", "B", "chunk", "random_split", "k",
                 "_gen", "_off", "_parts_u", "_parts_m")

    def __init__(self, rng: np.random.Generator, n_act: int, d: int, B: int,
                 chunk_nodes: int, random_split: bool, k: int):
        self.rng, self.n_act, self.d, self.B = rng, n_act, d, B
        self.chunk, self.random_split, self.k = chunk_nodes, random_split, k
        self._gen = 0        # nodes drawn so far
        self._off = 0        # node index of the first retained part row
        self._parts_u: List[np.ndarray] = []
        self._parts_m: List[np.ndarray] = []

    def take(self, lo: int, hi: int
             ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Draw slices covering node range [lo, hi); ranges must be
        requested in ascending order (fully-consumed parts are freed)."""
        while self._gen < hi:
            c = min(self.chunk, self.n_act - self._gen)
            if self.random_split:
                self._parts_u.append(self.rng.random((c, self.d, self.B)))
            if self.k < self.d:
                cols = self.rng.random((c, self.d)).argsort(axis=1)[:, :self.k]
                mk = np.zeros((c, self.d), dtype=bool)
                np.put_along_axis(mk, cols, True, axis=1)
                self._parts_m.append(mk)
            self._gen += c
        u_out: List[np.ndarray] = []
        m_out: List[np.ndarray] = []
        for parts, out in ((self._parts_u, u_out), (self._parts_m, m_out)):
            pos = self._off
            for p in parts:
                if pos + len(p) > lo and pos < hi:
                    out.append(p[max(lo - pos, 0):hi - pos])
                pos += len(p)
        src = self._parts_u if self._parts_u else self._parts_m
        ndrop = 0
        for p in src:
            if self._off + len(p) > hi:
                break
            self._off += len(p)
            ndrop += 1
        del self._parts_u[:ndrop]
        del self._parts_m[:ndrop]
        return u_out, m_out


def _hist_numpy(Xb: np.ndarray, rows: np.ndarray, w: np.ndarray,
                y_inst: np.ndarray, bounds: np.ndarray, d: int, B: int,
                C: int, cls: bool) -> np.ndarray:
    """(gc, d, B, C) float64 histograms via tiled flat bincounts.

    Feature-tiled so the transient index/weight arrays stay under
    ``_TILE_ELEMS`` elements, with int32 flat indices whenever
    ``gc * d * B * C < 2**31``.  Per-bin accumulation order is sample order.
    A memmap ``Xb`` skips the (m, d) frontier gather and gathers each
    feature tile's (m, td) codes instead, with one bincount a tile either
    way, so the sums (and the trees) are bit-identical.
    """
    gc = len(bounds) - 1
    hist = np.zeros((gc, d, B, C), dtype=np.float64)
    m = len(rows)
    if m == 0 or gc == 0:
        return hist
    size = gc * d * B
    idx_dt = np.int32 if size * C < 2 ** 31 else np.int64
    loc = np.repeat(np.arange(gc, dtype=idx_dt), np.diff(bounds))
    stream = _is_streamed(Xb)
    codes = None if stream else Xb[rows]              # (m, d) small dtype
    td_max = max(1, min(d, int(_TILE_ELEMS // max(m, 1))))
    if cls:
        yl = y_inst.astype(idx_dt)
    else:
        wy = w * y_inst
        wy2 = w * (y_inst * y_inst)
    for f0 in range(0, d, td_max):
        f1 = min(f0 + td_max, d)
        td = f1 - f0
        ct = np.asarray(Xb[rows, f0:f1]) if stream else codes[:, f0:f1]
        base = (loc[:, None] * np.int64(td).astype(idx_dt)
                + np.arange(td, dtype=idx_dt)[None, :]) * B \
            + ct.astype(idx_dt)
        tsize = gc * td * B
        if cls:
            flat = base * C + yl[:, None]
            hist[:, f0:f1] = np.bincount(
                flat.ravel(), weights=np.repeat(w, td),
                minlength=tsize * C).reshape(gc, td, B, C)
        else:
            fr = base.ravel()
            hist[:, f0:f1] = np.stack([
                np.bincount(fr, weights=np.repeat(w, td),
                            minlength=tsize).reshape(gc, td, B),
                np.bincount(fr, weights=np.repeat(wy, td),
                            minlength=tsize).reshape(gc, td, B),
                np.bincount(fr, weights=np.repeat(wy2, td),
                            minlength=tsize).reshape(gc, td, B),
            ], axis=-1)
    return hist


def _seq_sum_last(a: np.ndarray) -> np.ndarray:
    """Sum over the last axis in strictly sequential channel order."""
    s = a[..., 0].copy()
    for c in range(1, a.shape[-1]):
        s += a[..., c]
    return s


def _seq_sq_last(a: np.ndarray) -> np.ndarray:
    s = a[..., 0] * a[..., 0]
    for c in range(1, a.shape[-1]):
        s += a[..., c] * a[..., c]
    return s


def _best_splits(hist: np.ndarray, msl: float, cls: bool, random_split: bool,
                 u: Optional[np.ndarray], mask: Optional[np.ndarray]):
    """Pick the best (feature, bin) split per node from histograms.

    hist: (nodes, d, bins, C).  Returns (gain, feature, bin, node_totals).
    Float64 throughout; ties broken to the first (lowest-index) maximum.
    """
    cum = np.cumsum(hist, axis=2)                      # left stats at bin b
    tot = cum[:, :, -1:, :]                            # (nodes, d, 1, C)
    R = tot - cum
    if cls:
        nL = _seq_sum_last(cum)
        nR = _seq_sum_last(R)
        score = _seq_sq_last(cum) / np.maximum(nL, 1e-12)
        score += _seq_sq_last(R) / np.maximum(nR, 1e-12)
        p0 = tot[:, 0, 0, :]
        parent = _seq_sq_last(p0) / np.maximum(_seq_sum_last(p0), 1e-12)
        gain = score - parent[:, None, None]
        node_tot = np.ascontiguousarray(p0)
    else:
        nL, nR = cum[..., 0], R[..., 0]
        score = cum[..., 1] ** 2 / np.maximum(nL, 1e-12)
        score += R[..., 1] ** 2 / np.maximum(nR, 1e-12)
        parent = tot[..., 0, 1] ** 2 / np.maximum(tot[..., 0, 0], 1e-12)
        gain = score - parent[:, :, None]
        node_tot = np.ascontiguousarray(tot[:, 0, 0, :])

    valid = (nL >= msl) & (nR >= msl)
    valid[:, :, -1] = False                       # last bin -> empty right side
    gain = np.where(valid, gain, -np.inf)

    if random_split:
        # ExtraTrees: one random valid bin per (node, feature).
        uu = np.where(valid, u, -np.inf)
        rb = uu.argmax(axis=2)
        gain = np.take_along_axis(gain, rb[:, :, None], axis=2)[:, :, 0]
        bins_choice = rb
    else:
        bins_choice = gain.argmax(axis=2)
        gain = np.take_along_axis(gain, bins_choice[:, :, None], axis=2)[:, :, 0]

    if mask is not None:                          # per-node feature subset
        gain = np.where(mask, gain, -np.inf)

    f_best = gain.argmax(axis=1)
    g_best = np.take_along_axis(gain, f_best[:, None], axis=1)[:, 0]
    b_best = np.take_along_axis(bins_choice, f_best[:, None], axis=1)[:, 0]
    return g_best, f_best, b_best, node_tot


def _score_torch(hist: torch.Tensor, msl: float, cls: bool,
                 random_split: bool, u: Optional[np.ndarray],
                 mask: Optional[np.ndarray]):
    """``_best_splits`` on the histograms' device (the reference's
    ``_jax_scorer``), returned as host arrays.

    Float64, in numpy's operation order: the bin cumsum is a sequential
    loop over bins (as ``np.cumsum``; torch's CUDA cumsum is not
    deterministic), channel sums and squares are sequential, the two score
    terms are added after dividing, and ``argmax`` takes the first maximum
    (all ``-inf`` gives index 0, as in numpy).  On exact (integer-payload)
    histograms the gains are therefore bit-equal to the numpy path's.
    """
    dev = hist.device
    cum = hist.to(torch.float64, copy=True)
    for b in range(1, cum.shape[2]):
        cum[:, :, b] += cum[:, :, b - 1]
    tot = cum[:, :, -1:, :]
    R = tot - cum
    if cls:
        nL, nR = _sum_last_t(cum), _sum_last_t(R)
        score = _sq_last_t(cum) / nL.clamp_min(1e-12)
        score += _sq_last_t(R) / nR.clamp_min(1e-12)
        p0 = tot[:, 0, 0, :]
        parent = _sq_last_t(p0) / _sum_last_t(p0).clamp_min(1e-12)
        gain = score - parent[:, None, None]
        node_tot = p0
    else:
        nL, nR = cum[..., 0], R[..., 0]
        score = cum[..., 1] * cum[..., 1] / nL.clamp_min(1e-12)
        score += R[..., 1] * R[..., 1] / nR.clamp_min(1e-12)
        t0 = tot[..., 0, :]
        parent = t0[..., 1] * t0[..., 1] / t0[..., 0].clamp_min(1e-12)
        gain = score - parent[:, :, None]
        node_tot = tot[:, 0, 0, :]

    valid = (nL >= msl) & (nR >= msl)
    valid[:, :, -1] = False                       # last bin -> empty right side
    gain = gain.masked_fill(~valid, -np.inf)
    if random_split:
        uu = torch.as_tensor(u, device=dev).masked_fill(~valid, -np.inf)
        bins_choice = uu.argmax(dim=2)
    else:
        bins_choice = gain.argmax(dim=2)
    gain = gain.gather(2, bins_choice[:, :, None])[:, :, 0]
    if mask is not None:
        gain = gain.masked_fill(~torch.as_tensor(mask, device=dev), -np.inf)
    f_best = gain.argmax(dim=1)
    g_best = gain.gather(1, f_best[:, None])[:, 0]
    b_best = bins_choice.gather(1, f_best[:, None])[:, 0]
    return (g_best.cpu().numpy(), f_best.cpu().numpy(),
            b_best.cpu().numpy(), node_tot.cpu().numpy())


def _sum_last_t(a: torch.Tensor) -> torch.Tensor:
    s = a[..., 0].clone()
    for c in range(1, a.shape[-1]):
        s += a[..., c]
    return s


def _sq_last_t(a: torch.Tensor) -> torch.Tensor:
    s = a[..., 0] * a[..., 0]
    for c in range(1, a.shape[-1]):
        s += a[..., c] * a[..., c]
    return s


def _take(a, idx: np.ndarray):
    """``a[idx]`` for a host array or a device tensor (rows ``idx``)."""
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def _ranges_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate index ranges [starts[k], starts[k]+lens[k]) into one array."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.repeat(starts - off, lens) + np.arange(total)


def _partition_numpy(Xb: np.ndarray, rows: np.ndarray, w: np.ndarray,
                     y_inst: np.ndarray, bounds: np.ndarray,
                     split: np.ndarray, best_f: np.ndarray,
                     best_b: np.ndarray, cls: bool, Cv: int):
    """Partition split nodes' samples into child order.

    Returns (rows_next, w_next, child_counts, csum): instances of split
    nodes reordered as [left block, right block] per node (stable within a
    side), per-child instance counts, and per-child payload sums
    (class-weight rows for classification, (Σw, Σwy) for regression).
    """
    gc = len(bounds) - 1
    counts = np.diff(bounds)
    loc = np.repeat(np.arange(gc, dtype=np.int64), counts)
    keep = split[loc]
    rowsk, wk, yk, lock = rows[keep], w[keep], y_inst[keep], loc[keep]
    go_left = Xb[rowsk, best_f[lock]] <= best_b[lock]
    srank = np.cumsum(split) - 1                      # split rank per node
    child_slot = 2 * srank[lock] + (~go_left).astype(np.int64)
    n_child = 2 * int(split.sum())
    order = np.argsort(child_slot, kind="stable")
    rows_next = rowsk[order]
    w_next = wk[order]
    child_counts = np.bincount(child_slot, minlength=n_child).astype(np.int64)
    if cls:
        csum = np.bincount(child_slot * Cv + yk, weights=wk,
                           minlength=n_child * Cv).reshape(n_child, Cv)
    else:
        cw = np.bincount(child_slot, weights=wk, minlength=n_child)
        cwy = np.bincount(child_slot, weights=wk * yk, minlength=n_child)
        csum = np.stack([cw, cwy], axis=1)
    return rows_next, w_next, child_counts, csum


def _grow_trees(Xb: np.ndarray, y: np.ndarray, tasks: Sequence[tuple],
                params: TreeParams, binner: Binner, backend: str = "numpy",
                device="cuda", codes: Optional[torch.Tensor] = None
                ) -> List[Tree]:
    """Grow a batch of trees level-synchronously.

    ``tasks`` is a sequence of ``(rows, w, rng)`` — global sample indices
    into ``Xb``, per-instance weights, and the tree's RNG stream.  All RNG
    consumption happens here, per tree in the same chunked order regardless
    of batch width or backend, which is what makes batched and per-tree
    growth, and both backends, bit-identical.  The ``torch`` backend runs
    on ``device`` (default the card) from ``codes``, the code matrix already
    there (``device_codes``; made here when None), or, for a memmap ``Xb``,
    from the codes each histogram call stages (``codes`` is then unused).
    """
    n_all, d = Xb.shape
    B = int(binner.n_bins)
    cls = params.task == "classification"
    C = params.n_classes if cls else 3      # histogram channels
    Cv = params.n_classes if cls else 2     # stored value dim
    k = params.n_feature_subset(d)
    random_split = params.splitter == "random"
    msl = float(params.min_samples_leaf)
    chunk_nodes = max(1, int(_HIST_BUDGET // max(d * B * C, 1)))
    # Sibling pairs (children 2p, 2p+1) must never straddle a hist chunk for
    # the subtraction trick; per-tree node offsets are even from level 2 on,
    # so an even chunk width is sufficient.  RNG draws are chunk-invariant
    # (``Generator.random`` fills from a sequential stream), so this does
    # not perturb drawn values.
    if chunk_nodes > 1:
        chunk_nodes -= chunk_nodes % 2
    sub_on = chunk_nodes % 2 == 0
    yc = y.astype(np.int64) if cls else np.asarray(y, dtype=np.float64)
    use_torch = backend == "torch"
    if use_torch:
        staged = _is_streamed(Xb)
        if staged:
            _check_codes(Xb, B)
            dev = resolve_device(device)
            codes = None
        else:
            if codes is None:
                codes = device_codes(Xb, binner, device)
            dev = codes.device
        y_dev = torch.as_tensor(yc.astype(np.int32) if cls else yc,
                                device=dev)

        def as_dev(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev)

        # every frontier's row ids are some of the tasks' rows, so their
        # host range covers every histogram call of these trees
        spans = [(int(t[0].min()), int(t[0].max())) for t in tasks
                 if len(t[0])]
        row_range = (min(s[0] for s in spans), max(s[1] for s in spans)) \
            if spans else (0, 0)

        code_t = torch.uint8 if binner.code_dtype == np.uint8 \
            else torch.int16

        def stage(rows_h: np.ndarray) -> torch.Tensor:
            """The codes of host rows ``rows_h``, gathered from the memmap
            in this order into a fresh pinned buffer and copied up without
            blocking (the caching host allocator keeps the buffer until its
            copy has run, so no later gather can overwrite it early)."""
            cpu = dev.type == "cpu"
            buf = torch.empty((len(rows_h), d), dtype=code_t,
                              pin_memory=not cpu)
            out = buf.numpy()
            if Xb.dtype == out.dtype:
                np.take(Xb, rows_h, axis=0, out=out, mode="clip")
            else:
                out[...] = Xb[rows_h]
            return buf if cpu else buf.to(dev, non_blocking=True)

        def torch_hist(r: torch.Tensor, wv: torch.Tensor, bounds: np.ndarray,
                       nn: int, rows_h: np.ndarray) -> torch.Tensor:
            """Device histograms of ``nn`` nodes whose samples (code rows
            ``r`` on the device, ``rows_h`` on the host; weights ``wv``) lie
            in node order, node i's at ``bounds[i] .. bounds[i + 1]`` (host
            offsets: the wrapper then needs nothing back from the device).
            In-memory codes are read through ``r``; streamed codes are
            staged for the call, so the kernel reads them row by row."""
            if staged:
                xb, kw = stage(rows_h), dict(bounds=bounds)
            else:
                xb, kw = codes, dict(rows=r, bounds=bounds,
                                     row_range=row_range)
            if cls:
                return hops.histogram(xb, None, y_dev[r], wv.float(), nn, B,
                                      C, **kw)
            yv = y_dev[r]
            wm = torch.stack([wv, wv * yv, wv * (yv * yv)], dim=1).float()
            return hops.moments(xb, None, wm, nn, B, **kw)

    stores: List[_TreeStore] = []
    acts: List[np.ndarray] = []      # per-tree active node ids (store ids)
    rngs = []
    for rows, w, rng in tasks:
        st = _TreeStore(Cv)
        st.alloc(1)
        st.val[0] = _node_values(y[rows], w, params)
        st.cnt[0] = float(w.sum())
        stores.append(st)
        acts.append(np.zeros(1, np.int64))
        rngs.append(rng)

    # Histogram-subtraction state: per live tree, the retained split-node
    # histograms of the previous level (``ret_hist``, split-rank rows) and
    # the children's known-leaf flags (``ret_kl``) that gate which sibling
    # pairs may be derived instead of accumulated.
    ret_hist: dict = {}
    ret_kl: dict = {}

    # Level-global frontier state: instances of all live trees' active
    # nodes, sorted by (tree, node); the partition step emits the next
    # level's layout directly, so nothing is re-concatenated per level.
    live = list(range(len(tasks)))
    rows_g = np.ascontiguousarray(
        np.concatenate([t[0] for t in tasks]), dtype=np.int64)
    w_g = np.ascontiguousarray(
        np.concatenate([t[1] for t in tasks]), dtype=np.float64)
    bounds_g = np.concatenate(
        [[0], np.cumsum([len(t[0]) for t in tasks])]).astype(np.int64)
    # per-level profiling into the process-wide registry (no-op when it is
    # disabled): host values this loop already holds, no device sync (on
    # the torch branch a level's time is the host loop's, whose device
    # work may still be queued when it is read)
    _reg = global_registry()
    _h_level = _reg.histogram(
        "train_level_seconds", "level-synchronous growth: one level",
        labels=("backend",)).labels(backend=backend)
    _c_levels = _reg.counter(
        "train_levels_total", "tree levels grown",
        labels=("backend",)).labels(backend=backend)
    _g_nodes = _reg.gauge("train_frontier_nodes",
                          "active nodes in the last-grown level")
    _g_rows = _reg.gauge("train_frontier_rows",
                         "frontier sample rows in the last-grown level")

    depth = 0
    while live and depth < params.max_depth:
        depth += 1
        _t_level = time.perf_counter()
        if use_torch:
            rows_dev, w_dev = as_dev(rows_g), as_dev(w_g)
        g_sizes = np.array([len(acts[t]) for t in live], np.int64)
        node_off = np.concatenate([[0], np.cumsum(g_sizes)]).astype(np.int64)
        G = int(node_off[-1])
        y_g = yc[rows_g]
        _g_nodes.set(G)
        _g_rows.set(len(rows_g))

        best_gain = np.empty(G)
        best_f = np.empty(G, np.int64)
        best_b = np.empty(G, np.int64)
        node_tot = np.empty((G, C))

        # Per-tree RNG draws, generated lazily per hist chunk (in each
        # tree's own chunk order) and freed as the chunk sweep passes them.
        draw_cache: dict = {}
        tree_for_node = np.repeat(np.arange(len(live)), g_sizes)

        # ---- histogram-subtraction plan for this level ----
        # ``dm`` marks nodes whose histogram is accumulated directly; a
        # derived node's histogram is ``ret_hist[parent] - hist[sibling]``.
        # A pair is derivable only when neither child is known-leaf-flagged;
        # the computed child is the smaller side (tie -> left).  All
        # decisions are per-tree, so batched == per-tree holds.
        cnts_lvl = np.diff(bounds_g)
        dm = der_par = der_sib = None
        if sub_on and ret_hist:
            dm = np.ones(G, bool)
            der_par = np.zeros(G, np.int64)
            der_sib = np.zeros(G, np.int64)
            for i, t in enumerate(live):
                rh = ret_hist.get(t)
                if rh is None:
                    continue
                kl = ret_kl[t]
                o0i, g = int(node_off[i]), int(g_sizes[i])
                ns_prev = g // 2
                pair_ok = ~(kl[0::2] | kl[1::2])
                lc = cnts_lvl[o0i:o0i + g:2]
                rc = cnts_lvl[o0i + 1:o0i + g:2]
                left_small = lc <= rc
                base2 = 2 * np.arange(ns_prev, dtype=np.int64)
                der_loc = np.where(left_small, base2 + 1, base2)[pair_ok]
                sib_loc = np.where(left_small, base2, base2 + 1)[pair_ok]
                dm[o0i + der_loc] = False
                der_par[o0i + der_loc] = np.flatnonzero(pair_ok)
                der_sib[o0i + der_loc] = o0i + sib_loc
            if dm.all():
                dm = None
        stash_set = set()
        if sub_on:
            for i in range(len(live)):
                if g_sizes[i] <= _SUB_MAX_PARENTS:
                    stash_set.add(i)
        pend: dict = {}

        def draws_for(i: int) -> _LevelDraws:
            if i not in draw_cache:
                draw_cache[i] = _LevelDraws(
                    rngs[live[i]], int(g_sizes[i]), d, B, chunk_nodes,
                    random_split, k)
            return draw_cache[i]

        for c0 in range(0, G, chunk_nodes):
            c1 = min(c0 + chunk_nodes, G)
            s0, s1 = int(bounds_g[c0]), int(bounds_g[c1])
            bch = bounds_g[c0:c1 + 1] - s0
            u_ch = m_ch = None
            if random_split or k < d:
                u_parts, m_parts = [], []
                for i in range(int(tree_for_node[c0]),
                               int(tree_for_node[c1 - 1]) + 1):
                    lo = max(c0, int(node_off[i])) - int(node_off[i])
                    hi = min(c1, int(node_off[i + 1])) - int(node_off[i])
                    us, ms = draws_for(i).take(lo, hi)
                    u_parts += us
                    m_parts += ms
                if random_split:
                    u_ch = np.ascontiguousarray(
                        u_parts[0] if len(u_parts) == 1
                        else np.concatenate(u_parts))
                if k < d:
                    m_ch = np.ascontiguousarray(
                        m_parts[0] if len(m_parts) == 1
                        else np.concatenate(m_parts))
                for i in list(draw_cache):
                    if int(node_off[i + 1]) <= c1:
                        del draw_cache[i]

            gcc = c1 - c0
            i_lo, i_hi = int(tree_for_node[c0]), int(tree_for_node[c1 - 1])
            has_stash = any(i in stash_set for i in range(i_lo, i_hi + 1))
            dm_ch = dm[c0:c1] if dm is not None else None
            all_direct = dm_ch is None or bool(dm_ch.all())

            if all_direct:
                if use_torch:
                    hist = torch_hist(rows_dev[s0:s1], w_dev[s0:s1], bch,
                                      gcc, rows_g[s0:s1])
                else:
                    hist = _hist_numpy(Xb, rows_g[s0:s1], w_g[s0:s1],
                                       y_g[s0:s1], bch, d, B, C, cls)
            else:
                dn = np.flatnonzero(dm_ch)
                dl = np.flatnonzero(~dm_ch)
                d_starts = bounds_g[dn + c0]
                d_lens = bounds_g[dn + c0 + 1] - d_starts
                sel = _ranges_concat(d_starts, d_lens)
                bnd_d = np.concatenate([[0], np.cumsum(d_lens)]) \
                    .astype(np.int64)
                if use_torch:
                    sel_dev = as_dev(sel)
                    h_dir = torch_hist(rows_dev[sel_dev], w_dev[sel_dev],
                                       bnd_d, len(dn), rows_g[sel])
                    hist = torch.empty((gcc, d, B, C), dtype=torch.float32,
                                       device=dev)
                    hist[as_dev(dn)] = h_dir
                else:
                    h_dir = _hist_numpy(
                        Xb, np.ascontiguousarray(rows_g[sel]),
                        np.ascontiguousarray(w_g[sel]),
                        np.ascontiguousarray(y_g[sel]), bnd_d, d, B, C, cls)
                    hist = np.empty((gcc, d, B, C), np.float64)
                    hist[dn] = h_dir
                # stacked retained-parent hist rows aligned with ``dl``
                # (trees ascend with node index, so per-tree parts
                # concatenate in ``dl`` order)
                parts = []
                for i in range(i_lo, i_hi + 1):
                    rh = ret_hist.get(live[i])
                    if rh is None:
                        continue
                    o0i = int(node_off[i])
                    o1i = int(node_off[i + 1])
                    g_dl = dl[(dl + c0 >= o0i) & (dl + c0 < o1i)]
                    if len(g_dl):
                        parts.append(_take(rh, der_par[g_dl + c0]))
                # float32 on the device, float64 on the host; exact either
                # way on integer payloads
                sib = der_sib[dl + c0] - c0
                if use_torch:
                    hist[as_dev(dl)] = torch.cat(parts, dim=0) - \
                        hist[as_dev(sib)]
                else:
                    hist[dl] = np.concatenate(parts, axis=0) - hist[sib]

            if has_stash:
                for i in range(i_lo, i_hi + 1):
                    if i not in stash_set:
                        continue
                    o0i, o1i = int(node_off[i]), int(node_off[i + 1])
                    lo, hi = max(o0i, c0), min(o1i, c1)
                    if lo < hi:
                        sl = hist[lo - c0:hi - c0]
                        pend.setdefault(live[i], []).append(
                            sl if use_torch else sl.copy())

            score = _score_torch if use_torch else _best_splits
            (best_gain[c0:c1], best_f[c0:c1], best_b[c0:c1],
             node_tot[c0:c1]) = score(hist, msl, cls, random_split, u_ch,
                                      m_ch)

        # ---- split / leaf decisions, vectorized over every tree's nodes ----
        nw = node_tot.sum(1) if cls else node_tot[:, 0]
        if cls:
            pure = node_tot.max(1) >= nw - 1e-9
        else:
            pure = node_tot[:, 2] - node_tot[:, 1] ** 2 \
                / np.maximum(nw, 1e-12) <= 1e-12
        split_g = ~((best_gain <= 1e-12) | (nw < params.min_samples_split)
                    | pure | (depth >= params.max_depth))

        n_split_g = int(split_g.sum())
        if n_split_g:
            rows_nx, w_nx, child_counts, csum = _partition_numpy(
                Xb, rows_g, w_g, y_g, bounds_g, split_g, best_f,
                best_b, cls, Cv)
            if cls:
                cvals = csum
            else:
                cvals = np.stack(
                    [csum[:, 0],
                     csum[:, 1] / np.maximum(csum[:, 0], 1e-12)], axis=1)
            ccnt = cvals.sum(1) if cls else cvals[:, 0]
            sr = np.concatenate([[0], np.cumsum(split_g)]).astype(np.int64)

            # ---- early leaf pruning ----
            # Children that can never split — single-instance, weighted
            # count below min_samples_split, or (classification) a single
            # nonzero class in their payload row — are dropped from the
            # next frontier's *sample* set before the histogram pass.  The
            # nodes themselves stay in ``acts`` with zero-width ranges, so
            # per-tree RNG draw counts are unchanged: a zero-sample node
            # scores -inf on every split and becomes the same leaf (its
            # value was already stored from csum above) that a real pass
            # would have produced.
            known_leaf = child_counts <= 1
            known_leaf |= ccnt < params.min_samples_split - 1e-6
            if cls:
                known_leaf |= (csum > 0).sum(axis=1) <= 1
            if known_leaf.any():
                keep_samples = np.repeat(~known_leaf, child_counts)
                rows_nx = np.ascontiguousarray(rows_nx[keep_samples])
                w_nx = np.ascontiguousarray(w_nx[keep_samples])
                child_counts = np.where(known_leaf, 0, child_counts)

        new_live = []
        new_ret_h: dict = {}
        new_ret_kl: dict = {}
        for i, t in enumerate(live):
            o0, o1 = int(node_off[i]), int(node_off[i + 1])
            st = stores[t]
            sp = split_g[o0:o1]
            ns = int(sp.sum())
            if not ns:
                # every active node became a leaf; unresolved feat (-2)
                # entries are converted at assembly
                acts[t] = np.empty(0, np.int64)
                pend.pop(t, None)
                continue
            a_s = acts[t][sp]
            f_s = best_f[o0:o1][sp]
            b_s = best_b[o0:o1][sp]
            base = st.alloc(2 * ns)
            st.feat[a_s] = f_s
            st.thr[a_s] = binner.thresholds(f_s, b_s)
            cid = base + np.arange(2 * ns, dtype=np.int64)
            st.left[a_s] = cid[0::2]
            st.right[a_s] = cid[1::2]
            st.last_level = depth
            s_lo, s_hi = int(sr[o0]), int(sr[o1])
            st.val[base:base + 2 * ns] = \
                cvals[2 * s_lo:2 * s_hi].astype(np.float32)
            st.cnt[base:base + 2 * ns] = ccnt[2 * s_lo:2 * s_hi]
            parts = pend.pop(t, None)
            if parts is not None:
                # retain this level's split-node histograms (split-rank
                # rows) + the children's known-leaf flags for next level's
                # sibling subtraction
                full_h = parts[0] if len(parts) == 1 else (
                    torch.cat(parts, dim=0) if use_torch
                    else np.concatenate(parts, axis=0))
                new_ret_h[t] = _take(full_h, np.flatnonzero(sp))
                new_ret_kl[t] = known_leaf[2 * s_lo:2 * s_hi].copy()
            acts[t] = cid
            new_live.append(t)
        live = new_live
        ret_hist, ret_kl = new_ret_h, new_ret_kl
        if n_split_g:
            # partition output IS the next level's global frontier layout
            rows_g, w_g = rows_nx, w_nx
            bounds_g = np.concatenate(
                [[0], np.cumsum(child_counts)]).astype(np.int64)
        else:
            rows_g = np.empty(0, np.int64)
            w_g = np.empty(0, np.float64)
            bounds_g = np.zeros(1, np.int64)
        _h_level.observe(time.perf_counter() - _t_level)
        _c_levels.inc()

    return [st.to_tree() for st in stores]
