"""Level-wise histogram CART training on the host (numpy).

Copy of the reference trainer's ``numpy`` backend: features are pre-binned to
``n_bins`` quantile bins, and at each tree level the class/moment histograms
of *all* active nodes are accumulated in one vectorized pass over a
flattened (node, feature, bin[, class]) index, so growing to purity costs
``O(N d depth)`` per tree.  Sibling histograms are derived as
``parent − smaller child`` while a tree's level is narrow (the
histogram-subtraction trick), and children that can never split are dropped
from the next frontier's sample set (early-leaf pruning).

Every RNG draw happens here, per tree in the same chunked order as the
reference, and split scores use the same float64 operation order with
first-maximum tie-breaking, so trees are bit-identical to the reference's
numpy (and hence native) backend.  The reference's native C and jax
branches, its out-of-core (memmap) path and its metrics calls are not part
of this copy; the device histogram kernels come with the trainer slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .trees import Tree

__all__ = ["TreeParams", "Binner", "fit_tree_binned", "fit_forest_binned"]

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

    def n_feature_subset(self, d: int) -> int:
        mf = self.max_features
        if mf is None:
            return d
        if mf == "sqrt":
            return max(1, int(np.sqrt(d)))
        if mf == "log2":
            return max(1, int(np.log2(d)))
        return max(1, min(int(mf), d))


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
    def code_dtype(self) -> np.dtype:
        """Dtype of the emitted bin codes (uint8 iff they fit a byte)."""
        return np.dtype(np.uint8 if self.n_bins <= 256 else np.int16)

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Map raw features to bin codes; bin(x) <= b  <=>  x <= edges[b].

        Exact ``searchsorted(edges_f, x, side='left')`` semantics including
        NaN (which bins past the last edge).
        """
        n, d = X.shape
        dt = self.code_dtype
        out = np.empty((n, d), dtype=dt)
        pe = self._pad_edges
        cnt = self.edge_count[None, :]
        chunk = max(1, int(_TILE_ELEMS * 4) // max(pe.shape[1] * d, 1))
        for i0 in range(0, n, chunk):
            x = np.asarray(X[i0:i0 + chunk])
            ge = pe[None, :, :] >= x[:, :, None]     # (c, d, E)
            out[i0:i0 + chunk] = (cnt - ge.sum(axis=2)).astype(dt)
        return out

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


def _node_values(y: np.ndarray, w: np.ndarray, params: TreeParams) -> np.ndarray:
    if params.task == "classification":
        return np.bincount(y, weights=w, minlength=params.n_classes).astype(np.float32)
    tot = w.sum()
    return np.array([tot, (w * y).sum() / max(tot, 1e-12)], dtype=np.float32)


def fit_tree_binned(Xb: np.ndarray, y: np.ndarray, w: np.ndarray,
                    params: TreeParams, rng: np.random.Generator,
                    binner: Binner) -> Tree:
    """Grow one tree level-wise on pre-binned features.

    ``w`` are per-sample weights (bootstrap multiplicities); samples with
    ``w == 0`` must be excluded by the caller (they are OOB).
    """
    rows = np.arange(Xb.shape[0], dtype=np.int64)
    task = (rows, np.asarray(w, dtype=np.float64), rng)
    return _grow_trees(np.asarray(Xb), np.asarray(y), [task], params,
                       binner)[0]


def fit_forest_binned(Xb: np.ndarray, y: np.ndarray, inbag: np.ndarray,
                      params: TreeParams, rngs: Sequence[np.random.Generator],
                      binner: Binner, tree_block: int = 0) -> List[Tree]:
    """Grow a whole forest as level-synchronous batches of trees.

    Each level issues one histogram/score/partition pass spanning every
    tree's frontier.  ``tree_block`` caps how many trees share a batch: 0
    auto-sizes the cap so resident frontier state (~48 bytes per in-bag
    instance) stays under ``_BATCH_BUDGET``; negative means all trees in one
    batch.  Trees are bit-identical to growing each alone with its own RNG
    stream.
    """
    T = inbag.shape[0]
    if tree_block == 0:
        m_avg = max(1.0, float((inbag > 0).sum()) / max(T, 1))
        block = int(max(1, min(T, _BATCH_BUDGET // int(48 * m_avg))))
    elif tree_block < 0:
        block = T
    else:
        block = max(1, int(tree_block))
    Xb = np.asarray(Xb)
    trees: List[Tree] = []
    for b0 in range(0, T, block):
        tasks = []
        for t in range(b0, min(b0 + block, T)):
            rows = np.nonzero(inbag[t])[0].astype(np.int64)
            tasks.append((rows, inbag[t, rows].astype(np.float64), rngs[t]))
        trees += _grow_trees(Xb, y, tasks, params, binner)
    return trees


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
    """
    gc = len(bounds) - 1
    hist = np.zeros((gc, d, B, C), dtype=np.float64)
    m = len(rows)
    if m == 0 or gc == 0:
        return hist
    size = gc * d * B
    idx_dt = np.int32 if size * C < 2 ** 31 else np.int64
    loc = np.repeat(np.arange(gc, dtype=idx_dt), np.diff(bounds))
    codes = Xb[rows]                                  # (m, d) small dtype
    td_max = max(1, min(d, int(_TILE_ELEMS // max(m, 1))))
    if cls:
        yl = y_inst.astype(idx_dt)
    else:
        wy = w * y_inst
        wy2 = w * (y_inst * y_inst)
    for f0 in range(0, d, td_max):
        f1 = min(f0 + td_max, d)
        td = f1 - f0
        ct = codes[:, f0:f1]
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
                params: TreeParams, binner: Binner) -> List[Tree]:
    """Grow a batch of trees level-synchronously.

    ``tasks`` is a sequence of ``(rows, w, rng)`` — global sample indices
    into ``Xb``, per-instance weights, and the tree's RNG stream.  All RNG
    consumption happens here, per tree in the same chunked order regardless
    of batch width, which is what makes batched and per-tree growth
    bit-identical.
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

    depth = 0
    while live and depth < params.max_depth:
        depth += 1
        g_sizes = np.array([len(acts[t]) for t in live], np.int64)
        node_off = np.concatenate([[0], np.cumsum(g_sizes)]).astype(np.int64)
        G = int(node_off[-1])
        y_g = yc[rows_g]

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
                h_dir = _hist_numpy(Xb, np.ascontiguousarray(rows_g[sel]),
                                    np.ascontiguousarray(w_g[sel]),
                                    np.ascontiguousarray(y_g[sel]), bnd_d,
                                    d, B, C, cls)
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
                        parts.append(rh[der_par[g_dl + c0]])
                par = np.concatenate(parts, axis=0)
                hist[dl] = par - hist[der_sib[dl + c0] - c0]

            if has_stash:
                for i in range(i_lo, i_hi + 1):
                    if i not in stash_set:
                        continue
                    o0i, o1i = int(node_off[i]), int(node_off[i + 1])
                    lo, hi = max(o0i, c0), min(o1i, c1)
                    if lo < hi:
                        pend.setdefault(live[i], []).append(
                            hist[lo - c0:hi - c0].copy())

            (best_gain[c0:c1], best_f[c0:c1], best_b[c0:c1],
             node_tot[c0:c1]) = _best_splits(hist, msl, cls, random_split,
                                             u_ch, m_ch)

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
                full_h = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
                new_ret_h[t] = full_h[np.flatnonzero(sp)]
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

    return [st.to_tree() for st in stores]
