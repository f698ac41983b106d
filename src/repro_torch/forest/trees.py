"""Flattened decision-tree structures and routing.

Trees are stored as struct-of-arrays (copy of the reference's layout).  A
single :class:`Tree` holds one tree; :class:`TreeArrays` holds a whole
ensemble padded to ``max_nodes``, which is what the routing kernel
(``kernels/leaf_route``) reads.

Conventions
-----------
- node 0 is the root.
- ``feature[n] >= 0``  -> internal node splitting on that feature with
  ``threshold[n]``; samples with ``x[f] <= thr`` go to ``left[n]`` else
  ``right[n]`` (so NaN goes right).
- ``feature[n] == -1`` -> leaf; ``leaf_id[n]`` is the *within-tree* leaf
  ordinal in ``[0, n_leaves)``; internal nodes have ``leaf_id == -1``.
- ``value[n]`` stores the training prediction payload (class histogram row
  or (count, mean)) and ``n_node_samples[n]`` the in-node training count.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.leaf_route.ops import route, route_tables

__all__ = ["Tree", "TreeArrays", "route_tree", "route_forest_batched",
           "stack_leaf_values", "pack_trees", "unpack_trees"]


@dataclasses.dataclass
class Tree:
    """One decision tree in flattened (struct-of-arrays) form."""

    feature: np.ndarray        # (n_nodes,) int32, -1 for leaves
    threshold: np.ndarray      # (n_nodes,) float32 (bin-edge value in raw feature units)
    left: np.ndarray           # (n_nodes,) int32
    right: np.ndarray          # (n_nodes,) int32
    leaf_id: np.ndarray        # (n_nodes,) int32, -1 for internal
    value: np.ndarray          # (n_nodes, value_dim) float32
    n_node_samples: np.ndarray  # (n_nodes,) int32
    depth: int = 0

    @classmethod
    def from_growth(cls, feature: np.ndarray, threshold: np.ndarray,
                    left: np.ndarray, right: np.ndarray, value: np.ndarray,
                    counts: np.ndarray, depth: int) -> "Tree":
        """Finalize a grown node store into a Tree.

        Unresolved nodes (``feature == -2``, i.e. depth-capped frontiers)
        become leaves, and ``leaf_id`` numbers all leaves in node order.
        """
        feature = np.where(feature == -2, -1, feature).astype(np.int32)
        leaf = feature == -1
        leaf_id = np.full(len(feature), -1, dtype=np.int32)
        leaf_id[leaf] = np.arange(int(leaf.sum()), dtype=np.int32)
        return cls(
            feature=feature,
            threshold=np.asarray(threshold, dtype=np.float32),
            left=np.asarray(left, dtype=np.int32),
            right=np.asarray(right, dtype=np.int32),
            leaf_id=leaf_id,
            value=np.asarray(value, dtype=np.float32),
            n_node_samples=np.asarray(np.round(counts), dtype=np.int32),
            depth=depth,
        )

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int((self.feature == -1).sum())

    def leaf_nodes(self) -> np.ndarray:
        """Node indices of leaves, ordered by ``leaf_id``."""
        idx = np.nonzero(self.feature == -1)[0]
        order = np.argsort(self.leaf_id[idx])
        return idx[order].astype(np.int32)

    def leaf_values(self) -> np.ndarray:
        """(n_leaves, value_dim) prediction payloads ordered by leaf_id."""
        return self.value[self.leaf_nodes()]


def route_tree(tree: Tree, X: np.ndarray) -> np.ndarray:
    """Route samples through one tree (the per-tree oracle).  Returns
    within-tree leaf ids (int32); ``depth`` vectorized steps."""
    n = X.shape[0]
    node = np.zeros(n, dtype=np.int32)
    feat = tree.feature
    thr = tree.threshold
    left = tree.left
    right = tree.right
    for _ in range(max(tree.depth, 1)):
        f = feat[node]
        internal = f >= 0
        if not internal.any():
            break
        fi = np.where(internal, f, 0)
        go_left = X[np.arange(n), fi] <= thr[node]
        nxt = np.where(go_left, left[node], right[node])
        node = np.where(internal, nxt, node).astype(np.int32)
    return tree.leaf_id[node].astype(np.int32)


def route_forest_batched(ta: "TreeArrays", X, device="cuda") -> torch.Tensor:
    """(N, T) int32 within-tree leaf ids on ``device``, through the routing
    kernel (its plain PyTorch version on the CPU).  ``X`` is compared in
    float64 against the float32 thresholds widened to float64, as the
    reference's default routing does."""
    dev = resolve_device(device)
    return route(torch.as_tensor(X, dtype=torch.float64, device=dev),
                 route_tables(ta, dev))


# ---------------------------------------------------------------------------
# snapshot (de)serialization
# ---------------------------------------------------------------------------

def pack_trees(trees: Sequence[Tree]) -> dict:
    """Concatenate a fitted forest's trees into flat savez-able arrays, with
    a ``(T+1,)`` ``node_offset`` prefix sum and ``(T,)`` depths (the
    reference's snapshot layout)."""
    counts = np.asarray([t.n_nodes for t in trees], dtype=np.int64)
    return {
        "node_offset": np.concatenate([[0], np.cumsum(counts)]),
        "depth": np.asarray([t.depth for t in trees], dtype=np.int64),
        "feature": np.concatenate([t.feature for t in trees]),
        "threshold": np.concatenate([t.threshold for t in trees]),
        "left": np.concatenate([t.left for t in trees]),
        "right": np.concatenate([t.right for t in trees]),
        "leaf_id": np.concatenate([t.leaf_id for t in trees]),
        "value": np.concatenate([t.value for t in trees], axis=0),
        "n_node_samples": np.concatenate([t.n_node_samples for t in trees]),
    }


def unpack_trees(arrays: dict) -> List["Tree"]:
    """Inverse of :func:`pack_trees`."""
    off = np.asarray(arrays["node_offset"], dtype=np.int64)
    depth = np.asarray(arrays["depth"], dtype=np.int64)
    out: List[Tree] = []
    for t in range(len(depth)):
        lo, hi = int(off[t]), int(off[t + 1])
        out.append(Tree(
            feature=np.ascontiguousarray(arrays["feature"][lo:hi],
                                         dtype=np.int32),
            threshold=np.ascontiguousarray(arrays["threshold"][lo:hi],
                                           dtype=np.float32),
            left=np.ascontiguousarray(arrays["left"][lo:hi], dtype=np.int32),
            right=np.ascontiguousarray(arrays["right"][lo:hi],
                                       dtype=np.int32),
            leaf_id=np.ascontiguousarray(arrays["leaf_id"][lo:hi],
                                         dtype=np.int32),
            value=np.ascontiguousarray(arrays["value"][lo:hi],
                                       dtype=np.float32),
            n_node_samples=np.ascontiguousarray(
                arrays["n_node_samples"][lo:hi], dtype=np.int32),
            depth=int(depth[t]),
        ))
    return out


def stack_leaf_values(trees: Sequence[Tree]) -> np.ndarray:
    """(L, value_dim) float64 global leaf-value table, tree-major: row
    ``leaf_offset[t] + leaf_id`` holds tree t's payload for that leaf."""
    return np.concatenate([t.leaf_values().astype(np.float64) for t in trees],
                          axis=0)


@dataclasses.dataclass
class TreeArrays:
    """Whole ensemble padded to (T, max_nodes) for batched routing.

    Padding nodes are leaves with ``feature == -1`` and ``leaf_id == 0`` so
    routing through them is harmless (they are unreachable anyway).
    """

    feature: np.ndarray     # (T, max_nodes) int32
    threshold: np.ndarray   # (T, max_nodes) float32
    left: np.ndarray        # (T, max_nodes) int32
    right: np.ndarray       # (T, max_nodes) int32
    leaf_id: np.ndarray     # (T, max_nodes) int32
    n_leaves: np.ndarray    # (T,) int32
    leaf_offset: np.ndarray  # (T,) int64 — global leaf index base per tree
    max_depth: int
    _flat: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    @property
    def n_trees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def total_leaves(self) -> int:
        return int(self.n_leaves.sum())

    def flat(self) -> tuple:
        """Flattened node arrays with *global* node ids (tree t's node n at
        ``t * max_nodes + n``), children interleaved as ``lr[2g] = left,
        lr[2g+1] = right`` so an advance is one gather indexed by the
        compare bit.  Node ids are int32, hence the ``2·T·M < 2³¹`` guard.
        """
        if self._flat is None:
            T, M = self.feature.shape
            if 2 * T * M >= np.iinfo(np.int32).max:
                raise ValueError("ensemble too large for int32 node ids")
            base = (np.arange(T, dtype=np.int32) * M)[:, None]
            feature_f = np.ascontiguousarray(self.feature.ravel())
            threshold_f = np.ascontiguousarray(
                self.threshold.ravel().astype(np.float64))
            lr = np.empty(2 * T * M, dtype=np.int32)
            lr[0::2] = (self.left + base).ravel()
            lr[1::2] = (self.right + base).ravel()
            leaf_f = np.ascontiguousarray(self.leaf_id.ravel())
            self._flat = (feature_f, threshold_f, lr, leaf_f)
        return self._flat

    @classmethod
    def from_trees(cls, trees: Sequence[Tree]) -> "TreeArrays":
        T = len(trees)
        max_nodes = max(t.n_nodes for t in trees)
        feature = np.full((T, max_nodes), -1, dtype=np.int32)
        threshold = np.zeros((T, max_nodes), dtype=np.float32)
        left = np.zeros((T, max_nodes), dtype=np.int32)
        right = np.zeros((T, max_nodes), dtype=np.int32)
        leaf_id = np.zeros((T, max_nodes), dtype=np.int32)
        n_leaves = np.zeros(T, dtype=np.int32)
        for t, tr in enumerate(trees):
            n = tr.n_nodes
            feature[t, :n] = tr.feature
            threshold[t, :n] = tr.threshold
            left[t, :n] = tr.left
            right[t, :n] = tr.right
            leaf_id[t, :n] = np.where(tr.leaf_id < 0, 0, tr.leaf_id)
            n_leaves[t] = tr.n_leaves
        leaf_offset = np.concatenate([[0], np.cumsum(n_leaves)[:-1]]).astype(np.int64)
        return cls(
            feature=feature, threshold=threshold, left=left, right=right,
            leaf_id=leaf_id, n_leaves=n_leaves, leaf_offset=leaf_offset,
            max_depth=max(t.depth for t in trees),
        )
