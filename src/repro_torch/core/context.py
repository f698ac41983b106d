"""Ensemble context (T, θ) — §2.2 of the paper, on the forest's device.

Bundles everything the SWLC weight assignments need: the routed leaf codes
of the training set, global leaf indexing, and the auxiliary statistics θ
(leaf masses, in-bag multiplicities, OOB indicators, per-tree weights,
per-tree split-feature sets).
Leaf codes and θ live on the device; the per-tree leaf counts and offsets
stay on the host as well, where the CSR build reads them.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

__all__ = ["EnsembleContext"]


def _host(a, dtype) -> np.ndarray:
    """A contiguous host copy of tensor or array ``a`` in ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


@dataclasses.dataclass
class EnsembleContext:
    """Fixed context computed once after forest training (cost O(N T h̄))."""

    leaves: torch.Tensor        # (N, T) int32 within-tree leaf ids of TRAIN samples
    leaf_offset: np.ndarray     # (T,) int64 global leaf base per tree (host)
    n_leaves: np.ndarray        # (T,) int32 (host)
    total_leaves: int
    n_train: int

    # θ — auxiliary statistics, on the device
    leaf_mass: torch.Tensor              # (L,) float64: # train samples per global leaf
    leaf_mass_inbag: torch.Tensor        # (L,) float64: Σ_i c_t(i) per global leaf
    inbag: Optional[torch.Tensor]        # (T, N) int32 in-bag multiplicities c_t(x_i)
    oob: Optional[torch.Tensor]          # (T, N) bool  o_t(x_i)
    oob_count: Optional[torch.Tensor]    # (N,) int64  S(x_i)
    tree_weights: torch.Tensor           # (T,) float64
    y: Optional[np.ndarray] = None       # training labels (host)
    X: Optional[np.ndarray] = None       # training features (host)
    tree_features: Optional[list] = None  # per-tree split-feature sets (host)

    @property
    def n_trees(self) -> int:
        return int(self.leaves.shape[1])

    @property
    def device(self) -> torch.device:
        return self.leaves.device

    def global_leaves(self, leaves: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """(N, T) int32 global leaf indices (tree offset applied); int32 is
        exact because ``total_leaves < 2³¹`` is checked at construction."""
        lv = self.leaves if leaves is None else leaves
        off = torch.as_tensor(self.leaf_offset.astype(np.int32),
                              device=lv.device)
        return lv.to(torch.int32) + off[None, :]

    def digest(self) -> str:
        """Structural sha256 of (T, θ): leaf codes, global indexing, masses,
        in-bag state and tree weights — the reference's
        ``EnsembleContext.digest``, string for string.  Snapshot load
        rebuilds the context from saved arrays and checks the digest
        recorded at save time.  Every array is hashed as a host copy in the
        reference's dtype (leaf codes int32, offsets and OOB counts int64,
        leaf counts and in-bag counts int32, masses and tree weights
        float64, OOB flags bool), so an archive written by either package
        validates in the other."""
        h = hashlib.sha256()
        h.update(str((self.total_leaves, self.n_train)).encode())
        for a, dt in ((self.leaves, np.int32), (self.leaf_offset, np.int64),
                      (self.n_leaves, np.int32),
                      (self.leaf_mass, np.float64),
                      (self.leaf_mass_inbag, np.float64),
                      (self.inbag, np.int32), (self.oob, np.bool_),
                      (self.oob_count, np.int64),
                      (self.tree_weights, np.float64)):
            if a is None:
                h.update(b"none")
                continue
            a = _host(a, dt)
            h.update(str((a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    @classmethod
    def from_forest(cls, forest, X: Optional[np.ndarray] = None,
                    y: Optional[np.ndarray] = None, leaves=None,
                    row_chunk: Optional[int] = None) -> "EnsembleContext":
        """Route ``X`` (default: the forest's training set) on the forest's
        device, unless its ``leaves`` are given, and accumulate the masses
        there with ``torch.bincount``.  Both masses are sums of integers, so
        the order of the device's atomic adds does not change them.

        ``row_chunk`` routes ``X`` (which may be disk-backed) and
        accumulates the masses in row chunks of that size, bounding the
        transient (chunk, T) footprint of an out-of-core build; the sums are
        exact, so the digest is the same at every chunk size."""
        X = forest.X_ if X is None else X
        y = forest.y_ if y is None else y
        ta = forest.tree_arrays()
        L = ta.total_leaves
        if L >= 2 ** 31:
            raise ValueError(f"{L} leaves exceed int32 global leaf ids")
        dev = forest.route_tables_.device
        n = len(X) if leaves is None else len(leaves)
        T = len(ta.n_leaves)
        step = max(1, n if row_chunk is None else int(row_chunk))
        if leaves is None:
            leaves = torch.empty((n, T), dtype=torch.int32, device=dev)
            for i0 in range(0, n, step):
                leaves[i0:i0 + step] = forest.apply(
                    np.asarray(X[i0:i0 + step]))
        leaves = torch.as_tensor(leaves, device=dev).to(torch.int32)
        off = torch.as_tensor(ta.leaf_offset.astype(np.int32), device=dev)
        inbag = forest.inbag_
        inbag_d = None if inbag is None else torch.as_tensor(
            inbag, dtype=torch.int32, device=dev)
        mass = torch.zeros(L, dtype=torch.int64, device=dev)
        mass_inbag = torch.zeros(L, dtype=torch.float64, device=dev)
        for i0 in range(0, n, step):
            gl = leaves[i0:i0 + step] + off[None, :]
            mass += torch.bincount(gl.reshape(-1), minlength=L)
            if inbag_d is not None:
                mass_inbag += torch.bincount(
                    gl.t().reshape(-1),
                    weights=inbag_d[:, i0:i0 + step].reshape(-1).double(),
                    minlength=L)
        leaf_mass = mass.to(torch.float64)
        if inbag_d is not None:
            leaf_mass_inbag = mass_inbag
            oob = inbag_d == 0
            oob_count = oob.sum(0).to(torch.int64)
        else:
            oob = oob_count = None
            leaf_mass_inbag = leaf_mass.clone()
        tw = forest.tree_weights_
        tw = torch.ones(T, dtype=torch.float64, device=dev) if tw is None \
            else torch.as_tensor(tw, dtype=torch.float64, device=dev)
        tree_features = [np.unique(t.feature[t.feature >= 0])
                         for t in forest.trees_]
        return cls(
            leaves=leaves, leaf_offset=np.asarray(ta.leaf_offset),
            n_leaves=np.asarray(ta.n_leaves), total_leaves=L, n_train=n,
            leaf_mass=leaf_mass, leaf_mass_inbag=leaf_mass_inbag,
            inbag=inbag_d, oob=oob, oob_count=oob_count, tree_weights=tw,
            y=y, X=X, tree_features=tree_features)
