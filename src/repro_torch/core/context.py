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
from typing import Optional

import numpy as np
import torch

__all__ = ["EnsembleContext"]


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

    @classmethod
    def from_forest(cls, forest, X: Optional[np.ndarray] = None,
                    y: Optional[np.ndarray] = None,
                    leaves=None) -> "EnsembleContext":
        """Route ``X`` (default: the forest's training set) on the forest's
        device, unless its ``leaves`` are given, and accumulate the masses
        there with ``torch.bincount``.  Both masses are sums of integers, so
        the order of the device's atomic adds does not change them."""
        X = forest.X_ if X is None else X
        y = forest.y_ if y is None else y
        ta = forest.tree_arrays()
        L = ta.total_leaves
        if L >= 2 ** 31:
            raise ValueError(f"{L} leaves exceed int32 global leaf ids")
        dev = forest.route_tables_.device
        if leaves is None:
            leaves = forest.apply(X)                     # (N, T) on device
        leaves = torch.as_tensor(leaves, device=dev).to(torch.int32)
        n, T = leaves.shape
        off = torch.as_tensor(ta.leaf_offset.astype(np.int32), device=dev)
        gl = leaves + off[None, :]
        leaf_mass = torch.bincount(gl.reshape(-1), minlength=L) \
            .to(torch.float64)
        inbag = forest.inbag_
        if inbag is not None:
            inbag_d = torch.as_tensor(inbag, dtype=torch.int32, device=dev)
            leaf_mass_inbag = torch.bincount(
                gl.t().reshape(-1), weights=inbag_d.reshape(-1).double(),
                minlength=L)
            oob = inbag_d == 0
            oob_count = oob.sum(0).to(torch.int64)
        else:
            inbag_d = oob = oob_count = None
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
