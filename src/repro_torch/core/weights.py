"""SWLC weight assignments (q, w) — paper Appendix B — as tensor ops.

Each assignment maps routed leaf codes + the ensemble context θ to per
(sample, tree) scalar weights on the context's device.  ``query_weights``
builds q (query role), ``reference_weights`` builds w (reference role);
symmetric kernels use q == w.  Every rule is the reference's float64
expression in the same operation order, so the factors are bit-identical
to the reference's.

All functions return (N, T) float64 tensors; zeros are *structural* (they
are dropped from the sparse factors).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Type

import numpy as np
import torch

from .context import EnsembleContext

__all__ = ["WeightAssignment", "Original", "KeRF", "SeparableOOB", "RFGAP",
           "InstanceHardness", "Boosted", "get_assignment", "ASSIGNMENTS"]


class WeightAssignment:
    """Base class.  OOS queries (no bootstrap info) use ``oos_query``."""

    name: str = "base"
    symmetric: bool = True
    diagonal: Optional[float] = None   # None -> leave as computed

    def __init__(self, ctx: EnsembleContext):
        self.ctx = ctx

    def query_weights(self, leaves: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reference_weights(self, leaves: torch.Tensor) -> torch.Tensor:
        return self.query_weights(leaves)

    def oos_query_weights(self, leaves: torch.Tensor) -> torch.Tensor:
        """Weights for unseen query samples (no bootstrap info)."""
        return self.query_weights(leaves)

    def _mass(self, leaves: torch.Tensor, inbag: bool = False) -> torch.Tensor:
        gl = self.ctx.global_leaves(leaves)
        m = self.ctx.leaf_mass_inbag if inbag else self.ctx.leaf_mass
        return m[gl]

    def _full(self, leaves: torch.Tensor, value: float) -> torch.Tensor:
        return torch.full(tuple(leaves.shape), value, dtype=torch.float64,
                          device=leaves.device)

    def _train_only(self, leaves: torch.Tensor) -> EnsembleContext:
        ctx = self.ctx
        if ctx.oob is None:
            raise ValueError(f"kernel {self.name!r} needs a bootstrapped forest")
        if leaves.shape[0] != ctx.n_train:
            raise ValueError("training weights requested for non-training batch")
        return ctx


class Original(WeightAssignment):
    """Breiman: q = w = 1/sqrt(T)  (B.1)."""
    name = "original"

    def query_weights(self, leaves):
        return self._full(leaves, 1.0 / math.sqrt(leaves.shape[1]))


def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 1/sqrt(x), numpy's ``1.0 / np.sqrt(x)``.

    torch's CPU ``sqrt`` is not correctly rounded, while its CPU ``rsqrt``
    divides by an IEEE square root; on CUDA it is the other way round.
    """
    if x.device.type == "cpu":
        return torch.rsqrt(x)
    return torch.ones_like(x) / torch.sqrt(x)


class KeRF(WeightAssignment):
    """KeRF: q = w = 1/sqrt(T * M(leaf))  (B.2)."""
    name = "kerf"

    def query_weights(self, leaves):
        T = leaves.shape[1]
        per_leaf = _inv_sqrt(T * self.ctx.leaf_mass.clamp_min(1.0))
        return per_leaf[self.ctx.global_leaves(leaves)]


class SeparableOOB(WeightAssignment):
    """P̃_oob: q = w = o_t(x) * sqrt(T) / S(x)  (Appendix G).

    OOS queries are "always OOB": q_oos = 1/sqrt(T).  Diagonal is set to 1
    by convention (Remark G.2).
    """
    name = "oob"
    diagonal = 1.0

    def query_weights(self, leaves):
        ctx = self._train_only(leaves)
        T = leaves.shape[1]
        S = ctx.oob_count.to(torch.float64).clamp_min(1.0)
        # a full tensor, not ``math.sqrt(T) / S``: torch evaluates
        # scalar / tensor as scalar * reciprocal, which rounds differently
        return ctx.oob.t().to(torch.float64) * \
            (torch.full_like(S, math.sqrt(T)) / S)[:, None]

    def oos_query_weights(self, leaves):
        return self._full(leaves, 1.0 / math.sqrt(leaves.shape[1]))


class RFGAP(WeightAssignment):
    """RF-GAP: q_t(x) = o_t(x)/S(x),  w_t(x) = c_t(x)/M_inbag(leaf_t(x))  (B.4).

    Asymmetric; OOS queries: every tree counts, q_oos = 1/T.  The natural
    diagonal is 0.
    """
    name = "gap"
    symmetric = False

    def query_weights(self, leaves):
        ctx = self._train_only(leaves)
        S = ctx.oob_count.to(torch.float64).clamp_min(1.0)
        return ctx.oob.t().to(torch.float64) / S[:, None]

    def reference_weights(self, leaves):
        ctx = self.ctx
        M = self._mass(leaves, inbag=True).clamp_min(1.0)
        return ctx.inbag.t().to(torch.float64) / M

    def oos_query_weights(self, leaves):
        return self._full(leaves, 1.0 / leaves.shape[1])


class InstanceHardness(WeightAssignment):
    """RFProxIH: q = 1/T, w_t(x) = 1 - kDN_t(x)  (B.5).

    kDN_t is the share of x's ``k`` nearest neighbours, among ``max_ref``
    reference rows drawn once on the host (``default_rng(0)``, as the
    reference draws them), that disagree with x's label, in the subspace of
    the features tree t splits on.  The kNN runs on the context's device in
    float64, a tree at a time and in row chunks of at most ``_CHUNK_BYTES``
    of distances; the reference's choice between the broadcast form and
    the expansion form ``a² − 2ab + b²`` of the squared distances is kept,
    so that small inputs sum as the reference does.
    """
    name = "ih"
    symmetric = False
    k = 5
    max_ref = 2048
    _BROADCAST_MAX = 5e7      # n·n_ref·d_t below it: the broadcast form
    _CHUNK_BYTES = 1 << 30    # distances (or broadcast terms) a row chunk

    def query_weights(self, leaves):
        return self._full(leaves, 1.0 / leaves.shape[1])

    def reference_weights(self, leaves):
        ctx = self.ctx
        if ctx.X is None or ctx.y is None or ctx.tree_features is None:
            raise ValueError("'ih' weights need the context's X, y and "
                             "tree_features")
        dev = leaves.device
        n, T = leaves.shape
        ref = np.random.default_rng(0).choice(
            ctx.n_train, min(self.max_ref, ctx.n_train), replace=False)
        X = torch.as_tensor(np.asarray(ctx.X, dtype=np.float64), device=dev)
        y = torch.as_tensor(np.asarray(ctx.y), device=dev)
        ref_d = torch.as_tensor(ref, device=dev)
        y_ref = y[ref_d]
        out = torch.empty((n, T), dtype=torch.float64, device=dev)
        for t in range(T):
            feats = np.asarray(ctx.tree_features[t], dtype=np.int64)
            if len(feats) == 0:
                out[:, t] = 1.0
                continue
            f = torch.as_tensor(feats, device=dev)
            A = X[:, f]
            B = X[ref_d][:, f]
            broadcast = n * len(ref) * len(feats) < self._BROADCAST_MAX
            per_row = 8 * len(ref) * (len(feats) if broadcast else 1)
            step = max(1, self._CHUNK_BYTES // per_row)
            b2 = None if broadcast else (B * B).sum(1)
            for i0 in range(0, n, step):
                a = A[i0:i0 + step]
                if broadcast:
                    d2 = ((a[:, None, :] - B[None, :, :]) ** 2).sum(-1)
                else:
                    d2 = (a * a).sum(1)[:, None] - (2 * a) @ B.T + b2[None, :]
                nn = torch.topk(d2, self.k, dim=1, largest=False).indices
                bad = (y_ref[nn] != y[i0:i0 + step, None]).sum(1) \
                    .to(torch.float64)
                # numpy's mean divides; on CUDA, torch's mean and a division
                # by a Python scalar multiply by the reciprocal instead
                out[i0:i0 + step, t] = 1.0 - bad / torch.full_like(bad,
                                                                   self.k)
        return out


class Boosted(WeightAssignment):
    """Tree-weighted (GBT): q = w = sqrt(w_t / Σ w_s)  (B.6).

    The (T,) per-tree factor is the reference's numpy expression on the
    host (its pairwise sum and correctly rounded sqrt), broadcast on the
    device.
    """
    name = "boosted"

    def query_weights(self, leaves):
        tw = self.ctx.tree_weights.cpu().numpy()
        tw = tw / max(tw.sum(), 1e-300)
        per_tree = torch.as_tensor(np.sqrt(tw), device=leaves.device)
        return per_tree[None, :].expand(tuple(leaves.shape)).contiguous()


ASSIGNMENTS: Dict[str, Type[WeightAssignment]] = {
    c.name: c for c in [Original, KeRF, SeparableOOB, RFGAP,
                        InstanceHardness, Boosted]
}


def get_assignment(name: str, ctx: EnsembleContext) -> WeightAssignment:
    if name not in ASSIGNMENTS:
        raise KeyError(f"unknown kernel_method {name!r}; have {sorted(ASSIGNMENTS)}")
    return ASSIGNMENTS[name](ctx)
