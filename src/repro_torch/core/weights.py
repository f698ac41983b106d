"""SWLC weight assignments (q, w) — paper Appendix B — as tensor ops.

Each assignment maps routed leaf codes + the ensemble context θ to per
(sample, tree) scalar weights on the context's device.  ``query_weights``
builds q (query role), ``reference_weights`` builds w (reference role);
symmetric kernels use q == w.  Every rule is the reference's float64
expression in the same operation order, so the factors are bit-identical
to the reference's.

All functions return (N, T) float64 tensors; zeros are *structural* (they
are dropped from the sparse factors).  ``ih`` and ``boosted`` come with the
trainer slice, which ports gradient boosting.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Type

import torch

from .context import EnsembleContext

__all__ = ["WeightAssignment", "Original", "KeRF", "SeparableOOB", "RFGAP",
           "get_assignment", "ASSIGNMENTS"]


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


ASSIGNMENTS: Dict[str, Type[WeightAssignment]] = {
    c.name: c for c in [Original, KeRF, SeparableOOB, RFGAP]
}
_LATER = {"ih": "instance-hardness", "boosted": "boosted"}


def get_assignment(name: str, ctx: EnsembleContext) -> WeightAssignment:
    if name in _LATER:
        raise NotImplementedError(
            f"kernel_method {name!r} ({_LATER[name]} weights) is not ported "
            "yet; it comes with gradient boosting in the trainer slice")
    if name not in ASSIGNMENTS:
        raise KeyError(f"unknown kernel_method {name!r}; have {sorted(ASSIGNMENTS)}")
    return ASSIGNMENTS[name](ctx)
