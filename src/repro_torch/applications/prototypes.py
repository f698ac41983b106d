"""Tree-space prototypes (Tan, Hooker & Wells) on the factored kernel.

Greedy class-coverage selection: a class prototype is the sample whose
proximity neighbourhood (its top-k nearest neighbours in tree space)
contains the most same-class samples not yet covered by an earlier
prototype — greedy set cover over proximity neighbourhoods.  The
neighbourhoods come from ``ProximityEngine.topk`` (block-kernel row blocks
reduced on the device, never a dense P), copied to the host once; the
greedy cover is a host loop, as in the reference.  The nearest-prototype
classifier scores queries against the selected prototype columns only,
via ``kernel_block(cols=...)``.

:func:`compress` turns the selection into a **prototype-restricted engine**:
a ``ProximityEngine`` view whose reference side is the k prototype columns
instead of all N training columns.  Every engine op works unchanged against
the restricted reference set, OOS query routing is shared with the parent
engine (one routed state serves both), and the factor memory shrinks by
~N/k — the low-memory model the serving layer deploys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.engine import ProximityEngine

__all__ = ["select_prototypes", "NearestPrototypeClassifier", "compress",
           "CompressedProximityEngine"]


def select_prototypes(engine, y, n_prototypes: int = 3,
                      k: int = 50) -> Tuple[Dict[int, np.ndarray],
                                            Dict[int, float]]:
    """Greedy proximity-coverage prototypes per class.

    Returns ``(prototypes, coverage)``: for each class, the selected training
    row indices (≤ n_prototypes, in selection order) and the fraction of
    class members covered by the selected neighbourhoods.
    """
    y = np.asarray(y, dtype=np.int64)
    n = len(y)
    idx_d, val_d = engine.topk(k=min(k, n))      # (N, k) on the device
    idx, val = idx_d.cpu().numpy(), val_d.cpu().numpy()
    protos: Dict[int, np.ndarray] = {}
    coverage: Dict[int, float] = {}
    for c in np.unique(y):
        members = np.flatnonzero(y == c)
        neigh = idx[members]                                  # (nc, k)
        valid = (val[members] > 0) & (y[neigh] == c)          # same-class hits
        # Inverted index: training row -> the class members whose valid
        # neighbourhood contains it (CSR over the sorted valid entries), so
        # covering a row decrements exactly the gains it counted toward.
        vmemb, vpos = np.nonzero(valid)
        vrow = neigh[vmemb, vpos]
        order = np.argsort(vrow, kind="stable")
        vrow_s, vmemb_s = vrow[order], vmemb[order]
        row_ptr = np.searchsorted(vrow_s, np.arange(n + 1))
        gain = valid.sum(axis=1).astype(np.int64)
        covered = np.zeros(n, dtype=bool)
        chosen = []
        for _ in range(min(n_prototypes, len(members))):
            best = int(np.argmax(gain))          # first max -> deterministic
            if gain[best] == 0 and chosen:
                break
            chosen.append(int(members[best]))
            new_rows = np.append(neigh[best][valid[best]], members[best])
            new_rows = np.unique(new_rows[~covered[new_rows]])
            covered[new_rows] = True
            if len(new_rows):
                touched = np.concatenate(
                    [vmemb_s[row_ptr[r]:row_ptr[r + 1]] for r in new_rows])
                np.subtract.at(gain, touched, 1)
        protos[int(c)] = np.asarray(chosen, dtype=np.int64)
        coverage[int(c)] = float(covered[members].mean())
    return protos, coverage


def _stack(protos: Dict[int, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, labels) of the prototypes, classes in ascending order."""
    classes = sorted(protos)
    return (np.concatenate([protos[c] for c in classes]),
            np.concatenate([np.full(len(protos[c]), c, dtype=np.int64)
                            for c in classes]))


@dataclasses.dataclass
class NearestPrototypeClassifier:
    """Classify by maximum proximity to any selected prototype."""

    n_prototypes: int = 3
    k: int = 50

    prototype_indices_: Optional[np.ndarray] = None   # (P,) training rows
    prototype_labels_: Optional[np.ndarray] = None    # (P,) classes
    coverage_: Optional[Dict[int, float]] = None
    engine_: object = None

    def fit(self, engine, y) -> "NearestPrototypeClassifier":
        protos, cov = select_prototypes(engine, y,
                                        n_prototypes=self.n_prototypes,
                                        k=self.k)
        self.prototype_indices_, self.prototype_labels_ = _stack(protos)
        self.coverage_ = cov
        self.engine_ = engine
        return self

    def decision_function(self, X=None, block: int = 4096) -> torch.Tensor:
        """(Nq, P) proximities of each query to each prototype on the
        engine's device — dense only over the prototype columns, streamed
        over query rows."""
        eng = self.engine_
        n = eng.query_state(X).n
        out = torch.empty((n, len(self.prototype_indices_)),
                          dtype=torch.float64, device=eng.device)
        for i0 in range(0, n, block):
            i1 = min(i0 + block, n)
            out[i0:i1] = eng.kernel_block(np.arange(i0, i1),
                                          cols=self.prototype_indices_,
                                          X_rows=X)
        return out

    def predict(self, X=None, block: int = 4096) -> torch.Tensor:
        B = self.decision_function(X, block=block)
        labels = torch.as_tensor(self.prototype_labels_, device=B.device)
        return labels[B.argmax(dim=1)]


class CompressedProximityEngine(ProximityEngine):
    """Prototype-restricted view of a fitted ``ProximityEngine``.

    The reference side (columns of P) is sliced down to ``indices`` — every
    inherited op then runs against k prototype columns instead of N
    training columns, with factor memory to match.  The training query
    state is restricted to the same rows (the compressed model's "training
    set" *is* the prototype set); OOS query states are shared with the
    parent engine, so a batch routed once serves both models.

    Never calls ``ProximityEngine.__init__``: the device factors are
    gathered rows of the parent's, the host CSR maps row slices of the
    parent's, and the runtime state (the block kernel's leaf index
    included) is this view's own, apart from the shared OOS cache and its
    lock; the memory budget is the parent's.
    """

    def __init__(self, parent: ProximityEngine, indices,
                 labels: Optional[np.ndarray] = None,
                 coverage: Optional[Dict[int, float]] = None):
        indices = np.asarray(indices, dtype=np.int64)
        self.parent = parent
        self.prototype_indices_ = indices
        self.prototype_labels_ = labels
        self.coverage_ = coverage
        self.ctx = parent.ctx
        self.assignment = parent.assignment
        self.forest = parent.forest
        self.device = parent.device
        self.total_leaves = parent.total_leaves
        rows = torch.as_tensor(indices, device=self.device)
        self.gl = parent.gl[rows].contiguous()
        self.q = parent.q[rows].contiguous()
        self.w = self.q if parent.w is parent.q else \
            parent.w[rows].contiguous()
        self.Q = parent.Q[indices].tocsr()
        self.W = self.Q if parent.W is parent.Q else \
            parent.W[indices].tocsr()
        self.leaf_values = parent.leaf_values
        self.memory_budget_bytes = parent.memory_budget_bytes
        self._factor_scratch_dir = parent._factor_scratch_dir
        # one dict, one lock: the lock travels with the shared cache
        self._init_runtime_state(oos_cache=parent._oos_cache,
                                 oos_cache_size=parent._oos_cache_size,
                                 oos_lock=parent._qs_lock)


def compress(engine: ProximityEngine, y, n_prototypes: int = 10,
             k: int = 50) -> CompressedProximityEngine:
    """Prototype-compress a fitted engine for low-memory serving.

    Selects ``n_prototypes`` greedy coverage prototypes per class (see
    :func:`select_prototypes`) and returns the engine restricted to those
    reference columns.  ``.prototype_labels_`` holds the class of each
    column — the label vector to hand to ``predict`` — and
    ``.memory_bytes()`` reflects the compressed factors.
    """
    protos, coverage = select_prototypes(engine, y,
                                         n_prototypes=n_prototypes, k=k)
    indices, labels = _stack(protos)
    return CompressedProximityEngine(engine, indices, labels=labels,
                                     coverage=coverage)
