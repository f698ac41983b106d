"""Proximity applications — Breiman–Cutler's workload suite on the factored
kernel, on the card.

Every module here consumes only :class:`~repro_torch.core.engine.
ProximityEngine` primitives (matvec / matmat / topk / kernel_block /
row_sums / squared_row_sums), so all five workloads run through the
factored form ``P = Q Wᵀ`` — the dense proximity matrix is never
materialized for more rows than a streaming chunk.  Results that the engine
gives as device tensors stay device tensors; the steps the reference runs
as host loops (the greedy prototype cover, the eigensolvers) run on the
host.

- :mod:`.imputation` — iterative proximity-weighted missing-value imputation
- :mod:`.outliers`   — within-class outlier scores ``n / Σ_j P(i,j)²``
- :mod:`.prototypes` — greedy tree-space prototypes + nearest-prototype
  classification, and the prototype-compressed engine
- :mod:`.propagate`  — semi-supervised label propagation
- :mod:`.embed`      — proximity-MDS embeddings with Nyström OOS transform
"""
from .embed import ProximityEmbedding
from .imputation import ProximityImputer
from .outliers import oos_outlier_scores, outlier_scores, train_outlier_stats
from .propagate import OnlineLabelPropagation, propagate_labels
from .prototypes import (CompressedProximityEngine,
                         NearestPrototypeClassifier, compress,
                         select_prototypes)

__all__ = ["ProximityImputer", "outlier_scores", "oos_outlier_scores",
           "train_outlier_stats", "select_prototypes", "compress",
           "CompressedProximityEngine", "NearestPrototypeClassifier",
           "propagate_labels", "OnlineLabelPropagation",
           "ProximityEmbedding"]
