"""Proximity applications end to end on the card (twin of the reference's
``examples/proximity_applications.py``): the Breiman–Cutler workload suite
on the factored kernel — outliers, prototypes, label propagation,
embeddings and imputation — without ever materializing dense P.

    PYTHONPATH=src python -m repro_torch.proximity_applications
        [--device cpu] [--n 4000] [--d 12] [--trees 30]
"""
from __future__ import annotations

import argparse

import numpy as np

from .applications.prototypes import NearestPrototypeClassifier
from .core.api import ForestKernel
from .data.synthetic import gaussian_classes, train_test_split


def main(n: int = 4000, d: int = 12, n_trees: int = 30,
         device: str = "cuda") -> dict:
    X, y = gaussian_classes(n, d=d, n_classes=4, sep=3.0, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.1, seed=0)
    fk = ForestKernel(kernel_method="gap", n_trees=n_trees, seed=0,
                      device=device)
    fk.fit(Xtr, ytr)
    print(f"fitted: {len(Xtr)} samples, {n_trees} trees, device "
          f"{fk.engine.device}")

    # 1. within-class outlier scores (n_c / Σ P², median/MAD normalized)
    scores = fk.outlier_scores().cpu().numpy()
    top = np.argsort(-scores)[:5]
    print(f"outliers: top-5 scores {np.round(scores[top], 2)} at rows {top}")

    # 2. tree-space prototypes + nearest-prototype classification
    protos, coverage = fk.prototypes(n_prototypes=3, k=50)
    print("prototypes per class:",
          {c: list(map(int, p)) for c, p in protos.items()})
    clf = NearestPrototypeClassifier(n_prototypes=3, k=50).fit(fk.engine, ytr)
    proto_acc = float((clf.predict(Xte).cpu().numpy() == yte).mean())
    print(f"nearest-prototype test accuracy: {proto_acc:.3f} "
          f"(coverage {dict((c, round(v, 2)) for c, v in coverage.items())})")

    # 3. semi-supervised label propagation from 5% labels
    rng = np.random.default_rng(0)
    labeled = rng.random(len(ytr)) < 0.05
    lab, _ = fk.propagate_labels(labeled)
    lab = lab.cpu().numpy()
    prop_acc = float((lab[~labeled] == ytr[~labeled]).mean())
    print(f"label propagation: {labeled.sum()} labels -> "
          f"{prop_acc:.3f} accuracy on the {np.sum(~labeled)} unlabeled rows")

    # 4. proximity-MDS embedding with Nyström OOS transform
    emb = fk.embed(n_components=2)
    Zte = emb.transform(Xte)
    print(f"embedding: train {tuple(emb.embedding_.shape)}, OOS "
          f"{tuple(Zte.shape)}, top eigenvalues {np.round(emb.eigvals_, 2)}")

    # 5. iterative proximity-weighted imputation of 10% MCAR entries
    Xm = Xtr.copy()
    mask = rng.random(Xm.shape) < 0.1
    Xm[mask] = np.nan
    imp = ForestKernel(kernel_method="gap", n_trees=n_trees, seed=0,
                       device=device).impute(Xm, ytr, n_iter=3)
    err = float(np.abs(imp.X_imputed_[mask] - Xtr[mask]).mean())
    med = np.nanmedian(Xm, axis=0)
    err_med = float(np.abs(np.broadcast_to(med, Xm.shape)[mask]
                           - Xtr[mask]).mean())
    print(f"imputation: mean abs error {err:.3f} vs median-fill {err_med:.3f}"
          f" (deltas per iter: {[round(h, 4) for h in imp.history_]})")
    if not err < err_med:
        raise RuntimeError("imputation must beat the rough fill")
    print("OK")
    return {"prototype_acc": proto_acc, "propagation_acc": prop_acc,
            "impute_err": err, "median_err": err_med}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--d", type=int, default=12)
    ap.add_argument("--trees", type=int, default=30)
    a = ap.parse_args()
    main(a.n, a.d, a.trees, a.device)
