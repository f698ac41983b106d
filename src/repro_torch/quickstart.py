"""Quickstart: the paper's ForestKernel API on the card (twin of the
reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from .core.api import ForestKernel
from .data.synthetic import gaussian_classes, train_test_split


def main(n: int = 8000, n_trees: int = 50, device: str = "cuda") -> dict:
    # Covertype-like synthetic task
    X, y = gaussian_classes(n, d=20, n_classes=7, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.1)

    # 1. fit a forest + build the sparse kernel cache (P = Q Wᵀ, never dense)
    fk = ForestKernel(model_type="rf", kernel_method="gap", n_trees=n_trees,
                      seed=0, device=device)
    fk.fit(Xtr, ytr)

    # 2. the full proximity matrix is sparse and exact
    P = fk.kernel()
    print(f"P: {P.shape}, nnz={P.nnz} "
          f"({100 * P.nnz / P.shape[0] ** 2:.2f}% dense equivalent)")

    # 3. proximity blocks / top-k neighbours without materializing P
    idx, val = fk.topk(k=5)
    print("nearest neighbours of sample 0:", idx[0].tolist(),
          np.round(val[0].cpu().numpy(), 4))

    # 4. proximity-weighted prediction (GAP ≈ forest OOB predictions)
    train_acc = float((fk.predict().cpu().numpy() == ytr).mean())
    test_acc = float((fk.predict(Xte).cpu().numpy() == yte).mean())
    print(f"proximity-weighted accuracy: train={train_acc:.3f} "
          f"test={test_acc:.3f}")

    # 5. out-of-sample queries are first-class (Remark 3.9)
    Q_new = fk.query_map(Xte[:3])
    print("OOS query map:", Q_new.shape, "nnz/row =", Q_new.nnz / 3)

    # 6. Leaf-PCA: spectral embedding directly on the sparse leaf map (§4.3)
    pca = fk.leaf_pca(n_components=10)
    Z = pca.transform(fk.Q_)
    print("leaf-PCA embedding:", Z.shape, "top singular values:",
          np.round(pca.singular_values_[:3], 2))
    return {"train_acc": train_acc, "test_acc": test_acc, "nnz": P.nnz}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--trees", type=int, default=50)
    a = ap.parse_args()
    main(a.n, a.trees, a.device)
