"""End-to-end paper pipeline on the card (twin of the reference's
``examples/paper_pipeline.py``):

  forest -> sparse SWLC factorization -> scaling report
         -> leaf-PCA embedding -> proximity-weighted prediction

    PYTHONPATH=src python -m repro_torch.paper_pipeline [--device cpu]
        [--n 50000] [--trees 30]

The forest grows, routes and factorizes on the device; the exact sparse
kernel and leaf-PCA work on the host CSR factors, as in the reference.
"""
from __future__ import annotations

import argparse
import time

from .core.api import ForestKernel
from .core.leafmap import sparse_bytes
from .data.synthetic import gaussian_classes, train_test_split


def main(n: int = 50000, n_trees: int = 30, device: str = "cuda") -> dict:
    X, y = gaussian_classes(n, d=25, n_classes=7, seed=1)
    Xtr, ytr, Xte, yte = train_test_split(X, y, test_frac=0.05)

    t0 = time.time()
    fk = ForestKernel(kernel_method="gap", n_trees=n_trees, seed=0,
                      device=device)
    fk.fit_forest(Xtr, ytr)
    print(f"[1] forest: {n_trees} trees on N={len(Xtr):,} in "
          f"{time.time() - t0:.1f}s (device {device})")

    t0 = time.time()
    fk.build_kernel_cache()
    print(f"[2] kernel cache (θ + sparse factors Q,W): "
          f"{time.time() - t0:.2f}s, {fk.memory_bytes()['total'] / 1e6:.1f}"
          f" MB")

    t0 = time.time()
    P = fk.kernel(set_diagonal=False)
    lam = P.nnz / P.shape[0]
    print(f"[3] exact sparse kernel P=QWᵀ: {time.time() - t0:.2f}s, "
          f"nnz={P.nnz:,} (λ̄={lam:.0f} collisions/sample vs "
          f"N={P.shape[0]:,} dense cols), {sparse_bytes(P) / 1e6:.1f} MB "
          f"[dense would be {8 * P.shape[0] ** 2 / 1e9:.1f} GB]")

    t0 = time.time()
    acc = float((fk.predict(Xte).cpu().numpy() == yte).mean())
    forest_acc = float((fk.forest.predict(Xte).cpu().numpy() == yte).mean())
    print(f"[4] proximity-weighted OOS prediction: acc={acc:.4f} "
          f"({time.time() - t0:.2f}s)  [forest: {forest_acc:.4f}]")

    t0 = time.time()
    pca = fk.leaf_pca(n_components=20)
    Z = pca.transform(fk.Q_)
    print(f"[5] leaf-PCA on sparse Q (ARPACK, P never formed): {Z.shape} "
          f"in {time.time() - t0:.1f}s")
    return {"acc": acc, "forest_acc": forest_acc, "nnz": P.nnz,
            "lambda": lam, "embedding": Z.shape}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--trees", type=int, default=30)
    a = ap.parse_args()
    main(a.n, a.trees, a.device)
