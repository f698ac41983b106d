#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. builds every CUDA kernel of the port from ``src/repro_torch/kernels/*/
   csrc`` (one ``nvcc`` per source, all started together);
2. drives the main path through ``repro_torch.core.api.ForestKernel`` at the
   repository's acceptance size — RF, ``kernel_method="gap"``, 100 trees,
   50,000 training rows x 20 features, 7 classes, a 5,000-row OOS batch —
   and holds every op against the port's host scipy CSR products (atol
   1e-8);
3. holds each kernel against its plain PyTorch version on the card: the
   routing kernel bit-exact on the acceptance forest and on a deep forest
   whose node tables exceed a block's shared memory, the proximity-block
   kernel within 1e-10 at the main path's shape;
4. prints one ``{"kernels": [...]}`` line (launches on the main path,
   errors, kernel / plain / library times and the least time the card
   could take), the card's name and power limit, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once when torch finds no CUDA device or when the
port's sources are not beside it.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_TRAIN, N_OOS, D, N_CLASSES, N_TREES = 50_000, 5_000, 20, 7, 100
TOPK_ROWS, BLOCK_ROWS, K = 4096, 512, 10
CHECK_ROWS = 1024        # train rows whose all-pairs results host scipy checks
ATOL_OPS = 1e-8          # the reference's cross-backend engine contract
ATOL_BLOCK = 1e-10       # K2 against its plain version (sums in other order)

# Peak rates of one H100 SXM at the full 700 W (NVIDIA data sheet and Hopper
# white paper): HBM3 3.35 TB/s; FP64 outside the tensor cores 33.5 TFLOP/s
# (132 SMs x 64 FP64 lanes x 2 x 1.98 GHz).
HBM_BYTES_S = 3.35e12
FP64_FMA_S = 33.5e12 / 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_err(a, b):
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    return float(np.abs(a - b).max()) if a.size else 0.0


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    from CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.factorization import kernel_block, topk_neighbors
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    from repro_torch.forest.ensemble import RandomForest
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_prox.ops import block_prox
    from repro_torch.kernels.block_prox.ref import block_prox_ref
    from repro_torch.kernels.leaf_route.ops import route
    from repro_torch.kernels.leaf_route.ref import route_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 0: build every kernel, in parallel ----
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- phase 1: the main path, counted ----
    X, y = gaussian_classes(N_TRAIN + N_OOS, d=D, n_classes=N_CLASSES, seed=0)
    Xtr, ytr, Xte, yte = train_test_split(
        X, y, test_frac=N_OOS / (N_TRAIN + N_OOS), seed=0)
    check(len(Xtr) == N_TRAIN and len(Xte) == N_OOS, "split sizes")
    Xq = Xte[:TOPK_ROWS]
    rows = np.arange(BLOCK_ROWS)

    wall = {}

    def step(name, fn):
        """Run one main-path call to completion on the card, timed on the
        host clock."""
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t
        return out

    per_step = {}

    def counted(name, fn):
        """``step``, also noting the kernel launches the call made."""
        before = (route.launches, block_prox.launches)
        out = step(name, fn)
        per_step[name] = (route.launches - before[0],
                          block_prox.launches - before[1])
        return out

    route.launches = 0
    block_prox.launches = 0
    fk = ForestKernel(model_type="rf", kernel_method="gap", n_trees=N_TREES,
                      n_bins=64, seed=0, device="cuda")
    counted("fit_forest", lambda: fk.fit_forest(Xtr, ytr))
    counted("build_kernel_cache", fk.build_kernel_cache)
    pred_tr = counted("predict_train", fk.predict)
    pred_te = counted("predict_oos", lambda: fk.predict(Xte))
    top_idx, top_val = counted("topk_oos", lambda: fk.topk(k=K, X=Xq))
    blk = counted("kernel_block", lambda: fk.kernel_block(rows))
    srs = counted("squared_row_sums_oos", lambda: fk.engine.squared_row_sums(
        ytr, n_classes=N_CLASSES, X=Xte))
    rsum = counted("row_sums", fk.row_sums)
    # all-pairs jobs over the training set: 50k x 50k through K2 row blocks
    tr_idx, tr_val = counted("topk_train", lambda: fk.topk(k=K))
    srs_tr = counted("squared_row_sums_train",
                     lambda: fk.engine.squared_row_sums(ytr, N_CLASSES))
    launches = {"leaf_route": route.launches, "block_prox": block_prox.launches}
    print("main path (s, K1/K2 launches): " + ", ".join(
        f"{k} {v:.3f} ({per_step[k][0]}/{per_step[k][1]})"
        for k, v in wall.items()) + f"; launches {launches}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    # ---- phase 2: every op against the host scipy CSR products ----
    eng = fk.engine
    Q, W = eng.Q, eng.W
    Y = np.zeros((N_TRAIN, N_CLASSES))
    Y[np.arange(N_TRAIN), ytr] = 1.0
    S = np.asarray(W.T @ Y)
    diag = np.asarray(Q.multiply(W).sum(axis=1)).ravel()
    host_tr = np.asarray(Q @ S) - diag[:, None] * Y
    Qte = fk.query_map(Xte)
    host_te = np.asarray(Qte @ S)
    errs = {
        "predict_train_scores": max_err(eng.predict(ytr, N_CLASSES), host_tr),
        "predict_oos_scores": max_err(eng.predict(ytr, N_CLASSES, X=Xte),
                                      host_te),
        "kernel_block": max_err(blk, kernel_block(Q, W, rows)),
        "row_sums": max_err(rsum, np.asarray(Q @ (W.T @ np.ones(N_TRAIN)))),
    }
    # index_add_ sums with atomics, so exact class ties may break either
    # way: a prediction is right when its class scores within atol of the
    # row's best host score
    for name, pred, host in (("train", pred_tr, host_tr),
                             ("oos", pred_te, host_te)):
        chosen = host[np.arange(len(host)), pred.cpu().numpy()]
        check(np.all(chosen >= host.max(axis=1) - ATOL_OPS),
              f"{name} predict picks a top-scoring class")
    WT = W.T.tocsc()

    def host_srs(Qr):
        B = (Qr @ WT).tocsr()
        nr = B.shape[0]
        r_of = np.repeat(np.arange(nr), np.diff(B.indptr))
        return np.bincount(r_of * N_CLASSES + ytr[B.indices],
                           weights=B.data ** 2,
                           minlength=nr * N_CLASSES).reshape(nr, N_CLASSES)

    def topk_errs(name, Qr, idx, val):
        """Values match the host's; each returned index carries its
        value."""
        _, hv = topk_neighbors(Qr, W, K)
        errs[f"{name}_values"] = max_err(val, hv)
        Pr = (Qr @ WT).tocsr()
        at = np.asarray(Pr[np.repeat(np.arange(Qr.shape[0]), K),
                           idx.cpu().numpy().ravel()]).reshape(-1, K)
        errs[f"{name}_index_values"] = max_err(val, at)

    errs["squared_row_sums_oos"] = max_err(srs, host_srs(Qte))
    topk_errs("topk_oos", fk.query_map(Xq), top_idx, top_val)
    # the training set's all-pairs jobs, checked on a random sample of rows
    chk = np.sort(np.random.default_rng(2).choice(N_TRAIN, CHECK_ROWS,
                                                  replace=False))
    chk_dev = torch.as_tensor(chk, device=dev)
    errs["squared_row_sums_train"] = max_err(srs_tr[chk_dev], host_srs(Q[chk]))
    topk_errs("topk_train", Q[chk], tr_idx[chk_dev], tr_val[chk_dev])
    for name, e in errs.items():
        print(f"  {name}: max abs err {e:.3e}")
        check(e <= ATOL_OPS, f"{name} error {e} > {ATOL_OPS}")
    acc = float((pred_te.cpu().numpy() == yte).mean())
    print(f"OOS accuracy (proximity-weighted, gap): {acc:.4f}", flush=True)
    check(acc > 1.0 / N_CLASSES, "OOS accuracy above chance")

    # ---- phase 3: kernels against their plain versions ----
    forest = fk.forest
    tables = forest.route_tables_
    X_dev = torch.as_tensor(Xtr, dtype=torch.float64, device=dev)
    args = (tables.feature, tables.threshold, tables.lr, tables.leaf_id,
            tables.n_trees, tables.max_nodes)
    lv_k = route(X_dev, tables)
    lv_p = route_ref(X_dev, *args)
    k1_err = max_err(lv_k, lv_p)
    check(k1_err == 0.0, "leaf_route != plain version (acceptance)")
    k1_ms = cuda_ms(torch, lambda: route(X_dev, tables), 20)
    k1_plain_ms = cuda_ms(torch, lambda: route_ref(X_dev, *args), 3)

    rng = np.random.default_rng(1)
    Xd = rng.normal(size=(20_000, D))
    yd = rng.integers(0, N_CLASSES, size=20_000)
    deep = RandomForest(n_trees=10, seed=1, device="cuda").fit(Xd, yd)
    dt = deep.route_tables_
    node_bytes = 20 * min(t.n_nodes for t in deep.trees_)
    check(node_bytes > 232_448,
          f"deep forest's trees ({node_bytes} B) must exceed shared memory")
    Xd_dev = torch.as_tensor(Xd, dtype=torch.float64, device=dev)
    k1_err_deep = max_err(route(Xd_dev, dt),
                          route_ref(Xd_dev, dt.feature, dt.threshold, dt.lr,
                                    dt.leaf_id, dt.n_trees, dt.max_nodes))
    check(k1_err_deep == 0.0, "leaf_route != plain version (deep forest)")
    print(f"K1 bit-exact: acceptance M={tables.max_nodes}, deep "
          f"M={dt.max_nodes}", flush=True)

    gl_q, q = eng.gl[:BLOCK_ROWS], eng.q[:BLOCK_ROWS]
    k2_out = block_prox(gl_q, q, eng.gl, eng.w)
    k2_plain = block_prox_ref(gl_q, q, eng.gl, eng.w)
    k2_err = max_err(k2_out, k2_plain)
    check(k2_err <= ATOL_BLOCK, f"block_prox error {k2_err} > {ATOL_BLOCK}")
    k2_ms = cuda_ms(torch, lambda: block_prox(gl_q, q, eng.gl, eng.w), 10)
    k2_plain_ms = cuda_ms(
        torch, lambda: block_prox_ref(gl_q, q, eng.gl, eng.w), 2)
    # yardstick: cuSPARSE SpMM of W (CSR) with the dense rows of Q gives
    # P[rows, :]ᵀ in one PyTorch call
    W_dev = torch.sparse_csr_tensor(
        torch.as_tensor(W.indptr, dtype=torch.int64),
        torch.as_tensor(W.indices, dtype=torch.int64),
        torch.as_tensor(W.data), size=W.shape, device=dev)
    QrT = torch.as_tensor(Q[rows].toarray().T.copy(), device=dev)
    lib_err = max_err(torch.sparse.mm(W_dev, QrT).t(), k2_out)
    k2_lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(W_dev, QrT), 10)

    # ---- bounds, from this run's shapes and data ----
    # K1 reads X once, each real node once (feature, threshold, two
    # children, leaf id: 24 bytes; not the padding up to M) and writes the
    # (n, T) int32 leaves
    n, T, M = N_TRAIN, tables.n_trees, tables.max_nodes
    n_nodes = sum(t.n_nodes for t in forest.trees_)
    k1_bytes = n * D * 8 + n_nodes * (4 + 8 + 8 + 4) + n * T * 4
    k1_bound = k1_bytes / HBM_BYTES_S * 1e3
    nq, nw = BLOCK_ROWS, eng.n_ref
    cnt_w = torch.bincount(eng.gl.reshape(-1).long(),
                           minlength=eng.total_leaves)
    collisions = float(cnt_w[gl_q.reshape(-1).long()].sum())
    # K2's work is one FMA per colliding (i, j, t) — what these inputs
    # need, not the Nq·Nw·T compares of the dense algorithm — and its
    # bytes are gl/q of both sides (12 bytes a (row, tree)) and the output
    k2_bytes = (nq + nw) * T * 12 + nq * nw * 8
    k2_terms = {"bytes": k2_bytes / HBM_BYTES_S,
                "operations": collisions / FP64_FMA_S}
    k2_by = max(k2_terms, key=k2_terms.get)
    kernels = [
        {"name": "leaf_route", "route": "cuda",
         "source": "src/repro_torch/kernels/leaf_route/csrc/leaf_route.cu",
         "replaces": "src/repro/kernels/leaf_route/leaf_route.py:48",
         "launches": launches["leaf_route"],
         "max_abs_err": max(k1_err, k1_err_deep),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "block_prox", "route": "cuda",
         "source": "src/repro_torch/kernels/block_prox/csrc/block_prox.cu",
         "replaces": "src/repro/kernels/block_prox/block_prox.py:56",
         "launches": launches["block_prox"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_terms[k2_by] * 1e3, "bound_by": k2_by,
         "library_ms": k2_lib_ms},
    ]
    print(f"K1 route {n}x{T} (M={M}, {n_nodes} nodes): {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms")
    print(f"K2 block {nq}x{nw}x{T}: {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} "
          f"ms, cuSPARSE SpMM {k2_lib_ms:.3f} ms (err {lib_err:.2e}), bound "
          f"{k2_terms[k2_by] * 1e3:.4f} ms by {k2_by} "
          f"(collisions {collisions:.3e})")
    print(f"wall: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
