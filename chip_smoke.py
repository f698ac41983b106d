#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

0. builds every CUDA kernel of the port from ``src/repro_torch/kernels/*/
   csrc`` (one ``nvcc`` per source, all started together);
1. drives the main path through ``repro_torch.core.api.ForestKernel`` at the
   repository's acceptance size — RF, ``kernel_method="gap"``, 100 trees,
   50,000 training rows x 20 features, 7 classes, a 5,000-row OOS batch —
   with the forest grown on the card (histogram kernel K3), and
2. holds every op against the port's host scipy CSR products (atol 1e-8);
3. holds the trainer on the card against the host numpy trainer: the
   acceptance forest, a 10-tree ExtraTrees and a 20-tree integer-target
   regression forest (moments kernel K4) bit for bit, field for field;
4. drives the gradient-boosting path — ``model_type="gbt"``,
   ``kernel_method="boosted"``, 100 stages of depth 6 on ``friedman1``
   50,000 x 20 (+5,000 OOS) — counted, and holds it against a host GBT fit
   (predictions within 0.05 y.std), host scipy (ops at 1e-8) and a second
   card fit (bit-identical trees);
5. times each serving op again after its first call (warm: median of
   ``WARM_REPS`` calls; the OOS batches then hit the engine's query-state
   cache) beside its cold time;
6. holds each kernel against its plain PyTorch version on the card: routing
   bit-exact on the acceptance forest (also with NaN features), on a deep
   random-label forest (leaves of about 3 samples) and on a GBT stage's
   depth-6 tree, timed at 50,000 x 100 trees, 5,000 x 100 and 50,000 x 1
   tree; the proximity block within 1e-10 of its plain version at 512 and
   640 rows x 50,000 x 100 (the train-side row blocks are 640 rows), on
   the deep forest and on the GBT forest, in both forms (leaf collisions
   on the engine's leaf index, dense) with the same bits, each form timed,
   and its share of the warm train-side steps; K2 also at the prefix
   tier's shape (depth-4 leaves: the dense form) and the compressed
   engine's (the OOS batch against its 70 prototype columns), K1 also on
   the depth-4 truncated forest;
   K3 at the acceptance level-1 shape and K4 at the GBT root shape
   bit-exact on integer payloads, both bit for bit equal to the ordered
   oracle (``histogram_ordered``/``moments_ordered``) on integer and
   continuous payloads, K4 on continuous payloads within float32 rounding
   of float64 sums and bit-identical across launches; K3/K4 are timed as
   the trainer calls them (host node bounds) and with device node ids,
   with their device time, the device ops of one call, and the kernel mode
   the wrapper did not pick (same bits) timed beside the one it picked;
7. drives the proximity applications on the acceptance forest, counted
   (K1/K2/K3/K4/top-k/pair-top-k/pair-sums launches a step; cold, and warm
   where a server repeats the call): outlier scores (train side and OOS),
   prototypes (10 a class, k=50), the compressed engine's OOS predict and
   top-k, the nearest-prototype classifier, the depth-4 prefix tier (its
   OOS predict launches no K1) and the truncated forest's routing, label
   propagation (10% labelled, 50 iterations, online, the OOS projection),
   the embedding (Lanczos over device products, Nyström transform), ``ih``
   weights on the same forest, and imputation (10% NaN in 4 columns, 2
   iterations of card refits, twice); then holds each against the port's
   CPU engine on the same leaves (training-set outliers on 1,024 rows and
   the embedding against the host CSR products; ``ih`` on 4 trees;
   imputation against the CPU imputer at 5,000 rows), and compares the two
   card imputations' last refits tree for tree (printed, not checked);
8. drives snapshots and serving on the acceptance kernel, counted: a
   ``save``/``load`` round trip on the card (both digests, and the loaded
   kernel's top-k, block and squared row sums bit for bit, its predict
   labels equal), a ``ProximityServer`` over the full engine (64 slots,
   256 seeded requests of 1-16 OOS rows: 40% predict, 25% top-k, 15%
   outlier, 10% propagate, 10% embed; exactly one K1 launch a tick), the
   tiered ladder from phase 7's prefix, compressed and full engines in
   async mode, and the ladder again under seeded chaos (no request lost);
   then holds every answer against a direct call on the engine of the
   tier that gave it, and times K1 and K2 at a tick's 64 rows;
9. drives the out-of-core row of ``benchmarks/bench_scaling.py
   --out-of-core`` (its steps copied here) at 262,144 of its 1,000,000
   rows (the same trees and widths): 262,144 x 20
   ``gaussian_classes`` (5 classes, sep 0.8) generated into a memmap, RF
   ``gap`` with 15 trees, ``max_depth`` 32, ``min_samples_leaf`` 3, a
   scratch directory and a 512 MiB ``memory_budget_bytes``, counted and
   timed stage by stage (streamed binning and staged-code training
   through K3, the chunked context and the streamed CSR build, train-side
   outlier scores over leaf collisions (``core/collide.py``, the path the
   engine's rule picks at this size), one imputation iteration, a tiered
   serving burst whose prototypes' top-k takes the collision path too),
   each stage's device transient, host traced peak, engine bytes, scratch
   files, collision counters and kernel launches (the collision-pair
   kernels' among them) printed.  Check (a) first refits phase
   1's kernel under a 32 MiB budget (every budgeted branch taken) and
   holds it against phase 1's bit for bit (products within 1e-15); then
   (b) the streamed codes, the CSR factors' digest, 1,024 rows' outlier
   sums and scores against the host, the imputation, every served answer
   against a direct call, each stage's device transient at most 4 GiB and
   the scratch directory removed; (c) one K3 call on staged codes at the
   root level against its plain version and the device-resident call;
   (d) the collision-pair kernels against their plain versions on the
   card, on the products of three of the outlier scores' row blocks (top-k
   bit for bit at k = 10 and 64, class sums within 1e-12), timed;
10. drives the LM serving path (``repro_torch.models``, ``serve``,
   ``train/steps``), held to the bf16 contract of ``tests/_lm_contract.py``:
   (a) every arch at ``reduced()`` widths against the port's CPU path
   (forward, teacher-forced decode, caches); (b) hymba_1p5b at its
   published width and depth, prefill and a 1,280-step decode at B=2
   (past the 1,024 window) held against the forward, timed and profiled;
   (c) its widths at depth 2 against the CPU path; (d) the
   continuous-batching ``ServingEngine`` at full width (4 slots, 8 seeded
   requests), timed, then the same requests through the engine at depth 2
   on the card against the CPU's engine (first-divergence rule); (e) the
   ``proximity_head_lm`` twin, counted: forests fitted on the card LM's
   features on the card and on the host (trees equal, ops within 1e-8),
   then K3, K1 and K2 at the twin's shapes against their plain versions;
11. drives LM training (``train/steps.py``, ``optimizer.py``,
   ``checkpoint.py``, ``launch/train.py``, ``distributed/compression.py``),
   counted (no kernel of the port runs there): (a) every arch at
   ``reduced()`` widths, the card's float32 train step against the CPU's
   (loss, grad_norm and every leaf's gradient within 1e-4), then five bf16
   steps on one batch lowering the loss; (b) hymba_1p5b at its published
   width and depth, B=2 x 1,280, five steps with remat, timed, its peak
   memory and its FLOP bound, one warm step profiled; its widths at depth 2
   against the CPU in bf16; (c) the ``train_lm_e2e`` twin's ``train_loop``
   in a scratch directory, 20 steps uninterrupted and then failing at
   step 15 and resumed (losses within 1e-4 of the uninterrupted run's);
   (d) int8 gradient compression on the card against the CPU, bit for
   bit;
12. drives float32 factors, counted: (a) phase 1's forest as a
   ``ForestKernel(dtype=np.float32)`` (factors the float64 ones rounded
   once), every op of phase 1 cold and warm within 1e-5 of the largest
   value of phase 1's float64 results and of the port's CPU float32
   engine (loaded from the float32 archive; products on every row, blocks
   on 64 OOS and 64 training rows), its engine bytes beside float64's, the
   TF32 flag (off), a float32 snapshot round trip (bits equal) and a
   ``ProximityServer`` on 64 seeded requests (answers equal to direct
   calls); then K2's float32 forms (the same bits, within 1e-5 x max|P|
   of the plain float32 version) timed beside float64's at 512 x 50,000 x
   100 and at a 64-row serving tick, with cuSPARSE SpMM in float32; (b)
   the engine's sharded product with ``default_mesh`` set to grids (1, 1),
   (2, 1), (1, 2) and (2, 2) of cuda:0, at 7 and 64 columns, within
   1e-12 of the segment product (one card's ``default_mesh()`` is None, so
   the engine takes the segment path there), timed;
13. drives the LM's sharding layer (``distributed/logical.py``,
   ``distributed/sharding.py``, ``launch/mesh.py``, DTensor states in
   ``train/``), counted (no kernel of the port runs there): (a)
   hymba_1p5b at its published width and depth, B=2 x 1,280 with remat,
   two ``train_loop`` steps on one device and on a one-rank NCCL mesh
   ``make_local_mesh(1, 1)``, timed with peak memory, the runs' losses,
   grad norms and every leaf of params, m and v held equal bit for bit
   (one rank runs the one device's local kernels); (b) each run's
   parameter checkpoint restored into the other layout, bit for bit;
14. runs the dry-run tools (``repro_torch.launch.dryrun``: a fake world,
   every input a ``meta`` DTensor, per-rank counts; no card, no kernel of
   the port) on the host in the background from before phase 1 under
   ``nice``, one process after another, and reads them after phase 13: (a)
   every arch's ``decode_32k`` at (16, 16) (each arch's head, KV, expert
   and vocab layout at tp = 16), (b) hymba_1p5b ``train_4k`` at (16, 16)
   (the sequence-parallel train step at full width), (c)
   qwen3_moe_235b_a22b ``decode_32k`` at (2, 16, 16) (the pod axis, 128
   experts), (d) phase 11 (b)'s hymba_1p5b step (B=2 x 1,280, remat) on a
   one-rank world: its argument bytes must equal the state and batch
   phase 13 (a) trained on, and its predicted peak is printed beside phase
   11 (b)'s measured one.  Every cell must be ``ok``.

Then it holds the row top-k kernel bit for bit against its plain version
at the engine's 320 x 100,000 block (float64 and float32) and at a 64-row
tick, on dense and sparse rows, and times it beside the plain version,
``torch.topk`` and one read of the block (``row_topk_times``).

Last it prints one ``{"kernels": [...]}`` line (launches on the main, GBT,
applications, serving, out-of-core, LM proximity-head, LM training,
float32 and LM sharding paths; the dry runs launch none; K2's float32
instantiation has its own entry, and the collision-pair kernels theirs),
errors, kernel / plain / library times and the least time the card could
take), the card's name and power limit, and as its last line ``{"ok":
true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once when torch finds no CUDA device or when the
port's sources are not beside it.  About 10-11 minutes on one H100, most
of it the host computations the card's results are held against, the
out-of-core row and the LM decode (host-bound).
"""
import atexit
import dataclasses
import gc
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_TRAIN, N_OOS, D, N_CLASSES, N_TREES = 50_000, 5_000, 20, 7, 100
TOPK_ROWS, BLOCK_ROWS, K = 4096, 512, 10
CHECK_ROWS = 1024        # train rows whose all-pairs results host scipy checks
WARM_REPS = 5            # calls of each serving op timed after its first
ATOL_OPS = 1e-8          # the reference's cross-backend engine contract
ATOL_BLOCK = 1e-10       # K2 against its plain version (sums in other order)
N_GBT, N_GBT_OOS, GBT_STAGES, GBT_DEPTH = 50_000, 5_000, 100, 6
N_ET_TREES, N_REG_TREES = 10, 20
# phase 7: the proximity applications
PREFIX_DEPTH, N_PROTOS, PROTO_K = 4, 10, 50
PROP_LABELED, PROP_ITERS = 0.1, 50
N_EMBED_OOS = 2000
IH_CHECK_TREES, IH_TIE_RTOL = 4, 1e-9
IMPUTE_COLS, IMPUTE_FRAC, IMPUTE_ITERS, N_IMPUTE_HOST = 4, 0.1, 2, 5000
# phase 8: snapshots and serving
N_SERVE_REQ, SERVE_SLOTS = 256, 64
SERVE_MIX = (0.40, 0.25, 0.15, 0.10, 0.10)  # predict/topk/outlier/prop./embed
MARGIN_TIE = 1e-9        # propagation labels may differ below this margin
ATOL_EMBED = 1e-6        # embedding coordinates, after aligning signs
# phase 9: the out-of-core row of benchmarks/bench_scaling.py --out-of-core
OOC_ROWS, OOC_D, OOC_CLASSES, OOC_SEP = 262_144, 20, 5, 0.8
OOC_TREES, OOC_DEPTH, OOC_LEAF = 15, 32, 3
OOC_BUDGET = 512 << 20   # the row's memory_budget_bytes
CHECK_BUDGET = 32 << 20  # check (a): every budgeted branch taken at 50k
OOC_MISSING = 0.002      # imputation: NaN share of the copy
OOC_PREFIX, OOC_PROTOS, OOC_PROTO_K, OOC_SLOTS = 4, 3, 10, 64
OOC_REQS, OOC_KINDS = 16, ("predict", "predict", "topk", "outlier")
OOC_WINDOW = 65_536      # rows of each streamed-code window checked
OOC_TRANSIENT_MAX = 4096 << 20  # the row's own ceiling for a 512 MiB budget
OOC_RTOL = 1e-10         # outlier sums and scores against the host
# the collision-pair sums against their plain version on the card: the same
# squares added in another order (one pair dropped moves an entry ~1e-6)
PAIR_SUMS_RTOL = 1e-12
# the per-path launch counts, in the order of ``wrappers``
LAUNCHES = "K1/K2/K3/K4/top-k/pair-top-k/pair-sums/enumerate"
ATOL_PRODUCT = 1e-15     # budgeted products (index_add_ atomics) vs phase 1
# phase 12: float32 factors; the CPU checks' block rows (tolerance and
# top-k tie rule: tests/_f32_contract.py)
CHECK_ROWS_F32 = 64
# phase 10: the LM serving path (hymba_1p5b at its published width)
LM_ARCH = "hymba_1p5b"
LM_B, LM_S = 2, 1280          # past the 1,024 window; 5 SSD chunks of 256
LM_AGREE = 0.9                # decode vs forward argmax (the reference's)
LM_SEGMENTS = (0, 1008, 1248)  # (c): CPU decode from each, 32 steps
LM_SEG_LEN = 32
LM_SLOTS, LM_MAX_SEQ, LM_REQS, LM_NEW = 4, 256, 8, 16
LM_PROMPT = (16, 48)          # (d): prompt lengths, inclusive
LM_PROFILE_STEPS = 4          # (b): decode steps under the profiler
# phase 11: LM training (reduced archs; hymba_1p5b at its published width)
TRAIN_S_REDUCED = 20          # (a): ragged for 8-wide attention chunks
TRAIN_TOL = 1e-4              # (a): float32, card against the CPU
TRAIN_B, TRAIN_S = 2, 1280    # (b): past the 1,024 window
TRAIN_STEPS, TRAIN_LR, TRAIN_TOP_OPS = 5, 3e-4, 8
# (b) at depth 2 in bf16, card against the CPU: loss and grad_norm
# relative, each leaf's largest gap over its max|g| (the CPU's own bf16
# against float32 gradients differ by up to 0.034 of a leaf's max there)
TRAIN_BF16_LOSS, TRAIN_BF16_NORM, TRAIN_BF16_LEAF = 1e-3, 1e-2, 0.1
# (c): the twin's model and batch, 20 of its 300 steps (a step takes
# ~0.5 s on the card, host-bound, and a checkpoint ~1 GB)
E2E_STEPS, E2E_SAVE, E2E_FAIL = 20, 10, 15
# phase 13: the LM's sharding layer; (a) and (b) at phase 11 (b)'s size
MESH_STEPS = 2                # (a): train_loop steps, each way
MESH_CHUNK = 640              # (a): attention chunk dividing 1,280
# phase 14: how long the dry runs may still take once phase 13 is done
# (they start before phase 1 and take ~3 minutes of one host core)
DRYRUN_WAIT_S = 600
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_id", "value",
               "n_node_samples")

# Peak rates of one H100 SXM at the full 700 W (NVIDIA data sheet and Hopper
# white paper): HBM3 3.35 TB/s; FP64 outside the tensor cores 33.5 TFLOP/s
# (132 SMs x 64 FP64 lanes x 2 x 1.98 GHz).
HBM_BYTES_S = 3.35e12
FP64_FMA_S = 33.5e12 / 2
FP32_S = 67e12           # FP32 outside the tensor cores (NVIDIA data sheet)
BF16_S = 989e12          # bf16 dense on the tensor cores (NVIDIA data sheet)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def max_err(a, b):
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    return float(np.abs(a - b).max()) if a.size else 0.0


def same_trees(a, b, what):
    """Two forests' trees equal field for field."""
    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} trees")
    for t, (s, u) in enumerate(zip(a, b)):
        for f in TREE_FIELDS:
            check(np.array_equal(getattr(s, f), getattr(u, f)),
                  f"{what}: tree {t} field {f} differs")
        check(s.depth == u.depth, f"{what}: tree {t} depth differs")


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after as many warm-up
    calls (so that caches, pinned host buffers included, reach their steady
    state), from CUDA events around the whole run."""
    for _ in range(reps):
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


def device_kernels(torch, fn, want=None):
    """Run ``fn`` under ``torch.profiler``; returns its result, the device
    milliseconds of each kernel (or copy) name over the run and how many
    times each ran.  With ``want``, a window whose trace caught no kernel
    whose name holds it (the profiler can lose a short window's device
    events) is profiled again, up to three times in all, and then raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        times, counts = {}, {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                times[e.key] = times.get(e.key, 0.0) + us / 1e3
                counts[e.key] = counts.get(e.key, 0) + e.count
        if want is None or any(want in k for k in counts):
            return out, times, counts
    raise RuntimeError(f"the profiler caught no {want} kernel in 3 windows "
                       f"(caught: {sorted(counts)[:12]})")


def hist_kernel_ms(times):
    """Device ms of the histogram source's kernels (K3/K4 and the reduce
    pass) in a profile."""
    return sum(v for k, v in times.items() if "histogram" in k)


def hist_call_ms(times, counts, name="histogram"):
    """Device ms a call of the kernels whose names hold ``name`` (K3/K4 and
    the reduce pass by default), from a profile of several calls: each
    kernel's time divided by the number of its launches the profile caught
    (it may miss some at its start)."""
    return sum(times[k] / counts[k] for k in times if name in k)


def ops_per_call(counts):
    """Device work a call issues, from ``device_kernels`` counts over calls
    that each launch the histogram kernel once: ``{short name: count a
    call}``."""
    calls = max(v for k, v in counts.items()
                if k.startswith("void histogram_") and "_kernel<" in k)
    return {k.split("(")[0].replace("void ", ""): v / calls
            for k, v in sorted(counts.items())}


def k2_bound(torch, index, gl_q, q, fma_s):
    """K2's least time for one leaf-form block, in s, by bytes and by
    operations, counting what these inputs need: the query rows' ``gl``
    and ``q`` once; the offsets row and the members (int32 column and
    weight) of each reference leaf that a nonzero query factor falls into,
    once — a leaf no query reaches is never read; the (Nq, Nw) output
    once; one FMA (``fma_s`` a second) per collision whose q and w are
    both nonzero.  Returns ``(terms, collisions counted, index bytes
    counted)``."""
    hit = gl_q.reshape(-1)[q.reshape(-1) != 0].long()
    members = (index.offs[:, -1] - index.offs[:, 0]).long()
    leaves = torch.unique(hit)
    index_bytes = (leaves.numel() * index.offs.shape[1]
                   * index.offs.element_size()
                   + int(members[leaves].sum())
                   * (index.col.element_size() + index.w.element_size()))
    work = float(members[hit].sum())
    nbytes = (gl_q.numel() * (gl_q.element_size() + q.element_size())
              + index_bytes + q.shape[0] * index.n_ref * q.element_size())
    return ({"bytes": nbytes / HBM_BYTES_S, "operations": work / fma_s},
            work, index_bytes)


def same_bits(a, b):
    """Two float32 arrays (tensors or numpy) equal bit for bit."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a, np.float32).view(np.uint32),
        np.ascontiguousarray(b, np.float32).view(np.uint32))


def gen_memmap_dataset(path, n, gaussian_classes):
    """The out-of-core dataset, generated in 64 MiB row chunks straight into
    a float64 memmap (chunk i drawn with seed i), as the reference's
    ``benchmarks/bench_scaling.py::_gen_memmap_dataset`` does, so the full X
    is never held in memory."""
    X = np.memmap(path, dtype=np.float64, mode="w+", shape=(n, OOC_D))
    y = np.empty(n, dtype=np.int64)
    chunk = max(1, (64 << 20) // (8 * OOC_D))
    for ci, i0 in enumerate(range(0, n, chunk)):
        i1 = min(i0 + chunk, n)
        X[i0:i1], y[i0:i1] = gaussian_classes(
            i1 - i0, d=OOC_D, n_classes=OOC_CLASSES, sep=OOC_SEP, seed=ci)
    X.flush()
    return X, y


def budget_check(torch, dev, fk, Xtr, ytr, Xq, Xte, rows):
    """Check (a): phase 1's kernel again with a scratch directory and a
    ``CHECK_BUDGET`` budget, at which every budgeted branch is taken,
    against phase 1's in-memory kernel: trees, digests, blocks, top-k and
    squared row sums bit for bit; products within ``ATOL_PRODUCT``."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.factorization import factor_digest
    eng = fk.engine
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ooc_check_") as scratch:
        bk = ForestKernel(model_type="rf", kernel_method="gap",
                          n_trees=N_TREES, n_bins=64, seed=0,
                          device=str(dev), scratch_dir=scratch,
                          memory_budget_bytes=CHECK_BUDGET).fit(Xtr, ytr)
        be = bk.engine
        chunks = {"context rows": bk._context_row_chunk(),
                  "CSR build rows": be._factor_row_chunk(),
                  "K2 block rows": be._op_row_chunk(4096),
                  f"bucket columns of {N_CLASSES}": be._col_chunk(N_CLASSES),
                  "bucket columns of 20": be._col_chunk(20)}
        # each map spills when its own indices and data exceed the budget
        spilled = {"Q": isinstance(be.Q.data, np.memmap),
                   "W": isinstance(be.W.data, np.memmap)}
        print(f"  check (a) chunks: {chunks}, spilled {spilled}, total "
              f"leaves {be.total_leaves}", flush=True)
        check(chunks["context rows"] < N_TRAIN, "context not chunked")
        check(chunks["CSR build rows"] < N_TRAIN, "CSR build not chunked")
        check(any(spilled.values()), "no CSR factor spilled to scratch")
        check(chunks["K2 block rows"] < eng._op_row_chunk(4096),
              "K2 blocks not cut by the budget")
        check(chunks["bucket columns of 20"] < 20,
              "bucket table not split by columns")
        same_trees(fk.forest.trees_, bk.forest.trees_, "budgeted forest")
        check(bk.ctx.digest() == fk.ctx.digest(), "context digest differs")
        check(factor_digest(be.gl, be.q, be.w)
              == factor_digest(eng.gl, eng.q, eng.w), "factor digest differs")
        bitwise = {
            "kernel_block": (fk.kernel_block(rows), bk.kernel_block(rows)),
            "topk_oos": (fk.topk(k=K, X=Xq), bk.topk(k=K, X=Xq)),
            "topk_train": (fk.topk(k=K), bk.topk(k=K)),
            "squared_row_sums_train": (
                eng.squared_row_sums(ytr, N_CLASSES),
                be.squared_row_sums(ytr, N_CLASSES)),
            "squared_row_sums_oos": (
                eng.squared_row_sums(ytr, N_CLASSES, X=Xte),
                be.squared_row_sums(ytr, N_CLASSES, X=Xte))}
        for name, (a, b) in bitwise.items():
            pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            check(all(torch.equal(u, v) for u, v in pairs),
                  f"budgeted {name} differs from the in-memory kernel's")
        V = np.random.default_rng(9).random((N_TRAIN, 20))
        errs = {"predict_train": max_err(eng.predict(ytr, N_CLASSES),
                                         be.predict(ytr, N_CLASSES)),
                "predict_oos": max_err(eng.predict(ytr, N_CLASSES, X=Xte),
                                       be.predict(ytr, N_CLASSES, X=Xte)),
                "matmat_20": max_err(eng.matmat(V), be.matmat(V))}
        for name, e in errs.items():
            check(e <= ATOL_PRODUCT, f"budgeted {name} error {e}")
        left = sorted(os.listdir(scratch))
        check(left == [], f"scratch files left after the fit: {left}")
        mem = be.memory_bytes()
    print(f"phase 9 check (a), {CHECK_BUDGET / 2 ** 20:g} MiB budget at "
          f"{N_TRAIN} x {N_TREES} trees ({time.perf_counter() - t:.1f} s): "
          "trees, digests, " + ", ".join(bitwise) + " bit for bit; "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + f"; engine {mem}", flush=True)


def pair_kernel_check(torch, eng, y, n_classes, k):
    """The collision kernels (``kernels/collide``) against their plain
    versions on the card, on three of the engine's own train-side row
    blocks (the first, the one holding the most products and the last):
    ``collide_enumerate`` bit for bit against the plain enumeration and
    sort run on the card, then, on its products, ``pair_topk`` bit for bit
    at ``k`` and at the kernel's widest top-k, ``pair_sums`` class-bucketed
    and unbucketed within ``PAIR_SUMS_RTOL`` of each entry; the three timed
    on each block (``times``: block, its longest row's products,
    enumeration ms, top-k ms, sums ms), and beside their plain versions on
    the largest block.  Leaves every launch count as it found it."""
    from repro_torch.kernels.collide.ops import (MAX_K, collide_enumerate,
                                                 pair_sums, pair_topk)
    from repro_torch.kernels.collide.ref import (collide_enumerate_ref,
                                                 pair_sums_ref, pair_topk_ref)
    counts = (collide_enumerate.launches, pair_topk.launches,
              pair_sums.launches)
    index, gl, q, cum, row_start, blocks, depth = eng._collide_args()
    dev, n_ref = gl.device, index.n_ref
    class_of = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
    sizes = [int(cum[i1] - cum[i0]) for i0, i1 in blocks]
    picked = sorted({0, int(np.argmax(sizes)), len(blocks) - 1})
    out = {"blocks": len(blocks), "checked": [], "sums_abs_err": 0.0,
           "sums_rel_err": 0.0, "times": []}
    for b in picked:
        i0, i1 = blocks[b]
        rows, n_prod = i1 - i0, sizes[b]
        block = (index, gl[i0:i1], q[i0:i1])
        key, prod = collide_enumerate(*block, row_start[i0:i1 + 1], n_prod)
        want = collide_enumerate_ref(*block, n_prod)
        check(torch.equal(key, want[0]) and torch.equal(prod, want[1]),
              f"collide_enumerate on row block {b} ({rows} rows, {n_prod} "
              "products) is not its plain version")
        del want
        pairs = int((key[1:] != key[:-1]).sum()) + (n_prod > 0)
        held = torch.bincount(torch.unique_consecutive(key) // n_ref,
                              minlength=rows)
        for kk in sorted({k, MAX_K}):
            got = (torch.empty((rows, kk), dtype=torch.int64, device=dev),
                   torch.empty((rows, kk), dtype=torch.float64, device=dev))
            want = (torch.empty_like(got[0]), torch.empty_like(got[1]))
            pair_topk(key, prod, n_ref, rows, depth, *got)
            pair_topk_ref(key, prod, n_ref, rows, depth, *want)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"pair_topk (k={kk}) on row block {b} ({rows} rows, "
                  f"{n_prod} products) is not its plain version")
        for cls, C in ((class_of, n_classes), (None, 1)):
            got = torch.empty(rows * C, dtype=prod.dtype, device=dev)
            want = torch.empty_like(got)
            pair_sums(key, prod, n_ref, rows, depth, cls, C, got)
            pair_sums_ref(key, prod, n_ref, rows, depth, cls, C, want)
            diff = (got - want).abs()
            rel = float((diff / want.abs().clamp_min(
                torch.finfo(want.dtype).tiny)).max())
            check(rel <= PAIR_SUMS_RTOL, f"pair_sums ({C} classes) on row "
                  f"block {b} ({rows} rows): rel err {rel}")
            out["sums_abs_err"] = max(out["sums_abs_err"],
                                      float(diff.max()))
            out["sums_rel_err"] = max(out["sums_rel_err"], rel)
        out["checked"].append(
            (b, rows, n_prod, pairs, int((held < k).sum())))
        kk = min(k, n_ref)
        idx = torch.empty((rows, kk), dtype=torch.int64, device=dev)
        val = torch.empty((rows, kk), dtype=torch.float64, device=dev)
        sq = torch.empty(rows * n_classes, dtype=prod.dtype, device=dev)
        out["times"].append((
            b, int(np.diff(cum[i0:i1 + 1]).max()),
            cuda_ms(torch, lambda: collide_enumerate(
                *block, row_start[i0:i1 + 1], n_prod), 5),
            cuda_ms(torch, lambda: pair_topk(key, prod, n_ref, rows, depth,
                                             idx, val), 5),
            cuda_ms(torch, lambda: pair_sums(key, prod, n_ref, rows, depth,
                                             class_of, n_classes, sq), 5)))
        if b == int(np.argmax(sizes)):
            read = n_prod * (key.element_size() + prod.element_size())
            out.update({
                "enum_ms": out["times"][-1][2],
                "enum_plain_ms": cuda_ms(torch, lambda: collide_enumerate_ref(
                    *block, n_prod), 2),
                # one read of each product's column and weight, one write
                # of its key and value
                "enum_bound_ms": n_prod * (4 + 2 * prod.element_size()
                                           + key.element_size())
                / HBM_BYTES_S * 1e3,
                "topk_ms": out["times"][-1][3],
                "topk_plain_ms": cuda_ms(torch, lambda: pair_topk_ref(
                    key, prod, n_ref, rows, depth, idx, val), 2),
                "topk_bound_ms": (read + rows * kk * 16) / HBM_BYTES_S
                * 1e3,
                "sums_ms": out["times"][-1][4],
                "sums_plain_ms": cuda_ms(torch, lambda: pair_sums_ref(
                    key, prod, n_ref, rows, depth, class_of, n_classes,
                    sq), 2),
                "sums_bound_ms": (read + n_ref * 8 + sq.numel()
                                  * sq.element_size()) / HBM_BYTES_S * 1e3})
        del key, prod
    collide_enumerate.launches, pair_topk.launches, pair_sums.launches = \
        counts
    return out


def phase9(torch, dev, n_rows, wrappers):
    """The out-of-core row of the reference (``benchmarks/bench_scaling.py
    --out-of-core``) through the port's ``ForestKernel`` on the card:
    stages timed, counted and measured (device transient, host traced
    peak, engine bytes, scratch files), then checked.  Returns the stages'
    launches and the collision-pair kernels' check (``pair_kernel_check``,
    empty where the engine's rule picks dense blocks)."""
    import tracemalloc
    from repro_torch.applications.outliers import oos_outlier_scores
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.factorization import factor_digest
    from repro_torch.core.snapshot import _dense_factor_from_csr
    from repro_torch.data.synthetic import gaussian_classes
    from repro_torch.forest.training import Binner
    from repro_torch.kernels.histogram.ops import histogram
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.obs.metrics import global_registry
    t9 = time.perf_counter()

    def counts():
        return {k: f.launches for k, f in wrappers.items()}

    def collided():
        """(rows served, products enumerated) on the collision path."""
        snap = global_registry().snapshot()
        return tuple(snap.get(c, {}).get("series", {}).get("", 0.0)
                     for c in ("engine_collide_rows_total",
                               "engine_collisions_total"))

    tracemalloc.start()
    stages = {}
    scratch_dir = None
    try:
        with tempfile.TemporaryDirectory(prefix="ooc_") as scratch:
            scratch_dir = scratch
            t = time.perf_counter()
            X, y = gen_memmap_dataset(os.path.join(scratch, "X.mm"), n_rows,
                                      gaussian_classes)
            print(f"phase 9: {n_rows} x {OOC_D} gaussian_classes "
                  f"({OOC_CLASSES} classes, sep {OOC_SEP}) generated into a "
                  f"memmap in {time.perf_counter() - t:.1f} s", flush=True)
            rng = np.random.default_rng(0)
            fk9 = ForestKernel(kernel_method="gap", n_trees=OOC_TREES,
                               max_depth=OOC_DEPTH,
                               min_samples_leaf=OOC_LEAF, n_bins=64, seed=0,
                               device=str(dev), scratch_dir=scratch,
                               memory_budget_bytes=OOC_BUDGET)

            def stage(name, fn):
                torch.cuda.synchronize()
                before, c_before = counts(), collided()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                tracemalloc.reset_peak()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                sec = time.perf_counter() - t
                after = counts()
                st = {"s": sec, "launches": "/".join(
                          str(after[k] - before[k]) for k in wrappers),
                      "collide": tuple(a - b for a, b in
                                       zip(collided(), c_before)),
                      "device_transient": torch.cuda.max_memory_allocated()
                      - base,
                      "host_peak": tracemalloc.get_traced_memory()[1],
                      "engine": None if fk9.engine is None
                      else fk9.engine.memory_bytes(),
                      "files": sorted(os.listdir(scratch))}
                stages[name] = st
                print(f"  stage {name}: {sec:.3f} s, {LAUNCHES} "
                      f"{st['launches']}, collision path rows/products "
                      f"{st['collide'][0]:.0f}/{st['collide'][1]:.0f}, "
                      f"device transient "
                      f"{st['device_transient'] / 2 ** 20:.1f} MiB, host "
                      f"traced peak {st['host_peak'] / 2 ** 20:.1f} MiB, "
                      f"engine {st['engine']}, scratch files {st['files']}",
                      flush=True)
                return out

            for f in wrappers.values():
                f.launches = 0
            # 1. streamed binning, then staged-code training; the streamed
            # codes are kept (their file is unlinked by the fit) for the
            # checks below
            kept = []
            real_tm = Binner.transform_memmap

            def keep_tm(self, X_, path):
                kept.append(real_tm(self, X_, path))
                return kept[-1]
            Binner.transform_memmap = keep_tm
            try:
                stage("fit_forest", lambda: fk9.fit_forest(X, y))
            finally:
                Binner.transform_memmap = real_tm
            check(stages["fit_forest"]["files"] == ["X.mm"],
                  "the binned-code scratch file outlived the fit")
            # 2. chunked K1, streamed (and, past the budget, spilled) CSR
            stage("build_kernel_cache", fk9.build_kernel_cache)
            eng9 = fk9.engine
            # 3. train-side outlier scores: N x N over leaf collisions
            # where the engine's rule picks them, else in K2 blocks; the
            # class-bucketed squared sums are kept for the checks
            sq_kept = []
            real_srs = eng9.squared_row_sums

            def keep_srs(*a, **k):
                sq_kept.append(real_srs(*a, **k))
                return sq_kept[-1]
            eng9.squared_row_sums = keep_srs
            try:
                scores = stage("outlier_scores", fk9.outlier_scores)
            finally:
                del eng9.squared_row_sums
            collides9 = eng9.collision_mode()
            print(f"phase 9: train-side path "
                  f"{'collision' if collides9 else 'dense blocks'} "
                  f"(collision share {eng9.collision_share():.3g})",
                  flush=True)
            check(not collides9 or stages["outlier_scores"]["collide"][0]
                  >= n_rows, "the outlier scores did not take the "
                  "collision path")

            # 4. one imputation iteration on a NaN-injected copy
            def impute():
                Xnan = np.asarray(X).copy()
                n_miss = max(1, int(n_rows * OOC_D * OOC_MISSING))
                Xnan[rng.integers(0, n_rows, n_miss),
                     rng.integers(0, OOC_D, n_miss)] = np.nan
                return fk9.impute(Xnan, y, n_iter=1)
            imp = stage("impute", impute)
            check(not np.isnan(imp.X_imputed_).any(),
                  "imputation left a NaN")
            n_missing = int(imp.missing_mask_.sum())
            del imp

            # 5. a tiered serving burst (shallow -> compressed -> full)
            def serve():
                srv = fk9.serve_tiered(prefix_depth=OOC_PREFIX,
                                       n_prototypes=OOC_PROTOS,
                                       proto_k=OOC_PROTO_K,
                                       n_slots=OOC_SLOTS)
                pool = [np.asarray(X[rng.integers(0, n_rows, OOC_SLOTS)])
                        for _ in range(4)]
                reqs = [(OOC_KINDS[i % 4], pool[i % 4])
                        for i in range(OOC_REQS)]
                srv.start()
                try:
                    uids = [srv.submit(kd, Xr, k=K) for kd, Xr in reqs]
                    srv.wait(uids, timeout=600.0)
                finally:
                    srv.stop()
                return srv, reqs, uids
            srv, reqs, uids = stage("serve_tiered", serve)
            ooc_launches = counts()
            tracemalloc.stop()
            pairs = pair_kernel_check(torch, eng9, y, OOC_CLASSES, K) \
                if collides9 else {}

            # ---- checks (b) ----
            binner = fk9.forest.binner_
            codes = kept[0]
            wins = (0, (n_rows - OOC_WINDOW) // 2, n_rows - OOC_WINDOW)
            for w0 in wins:
                check(np.array_equal(codes[w0:w0 + OOC_WINDOW],
                                     binner.transform(np.asarray(
                                         X[w0:w0 + OOC_WINDOW]))),
                      f"streamed codes differ in window {w0}")
            T = eng9.gl.shape[1]
            q_h = _dense_factor_from_csr(
                np.asarray(eng9.Q.data), np.asarray(eng9.Q.indices),
                np.asarray(eng9.Q.indptr), eng9.ctx.leaf_offset, T)
            w_h = _dense_factor_from_csr(
                np.asarray(eng9.W.data), np.asarray(eng9.W.indices),
                np.asarray(eng9.W.indptr), eng9.ctx.leaf_offset, T)
            dig = factor_digest(eng9.gl, eng9.q, eng9.w)
            check(factor_digest(eng9.gl, q_h, w_h) == dig,
                  "the streamed CSR factors differ from the device factors")
            del q_h, w_h
            # outliers: the kept class-bucketed squared sums of 1,024 stated
            # rows against the host CSR product, and the scores against the
            # host's median/MAD normalization of the kept sums
            chk = np.sort(np.random.default_rng(2).choice(
                n_rows, CHECK_ROWS, replace=False))
            B = (eng9.Q[chk] @ eng9.W.T.tocsc()).tocsr()
            r_of = np.repeat(np.arange(len(chk)), np.diff(B.indptr))
            host_sq = np.bincount(
                r_of * OOC_CLASSES + y[B.indices], weights=B.data ** 2,
                minlength=len(chk) * OOC_CLASSES).reshape(-1, OOC_CLASSES)
            sq = sq_kept[0].cpu().numpy()
            sq_rel = float((np.abs(sq[chk] - host_sq)
                            / np.maximum(np.abs(host_sq), 1e-300)).max())
            check(sq_rel <= OOC_RTOL, f"outlier squared sums rel {sq_rel}")
            cnt = np.bincount(y, minlength=OOC_CLASSES).astype(np.float64)
            own = sq[np.arange(n_rows), y]
            with np.errstate(over="ignore"):    # capped below, as on card
                raw = np.minimum(cnt[y] / np.maximum(own,
                                                     np.finfo(float).tiny),
                                 float(n_rows) ** 2)
            want = np.empty(n_rows)
            for c in range(OOC_CLASSES):
                m = y == c
                med = np.median(raw[m])
                mad = max(np.median(np.abs(raw[m] - med)),
                          np.finfo(float).tiny)
                want[m] = (raw[m] - med) / mad
            got = scores.cpu().numpy()
            check(got.shape == (n_rows,) and np.isfinite(got).all(),
                  "outlier scores not finite or of the wrong shape")
            sc_rel = float((np.abs(got[chk] - want[chk])
                            / np.maximum(np.abs(want[chk]), 1.0)).max())
            check(sc_rel <= OOC_RTOL, f"outlier scores rel {sc_rel}")
            # serving: every answer against a direct call on its tier
            tiers = {t.name: t for t in srv.tiers}
            s_err = {"topk values": 0.0, "outlier scores": 0.0}
            finals = []
            for (kind, Xr), u in zip(reqs, uids):
                r = srv._requests[u]
                check(r.done.is_set() and r.result is not None,
                      "the tiered server lost a request")
                tier = tiers[r.final_tier]
                e, yv = tier.engine, tier.y
                finals.append(r.final_tier)
                if kind == "predict":
                    want_l = e.predict(yv, OOC_CLASSES, X=Xr).argmax(1)
                    check(np.array_equal(r.result["labels"],
                                         want_l.cpu().numpy()),
                          f"tier {r.final_tier} predict labels differ")
                elif kind == "topk":
                    i_, v_ = e.topk(k=K, X=Xr)
                    i_, v_ = i_.cpu().numpy(), v_.cpu().numpy()
                    cols = getattr(e, "prototype_indices_", None)
                    if cols is not None:
                        i_ = np.where(v_ > 0, cols[i_], -1)
                    check(np.array_equal(r.result["indices"], i_),
                          f"tier {r.final_tier} topk ids differ")
                    s_err["topk values"] = max(s_err["topk values"], float(
                        np.abs(r.result["values"] - v_).max()))
                else:
                    s_err["outlier scores"] = max(
                        s_err["outlier scores"], float(np.abs(
                            r.result["scores"] - oos_outlier_scores(
                                e, yv, Xr).cpu().numpy()).max()))
            check(s_err["topk values"] <= 1e-12 and
                  s_err["outlier scores"] <= 1e-10, f"serving {s_err}")
            for name, st in stages.items():
                check(st["device_transient"] <= OOC_TRANSIENT_MAX,
                      f"stage {name} device transient "
                      f"{st['device_transient']} > {OOC_TRANSIENT_MAX}")

            # ---- check (c): K3 on staged codes at the root level ----
            inbag = fk9.forest.inbag_
            rows_t = [np.flatnonzero(inbag[t]) for t in range(OOC_TREES)]
            rows_cat = np.concatenate(rows_t)
            m3 = len(rows_cat)
            bounds = np.concatenate([[0], np.cumsum([len(r) for r in rows_t])])
            n_bins = binner.n_bins
            y_d = torch.as_tensor(y[rows_cat].astype(np.int32), device=dev)
            w_d = torch.as_tensor(np.concatenate(
                [inbag[t, r] for t, r in enumerate(rows_t)]),
                dtype=torch.float32, device=dev)

            def staged_codes():
                buf = torch.empty((m3, OOC_D), dtype=torch.uint8,
                                  pin_memory=True)
                np.take(codes, rows_cat, axis=0, out=buf.numpy(),
                        mode="clip")
                return buf.to(dev, non_blocking=True)
            t = time.perf_counter()
            xs = staged_codes()
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t
            resident = torch.as_tensor(np.asarray(codes), device=dev)
            rows_d = torch.as_tensor(rows_cat, device=dev)
            span = (int(rows_cat.min()), int(rows_cat.max()))

            def k3_staged():
                return histogram(xs, None, y_d, w_d, OOC_TREES, n_bins,
                                 OOC_CLASSES, bounds=bounds)

            def k3_resident():
                return histogram(resident, None, y_d, w_d, OOC_TREES,
                                 n_bins, OOC_CLASSES, rows=rows_d,
                                 bounds=bounds, row_range=span)
            h_st = k3_staged()
            node_d = torch.as_tensor(np.repeat(
                np.arange(OOC_TREES, dtype=np.int32), np.diff(bounds)),
                device=dev)
            k3_err = max_err(h_st, histogram_ref(xs, node_d, y_d, w_d,
                                                 OOC_TREES, n_bins,
                                                 OOC_CLASSES))
            check(k3_err == 0.0, "staged K3 != plain version")
            check(torch.equal(h_st, k3_resident()),
                  "staged K3 != K3 on device-resident codes")
            st_ms, res_ms = cuda_ms(torch, k3_staged, 5), \
                cuda_ms(torch, k3_resident, 5)
            del xs, resident, rows_d, codes, kept
        check(not os.path.exists(scratch_dir), "scratch dir not removed")
    finally:
        if tracemalloc.is_tracing():
            tracemalloc.stop()
        if scratch_dir is not None and os.path.exists(scratch_dir):
            print(f"phase 9: scratch dir {scratch_dir} left", flush=True)
    print(f"phase 9 checks (b): streamed codes equal Binner.transform on "
          f"windows {wins} of {OOC_WINDOW}; CSR factors' digest equals the "
          f"device factors' ({dig[:12]}); outlier squared sums on "
          f"{CHECK_ROWS} rows rel err {sq_rel:.1e}, scores rel err "
          f"{sc_rel:.1e}; {n_missing} NaN imputed, none left; "
          f"{OOC_REQS} served answers equal direct calls (final tiers "
          + ", ".join(f"{t} {finals.count(t)}" for t in sorted(set(finals)))
          + f"; topk values {s_err['topk values']:.1e}, outlier scores "
          f"{s_err['outlier scores']:.1e}); scratch dir removed", flush=True)
    print(f"phase 9 check (c): K3 on staged codes at the root level "
          f"({OOC_TREES} nodes x {m3} instances x {OOC_D} x {n_bins} x "
          f"{OOC_CLASSES}) equals its plain version (err {k3_err}) and the "
          f"device-resident call bit for bit; {res_ms:.3f} ms a call "
          f"resident, {st_ms:.3f} ms staged, host gather + copy "
          f"{stage_s:.3f} s", flush=True)
    print(f"phase 9 ({n_rows} rows) stages: " + ", ".join(
        f"{k} {v['s']:.3f} s" for k, v in stages.items())
        + f"; total {sum(v['s'] for v in stages.values()):.3f} s; launches "
        f"{ooc_launches}; phase 9 wall {time.perf_counter() - t9:.1f} s",
        flush=True)
    for name in ("leaf_route", "block_prox", "histogram"):
        check(ooc_launches[name] > 0,
              f"{name} was not launched on the out-of-core path")
    # the outlier scores' class sums and the prototypes' top-k
    path9 = "the collision path" if collides9 else "dense blocks"
    for name in ("pair_sums", "pair_topk", "collide_enumerate"):
        check((ooc_launches[name] > 0) == collides9,
              f"{name} launched {ooc_launches[name]} times on the "
              f"out-of-core path, on {path9}")
    if pairs:
        print("phase 9 check (d): the collision kernels equal their "
              "plain versions on the card on row blocks (block, rows, "
              "products, pairs, rows holding fewer than k pairs) "
              + ", ".join(str(c) for c in pairs["checked"])
              + f" of {pairs['blocks']}: collide_enumerate bit for bit, "
              f"pair_topk bit for bit at k = {K} "
              f"and 64, pair_sums rel err {pairs['sums_rel_err']:.1e} "
              f"(abs {pairs['sums_abs_err']:.1e}); collide_enumerate "
              f"launches on the out-of-core path "
              f"{ooc_launches['collide_enumerate']}; largest block ms "
              f"kernel / plain / one read: enumeration "
              f"{pairs['enum_ms']:.4f} / {pairs['enum_plain_ms']:.3f} / "
              f"{pairs['enum_bound_ms']:.4f}, top-k {pairs['topk_ms']:.4f} / "
              f"{pairs['topk_plain_ms']:.3f} / "
              f"{pairs['topk_bound_ms']:.4f}, sums {pairs['sums_ms']:.4f} "
              f"/ {pairs['sums_plain_ms']:.3f} / "
              f"{pairs['sums_bound_ms']:.4f}; a call on each (block, "
              "longest row's products, enumeration ms, top-k ms, sums ms) "
              + ", ".join(f"({b}, {n}, {e:.4f}, {t:.4f}, {u:.4f})"
                          for b, n, e, t, u in pairs["times"]), flush=True)
    return ooc_launches, pairs


def lm_teacher_forced(torch, lm, params, cfg, tokens, cache, start, n):
    """Decode ``tokens[:, start:start + n]`` one step each from ``cache``;
    returns the (B, n, V) logits and the cache."""
    logits = []
    for pos in range(start, start + n):
        lg, cache = lm.decode_step(params, cfg, tokens[:, pos:pos + 1],
                                   cache, pos)
        logits.append(lg[:, 0])
    return torch.stack(logits, 1), cache


def host_cache(cache):
    return {k: v.detach().to("cpu", copy=True) for k, v in cache.items()}


def phase10(torch, dev, wrappers):
    """The LM serving path on the card: (a) every reduced arch against the
    port's CPU path; (b) hymba_1p5b at its published width and depth,
    prefill and a 1,280-step decode held against the forward, timed and
    profiled; (c) its widths at depth 2 against the CPU path; (d) the
    continuous-batching engine at full width; (e) the proximity-head twin,
    counted, each of its kernels held against its plain version at the
    twin's shapes.  Returns (e)'s launches and those holds' errors."""
    import copy
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _lm_contract import (BF16_REL, ROUTER_TIE, bf16_contract,
                              engine_token_logits, first_divergence_ok,
                              logit_stats, np32, router_gaps)
    from repro_torch import proximity_head_lm as twin
    from repro_torch.configs.base import ALL_ARCHS, get_config
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels.block_prox.ops import block_prox
    from repro_torch.kernels.block_prox.ref import block_prox_ref
    from repro_torch.kernels.histogram.ops import histogram
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.leaf_route.ops import route
    from repro_torch.kernels.leaf_route.ref import route_ref
    from repro_torch.models import lm
    from repro_torch.models.lm import decode_step
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train.steps import make_prefill_step
    t10 = time.perf_counter()
    cpu = torch.device("cpu")

    # (a) every arch at reduced widths, card against the CPU path (bf16)
    rows = []
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced()
        if cfg.family == "moe":   # drop-free, as the reference's own test
            cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        params = lm.init_params(cfg, 0, device=dev)
        host = copy.deepcopy(params).to(cpu)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (2, 12))
        img = None
        if cfg.family == "vlm":
            img = torch.from_numpy(rng.normal(
                size=(2, cfg.prefix_len, cfg.d_model)).astype(np.float32))
        gaps_f, gaps_d = [], []
        with torch.inference_mode():
            fwd_d, _ = lm.forward(params, cfg, tokens, image_embed=img,
                                  attn_chunk=4)
            with router_gaps(gaps_f):
                fwd_h, _ = lm.forward(host, cfg, tokens, image_embed=img,
                                      attn_chunk=4)
        skip = (np.any([g.reshape(2, -1) < ROUTER_TIE for g in gaps_f],
                       axis=0)[:, -12:] if gaps_f else None)
        gap_f, dec_f = bf16_contract(fwd_d, fwd_h, skip, f"{arch} forward")
        row = f"{arch} forward {gap_f:.4f} ({dec_f} decided)"
        if cfg.family != "vlm":
            cd = lm.init_cache(cfg, 2, 16, device=dev)
            ch = lm.init_cache(cfg, 2, 16, device=cpu)
            dd, cd = lm_teacher_forced(torch, lm, params, cfg, tokens, cd,
                                       0, 12)
            with router_gaps(gaps_d):
                dh, ch = lm_teacher_forced(torch, lm, host, cfg, tokens, ch,
                                           0, 12)
            skip = None
            if gaps_d:
                skip = (np.stack(gaps_d).reshape(12, cfg.n_layers, 2)
                        < ROUTER_TIE).any(1).T
            gap_d, dec_d = bf16_contract(dd, dh, skip, f"{arch} decode")
            cache_gap = 0.0
            if skip is None or not skip.any():
                for k in ch:
                    r = np32(ch[k])
                    e = float(np.abs(np32(cd[k]) - r).max())
                    check(e <= BF16_REL * np.abs(r).max(),
                          f"{arch} cache {k}: {e}")
                    cache_gap = max(cache_gap, e / max(np.abs(r).max(),
                                                       1e-30))
            row += (f", decode {gap_d:.4f} ({dec_d} decided), caches "
                    f"{cache_gap:.4f}")
        rows.append(row)
    print("phase 10 (a) reduced archs, card vs CPU path, largest logit gap "
          "/ position max|logit|: " + "; ".join(rows)
          + f" ({time.perf_counter() - t10:.1f} s)", flush=True)

    # (b) hymba_1p5b at full width and depth
    tb = time.perf_counter()
    cfg = get_config(LM_ARCH)
    # earlier phases' unreachable cycles freed first, so that a collection
    # during the phase does not hide the phase's own peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    t = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    # param_count() is the reference's analytic count: it leaves out the
    # SSM conv bias and counts the conv weights over d_inner channels only
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    expect = cfg.param_count() + cfg.n_layers * (
        conv_ch * (cfg.ssm_conv + 1) - cfg.d_inner * cfg.ssm_conv)
    check(n_params == expect, f"{n_params} parameters, expected {expect}")
    print(f"phase 10 (b) {LM_ARCH}: {n_params} parameters "
          f"(param_count() {cfg.param_count()}; {n_params * 4 / 1e9:.3f} GB "
          f"float32) drawn on the card in {time.perf_counter() - t:.2f} s",
          flush=True)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=1)
    tokens = corpus.sample(np.random.default_rng(0), LM_B, LM_S)[:, :LM_S]
    tok_d = torch.from_numpy(tokens).to(dev)
    prefill = make_prefill_step(cfg)
    pre = {}
    for name in ("cold", "warm"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fwd = prefill(params, {"tokens": tok_d})
        torch.cuda.synchronize()
        pre[name] = time.perf_counter() - t
    check(fwd.shape == (LM_B, LM_S, cfg.vocab), f"prefill shape {fwd.shape}")
    check(bool(torch.isfinite(fwd.float()).all()), "prefill non-finite")
    cache = lm.init_cache(cfg, LM_B, LM_S, device=dev)
    dec = torch.empty_like(fwd)
    torch.cuda.synchronize()
    t = time.perf_counter()
    snaps = {}
    for pos in range(LM_S):
        lg, cache = lm.decode_step(params, cfg, tok_d[:, pos:pos + 1], cache,
                                   pos)
        dec[:, pos] = lg[:, 0]
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base
    ms_tok = dec_s * 1e3 / LM_S
    gap, scale, margin, agree = logit_stats(dec, fwd, "decode vs prefill")
    gap = gap / scale
    decided = margin > BF16_REL * scale
    agree_dec = float(agree[decided].mean()) if decided.any() else 1.0
    check(decided.sum() > 0, "no position has a decided argmax")
    check(agree_dec >= LM_AGREE, f"decode vs forward argmax agreement "
          f"{agree_dec:.4f} < {LM_AGREE}")
    bytes_bf16 = n_params * 2
    print(f"phase 10 (b) prefill B={LM_B} S={LM_S}: cold {pre['cold']:.3f} "
          f"s, warm {pre['warm']:.3f} s; teacher-forced decode {LM_S} steps "
          f"{dec_s:.2f} s = {ms_tok:.2f} ms a token (a step of {LM_B} "
          f"lanes); byte bound {bytes_bf16 / HBM_BYTES_S * 1e3:.3f} ms "
          f"({bytes_bf16 / 1e9:.3f} GB of bf16 weights; the float32 weights "
          f"the port reads {n_params * 4 / HBM_BYTES_S * 1e3:.3f} ms); peak "
          f"device memory {peak / 2 ** 30:.3f} GiB above the phase's start",
          flush=True)
    span = LM_S // 10
    per_pos = ", ".join(f"{p}-{p + span - 1}: {gap[:, p:p + span].max():.4f}"
                        for p in range(0, LM_S, span))
    print(f"phase 10 (b) decode vs forward: logit gap / max|logit|, max over "
          f"lanes and each span of positions: {per_pos}; overall max "
          f"{gap.max():.4f}, median {np.median(gap):.4f}; argmax agreement "
          f"{float(agree.mean()):.4f} at all {agree.size} positions, "
          f"{agree_dec:.4f} at the {int(decided.sum())} decided ones",
          flush=True)
    # where a decode step's device time goes
    prof_cache = {k: v.clone() for k, v in cache.items()}

    def decode_window():
        for i in range(LM_PROFILE_STEPS):
            lm.decode_step(params, cfg, tok_d[:, i:i + 1], prof_cache,
                           LM_S - LM_PROFILE_STEPS + i)
    # one profiled window: the device kernels (and copies) it ran, and
    # the device time of the kernels each aten op launched, its children's
    # included (aten::_to_copy is every dtype cast: the per-use float32 ->
    # bf16 weight casts, and the activations')
    from torch.profiler import ProfilerActivity, profile
    t = time.perf_counter()
    for _ in range(3):      # the profiler can lose a short window's events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode_window()
            torch.cuda.synchronize()
        dev_ms, n_k, by_op, n_ops = 0.0, 0, {}, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                dev_ms += us / 1e3 / LM_PROFILE_STEPS
                n_k += e.count / LM_PROFILE_STEPS
            else:
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = e.cuda_time_total
                by_op[e.key] = us / 1e3 / LM_PROFILE_STEPS
                n_ops += e.count
        if dev_ms > 0:
            break
    check(dev_ms > 0, "the profiler caught no device time in 3 windows")
    prof_s = time.perf_counter() - t
    ops = ("aten::_to_copy", "aten::mm", "aten::bmm", "aten::repeat_interleave",
           "aten::index_put_", "aten::softmax", "aten::cat")
    cast_bytes = n_params * 6               # read float32, write bf16
    print(f"phase 10 (b) a decode step under the profiler "
          f"({LM_PROFILE_STEPS} steps): {n_k:.0f} device kernels and "
          f"copies, {dev_ms:.3f} ms on the device, {n_ops / LM_PROFILE_STEPS:.0f}"
          f" aten op calls (nested calls counted); device ms by op (children "
          f"included): " + ", ".join(
              f"{k} {by_op.get(k, 0.0):.3f}" for k in ops)
          + f"; the weight casts move {cast_bytes / 1e9:.2f} GB a step "
          f"(>= {cast_bytes / HBM_BYTES_S * 1e3:.3f} ms); the device is "
          f"idle {1 - dev_ms / ms_tok:.3f} of an unprofiled step "
          f"({ms_tok:.2f} ms); profiling and reading it {prof_s:.1f} s; "
          f"(b) {time.perf_counter() - tb:.1f} s",
          flush=True)
    del fwd, dec, prof_cache

    # (c) full width, depth 2: layer 0 global, layer 1 SWA
    cfg2 = dataclasses.replace(cfg, n_layers=2, global_layers=(0,))
    p2 = lm.init_params(cfg2, 2, device=dev)
    h2 = copy.deepcopy(p2).to(cpu)
    t = time.perf_counter()
    with torch.inference_mode():
        f_d, _ = lm.forward(p2, cfg2, tok_d)
        f_h, _ = lm.forward(h2, cfg2, tokens)
    gf, df = bf16_contract(f_d, f_h, what="depth-2 forward")
    # the card decodes all positions; the CPU path decodes each segment
    # from the card's cache at its start (the second crosses the window)
    c_d = lm.init_cache(cfg2, LM_B, LM_S, device=dev)
    seg, seg_rows = {}, []
    for pos in range(LM_S):
        if pos in LM_SEGMENTS:
            seg[pos] = {"start": host_cache(c_d), "logits": []}
        lg, c_d = lm.decode_step(p2, cfg2, tok_d[:, pos:pos + 1], c_d, pos)
        for s0, d in seg.items():
            if s0 <= pos < s0 + LM_SEG_LEN:
                d["logits"].append(lg[:, 0])
                if pos == s0 + LM_SEG_LEN - 1:
                    d["end"] = host_cache(c_d)
    for s0, d in seg.items():
        lh, ch = lm_teacher_forced(torch, lm, h2, cfg2, tokens, d["start"],
                                   s0, LM_SEG_LEN)
        g, n = bf16_contract(torch.stack(d["logits"], 1), lh,
                             what=f"depth-2 decode from {s0}")
        ce = 0.0
        for k, v in ch.items():
            r = np32(v)
            e = float(np.abs(np32(d["end"][k]) - r).max())
            check(e <= BF16_REL * np.abs(r).max(), f"depth-2 cache {k} after "
                  f"{s0}: {e}")
            ce = max(ce, e / max(np.abs(r).max(), 1e-30))
        seg_rows.append(f"positions {s0}-{s0 + LM_SEG_LEN - 1}: logits "
                        f"{g:.4f} ({n} decided), caches {ce:.4f}")
    print(f"phase 10 (c) {LM_ARCH} widths at depth 2 (layer 0 global, 1 "
          f"SWA), card vs CPU path, largest gap / max|.|: forward B={LM_B} "
          f"S={LM_S} {gf:.4f} ({df} decided); decode " + "; ".join(seg_rows)
          + f" ({time.perf_counter() - t:.1f} s)", flush=True)
    del f_d, c_d

    # (d) the continuous-batching engine at full width
    rng = np.random.default_rng(2)
    corpus2 = SyntheticCorpus(vocab=cfg.vocab, seed=2)
    reqs = []
    for i in range(LM_REQS):
        n = int(rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1))
        reqs.append(Request(uid=i, prompt=corpus2.sample(rng, 1, n)[0, :n],
                            max_new_tokens=LM_NEW))
    eng = ServingEngine(cfg, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    td = t = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    ticks = 0
    while eng.queue or eng.active:
        eng.step()
        ticks += 1
    eng_s = time.perf_counter() - t
    st = eng.stats()
    check(st["requests"] == LM_REQS and st["tokens"] == LM_REQS * LM_NEW,
          f"engine stats {st}")
    # the same requests through the engine at depth 2 on the card and on
    # the CPU (the schedule of batched steps depends only on the prompt
    # lengths and max_new_tokens, so it is the same on both): each
    # request's tokens under the first-divergence rule, judged by the CPU
    # engine's own logits (recorded through the engine's decode_step)
    t = time.perf_counter()
    runs = {}
    for side, p in (("card", p2), ("cpu", h2)):
        calls = []

        def spy(*a, **kw):
            lg, c = decode_step(*a, **kw)
            calls.append((a[4].cpu().numpy().copy(), lg[:, -1].float().cpu()))
            return lg, c
        engine_mod.decode_step = spy
        try:
            e2 = ServingEngine(cfg2, p, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
            for r in reqs:
                e2.submit(Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=LM_NEW))
            e2.run_until_drained()
        finally:
            engine_mod.decode_step = decode_step
        runs[side] = (e2, calls)
    (e_d, _), (e_h, calls_h) = runs["card"], runs["cpu"]
    got = {r.uid: r for r in e_d.finished}
    n_same = 0
    for r in e_h.finished:
        check(len(got[r.uid].generated) == len(r.generated) == LM_NEW,
              f"request {r.uid}: {len(got[r.uid].generated)} tokens")
        check(first_divergence_ok(got[r.uid].generated, r.generated,
                                  engine_token_logits(calls_h, e_h.finished,
                                                      r)),
              f"request {r.uid}: the card engine's tokens part from the CPU "
              f"engine's at a decided position")
        n_same += got[r.uid].generated == r.generated
    print(f"phase 10 (d) ServingEngine {LM_ARCH} full width, {LM_SLOTS} "
          f"slots, max_seq {LM_MAX_SEQ}, {LM_REQS} requests of "
          f"{[len(r.prompt) for r in reqs]} prompt tokens + {LM_NEW} new: "
          f"{ticks} ticks in {eng_s:.3f} s ({eng_s * 1e3 / ticks:.1f} ms a "
          f"tick, admissions included), {st['tokens'] / eng_s:.1f} generated "
          f"tokens/s, mean latency {st['mean_latency_s']:.3f} s, mean TTFT "
          f"{st['mean_ttft_s']:.3f} s; at depth 2 the card engine against "
          f"the CPU engine (same weights, bf16): {n_same} of {LM_REQS} "
          f"requests equal throughout, the rest equal up to a near-tie of "
          f"the CPU engine's logits ({time.perf_counter() - t:.1f} s; (d) "
          f"{time.perf_counter() - td:.1f} s)", flush=True)
    del p2, h2, e_d, e_h, runs, calls_h
    del eng, params, cache

    # (e) the proximity-head twin: LM features once on the card, forests
    # on the card (counted) and on the host
    t = time.perf_counter()
    feats, labels = twin.features(device=str(dev))
    for f in wrappers.values():
        f.launches = 0
    fk = twin.fit_head(feats, labels, device=str(dev))
    idx, val = fk.topk(k=4)
    pred = fk.predict()
    Z = fk.leaf_pca(n_components=8).transform(fk.Q_)
    torch.cuda.synchronize()
    lm_launches = {k: f.launches for k, f in wrappers.items()}
    for name in ("leaf_route", "block_prox", "histogram"):
        check(lm_launches[name] > 0, f"{name} not launched by the twin")
    hk = twin.fit_head(feats, labels, device="cpu")
    same_trees(fk.forest.trees_, hk.forest.trees_, "proximity-head forest")
    _, hv = hk.topk(k=4)
    n_cls = int(labels.max()) + 1
    e_topk = max_err(val, hv)
    e_pred = max_err(fk.engine.predict(fk.ctx.y, n_cls),
                     hk.engine.predict(hk.ctx.y, n_cls))
    check(e_topk <= ATOL_OPS and e_pred <= ATOL_OPS,
          f"twin ops: topk {e_topk}, predict {e_pred}")
    acc = float((pred.cpu().numpy() == labels).mean())
    print(f"phase 10 (e) proximity_head_lm: features {feats.shape} from the "
          f"card LM, {twin.N_TREES} trees equal to the host fit's, top-k "
          f"{e_topk:.2e} and predict scores {e_pred:.2e} from the CPU "
          f"engine, label recovery {acc:.3f}, leaf-PCA {Z.shape}; launches "
          f"{LAUNCHES} "
          f"{'/'.join(str(v) for v in lm_launches.values())} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # each kernel of (e) against its plain version on the twin's card
    # tensors (not counted): K3 at the root level over the codes (every
    # tree's in-bag rows, bootstrap counts as weights, as the trainer calls
    # it), K1 on the fitted forest's tables, K2 on topk's block (every
    # training row) in the form the engine picks, and in the other form
    forest, e = fk.forest, fk.engine
    T, n_bins = forest.n_trees, forest.binner_.n_bins
    codes = torch.as_tensor(forest.binner_.transform(feats), device=dev)
    rows_t = [np.flatnonzero(forest.inbag_[i]) for i in range(T)]
    rows_cat = np.concatenate(rows_t)
    bounds = np.concatenate([[0], np.cumsum([len(r) for r in rows_t])])
    rows_d = torch.as_tensor(rows_cat, dtype=torch.int32, device=dev)
    node_d = torch.as_tensor(np.repeat(np.arange(T), np.diff(bounds)),
                             dtype=torch.int32, device=dev)
    y_d = torch.as_tensor(labels[rows_cat], dtype=torch.int32, device=dev)
    w_d = torch.as_tensor(np.concatenate(
        [forest.inbag_[i, r] for i, r in enumerate(rows_t)]),
        dtype=torch.float32, device=dev)
    X_d = torch.as_tensor(feats, dtype=torch.float64, device=dev)
    tb = forest.route_tables_
    ix = e.leaf_index() if e.leaf_mode() else None
    calls = {  # name: (kernel call, plain version)
        "histogram": (
            lambda: histogram(codes, None, y_d, w_d, T, n_bins, n_cls,
                              rows=rows_d, bounds=bounds,
                              row_range=(int(rows_cat.min()),
                                         int(rows_cat.max()))),
            lambda: histogram_ref(codes[rows_d.long()], node_d, y_d, w_d, T,
                                  n_bins, n_cls)),
        "leaf_route": (lambda: route(X_d, tb),
                       lambda: route_ref(X_d, *tb.flat(), tb.n_trees,
                                         tb.max_nodes)),
        "block_prox": (lambda: block_prox(e.gl, e.q, e.gl, e.w, index=ix),
                       lambda: block_prox_ref(e.gl, e.q, e.gl, e.w))}
    holds, times = {}, {}
    for name, (call, plain) in calls.items():
        got = call()
        holds[name] = max_err(got, plain())
        if name != "block_prox":
            check(torch.equal(got, plain()), f"{name} != its plain version "
                  f"on the proximity head")
        times[name] = (cuda_ms(torch, call, 5), cuda_ms(torch, plain, 2))
    check(holds["block_prox"] <= ATOL_BLOCK, f"block_prox on the proximity "
          f"head: error {holds['block_prox']} > {ATOL_BLOCK}")
    ix_other = e.leaf_index() if ix is None else None

    def k2_other():
        return block_prox(e.gl, e.q, e.gl, e.w, index=ix_other)
    check(torch.equal(k2_other().view(torch.int64),
                      calls["block_prox"][0]().view(torch.int64)),
          "block_prox on the proximity head: leaf and dense forms differ")
    other_ms = cuda_ms(torch, k2_other, 5)
    print(f"phase 10 (e) kernels against their plain versions on the twin's "
          f"tensors (ms a call, plain ms): K3 root level {T} nodes x "
          f"{len(rows_cat)} instances x {feats.shape[1]} x {n_bins} x {n_cls} "
          f"bit for bit {times['histogram'][0]:.4f} / "
          f"{times['histogram'][1]:.3f}; K1 {X_d.shape[0]} x {T} trees "
          f"(M={tb.max_nodes}, {feats.shape[1]} features) bit for bit "
          f"{times['leaf_route'][0]:.4f} / {times['leaf_route'][1]:.3f}; K2 "
          f"{e.gl.shape[0]} x {e.gl.shape[0]} x {T} in the "
          f"{'leaf' if ix is not None else 'dense'} form (leaf density "
          f"{e._leaf_density:.5f}), err {holds['block_prox']:.1e} "
          f"{times['block_prox'][0]:.4f} / {times['block_prox'][1]:.3f} "
          f"(the other form same bits, {other_ms:.4f} ms)",
          flush=True)
    print(f"phase 10 wall: {time.perf_counter() - t10:.1f} s", flush=True)
    return lm_launches, holds


def phase11(torch, dev):
    """LM training on the card: (a) every reduced arch's train step against
    the port's CPU train step in float32 compute, then five bf16 steps on
    one batch lowering the loss; (b) hymba_1p5b at its published width and
    depth, five steps on one batch with remat, timed, its peak memory and
    its bound, one warm step profiled; its widths at depth 2 against the
    CPU path in bf16; (c) the ``train_lm_e2e`` twin's ``train_loop`` in a
    scratch directory, uninterrupted and then failing at a middle step and
    resumed; (d) int8 gradient compression on the card against the CPU on
    hymba's gradient leaves."""
    import copy
    from repro_torch import train_lm_e2e as e2e
    from repro_torch.configs.base import ALL_ARCHS, get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.compression import (EFState, ef_compress,
                                                     quantize_int8)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm
    from repro_torch.train.checkpoint import latest_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (init_train_state, make_train_step,
                                         value_and_grad)
    t11 = time.perf_counter()
    cpu = torch.device("cpu")

    def on(batch, device):
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def leaf_gaps(got, ref):
        """Each leaf's largest |got - ref| as a share of its max|ref|."""
        return [float((g.cpu() - r).abs().max()) / max(float(r.abs().max()),
                                                       1e-30)
                for g, r in zip(got, ref)]

    # (a) every arch at reduced widths, float32 compute
    rows, f32 = [], lm.COMPUTE_DTYPE
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced()
        params = lm.init_params(cfg, 0, device=dev)
        host = copy.deepcopy(params).to(cpu)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (2, TRAIN_S_REDUCED))
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
        if cfg.family == "vlm":
            batch["image_embed"] = rng.normal(
                size=(2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        opt = AdamWConfig(lr=1e-3, warmup_steps=1, schedule="const")
        lm.COMPUTE_DTYPE = torch.float32
        try:
            ld, gd = value_and_grad(cfg, params, on(batch, dev), attn_chunk=8)
            lh, gh = value_and_grad(cfg, host, on(batch, cpu), attn_chunk=8)
            mets = []
            for p in (params, host):
                step = make_train_step(cfg, opt, attn_chunk=8)
                _, m = step({"params": p, "opt": adamw_init(p)},
                            on(batch, p.device))
                mets.append({k: float(v) for k, v in m.items()})
        finally:
            lm.COMPUTE_DTYPE = f32
        e_loss = abs(float(ld) - float(lh)) / abs(float(lh))
        e_step = abs(mets[0]["loss"] - mets[1]["loss"]) / abs(mets[1]["loss"])
        e_norm = abs(mets[0]["grad_norm"] - mets[1]["grad_norm"]) \
            / mets[1]["grad_norm"]
        gaps = leaf_gaps(gd, gh)
        check(all(torch.isfinite(g).all() for g in gd), f"{arch}: non-finite "
              f"gradients on the card")
        check(max(e_loss, e_step, e_norm) <= TRAIN_TOL and
              max(gaps) <= TRAIN_TOL, f"{arch} float32 train step, card vs "
              f"CPU: loss {e_loss:.2e} / {e_step:.2e}, grad_norm "
              f"{e_norm:.2e}, worst leaf {max(gaps):.2e}")
        # bf16: five steps on one batch (labels the tokens themselves, the
        # reference's test_train_step_reduces_loss) lower the loss
        state = init_train_state(cfg, 1, device=dev)
        step = make_train_step(cfg, AdamWConfig(
            lr=1e-2, warmup_steps=1, total_steps=100, schedule="const"),
            attn_chunk=8)
        mem = on(dict(batch, labels=tokens), dev)
        losses = []
        for _ in range(5):
            state, m = step(state, mem)
            losses.append(float(m["loss"]))
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{arch}: bf16 losses {losses}")
        rows.append(f"{arch} loss {max(e_loss, e_step):.1e} grad_norm "
                    f"{e_norm:.1e} leaf {max(gaps):.1e}, bf16 "
                    f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    print("phase 11 (a) reduced archs, float32 train step card vs CPU (loss "
          "and grad_norm relative, worst leaf's gradient gap / its "
          "max|g|), then 5 bf16 steps on one batch: " + "; ".join(rows)
          + f" ({time.perf_counter() - t11:.1f} s)", flush=True)

    # (b) hymba_1p5b at full width and depth: 5 steps on one batch
    tb = time.perf_counter()
    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    gc.collect()                             # as in phase 10 (b)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    state = init_train_state(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    state_gb = 4 * n_params * 3 / 1e9        # params, m, v (float32)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=TRAIN_B,
                         seq_len=TRAIN_S)
    batch = on(pipe.batch_at(0), dev)
    step = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, schedule="const"), remat=True)
    losses, secs = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))      # reads the device: the step's end
        secs.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() - base
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"{LM_ARCH} full-size losses {losses}")
    warm_ms = float(np.mean(secs[1:])) * 1e3
    tokens = TRAIN_B * TRAIN_S
    flops = 8 * n_params * tokens            # 6NT + the remat forward's 2NT
    bound_ms = flops / BF16_S * 1e3
    # one warm step under the profiler: device time by aten op (the
    # kernels each op launched itself) and the idle share
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):      # the profiler can lose a short window's events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batch)
            torch.cuda.synchronize()
        dev_ms, n_k, by_op, by_kernel = 0.0, 0, {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev_ms += us / 1e3
                n_k += e.count
                by_kernel[e.key] = (by_kernel.get(e.key, (0.0, 0))[0]
                                    + us / 1e3, e.count)
            elif us > 0:
                by_op[e.key] = by_op.get(e.key, 0.0) + us / 1e3
        if dev_ms > 0:
            break
    check(dev_ms > 0, "the profiler caught no device time in 3 windows")
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TRAIN_TOP_OPS]
    print(f"phase 11 (b) {LM_ARCH}: {n_params} parameters, B={TRAIN_B} x "
          f"S={TRAIN_S}, remat, lr {TRAIN_LR}: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; cold {secs[0] * 1e3:.1f}"
          f" ms, warm {warm_ms:.1f} ms a step (mean of {TRAIN_STEPS - 1}), "
          f"{tokens / warm_ms * 1e3:.1f} tokens/s; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB above the phase's start (params, m and v "
          f"{state_gb:.2f} GB float32, grads {state_gb / 3:.2f} GB); bound "
          f"{bound_ms:.2f} ms (8 x N x T = {flops:.3e} FLOP at "
          f"{BF16_S / 1e12:.0f} TFLOP/s bf16 dense), the step "
          f"{warm_ms / bound_ms:.1f}x it", flush=True)
    print(f"phase 11 (b) a warm step under the profiler: {n_k} device "
          f"kernels and copies, {dev_ms:.2f} ms on the device, idle "
          f"{1 - dev_ms / warm_ms:.3f} of an unprofiled step; device ms by "
          f"aten op (its own kernels): " + ", ".join(
              f"{k} {v:.2f}" for k, v in top) + "; the longest kernels "
          "(ms, launches): " + ", ".join(
              f"{k[:60]} {v[0]:.2f} ({v[1]})" for k, v in sorted(
                  by_kernel.items(), key=lambda kv: -kv[1][0])[:5]),
          flush=True)
    del state, batch, m, prof

    # (b) its widths at depth 2 (layer 0 global, 1 SWA), B=1 x S=1,280:
    # loss, grad_norm and every leaf's gradient, card against the CPU (bf16)
    t = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2, global_layers=(0,))
    p2 = lm.init_params(cfg2, 2, device=dev)
    h2 = copy.deepcopy(p2).to(cpu)
    b2 = {k: v[:1] for k, v in pipe.batch_at(1).items()}
    ld, gd = value_and_grad(cfg2, p2, on(b2, dev))
    lh, gh = value_and_grad(cfg2, h2, on(b2, cpu))
    nd = float(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(gd))))
    nh = float(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(gh))))
    e_loss = abs(float(ld) - float(lh)) / abs(float(lh))
    e_norm = abs(nd - nh) / nh
    gaps = leaf_gaps(gd, gh)
    names = [n for n, _ in p2.named_parameters()]
    worst = int(np.argmax(gaps))
    check(e_loss <= TRAIN_BF16_LOSS and e_norm <= TRAIN_BF16_NORM
          and max(gaps) <= TRAIN_BF16_LEAF,
          f"depth-2 bf16 gradients, card vs CPU: loss {e_loss:.2e}, "
          f"grad_norm {e_norm:.2e}, {names[worst]} {gaps[worst]:.3f}")
    print(f"phase 11 (b) {LM_ARCH} widths at depth 2, B=1 x S={TRAIN_S}, "
          f"bf16, card vs CPU: loss {float(ld):.5f} / {float(lh):.5f} "
          f"(relative {e_loss:.2e}, limit {TRAIN_BF16_LOSS}), grad_norm "
          f"{nd:.5f} / {nh:.5f} ({e_norm:.2e}, limit {TRAIN_BF16_NORM}), "
          f"largest leaf gap / its max|g| {gaps[worst]:.4f} at "
          f"{names[worst]} (limit {TRAIN_BF16_LEAF}), median "
          f"{float(np.median(gaps)):.4f} ({time.perf_counter() - t:.1f} s; "
          f"(b) {time.perf_counter() - tb:.1f} s)", flush=True)

    del p2, h2, gh

    # (c) the e2e twin's train_loop: uninterrupted, then failing at a middle
    # step and resumed from its checkpoint (the reference's resume-exact)
    t = time.perf_counter()
    cfg_e = e2e.e2e_config()
    kw = dict(e2e.run_kw(), device=str(dev), log_every=10 ** 9)
    kw["steps"] = E2E_STEPS
    kw["save_every"] = E2E_SAVE
    with tempfile.TemporaryDirectory(prefix="e2e_") as scratch:
        t0 = time.perf_counter()
        _, full = train_loop(cfg_e, ckpt_dir=os.path.join(scratch, "a"), **kw)
        full_s = time.perf_counter() - t0
        d_b = os.path.join(scratch, "b")
        try:
            train_loop(cfg_e, ckpt_dir=d_b, fail_at=E2E_FAIL, **kw)
            check(False, "the failing run did not fail")
        except RuntimeError as err:
            check("simulated failure" in str(err), f"failing run: {err}")
        resumed_at = latest_step(d_b)
        _, resumed = train_loop(cfg_e, ckpt_dir=d_b, **kw)
    a = np.array([h["loss"] for h in full[resumed_at:]])
    b = np.array([h["loss"] for h in resumed])
    check(len(a) == len(b) == E2E_STEPS - resumed_at,
          f"resumed {len(b)} steps from {resumed_at}")
    e_res = float(np.max(np.abs(a - b) / np.abs(a)))
    check(e_res <= 1e-4, f"resumed losses differ by {e_res:.2e} (rtol 1e-4)")
    first, last, ok = e2e.summary(full)
    check(ok, f"e2e PASS rule: {first:.3f} -> {last:.3f}")
    print(f"phase 11 (c) train_lm_e2e's train_loop on the card "
          f"({cfg_e.param_count() / 1e6:.1f}M parameters, batch "
          f"{kw['global_batch']} x {kw['seq_len']}, {E2E_STEPS} steps, "
          f"checkpoints every {E2E_SAVE}): loss {first:.3f} -> {last:.3f} "
          f"(PASS: last < first - 0.3), {full_s * 1e3 / E2E_STEPS:.1f} ms a "
          f"step with its saves; failed at step {E2E_FAIL}, resumed from "
          f"{resumed_at}: the {len(b)} resumed losses within {e_res:.1e} of "
          f"the uninterrupted run's ({time.perf_counter() - t:.1f} s)",
          flush=True)

    # (d) int8 compression of (b)'s depth-2 gradients: the card's codes,
    # scales and error-feedback residuals against the CPU's, bit for bit
    t = time.perf_counter()
    n_el = 0
    for i in range(len(gd)):
        g_d, g_h = gd[i], gd[i].cpu()
        qd, sd = quantize_int8(g_d)
        qh, sh = quantize_int8(g_h)
        r = torch.full_like(g_h, 1e-4)
        (od,), efd = ef_compress([g_d], EFState([r.to(dev)]))
        (oh,), efh = ef_compress([g_h], EFState([r]))
        check(torch.equal(qd.cpu(), qh) and same_bits(sd, sh)
              and same_bits(od, oh) and same_bits(efd.residual[0],
                                                  efh.residual[0]),
              f"int8 compression of {names[i]} differs on the card")
        n_el += g_h.numel()
    big = max(range(len(gd)), key=lambda i: gd[i].numel())
    print(f"phase 11 (d) int8 compression of the {len(gd)} depth-2 gradient "
          f"leaves ({n_el} values, the largest {names[big]} "
          f"{tuple(gd[big].shape)}): codes, scales, error-feedback outputs and residuals "
          f"on the card equal the CPU's bit for bit "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    del gd
    print(f"phase 11 wall: {time.perf_counter() - t11:.1f} s", flush=True)
    return peak


class _StepClock:
    """Collects ``train_loop``'s step times (its monitor's heartbeats)."""

    def __init__(self):
        self.secs = []

    def beat(self, host, step_duration):
        self.secs.append(step_duration)


def phase13(torch, dev):
    """The LM's sharding layer on the card (no kernel of the port runs
    here): (a) hymba_1p5b at its published width and depth, B=2 x 1,280
    with remat, two steps of ``train_loop`` on one device and on a one-rank
    NCCL mesh (1, 1) (DTensor leaves and batch), timed with peak memory,
    the two runs' metrics and every leaf compared; (b) each run's
    parameters checkpointed and restored into the other layout (the mesh
    run's into one device, the one-device run's onto the mesh), bit for
    bit.  The whole state (params, m and v: 19.69 GB) would take ~75 s
    more of disk writes; m and v go through the same code.  Returns the
    bytes of the state and batch the one-device run trains on (phase 14
    (d) predicts them)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.models.lm import abstract_params
    t13 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    mesh = make_local_mesh(1, 1, device=dev.type)
    kw = dict(steps=MESH_STEPS, global_batch=TRAIN_B, seq_len=TRAIN_S,
              ckpt_dir="", device=str(dev), lr=TRAIN_LR, log_every=10 ** 9,
              attn_chunk=MESH_CHUNK)

    def leaves(state):
        """Every leaf of params (and of m and v when ``state`` has them) as
        a plain tensor (a one-rank mesh's shard is the whole leaf)."""
        out = list(state["params"].parameters())
        if "opt" in state:
            out += list(state["opt"]["m"].parameters()) \
                + list(state["opt"]["v"].parameters())
        return [p.detach().to_local() if hasattr(p, "to_local")
                else p.detach() for p in out]

    def bits(x, y):
        return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32))

    runs, states = {}, {}
    with tempfile.TemporaryDirectory(prefix="mesh13_") as scratch:
        for name, m in (("one device", None), ("mesh (1, 1)", mesh)):
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            clock = _StepClock()
            t = time.perf_counter()
            state, hist = train_loop(cfg, mesh=m, monitor=clock, **kw)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            if m is None:      # the state's leaves (and host step), a batch
                pipe = TokenPipeline(vocab=cfg.vocab, global_batch=TRAIN_B,
                                     seq_len=TRAIN_S)
                arg_bytes = sum(
                    t.numel() * t.element_size() for t in
                    list(state["params"].parameters())
                    + list(state["opt"]["m"].parameters())
                    + list(state["opt"]["v"].parameters())
                    + [state["opt"]["step"]]) + sum(
                    v.nbytes for v in pipe.batch_at(0).values())
            peak = torch.cuda.max_memory_allocated() - base
            ck = os.path.join(scratch, "mesh" if m is not None else "one")
            t = time.perf_counter()
            save_checkpoint(ck, MESH_STEPS, {"params": state["params"]})
            runs[name] = dict(hist=hist, secs=clock.secs, total=total,
                              peak=peak, save=time.perf_counter() - t, ck=ck)
            states[name] = state
            del state
            check(all(np.isfinite([h["loss"], h["grad_norm"]]).all()
                      for h in hist), f"phase 13 {name}: non-finite metrics")
        one, sh = states["one device"], states["mesh (1, 1)"]
        check(all(hasattr(p, "placements")
                  for p in sh["params"].parameters()),
              "phase 13: the mesh run's leaves are not DTensors")
        a, b = leaves(one), leaves(sh)
        n_p = sum(1 for _ in one["params"].parameters())
        gaps = [float((x - y).abs().max()) for x, y in zip(a[:n_p], b[:n_p])]
        equal = all(bits(x, y) for x, y in zip(a, b))
        del a, b
        h1, h2 = runs["one device"]["hist"], runs["mesh (1, 1)"]["hist"]
        e_loss = max(abs(x["loss"] - y["loss"]) for x, y in zip(h1, h2))
        e_norm = max(abs(x["grad_norm"] - y["grad_norm"])
                     for x, y in zip(h1, h2))
        # one rank runs the same local kernels as one device: bit for bit
        check(equal and e_loss == 0 and e_norm == 0,
              f"phase 13 (a): mesh (1, 1) against one device: loss gap "
              f"{e_loss:.3e}, grad norm gap {e_norm:.3e}, largest parameter "
              f"gap {max(gaps):.3e}, every leaf of params, m and v equal bit "
              f"for bit: {equal}")
        for name, r in runs.items():
            losses = ", ".join(f"{h['loss']:.6f}" for h in r["hist"])
            norms = ", ".join(f"{h['grad_norm']:.6f}" for h in r["hist"])
            ms = ", ".join(f"{x * 1e3:.1f}" for x in r["secs"])
            print(f"phase 13 (a) {LM_ARCH} {name}, B={TRAIN_B} x "
                  f"S={TRAIN_S}, remat, {MESH_STEPS} train_loop steps: "
                  f"losses {losses}; grad norms {norms}; ms a step {ms}"
                  f" (first, then warm); train_loop {r['total']:.1f} s with "
                  f"its set-up; peak device memory {r['peak'] / 2 ** 30:.3f} "
                  f"GiB above the run's start; parameter checkpoint save "
                  f"{r['save']:.1f} s", flush=True)
        print(f"phase 13 (a) mesh (1, 1) against one device: largest loss "
              f"gap {e_loss:.3e}, grad norm gap {e_norm:.3e}, parameter gap "
              f"{max(gaps):.3e}; every leaf of params, m and v equal bit for "
              f"bit: {equal}", flush=True)

        # (b) each run's parameters checkpoint into the other layout
        t = time.perf_counter()
        got = restore_checkpoint(runs["mesh (1, 1)"]["ck"],
                                 {"params": abstract_params(cfg)}, device=dev)
        check(not any(hasattr(p, "placements")
                      for p in got["params"].parameters()),
              "phase 13 (b): restored leaves should be plain tensors")
        check(all(bits(x, y) for x, y in
                  zip(leaves(got), leaves({"params": sh["params"]}))),
              "phase 13 (b): the mesh run's checkpoint on one device differs")
        t_one = time.perf_counter() - t
        del got
        t = time.perf_counter()
        got = restore_checkpoint(runs["one device"]["ck"],
                                 {"params": sh["params"]})
        check(all(hasattr(p, "placements")
                  for p in got["params"].parameters()),
              "phase 13 (b): leaves restored onto the mesh are not DTensors")
        check(all(bits(x, y) for x, y in
                  zip(leaves(got), leaves({"params": one["params"]}))),
              "phase 13 (b): the one-device checkpoint on the mesh differs")
        t_mesh = time.perf_counter() - t
        del got, one, sh, states
        gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                 os.walk(runs["one device"]["ck"]) for f in fs) / 1e9
        print(f"phase 13 (b) parameter checkpoints ({gb:.2f} GB each): the "
              f"mesh run's restored on one device {t_one:.1f} s, the "
              f"one-device run's restored onto the mesh {t_mesh:.1f} s; every "
              f"leaf equal bit for bit", flush=True)

    print(f"phase 13 (a) the one-device run's state and batch: {arg_bytes} "
          f"bytes", flush=True)
    print(f"phase 13 wall: {time.perf_counter() - t13:.1f} s", flush=True)
    return arg_bytes


# phase 14 (d): hymba_1p5b's phase-11 (b) train step on a fake one-rank
# world, run by the dry run in its own process (no card)
DRYRUN_ONE_RANK = """
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
dryrun.fake_world(1)
cell = ShapeCell("train_{s}", {s}, {b}, "train")
rec = dryrun.run_cell("{arch}", cell.name, cell=cell,
                      mesh=make_local_mesh(1, 1, device="cpu"))
print(json.dumps(rec))
sys.exit(0 if rec["ok"] else 1)
"""
# phase 14's dry-run cells: (label, arguments of ``python -m
# repro_torch.launch.dryrun``, or None for the one-rank helper above)
DRYRUN_CELLS = (
    ("(a) every arch's decode_32k at (16, 16)",
     ["--all", "--shape", "decode_32k"]),
    ("(b) hymba_1p5b train_4k at (16, 16)",
     ["--arch", LM_ARCH, "--shape", "train_4k"]),
    ("(c) qwen3_moe_235b_a22b decode_32k at (2, 16, 16)",
     ["--arch", "qwen3_moe_235b_a22b", "--shape", "decode_32k",
      "--multi-pod"]),
    ("(d) hymba_1p5b B=2 x 1,280 on one rank", None),
)


def phase14_start():
    """Start phase 14's dry runs (``repro_torch.launch.dryrun``: a fake
    world of 256, 512 or 1 rank, every input a ``meta`` DTensor; no card,
    no kernel of the port) in the background under ``nice``: one process
    a cell set, one after another (one host core busy, not four, while
    phases 1-3 run their host fits), each writing its log, exit code and
    records under a temporary directory.  Returns the directory and the
    shell that runs them."""
    out = tempfile.mkdtemp(prefix="dryrun14_")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    steps = []
    for i, (_, args) in enumerate(DRYRUN_CELLS):
        if args is None:
            cmd = [sys.executable, "-c", DRYRUN_ONE_RANK.format(
                arch=LM_ARCH, b=TRAIN_B, s=TRAIN_S)]
        else:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                   "--out", os.path.join(out, str(i))]
        log, rc = (shlex.quote(os.path.join(out, f"{i}.{x}"))
                   for x in ("log", "rc"))
        steps.append(f"{shlex.join(cmd)} > {log} 2>&1; echo $? > {rc}")
    proc = subprocess.Popen(["nice", "-n", "10", "sh", "-c", "; ".join(steps)],
                            cwd=ROOT, env=env, start_new_session=True)
    atexit.register(phase14_stop, proc)
    return out, proc


def phase14_stop(proc):
    """Stop phase 14's shell and the dry run it is running."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def phase14_finish(out, proc, arg_bytes13, peak11):
    """Wait for phase 14's dry runs and check them: every cell ``ok``; (d)'s
    argument bytes equal to the state and batch phase 13 (a) trained on
    (``arg_bytes13``); (d)'s predicted peak printed beside phase 11 (b)'s
    measured one (``peak11``), not checked."""
    t = time.perf_counter()
    try:
        try:
            proc.wait(timeout=DRYRUN_WAIT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"phase 14: still running after "
                               f"{DRYRUN_WAIT_S} s more")
        for i, (label, args) in enumerate(DRYRUN_CELLS):
            with open(os.path.join(out, f"{i}.log")) as f:
                text = f.read()
            with open(os.path.join(out, f"{i}.rc")) as f:
                rc = int(f.read())
            if args is None:
                one = json.loads(next(
                    line for line in reversed(text.splitlines())
                    if line.startswith("{")))
                recs = [one]
            else:
                d = os.path.join(out, str(i))
                recs = []
                for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
                    with open(os.path.join(d, name)) as f:
                        recs.append(json.load(f))
            check(rc == 0 and recs and all(r["ok"] for r in recs),
                  f"phase 14 {label}: exit {rc}, "
                  f"{[r.get('error') for r in recs if not r['ok']]}; "
                  f"{text[-2000:]}")
            for r in recs:
                m = r["memory"]
                print(f"phase 14 {label}: {r['arch']} {r['shape']} "
                      f"{r['mesh']} ok {r['ok']} trace {r['trace_s']} s, "
                      f"tc_flops {r['tc_flops']:.4e} a rank, memory a rank "
                      f"{(m['argument_size'] + m['temp_size']) / 2 ** 30:.3f} "
                      f"GiB (arguments {m['argument_size']}, temp "
                      f"{m['temp_size']}), collective bytes a rank "
                      f"{r['tc_collective_total']:.4e} "
                      f"({json.dumps(r['collectives'])})", flush=True)
        one = one["memory"]
        check(one["argument_size"] == arg_bytes13,
              f"phase 14 (d): argument bytes {one['argument_size']} against "
              f"phase 13 (a)'s state and batch, {arg_bytes13}")
        pred = one["argument_size"] + one["temp_size"]
        print(f"phase 14 (d) {LM_ARCH} B={TRAIN_B} x S={TRAIN_S}, remat, one "
              f"rank: arguments {one['argument_size']} bytes = phase 13 "
              f"(a)'s state and batch; predicted peak (arguments + temp) "
              f"{pred / 2 ** 30:.3f} GiB beside phase 11 (b)'s measured peak "
              f"{peak11 / 2 ** 30:.3f} GiB (gap "
              f"{(pred - peak11) / 2 ** 30:+.3f} GiB, not checked)",
              flush=True)
    finally:
        phase14_stop(proc)
        shutil.rmtree(out, ignore_errors=True)
    print(f"phase 14: waited {time.perf_counter() - t:.1f} s after phase 13",
          flush=True)


def phase12(torch, dev, fk, Xtr, ytr, Xte, snap_bytes64):
    """Phase 12: (a) float32 factors on the card — the acceptance forest of
    phase 1 as a ``ForestKernel(dtype=np.float32)``, counted: its factors,
    every op cold and warm against phase 1's float64 kernel and against
    the port's CPU float32 engine on a stated subset of rows, its engine
    bytes, a snapshot round trip and a ``ProximityServer``; then K2's
    float32 forms against each other, their plain version, float64's
    forms and cuSPARSE at 512 x 50,000 x 100 and at a serving tick.  (b)
    the engine's sharded product on grids of cuda:0 against the segment
    product.  Returns the float32 K2 numbers of the kernels line and the
    path's launches."""
    from repro_torch.core import torch_ops
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.factorization import factor_digest
    from repro_torch.kernels.block_prox.ops import block_prox
    from repro_torch.kernels.block_prox.ref import block_prox_ref
    from repro_torch.kernels.collide.ops import (collide_enumerate,
                                                 pair_sums, pair_topk)
    from repro_torch.kernels.histogram.ops import histogram, moments
    from repro_torch.kernels.leaf_route.ops import route
    from repro_torch.kernels.row_topk.ops import row_topk
    from repro_torch.obs.metrics import global_registry
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _f32_contract import RTOL_F32, decided_rows
    t12 = time.perf_counter()
    eng = fk.engine
    Xq, rows = Xte[:TOPK_ROWS], np.arange(BLOCK_ROWS)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    check(not tf32, "float32 GEMMs would run in TF32")
    # phase 1's kernel's float64 results (K(+1) top-k values for the tie
    # rule), before the float32 path's counts start
    base = {
        "predict_train": eng.predict(ytr, N_CLASSES),
        "predict_oos": eng.predict(ytr, N_CLASSES, X=Xte),
        "topk_oos": eng.topk(K + 1, X=Xq),
        "kernel_block": eng.kernel_block(rows),
        "squared_row_sums_oos": eng.squared_row_sums(ytr, N_CLASSES, X=Xte),
        "row_sums": eng.row_sums(),
        "topk_train": eng.topk(K + 1),
        "squared_row_sums_train": eng.squared_row_sums(ytr, N_CLASSES)}
    torch.cuda.synchronize()

    # ---- (a) the float32 path, counted ----
    counters = {"leaf_route": route, "block_prox": block_prox,
                "histogram": histogram, "moments": moments,
                "row_topk": row_topk, "pair_topk": pair_topk,
                "pair_sums": pair_sums,
                "collide_enumerate": collide_enumerate}
    for f in counters.values():
        f.launches = 0
    block_prox.launches_f32 = 0
    t = time.perf_counter()
    fk32 = ForestKernel(model_type="rf", kernel_method="gap",
                        n_trees=N_TREES, n_bins=64, seed=0, device="cuda",
                        dtype=np.float32)
    fk32.forest = fk.forest
    fk32.build_kernel_cache()
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t
    e32 = fk32.engine
    check(e32.q.dtype == e32.w.dtype == torch.float32, "factors not float32")
    check(torch.equal(eng.q.to(torch.float32), e32.q)
          and torch.equal(eng.w.to(torch.float32), e32.w),
          "float32 factors are not the float64 ones rounded once")
    calls = {
        "predict_train": lambda: e32.predict(ytr, N_CLASSES),
        "predict_oos": lambda: e32.predict(ytr, N_CLASSES, X=Xte),
        "topk_oos": lambda: fk32.topk(k=K, X=Xq),
        "kernel_block": lambda: fk32.kernel_block(rows),
        "squared_row_sums_oos": lambda: e32.squared_row_sums(
            ytr, N_CLASSES, X=Xte),
        "row_sums": lambda: fk32.row_sums(),
        "topk_train": lambda: fk32.topk(k=K),
        "squared_row_sums_train": lambda: e32.squared_row_sums(ytr,
                                                              N_CLASSES)}
    out32, cold, warm = {}, {}, {}
    for name, fn in calls.items():
        t = time.perf_counter()
        out32[name] = fn()
        torch.cuda.synchronize()
        cold[name] = time.perf_counter() - t
        times = []
        for _ in range(WARM_REPS):
            if name == "row_sums":
                e32._train_row_sums = None        # cached after a call
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        warm[name] = float(np.median(times))

    # the snapshot round trip and the CPU float32 engine (loaded from it)
    with tempfile.TemporaryDirectory() as snap_dir:
        path = os.path.join(snap_dir, "acceptance32.npz")
        t = time.perf_counter()
        manifest = fk32.save(path)
        save_s = time.perf_counter() - t
        snap_bytes = os.path.getsize(path)
        t = time.perf_counter()
        lk = ForestKernel.load(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        hk = ForestKernel.load(path, device="cpu")
    check(manifest["config"]["dtype"] == "float32", "archive dtype")
    check(lk.engine.dtype == np.float32 and torch.equal(lk.engine.q, e32.q)
          and torch.equal(lk.engine.w, e32.w), "loaded float32 factors")
    check(factor_digest(lk.engine.gl, lk.engine.q, lk.engine.w)
          == manifest["factor_digest"], "loaded factor digest")
    check(torch.equal(lk.kernel_block(rows), out32["kernel_block"])
          and all(torch.equal(a, b) for a, b in zip(
              lk.topk(k=K, X=Xq), out32["topk_oos"])),
          "loaded float32 kernel's blocks or top-k differ")
    del lk

    # a ProximityServer over the float32 kernel: 64 seeded requests
    rng12 = np.random.default_rng(12)
    kinds = rng12.choice(("predict", "topk", "outlier"), size=64,
                         p=(0.5, 0.3, 0.2))
    sizes = rng12.integers(1, 17, size=64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    check(offs[-1] <= len(Xte), "serving rows exceed the OOS batch")
    reqs = [(str(kd), Xte[offs[i]:offs[i + 1]]) + ((K,) if kd == "topk"
                                                   else ())
            for i, kd in enumerate(kinds)]
    srv = fk32.serve(n_slots=SERVE_SLOTS)
    t = time.perf_counter()
    res = srv.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = {k: f.launches for k, f in counters.items()}
    launches_f32 = block_prox.launches_f32
    print(f"phase 12 (a) float32 path launches {LAUNCHES} (K2 float64): "
          f"{'/'.join(str(v) for v in launches.values())}, K2 float32 "
          f"{launches_f32}", flush=True)
    check(launches_f32 > 0, "K2's float32 form was not launched")
    check(launches["block_prox"] == 0, "the float32 path launched K2 f64")
    check(launches["row_topk"] > 0, "the float32 path's top-k did not "
          "launch row_topk")

    # checks: against phase 1's float64 results, then the CPU engine
    from repro_torch.applications.outliers import oos_outlier_scores
    tol = {}

    def rel(a, b):
        """max |a - b| over max |b| (a, b tensors or arrays)."""
        a = a.detach().double().cpu().numpy() if hasattr(a, "detach") \
            else np.asarray(a, np.float64)
        b = b.detach().double().cpu().numpy() if hasattr(b, "detach") \
            else np.asarray(b, np.float64)
        check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    undecided = {}
    for name, got in out32.items():
        want = base[name]
        if name.startswith("topk"):
            (gi, gv), (wi, wv) = got, want
            check(gv.dtype == torch.float64 and gi.dtype == torch.int64,
                  f"{name} dtypes")
            tol[name] = rel(gv, wv[:, :K])
            ok = decided_rows(wv, K, RTOL_F32 * float(wv[:, 0].max()))
            check(torch.equal(gi[torch.as_tensor(ok, device=dev)],
                              wi[:, :K][torch.as_tensor(ok, device=dev)]),
                  f"{name}: ids differ from float64 on decided rows")
            undecided[name] = int((~ok).sum())
        else:
            check(got.dtype == torch.float32, f"{name} is not float32")
            tol[name] = rel(got, want)
    for name, e in tol.items():
        check(e <= RTOL_F32, f"float32 {name} off float64 by {e}")

    # the CPU float32 engine on the same factors: products on every row,
    # blocks on CHECK_ROWS_F32 OOS and training rows
    n = CHECK_ROWS_F32
    he = hk.engine
    Xs = np.ascontiguousarray(Xte[:n])
    blk_tr = he.kernel_block(np.arange(n))
    onehot = torch.zeros((he.n_ref, N_CLASSES), dtype=torch.float32)
    onehot[torch.arange(he.n_ref), torch.as_tensor(ytr)] = 1.0
    hi, hv = he.topk(K + 1, X=Xs)
    host = {
        "predict_train": (out32["predict_train"], he.predict(ytr,
                                                             N_CLASSES)),
        "predict_oos": (out32["predict_oos"][:n],
                        he.predict(ytr, N_CLASSES, X=Xs)),
        "row_sums": (out32["row_sums"], he.row_sums()),
        "kernel_block": (out32["kernel_block"][:n], blk_tr),
        "squared_row_sums_oos": (out32["squared_row_sums_oos"][:n],
                                 he.squared_row_sums(ytr, N_CLASSES, X=Xs)),
        "squared_row_sums_train": (out32["squared_row_sums_train"][:n],
                                   (blk_tr * blk_tr) @ onehot),
        "topk_oos": (out32["topk_oos"][1][:n], hv[:, :K]),
        "topk_train": (out32["topk_train"][1][:n], torch.sort(
            blk_tr, dim=1, descending=True).values[:, :K].double())}
    herr = {}
    for name, (a, b) in host.items():
        check(a.dtype == b.dtype, f"{name}: card {a.dtype}, CPU {b.dtype}")
        herr[name] = rel(a, b)
        check(herr[name] <= RTOL_F32, f"float32 {name} off the CPU engine "
              f"by {herr[name]}")
    ok = decided_rows(hv, K, RTOL_F32 * float(hv[:, 0].max()))
    check(np.array_equal(out32["topk_oos"][0][:n].cpu().numpy()[ok],
                         hi[:, :K].numpy()[ok]),
          "topk_oos ids differ from the CPU engine on decided rows")

    # served answers against direct calls on the float32 engine
    serr, near = 0.0, 0
    for (kind, Xr, *_), got in zip(reqs, res):
        Xr = np.ascontiguousarray(Xr)
        if kind == "predict":
            sc = e32.predict(ytr, N_CLASSES, X=Xr)
            top2 = torch.topk(sc, 2, dim=1).values
            tie = (top2[:, 0] - top2[:, 1]
                   <= RTOL_F32 * top2[:, 0]).cpu().numpy()
            diff = got["labels"] != sc.argmax(1).cpu().numpy()
            check(not (diff & ~tie).any(), "served float32 predict labels")
            near += int(tie.sum())
        elif kind == "topk":
            i_, v_ = (t.cpu().numpy() for t in e32.topk(k=K, X=Xr))
            check(np.array_equal(got["indices"], i_),
                  "served float32 topk ids")
            serr = max(serr, float(np.abs(got["values"] - v_).max()))
        else:
            want = oos_outlier_scores(e32, ytr, Xr).cpu().numpy()
            serr = max(serr, float(np.abs(got["scores"] - want).max()
                                   / max(np.abs(want).max(), 1e-300)))
    check(serr <= RTOL_F32, f"served float32 answers off by {serr}")
    m32, m64 = e32.memory_bytes(), eng.memory_bytes()
    check(m32["dense_factors"] < m64["dense_factors"], "float32 bytes")
    print(f"phase 12 (a) float32 kernel from phase 1's forest: cache "
          f"{cache_s:.3f} s; factors = float64 rounded once; TF32 "
          f"{'on' if tf32 else 'off'}; ops (cold s / warm s, error vs "
          f"float64 / vs the CPU float32 engine on {n} rows of the blocks): "
          + ", ".join(f"{k} {cold[k]:.4f} / {warm[k]:.4f} ({tol[k]:.1e} / "
                      f"{herr[k]:.1e})" for k in calls)
          + f"; top-k rows with values within {RTOL_F32:g} of the next "
          f"(ids not compared): {undecided}", flush=True)
    print(f"phase 12 (a) engine bytes float32 / float64: " + ", ".join(
        f"{k} {m32[k]} / {m64[k]}" for k in ("dense_factors", "Q", "W",
                                              "leaf_index", "total")),
          flush=True)
    print(f"phase 12 (a) snapshot: save {save_s:.3f} s, load {load_s:.3f} "
          f"s, archive {snap_bytes} bytes (float64 {snap_bytes64}); bits "
          f"equal; server: 64 requests in {serve_s:.3f} s, answers equal "
          f"to direct calls (values within {serr:.1e}; {near} predict rows "
          f"at a top-two near-tie)", flush=True)

    # K2's float32 forms at 512 x 50,000 x 100 and at a serving tick,
    # beside float64's (same call, interleaved); not counted
    index32, index64 = e32.leaf_index(), eng.leaf_index()
    tick32, tick64 = e32.query_state(Xte[:64]), eng.query_state(Xte[:64])
    cases = {f"{BLOCK_ROWS}x{N_TRAIN}": ((e32.gl[:BLOCK_ROWS],
                                          e32.q[:BLOCK_ROWS]),
                                         (eng.gl[:BLOCK_ROWS],
                                          eng.q[:BLOCK_ROWS])),
             f"tick 64x{N_TRAIN}": ((tick32.gl, tick32.q),
                                    (tick64.gl, tick64.q))}
    k2 = {}
    for name, ((g32, q32), (g64, q64)) in cases.items():
        leaf = block_prox(g32, q32, e32.gl, e32.w, index=index32)
        dense = block_prox(g32, q32, e32.gl, e32.w)
        check(torch.equal(leaf.view(torch.int32), dense.view(torch.int32)),
              f"K2 float32 ({name}): leaf and dense forms differ")
        plain = block_prox_ref(g32, q32, e32.gl, e32.w)
        err = max_err(leaf, plain)
        check(err <= RTOL_F32 * float(plain.abs().max()),
              f"K2 float32 ({name}) off its plain version by {err}")
        ms = {
            "f64 leaf": cuda_ms(torch, lambda: block_prox(
                g64, q64, eng.gl, eng.w, index=index64), 10),
            "f32 leaf": cuda_ms(torch, lambda: block_prox(
                g32, q32, e32.gl, e32.w, index=index32), 10),
            "f32 dense": cuda_ms(torch, lambda: block_prox(
                g32, q32, e32.gl, e32.w), 10),
            "f64 dense": cuda_ms(torch, lambda: block_prox(
                g64, q64, eng.gl, eng.w), 10)}
        k2[name] = (err, ms, leaf)
    g32, q32 = cases[f"{BLOCK_ROWS}x{N_TRAIN}"][0]
    plain_ms = cuda_ms(torch, lambda: block_prox_ref(g32, q32, e32.gl,
                                                     e32.w), 2)
    W32 = hk.engine.W
    W_dev = torch.sparse_csr_tensor(
        torch.as_tensor(W32.indptr, dtype=torch.int64),
        torch.as_tensor(W32.indices, dtype=torch.int64),
        torch.as_tensor(W32.data), size=W32.shape, device=dev)
    QrT = torch.as_tensor(hk.engine.Q[rows].toarray().T.copy(), device=dev)
    check(QrT.dtype == torch.float32, "SpMM operand not float32")
    lib_out = torch.sparse.mm(W_dev, QrT).t()
    lib_err = max_err(lib_out, k2[f"{BLOCK_ROWS}x{N_TRAIN}"][2])
    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(W_dev, QrT), 10)
    terms, _, read32 = k2_bound(torch, index32, g32, q32, FP32_S / 2)
    bound_by = max(terms, key=terms.get)
    print("phase 12 (a) K2 ms a call (f64 leaf / f32 leaf / f32 dense / "
          "f64 dense), float32 forms the same bits: " + ", ".join(
              f"{k} {v[1]['f64 leaf']:.4f} / {v[1]['f32 leaf']:.4f} / "
              f"{v[1]['f32 dense']:.4f} / {v[1]['f64 dense']:.4f} (err vs "
              f"plain {v[0]:.1e})" for k, v in k2.items())
          + f"; plain float32 {plain_ms:.3f} ms, cuSPARSE SpMM float32 "
          f"{lib_ms:.3f} ms (err {lib_err:.1e}), bound "
          f"{terms[bound_by] * 1e3:.4f} ms by {bound_by} (index "
          f"{index32.nbytes} bytes, {read32} of them reached by these "
          f"queries; float64's {index64.nbytes})",
          flush=True)
    del hk, he, blk_tr, out32, base

    # ---- (b) the sharded product on grids of cuda:0 ----
    real = torch_ops.default_mesh
    rng = np.random.default_rng(13)
    sh = {}
    sharded_calls = global_registry().counter(
        "engine_op_calls_total", "engine op invocations",
        labels=("op", "backend", "tier")).labels(
        op="sharded_matmat", backend=dev.type, tier="")
    calls_before = sharded_calls.value
    for C in (7, 64):
        V = torch.as_tensor(rng.normal(size=(N_TRAIN, C)), device=dev)
        seg = eng.matmat(V)
        check(eng.last_matmat_path == "segment",
              "one card: the engine did not take the segment path")
        # the segment product with its bucket table built every call, as
        # the sharded path builds its tables (the engine caches a narrow
        # V's table)
        seg_ms = cuda_ms(torch, lambda: torch_ops.swlc_matmat(
            eng.gl, eng.q, eng.w, V, eng.total_leaves, eng._t_chunk(C)), 3)
        sh[(C, "segment")] = (0.0, seg_ms, None)
        try:
            for dp, mp in ((1, 1), (2, 1), (1, 2), (2, 2)):
                grid = np.empty((dp, mp), dtype=object)
                for a in range(dp):
                    for b in range(mp):
                        grid[a, b] = dev
                torch_ops.default_mesh = lambda: grid
                got = eng.matmat(V)
                check(eng.last_matmat_path == "sharded",
                      f"grid {dp}x{mp}: the engine did not shard")
                err = max_err(got, seg)
                check(err <= 1e-12, f"sharded {dp}x{mp} x {C} off the "
                      f"segment product by {err}")
                c = torch_ops.auto_c_chunk(N_TRAIN // dp, N_TREES, C)
                sh[(C, f"{dp}x{mp}")] = (
                    err, cuda_ms(torch, lambda: eng.matmat(V), 3), c)
        finally:
            torch_ops.default_mesh = real
    n_obs = sharded_calls.value - calls_before
    check(n_obs > 0, "sharded calls were not observed")
    print("phase 12 (b) engine matmat on grids of cuda:0 (ms a call, err "
          "vs the segment product, auto_c_chunk columns): " + ", ".join(
              f"{C} cols {g} {ms:.3f} ({err:.1e}, c={c})"
              for (C, g), (err, ms, c) in sh.items())
          + f"; {int(n_obs)} sharded_matmat calls observed", flush=True)
    print(f"phase 12 wall: {time.perf_counter() - t12:.1f} s", flush=True)
    return {"launches": launches, "launches_f32": launches_f32,
            "max_abs_err": max(v[0] for v in k2.values()),
            "ms": k2[f"{BLOCK_ROWS}x{N_TRAIN}"][1]["f32 leaf"],
            "plain_ms": plain_ms, "bound_ms": terms[bound_by] * 1e3,
            "bound_by": bound_by, "library_ms": lib_ms}

def row_topk_times(torch, dev):
    """The row top-k kernel at the engine's block (320 x 100,000) in
    float64 and float32 and at a 64-row serving tick, on dense random rows
    (every entry distinct: a booster's blocks) and on sparse rows (1% of the
    columns nonzero, the rest tied at 0: a deep forest's), k = 10: bit for
    bit against its plain version, timed beside the plain version,
    ``torch.topk`` (the library call it replaced) and one read of the block
    at the HBM rate."""
    from repro_torch.kernels.row_topk.ops import row_topk
    from repro_torch.kernels.row_topk.ref import row_topk_ref
    k, n = 10, 100_000
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    res = {}
    for rows, dt in ((320, torch.float64), (320, torch.float32),
                     (64, torch.float64)):
        dense = torch.rand((rows, n), generator=g, device=dev,
                           dtype=torch.float64).to(dt)
        sparse = torch.where(torch.rand((rows, n), generator=g, device=dev)
                             < 0.01, dense, torch.zeros((), dtype=dt,
                                                        device=dev))
        for kind, B in (("dense", dense), ("sparse", sparse)):
            idx, val = row_topk(B, k)
            want = row_topk_ref(B, k)
            check(torch.equal(idx, want[0]) and torch.equal(val, want[1]),
                  f"row_topk {rows}x{n} {dt} {kind}: not the plain version")
            lib = torch.topk(B, k, dim=1).values.double()
            check(torch.equal(lib, val), f"row_topk {rows}x{n} {dt} "
                  f"{kind}: not torch.topk's values")
            res[(rows, str(dt)[6:], kind)] = {
                "ms": cuda_ms(torch, lambda: row_topk(B, k), 20),
                "plain_ms": cuda_ms(torch, lambda: row_topk_ref(B, k), 2),
                "library_ms": cuda_ms(torch, lambda: torch.topk(B, k, dim=1),
                                      20),
                "bound_ms": (B.numel() * B.element_size() + rows * k * 16)
                / HBM_BYTES_S * 1e3}
        del dense, sparse, B
    print("row_topk k=10 (ms: kernel / plain / torch.topk / one-read "
          "bound): " + "; ".join(
              f"{r}x{n} {dt} {kind} {v['ms']:.4f} / {v['plain_ms']:.3f} / "
              f"{v['library_ms']:.4f} / {v['bound_ms']:.4f}"
              for (r, dt, kind), v in res.items()), flush=True)
    return res


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
    from repro_torch.data.synthetic import (friedman1, gaussian_classes,
                                            train_test_split)
    from repro_torch.forest.ensemble import ExtraTrees, RandomForest
    from repro_torch.forest.trees import TreeArrays
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_prox.ops import block_prox, build_leaf_index
    from repro_torch.kernels.block_prox.ref import block_prox_ref
    from repro_torch.kernels.histogram import ops as h_ops
    from repro_torch.kernels.histogram.ops import (histogram, moments,
                                                   work_items)
    from repro_torch.kernels.histogram.ref import (histogram_ordered,
                                                   histogram_ref,
                                                   moments_ordered,
                                                   moments_ref)
    from repro_torch.kernels.leaf_route.ops import route, route_tables
    from repro_torch.kernels.leaf_route.ref import route_ref
    from repro_torch.kernels.collide.ops import (collide_enumerate,
                                                 pair_sums, pair_topk)
    from repro_torch.kernels.row_topk.ops import row_topk
    from repro_torch.obs.metrics import global_registry
    wrappers = {"leaf_route": route, "block_prox": block_prox,
                "histogram": histogram, "moments": moments,
                "row_topk": row_topk, "pair_topk": pair_topk,
                "pair_sums": pair_sums,
                "collide_enumerate": collide_enumerate}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 14 starts: the dry runs, on the host, in the background ----
    dry_out, dry_proc = phase14_start()

    # ---- phase 0: build every kernel, in parallel ----
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, rep in sorted(reports.items()):
        seen = set()
        for line in rep.splitlines():
            line = line.strip()
            if ("registers" in line or "spill" in line or "smem" in line) \
                    and line not in seen:
                seen.add(line)
                print(f"  ptxas {name}: {line}")

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
        before = {k: f.launches for k, f in wrappers.items()}
        out = step(name, fn)
        per_step[name] = "/".join(str(f.launches - before[k])
                                  for k, f in wrappers.items())
        return out

    def reset_counts():
        for f in wrappers.values():
            f.launches = 0

    def read_counts():
        return {k: f.launches for k, f in wrappers.items()}

    reset_counts()
    fk = ForestKernel(model_type="rf", kernel_method="gap", n_trees=N_TREES,
                      n_bins=64, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    counted("fit_forest", lambda: fk.fit_forest(Xtr, ytr))
    fit_peak = torch.cuda.max_memory_allocated()
    counted("build_kernel_cache", fk.build_kernel_cache)
    pred_tr = counted("predict_train", fk.predict)
    pred_te = counted("predict_oos", lambda: fk.predict(Xte))
    dense_rows = global_registry().counter(
        "engine_topk_rows_total",
        "query rows top-k selected from dense blocks").labels()
    collide_rows = global_registry().counter(
        "engine_collide_rows_total",
        "query rows served on the collision path").labels()
    kr0, rl0 = dense_rows.value, row_topk.launches
    top_idx, top_val = counted("topk_oos", lambda: fk.topk(k=K, X=Xq))
    kr_oos, rl_oos = dense_rows.value - kr0, row_topk.launches - rl0
    blk = counted("kernel_block", lambda: fk.kernel_block(rows))
    srs = counted("squared_row_sums_oos", lambda: fk.engine.squared_row_sums(
        ytr, n_classes=N_CLASSES, X=Xte))
    rsum = counted("row_sums", fk.row_sums)
    # all-pairs jobs over the training set: 50k x 50k through K2 row
    # blocks, or over leaf collisions where the engine's rule picks them
    kr0, cr0, rl0 = dense_rows.value, collide_rows.value, row_topk.launches
    tr_idx, tr_val = counted("topk_train", lambda: fk.topk(k=K))
    kr_train, cr_train = dense_rows.value - kr0, collide_rows.value - cr0
    rl_train = row_topk.launches - rl0
    collides = fk.engine.collision_mode()
    srs_tr = counted("squared_row_sums_train",
                     lambda: fk.engine.squared_row_sums(ytr, N_CLASSES))
    launches = read_counts()
    print(f"main path (s, {LAUNCHES} launches): " + ", ".join(
        f"{k} {v:.3f} ({per_step[k]})" for k, v in wall.items())
        + f"; launches {launches}", flush=True)
    for name in ("leaf_route", "block_prox", "histogram", "row_topk"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    # the train-side top-k and class sums: on dense blocks, or through the
    # collision-pair kernels where the engine's rule picks that path
    for name in ("pair_topk", "pair_sums", "collide_enumerate"):
        check((launches[name] > 0) == collides,
              f"{name} launched {launches[name]} times on the main path, "
              f"its train-side path {'collision' if collides else 'dense'}")
    print(f"main path rows top-k selected from dense blocks "
          f"(engine_topk_rows_total) and row_topk launches: topk_oos "
          f"{kr_oos:.0f} ({rl_oos}), topk_train {kr_train:.0f} "
          f"({rl_train}); rows served on the collision path "
          f"(engine_collide_rows_total): topk_train {cr_train:.0f}; "
          f"collision share {fk.engine.collision_share():.5f}, train-side "
          f"path {'collision' if collides else 'dense blocks'}", flush=True)
    want_kr, want_cr = (0, N_TRAIN) if collides else (N_TRAIN, 0)
    check(kr_oos == TOPK_ROWS and kr_train == want_kr
          and cr_train == want_cr,
          f"dense blocks gave {kr_oos}/{kr_train} rows and the collision "
          f"path served {cr_train} of the main path's top-k, not "
          f"{TOPK_ROWS}/{want_kr} and {want_cr}")
    check(rl_oos > 0 and (rl_train > 0) != collides,
          f"row_topk launched {rl_oos}/{rl_train} times for the main "
          f"path's top-k, its train-side path "
          f"{'collision' if collides else 'dense'}")
    check(launches["moments"] == 0, "a classification fit launched K4")
    print(f"engine device memory: {fk.engine.memory_bytes()}", flush=True)
    levels = max(t.depth for t in fk.forest.trees_)
    print(f"card fit: {wall['fit_forest']:.3f} s, {levels} levels, "
          f"{per_step['fit_forest']} launches, peak device memory "
          f"{fit_peak / 2 ** 30:.3f} GiB", flush=True)

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

    # ---- phase 3: the trainer on the card against the host trainer ----
    host = ForestKernel(model_type="rf", kernel_method="gap", n_trees=N_TREES,
                        n_bins=64, seed=0, device="cuda", tree_backend="numpy")
    step("host_fit_forest", lambda: host.fit_forest(Xtr, ytr))
    same_trees(fk.forest.trees_, host.forest.trees_, "acceptance forest")
    from repro_torch.forest import training

    def split_fit(name, fn):
        """``step`` with the trainer's histogram calls (K3/K4 and their
        wrapper) and its device scoring (uploads of the draws included)
        timed to completion; the rest is the host driver (partition, RNG,
        split decisions, frontier uploads)."""
        split = {"histogram calls": 0.0, "device scoring": 0.0}

        def timed(f, key):
            def run(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = f(*a, **k)
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t
                return out
            return run

        hops, score = training.hops, training._score_torch
        training.hops = types.SimpleNamespace(
            histogram=timed(histogram, "histogram calls"),
            moments=timed(moments, "histogram calls"))
        training._score_torch = timed(score, "device scoring")
        try:
            out = step(name, fn)
        finally:
            training.hops, training._score_torch = hops, score
        split["host driver"] = wall[name] - sum(split.values())
        return out, ", ".join(f"{k} {v:.3f} s" for k, v in split.items())

    def card_rf():
        return RandomForest(n_trees=N_TREES, n_bins=64, seed=0,
                            device="cuda").fit(Xtr, ytr)
    again, parts = split_fit("card fit, timed parts", card_rf)
    same_trees(fk.forest.trees_, again.trees_, "second card fit")
    # the device's own view, from a third fit under torch.profiler (which
    # slows the host, so its wall time is not used)
    third, fit_kernels, _ = device_kernels(torch, card_rf)
    same_trees(fk.forest.trees_, third.trees_, "profiled card fit")
    busy = sum(fit_kernels.values()) / 1e3
    print(f"card fit {wall['fit_forest']:.3f} s vs host numpy fit "
          f"{wall['host_fit_forest']:.3f} s, trees identical; a second card "
          f"fit {wall['card fit, timed parts']:.3f} s: {parts}; device "
          f"kernels of a third (profiled) fit {busy:.3f} s, K3 "
          f"{hist_kernel_ms(fit_kernels) / 1e3:.3f} s, so the device idles "
          f"{1 - busy / wall['card fit, timed parts']:.3f} of the second "
          f"fit", flush=True)
    # integer targets keep the (w, w·y, w·y²) moments exact in float32
    Xr = np.random.default_rng(3).random((N_TRAIN, D))
    yr = np.floor(Xr[:, 0] * 5 + Xr[:, 1] * 3)
    for name, make in (("extra trees", lambda b: ExtraTrees(
            n_trees=N_ET_TREES, seed=0, device="cuda", tree_backend=b)
            .fit(Xtr, ytr)),
            ("integer regression", lambda b: RandomForest(
                n_trees=N_REG_TREES, seed=0, task="regression",
                device="cuda", tree_backend=b).fit(Xr, yr))):
        card, parts = split_fit(f"{name} card", lambda: make("auto"))
        hostf = step(f"{name} host", lambda: make("numpy"))
        same_trees(card.trees_, hostf.trees_, name)
        print(f"{name}: card {wall[name + ' card']:.3f} s ({parts}), host "
              f"{wall[name + ' host']:.3f} s, trees identical", flush=True)

    # ---- phase 4: the gradient-boosting path, counted ----
    Xg, yg = friedman1(N_GBT + N_GBT_OOS, d=D, seed=0)
    Xg_tr, yg_tr, Xg_te, yg_te = train_test_split(
        Xg, yg, test_frac=N_GBT_OOS / (N_GBT + N_GBT_OOS), seed=0)
    check(len(Xg_tr) == N_GBT, "GBT split sizes")
    gkw = dict(model_type="gbt", task="regression", kernel_method="boosted",
               n_trees=GBT_STAGES, max_depth=GBT_DEPTH, seed=0)
    reset_counts()
    gk = ForestKernel(device="cuda", **gkw)
    counted("gbt fit_forest", lambda: gk.fit_forest(Xg_tr, yg_tr))
    counted("gbt build_kernel_cache", gk.build_kernel_cache)
    g_pred_tr = counted("gbt predict_train", gk.predict)
    g_pred_te = counted("gbt predict_oos", lambda: gk.predict(Xg_te))
    g_rs = counted("gbt row_sums_oos", lambda: gk.row_sums(Xg_te))
    g_blk = counted("gbt kernel_block", lambda: gk.kernel_block(rows))
    g_idx, g_val = counted("gbt topk_oos", lambda: gk.topk(k=K, X=Xg_te))
    gbt_launches = read_counts()
    print(f"GBT path (s, {LAUNCHES} launches): " + ", ".join(
        f"{k} {wall[k]:.3f} ({per_step[k]})" for k in per_step
        if k.startswith("gbt")) + f"; launches {gbt_launches}", flush=True)
    for name in ("leaf_route", "block_prox", "moments", "row_topk"):
        check(gbt_launches[name] > 0, f"{name} was not launched on the GBT "
              "path")
    check(gbt_launches["histogram"] == 0, "a regression fit launched K3")
    check(gbt_launches["pair_topk"] == gbt_launches["pair_sums"]
          == gbt_launches["collide_enumerate"] == 0,
          "the GBT path left dense blocks for the collision path")
    ge = gk.engine
    Y2 = np.stack([yg_tr, np.ones(N_GBT)], axis=1)
    S2 = np.asarray(ge.W.T @ Y2)
    gdiag = np.asarray(ge.Q.multiply(ge.W).sum(axis=1)).ravel()
    h_tr = np.asarray(ge.Q @ S2) - gdiag[:, None] * Y2
    Qg_te = gk.query_map(Xg_te)
    h_te = np.asarray(Qg_te @ S2)
    gerrs = {
        "gbt_predict_train": max_err(g_pred_tr, h_tr[:, 0] / np.maximum(
            h_tr[:, 1], 1e-300)),
        "gbt_predict_oos": max_err(g_pred_te, h_te[:, 0] / np.maximum(
            h_te[:, 1], 1e-300)),
        "gbt_row_sums_oos": max_err(g_rs, np.asarray(
            Qg_te @ (ge.W.T @ np.ones(N_GBT)))),
        "gbt_kernel_block": max_err(g_blk, kernel_block(ge.Q, ge.W, rows)),
        "gbt_topk_oos_values": max_err(g_val, topk_neighbors(
            Qg_te, ge.W, K)[1]),
    }
    for name, e in gerrs.items():
        print(f"  {name}: max abs err {e:.3e}")
        check(e <= ATOL_OPS, f"{name} error {e} > {ATOL_OPS}")
    g_host = ForestKernel(device="cuda", tree_backend="numpy", **gkw)
    step("gbt host fit", lambda: g_host.fit_forest(Xg_tr, yg_tr))
    gbt_gap = float((gk.forest.predict(Xg_tr) - g_host.forest.predict(Xg_tr))
                    .abs().max())
    check(gbt_gap <= 0.05 * yg_tr.std(),
          f"card GBT vs host GBT {gbt_gap} > 0.05 y.std")
    g_again = ForestKernel(device="cuda", **gkw)
    _, g_parts = split_fit("gbt card fit again",
                           lambda: g_again.fit_forest(Xg_tr, yg_tr))
    same_trees(gk.forest.trees_, g_again.forest.trees_, "GBT refit")
    gbt_rmse = float(((g_pred_te.cpu().numpy() - yg_te) ** 2).mean() ** .5)
    print(f"GBT: card fit {wall['gbt fit_forest']:.3f} s, host fit "
          f"{wall['gbt host fit']:.3f} s, max |card - host| prediction "
          f"{gbt_gap:.3e} (limit {0.05 * yg_tr.std():.4f}), refit "
          f"bit-identical ({wall['gbt card fit again']:.3f} s: {g_parts}); "
          f"OOS proximity-prediction RMSE {gbt_rmse:.4f} "
          f"(y.std {yg_te.std():.4f})", flush=True)

    # ---- phase 5: the serving ops warm ----
    warm_ops = {
        "predict_oos": lambda: fk.predict(Xte),
        "topk_oos": lambda: fk.topk(k=K, X=Xq),
        "kernel_block": lambda: fk.kernel_block(rows),
        "squared_row_sums_oos": lambda: fk.engine.squared_row_sums(
            ytr, n_classes=N_CLASSES, X=Xte),
        "topk_train": lambda: fk.topk(k=K),
        "squared_row_sums_train": lambda: fk.engine.squared_row_sums(
            ytr, N_CLASSES),
    }
    warm = {}
    for name, fn in warm_ops.items():
        times = []
        for _ in range(WARM_REPS):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        warm[name] = float(np.median(times))
    print(f"serving ops, s (cold: first call; warm: median of {WARM_REPS} "
          "later calls): " + ", ".join(
              f"{k} cold {wall[k]:.4f} warm {v:.4f}" for k, v in warm.items()),
          flush=True)

    # ---- phase 6: kernels against their plain versions ----
    forest = fk.forest
    tables = forest.route_tables_
    X_dev = torch.as_tensor(Xtr, dtype=torch.float64, device=dev)

    def route_plain(Xr, tb):
        return route_ref(Xr, *tb.flat(), tb.n_trees, tb.max_nodes)

    def k1_case(name, Xr, tb):
        """K1 bit-exact against its plain version; its ms a wrapper call
        and on the device (profiled)."""
        check(torch.equal(route(Xr, tb), route_plain(Xr, tb)),
              f"leaf_route != plain version ({name})")
        _, t, c = device_kernels(torch, lambda: [route(Xr, tb)
                                                 for _ in range(20)],
                                 "leaf_route")
        return (cuda_ms(torch, lambda: route(Xr, tb), 20),
                hist_call_ms(t, c, "leaf_route"))

    X_nan = X_dev.clone()
    X_nan[::7, 3] = float("nan")
    X_nan[1::11, 0] = float("nan")
    k1_case("acceptance, NaN features", X_nan, tables)
    Xte_dev = torch.as_tensor(Xte, dtype=torch.float64, device=dev)
    Xg_dev = torch.as_tensor(Xg_tr, dtype=torch.float64, device=dev)
    stage = gk.forest.trees_[0]
    stage_tb = route_tables(TreeArrays.from_trees([stage]), dev)
    k1_shapes = {  # name: (samples, tables, real nodes)
        f"{N_TRAIN}x{N_TREES}": (X_dev, tables,
                                 sum(t.n_nodes for t in forest.trees_)),
        f"{N_OOS}x{N_TREES}": (Xte_dev, tables,
                               sum(t.n_nodes for t in forest.trees_)),
        f"{N_GBT}x1 (GBT stage, depth {stage.depth})": (Xg_dev, stage_tb,
                                                        stage.n_nodes)}
    k1_times = {k: k1_case(k, Xr, tb) for k, (Xr, tb, _) in k1_shapes.items()}
    k1_ms = k1_times[f"{N_TRAIN}x{N_TREES}"][0]
    k1_plain_ms = cuda_ms(torch, lambda: route_plain(X_dev, tables), 3)

    # the depth-4 prefix of the acceptance forest (the prefix tier's
    # forest): its own records, routed by K1
    trunc = forest.truncated(PREFIX_DEPTH)
    k1_case(f"truncated depth {PREFIX_DEPTH}", Xte_dev, trunc.route_tables_)

    rng = np.random.default_rng(1)
    Xd = rng.normal(size=(20_000, D))
    yd = rng.integers(0, N_CLASSES, size=20_000)
    deep = RandomForest(n_trees=10, seed=1, device="cuda").fit(Xd, yd)
    dt = deep.route_tables_
    Xd_dev = torch.as_tensor(Xd, dtype=torch.float64, device=dev)
    k1_case("deep forest", Xd_dev, dt)
    deep_leaf = 20_000 / np.mean([t.n_leaves for t in deep.trees_])
    print(f"K1 bit-exact on the acceptance forest (M={tables.max_nodes}; "
          f"also with NaN features), its depth-{PREFIX_DEPTH} prefix "
          f"(M={trunc.route_tables_.max_nodes}), the deep forest "
          f"(M={dt.max_nodes}, {deep_leaf:.2f} samples a leaf) and a GBT "
          "stage", flush=True)

    # K2 in both forms on one engine's factors: the leaf-collision form on
    # its leaf index and the dense form, at the timed 512-row block and at
    # the 640-row train-side block; same bits, within ATOL_BLOCK of plain
    index = eng.leaf_index()
    idx_ms = cuda_ms(torch, lambda: build_leaf_index(
        eng.gl, eng.w, n_leaves=eng.total_leaves), 3)
    train_rows = eng._op_row_chunk(4096)

    def k2_case(name, e, gq, qq):
        """Both forms of K2 for query factors ``gq``/``qq`` against engine
        ``e``'s reference side: the leaf form within ATOL_BLOCK of the plain
        version and the same bits on a second launch and in the dense form.
        Returns (output, error, leaf ms, dense ms)."""
        ix = e.leaf_index()
        got = block_prox(gq, qq, e.gl, e.w, index=ix)
        err = max_err(got, block_prox_ref(gq, qq, e.gl, e.w))
        check(err <= ATOL_BLOCK, f"block_prox ({name}) error {err} > "
              f"{ATOL_BLOCK}")
        check(torch.equal(block_prox(gq, qq, e.gl, e.w, index=ix), got),
              f"block_prox ({name}) differs between two launches")
        check(torch.equal(block_prox(gq, qq, e.gl, e.w).view(torch.int64),
                          got.view(torch.int64)),
              f"block_prox ({name}): leaf and dense forms differ")
        return (got, err,
                cuda_ms(torch, lambda: block_prox(gq, qq, e.gl, e.w,
                                                  index=ix), 10),
                cuda_ms(torch, lambda: block_prox(gq, qq, e.gl, e.w), 10))

    dk = ForestKernel(kernel_method="gap", device="cuda")
    dk.forest = deep
    dk.build_kernel_cache()
    # the prefix tier (depth-4 leaves: the dense form) and the
    # prototype-compressed engine (the OOS batch against its 70 columns)
    pe6 = fk.prefix_engine(PREFIX_DEPTH)
    ce6 = fk.compress(n_prototypes=N_PROTOS, k=PROTO_K)
    qs_te = eng.query_state(Xte)
    k2_cases = {  # name: (engine, query rows' gl, q)
        f"acceptance {BLOCK_ROWS}": (eng, eng.gl[:BLOCK_ROWS],
                                     eng.q[:BLOCK_ROWS]),
        f"acceptance {train_rows}": (eng, eng.gl[:train_rows],
                                     eng.q[:train_rows]),
        f"deep forest {BLOCK_ROWS}": (dk.engine, dk.engine.gl[:BLOCK_ROWS],
                                      dk.engine.q[:BLOCK_ROWS]),
        f"GBT forest {BLOCK_ROWS}": (ge, ge.gl[:BLOCK_ROWS],
                                     ge.q[:BLOCK_ROWS]),
        f"prefix depth {PREFIX_DEPTH} {BLOCK_ROWS}": (
            pe6, pe6.gl[:BLOCK_ROWS], pe6.q[:BLOCK_ROWS]),
        f"compressed {N_OOS}x{ce6.n_ref}": (ce6, qs_te.gl, qs_te.q)}
    k2_res = {k: k2_case(k, *v) for k, v in k2_cases.items()}
    k2_out, _, k2_ms, k2_dense_ms = k2_res[f"acceptance {BLOCK_ROWS}"]
    k2_tr_ms = k2_res[f"acceptance {train_rows}"][2]
    k2_err = max(r[1] for r in k2_res.values())
    gl_q, q = eng.gl[:BLOCK_ROWS], eng.q[:BLOCK_ROWS]
    k2_plain_ms = cuda_ms(
        torch, lambda: block_prox_ref(gl_q, q, eng.gl, eng.w), 2)
    forms = {k: "leaf" if e.leaf_mode() else "dense"
             for k, (e, _, _) in k2_cases.items()}
    print("K2 leaf form vs dense form (ms, same bits; the engine's leaf "
          "density and the form it picks in brackets): " + ", ".join(
              f"{k} {r[2]:.4f} vs {r[3]:.4f} ({e._leaf_density:.5f}: "
              f"{forms[k]})" for (k, r), (e, _, _) in zip(
                  k2_res.items(), k2_cases.values())), flush=True)
    check(not pe6.leaf_mode(), "the prefix engine takes the leaf form")
    print(f"K2 leaf index of the acceptance engine: {index.nbytes} bytes "
          f"({index.col.numel()} members, {index.offs.shape[0]} leaves x "
          f"{index.n_ranges} column ranges of {index.range_w}), built in "
          f"{idx_ms:.3f} ms", flush=True)
    check(eng.leaf_mode(), "the acceptance engine takes the dense form")
    # share of the warm train-side steps: each runs its K2 row blocks,
    # unless the engine takes the collision path for them
    blocks_tr = -(-N_TRAIN // train_rows)
    path_tr = "none: the collision path" if eng.collision_mode() \
        else "dense blocks"
    print(f"K2 in the warm train-side steps ({path_tr}): "
          f"{blocks_tr} blocks x {k2_tr_ms:.4f} ms = "
          f"{blocks_tr * k2_tr_ms / 1e3:.4f} s against topk "
          f"{warm['topk_train']:.4f} s and squared_row_sums "
          f"{warm['squared_row_sums_train']:.4f} s", flush=True)
    # yardstick: cuSPARSE SpMM of W (CSR) with the dense rows of Q gives
    # P[rows, :]ᵀ in one PyTorch call
    W_dev = torch.sparse_csr_tensor(
        torch.as_tensor(W.indptr, dtype=torch.int64),
        torch.as_tensor(W.indices, dtype=torch.int64),
        torch.as_tensor(W.data), size=W.shape, device=dev)
    QrT = torch.as_tensor(Q[rows].toarray().T.copy(), device=dev)
    lib_err = max_err(torch.sparse.mm(W_dev, QrT).t(), k2_out)
    k2_lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(W_dev, QrT), 10)

    def modes(call, want, d, bins, chans, values, classes, bounds):
        """The kernel mode the wrapper picks for ``call`` and, run in the
        other mode (same bits), that mode's wrapper and device ms."""
        fold = h_ops.launch_plan(d, bins, chans, values, classes, 1,
                                 len(work_items(bounds)[0]),
                                 *h_ops._device_limits(dev.index))[0]
        keep = h_ops._FOLD_UNITS_PER_SM
        h_ops._FOLD_UNITS_PER_SM = 1 << 30 if fold else 0
        try:
            check(torch.equal(call(), want),
                  "the two kernel modes give different bits")
            ms = cuda_ms(torch, call, 10)
            _, t, c = device_kernels(torch, lambda: [call()
                                                     for _ in range(20)],
                                     "histogram_")
            return ("fold" if fold else "rank"), ms, hist_call_ms(t, c)
        finally:
            h_ops._FOLD_UNITS_PER_SM = keep

    # K3 at the acceptance forest's level-1 shape: every tree's root over
    # its in-bag rows (bootstrap counts as weights), through the whole code
    # matrix by row id, as the trainer calls it: with the node bounds and
    # the row ids' range from the host (``bounds=``), and, for comparison,
    # with device node ids (``node=``, the wrapper finds the bounds)
    inbag = forest.inbag_
    codes_np = forest.binner_.transform(Xtr)
    codes = torch.as_tensor(codes_np, device=dev)
    n_bins = forest.binner_.n_bins
    rows_np = [np.flatnonzero(inbag[t]) for t in range(N_TREES)]
    rows_cat = np.concatenate(rows_np)
    k3_rows = torch.as_tensor(rows_cat, dtype=torch.int32, device=dev)
    k3_node = torch.as_tensor(np.repeat(np.arange(N_TREES), [
        len(r) for r in rows_np]), dtype=torch.int32, device=dev)
    k3_y = torch.as_tensor(ytr, dtype=torch.int32, device=dev)[
        k3_rows.long()]
    w_cat = np.concatenate([inbag[t, r] for t, r in enumerate(rows_np)])
    k3_w = torch.as_tensor(w_cat, dtype=torch.float32, device=dev)
    k3_bounds = np.concatenate([[0], np.cumsum([len(r) for r in rows_np])])
    k3_kw = dict(rows=k3_rows, bounds=k3_bounds,
                 row_range=(int(rows_cat.min()), int(rows_cat.max())))
    k3_args = (k3_node, k3_y, k3_w, N_TREES, n_bins, N_CLASSES)

    def k3_call():
        return histogram(codes, None, k3_y, k3_w, N_TREES, n_bins,
                         N_CLASSES, **k3_kw)
    k3_out = k3_call()

    def k3_plain():
        return histogram_ref(codes[k3_rows.long()], *k3_args)
    k3_err = max_err(k3_out, k3_plain())
    check(k3_err == 0.0, "histogram != plain version on integer weights")
    check(torch.equal(k3_call(), k3_out),
          "histogram differs between two launches")
    check(torch.equal(histogram(codes, *k3_args, rows=k3_rows), k3_out),
          "histogram with node ids differs from the bounds call")
    # the ordered oracle's bits, on integer and on continuous weights
    k3_items, k3_red, _ = work_items(k3_bounds)
    k3_codes = codes_np[rows_cat]
    check(same_bits(k3_out, histogram_ordered(
        k3_codes, ytr[rows_cat], w_cat, k3_items, k3_red, N_TREES, n_bins,
        N_CLASSES)), "histogram != ordered oracle on integer weights")
    w_cont = (w_cat * np.random.default_rng(5).uniform(
        0.5, 1.5, len(w_cat))).astype(np.float32)
    k3_cont = histogram(codes, None, k3_y, torch.as_tensor(w_cont,
                                                           device=dev),
                        N_TREES, n_bins, N_CLASSES, **k3_kw)
    check(same_bits(k3_cont, histogram_ordered(
        k3_codes, ytr[rows_cat], w_cont, k3_items, k3_red, N_TREES, n_bins,
        N_CLASSES)), "histogram != ordered oracle on continuous weights")
    del k3_codes, k3_cont
    k3_ms = cuda_ms(torch, k3_call, 10)
    k3_node_ms = cuda_ms(torch, lambda: histogram(codes, *k3_args,
                                                  rows=k3_rows), 10)
    k3_plain_ms = cuda_ms(torch, k3_plain, 3)
    _, kt, kc = device_kernels(torch, lambda: [k3_call() for _ in range(20)],
                               "histogram_")
    k3_dev_ms = hist_call_ms(kt, kc)
    k3_ops = ops_per_call(kc)
    k3_mode, k3_alt_ms, k3_alt_dev = modes(k3_call, k3_out, D, n_bins,
                                           N_CLASSES, 1, True, k3_bounds)
    m3 = len(k3_rows)
    k3_flat = ((((k3_node.long()[:, None] * D + torch.arange(D, device=dev))
                 * n_bins + codes[k3_rows.long()].long()) * N_CLASSES
                + k3_y.long()[:, None]).reshape(-1))
    k3_wexp = k3_w[:, None].expand(m3, D).reshape(-1).contiguous()
    k3_table = torch.zeros(N_TREES * D * n_bins * N_CLASSES,
                           dtype=torch.float32, device=dev)
    k3_lib_ms = cuda_ms(torch, lambda: k3_table.index_add_(0, k3_flat,
                                                           k3_wexp), 10)
    del k3_flat, k3_wexp

    # K4 at the GBT root shape: one node over all 50,000 rows with the
    # trainer's (w, w·y, w·y²) payload; integer targets first (exact), then
    # the continuous residuals of the first stage
    gforest = gk.forest
    g_codes_np = gforest.binner_.transform(Xg_tr)
    g_codes = torch.as_tensor(g_codes_np, device=dev)
    g_bins = gforest.binner_.n_bins
    k4_rows = torch.arange(N_GBT, dtype=torch.int32, device=dev)
    k4_node = torch.zeros(N_GBT, dtype=torch.int32, device=dev)
    k4_bounds = np.array([0, N_GBT])
    k4_kw = dict(rows=k4_rows, bounds=k4_bounds, row_range=(0, N_GBT - 1))
    k4_items, k4_red, _ = work_items(k4_bounds)

    def payload(v):
        v = torch.as_tensor(v, device=dev)
        return torch.stack([torch.ones_like(v), v, v * v], 1).float()
    wm_int = payload(np.floor(yg_tr))
    wm_res = payload(yg_tr - yg_tr.mean())
    k4_args = (k4_node, wm_res, 1, g_bins)

    def k4_call():
        return moments(g_codes, None, wm_res, 1, g_bins, **k4_kw)
    k4_int = moments(g_codes, None, wm_int, 1, g_bins, **k4_kw)
    k4_int_err = max_err(k4_int, moments_ref(g_codes, k4_node, wm_int, 1,
                                             g_bins, 3))
    check(k4_int_err == 0.0, "moments != plain version on integer payloads")
    check(same_bits(k4_int, moments_ordered(
        g_codes_np, wm_int.cpu().numpy(), k4_items, k4_red, 1, g_bins)),
        "moments != ordered oracle on integer payloads")
    k4_out = k4_call()
    check(torch.equal(k4_call(), k4_out),
          "moments differs between two launches on continuous payloads")
    check(torch.equal(moments(g_codes, *k4_args, rows=k4_rows), k4_out),
          "moments with node ids differs from the bounds call")
    check(same_bits(k4_out, moments_ordered(
        g_codes_np, wm_res.cpu().numpy(), k4_items, k4_red, 1, g_bins)),
        "moments != ordered oracle on continuous payloads")
    # float32 sums of a bin's c terms are within c·2⁻²⁴·Σ|terms| of the
    # exact (float64) sum
    flat = (torch.arange(D, device=dev) * g_bins + g_codes.long()).reshape(-1)
    exact = torch.zeros((D * g_bins, 3), dtype=torch.float64, device=dev)
    absum = torch.zeros_like(exact)
    cnt = torch.zeros(D * g_bins, dtype=torch.float64, device=dev)
    wm64 = wm_res.double()[:, None, :].expand(N_GBT, D, 3).reshape(-1, 3)
    exact.index_add_(0, flat, wm64)
    absum.index_add_(0, flat, wm64.abs())
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float64))
    k4_dev = (k4_out.reshape(-1, 3).double() - exact).abs()
    check(bool((k4_dev <= cnt[:, None] * 2.0 ** -24 * absum).all()),
          "moments on continuous payloads outside float32 rounding")
    k4_plain_out = moments_ref(g_codes, k4_node, wm_res, 1, g_bins, 3)
    k4_err = max(k4_int_err, max_err(k4_out, k4_plain_out))
    k4_ms = cuda_ms(torch, k4_call, 20)
    k4_node_ms = cuda_ms(torch, lambda: moments(g_codes, *k4_args,
                                                rows=k4_rows), 20)
    _, kt, kc = device_kernels(torch, lambda: [k4_call() for _ in range(20)],
                               "histogram_")
    k4_dev_ms = hist_call_ms(kt, kc)
    k4_ops = ops_per_call(kc)
    k4_mode, k4_alt_ms, k4_alt_dev = modes(k4_call, k4_out, D, g_bins, 3, 3,
                                           False, k4_bounds)
    k4_plain_ms = cuda_ms(torch, lambda: moments_ref(
        g_codes[k4_rows.long()], k4_node, wm_res, 1, g_bins, 3), 5)
    k4_table = torch.zeros((D * g_bins, 3), dtype=torch.float32, device=dev)
    wm_exp = wm_res[:, None, :].expand(N_GBT, D, 3).reshape(-1, 3) \
        .contiguous()
    k4_lib_ms = cuda_ms(torch, lambda: k4_table.index_add_(0, flat, wm_exp),
                        20)
    print(f"K3/K4 bit-exact on integer payloads; K3/K4 equal the ordered "
          f"oracle bit for bit on integer and continuous payloads; K4 "
          f"continuous: max |kernel - float64| {float(k4_dev.max()):.3e}, "
          f"vs plain {max_err(k4_out, k4_plain_out):.3e}, same bits twice",
          flush=True)

    # ---- phase 7: the proximity applications on the card, counted ----
    from repro_torch.applications.outliers import train_outlier_stats
    from repro_torch.applications.prototypes import (
        CompressedProximityEngine, NearestPrototypeClassifier)
    from repro_torch.core.context import EnsembleContext
    from repro_torch.core.engine import ProximityEngine, prediction_margin
    from repro_torch.core.factorization import kernel_matvec_operator
    from repro_torch.core.spectral import operator_eigs
    from scipy.sparse.linalg import LinearOperator
    from repro_torch.core.weights import InstanceHardness, get_assignment
    from repro_torch.forest.trees import route_tree
    t7 = time.perf_counter()

    def host_kernel(k, factors=None):
        """The port's CPU kernel on card kernel ``k``'s forest and training
        leaves (its plain path), optionally with given weights."""
        hf = dataclasses.replace(k.forest, device="cpu", tree_arrays_=None,
                                 leaf_values_=None, route_tables_=None,
                                 leaf_table_=None)
        hf._cache_tables()
        hk = ForestKernel(kernel_method=k.kernel_method, n_trees=k.n_trees,
                          device="cpu")
        hk.forest = hf
        hk.ctx = EnsembleContext.from_forest(hf, leaves=k.ctx.leaves.cpu())
        hk.assignment = get_assignment(hk.kernel_method, hk.ctx)
        hk.engine = ProximityEngine(hk.ctx, hk.assignment, forest=hf,
                                    factors=factors)
        hk.Q_, hk.W_ = hk.engine.Q, hk.engine.W
        return hk

    def cold(e=eng):
        """Empty the OOS query-state cache, so the next call routes its
        batch as a new one would be."""
        with e._qs_lock:
            e._oos_cache.clear()

    def warm_s(fn):
        times = []
        for _ in range(WARM_REPS):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return float(np.median(times))

    app_warm = {}
    earlier = set(per_step)
    reset_counts()
    # outliers: the train side (K2 row blocks bucketed by class, or leaf
    # collisions), then the OOS batch (routed by K1) against the cached
    # training statistics
    o_raw = counted("outlier_scores raw", lambda: fk.outlier_scores(
        normalize=False))
    o_norm = counted("outlier_scores", fk.outlier_scores)
    counted("train_outlier_stats", lambda: train_outlier_stats(eng, ytr))
    cold()
    o_oos = counted("oos_outlier_scores", lambda: fk.oos_outlier_scores(Xte))
    app_warm["oos_outlier_scores"] = warm_s(
        lambda: fk.oos_outlier_scores(Xte))
    # prototypes, the compressed engine and the nearest-prototype classifier
    cr0 = collide_rows.value
    protos, _ = counted("prototypes", lambda: fk.prototypes(
        n_prototypes=N_PROTOS, k=PROTO_K))
    cr_protos = collide_rows.value - cr0
    ce = counted("compress", lambda: fk.compress(n_prototypes=N_PROTOS,
                                                 k=PROTO_K))
    ce_pred = counted("compressed predict_oos", lambda: ce.predict(
        ce.prototype_labels_, N_CLASSES, X=Xte))
    app_warm["compressed predict_oos"] = warm_s(lambda: ce.predict(
        ce.prototype_labels_, N_CLASSES, X=Xte))
    ce_idx, ce_val = counted("compressed topk_oos", lambda: ce.topk(
        k=K, X=Xte))
    app_warm["compressed topk_oos"] = warm_s(lambda: ce.topk(k=K, X=Xte))
    clf = NearestPrototypeClassifier(
        n_prototypes=N_PROTOS, k=PROTO_K,
        prototype_indices_=ce.prototype_indices_,
        prototype_labels_=ce.prototype_labels_, engine_=eng)
    clf_pred = counted("prototype classifier predict_oos",
                       lambda: clf.predict(Xte))
    app_warm["prototype classifier predict_oos"] = warm_s(
        lambda: clf.predict(Xte))
    # the prefix tier: contracted from the engine, its OOS batch the
    # engine's routed state (no K1 launch)
    pe = counted("prefix_engine", lambda: fk.prefix_engine(PREFIX_DEPTH))
    eng.query_state(Xte)
    pe_scores = counted("prefix predict_oos", lambda: pe.predict(
        ytr, N_CLASSES, X=Xte))
    check(per_step["prefix predict_oos"].split("/")[0] == "0",
          "the prefix tier's OOS predict launched K1")
    app_warm["prefix predict_oos"] = warm_s(lambda: pe.predict(
        ytr, N_CLASSES, X=Xte))
    pe_margin = prediction_margin(pe_scores)
    trunc_leaves = counted("truncated forest route_oos",
                           lambda: trunc.apply(Xte))
    # label propagation: 10% labelled, the online state and the OOS batch
    labeled = np.random.default_rng(11).random(N_TRAIN) < PROP_LABELED
    p_lab, p_sc = counted("propagate_labels", lambda: fk.propagate_labels(
        labeled, n_iter=PROP_ITERS))
    onl = counted("propagate online", lambda: fk.propagate_labels(
        labeled, n_iter=PROP_ITERS, online=True))
    cold()
    pb_lab, pb_sc = counted("propagate partial_fit_oos",
                            lambda: onl.partial_fit(Xte))
    app_warm["propagate partial_fit_oos"] = warm_s(
        lambda: onl.partial_fit(Xte))
    # embedding: gap is asymmetric, so Lanczos over device products
    emb = counted("embed", lambda: fk.embed(n_components=2))
    X_emb = Xte[:N_EMBED_OOS]
    cold()
    z_oos = counted("embed transform_oos", lambda: emb.transform(X_emb))
    app_warm["embed transform_oos"] = warm_s(lambda: emb.transform(X_emb))
    # instance-hardness weights on the same forest (no refit)
    ik = ForestKernel(model_type="rf", kernel_method="ih", n_trees=N_TREES,
                      n_bins=64, seed=0, device="cuda")
    ik.forest = fk.forest
    counted("ih build_kernel_cache", ik.build_kernel_cache)
    counted("ih weights", lambda: ik.assignment.reference_weights(
        ik.ctx.leaves))
    ih_pred = counted("ih predict_oos", lambda: ik.engine.predict(
        ytr, N_CLASSES, X=Xte))
    ih_idx, ih_val = counted("ih topk_oos", lambda: ik.topk(k=K, X=Xq))
    # imputation: 10% MCAR NaN in 4 of the 20 columns, drawn among the 10
    # informative ones (a pure-noise column has nothing for proximities to
    # recover); every refit grows its forest on the card (K3)
    rng7 = np.random.default_rng(12)
    imp_cols = np.sort(rng7.choice(10, IMPUTE_COLS, replace=False))
    miss = np.zeros_like(Xtr, dtype=bool)
    miss[:, imp_cols] = rng7.random((N_TRAIN, IMPUTE_COLS)) < IMPUTE_FRAC
    Xmiss = np.where(miss, np.nan, Xtr)
    imp_kw = dict(model_type="rf", kernel_method="gap", n_trees=N_TREES,
                  n_bins=64, seed=0)
    imp = counted("impute", lambda: ForestKernel(
        device="cuda", **imp_kw).impute(Xmiss, ytr, n_iter=IMPUTE_ITERS))
    imp2 = counted("impute again", lambda: ForestKernel(
        device="cuda", **imp_kw).impute(Xmiss, ytr, n_iter=IMPUTE_ITERS))
    Xm_small = Xmiss[:N_IMPUTE_HOST]
    imp_small = counted(f"impute {N_IMPUTE_HOST}", lambda: ForestKernel(
        device="cuda", **imp_kw).impute(Xm_small, ytr[:N_IMPUTE_HOST],
                                        n_iter=IMPUTE_ITERS))
    app_launches = read_counts()
    app_steps = [k for k in per_step if k not in earlier]
    print("applications path (s cold, s warm where a server repeats the "
          f"call, {LAUNCHES} launches): " + ", ".join(
              f"{k} {wall[k]:.4f}"
              + (f" warm {app_warm[k]:.4f}" if k in app_warm else "")
              + f" ({per_step[k]})" for k in app_steps)
          + f"; launches {app_launches}", flush=True)
    for name in ("leaf_route", "block_prox", "histogram", "row_topk"):
        check(app_launches[name] > 0,
              f"{name} was not launched on the applications path")
    for name in ("oos_outlier_scores", "propagate partial_fit_oos",
                 "embed transform_oos", "truncated forest route_oos"):
        check(int(per_step[name].split("/")[0]) > 0,
              f"{name} did not route through K1")
    for name in ("impute", "impute again"):
        check(int(per_step[name].split("/")[2]) > 0,
              f"{name} did not fit on the card through K3")
    # the prototypes' train-side top-k: row_topk on dense blocks, or the
    # collision path where the engine's rule picks it
    if collides:
        check(cr_protos >= N_TRAIN and
              int(per_step["prototypes"].split("/")[5]) > 0,
              "prototypes (k=50) did not take the collision path "
              f"({cr_protos:.0f} rows served)")
    else:
        check(int(per_step["prototypes"].split("/")[4]) > 0,
              "prototypes (k=50) did not select through row_topk")

    # ---- phase 7 checks: each application against the port's CPU engine
    # on the same leaves ----
    t_host = time.perf_counter()
    host_s = {}

    def hosted(name, fn):
        """A host computation of the checks, timed by name."""
        t = time.perf_counter()
        out = fn()
        host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t
        return out
    host = hosted("engine", lambda: host_kernel(fk))
    he = host.engine
    aerrs = {}

    def rel_err(a, b):
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        b = b.detach().cpu().numpy() if hasattr(b, "detach") else b
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())
    # outliers: the host CSR's class-bucketed squared row sums on phase 2's
    # CHECK_ROWS training rows (all 50,000 take the host minutes) and on
    # the OOS batch; the medians and MADs numpy's, of the card's raw scores
    tiny = np.finfo(np.float64).tiny
    counts = np.bincount(ytr, minlength=N_CLASSES).astype(np.float64)

    def raw_of(sq, cls):
        own = sq[np.arange(len(cls)), cls]
        with np.errstate(divide="ignore", over="ignore"):
            return np.minimum(counts[cls] / np.maximum(own, tiny),
                              float(N_TRAIN) ** 2)
    h_raw = hosted("outliers", lambda: raw_of(host_srs(Q[chk]), ytr[chk]))
    aerrs[f"outlier raw (relative), {CHECK_ROWS} rows"] = (
        rel_err(o_raw[chk_dev], h_raw), 1e-10)
    raw_np = o_raw.cpu().numpy()
    med, mad = np.zeros(N_CLASSES), np.full(N_CLASSES, tiny)
    h_norm = np.empty(N_TRAIN)
    for c in range(N_CLASSES):
        m = ytr == c
        med[c] = np.median(raw_np[m])
        mad[c] = max(np.median(np.abs(raw_np[m] - med[c])), tiny)
        h_norm[m] = (raw_np[m] - med[c]) / mad[c]
    aerrs["outlier normalized"] = (max_err(o_norm, h_norm), ATOL_OPS)
    sq_te = hosted("outliers", lambda: host_srs(Qte))
    cls_te = (sq_te / np.maximum(counts, 1.0)[None, :]).argmax(axis=1)
    aerrs["oos outlier"] = (max_err(o_oos, (raw_of(sq_te, cls_te)
                                            - med[cls_te]) / mad[cls_te]),
                            ATOL_OPS)
    h_protos, _ = hosted("prototypes", lambda: host.prototypes(
        n_prototypes=N_PROTOS, k=PROTO_K))
    for c in h_protos:
        check(np.array_equal(protos[c], h_protos[c]),
              f"class {c} prototypes differ from the host's")
        check(np.array_equal(ce.prototype_indices_[ce.prototype_labels_ == c],
                             h_protos[c]), "compress picked other prototypes")
    _, tie_val = fk.topk(k=PROTO_K + 1)
    tie_val = tie_val.cpu().numpy()
    proto_ties = int(((tie_val[:, PROTO_K - 1] == tie_val[:, PROTO_K])
                      & (tie_val[:, PROTO_K] > 0)).sum())
    hce = CompressedProximityEngine(he, ce.prototype_indices_,
                                    labels=ce.prototype_labels_)
    aerrs["compressed predict_oos"] = (max_err(ce_pred, hosted(
        "compressed", lambda: hce.predict(ce.prototype_labels_, N_CLASSES,
                                          X=Xte))), ATOL_OPS)
    h_ci, h_cv = hosted("compressed", lambda: hce.topk(k=K, X=Xte))
    aerrs["compressed topk_oos values"] = (max_err(ce_val, h_cv), ATOL_OPS)
    ce_idx_same = float((ce_idx.cpu() == h_ci).float().mean())
    hclf = NearestPrototypeClassifier(
        prototype_indices_=ce.prototype_indices_,
        prototype_labels_=ce.prototype_labels_, engine_=he)
    aerrs["prototype decision_function"] = (max_err(
        clf.decision_function(Xte), hosted(
            "compressed", lambda: hclf.decision_function(Xte))), ATOL_OPS)
    check(torch.equal(clf_pred.cpu(), hosted(
        "compressed", lambda: hclf.predict(Xte))),
          "nearest-prototype predictions differ from the host's")
    hpe = hosted("prefix", lambda: host.prefix_engine(PREFIX_DEPTH))
    check(torch.equal(pe.gl.cpu(), hpe.gl), "prefix codes differ")
    hpe_scores = hosted("prefix", lambda: hpe.predict(ytr, N_CLASSES,
                                                      X=Xte))
    aerrs["prefix predict_oos"] = (max_err(pe_scores, hpe_scores), ATOL_OPS)
    aerrs["prefix margin"] = (max_err(pe_margin, prediction_margin(
        hpe_scores)), ATOL_OPS)
    check(np.array_equal(trunc_leaves.cpu().numpy(), hosted(
        "prefix", lambda: np.stack([route_tree(t, Xte)
                                    for t in trunc.trees_], axis=1))),
        "K1 on the truncated forest != route_tree")
    h_onl = hosted("propagation", lambda: host.propagate_labels(
        labeled, n_iter=PROP_ITERS, online=True))

    def label_check(name, got_lab, got_sc, want_sc):
        """Labels equal the host's except where the host's top-two score
        margin is below MARGIN_TIE; returns the excepted rows."""
        srt = np.sort(want_sc.cpu().numpy(), axis=1)
        close = srt[:, -1] - srt[:, -2] < MARGIN_TIE
        diff = got_lab.cpu().numpy() != want_sc.argmax(1).numpy()
        check(not (diff & ~close).any(), f"{name} labels differ")
        aerrs[f"{name} scores"] = (max_err(got_sc, want_sc), ATOL_OPS)
        return int(close.sum())
    prop_except = label_check("propagate", p_lab, p_sc, h_onl.scores_)
    hb_lab, hb_sc = hosted("propagation", lambda: h_onl.partial_fit(Xte))
    prop_oos_except = label_check("propagate oos", pb_lab, pb_sc, hb_sc)
    # the embedding's host reference: the same Lanczos (seed, v0) over the
    # host CSR products P v = Q (Wᵀ v) (the CPU engine's segment sums take
    # ~0.5 s a product at this size, minutes for the solver)
    def host_embedding():
        op = kernel_matvec_operator(he.Q, he.W)
        sym = LinearOperator(op.shape, dtype=np.float64, matvec=lambda v:
                             0.5 * (op.matvec(v) + op.rmatvec(v)))
        vals, vecs = operator_eigs(sym, k=2, seed=0)
        vals = np.maximum(vals, 0.0)
        nys = vecs / np.sqrt(vals)[None, :]
        return vals, vecs * np.sqrt(vals)[None, :], np.asarray(
            host.query_map(X_emb) @ (he.W.T @ nys))
    h_vals, h_coords, h_z = hosted("embedding", host_embedding)
    eig_rel = float(np.abs(emb.eigvals_ / h_vals - 1).max())
    check(eig_rel <= 1e-8, f"embedding eigenvalues rtol {eig_rel} > 1e-8")
    sign = np.sign((emb.embedding_ * h_coords).sum(0))
    aerrs["embedding coordinates"] = (max_err(
        emb.embedding_ * sign, h_coords), ATOL_EMBED)
    aerrs["embedding transform_oos"] = (max_err(
        z_oos.cpu().numpy() * sign, h_z), ATOL_EMBED)
    # ih: the first trees' weights against the host rule; a row may pick
    # another neighbour where its 5th and 6th nearest squared distances
    # are within IH_TIE_RTOL
    hctx = host.ctx
    ih_w = ik.engine.w[:, :IH_CHECK_TREES].cpu()
    h_w = hosted("ih", lambda: InstanceHardness(hctx).reference_weights(
        hctx.leaves[:, :IH_CHECK_TREES]))
    ref_rows = torch.as_tensor(np.random.default_rng(0).choice(
        N_TRAIN, min(InstanceHardness.max_ref, N_TRAIN), replace=False),
        device=dev)
    near = torch.zeros((N_TRAIN, IH_CHECK_TREES), dtype=torch.bool)
    for t in range(IH_CHECK_TREES):
        f = torch.as_tensor(hctx.tree_features[t], device=dev)
        A = X_dev[:, f]
        B = A[ref_rows]
        d2 = ((A * A).sum(1)[:, None] - (2 * A) @ B.T
              + (B * B).sum(1)[None, :])
        d = torch.topk(d2, InstanceHardness.k + 1, dim=1,
                       largest=False).values
        del d2
        k5, k6 = d[:, InstanceHardness.k - 1], d[:, InstanceHardness.k]
        near[:, t] = ((k6 - k5) <= IH_TIE_RTOL * k6.abs()).cpu()
    ih_diff = ih_w != h_w
    check(not (ih_diff & ~near).any(),
          "ih weights differ from the host's away from a near-tie")
    ih_near = int(near.sum())
    hik = hosted("ih", lambda: host_kernel(ik, factors=(
        ik.engine.q.cpu(), ik.engine.w.cpu())))
    aerrs["ih predict_oos"] = (max_err(ih_pred, hosted(
        "ih", lambda: hik.engine.predict(ytr, N_CLASSES, X=Xte))), ATOL_OPS)
    # the top-k values of the same 4,096 rows from the host CSR product of
    # the CPU kernel's maps (its dense plain blocks take minutes here)
    aerrs["ih topk_oos values"] = (max_err(ih_val, hosted(
        "ih", lambda: topk_neighbors(hik.query_map(Xq), hik.W_, K)[1])),
        ATOL_OPS)
    # imputation: observed entries untouched, better than the median fill,
    # and the card against the CPU imputer (host trainer) at 5,000 rows
    Xi = imp.X_imputed_
    check(np.array_equal(Xi[~miss], Xtr[~miss]), "observed entries changed")
    check(np.isfinite(Xi).all(), "imputed matrix not finite")
    err_imp = float(np.abs(Xi[miss] - Xtr[miss]).mean())
    med = np.nanmedian(Xmiss, axis=0)
    err_med = float(np.abs(np.broadcast_to(med, Xtr.shape)[miss]
                           - Xtr[miss]).mean())
    check(err_imp < 0.8 * err_med, f"imputation error {err_imp} not below "
          f"0.8 x the median fill's {err_med}")
    run_diff = float(np.abs(imp2.X_imputed_ - Xi).max())
    # the two card imputations' last refits, tree for tree: the bucket sums'
    # atomics may move a filled value across a bin edge
    tree_diff = [next((f for f in TREE_FIELDS if not np.array_equal(
        getattr(a, f), getattr(b, f))), None) for a, b in zip(
            imp.kernel_.forest.trees_, imp2.kernel_.forest.trees_)]
    n_tree_diff = sum(f is not None for f in tree_diff)
    first_tree_diff = next((f"tree {t} field {f}" for t, f in
                            enumerate(tree_diff) if f is not None), "none")
    himp = hosted("imputation", lambda: ForestKernel(
        device="cpu", **imp_kw).impute(Xm_small, ytr[:N_IMPUTE_HOST],
                                       n_iter=IMPUTE_ITERS))
    aerrs[f"impute {N_IMPUTE_HOST} vs host"] = (max_err(
        imp_small.X_imputed_, himp.X_imputed_), ATOL_OPS)
    aerrs[f"impute {N_IMPUTE_HOST} history"] = (max_err(
        np.asarray(imp_small.history_), np.asarray(himp.history_)), ATOL_OPS)
    for name, (e, lim) in aerrs.items():
        print(f"  {name}: max err {e:.3e} (limit {lim:g})")
        check(e <= lim, f"{name} error {e} > {lim}")
    mem_full, mem_ce = eng.memory_bytes(), ce.memory_bytes()
    print(f"applications vs host: prototype ids equal ({ce.n_ref} columns; "
          f"{proto_ties} of {N_TRAIN} rows tie at the {PROTO_K}th place), "
          f"compressed topk_oos indices equal the host's in "
          f"{ce_idx_same:.6f} of places, nearest-prototype predictions "
          f"equal; propagation labels equal except {prop_except} train / "
          f"{prop_oos_except} OOS rows with a top-two margin below "
          f"{MARGIN_TIE:g}; embedding eigenvalues {emb.eigvals_.tolist()} "
          f"(rtol vs host {eig_rel:.2e}); ih weights on {IH_CHECK_TREES} "
          f"trees: {int(ih_diff.sum())} differ, {ih_near} (row, tree) near "
          f"ties; imputation error {err_imp:.4f} vs median fill "
          f"{err_med:.4f}, two card runs differ by at most {run_diff:.3e} "
          f"and their last refits in {n_tree_diff} of {len(tree_diff)} "
          f"trees (first difference: {first_tree_diff}); "
          f"host checks {time.perf_counter() - t_host:.1f} s (" + ", ".join(
              f"{k} {v:.1f}" for k, v in host_s.items()) + ")", flush=True)
    print(f"compressed engine memory {mem_ce} vs full engine {mem_full}",
          flush=True)
    print(f"phase 7 wall: {time.perf_counter() - t7:.1f} s", flush=True)

    # ---- phase 8: snapshots and serving on the card, counted ----
    from repro_torch.applications.outliers import oos_outlier_scores
    from repro_torch.core.factorization import factor_digest
    from repro_torch.serve.proximity import Tier, TieredProximityServer
    from repro_torch.serve.reliability import FaultInjector, RetryPolicy
    t8 = time.perf_counter()
    earlier = set(per_step)
    reset_counts()
    # 1. snapshot round trip of the acceptance kernel: the load routes
    # nothing (the saved leaves) and recomputes no weight
    with tempfile.TemporaryDirectory() as snap_dir:
        snap_path = os.path.join(snap_dir, "acceptance.npz")
        manifest = counted("save", lambda: fk.save(snap_path))
        snap_bytes = os.path.getsize(snap_path)
        lk = counted("load", lambda: ForestKernel.load(snap_path,
                                                       device="cuda"))
    check(per_step["load"].split("/")[0] == "0", "load launched K1")
    check(lk.ctx.digest() == manifest["ctx_digest"] == fk.ctx.digest(),
          "loaded context digest differs")
    check(factor_digest(lk.engine.gl, lk.engine.q, lk.engine.w)
          == manifest["factor_digest"], "loaded factor digest differs")
    # the block kernel's ops give the saved kernel's bits; predict's class
    # scores sum with index_add_ atomics (last bits vary between calls), so
    # its labels are held equal except where the top-two scores of the
    # saved kernel are within 1e-12
    snap_same = {
        "topk_oos": (fk.topk(k=K, X=Xq), lk.topk(k=K, X=Xq)),
        "kernel_block": (fk.kernel_block(rows), lk.kernel_block(rows)),
        "squared_row_sums_oos": (
            eng.squared_row_sums(ytr, n_classes=N_CLASSES, X=Xte),
            lk.engine.squared_row_sums(ytr, n_classes=N_CLASSES, X=Xte))}
    for name, (a, b) in snap_same.items():
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        check(all(torch.equal(u, v) for u, v in pairs),
              f"loaded kernel's {name} differs from the saved kernel's")
    sc_saved = eng.predict(ytr, N_CLASSES, X=Xte)
    sc_loaded = lk.engine.predict(ytr, N_CLASSES, X=Xte)
    snap_pred_err = max_err(sc_loaded, sc_saved)
    check(snap_pred_err <= 1e-12, f"loaded predict scores {snap_pred_err}")
    top2 = torch.topk(sc_saved, 2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1] <= 1e-12).cpu().numpy()
    lab_diff = (lk.predict(Xte) != fk.predict(Xte)).cpu().numpy()
    check(not (lab_diff & ~near_tie).any(), "loaded predict labels differ")
    del lk
    print(f"snapshot: save {wall['save']:.3f} s, load {wall['load']:.3f} s "
          f"({per_step['load']} launches), archive {snap_bytes} bytes; "
          f"digests equal; topk_oos, kernel_block and squared_row_sums_oos "
          f"bit for bit, predict labels equal ({int(near_tie.sum())} rows "
          f"with a top-two gap <= 1e-12, {int(lab_diff.sum())} differ), "
          f"scores within {snap_pred_err:.1e}", flush=True)

    # 2. ProximityServer over the full engine: 256 seeded requests of 1-16
    # disjoint OOS rows (each tick's batch is new to the engine's cache)
    mix = ("predict", "topk", "outlier", "propagate", "embed")
    rng8 = np.random.default_rng(16)
    kinds8 = rng8.choice(mix, size=N_SERVE_REQ, p=SERVE_MIX)
    sizes8 = rng8.integers(1, 17, size=N_SERVE_REQ)
    offs8 = np.concatenate([[0], np.cumsum(sizes8)])
    check(offs8[-1] <= N_OOS, "serving rows exceed the OOS batch")
    reqs8 = [(str(kd), Xte[offs8[i]:offs8[i + 1]]) + ((K,) if kd == "topk"
                                                      else ())
             for i, kd in enumerate(kinds8)]
    # the propagation field converged, so partial_fit is a pure projection
    # and a direct call gives the server's answer
    refine_steps = 0
    while not onl.converged_ and refine_steps < 500:
        refine_steps += onl.refine(10)
    check(onl.converged_, "online propagation did not converge")
    srv = fk.serve(n_slots=SERVE_SLOTS, propagator=onl, embedding=emb)
    tick_log = []
    inner_step = srv.step

    def logged_step():
        before = read_counts()
        n_fin = len(srv.finished)
        out = inner_step()
        torch.cuda.synchronize()
        after = read_counts()
        tick_log.append(({r.kind for r in srv.finished[n_fin:]},
                         after["leaf_route"] - before["leaf_route"],
                         after["block_prox"] - before["block_prox"]))
        return out
    srv.step = logged_step
    res8 = counted("ProximityServer 256 requests", lambda: srv.serve(reqs8))
    serve_s = wall["ProximityServer 256 requests"]
    st8 = srv.stats()
    check(st8["requests"] == N_SERVE_REQ and not srv.failed_requests
          and not srv.shed_requests, "ProximityServer lost requests")
    for kinds, k1n, k2n in tick_log:
        check(k1n == 1, f"a tick of {sorted(kinds)} launched {k1n} K1")
        check(k2n >= len(kinds & {"topk", "outlier"}),
              f"a tick of {sorted(kinds)} launched {k2n} K2")
    lat = np.array([r.latency_s for r in srv.finished])
    svc = np.array([r.service_s for r in srv.finished])
    reg8 = srv.registry
    h_op = reg8.histogram("engine_op_seconds",
                          labels=("op", "backend", "tier"))
    op_ms = {op: h_op.labels(op=op, backend=eng.device.type, tier="server")
             for op in ("query_state", "predict", "topk",
                        "squared_row_sums")}
    phase5 = {"predict": "predict_oos", "topk": "topk_oos",
              "squared_row_sums": "squared_row_sums_oos"}
    k2_per_tick = [k2n for _, _, k2n in tick_log]
    print(f"ProximityServer (full engine, {SERVE_SLOTS} slots): "
          f"{N_SERVE_REQ} requests ("
          + ", ".join(f"{kd} {int((kinds8 == kd).sum())}" for kd in mix)
          + f") "
          f"in {st8['ticks']} ticks, {serve_s:.3f} s, "
          f"{N_SERVE_REQ / serve_s:.1f} requests/s, "
          f"{serve_s / st8['ticks'] * 1e3:.3f} ms a tick; "
          f"serve_request_seconds p50 {np.percentile(lat, 50) * 1e3:.3f} "
          f"p99 {np.percentile(lat, 99) * 1e3:.3f} ms, serve_service_seconds "
          f"p50 {np.percentile(svc, 50) * 1e3:.3f} p99 "
          f"{np.percentile(svc, 99) * 1e3:.3f} ms; K1 a tick "
          f"{min(t[1] for t in tick_log)}-{max(t[1] for t in tick_log)}, K2 "
          f"a tick {min(k2_per_tick)}-{max(k2_per_tick)} "
          f"(mean {np.mean(k2_per_tick):.2f}); mean occupancy "
          f"{st8['mean_occupancy']:.1f}; propagation refined "
          f"{refine_steps} steps to converge first", flush=True)
    print("  engine_op_seconds mean ms (count) beside phase 5's warm call: "
          + ", ".join(f"{op} {h.mean * 1e3:.3f} ({h.count})"
                      + (f" vs {warm[phase5[op]] * 1e3:.3f}"
                         if op in phase5 else "")
                      for op, h in op_ms.items()), flush=True)
    print("  per kind (ms): " + ", ".join(
        f"{kd} n={v['requests']} p50 {v['p50_ms']:.3f} p95 "
        f"{v['p95_ms']:.3f} service p50 {v['p50_service_ms']:.3f}"
        for kd, v in st8["kinds"].items()), flush=True)

    # 3. the tiered ladder from phase 7's engines (depth-4 prefix,
    # compressed, full), async: an admission thread and a worker a tier
    tiers = [Tier("shallow", pe, y=ytr, kinds=("predict",),
                  n_slots=SERVE_SLOTS, n_classes=N_CLASSES),
             Tier("compressed", ce, y=ce.prototype_labels_,
                  kinds=("predict", "topk", "outlier"),
                  n_slots=SERVE_SLOTS, n_classes=N_CLASSES),
             Tier("full", eng, y=ytr, kinds=mix, n_slots=SERVE_SLOTS,
                  n_classes=N_CLASSES, propagator=onl, embedding=emb)]
    tsrv = TieredProximityServer(tiers, escalate_margin=0.1)

    def tiered_async():
        tsrv.start()
        try:
            return tsrv.wait([tsrv.submit(*r) for r in reqs8],
                             timeout=300.0)
        finally:
            tsrv.stop()
    tres = counted("TieredProximityServer 256 requests", tiered_async)
    check(not any(t.is_alive() for t in tsrv._worker_threads.values()),
          "a tier worker outlived stop()")
    tier_s = wall["TieredProximityServer 256 requests"]
    tst = tsrv.stats()
    treqs = [tsrv._requests[u] for u in sorted(tsrv._requests)]
    check(all(r.done.is_set() and r.result is not None for r in treqs),
          "the tiered server lost a request")
    agree_rows = esc_rows = 0
    for r in treqs:
        if r.escalations:
            lab = [r.answers[t]["labels"] for t in r.tier_path]
            agree_rows += int((lab[0] == lab[-1]).sum())
            esc_rows += len(lab[0])
    print(f"TieredProximityServer (async, shallow depth {PREFIX_DEPTH} -> "
          f"compressed {ce.n_ref} columns -> full): {N_SERVE_REQ} requests "
          f"in {tier_s:.3f} s, {N_SERVE_REQ / tier_s:.1f} requests/s; "
          f"escalations {tst['escalations']} (rate "
          f"{tst['escalation_rate']:.3f}), shed {tst['shed']}, spills "
          f"{tst['reliability']['spills']}, timeouts {tst['timeouts']}; "
          "per tier routed / ticks: " + ", ".join(
              f"{t} {v['routed_requests']} / {v['ticks']}"
              for t, v in tst["tiers"].items())
          + f"; escalated rows whose shallow label the full tier kept "
          f"{agree_rows} of {esc_rows}", flush=True)

    # 4. chaos: the same requests through a fresh ladder, synchronously,
    # with seeded exceptions, latency and corrupted results
    inj = FaultInjector(error_rate=0.2, latency_rate=0.05, latency_s=0.001,
                        corrupt_rate=0.05, seed=3)
    csrv = TieredProximityServer(
        tiers, escalate_margin=0.1, fault_injector=inj,
        retry=RetryPolicy(max_retries=2, backoff_s=0.001))
    c_uids = [csrv.submit(*r) for r in reqs8]
    counted("chaos 256 requests", csrv.run_until_drained)
    creqs = [csrv._requests[u] for u in c_uids]
    c_done = sum(r.result is not None for r in creqs)
    c_failed = sum(r.failed for r in creqs)
    c_shed = sum(r.shed for r in creqs)
    cst = csrv.stats()["reliability"]
    check(all(r.done.is_set() for r in creqs), "chaos: a request never ended")
    check(c_done + c_failed + c_shed == N_SERVE_REQ,
          "chaos: a request was silently lost")
    check(all(r.fail_reason for r in creqs if r.failed),
          "chaos: a failure without a reason")
    check(all(s.faults == s.retries + s.failed_calls
              for s in csrv._servers), "chaos: fault accounting")
    check(cst["faults"] > 0, "chaos: no fault was injected")
    print(f"chaos (sync ladder, {inj.stats()['injected']} injected over "
          f"{inj.stats()['calls']} calls): faults {cst['faults']}, retries "
          f"{cst['retries']}, recovered calls {cst['recovered_calls']}, "
          f"failed calls {cst['failed_calls']}, reroutes "
          f"{cst['reroutes']}; requests answered {c_done}, failed "
          f"{c_failed}, shed {c_shed} of {N_SERVE_REQ} (0 lost)", flush=True)
    serve_launches = read_counts()
    serve_steps = [k for k in per_step if k not in earlier]
    print(f"serving path (s, {LAUNCHES} launches): " + ", ".join(
        f"{k} {wall[k]:.3f} ({per_step[k]})" for k in serve_steps)
        + f"; launches {serve_launches}", flush=True)
    for name in ("leaf_route", "block_prox", "row_topk"):
        check(serve_launches[name] > 0,
              f"{name} was not launched on the serving path")

    # phase 8 checks: every answer against a direct call on the card, on
    # the engine of the tier that gave it
    direct = {"shallow": (pe, ytr), "compressed": (ce, ce.prototype_labels_),
              "full": (eng, ytr)}
    serr = {}

    def note(name, e):
        serr[name] = max(serr.get(name, 0.0), e)

    def check_answer(kind, Xr, got, e, yv, where):
        Xr = np.ascontiguousarray(Xr)
        if kind == "predict":
            want = e.predict(yv, N_CLASSES, X=Xr).argmax(1).cpu().numpy()
            check(np.array_equal(got["labels"], want),
                  f"{where} predict labels differ from a direct call")
        elif kind == "topk":
            i_, v_ = e.topk(k=K, X=Xr)
            i_, v_ = i_.cpu().numpy(), v_.cpu().numpy()
            cols = getattr(e, "prototype_indices_", None)
            if cols is not None:
                i_ = np.where(v_ > 0, cols[i_], -1)
            check(np.array_equal(got["indices"], i_),
                  f"{where} topk ids differ from a direct call")
            note("topk values", float(np.abs(got["values"] - v_).max()))
        elif kind == "outlier":
            note("outlier scores", float(np.abs(
                got["scores"]
                - oos_outlier_scores(e, yv, Xr).cpu().numpy()).max()))
        elif kind == "propagate":
            note("propagate scores", float(np.abs(
                got["scores"] - onl.partial_fit(Xr)[1].cpu().numpy()).max()))
        else:
            note("embed coordinates", float(np.abs(
                got["embedding"] - emb.transform(Xr).cpu().numpy()).max()))

    for (kind, Xr, *_), got in zip(reqs8, res8):
        check_answer(kind, Xr, got, eng, ytr, "ProximityServer")
    for (kind, Xr, *_), r in zip(reqs8, treqs):
        check_answer(kind, Xr, r.result, *direct[r.final_tier],
                     f"tier {r.final_tier}")
    for name, lim in (("topk values", 1e-12), ("embed coordinates", 1e-8),
                      ("outlier scores", 1e-10), ("propagate scores", 1e-10)):
        print(f"  serving {name}: max err {serr.get(name, 0.0):.3e} "
              f"(limit {lim:g})")
        check(serr.get(name, 0.0) <= lim, f"serving {name} error")
    # K1 and K2 at the serving shapes: a full tick's 64 rows routed, and
    # its block against the 50,000 training columns and against the
    # compressed engine's prototype columns
    qs_tick = eng.query_state(Xte)
    k1_tick = k1_case(f"{SERVE_SLOTS}x{N_TREES}", Xte_dev[:SERVE_SLOTS],
                      tables)
    k2_tick = {name: k2_case(name, e, qs_tick.gl[:SERVE_SLOTS],
                             qs_tick.q[:SERVE_SLOTS])
               for name, e in ((f"{SERVE_SLOTS}x{eng.n_ref}", eng),
                               (f"{SERVE_SLOTS}x{ce.n_ref}", ce))}
    print(f"serving shapes: K1 {SERVE_SLOTS} rows x {N_TREES} trees "
          f"{k1_tick[0]:.4f} ms a call / {k1_tick[1]:.4f} on the device "
          "(bit-exact); K2 " + ", ".join(
              f"{k} leaf form {r[2]:.4f} ms, dense form {r[3]:.4f} ms "
              f"(err {r[1]:.1e}, {'leaf' if e.leaf_mode() else 'dense'} "
              "picked)" for (k, r), e in zip(k2_tick.items(), (eng, ce))),
          flush=True)
    print(f"phase 8 wall: {time.perf_counter() - t8:.1f} s", flush=True)

    # ---- phase 9: the out-of-core pipeline on the card, counted ----
    budget_check(torch, dev, fk, Xtr, ytr, Xq, Xte, rows)
    ooc_launches, pairs = phase9(torch, dev, OOC_ROWS, wrappers)

    # ---- phase 10: the LM serving path on the card ----
    lm_launches, lm_holds = phase10(torch, dev, wrappers)

    # ---- phase 11: LM training on the card (no kernel of the port) ----
    reset_counts()
    peak11 = phase11(torch, dev)
    torch.cuda.synchronize()
    train_launches = read_counts()
    print(f"phase 11 launches {LAUNCHES}: "
          f"{'/'.join(str(v) for v in train_launches.values())}", flush=True)

    # ---- phase 12: float32 factors and the sharded product ----
    k2f32 = phase12(torch, dev, fk, Xtr, ytr, Xte, snap_bytes)

    # ---- phase 13: the LM's sharding layer (no kernel of the port) ----
    reset_counts()
    arg_bytes13 = phase13(torch, dev)
    torch.cuda.synchronize()
    mesh_launches = read_counts()
    print(f"phase 13 launches {LAUNCHES}: "
          f"{'/'.join(str(v) for v in mesh_launches.values())}", flush=True)

    # ---- phase 14: the dry runs' results (no card, no kernel) ----
    phase14_finish(dry_out, dry_proc, arg_bytes13, peak11)

    # ---- the row top-k kernel at the engine's block and a tick ----
    rt = row_topk_times(torch, dev)
    rt_main = rt[(320, "float64", "dense")]

    # ---- bounds, from this run's shapes and data ----
    # K1 reads X once, each real node's 16-byte record once (not the
    # padding up to M) and writes the (n, T) int32 leaves
    T, M = tables.n_trees, tables.max_nodes

    def k1_bound_ms(Xr, tb, n_nodes):
        return (Xr.numel() * 8 + n_nodes * 16
                + Xr.shape[0] * tb.n_trees * 4) / HBM_BYTES_S * 1e3
    k1_bounds = {k: k1_bound_ms(*v) for k, v in k1_shapes.items()}
    k1_bound = k1_bounds[f"{N_TRAIN}x{N_TREES}"]
    nq, nw = BLOCK_ROWS, eng.n_ref
    cnt_w = torch.bincount(eng.gl.reshape(-1).long(),
                           minlength=eng.total_leaves)
    collisions = float(cnt_w[gl_q.reshape(-1).long()].sum())
    # K2's work is one FMA per collision whose q and w are both nonzero —
    # what these inputs need, not the Nq·Nw·T compares of the dense
    # algorithm; its bytes are gl/q of the query rows, the part of the
    # leaf index these rows reach and the output
    k2_terms, work, k2_read = k2_bound(torch, index, gl_q, q, FP64_FMA_S)
    k2_by = max(k2_terms, key=k2_terms.get)
    # K3/K4 read the code matrix, each instance's row id, label and
    # weight (or K payloads) once and write the table; the work is one add
    # per (instance, feature) and payload column
    k3_terms = {"bytes": (N_TRAIN * D * codes.element_size() + m3 * 12
                          + k3_out.numel() * 4) / HBM_BYTES_S,
                "operations": m3 * D / FP32_S}
    k4_terms = {"bytes": (N_GBT * D * g_codes.element_size() + N_GBT * 4
                          + wm_res.numel() * 4 + k4_out.numel() * 4)
                / HBM_BYTES_S,
                "operations": N_GBT * D * 3 / FP32_S}
    k3_by = max(k3_terms, key=k3_terms.get)
    k4_by = max(k4_terms, key=k4_terms.get)

    def total(name):
        return launches[name] + gbt_launches[name] + app_launches[name] \
            + serve_launches[name] + ooc_launches[name] + lm_launches[name] \
            + train_launches[name] + k2f32["launches"][name] \
            + mesh_launches[name]
    kernels = [
        {"name": "leaf_route", "route": "cuda",
         "source": "src/repro_torch/kernels/leaf_route/csrc/leaf_route.cu",
         "replaces": "src/repro/kernels/leaf_route/leaf_route.py:48",
         "launches": total("leaf_route"),
         "max_abs_err": 0.0,               # every K1 case is bit-exact
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "block_prox", "route": "cuda",
         "source": "src/repro_torch/kernels/block_prox/csrc/block_prox.cu",
         "replaces": "src/repro/kernels/block_prox/block_prox.py:56",
         "launches": total("block_prox"),
         "max_abs_err": max(k2_err, lm_holds["block_prox"]),
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_terms[k2_by] * 1e3, "bound_by": k2_by,
         "library_ms": k2_lib_ms},
        {"name": "block_prox_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/block_prox/csrc/block_prox.cu",
         "replaces": "src/repro/kernels/block_prox/block_prox.py:56",
         "launches": k2f32["launches_f32"],
         "max_abs_err": k2f32["max_abs_err"],
         "ms": k2f32["ms"], "plain_ms": k2f32["plain_ms"],
         "bound_ms": k2f32["bound_ms"], "bound_by": k2f32["bound_by"],
         "library_ms": k2f32["library_ms"]},
        {"name": "histogram", "route": "cuda",
         "source": "src/repro_torch/kernels/histogram/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:110",
         "launches": total("histogram"),
         "max_abs_err": max(k3_err, lm_holds["histogram"]),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_terms[k3_by] * 1e3, "bound_by": k3_by,
         "library_ms": k3_lib_ms},
        {"name": "moments", "route": "cuda",
         "source": "src/repro_torch/kernels/histogram/csrc/histogram.cu",
         "replaces": "src/repro/kernels/histogram/histogram.py:165",
         "launches": total("moments"), "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_terms[k4_by] * 1e3, "bound_by": k4_by,
         "library_ms": k4_lib_ms},
        {"name": "row_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/row_topk/csrc/row_topk.cu",
         "replaces": None,             # the reference's jax.lax.top_k
         "launches": total("row_topk"),
         "max_abs_err": 0.0,           # every case is bit for bit
         "ms": rt_main["ms"], "plain_ms": rt_main["plain_ms"],
         "bound_ms": rt_main["bound_ms"], "bound_by": "bytes",
         "library_ms": rt_main["library_ms"]},
    ]
    # the collision kernels (phase 9 (d), on its largest row block; none:
    # the reference's train-side ops write dense blocks)
    for name, op, err in (
            ("collide_enumerate", "enum", 0.0),  # bit for bit
            ("pair_topk", "topk", 0.0),
            ("pair_sums", "sums", pairs.get("sums_abs_err"))):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/collide/csrc/collide.cu",
            "replaces": None, "launches": total(name),
            "max_abs_err": err if pairs else None,
            "ms": pairs.get(f"{op}_ms"),
            "plain_ms": pairs.get(f"{op}_plain_ms"),
            "bound_ms": pairs.get(f"{op}_bound_ms"), "bound_by": "bytes",
            "library_ms": None})
    print(f"K1 route (M={M}), ms a wrapper call / on the device: " +
          ", ".join(f"{k} {k1_times[k][0]:.4f} / {k1_times[k][1]:.4f} "
                    f"(bound {k1_bounds[k]:.5f})" for k in k1_shapes)
          + f"; plain {k1_plain_ms:.3f} ms at {N_TRAIN}x{N_TREES}")
    print(f"K2 block {nq}x{nw}x{T}: {k2_ms:.4f} ms in the leaf form "
          f"({train_rows} rows {k2_tr_ms:.4f} ms; dense form "
          f"{k2_dense_ms:.4f} ms), plain "
          f"{k2_plain_ms:.3f} ms, cuSPARSE SpMM {k2_lib_ms:.3f} ms (err "
          f"{lib_err:.2e}), bound {k2_terms[k2_by] * 1e3:.4f} ms by {k2_by} "
          f"(collisions {collisions:.3e}, with nonzero q and w {work:.3e}; "
          f"index {index.nbytes} bytes, {k2_read} of them reached)")
    print(f"K3 level 1 {N_TREES} nodes x {m3} instances x {D} x {n_bins} x "
          f"{N_CLASSES}: {k3_ms:.3f} ms a wrapper call with host bounds "
          f"({k3_dev_ms:.3f} ms in its kernels on the device, host share "
          f"{k3_ms - k3_dev_ms:.3f} ms; {k3_node_ms:.3f} ms a call with "
          f"node ids), plain {k3_plain_ms:.3f} ms, index_add_ "
          f"{k3_lib_ms:.3f} ms, bound {k3_terms[k3_by] * 1e3:.4f} ms by "
          f"{k3_by}; device ops of one call {k3_ops}; {k3_mode} mode "
          f"(the other mode here: {k3_alt_ms:.3f} ms a call, "
          f"{k3_alt_dev:.3f} ms on the device, same bits)")
    print(f"K4 GBT root 1 node x {N_GBT} x {D} x {g_bins} x 3: {k4_ms:.3f} "
          f"ms a wrapper call with host bounds ({k4_dev_ms:.3f} ms in its "
          f"kernels on the device, host share {k4_ms - k4_dev_ms:.3f} ms; "
          f"{k4_node_ms:.3f} ms a call with node ids), plain "
          f"{k4_plain_ms:.3f} ms, index_add_ {k4_lib_ms:.3f} ms, bound "
          f"{k4_terms[k4_by] * 1e3:.4f} ms by {k4_by}; device ops of one "
          f"call {k4_ops}; {k4_mode} mode (the other mode here: "
          f"{k4_alt_ms:.3f} ms a call, {k4_alt_dev:.3f} ms on the device, "
          f"same bits)")
    print("launches (main path + GBT path + applications path + serving "
          "path + out-of-core path + LM proximity head + LM training + "
          "float32 path + LM sharding): " + ", ".join(
              f"{k} {launches[k]} + {gbt_launches[k]} + {app_launches[k]} "
              f"+ {serve_launches[k]} + {ooc_launches[k]} + "
              f"{lm_launches[k]} + {train_launches[k]} + "
              f"{k2f32['launches'][k]} + {mesh_launches[k]}"
              for k in wrappers)
          + f"; block_prox_f32 {k2f32['launches_f32']} (float32 path)")
    print(f"wall: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
