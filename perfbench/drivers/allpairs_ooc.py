"""All-pairs proximity jobs out of core: ``allpairs.py``'s job over a
training set under the configuration's ``memory_budget_bytes``.

A pass is ``fk.topk(k)`` over every training row, then
``fk.engine.squared_row_sums(class_ids=y)``, then a synchronise, as in
``allpairs.py``; the rate is the rows of the whole passes over the time
from the window's start to the end of the last one.  What differs:

- the ``ForestKernel`` gets the budget and a scratch directory made for the
  run inside the checkout (``.bench_cache/scratch/``), removed on success
  and on failure;
- before the fit the driver exits unless the program's engine has the
  collision rule (``ProximityEngine.collision_mode``): on dense blocks a
  pass over this many columns outlasts the window; after the warm-up, on
  the card, it exits unless the warm-up's train-side calls took the
  collision path (``engine_collide_rows_total``);
- each pass keeps its answers at the check rows only, and a finiteness
  flag of the whole answer (every row's answers, a pass after a pass,
  would fill the card over a window);
- a traced window has the program's regions on (``set_regions``) and is
  read with ``pb/regions.py``; the engine's counters are read before and
  after the window (``rec["counters"]``);
- the fit's bin edges, which the checks route by, come from the trainer's
  row sample above 200,000 rows (``reference/edges.py``);
- the deployment is one dataset and one forest, as the source's run is: the
  rows and the forest's seed come from the configuration's
  ``deployment_seed``, not from ``--seed``.  A pass enumerates the products
  of the forest's leaf collisions, and the few large pure leaves of a forest
  move them by 10-20% from one forest to the next, so every seed gets the
  same work; ``--seed`` draws the check rows.

Correctness is ``allpairs.py``'s: every pass's answers at ``check_rows``
rows drawn from ``--seed`` against the plain reference, whose ``pairs`` form
works out whole rows of P, a few hundred rows at a time.
"""
from __future__ import annotations

import os
import tempfile
import traceback

import numpy as np

from pb import checks, program, regions, roofline, trace
from pb.common import ROOT, load_module
from pb.rng import stream
from reference import edges
from reference import forest as rforest
from reference.pipeline import Forest
from reference.prox import class_sq_sums, onehot, topk

COUNTERS = ("engine_collide_rows_total", "engine_collisions_total",
            "engine_topk_rows_total")
REF_ROWS = 256           # query rows of P the reference holds at a time


def counters() -> dict:
    """The engine's process-wide counters (0 where the program has none)."""
    from repro_torch.obs.metrics import global_registry
    snap = global_registry().snapshot()
    return {k: float(snap.get(k, {}).get("series", {}).get("", 0.0))
            for k in COUNTERS}


def run(ctx) -> dict:
    from repro_torch.core.engine import ProximityEngine
    if not hasattr(ProximityEngine, "collision_mode"):
        raise SystemExit(
            f"{ctx.cell}: the program's engine has no collision rule "
            "(ProximityEngine.collision_mode); on dense blocks a pass over "
            f"{ctx.cfg['n_train']} columns would outlast the window")
    root = os.path.join(ROOT, ".bench_cache", "scratch")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="ooc_", dir=root) as scratch:
        return _run(ctx, scratch)


def deployment_seed(cfg: dict) -> int:
    """The seed of the deployment's rows and forest."""
    return int(cfg["deployment_seed"])


def _build(ctx, scratch: str) -> program.Built:
    """``program.build`` with the budget, the scratch directory and the
    deployment's seed."""
    from repro_torch.core.api import ForestKernel
    cfg, sp = ctx.cfg, ctx.spans
    seed = deployment_seed(cfg)
    gen = load_module("data", cfg["generator"])
    with sp("data"):
        X, y = gen.generate(cfg, seed, "train", cfg["n_train"], ctx.device)
    fk = ForestKernel(
        model_type=cfg["model_type"], kernel_method=cfg["kernel_method"],
        task=cfg["task"], n_trees=cfg["n_trees"], max_depth=cfg["max_depth"],
        min_samples_leaf=cfg["min_samples_leaf"],
        max_features=cfg["max_features"], n_bins=cfg["n_bins"],
        seed=seed, dtype=np.dtype(ctx.dtype or cfg["dtype"]).type,
        device=str(ctx.device), scratch_dir=scratch,
        memory_budget_bytes=int(cfg["memory_budget_bytes"]))
    with sp("fit", sync=True):
        fk.fit_forest(X, y)
    with sp("factors", sync=True):
        fk.build_kernel_cache()
    return program.Built(fk=fk, X=X, y=y)


def _run(ctx, scratch: str) -> dict:
    torch, cfg, mix, sp = ctx.torch, ctx.cfg, ctx.mix, ctx.spans
    built = _build(ctx, scratch)
    fk, y = built.fk, built.y
    k, C = int(mix["k"]), int(cfg["n_classes"])
    n = int(built.X.shape[0])
    rows = np.sort(stream(ctx.seed, 7).choice(n, min(n, mix["check_rows"]),
                                              replace=False))
    rd = torch.as_tensor(rows, device=ctx.device)

    def one_pass():
        with sp("topk"):
            idx, val = fk.topk(k=k)
        with sp("squared_row_sums"):
            sq = fk.engine.squared_row_sums(class_ids=y, n_classes=C)
        with sp("keep"):
            kept = (idx[rd], val[rd], sq[rd],
                    torch.isfinite(val).all() & torch.isfinite(sq).all())
        with sp("sync", sync=True):
            pass
        return kept

    c0 = counters()
    with sp("warmup", sync=True):
        one_pass()
    c1 = counters()
    served = c1["engine_collide_rows_total"] - c0["engine_collide_rows_total"]
    if ctx.device.type == "cuda" and (
            not fk.engine.collision_mode() or served != 2 * n
            or c1["engine_topk_rows_total"] != c0["engine_topk_rows_total"]):
        raise SystemExit(
            f"{ctx.cell}: the warm-up's train-side calls did not take the "
            f"collision path (collision share "
            f"{fk.engine.collision_share():.3g}, {served:.0f} rows served "
            f"of {2 * n})")
    setup_s = sp.clock() - ctx.t_start
    ctx.log("setup: " + ", ".join(f"{s} {sp.last(s):.3f} s" for s in
                                  ("data", "fit", "factors", "warmup"))
            + f"; {setup_s:.3f} s from the process's start")
    ctx.settle()
    from repro_torch.obs import set_regions
    prof = trace.start() if ctx.trace else None
    regions_were = set_regions(ctx.trace)
    sp.tracing = ctx.trace
    before = counters()
    outs, raised = [], 0
    with sp("window"):
        t0 = sp.clock()
        elapsed = 0.0
        while elapsed < ctx.seconds:
            try:
                outs.append(one_pass())
            except Exception:                # noqa: BLE001 — a failed pass
                traceback.print_exc()
                raised += 1
                break
            elapsed = sp.clock() - t0
    after = counters()
    sp.tracing = False
    set_regions(regions_were)
    summary = regions.summarize(*regions.stop(prof)) if prof else None
    peak = ctx.memory_peak()

    # ---- after the window: the answers at the sampled rows ----
    got, failed = [], raised
    for out in outs:
        failed += not bool(out[3])
        got.append(tuple(t.cpu().numpy() for t in out[:3]))
    st = program.model_state(fk, cfg)
    pf = program.program_factors(fk)
    outs = fk = built.fk = None
    ctx.free()

    # ---- the reference ----
    with sp("reference"):
        values, work = _reference(ctx, st, built, rows, got, pf, k, C)
    rec = {"setup_s": setup_s, "fit_s": sp.last("fit"),
           "factor_s": sp.last("factors"), "rows": n,
           "passes": len(got), "window_s": elapsed,
           "trace": summary, "work": work,
           "counters": {"before": before, "after": after}}
    ctx.log(f"allpairs_ooc: {len(got)} passes of {n} rows in "
            f"{elapsed:.3f} s, {failed} failed; counters over the window "
            + ", ".join(f"{c} {after[c] - before[c]:.0f}" for c in COUNTERS)
            + f"; reference {sp.last('reference'):.3f} s")
    return {"attempted": len(got) + raised,
            "failed": failed, "record": rec, "values": values,
            "memory_peak_bytes": peak}


def _forest_checks(ctx, st: dict, built, pf: dict):
    """``pb/verify.py::forest_checks``, with the fit's edges from the
    trainer's row sample (``reference/edges.py``)."""
    torch, cfg, dev = ctx.torch, ctx.cfg, ctx.device
    ref = Forest(torch, st, built.X, built.y, cfg["kernel_method"], dev)
    thr, unmatched = rforest.fit_thresholds(
        st, edges.fit_edges(built.X, cfg["n_bins"], deployment_seed(cfg)))
    fit_leaves = rforest.route(torch, st, built.X, dev, thr=thr)
    C = cfg["n_classes"]

    def mismatch(leaves):
        gl = rforest.global_leaves(torch, st, leaves)
        count, hist = rforest.leaf_tallies(torch, st, gl, built.y, C)
        return checks.fit_mismatch(st, count, hist, True)

    ctx.log(f"fit: {checks.route_mismatch(fit_leaves, ref.leaves)} (row, "
            f"tree) leaves differ between the fit's float64 edges and the "
            f"stored float32 thresholds, {mismatch(ref.leaves)} of "
            f"{st['total_leaves']} leaves tally otherwise by the latter; "
            f"{unmatched} nodes match no edge")
    return ref, {
        "fit_leaf_mismatch": mismatch(fit_leaves),
        "route_mismatch": checks.route_mismatch(pf["leaves"], ref.leaves),
        "weight_gap": max(checks.weight_gap(pf["q"], ref.q),
                          checks.weight_gap(pf["w"], ref.w)),
    }


def _reference(ctx, st, built, rows, got, pf, k, C):
    torch, dev = ctx.torch, ctx.device
    ref, values = _forest_checks(ctx, st, built, pf)
    rd = torch.as_tensor(rows, device=dev)
    Y = onehot(torch, built.y, C, torch.float64, dev)
    m, n = len(rows), int(built.X.shape[0])
    Pn = np.empty((m, n))
    ri = np.empty((m, k), np.int64)
    rv = np.empty((m, k))
    rs = np.empty((m, C))
    for i0, i1, P in ref.ref.blocks(ref.gl[rd], ref.q[rd], chunk=REF_ROWS):
        bi, bv = topk(torch, P, k)
        ri[i0:i1], rv[i0:i1] = bi.cpu().numpy(), bv.cpu().numpy()
        rs[i0:i1] = class_sq_sums(P, Y).cpu().numpy()
        Pn[i0:i1] = P.cpu().numpy()
        del P, bi, bv
    # no pass compared is no pass shown correct
    tg = sg = 0.0 if got else float("inf")
    im = 0 if got else Pn.size
    for idx, val, sq in got:
        tg = max(tg, checks.topk_gap(idx, val, Pn, rv))
        im = max(im, checks.topk_index_mismatch(idx, val, Pn, ri))
        sg = max(sg, checks.rel_gap(sq, rs))
    values.update({"topk_gap": tg, "topk_index_mismatch": im,
                   "class_sum_gap": sg})
    nbytes, fmas = roofline.allpairs_work(
        torch, ref.gl, ref.q, ref.gl, ref.w, int(st["total_leaves"]), k, C)
    return values, {"pass_bytes": nbytes, "pass_fmas": fmas}
