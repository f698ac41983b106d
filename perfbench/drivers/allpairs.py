"""All-pairs proximity jobs over the training set, whole passes back to back.

A pass is ``fk.topk(k)`` over every training row (the neighbour graph),
then ``fk.engine.squared_row_sums(class_ids=y)`` (the class-bucketed
squared sums of RF-GAP outlier scores), then a synchronise.  Set-up makes
the rows, fits the forest, builds the factors and runs one pass (the leaf
index and every shape the window uses).  The window runs passes until
``--seconds`` have gone by; the rate is the rows of the whole passes over
the time from the window's start to the end of the last one.

Correctness: every pass's answers at ``check_rows`` training rows drawn
from the seed, against the plain reference (``reference/``): the top-k
values and columns (with the tie rule) and the class sums; the training
rows' routing and the weights whole; the fit's leaf tallies.
"""
from __future__ import annotations

import traceback

import numpy as np

from pb import checks, program, roofline, trace
from pb.rng import stream
from pb.verify import forest_checks
from reference.prox import class_sq_sums, onehot, topk


def run(ctx) -> dict:
    torch, cfg, mix, sp = ctx.torch, ctx.cfg, ctx.mix, ctx.spans
    built = program.build(cfg, ctx.seed, ctx.device, sp, dtype=ctx.dtype)
    fk, y = built.fk, built.y
    k, C = int(mix["k"]), int(cfg["n_classes"])

    def one_pass():
        with sp("topk"):
            idx, val = fk.topk(k=k)
        with sp("squared_row_sums"):
            sq = fk.engine.squared_row_sums(class_ids=y, n_classes=C)
        with sp("sync", sync=True):
            pass
        return idx, val, sq

    with sp("warmup", sync=True):
        one_pass()
    setup_s = sp.clock() - ctx.t_start
    ctx.log("setup: " + ", ".join(f"{s} {sp.last(s):.3f} s" for s in
                                  ("data", "fit", "factors", "warmup"))
            + f"; {setup_s:.3f} s from the process's start")
    ctx.settle()
    prof = trace.start() if ctx.trace else None
    sp.tracing = ctx.trace
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
    sp.tracing = False
    summary = trace.summarize(*trace.stop(prof)) if prof else None
    peak = ctx.memory_peak()
    n = int(built.X.shape[0])

    # ---- after the window: the answers at the sampled rows ----
    rows = np.sort(stream(ctx.seed, 7).choice(n, min(n, mix["check_rows"]),
                                              replace=False))
    rd = torch.as_tensor(rows, device=ctx.device)
    got, failed = [], raised
    for out in outs:
        failed += not all(bool(torch.isfinite(t).all()) for t in out[1:])
        got.append(tuple(t[rd].cpu().numpy() for t in out))
    st = program.model_state(fk, cfg)
    pf = program.program_factors(fk)
    outs = out = fk = built.fk = None
    ctx.free()

    # ---- the reference ----
    with sp("reference"):
        values, work = _reference(ctx, st, built, rows, got, pf, k, C)
    rec = {"setup_s": setup_s, "fit_s": sp.last("fit"),
           "factor_s": sp.last("factors"), "rows": n,
           "passes": len(got), "window_s": elapsed,
           "trace": summary, "work": work}
    ctx.log(f"allpairs: {len(got)} passes of {n} rows in {elapsed:.3f} s, "
            f"{failed} failed; reference {sp.last('reference'):.3f} s")
    return {"attempted": len(got) + raised,
            "failed": failed, "record": rec, "values": values,
            "memory_peak_bytes": peak}


def _reference(ctx, st, built, rows, got, pf, k, C):
    torch, dev = ctx.torch, ctx.device
    ref, values = forest_checks(ctx, st, built, pf)
    rd = torch.as_tensor(rows, device=dev)
    Y = onehot(torch, built.y, C, torch.float64, dev)
    P = torch.cat([b for _, _, b in ref.ref.blocks(ref.gl[rd], ref.q[rd])])
    ri, rv = topk(torch, P, k)
    rs = class_sq_sums(P, Y).cpu().numpy()
    Pn, ri, rv = P.cpu().numpy(), ri.cpu().numpy(), rv.cpu().numpy()
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
