"""Checks every cell makes of the model and its factors: the fit's leaf
tallies, and the training rows' routing (K1) and the weights against the
reference's."""
from __future__ import annotations

from reference import forest as rforest
from reference.pipeline import Forest

from . import checks


def forest_checks(ctx, st: dict, built, pf: dict):
    """(reference forest, {name: number}).

    The fit is checked by its leaves: each leaf's stored in-bag count (and,
    for a classification forest, class histogram) against the in-bag tally
    of the training rows that the fit's own bin edges send there.  Routed
    by the stored float32 thresholds instead, a row between a threshold and
    its float64 edge lands in the other leaf; those are logged, beside the
    leaves that tally differs at."""
    torch, cfg, dev = ctx.torch, ctx.cfg, ctx.device
    ref = Forest(torch, st, built.X, built.y, cfg["kernel_method"], dev)
    thr, unmatched = rforest.fit_thresholds(
        st, rforest.fit_edges(built.X, cfg["n_bins"]))
    fit_leaves = rforest.route(torch, st, built.X, dev, thr=thr)
    classes = cfg["model_type"] != "gbt"
    C = cfg["n_classes"] if classes else 0

    def mismatch(leaves):
        gl = rforest.global_leaves(torch, st, leaves)
        count, hist = rforest.leaf_tallies(torch, st, gl, built.y, C)
        return checks.fit_mismatch(st, count, hist, classes)

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
