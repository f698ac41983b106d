"""The collision path's crossover on the card: for each forest, one
train-side all-pairs pass (``topk(k=10)`` and the class-bucketed squared
row sums) on dense blocks and on the collision path, with the engine's
collision share.  Not a test; ``PERF.md`` §6 (PR 27) holds its table.

    python3 tests/_collide_probe.py [label ...]

from the root of a checkout on a machine with a card (every label by
default; labels as in ``FORESTS``).  Rows come from the benchmark's
generators (``perfbench/data/``) at a fixed seed; the dense path is timed
over the first ``dense_rows`` rows and scaled to all of them, the
collision path over every row.  One ``PROBE`` JSON line a forest.
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "perfbench"), os.path.join(ROOT, "src")]

G = "rf_gap_ooc_1m"
# label: (configuration, overrides, dense rows timed)
FORESTS = {
    "gauss100k_leaf3": (G, {"n_train": 100_000}, 100_000),
    "gauss100k_leaf30": (G, {"n_train": 100_000, "min_samples_leaf": 30},
                         100_000),
    "gauss100k_leaf100": (G, {"n_train": 100_000, "min_samples_leaf": 100},
                          100_000),
    "gauss100k_leaf300": (G, {"n_train": 100_000, "min_samples_leaf": 300},
                          100_000),
    "gauss100k_leaf1000": (G, {"n_train": 100_000,
                               "min_samples_leaf": 1000}, 100_000),
    "gauss100k_leaf3000": (G, {"n_train": 100_000,
                               "min_samples_leaf": 3000}, 100_000),
    "covtype100k": ("rf_gap_covtype", {}, 100_000),
    "gbt100k": ("gbt_boosted_higgs", {}, 100_000),
    "gauss316k_leaf3": (G, {"n_train": 316_228}, 32_768),
    "gauss1m_leaf3": (G, {"n_train": 1_000_000}, 16_384),
}
REPS = 3
SEED = 2147499001


def _median_s(torch, fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


def probe(label: str) -> dict:
    import torch
    from pb import common
    from repro_torch.core.api import ForestKernel
    from repro_torch.core.engine import QueryState
    name, over, dense_rows = FORESTS[label]
    cfg = dict(common.config(common.manifest(), name), **over)
    dev = torch.device("cuda", 0)
    X, y = common.load_module("data", cfg["generator"]).generate(
        cfg, SEED, "train", cfg["n_train"], dev)
    budget = cfg.get("memory_budget_bytes")
    with tempfile.TemporaryDirectory() as scratch:
        fk = ForestKernel(
            model_type=cfg["model_type"],
            kernel_method=cfg["kernel_method"], task=cfg["task"],
            n_trees=cfg["n_trees"], max_depth=cfg["max_depth"],
            min_samples_leaf=cfg["min_samples_leaf"],
            max_features=cfg["max_features"], n_bins=cfg["n_bins"], seed=7,
            device="cuda", scratch_dir=scratch if budget else None,
            memory_budget_bytes=budget).fit(X, y)
        eng, C = fk.engine, int(cfg["n_classes"])
        n, share = eng.n_ref, eng.collision_share()
        full = eng._train_state
        r = min(n, dense_rows)

        def one_pass():
            eng.topk(k=10)
            eng.squared_row_sums(class_ids=y, n_classes=C)
        eng._train_path = lambda X, k=None: "dense"
        eng._train_state = QueryState(eng.gl[:r], eng.q[:r],
                                      eng.total_leaves)
        dense_s = _median_s(torch, one_pass) * n / r
        eng._train_state = full
        eng._train_path = lambda X, k=None: \
            "collide" if X is None else "dense"
        collide_s = _median_s(torch, one_pass)
        return {"label": label, "rows": n, "trees": eng.gl.shape[1],
                "share": share,
                "products_per_row": float(eng._collide_cum[-1]) / n,
                "blocks": len(eng._collide_blocks[1]),
                "dense_pass_s": dense_s, "collide_pass_s": collide_s,
                "ratio": collide_s / dense_s}


def main(labels) -> int:
    from repro_torch.kernels import _build
    _build.build()
    for label in labels or FORESTS:
        print("PROBE " + json.dumps(probe(label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
