"""The harness's side of the program: build the cell's ``ForestKernel``
from the configuration (data from the seed, fit, factors), and read back,
once the window has closed, what the reference needs: the fitted trees and
in-bag counts (the model), and the program's routed leaves and weights
(judged against the reference's)."""
from __future__ import annotations

import dataclasses

import numpy as np

from .common import load_module


@dataclasses.dataclass
class Built:
    fk: object
    X: np.ndarray
    y: np.ndarray


def build(cfg: dict, seed: int, device, spans, dtype: str = None) -> Built:
    from repro_torch.core.api import ForestKernel
    gen = load_module("data", cfg["generator"])
    with spans("data"):
        X, y = gen.generate(cfg, seed, "train", cfg["n_train"], device)
    fk = ForestKernel(
        model_type=cfg["model_type"], kernel_method=cfg["kernel_method"],
        task=cfg["task"], n_trees=cfg["n_trees"], max_depth=cfg["max_depth"],
        min_samples_leaf=cfg["min_samples_leaf"],
        max_features=cfg["max_features"], n_bins=cfg["n_bins"],
        seed=int(seed), dtype=np.dtype(dtype or cfg["dtype"]).type,
        device=str(device))
    with spans("fit", sync=True):
        fk.fit_forest(X, y)
    with spans("factors", sync=True):
        fk.build_kernel_cache()
    return Built(fk=fk, X=X, y=y)


def model_state(fk, cfg: dict) -> dict:
    """The fitted forest as plain arrays padded to (T, M), with the in-bag
    counts, leaf offsets, each tree's leaf counts and values in leaf
    order, and what the configuration states of the booster."""
    trees = fk.forest.trees_
    T, M = len(trees), max(t.n_nodes for t in trees)
    st = {k: np.full((T, M), -1, np.int32)
          for k in ("feature", "left", "right", "leaf_id")}
    st["threshold"] = np.zeros((T, M), np.float32)
    counts, hists, values, n_leaves = [], [], [], []
    for t, tr in enumerate(trees):
        n = tr.n_nodes
        for k in ("feature", "left", "right", "leaf_id"):
            st[k][t, :n] = getattr(tr, k)
        st["threshold"][t, :n] = tr.threshold
        leaf = tr.leaf_nodes()
        n_leaves.append(len(leaf))
        counts.append(tr.n_node_samples[leaf].astype(np.float64))
        hists.append(np.asarray(tr.value[leaf], np.float64))
        values.append(np.asarray(tr.value[leaf, 1], np.float32)
                      if tr.value.shape[1] > 1 else None)
    n_leaves = np.asarray(n_leaves, np.int64)
    st["leaf_offset"] = np.concatenate([[0], np.cumsum(n_leaves)[:-1]])
    st["total_leaves"] = int(n_leaves.sum())
    st["leaf_count"] = np.concatenate(counts)
    st["leaf_hist"] = np.concatenate(hists)
    st["leaf_value"] = values
    st["inbag"] = np.asarray(fk.forest.inbag_, np.int32)
    st["task"] = cfg["task"]
    st["learning_rate"] = cfg.get("learning_rate")
    return st


def program_factors(fk):
    """The program's routed training leaves and its weights, on the
    host."""
    eng = fk.engine
    return {"leaves": fk.ctx.leaves.cpu().numpy(),
            "q": eng.q.double().cpu().numpy(),
            "w": eng.w.double().cpu().numpy()}
