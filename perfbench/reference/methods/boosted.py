"""Boosted proximities (Tan et al. 2020): q_t = w_t = sqrt(v_t / Σ_s v_s),
with v_t the training-loss decrease of boosting stage t (clamped at 0).

The stages are replayed in NumPy from the routed leaves and the stored
leaf values: F starts at the log-odds of the positive share and takes
``learning_rate × value`` at each stage, the loss is the mean logistic
loss (binary classification) or squared error.  The update is written as
the booster writes it (the float32 leaf value times the rate, added to a
float64 F), so that the loss decreases carry no rounding of their own.
"""
from __future__ import annotations

import numpy as np


def tree_weights(st: dict, leaves: np.ndarray, y) -> np.ndarray:
    lr = float(st["learning_rate"])
    yf = np.asarray(y, dtype=np.float64)
    binary = st["task"] == "classification"
    if binary:
        p0 = np.clip(yf.mean(), 1e-6, 1 - 1e-6)
        F = np.full(len(yf), float(np.log(p0 / (1 - p0))))
    else:
        F = np.full(len(yf), float(yf.mean()))

    def loss(F):
        if binary:
            return float(np.mean(np.logaddexp(0.0, F) - yf * F))
        return float(np.mean((yf - F) ** 2))

    prev = loss(F)
    tw = []
    for t, vals in enumerate(st["leaf_value"]):
        F = F + lr * vals[leaves[:, t]]
        cur = loss(F)
        tw.append(max(prev - cur, 0.0))
        prev = cur
    tw = np.asarray(tw)
    return tw / max(tw.sum(), 1e-12)


def _per_tree(torch, st, gl):
    tw = st["_tree_weights"]
    per = np.sqrt(tw / max(tw.sum(), 1e-300))
    return torch.as_tensor(per, device=gl.device)[None, :] \
        .expand(tuple(gl.shape)).contiguous()


def train_factors(torch, st: dict, gl, y):
    leaves = (gl.long() - torch.as_tensor(st["leaf_offset"],
                                          device=gl.device)[None, :])
    st["_tree_weights"] = tree_weights(st, leaves.cpu().numpy(), y)
    q = _per_tree(torch, st, gl)
    return q, q
