"""RF-GAP (Rhodes, Cutler & Moon 2023), worked out from the routed leaves
and the in-bag counts.

Training rows: q_t(i) = o_t(i) / S(i), with o_t(i) = 1 where row i is out
of bag for tree t and S(i) = max(1, Σ_t o_t(i)); references:
w_t(j) = c_t(j) / max(1, M_t(leaf)), with c_t(j) the in-bag count and
M_t(leaf) the in-bag count of the leaf.
"""
from __future__ import annotations


def train_factors(torch, st: dict, gl, y):
    L = int(st["total_leaves"])
    inbag = torch.as_tensor(st["inbag"], device=gl.device).t()   # (N, T)
    oob = (inbag == 0).double()
    S = oob.sum(1).clamp_min(1.0)
    q = oob / S[:, None]
    mass = torch.bincount(gl.reshape(-1).long(),
                          weights=inbag.reshape(-1).double(), minlength=L)
    w = inbag.double() / mass[gl.long()].clamp_min(1.0)
    return q, w
