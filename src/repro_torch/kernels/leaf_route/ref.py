"""Plain PyTorch version of the routing kernel.

The tree-major active-lane pass of the reference's ``_route_batched_numpy``
written in torch ops: every (sample, tree) lane advances one node per step
(gather feature → compare ``x <= thr`` in float64 → gather child), and lanes
that reach a leaf are written out and dropped.  It runs on any device; the
wrapper uses it for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.
"""
from __future__ import annotations

import torch

__all__ = ["route_ref"]


def route_ref(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
              lr: torch.Tensor, leaf_id: torch.Tensor, n_trees: int,
              max_nodes: int) -> torch.Tensor:
    """(N, T) int32 within-tree leaf ids.

    X: (N, D) float64; feature, leaf_id: (T·M,) int32; threshold: (T·M,)
    float64; lr: (2·T·M,) int32 interleaved children — ``TreeArrays.flat()``
    on X's device.
    """
    n, d = X.shape
    dev = X.device
    T, M = n_trees, max_nodes
    Xf = X.reshape(-1)
    out = torch.empty(T * n, dtype=torch.int32, device=dev)
    cur = torch.arange(T, dtype=torch.int64, device=dev) \
        .repeat_interleave(n) * M                            # roots, (T·N,)
    xbase = (torch.arange(n, dtype=torch.int64, device=dev) * d).repeat(T)
    outidx = torch.arange(T * n, dtype=torch.int64, device=dev)
    fa = feature[cur].long()
    done = fa < 0                                            # stump trees
    out[outidx[done]] = leaf_id[cur[done]]
    keep = ~done
    cur, xbase, outidx, fa = cur[keep], xbase[keep], outidx[keep], fa[keep]
    # children ids exceed their parent's, so M steps always suffice
    for _ in range(M):
        if cur.numel() == 0:
            break
        # ~(x <= thr), not (x > thr): NaN features go right
        go_right = ~(Xf[xbase + fa] <= threshold[cur])
        nxt = lr[2 * cur + go_right.long()].long()
        fa = feature[nxt].long()
        done = fa < 0
        out[outidx[done]] = leaf_id[nxt[done]]
        keep = ~done
        cur, xbase, outidx, fa = nxt[keep], xbase[keep], outidx[keep], fa[keep]
    return out.view(T, n).t().contiguous()
