"""The device trace of a window: ``torch.profiler`` over the window, reduced
to what the per-layer readers need.

- ``busy_s``: the union of the intervals in which any device operation
  (kernel, copy, set) ran, clipped to the window; summing durations would
  count overlaps twice.
- ``ops``: device seconds and launches by operation name.
- ``gaps``: the longest idle intervals, each named by the innermost
  ``bench:`` span (the harness's own host spans) that holds its midpoint.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

WINDOW = "window"


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> Tuple[list, list]:
    """End the profile; returns (device ops, host spans), each a list of
    (name, start_ns, end_ns)."""
    import torch
    prof.__exit__(None, None, None)
    device, spans = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("bench:"):
            # a host span; its copy on the device's timeline is an
            # annotation, not an operation
            if e.device_type() == cuda:
                continue
            t0 = e.start_ns()
            spans.append((name[6:], t0, t0 + e.duration_ns()))
        elif e.device_type() == cuda:
            t0 = e.start_ns()
            device.append((name, t0, t0 + e.duration_ns()))
    return device, spans


def union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends): (group starts, group ends)."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    gi = np.cumsum(new) - 1
    gs = s[new]
    ge = np.zeros(len(gs), dtype=e.dtype)
    np.maximum.at(ge, gi, e)
    return gs, ge


def summarize(device: List[tuple], spans: List[tuple],
              top: int = 10) -> Dict:
    """Reduce a window's trace.  ``spans`` must hold one ``window`` span;
    device ops are clipped to it."""
    win = [(s, e) for n, s, e in spans if n == WINDOW]
    if not win:
        raise ValueError("the trace holds no window span")
    w0, w1 = win[-1]
    names = [n for n, _, _ in device]
    st = np.array([s for _, s, _ in device], dtype=np.int64)
    en = np.array([e for _, _, e in device], dtype=np.int64)
    inside = (en > w0) & (st < w1)
    st, en = np.clip(st[inside], w0, w1), np.clip(en[inside], w0, w1)
    names = [n for n, k in zip(names, inside) if k]
    ops: Dict[str, List[float]] = {}
    for n, s, e in zip(names, st, en):
        v = ops.setdefault(n, [0.0, 0])
        v[0] += (e - s) / 1e9
        v[1] += 1
    gs, ge = union(st, en)
    busy = float((ge - gs).sum()) / 1e9
    # idle gaps: before the first op, between merged groups, after the last
    edges_s = np.concatenate([[w0], ge])
    edges_e = np.concatenate([gs, [w1]])
    gap = edges_e - edges_s
    order = np.argsort(-gap, kind="stable")[:top]
    inner = [(n, s, e) for n, s, e in spans if n != WINDOW]
    gaps = []
    for i in order:
        if gap[i] <= 0:
            break
        mid = (edges_s[i] + edges_e[i]) // 2
        best, width = WINDOW, None
        for n, s, e in inner:
            if s <= mid <= e and (width is None or e - s < width):
                best, width = n, e - s
        gaps.append([best, float(gap[i]) / 1e9])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "ops": ops,
            "gaps": gaps}


def top_ops(summary: Dict, top: int = 10) -> List[list]:
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    return [[n, v[0]] for n, v in ops]


def seconds_of(summary: Dict, *needles: str, invert: bool = False) -> float:
    """Device seconds of the ops whose names hold any of ``needles`` (or,
    with ``invert``, of every other op)."""
    return sum(v[0] for n, v in summary["ops"].items()
               if any(s in n for s in needles) != invert)
