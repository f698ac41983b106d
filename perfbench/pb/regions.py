"""The program's own spans in a window's device trace.

With its regions on (``repro_torch.obs.trace.set_regions``) the port's
engine opens ``torch.profiler`` ranges named ``repro:<name>``
(``engine.topk``, ``engine.k2``, ``engine.select``, ...) on the same
timeline and clock as the benchmark's ``bench:`` spans and the device ops.
``trace.stop`` would take those ranges' copies on the device's timeline for
operations, so a window traced with regions on is read with these two:

- ``stop``: ``trace.stop``'s device ops, each with the host time of the
  launch that carries its correlation id (-1 where the trace has none),
  the benchmark's spans, and the program's host ranges;
- ``summarize``: ``trace.summarize`` with idle gaps named by the innermost
  span of either kind, plus, where the trace holds program ranges, a
  ``program`` entry: for each span name its ``calls``, ``host_s``,
  ``self_s`` (less its child spans) and ``device_s`` (the device seconds of
  the ops whose launch lies innermost in it); ``unspanned_device_s``, the
  device seconds of ops launched in no program span, and
  ``unmatched_ops``, the ops whose launch the trace lacks (counted as
  launched in no span).

``per_pass`` turns the entry into the per-pass numbers PERF.md §3 names.
Everything is clipped to the ``window`` span, as in ``trace.summarize``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import trace


def stop(prof) -> Tuple[list, list, list]:
    """End the profile; returns (device ops as (name, start_ns, end_ns,
    launch_ns), benchmark spans, program ranges), each span and range as
    (name without its prefix, start_ns, end_ns)."""
    import torch
    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    device, spans, ranges, launch = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, on_device = e.name(), e.device_type() == cuda
        if name.startswith(("bench:", "repro:")):
            # a host span; its copy on the device's timeline is an
            # annotation, not an operation
            if not on_device:
                t0 = e.start_ns()
                (spans if name[0] == "b" else ranges).append(
                    (name[6:], t0, t0 + e.duration_ns()))
        elif on_device:
            t0 = e.start_ns()
            device.append((name, t0, t0 + e.duration_ns(),
                           e.correlation_id()))
        elif name.startswith("cu"):
            # a CUDA API call (cudaLaunchKernel, cudaMemcpyAsync,
            # cuLaunchKernel, ...): the correlation id its device op
            # carries
            launch[e.correlation_id()] = e.start_ns()
    return ([(n, s, t, launch.get(c, -1)) for n, s, t, c in device],
            spans, ranges)


def _nest(ranges: List[tuple]):
    """For ranges sorted by (start, -end), properly nested: each one's
    parent index (-1 for none), and the innermost range as a step function
    of time: (times, index of the innermost range from that time on)."""
    parent = np.full(len(ranges), -1, dtype=np.int64)
    times, who, stack = [], [], []

    def close_until(t):
        while stack and ranges[stack[-1]][2] <= t:
            j = stack.pop()
            times.append(ranges[j][2])
            who.append(stack[-1] if stack else -1)

    for i, (_, s, _) in enumerate(ranges):
        close_until(s)
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
        times.append(s)
        who.append(i)
    close_until(np.iinfo(np.int64).max)
    return parent, np.array(times, dtype=np.int64), np.array(who,
                                                            dtype=np.int64)


def summarize(device: List[tuple], spans: List[tuple],
              ranges: List[tuple], top: int = 10) -> Dict:
    """``trace.summarize`` of the window, gaps named by the innermost span
    of either kind, and the ``program`` entry where ``ranges`` holds a
    program range in the window."""
    out = trace.summarize([d[:3] for d in device], spans + ranges, top)
    w0, w1 = [(s, e) for n, s, e in spans if n == trace.WINDOW][-1]
    rs = sorted(((n, max(s, w0), min(e, w1)) for n, s, e in ranges
                 if e > w0 and s < w1), key=lambda r: (r[1], -r[2]))
    if not rs:
        return out
    parent, times, who = _nest(rs)
    host = np.array([e - s for _, s, e in rs], dtype=np.int64)
    child = np.zeros(len(rs), dtype=np.int64)
    has = parent >= 0
    np.add.at(child, parent[has], host[has])
    st = np.array([d[1] for d in device], dtype=np.int64)
    en = np.array([d[2] for d in device], dtype=np.int64)
    ln = np.array([d[3] for d in device], dtype=np.int64)
    inside = (en > w0) & (st < w1)
    dur = (np.clip(en, w0, w1) - np.clip(st, w0, w1))[inside]
    ln = ln[inside]
    pos = np.searchsorted(times, ln, side="right") - 1
    inner = np.where((ln >= 0) & (pos >= 0), who[np.maximum(pos, 0)], -1)
    dev = np.zeros(len(rs), dtype=np.int64)
    np.add.at(dev, inner[inner >= 0], dur[inner >= 0])
    per: Dict[str, Dict[str, float]] = {}
    for i, (n, _, _) in enumerate(rs):
        v = per.setdefault(n, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                               "device_s": 0.0})
        v["calls"] += 1
        v["host_s"] += host[i] / 1e9
        v["self_s"] += (host[i] - child[i]) / 1e9
        v["device_s"] += dev[i] / 1e9
    out["program"] = {"spans": per,
                      "unspanned_device_s": float(dur[inner < 0].sum()) / 1e9,
                      "unmatched_ops": int((ln < 0).sum())}
    return out


def per_pass(summary: Optional[Dict], passes: int) -> Optional[Dict]:
    """Milliseconds a pass (None without a ``program`` entry or a pass):

    - ``topk_select_ms``: device ms of ops launched in ``engine.select``;
    - ``class_sums_ms``: in ``engine.class_ids`` and ``engine.class_sums``;
    - ``k2_ms``: in ``engine.k2``;
    - ``unspanned_ms``: launched in no program span;
    - ``engine_wait_ms``: host ms in ``engine.spill_read`` and
      ``engine.class_ids`` (the host reads and the one-hot's copy);
    - ``engine_host_ms``: host ms in ``engine.topk`` and
      ``engine.squared_row_sums``, less ``engine_wait_ms``.
    """
    p = (summary or {}).get("program")
    if not p or not passes:
        return None
    sp = p["spans"]

    def ms(key, *names):
        return sum(sp.get(n, {}).get(key, 0.0) for n in names) \
            / passes * 1e3

    wait = ms("host_s", "engine.spill_read", "engine.class_ids")
    return {"topk_select_ms": ms("device_s", "engine.select"),
            "class_sums_ms": ms("device_s", "engine.class_ids",
                                "engine.class_sums"),
            "k2_ms": ms("device_s", "engine.k2"),
            "unspanned_ms": p["unspanned_device_s"] / passes * 1e3,
            "engine_wait_ms": wait,
            "engine_host_ms": ms("host_s", "engine.topk",
                                 "engine.squared_row_sums") - wait}
