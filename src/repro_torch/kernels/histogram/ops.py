"""Split-histogram wrappers: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else.

Replaces ``repro/kernels/histogram/ops.py::histogram`` / ``moments``.  The
reference chunks nodes (64 at a time, over stably pre-sorted sample ranges)
and features (to a VMEM budget) around its Pallas calls.  Here one launch
covers every node: the wrapper stable-sorts samples by node when they are
not sorted already (the trainer's frontier is), cuts each node's sample
range into work items (``work_items``: a large node into equal segments,
whose partial histograms a second, fixed-order pass sums, so that a level
with few nodes still gives the card enough blocks), and slices features per
block to the card's shared memory (``slice_plan``).

Codes are ``uint8``, ``int16`` (more than 256 bins) or ``int32``, taken as
they are.  ``rows`` optionally names the code row of each sample, so the
trainer passes its frontier's row ids into the whole code matrix instead of
gathering codes.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..._tensor import require
from .ref import histogram_ref, moments_ref

__all__ = ["histogram", "moments", "slice_plan", "work_items"]

_TILE = 128        # samples staged per block step (HIST_TILE in the source)
_MAX_WARPS = 32    # one warp per feature of a slice
_TARGET_ITEMS = 512  # a launch's samples are cut into about this many
_MIN_SEGMENT = 256  # ... segments, but none shorter than this
_MAX_SEGMENTS = 128  # segments a node is cut into at most
_CODE_DTYPES = (torch.uint8, torch.int16, torch.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    ptrs = [ctypes.c_void_p] * 6
    lib.histogram_classes.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + ptrs[:5] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.histogram_classes.restype = ctypes.c_int
    lib.histogram_moments.argtypes = [
        ctypes.c_void_p, ctypes.c_int] + ptrs[:4] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.histogram_moments.restype = ctypes.c_int
    lib.histogram_reduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]
    lib.histogram_reduce.restype = ctypes.c_int
    return lib


def work_items(bounds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Cut each node's sample range ``bounds[i] .. bounds[i + 1]`` into work
    items for the kernel.

    The segment length is ``max(_MIN_SEGMENT, ceil(m / _TARGET_ITEMS))``
    for the call's m samples, a function of the inputs alone, so the sums
    (and their bits) do not depend on the card.  A node of at most one
    segment (empty ones included) is one item that writes output row i.  A
    larger node is cut into ``min(ceil(count / segment), _MAX_SEGMENTS)``
    equal segments that write partial rows numbered from ``n_nodes`` on.
    Returns ``(items, red, n_partial)``: items (n_items, 3) int64 (first
    sample, end sample, row), red (n_cut, 3) int64 (node, first partial
    row, count) for the reduce pass, and the number of partial rows.
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    n_nodes = len(bounds) - 1
    cnt = np.diff(bounds)
    seg = max(_MIN_SEGMENT, -(-int(bounds[-1] - bounds[0]) // _TARGET_ITEMS))
    nseg = np.clip(-(-cnt // seg), 1, _MAX_SEGMENTS)
    node = np.repeat(np.arange(n_nodes, dtype=np.int64), nseg)
    k = np.arange(len(node), dtype=np.int64) - np.repeat(
        np.cumsum(nseg) - nseg, nseg)
    s, c, ns = bounds[node], cnt[node], nseg[node]
    cut = ns > 1
    n_partial = int(cut.sum())
    row = np.where(cut, n_nodes + np.cumsum(cut) - 1, node)
    items = np.stack([s + k * c // ns, s + (k + 1) * c // ns, row], axis=1)
    cut_nodes = np.flatnonzero(nseg > 1)
    first = n_nodes + np.cumsum(nseg[cut_nodes]) - nseg[cut_nodes]
    red = np.stack([cut_nodes, first, nseg[cut_nodes]], axis=1)
    return items, red.astype(np.int64), n_partial


def slice_plan(d: int, n_bins: int, n_channels: int, n_values: int,
               classes: bool, smem_limit: int) -> Tuple[int, bool]:
    """(features per block, histogram in shared memory?) for one launch.

    A block holds its slice's ``Ds × n_bins × n_channels`` float32
    histogram plus the staged tile (``Ds`` codes, a label and ``n_values``
    payloads per sample) in ``smem_limit`` bytes, with one warp per feature
    (at most 32).  When not even one feature's histogram fits, the warps
    accumulate in the zeroed output instead.  Slices are balanced, so
    ``ceil(d / Ds)`` blocks cover a node.
    """
    stage = 4 * _TILE * (n_values + (1 if classes else 0))
    per_feat = 4 * (n_bins * n_channels + _TILE + 1)
    fit = (smem_limit - stage) // per_feat
    smem = fit >= 1
    ds = max(1, min(d, _MAX_WARPS, fit if smem else _MAX_WARPS))
    n_slices = math.ceil(d / ds)
    return math.ceil(d / n_slices), smem


def _check_common(xb, node, rows, cols: Sequence[Tuple[str, torch.Tensor,
                                                       torch.dtype]]):
    if not isinstance(xb, torch.Tensor) or xb.dtype not in _CODE_DTYPES:
        raise TypeError(f"xb must be a uint8, int16 or int32 tensor, got "
                        f"{getattr(xb, 'dtype', type(xb))}")
    if xb.dim() != 2:
        raise ValueError(f"xb must be (N, D), got {tuple(xb.shape)}")
    dev = xb.device
    require(node, torch.int32, "node", dev)
    m = node.shape[0]
    if rows is not None:
        if not isinstance(rows, torch.Tensor) or rows.dtype not in (
                torch.int32, torch.int64):
            raise TypeError("rows must be an int32 or int64 tensor")
        require(rows, rows.dtype, "rows", dev)
        if rows.shape != (m,):
            raise ValueError(f"rows must be ({m},), got {tuple(rows.shape)}")
    elif xb.shape[0] != m:
        raise ValueError(f"xb has {xb.shape[0]} rows for {m} samples")
    for name, c, dt in cols:
        require(c, dt, name, dev)
        if c.shape[0] != m:
            raise ValueError(f"{name} has {c.shape[0]} rows for {m} samples")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"histograms run on 'cuda' or 'cpu', got {dev}")
    return dev, m


def _launch(classes: bool, xb, node, rows, cols, n_nodes, n_bins, C):
    """Sort by node if needed, cut the nodes' ranges into work items,
    launch, and sum the cut nodes' partial rows."""
    dev = xb.device
    d = xb.shape[1]
    slots = torch.arange(n_nodes + 1, dtype=torch.int32, device=dev)
    # one device-to-host copy: the node bounds, the row ids' range (the
    # kernel reads code rows through them) and whether the bounds are valid
    # (samples already in node order, as the trainer hands them)
    node = node.contiguous()
    span = torch.stack([rows.min(), rows.max()]).long() if rows is not None \
        else torch.zeros(2, dtype=torch.int64, device=dev)
    unsorted = (node[1:] < node[:-1]).any().to(torch.int64)[None]
    got = torch.cat([torch.searchsorted(node, slots), span, unsorted]).cpu()
    if got[-3] < 0 or got[-2] >= xb.shape[0]:
        raise IndexError(f"rows out of range for {xb.shape[0]} code rows")
    if got[-1]:
        node, order = torch.sort(node, stable=True)
        cols = [c[order] for c in cols]
        rows = order if rows is None else rows[order]
        got = torch.searchsorted(node, slots).cpu()
    rows = None if rows is None else rows.to(torch.int32).contiguous()
    cols = [c.contiguous() for c in cols]
    items, red, n_partial = work_items(got[:n_nodes + 1].numpy())
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    n_values = 1 if classes else C
    ds, smem = slice_plan(d, n_bins, C, n_values, classes, int(limit))
    out = (torch.empty if smem else torch.zeros)(
        (n_nodes + n_partial, d, n_bins, C), dtype=torch.float32, device=dev)
    plan = torch.as_tensor(np.concatenate([items, red]), device=dev)
    items_d, red_d = plan[:len(items)], plan[len(items):]
    xb = xb.contiguous()
    rows_p = None if rows is None else rows.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if classes:
            err = lib.histogram_classes(
                xb.data_ptr(), xb.element_size(), rows_p, cols[0].data_ptr(),
                cols[1].data_ptr(), items_d.data_ptr(), out.data_ptr(),
                len(items), d, n_bins, C, ds, int(smem), stream)
        else:
            err = lib.histogram_moments(
                xb.data_ptr(), xb.element_size(), rows_p, cols[0].data_ptr(),
                items_d.data_ptr(), out.data_ptr(), len(items), d, n_bins, C,
                ds, int(smem), stream)
        _build.check(lib, err, "histogram launch")
        err = lib.histogram_reduce(out.data_ptr(), red_d.data_ptr(),
                                   len(red), d * n_bins * C, stream)
    _build.check(lib, err, "histogram reduce launch")
    return out[:n_nodes]


def histogram(xb: torch.Tensor, node: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, n_nodes: int, n_bins: int, n_classes: int,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_nodes, D, n_bins, n_classes) float32 weighted class histograms.

    ``xb`` (N, D) codes; ``node``/``y`` (m,) int32 and ``w`` (m,) float32
    per sample; sample i's codes are ``xb[rows[i]]`` (``xb[i]`` when
    ``rows`` is None).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``histogram.launches``) or raise.
    """
    dev, m = _check_common(xb, node, rows, (("y", y, torch.int32),
                                            ("w", w, torch.float32)))
    d = xb.shape[1]
    if dev.type == "cpu":
        codes = xb if rows is None else xb[rows.long()]
        return histogram_ref(codes, node, y, w, n_nodes, n_bins, n_classes)
    if m == 0 or n_nodes == 0 or d == 0:
        return torch.zeros((n_nodes, d, n_bins, n_classes),
                           dtype=torch.float32, device=dev)
    out = _launch(True, xb, node, rows, [y, w], n_nodes, n_bins, n_classes)
    histogram.launches += 1
    return out


def moments(xb: torch.Tensor, node: torch.Tensor, wm: torch.Tensor,
            n_nodes: int, n_bins: int,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_nodes, D, n_bins, K) float32 payload-sum histograms of the (m, K)
    float32 payload columns ``wm`` (the trainer passes w, w·y, w·y²).

    Same inputs and device rules as :func:`histogram`; launches are counted
    in ``moments.launches``.
    """
    dev, m = _check_common(xb, node, rows, (("wm", wm, torch.float32),))
    if wm.dim() != 2:
        raise ValueError(f"wm must be (m, K), got {tuple(wm.shape)}")
    d, k = xb.shape[1], wm.shape[1]
    if dev.type == "cpu":
        codes = xb if rows is None else xb[rows.long()]
        return moments_ref(codes, node, wm, n_nodes, n_bins, k)
    if m == 0 or n_nodes == 0 or d == 0 or k == 0:
        return torch.zeros((n_nodes, d, n_bins, k), dtype=torch.float32,
                           device=dev)
    out = _launch(False, xb, node, rows, [wm], n_nodes, n_bins, k)
    moments.launches += 1
    return out


histogram.launches = 0
moments.launches = 0
