"""Split-histogram wrappers: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing else.

Replaces ``repro/kernels/histogram/ops.py::histogram`` / ``moments``.  The
reference chunks nodes (64 at a time, over stably pre-sorted sample ranges)
and features (to a VMEM budget) around its Pallas calls.  Here one launch
covers every node: samples lie in node order, each node's sample range is
cut into work items (``work_items``: a large node into equal segments,
whose partial histograms a second, fixed-order pass sums, so that a level
with few nodes still gives the card enough work; on the card the kernel
library's host copy of it writes the plan straight into pinned memory, and
the card tests hold the two equal), features are sliced per
block to the card's shared memory (``slice_plan``), and the kernel's mode
(a warp folding many features, or warps ranking samples) follows the
number of work units (``launch_plan``).  No plan changes a bit of the
result.

The caller names the node layout one of two ways:

* ``bounds=`` — host ``int64`` node offsets ``(n_nodes + 1,)`` with
  ``bounds[0] == 0`` and ``bounds[-1] == m``, for samples already in node
  order (the trainer's frontier), with ``node=None``.  With ``row_range=``
  (the host range ``(lo, hi)`` of the ``rows`` ids) as well, a call neither
  synchronises nor copies from the device: it issues the plan's copy from
  pinned memory, the output's zeroing when the histogram does not fit
  shared memory, the kernel, and the reduce when a node is cut.  This is
  the reference's own layout source (its wrapper reads the node ids on the
  host), not a user feature;
* ``node=`` — (m,) int32 node ids in any order: the wrapper finds the
  bounds, the row ids' range and whether the samples are sorted in one
  device-to-host copy, and stable-sorts by node when they are not.

Codes are ``uint8``, ``int16`` (more than 256 bins) or ``int32``, taken as
they are.  ``rows`` optionally names the code row of each sample, so the
trainer passes its frontier's row ids into the whole code matrix instead of
gathering codes; row ids outside the code matrix raise ``IndexError``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..._tensor import require
from .ref import histogram_ref, moments_ref

__all__ = ["histogram", "moments", "launch_plan", "slice_plan", "work_items"]

_TILE = 256        # rank mode: samples staged a step (HIST_TILE)
_WARPS = 32        # rank mode: one warp per feature of a slice
_TAGS = 128        # rank mode: tag slots of a warp
_BATCH = 32        # fold mode: samples staged a step (HIST_BATCH)
_LANES = 32        # fold mode: one lane per (feature, payload column)
_FOLD_UNITS_PER_SM = 2  # the fold mode when its units fill the SMs this often
_TARGET_ITEMS = 512  # a launch's samples are cut into about this many
_MIN_SEGMENT = 256  # ... segments, but none shorter than this
_MAX_SEGMENTS = 128  # segments a node is cut into at most
_CODE_DTYPES = (torch.uint8, torch.int16, torch.int32)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The kernel library, built and typed on first use."""
    global _LIB
    if _LIB is None:
        lib = _build.load("histogram")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.histogram_classes.argtypes = [p, i, p, i, p, p, p, p] + [i] * 7 \
            + [p]
        lib.histogram_classes.restype = i
        lib.histogram_moments.argtypes = [p, i, p, i, p, p, p] + [i] * 7 \
            + [p]
        lib.histogram_moments.restype = i
        lib.histogram_reduce.argtypes = [p, p, i, ctypes.c_longlong, p]
        lib.histogram_reduce.restype = i
        lib.histogram_plan.argtypes = [p, i, p]
        lib.histogram_plan.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(a block's opt-in shared memory, SM count) of a device."""
    props = torch.cuda.get_device_properties(index)
    return int(props.shared_memory_per_block_optin), \
        int(props.multi_processor_count)


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


def smem_bytes(ds: int, n_bins: int, n_channels: int, n_values: int,
               classes: bool, code_bytes: int, smem: bool,
               fold: bool = False) -> int:
    """Dynamic shared memory of one block (``smem_size`` in the source
    computes the same): staged row ids (8 bytes), labels and payloads of 3
    steps (rank) or 5 (fold), codes of 2 steps or 3 (a sample's slice as an
    odd number of 32-bit words), steps of 256 samples (rank) or 32 (fold);
    the rank mode's tag tables; the slice's float32 histogram when
    ``smem`` (each feature's table at an odd stride in the fold mode)."""
    words = -(-ds * code_bytes // 4) | 1
    meta, code, step = (5, 3, _BATCH) if fold else (3, 2, _TILE)
    table = n_bins * n_channels
    return step * (meta * (8 + 4 * (n_values + (1 if classes else 0)))
                   + code * 4 * words) \
        + (0 if fold else 4 * _TAGS * ds) \
        + (4 * ds * ((table | 1) if fold else table) if smem else 0)


@functools.lru_cache(maxsize=256)
def slice_plan(d: int, n_bins: int, n_channels: int, n_values: int,
               classes: bool, smem_limit: int, code_bytes: int = 1,
               fold: bool = False) -> Tuple[int, bool]:
    """(features per block, histogram in shared memory?) for one launch.

    A block holds its slice's ``Ds × n_bins × n_channels`` float32
    histogram plus the staged samples (``smem_bytes``) in ``smem_limit``
    bytes.  The rank mode gives each feature a warp (at most 32); the fold
    mode gives each feature a lane, and for moments each (feature, payload
    column) (at most 32 lanes).  When not even one feature's histogram
    fits, the rank mode's warps accumulate in the zeroed output instead
    (the fold mode is then not used).  Slices are balanced, so
    ``ceil(d / Ds)`` blocks cover a node.
    """
    per = 1 if classes or not fold else min(n_values, _LANES)
    top = max(1, min(d, (_LANES if fold else _WARPS) // per))

    def fits(ds):
        return smem_bytes(ds, n_bins, n_channels, n_values, classes,
                          code_bytes, True, fold) <= smem_limit
    smem = fits(1)
    ds = top
    if smem:
        while not fits(ds):
            ds -= 1
    n_slices = math.ceil(d / ds)
    return math.ceil(d / n_slices), smem


def launch_plan(d: int, n_bins: int, n_channels: int, n_values: int,
                classes: bool, code_bytes: int, n_items: int,
                smem_limit: int, n_sms: int) -> Tuple[bool, int, bool]:
    """(fold mode?, features per block, histogram in shared memory?).

    The fold mode runs a unit on one warp, so it fills the card only when
    the launch has many units: it is taken when its units are at least
    ``_FOLD_UNITS_PER_SM`` times the SMs (the acceptance forest's level-1
    call has 600 units on 132 SMs; a GBT stage's ~130-200 take the rank
    mode).  The mode changes no bit of the result.
    """
    ds, smem = slice_plan(d, n_bins, n_channels, n_values, classes,
                          smem_limit, code_bytes, fold=True)
    if smem and n_items * math.ceil(d / ds) >= _FOLD_UNITS_PER_SM * n_sms:
        return True, ds, smem
    return (False,) + slice_plan(d, n_bins, n_channels, n_values, classes,
                                 smem_limit, code_bytes)


def _check_bounds(bounds, n_nodes: int, m: int) -> np.ndarray:
    b = np.asarray(bounds)
    if b.dtype.kind not in "iu" or b.shape != (n_nodes + 1,):
        raise ValueError(f"bounds must be ({n_nodes + 1},) integer node "
                         f"offsets, got {b.dtype} {b.shape}")
    b = np.asarray(b, dtype=np.int64)
    if b[0] != 0 or b[-1] != m or (b[1:] < b[:-1]).any():
        raise ValueError(f"bounds must rise from 0 to the {m} samples, got "
                         f"{b[0]} .. {b[-1]}")
    return b


def _check_common(xb, node, rows, cols: Sequence[Tuple[str, torch.Tensor,
                                                       torch.dtype]],
                  bounds, n_nodes: int):
    """Validate the inputs; returns (device, m, host bounds or None)."""
    if not isinstance(xb, torch.Tensor) or xb.dtype not in _CODE_DTYPES:
        raise TypeError(f"xb must be a uint8, int16 or int32 tensor, got "
                        f"{getattr(xb, 'dtype', type(xb))}")
    if xb.dim() != 2:
        raise ValueError(f"xb must be (N, D), got {tuple(xb.shape)}")
    dev = xb.device
    if (node is None) == (bounds is None):
        raise ValueError("give the node layout as exactly one of node= and "
                         "bounds=")
    if node is not None:
        require(node, torch.int32, "node", dev)
        m = node.shape[0]
    else:
        require(cols[0][1], cols[0][2], cols[0][0], dev)
        m = cols[0][1].shape[0]
        bounds = _check_bounds(bounds, n_nodes, m)
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
    return dev, m, bounds


def _check_range(lo: int, hi: int, n_rows: int) -> None:
    if lo < 0 or hi >= n_rows:
        raise IndexError(f"rows out of range for {n_rows} code rows "
                         f"(ids {lo} .. {hi})")


def _plain_inputs(xb, node, rows, bounds, n_nodes, row_range):
    """(codes, node) for the plain version on the CPU, with the same row
    checks as the kernel's path."""
    if node is None:
        node = torch.repeat_interleave(
            torch.arange(n_nodes, dtype=torch.int32),
            torch.as_tensor(np.diff(bounds)))
    if rows is None:
        return xb, node
    if len(rows):
        lo, hi = int(rows.min()), int(rows.max())
        if row_range is not None and (lo < row_range[0]
                                      or hi > row_range[1]):
            raise ValueError(f"row ids {lo} .. {hi} lie outside row_range "
                             f"{tuple(row_range)}")
        _check_range(lo, hi, xb.shape[0])
    return xb[rows.long()], node


def _launch(classes: bool, xb, node, rows, cols, n_nodes, n_bins, C,
            bounds, row_range):
    """Find the node bounds (unless given), cut the nodes' ranges into work
    items, launch, and sum the cut nodes' partial rows."""
    dev = xb.device
    d = xb.shape[1]
    if bounds is None:
        # one device-to-host copy: the node bounds, the row ids' range (the
        # kernel reads code rows through them) and whether the samples are
        # in node order
        node = node.contiguous()
        slots = torch.arange(n_nodes + 1, dtype=torch.int32, device=dev)
        span = torch.stack([rows.min(), rows.max()]).long() \
            if rows is not None else torch.zeros(2, dtype=torch.int64,
                                                 device=dev)
        unsorted = (node[1:] < node[:-1]).any().to(torch.int64)[None]
        got = torch.cat([torch.searchsorted(node, slots), span,
                         unsorted]).cpu()
        if rows is not None:
            row_range = (int(got[-3]), int(got[-2]))
        if got[-1]:
            node, order = torch.sort(node, stable=True)
            cols = [c[order] for c in cols]
            rows = order if rows is None else rows[order]
            got = torch.searchsorted(node, slots).cpu()
        bounds = got[:n_nodes + 1].numpy()
    elif rows is not None and row_range is None:
        row_range = tuple(int(v) for v in torch.stack(
            [rows.min(), rows.max()]).cpu())
    if rows is not None:
        _check_range(int(row_range[0]), int(row_range[1]), xb.shape[0])
    cols = [c.contiguous() for c in cols]
    # the plan of `work_items`, made by the library's host copy of it
    # straight into pinned memory, goes up without blocking the host; the
    # caching host allocator keeps the buffer until the copy has run
    lib = _lib()
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    size = lib.histogram_plan(bounds.ctypes.data, n_nodes, None)
    n_items, n_red = size >> 32, size & 0xFFFFFFFF
    host = torch.empty((n_items + n_red, 3), dtype=torch.int64,
                       pin_memory=True)
    lib.histogram_plan(bounds.ctypes.data, n_nodes, host.data_ptr())
    plan = host.to(dev, non_blocking=True)
    n_partial = n_items - n_nodes + n_red
    fold, ds, smem = launch_plan(d, n_bins, C, 1 if classes else C, classes,
                                 xb.element_size(), n_items,
                                 *_device_limits(dev.index))
    out = (torch.empty if smem else torch.zeros)(
        (n_nodes + n_partial, d, n_bins, C), dtype=torch.float32, device=dev)
    items_p = plan.data_ptr()
    red_p = items_p + 24 * n_items
    xb = xb.contiguous()
    rows = None if rows is None else rows.contiguous()
    rows_p = None if rows is None else rows.data_ptr()
    rows64 = int(rows is not None and rows.dtype == torch.int64)
    here = torch.cuda.current_device() == dev.index
    with contextlib.nullcontext() if here else torch.cuda.device(dev.index):
        stream = torch.cuda.current_stream().cuda_stream
        if classes:
            err = lib.histogram_classes(
                xb.data_ptr(), xb.element_size(), rows_p, rows64,
                cols[0].data_ptr(), cols[1].data_ptr(), items_p,
                out.data_ptr(), n_items, d, n_bins, C, ds, int(smem),
                int(fold), stream)
        else:
            err = lib.histogram_moments(
                xb.data_ptr(), xb.element_size(), rows_p, rows64,
                cols[0].data_ptr(), items_p, out.data_ptr(), n_items, d,
                n_bins, C, ds, int(smem), int(fold), stream)
        _build.check(lib, err, "histogram launch")
        err = lib.histogram_reduce(out.data_ptr(), red_p, n_red,
                                   d * n_bins * C, stream)
    _build.check(lib, err, "histogram reduce launch")
    return out[:n_nodes] if n_partial else out


def histogram(xb: torch.Tensor, node: Optional[torch.Tensor],
              y: torch.Tensor, w: torch.Tensor, n_nodes: int, n_bins: int,
              n_classes: int, rows: Optional[torch.Tensor] = None,
              bounds: Optional[np.ndarray] = None,
              row_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(n_nodes, D, n_bins, n_classes) float32 weighted class histograms.

    ``xb`` (N, D) codes; ``y`` (m,) int32 and ``w`` (m,) float32 per
    sample; the node layout is ``node`` (m,) int32 or, for samples in node
    order, host ``bounds`` (module docstring); sample i's codes are
    ``xb[rows[i]]`` (``xb[i]`` when ``rows`` is None), and ``row_range``
    optionally gives the rows' host range.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``histogram.launches``) or raise.
    """
    dev, m, bounds = _check_common(xb, node, rows, (
        ("y", y, torch.int32), ("w", w, torch.float32)), bounds, n_nodes)
    d = xb.shape[1]
    if dev.type == "cpu":
        codes, node = _plain_inputs(xb, node, rows, bounds, n_nodes,
                                    row_range)
        return histogram_ref(codes, node, y, w, n_nodes, n_bins, n_classes)
    if m == 0 or n_nodes == 0 or d == 0:
        return torch.zeros((n_nodes, d, n_bins, n_classes),
                           dtype=torch.float32, device=dev)
    out = _launch(True, xb, node, rows, [y, w], n_nodes, n_bins, n_classes,
                  bounds, row_range)
    histogram.launches += 1
    return out


def moments(xb: torch.Tensor, node: Optional[torch.Tensor],
            wm: torch.Tensor, n_nodes: int, n_bins: int,
            rows: Optional[torch.Tensor] = None,
            bounds: Optional[np.ndarray] = None,
            row_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(n_nodes, D, n_bins, K) float32 payload-sum histograms of the (m, K)
    float32 payload columns ``wm`` (the trainer passes w, w·y, w·y²).

    Same inputs and device rules as :func:`histogram`; launches are counted
    in ``moments.launches``.
    """
    dev, m, bounds = _check_common(xb, node, rows, (
        ("wm", wm, torch.float32),), bounds, n_nodes)
    if wm.dim() != 2:
        raise ValueError(f"wm must be (m, K), got {tuple(wm.shape)}")
    d, k = xb.shape[1], wm.shape[1]
    if dev.type == "cpu":
        codes, node = _plain_inputs(xb, node, rows, bounds, n_nodes,
                                    row_range)
        return moments_ref(codes, node, wm, n_nodes, n_bins, k)
    if m == 0 or n_nodes == 0 or d == 0 or k == 0:
        return torch.zeros((n_nodes, d, n_bins, k), dtype=torch.float32,
                           device=dev)
    out = _launch(False, xb, node, rows, [wm], n_nodes, n_bins, k, bounds,
                  row_range)
    moments.launches += 1
    return out


histogram.launches = 0
moments.launches = 0
