"""Peaks of one H100 SXM and the work that a cell's device calls need.

Peaks (NVIDIA's H100 SXM data sheet, at the full 700 W; the run records
the card's ``power.limit`` beside them): HBM3 3.35 TB/s; FP64 on the tensor
cores 67 TFLOP/s, i.e. 33.5e12 FMA/s.  The tensor cores' rate is the
higher of the two FP64 peaks, so no implementation can read above 100%.

Counts are of what these inputs need for the result, whatever kernel
computes it:

An all-pairs pass (``allpairs_work``): the query factors ``gl`` and ``q``
  read once; the members (column and weight) of each reference leaf that a
  nonzero query factor reaches, read once; one FMA per collision of a
  nonzero query factor with a nonzero reference member; the results
  written once (``n × k`` indices and values, ``n × C`` class sums).  The
  dense ``Nq × N`` block is not counted, so the count holds for a kernel
  that never writes it, and it is the same for K2's leaf and dense forms.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
FP64_FMA_S = 67e12 / 2


def least_s(nbytes: float, fmas: float) -> float:
    """The least time for the work: the larger of its two bounds."""
    return max(nbytes / HBM_BYTES_S, fmas / FP64_FMA_S)


def allpairs_work(torch, gl_q, q, gl_w, w, n_leaves: int, k: int,
                  n_classes: int):
    """(bytes, FMAs) of one pass (top-k and class sums) of the query rows
    ``gl_q``/``q`` against the reference ``gl_w``/``w``, all (n, T)."""
    keep = w.reshape(-1) != 0
    members = torch.bincount(gl_w.reshape(-1)[keep].long(),
                             minlength=n_leaves)
    hit = gl_q.reshape(-1)[q.reshape(-1) != 0].long()
    fmas = float(members[hit].sum())
    reached = torch.zeros(n_leaves, dtype=torch.bool, device=hit.device)
    reached[hit] = True
    member_bytes = float(members[reached].sum()) * (4 + w.element_size())
    n = gl_q.shape[0]
    nbytes = (gl_q.numel() * (gl_q.element_size() + q.element_size())
              + member_bytes + n * k * 16 + n * n_classes * 8)
    return nbytes, fmas
