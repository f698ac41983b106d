"""Per-request span trees with Chrome-trace export (the port's copy of the
reference's tracer; host Python only).

A :class:`Tracer` hands out root :class:`Span` objects (one per served
request); spans nest (``span.child``), carry point events
(``span.event``) and pre-measured intervals (``span.record`` — used for
engine calls timed with a different clock), and end back into the
tracer's bounded ring buffer.  The clock is injectable, so span
timestamps are deterministic under the same fake clocks the serving
stack already uses for deadline semantics.

Sampling + bounding: ``sample_every=n`` keeps every n-th root (1 = all);
unsampled roots get the shared :data:`NULL_SPAN`, whose whole API no-ops
— call sites never branch on "is tracing on".  The ring buffer keeps the
most recent ``capacity`` *finished* roots; memory is bounded regardless
of traffic.

``chrome_trace()`` renders the rings's span trees as Chrome
``chrome://tracing`` / Perfetto JSON: one ``pid``, one ``tid`` per root
request (so each request reads as its own row), ``"ph": "X"`` complete
events for spans and ``"ph": "i"`` instants for events, timestamps in
microseconds.

Program regions (:func:`region`) are the engine's own spans, for a
``torch.profiler`` trace rather than this module's ring: with regions on
(:func:`set_regions`, off by default, process-wide) each is a
``record_function`` range named ``repro:<name>``, on the same timeline and
clock as the device ops it launches; off, :func:`region` returns the shared
:data:`NULL_REGION` and makes no profiler call and no clock read.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_SPAN", "NULL_REGION", "region",
           "set_regions"]


class _NullSpan:
    """Shared no-op span for unsampled requests / disabled tracers."""

    __slots__ = ()
    sampled = False
    name = ""

    def child(self, name: str, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass

    def record(self, name: str, t0: float, t1: float, **attrs) -> "_NullSpan":
        return self

    def end(self, t: Optional[float] = None) -> None:
        pass


NULL_SPAN = _NullSpan()


class _NullRegion:
    """Shared no-op context for :func:`region` while regions are off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL_REGION = _NullRegion()
_REGIONS = False


def set_regions(on: bool) -> bool:
    """Turn the program's regions on or off for the whole process; returns
    the previous state."""
    global _REGIONS
    old, _REGIONS = _REGIONS, bool(on)
    return old


def region(name: str):
    """A ``torch.profiler.record_function`` range named ``repro:<name>``
    while regions are on, else :data:`NULL_REGION`."""
    if not _REGIONS:
        return NULL_REGION
    from torch.profiler import record_function
    return record_function("repro:" + name)


class Span:
    """One timed node of a request's trace tree."""

    __slots__ = ("name", "attrs", "t0", "t1", "events", "children",
                 "_tracer")
    sampled = True

    def __init__(self, name: str, t0: float, tracer: Optional["Tracer"],
                 **attrs):
        self.name = name
        self.attrs: Dict[str, Any] = attrs
        self.t0 = float(t0)
        self.t1: Optional[float] = None
        self.events: List[tuple] = []        # (ts, name, attrs)
        self.children: List[Span] = []
        self._tracer = tracer                # set on roots only

    def _clock(self) -> float:
        if self._tracer is not None:
            return self._tracer.clock()
        return time.time()

    def child(self, name: str, t: Optional[float] = None, **attrs) -> "Span":
        c = Span(name, self._root_clock(t), None, **attrs)
        c._tracer = self._tracer             # propagate the clock source
        self.children.append(c)
        return c

    def _root_clock(self, t: Optional[float]) -> float:
        if t is not None:
            return float(t)
        tr = self._tracer
        return tr.clock() if tr is not None else time.time()

    def event(self, name: str, t: Optional[float] = None, **attrs) -> None:
        if t is None:
            tr = self._tracer
            t = tr.clock() if tr is not None else time.time()
        self.events.append((t, name, attrs))

    def record(self, name: str, t0: float, t1: float, **attrs) -> "Span":
        """Attach a pre-measured interval (e.g. a perf_counter-timed
        engine call) as a closed child span."""
        c = Span(name, t0, None, **attrs)
        c._tracer = self._tracer
        c.t1 = float(t1)
        self.children.append(c)
        return c

    def end(self, t: Optional[float] = None) -> None:
        if self.t1 is None:
            self.t1 = self._root_clock(t)
            tr = self._tracer
            if tr is not None and tr._is_root(self):
                tr._finish(self)

    # ---------------- export ----------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "t0": self.t0, "t1": self.t1,
            "attrs": dict(self.attrs),
            "events": [{"t": t, "name": n, "attrs": a}
                       for t, n, a in self.events],
            "children": [c.to_dict() for c in self.children],
        }


class Tracer:
    """Bounded, sampled collector of per-request span trees."""

    def __init__(self, clock=time.time, capacity: int = 256,
                 sample_every: int = 1, enabled: bool = True):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.clock = clock
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.enabled = bool(enabled)
        self._ring: "deque[Span]" = deque(maxlen=self.capacity)
        self._roots: set = set()
        self._seq = itertools.count()
        self.started = 0                 # sampled roots handed out
        self.dropped = 0                 # roots skipped by sampling
        self._lock = threading.Lock()

    # ---------------- span lifecycle ----------------
    def root(self, name: str, **attrs):
        """A new root span, or :data:`NULL_SPAN` when sampled out.

        Lock-free: ``next`` on :func:`itertools.count` and ``set.add`` are
        atomic under the GIL, and ``started``/``dropped`` are
        monitoring-only tallies where a lost update is harmless.
        """
        if not self.enabled:
            return NULL_SPAN
        n = next(self._seq)
        if n % self.sample_every != 0:
            self.dropped += 1
            return NULL_SPAN
        self.started += 1
        sp = Span(name, self.clock(), self, **attrs)
        self._roots.add(id(sp))
        return sp

    def _is_root(self, span: Span) -> bool:
        return id(span) in self._roots

    def _finish(self, span: Span) -> None:
        # set.discard and deque.append are individually atomic; a reader
        # racing between them sees the span in neither place, never twice
        self._roots.discard(id(span))
        self._ring.append(span)

    def spans(self) -> List[Span]:
        """Finished roots currently in the ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # ---------------- chrome trace export ----------------
    def chrome_trace(self) -> Dict[str, Any]:
        """``chrome://tracing`` JSON object for the ring's span trees."""
        events: List[Dict[str, Any]] = []
        for tid, root in enumerate(self.spans(), start=1):
            label = root.name
            for k in ("kind", "uid"):
                if k in root.attrs:
                    label += f" {k}={root.attrs[k]}"
            events.append({"ph": "M", "pid": 1, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": label}})
            self._emit(root, tid, events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def _emit(self, span: Span, tid: int, events: List[Dict[str, Any]]
              ) -> None:
        t1 = span.t1 if span.t1 is not None else span.t0
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": span.name,
            "ts": span.t0 * 1e6, "dur": max(t1 - span.t0, 0.0) * 1e6,
            "args": _jsonable(span.attrs),
        })
        for ts, name, attrs in span.events:
            events.append({"ph": "i", "pid": 1, "tid": tid, "name": name,
                           "ts": ts * 1e6, "s": "t",
                           "args": _jsonable(attrs)})
        for c in span.children:
            self._emit(c, tid, events)

    def export(self, path) -> Dict[str, Any]:
        """Write the Chrome trace JSON to ``path``; returns the object."""
        obj = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return obj


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = repr(v)
    return out
