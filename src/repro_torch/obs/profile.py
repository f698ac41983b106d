"""Engine profiling hooks: ``instrument(engine)``.

:class:`InstrumentedEngine` is a transparent proxy over any
``ProximityEngine`` (full, prototype-compressed, or depth-prefix view):
every engine op — routing (``query_state``), the factored products
(``matvec``/``matmat``/``row_sums``), serving ops (``predict``/``topk``/
``kernel_block``/``squared_row_sums``) — is timed into the
``engine_op_seconds{op,backend,tier}`` histogram family, and the
engine's qs-cache hit/miss counters are mirrored into gauges after each
routed call.  Everything else (attributes, caches, ``W``/``Q`` factors,
``prototype_indices_`` …) delegates untouched, so the proxy drops into
any call site that held the raw engine.

A CUDA op returns before the card has finished it, so on a CUDA engine the
timer synchronizes the engine device's current stream before its second
clock read: ``engine_op_seconds`` then holds the time the op took on the
card, not the time its launches took.  ``backend`` is the engine's device
type (``"cuda"`` or ``"cpu"``).

Cost per op: one ``perf_counter`` pair + one histogram observe (~1µs), and
on the card the stream sync (the caller reads the result next anyway).
"""
from __future__ import annotations

import time

import torch

__all__ = ["InstrumentedEngine", "instrument", "ENGINE_OPS"]

ENGINE_OPS = ("query_state", "matvec", "matmat", "row_sums", "predict",
              "topk", "kernel_block", "squared_row_sums", "full_kernel")


class InstrumentedEngine:
    """Timing proxy over a ``ProximityEngine``; see module docstring."""

    def __init__(self, engine, registry, tier: str = "",
                 clock=time.perf_counter):
        self._engine = engine
        self._registry = registry
        self._tier = str(tier)
        self._clock = clock
        device = torch.device(engine.device)
        backend = device.type
        # a CUDA engine's ops are waited for before the second clock read
        self._cuda = device if device.type == "cuda" else None
        hist = registry.histogram(
            "engine_op_seconds", "engine op latency (s)",
            labels=("op", "backend", "tier"))
        self._timers = {op: hist.labels(op=op, backend=backend,
                                        tier=self._tier)
                        for op in ENGINE_OPS}
        self._calls = registry.counter(
            "engine_op_calls_total", "engine op invocations",
            labels=("op", "backend", "tier"))
        self._call_counters = {op: self._calls.labels(
            op=op, backend=backend, tier=self._tier) for op in ENGINE_OPS}
        g = registry.gauge("engine_qs_cache", "routed query-state cache",
                           labels=("tier", "event"))
        self._g_hits = g.labels(tier=self._tier, event="hit")
        self._g_misses = g.labels(tier=self._tier, event="miss")
        # pre-bind every wrapped op so the hot path never re-enters
        # __getattr__ or rebuilds a closure per call
        for op in ENGINE_OPS:
            fn = getattr(engine, op, None)
            if callable(fn):
                setattr(self, op, self._wrap(op, fn))

    def _wrap(self, op: str, fn):
        timer = self._timers[op]
        calls = self._call_counters[op]
        clock = self._clock
        cuda = self._cuda
        sync_qs = self._sync_qs_gauges if op == "query_state" else None

        def timed(*a, **kw):
            t0 = clock()
            out = fn(*a, **kw)
            if cuda is not None:
                # the calling thread's current stream, where the op queued
                torch.cuda.current_stream(cuda).synchronize()
            timer.observe(clock() - t0)
            calls.inc()
            if sync_qs is not None:
                sync_qs()
            return out

        timed.__name__ = op
        return timed

    # ---------------- delegation ----------------
    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _sync_qs_gauges(self) -> None:
        eng = self._engine
        self._g_hits.set(getattr(eng, "qs_cache_hits", 0))
        self._g_misses.set(getattr(eng, "qs_cache_misses", 0))

    @property
    def wrapped(self):
        """The underlying engine (unwrap for identity checks)."""
        return self._engine


def instrument(engine, registry, tier: str = "",
               clock=time.perf_counter) -> InstrumentedEngine:
    """Wrap ``engine`` so every op is timed into ``registry``.

    Idempotent: instrumenting an already-instrumented engine returns it
    unchanged (same registry or not — double-timing is never useful).
    """
    if isinstance(engine, InstrumentedEngine):
        return engine
    return InstrumentedEngine(engine, registry, tier=tier, clock=clock)
