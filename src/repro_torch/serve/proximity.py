"""Continuous-batching out-of-sample proximity serving, over the port's
engines on the card (or, on request, the CPU).

``ProximityServer`` fronts a fitted
:class:`~repro_torch.core.engine.ProximityEngine` (full,
prototype-compressed, or depth-prefix) with a slot design: a fixed pool of
``n_slots`` query slots, requests admitted into free slots as they arrive,
and **one routed batch per tick** shared by every operation kind.

Request kinds and the engine op each maps to:

=============  ====================================================
``predict``    proximity-weighted class scores  P_oos · Y
``topk``       per-query nearest training columns (block top-k)
``outlier``    OOS outlier scores vs cached per-class train stats
``propagate``  warm-started online label propagation (partial_fit)
``embed``      Nyström out-of-sample embedding transform
=============  ====================================================

Per tick the server routes the slot batch **once** (``engine.query_state``
content-caches the routed state, so the per-kind engine calls below reuse
it: one routing-kernel launch a tick) and then issues one engine call per
kind present; ``topk`` and ``outlier`` run the proximity-block kernel on
the tick's rows.  All five ops are
row-wise in the query, so each request's result is independent of which
other requests share its tick — serving results are deterministic under
request reordering (tested).  Products against fixed reference-side
matrices (labels, propagation field, Nyström basis) additionally hit the
engine's cached device bucket tables, so a steady-state tick costs
O(n_slots · T · C), independent of the training-set size.

Admission control
-----------------
Requests carry a **priority** (higher served first, FIFO within a priority
level, no overtaking once queued ahead) and an optional **deadline**.  A
request whose deadline passes while still queued is *shed* — removed
deterministically at the next admission sweep, never silently stalled —
and lands in ``shed_requests``.  The clock is injectable so deadline
semantics are testable without real sleeps.

Tiered serving
--------------
``TieredProximityServer`` stacks several engines into a latency ladder
(e.g. depth-prefix → prototype-compressed → full) with one inner
``ProximityServer`` per tier.  Admission routes each request to the
cheapest tier that supports its kind; low-confidence ``predict`` answers
(vote margin below ``escalate_margin``) escalate to the next tier while
their deadline allows.  A request that runs out of deadline mid-ladder is
answered from the best tier already available.  In async mode an admission
thread and one worker thread per tier run the loops, so a slow full-engine
tick never blocks the compressed tier; the same logic runs synchronously
(``run_until_drained``) for deterministic tests.

Reliability
-----------
Engine calls run under a **supervisor**: an optional seeded
:class:`~repro_torch.serve.reliability.FaultInjector` is consulted around every
call (synthetic exceptions / latency / corrupted buffers), results are
validated finite, failures are retried under a bounded
:class:`~repro_torch.serve.reliability.RetryPolicy` with backoff, and
repeated faults trip a per-server
:class:`~repro_torch.serve.reliability.CircuitBreaker`.
A request whose call fails terminally is never silently dropped — it lands
in ``failed_requests`` with a recorded reason, and the tiered server
re-routes it **down-ladder** to the next capable tier.  Tiers also carry
deadline *budgets* (a request whose remaining deadline cannot afford the
cheap tier plus a possible escalation hop routes straight to a deeper
tier) and overload *spill* watermarks (a tier whose queue exceeds the
watermark passes new work down-ladder instead of queuing it toward a
shed).  All of it is visible in ``stats()``.

Host and device
---------------
The slot buffer is host-owned and mutated on admission; engine calls get a
defensive copy of the tick's rows (the buffer-aliasing race: on a CPU
engine ``torch.as_tensor`` of a numpy array is zero-copy, so a batch that
viewed the slot buffer would change under an in-flight call).  Each kind's
result buffers are copied to the host **once per tick**, right after its
engine call and before fault injection and finite validation: request
results are numpy arrays, as the reference server's are, none is a view of
the slot buffer or of an engine cache, and no request reads the device on
its own.  The escalation margin is computed on those host scores.

In async mode every worker thread launches on its device's default stream:
the tiers share device state built lazily (the full engine's routed OOS
states, which the prefix and compressed tiers reuse, the block kernel's
leaf index, bucket and label tables), and a tensor made on one stream and
read or freed on another needs events this server does not record.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import prediction_margin as _device_margin
from ..obs.metrics import EWMA, MetricsRegistry
from ..obs.profile import instrument
from ..obs.trace import NULL_SPAN, Tracer
from .reliability import (CircuitBreaker, FaultInjector, RetryPolicy,
                          validate_finite)

__all__ = ["ProxRequest", "ProximityServer", "TieredProximityServer",
           "Tier", "TieredRequest", "KINDS"]

KINDS = ("predict", "topk", "outlier", "propagate", "embed")

# shared no-op tracer: servers built without a tracer hand every request
# the NULL_SPAN, so call sites never branch on "is tracing on"
_NULL_TRACER = Tracer(enabled=False)


def _host(*tensors) -> Tuple[np.ndarray, ...]:
    """Host numpy copies of result tensors: the one device-to-host read of a
    kind a tick (on a CPU engine a copy too, so no result shares memory
    with an engine cache)."""
    return tuple(t.detach().to("cpu", copy=True).numpy() for t in tensors)


def prediction_margin(scores: np.ndarray) -> np.ndarray:
    """The engine's ``prediction_margin`` of host class scores, as a host
    array (the escalation test reads it with ``float``)."""
    return _device_margin(torch.as_tensor(scores)).numpy()


@dataclasses.dataclass
class ProxRequest:
    """One serving request: a batch of query rows and an operation kind."""

    uid: int
    kind: str                         # one of KINDS
    X: np.ndarray                     # (nq, d) query rows
    k: int = 10                       # top-k width (kind='topk' only)
    priority: int = 0                 # higher = served first
    deadline_at: Optional[float] = None   # absolute clock() deadline

    # runtime (owned by the server)
    slots: Optional[np.ndarray] = None     # assigned slot ids
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    done_at: Optional[float] = None
    shed: bool = False
    failed: bool = False                   # engine fault after all retries
    fail_reason: Optional[str] = None
    attempts: int = 0                      # extra engine-call attempts spent
    result: Any = None
    span: Any = NULL_SPAN                  # trace span (tier attempt / root)

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_at is None else \
            self.done_at - self.submitted_at

    @property
    def wait_s(self) -> Optional[float]:
        return None if self.admitted_at is None else \
            self.admitted_at - self.submitted_at

    @property
    def service_s(self) -> Optional[float]:
        """In-slot time (admission → completion), excluding queue wait."""
        return None if self.done_at is None or self.admitted_at is None \
            else self.done_at - self.admitted_at


class _MetricsHTTPMixin:
    """``/metrics`` scrape endpoint lifecycle shared by both servers.

    ``start_metrics_http`` is idempotent and binds an ephemeral port by
    default (returns the :class:`~repro_torch.obs.http.MetricsHTTPServer`,
    whose ``.port``/``.url`` identify the scrape target);
    ``stop_metrics_http``
    is safe to call without a running endpoint.
    """

    _metrics_http = None

    def start_metrics_http(self, host: str = "127.0.0.1", port: int = 0):
        if self._metrics_http is None:
            from ..obs.http import MetricsHTTPServer
            self._metrics_http = MetricsHTTPServer(self.registry, host=host,
                                                   port=port).start()
        return self._metrics_http

    def stop_metrics_http(self) -> None:
        if self._metrics_http is not None:
            self._metrics_http.stop()
            self._metrics_http = None


class ProximityServer(_MetricsHTTPMixin):
    """Slot-batched serving loop over a ``ProximityEngine``.

    Parameters
    ----------
    engine : ProximityEngine (or a compressed/prefix view), on the card or
        the CPU
    y : labels of the engine's **reference columns** — the training labels
        for a full engine, ``prototype_labels_`` for a compressed one.
        Needed by ``predict`` and ``outlier`` requests.
    n_slots : query rows per tick; requests wider than this are rejected.
    propagator : OnlineLabelPropagation, enables ``propagate`` requests.
    embedding : fitted ProximityEmbedding, enables ``embed`` requests.
    n_classes : class count (default ``y.max() + 1``).
    clock : injectable time source for deadline semantics (default
        ``time.time``); deterministic tests pass a fake.
    fault_injector : optional ``FaultInjector`` consulted around every
        engine call (chaos testing / benchmarking).
    retry : ``RetryPolicy`` for failed engine calls (default: 2 retries
        with 10 ms exponential backoff).  Pass ``RetryPolicy(max_retries=0)``
        to fail fast.
    breaker : optional ``CircuitBreaker``; while open, engine calls are
        skipped and active requests fail fast with reason
        ``"breaker_open"`` (the tiered server re-routes them down-ladder).
    name : label used in fault-injection scoping and failure reasons.
    registry : ``MetricsRegistry`` every counter/latency observation goes
        through (one is created if not given; the tiered server shares one
        across its tiers).  Pass ``MetricsRegistry(enabled=False)`` for an
        uninstrumented server — engine calls then skip the timing proxy
        entirely and ``stats()`` latency views are empty.
    tracer : optional ``obs.trace.Tracer``; when set, every request gets a
        span (admission / engine calls / retries / terminal state).  The
        tiered server passes per-tier child spans through ``submit``.
    """

    def __init__(self, engine, y: Optional[np.ndarray] = None,
                 n_slots: int = 64, n_classes: Optional[int] = None,
                 propagator=None, embedding=None, clock=time.time,
                 fault_injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 name: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else _NULL_TRACER
        tier = name if name else "server"
        self._tier_label = tier
        # every engine op is timed through the instrumentation proxy; an
        # explicitly disabled registry keeps the raw engine (zero overhead)
        self.engine = instrument(engine, self.registry, tier=tier) \
            if self.registry.enabled else engine
        self.y = None if y is None else np.asarray(y, dtype=np.int64)
        if n_classes is None and self.y is not None and len(self.y):
            n_classes = int(self.y.max()) + 1
        self.n_classes = n_classes
        self.n_slots = int(n_slots)
        self.propagator = propagator
        self.embedding = embedding
        self._clock = clock
        self.name = name
        self.fault_injector = fault_injector
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker
        if self.registry.enabled:
            if self.breaker is not None:
                self.breaker.bind_registry(self.registry, tier=tier)
            if self.fault_injector is not None:
                self.fault_injector.bind_registry(self.registry)

        self._slot_X: Optional[np.ndarray] = None    # (n_slots, d), lazy
        self._slot_free: List[int] = list(range(self.n_slots))
        self.active: Dict[int, ProxRequest] = {}     # uid -> request
        self.queue: "deque[ProxRequest]" = deque()
        self.finished: List[ProxRequest] = []
        self.shed_requests: List[ProxRequest] = []
        self.failed_requests: List[ProxRequest] = []
        self._uids = itertools.count()
        self.ticks = 0
        self.rows_served = 0
        self._occupancy: List[int] = []

        # ---- metric families (one shared registry per server/ladder) ----
        reg = self.registry
        self._m_requests = reg.counter(
            "serve_requests_total", "requests by terminal status",
            labels=("tier", "kind", "status"))
        h_lat = reg.histogram("serve_request_seconds",
                              "submit -> done latency (s)",
                              labels=("tier", "kind"))
        h_wait = reg.histogram("serve_wait_seconds",
                               "queue wait (submit -> admit, s)",
                               labels=("tier", "kind"))
        h_svc = reg.histogram("serve_service_seconds",
                              "in-slot service time (admit -> done, s)",
                              labels=("tier", "kind"))
        self._h_lat = {k: h_lat.labels(tier=tier, kind=k) for k in KINDS}
        self._h_wait = {k: h_wait.labels(tier=tier, kind=k) for k in KINDS}
        self._h_svc = {k: h_svc.labels(tier=tier, kind=k) for k in KINDS}
        self._c_done = {k: self._m_requests.labels(tier=tier, kind=k,
                                                   status="done")
                        for k in KINDS}
        self._g_queue = reg.gauge("serve_queue_depth", "queued requests",
                                  labels=("tier",)).labels(tier=tier)
        self._g_occ = reg.gauge("serve_slot_occupancy", "occupied slots",
                                labels=("tier",)).labels(tier=tier)
        self._c_ticks = reg.counter("serve_ticks_total", "engine ticks",
                                    labels=("tier",)).labels(tier=tier)
        self._c_rows = reg.counter("serve_rows_total", "query rows served",
                                   labels=("tier",)).labels(tier=tier)
        # reliability accounting: every engine-call exception is a fault,
        # and each fault is either retried or terminal, so
        # faults == retries + failed_calls always holds (tested).  These
        # are registry counters; the legacy int attributes below are
        # read-only views over them (``stats()`` backward compat).
        rel = reg.counter("serve_engine_faults_total",
                          "supervised engine-call outcomes",
                          labels=("tier", "event"))
        self._c_faults = rel.labels(tier=tier, event="fault")
        self._c_retries = rel.labels(tier=tier, event="retry")
        self._c_failed_calls = rel.labels(tier=tier, event="failed_call")
        self._c_recovered = rel.labels(tier=tier, event="recovered_call")

    # legacy counter views (kept as attributes-in-spirit: same names and
    # int semantics as the pre-registry fields, now reading the registry)
    @property
    def faults(self) -> int:
        return int(self._c_faults.value)

    @property
    def retries(self) -> int:
        return int(self._c_retries.value)

    @property
    def failed_calls(self) -> int:
        return int(self._c_failed_calls.value)

    @property
    def recovered_calls(self) -> int:
        return int(self._c_recovered.value)

    # ---------------- public API ----------------
    def submit(self, kind: str, X: np.ndarray, k: int = 10,
               priority: int = 0, deadline_s: Optional[float] = None,
               deadline_at: Optional[float] = None, span=None) -> int:
        """Queue a request; returns its uid (see ``.finished`` / ``serve``).

        ``priority``: higher values are served first; FIFO within a level.
        ``deadline_s``: relative deadline from now; ``deadline_at`` passes an
        absolute clock value instead (the tiered server uses it so a
        request's deadline survives escalation unchanged).
        ``span``: trace span this request reports into (the tiered server
        passes a per-tier child span); without one, a root span is opened
        on this server's tracer.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        if kind in ("predict", "outlier") and self.y is None:
            raise ValueError(f"{kind!r} requests need reference labels y")
        if kind == "propagate" and self.propagator is None:
            raise ValueError("propagate requests need propagator=")
        if kind == "embed" and self.embedding is None:
            raise ValueError("embed requests need embedding=")
        X = np.ascontiguousarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be (n_rows, d), got {X.shape}")
        if X.shape[0] > self.n_slots:
            raise ValueError(f"request rows {X.shape[0]} exceed "
                             f"n_slots={self.n_slots}; split the batch")
        now = self._clock()
        if deadline_at is None and deadline_s is not None:
            deadline_at = now + float(deadline_s)
        req = ProxRequest(uid=next(self._uids), kind=kind, X=X, k=int(k),
                          priority=int(priority), deadline_at=deadline_at)
        req.submitted_at = now
        if span is None:
            span = self.tracer.root("request", kind=kind, uid=req.uid,
                                    rows=X.shape[0], tier=self._tier_label)
        req.span = span
        span.event("submit", t=now, queue_depth=len(self.queue),
                   priority=req.priority)
        # insert after every request of >= priority: higher priorities jump
        # the line, equal priorities stay FIFO (stable, no overtaking)
        idx = len(self.queue)
        while idx > 0 and self.queue[idx - 1].priority < req.priority:
            idx -= 1
        if idx == len(self.queue):
            self.queue.append(req)
        else:
            self.queue.insert(idx, req)
        return req.uid

    def step(self) -> int:
        """One engine tick: admit, run one engine call per kind present,
        retire.  Returns the number of requests retired."""
        self._admit()
        if not self.active:
            return 0
        if self.breaker is not None and not self.breaker.allow():
            # open breaker: fail fast with a recorded reason rather than
            # burning retries against an engine that keeps crashing (the
            # tiered server re-routes these down-ladder)
            failed = 0
            for req in list(self.active.values()):
                self._fail_request(req, "breaker_open")
                failed += 1
            return failed
        self.ticks += 1
        self._c_ticks.inc()
        occ = self.n_slots - len(self._slot_free)
        self._occupancy.append(occ)
        self._g_occ.set(occ)

        # one routed batch per tick, in slot order; a defensive copy so no
        # engine ever aliases the mutable slot buffer (the async aliasing
        # race pattern)
        rows = np.sort(np.concatenate(
            [r.slots for r in self.active.values()]))
        X_tick = self._slot_X[rows].copy()
        pos = {slot: i for i, slot in enumerate(rows)}   # slot -> batch row
        self.engine.query_state(X_tick)                  # route once

        by_kind: Dict[str, List[ProxRequest]] = {}
        for req in self.active.values():
            by_kind.setdefault(req.kind, []).append(req)
        for kind, reqs in by_kind.items():
            self._supervised_kind(kind, reqs, X_tick, pos)

        retired = 0
        now = self._clock()
        for req in list(self.active.values()):
            req.done_at = now
            self.finished.append(req)
            self._slot_free.extend(int(s) for s in req.slots)
            self.rows_served += req.n_rows
            self._c_rows.inc(req.n_rows)
            del self.active[req.uid]
            retired += 1
            self._c_done[req.kind].inc()
            self._h_lat[req.kind].observe(req.latency_s)
            self._h_wait[req.kind].observe(req.wait_s)
            self._h_svc[req.kind].observe(req.service_s)
            req.span.end(now)
        return retired

    def run_until_drained(self, max_ticks: int = 10_000) -> List[ProxRequest]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished

    def serve(self, requests, max_ticks: int = 10_000) -> List[Any]:
        """Submit ``(kind, X[, k])`` tuples, drain, return results in order
        (``None`` for requests shed past their deadline)."""
        uids = [self.submit(*r) for r in requests]
        self.run_until_drained(max_ticks=max_ticks)
        by_uid = {r.uid: r.result for r in self.finished}
        return [by_uid.get(u) for u in uids]

    # ---------------- internals ----------------
    def _admit(self) -> None:
        """Shed expired requests, then admit by priority into free slots
        (no overtaking: a wide request at the head blocks narrower ones
        behind it, keeping service order within each priority level)."""
        now = self._clock()
        if any(r.deadline_at is not None for r in self.queue):
            kept: "deque[ProxRequest]" = deque()
            for r in self.queue:
                if r.deadline_at is not None and now > r.deadline_at:
                    r.shed = True
                    r.done_at = now
                    self.shed_requests.append(r)
                    self._m_requests.labels(tier=self._tier_label,
                                            kind=r.kind, status="shed").inc()
                    r.span.event("shed", t=now)
                    r.span.end(now)
                else:
                    kept.append(r)
            self.queue = kept
        while self.queue and len(self._slot_free) >= self.queue[0].n_rows:
            req = self.queue.popleft()
            if self._slot_X is None:
                self._slot_X = np.zeros((self.n_slots, req.X.shape[1]))
            slots = np.asarray([self._slot_free.pop()
                                for _ in range(req.n_rows)], dtype=np.int64)
            req.slots = slots
            req.admitted_at = now
            self._slot_X[slots] = req.X
            self.active[req.uid] = req
            req.span.event("admit", t=now, slots=req.n_rows)
        self._g_queue.set(len(self.queue))

    def _supervised_kind(self, kind: str, reqs: List[ProxRequest],
                         X_tick: np.ndarray, pos: Dict[int, int]) -> None:
        """Run one kind's engine call under the supervisor: fault
        injection, finite validation, bounded retry-with-backoff, breaker
        accounting.  On terminal failure the kind's requests land in
        ``failed_requests`` with a reason — never silently dropped."""
        arrays = None
        err: Optional[BaseException] = None
        t0c = self._clock()
        for attempt in range(self.retry.max_retries + 1):
            try:
                arrays = self._compute_kind(kind, reqs, X_tick)
                break
            except Exception as exc:          # noqa: BLE001 — supervisor
                self._c_faults.inc()
                err = exc
                if self.breaker is not None:
                    self.breaker.record_failure()
                if attempt < self.retry.max_retries and (
                        self.breaker is None or self.breaker.allow()):
                    self._c_retries.inc()
                    for r in reqs:
                        r.attempts += 1
                        r.span.event("retry", attempt=attempt + 1,
                                     error=type(exc).__name__)
                    self.retry.backoff(attempt + 1)
                else:
                    self._c_failed_calls.inc()
                    break
        t1c = self._clock()
        for r in reqs:
            r.span.record(f"engine:{kind}", t0c, t1c,
                          tier=self._tier_label, rows=r.n_rows,
                          batch_rows=X_tick.shape[0],
                          ok=arrays is not None)
        if arrays is None:
            reason = f"{type(err).__name__}: {err}"
            for req in reqs:
                self._fail_request(req, reason)
            return
        if self.breaker is not None:
            self.breaker.record_success()
        if err is not None:
            self._c_recovered.inc()
        self._assign_results(kind, reqs, arrays, pos)

    def _compute_kind(self, kind: str, reqs: List[ProxRequest],
                      X_tick: np.ndarray) -> Tuple[np.ndarray, ...]:
        """The engine call for one kind — everything that can fault."""
        inj = self.fault_injector
        if inj is not None:
            inj.before_call(kind, self.name)
        eng = self.engine
        # each branch copies its result buffers to the host once (_host)
        if kind == "predict":
            arrays = _host(eng.predict(self.y, n_classes=self.n_classes,
                                       X=X_tick))
        elif kind == "topk":
            kk = max(r.k for r in reqs)
            idx, val = _host(*eng.topk(k=kk, X=X_tick))
            cols = getattr(eng, "prototype_indices_", None)
            if cols is not None:
                # map prototype columns -> training rows; zero-proximity
                # slots are engine padding (fewer than k colliding columns),
                # not neighbors — mark them -1 instead of fabricating the
                # training row behind column 0
                idx = np.where(val > 0, cols[idx], -1)
            arrays = (idx, val)
        elif kind == "outlier":
            from ..applications.outliers import oos_outlier_scores
            arrays = _host(oos_outlier_scores(eng, self.y, X_tick))
        elif kind == "propagate":
            _, scores = self.propagator.partial_fit(X_tick)
            arrays = _host(scores)
        else:                        # embed
            arrays = _host(self.embedding.transform(X_tick))
        if inj is not None:
            arrays = inj.corrupt(kind, arrays, self.name)
        validate_finite(kind, arrays)
        return arrays

    def _assign_results(self, kind: str, reqs: List[ProxRequest],
                        arrays: Tuple[np.ndarray, ...],
                        pos: Dict[int, int]) -> None:
        """Slice the kind-level result buffers into per-request results
        (pure — runs exactly once, after the supervised call succeeds)."""
        for req in reqs:
            take = np.asarray([pos[int(s)] for s in req.slots])
            if kind == "predict":
                s = arrays[0][take]
                req.result = {"scores": s, "labels": s.argmax(axis=1)}
            elif kind == "topk":
                idx, val = arrays
                req.result = {"indices": idx[take, :req.k],
                              "values": val[take, :req.k]}
            elif kind == "propagate":
                s = arrays[0][take]
                req.result = {"scores": s, "labels": s.argmax(axis=1)}
            elif kind == "outlier":
                req.result = {"scores": arrays[0][take]}
            else:
                req.result = {"embedding": arrays[0][take]}

    def _fail_request(self, req: ProxRequest, reason: str) -> None:
        """Terminal failure: free the slots, record the reason, surface the
        request in ``failed_requests`` (the tiered server re-routes it)."""
        req.failed = True
        req.fail_reason = reason
        now = self._clock()
        req.done_at = now
        if req.slots is not None:
            self._slot_free.extend(int(s) for s in req.slots)
        self.failed_requests.append(req)
        del self.active[req.uid]
        self._m_requests.labels(tier=self._tier_label, kind=req.kind,
                                status="failed").inc()
        req.span.event("failed", t=now, reason=reason)
        req.span.end(now)

    # ---------------- accounting ----------------
    def stats(self) -> Dict[str, Any]:
        """Latency/throughput stats per kind plus tick-level occupancy."""
        out: Dict[str, Any] = {
            "ticks": self.ticks,
            "requests": len(self.finished),
            "rows": self.rows_served,
            "mean_occupancy": float(np.mean(self._occupancy))
            if self._occupancy else 0.0,
            "queue_depth": len(self.queue),
            "shed": len(self.shed_requests),
        }
        out["reliability"] = {
            "faults": self.faults,
            "retries": self.retries,
            "recovered_calls": self.recovered_calls,
            "failed_calls": self.failed_calls,
            "failed_requests": len(self.failed_requests),
        }
        if self.breaker is not None:
            out["reliability"]["breaker"] = self.breaker.snapshot()
        if self.fault_injector is not None:
            out["reliability"]["injected"] = self.fault_injector.stats()
        hits = int(getattr(self.engine, "qs_cache_hits", 0))
        misses = int(getattr(self.engine, "qs_cache_misses", 0))
        out["qs_cache"] = {
            "hits": hits, "misses": misses,
            "hit_rate": hits / max(hits + misses, 1),
        }
        # per-kind latency views are read from the registry histograms —
        # the same numbers the exposition exports (exact percentiles below
        # the reservoir cap, bit-equal to the per-request lists they
        # replaced).  A disabled registry yields empty views.
        per: Dict[str, Dict[str, float]] = {}
        for kind in KINDS:
            h = self._h_lat[kind]
            if not h.count:
                continue
            per[kind] = {
                "requests": int(h.count),
                "p50_ms": float(h.percentile(50) * 1e3),
                "p95_ms": float(h.percentile(95) * 1e3),
                "p50_service_ms":
                    float(self._h_svc[kind].percentile(50) * 1e3),
                "mean_wait_ms": float(self._h_wait[kind].mean * 1e3),
            }
        out["kinds"] = per
        return out


# ===========================================================================
# tiered serving
# ===========================================================================

@dataclasses.dataclass
class Tier:
    """One rung of the engine ladder.

    ``kinds`` declares what this tier can answer; kinds absent here route
    past it at admission (e.g. a compressed tier cannot serve ``propagate``
    / ``embed``, which are fitted against the full reference set).

    ``budget_s`` is the tier's deadline budget — the service time a request
    should expect here.  When unset it is learned online (EWMA of observed
    tier latency).  A request whose remaining deadline cannot afford this
    tier's budget *plus* a possible escalation hop routes straight to a
    deeper tier at admission.  ``spill_watermark`` bounds the tier's queue:
    beyond it, new work spills to the next capable tier instead of queuing
    toward a deadline shed.
    """

    name: str
    engine: object
    y: Optional[np.ndarray] = None
    kinds: Tuple[str, ...] = KINDS
    n_slots: int = 64
    n_classes: Optional[int] = None
    propagator: object = None
    embedding: object = None
    budget_s: Optional[float] = None
    spill_watermark: Optional[int] = None


@dataclasses.dataclass
class TieredRequest:
    """A request's journey through the ladder."""

    uid: int
    kind: str
    X: np.ndarray
    k: int
    priority: int
    deadline_at: Optional[float]
    submitted_at: float

    answers: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tier_path: List[str] = dataclasses.field(default_factory=list)
    result: Any = None
    final_tier: Optional[str] = None
    escalations: int = 0
    shed: bool = False
    timed_out: bool = False
    failed: bool = False                   # no tier could answer (faults)
    fail_reason: Optional[str] = None      # last recorded engine fault
    reroutes: int = 0                      # fault-driven down-ladder hops
    done_at: Optional[float] = None
    span: Any = NULL_SPAN                  # root trace span (whole journey)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_at is None else \
            self.done_at - self.submitted_at


class TieredProximityServer(_MetricsHTTPMixin):
    """Deadline-aware serving across an engine ladder.

    Tiers are ordered cheapest-first.  Admission routes each request to the
    first tier whose ``kinds`` include its kind; completed ``predict``
    answers whose minimum vote margin (``prediction_margin``) falls below
    ``escalate_margin`` escalate to the next capable tier while the
    request's deadline allows.  When the deadline runs out mid-ladder the
    best answer already computed is returned (``timed_out``); a request
    shed before *any* tier answered is dropped (``shed``).

    Async mode (``start()``) runs one admission thread plus one worker
    thread per tier, each ticking its own inner ``ProximityServer`` under a
    per-tier lock — a slow full-engine tick never blocks the compressed
    tier's loop.  The identical logic runs synchronously via
    ``run_until_drained`` for deterministic tests.

    Reliability (see module docstring): each tier's worker runs its engine
    calls under a supervisor with retry/backoff and a per-tier circuit
    breaker; a tier that fails a request terminally (or whose breaker is
    open) has that request **re-routed down-ladder** to the next capable
    tier, so no admitted request is ever lost — a request only fails
    terminally when every capable tier has faulted on it, and then with a
    recorded reason.  Over-watermark queues spill down-ladder, and deadline
    budgets route hopeless escalation candidates straight to a deeper
    tier.  ``adaptive_margin=True`` calibrates the escalation threshold
    from observed escalated-vs-shallow agreement in a sliding window
    (targeting ``margin_target`` agreement above the threshold); the
    default keeps the fixed ``escalate_margin``.
    """

    def __init__(self, tiers: Sequence[Tier], escalate_margin: float = 0.1,
                 clock=time.time,
                 fault_injector: Optional[FaultInjector] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 1.0,
                 spill_watermark: Optional[int] = None,
                 adaptive_margin: bool = False,
                 margin_window: int = 256,
                 margin_target: float = 0.95,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers = list(tiers)
        self.escalate_margin = float(escalate_margin)
        self._clock = clock
        self.spill_watermark = spill_watermark
        # one registry shared across every tier (tier label disambiguates);
        # tracing is on by default with a small ring — every request gets a
        # root span whose children are the per-tier attempts, so a single
        # trace shows the full causal path (admit → tier → escalate →
        # reroute → final).
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        if tracer is not None:
            self.tracer = tracer
        elif self.registry.enabled:
            self.tracer = Tracer(clock=clock, capacity=64)
        else:
            self.tracer = _NULL_TRACER
        self.adaptive_margin = bool(adaptive_margin)
        self.margin_target = float(margin_target)
        self._margin_obs: "deque[Tuple[float, bool]]" = \
            deque(maxlen=int(margin_window))
        self._margin_min = max(8, int(margin_window) // 8)
        self._margin_lock = threading.Lock()
        self._breakers = [
            CircuitBreaker(fail_threshold=breaker_threshold,
                           cooldown_s=breaker_cooldown_s, clock=clock)
            for _ in self.tiers]
        self._servers = [
            ProximityServer(t.engine, y=t.y, n_slots=t.n_slots,
                            n_classes=t.n_classes, propagator=t.propagator,
                            embedding=t.embedding, clock=clock,
                            fault_injector=fault_injector, retry=retry,
                            breaker=self._breakers[i], name=t.name,
                            registry=self.registry, tracer=self.tracer)
            for i, t in enumerate(self.tiers)]
        # pre-warm lazy routing tables so worker threads never race their
        # first build
        for t in self.tiers:
            forest = getattr(t.engine, "forest", None)
            if forest is not None:
                forest.tree_arrays()

        self._locks = [threading.Lock() for _ in self.tiers]
        self._inbox: "deque[TieredRequest]" = deque()
        self._inbox_lock = threading.Lock()
        self._uids = itertools.count()
        self._requests: Dict[int, TieredRequest] = {}
        # inner uid -> TieredRequest, per tier
        self._pending: List[Dict[int, TieredRequest]] = \
            [{} for _ in self.tiers]
        self._seen_finished = [0] * len(self.tiers)
        self._seen_shed = [0] * len(self.tiers)
        self._seen_failed = [0] * len(self.tiers)
        self.finished: List[TieredRequest] = []
        self._finished_lock = threading.Lock()

        # ladder-level events: registry counters under one family; the
        # legacy int attributes (``srv.escalations`` ...) remain as
        # read-only properties over them
        lad = self.registry.counter("serve_ladder_total",
                                    "ladder-level events", labels=("event",))
        self._c_escalations = lad.labels(event="escalation")
        self._c_sheds = lad.labels(event="shed")
        self._c_timeouts = lad.labels(event="timeout")
        self._c_spills = lad.labels(event="spill")
        self._c_reroutes = lad.labels(event="reroute")
        self._c_failures = lad.labels(event="failure")
        self._c_recoveries = lad.labels(event="recovery")
        self._c_budget_skips = lad.labels(event="budget_skip")
        self._c_worker_crashes = lad.labels(event="worker_crash")
        self._c_worker_restarts = lad.labels(event="worker_restart")
        self._tier_requests = [0] * len(self.tiers)
        # EWMA of observed per-tier request latency, feeding deadline
        # budgets when Tier.budget_s is unset; mirrored into the
        # tier_budget_seconds gauge on every update
        self._tier_lat = [EWMA(alpha=0.2) for _ in self.tiers]
        g_budget = self.registry.gauge(
            "tier_budget_seconds", "declared/learned tier deadline budget",
            labels=("tier",))
        self._g_budget = [g_budget.labels(tier=t.name) for t in self.tiers]

        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._worker_threads: Dict[int, threading.Thread] = {}

    # legacy ladder-counter views (same names/int semantics as the
    # pre-registry fields, now reading the shared registry)
    @property
    def escalations(self) -> int:
        return int(self._c_escalations.value)

    @property
    def sheds(self) -> int:
        return int(self._c_sheds.value)

    @property
    def timeouts(self) -> int:
        return int(self._c_timeouts.value)

    @property
    def spills(self) -> int:
        return int(self._c_spills.value)

    @property
    def reroutes(self) -> int:
        return int(self._c_reroutes.value)

    @property
    def failures(self) -> int:
        return int(self._c_failures.value)

    @property
    def recoveries(self) -> int:
        return int(self._c_recoveries.value)

    @property
    def budget_skips(self) -> int:
        return int(self._c_budget_skips.value)

    @property
    def worker_crashes(self) -> int:
        return int(self._c_worker_crashes.value)

    @property
    def worker_restarts(self) -> int:
        return int(self._c_worker_restarts.value)

    # ---------------- submission / routing ----------------
    def _tier_for(self, kind: str, n_rows: int,
                  after: int = -1) -> Optional[int]:
        for i in range(after + 1, len(self.tiers)):
            if kind in self.tiers[i].kinds and \
                    n_rows <= self.tiers[i].n_slots:
                return i
        return None

    def _last_tier_for(self, kind: str, n_rows: int,
                       after: int = -1) -> Optional[int]:
        """Deepest tier serving ``kind`` — the escalation target.  A
        low-confidence prediction goes straight to the reference engine:
        an intermediate tier answering confidently-but-wrong (prototype
        factors especially) would otherwise terminate the ladder early."""
        for i in range(len(self.tiers) - 1, after, -1):
            if kind in self.tiers[i].kinds and \
                    n_rows <= self.tiers[i].n_slots:
                return i
        return None

    def submit(self, kind: str, X: np.ndarray, k: int = 10,
               priority: int = 0, deadline_s: Optional[float] = None) -> int:
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; have {KINDS}")
        X = np.ascontiguousarray(X, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError(f"X must be (n_rows, d), got {X.shape}")
        if self._tier_for(kind, X.shape[0]) is None:
            raise ValueError(f"no tier serves kind {kind!r} at "
                             f"{X.shape[0]} rows")
        now = self._clock()
        deadline_at = None if deadline_s is None else now + float(deadline_s)
        treq = TieredRequest(uid=next(self._uids), kind=kind, X=X, k=int(k),
                             priority=int(priority), deadline_at=deadline_at,
                             submitted_at=now)
        treq.span = self.tracer.root("request", kind=kind, uid=treq.uid,
                                     rows=X.shape[0])
        treq.span.event("submit", t=now, priority=treq.priority)
        self._requests[treq.uid] = treq
        with self._inbox_lock:
            self._inbox.append(treq)
        return treq.uid

    def _budget(self, i: int) -> float:
        """Tier i's deadline budget: fixed ``Tier.budget_s`` when set, else
        the learned EWMA of observed tier latency (0 until first sample)."""
        b = self.tiers[i].budget_s
        if b is not None:
            return float(b)
        lat = self._tier_lat[i].value
        return 0.0 if lat is None else float(lat)

    def _route_tier(self, treq: TieredRequest) -> int:
        """Admission tier choice: cheapest capable tier, adjusted for
        deadline budgets (skip tiers the remaining deadline can't afford,
        escalation hop included) and open circuit breakers (route around a
        tripped tier when a deeper capable one exists)."""
        kind, n_rows = treq.kind, treq.X.shape[0]
        i = self._tier_for(kind, n_rows)
        last = self._last_tier_for(kind, n_rows)
        if treq.deadline_at is not None and i is not None \
                and last is not None:
            remaining = treq.deadline_at - self._clock()
            while i is not None and i < last:
                # answering here must leave room for a possible escalation
                # hop to the deepest capable tier
                hop = self._budget(last) if (
                    kind == "predict" and self.escalate_margin > 0) else 0.0
                need = self._budget(i) + hop
                if need > 0 and remaining < need:
                    self._c_budget_skips.inc()
                    treq.span.event("budget_skip",
                                    tier=self.tiers[i].name,
                                    need_s=need, remaining_s=remaining)
                    i = self._tier_for(kind, n_rows, after=i)
                else:
                    break
            if i is None:
                i = last        # deepest tier is the last resort, always
        while i is not None and last is not None and i < last:
            if self._breakers[i].allow():
                break
            nxt = self._tier_for(kind, n_rows, after=i)
            if nxt is None:
                break
            i = nxt
        return i

    def _route_inbox(self) -> int:
        routed = 0
        while True:
            with self._inbox_lock:
                if not self._inbox:
                    return routed
                treq = self._inbox.popleft()
            self._enqueue(self._route_tier(treq), treq)
            routed += 1

    def _enqueue(self, i: int, treq: TieredRequest) -> None:
        wm = self.tiers[i].spill_watermark
        if wm is None:
            wm = self.spill_watermark
        if wm is not None:
            nxt = self._tier_for(treq.kind, treq.X.shape[0], after=i)
            if nxt is not None:
                with self._locks[i]:
                    depth = len(self._servers[i].queue)
                if depth >= wm:
                    # overload spill: degrade to the next capable tier
                    # instead of queuing toward a deadline shed (the
                    # deepest capable tier always accepts)
                    self._c_spills.inc()
                    treq.span.event("spill", tier=self.tiers[i].name,
                                    to=self.tiers[nxt].name, depth=depth)
                    self._enqueue(nxt, treq)
                    return
        with self._locks[i]:
            tspan = treq.span.child(f"tier:{self.tiers[i].name}",
                                    tier=self.tiers[i].name)
            inner_uid = self._servers[i].submit(
                treq.kind, treq.X, k=treq.k, priority=treq.priority,
                deadline_at=treq.deadline_at, span=tspan)
            self._pending[i][inner_uid] = treq
            self._tier_requests[i] += 1
            treq.tier_path.append(self.tiers[i].name)

    # ---------------- completion / escalation ----------------
    def _collect(self, i: int) -> List[Tuple[ProxRequest, str]]:
        """Newly finished/shed/failed inner requests of tier i (caller need
        not hold the tier lock; lists are append-only, indices monotone)."""
        srv = self._servers[i]
        out: List[Tuple[ProxRequest, str]] = []
        fin = srv.finished
        while self._seen_finished[i] < len(fin):
            out.append((fin[self._seen_finished[i]], "done"))
            self._seen_finished[i] += 1
        sh = srv.shed_requests
        while self._seen_shed[i] < len(sh):
            out.append((sh[self._seen_shed[i]], "shed"))
            self._seen_shed[i] += 1
        fl = srv.failed_requests
        while self._seen_failed[i] < len(fl):
            out.append((fl[self._seen_failed[i]], "failed"))
            self._seen_failed[i] += 1
        return out

    def _settle(self, i: int, inner: ProxRequest, status: str) -> None:
        treq = self._pending[i].pop(inner.uid, None)
        if treq is None:
            return
        tname = self.tiers[i].name
        if status == "shed":
            if treq.answers:
                # past deadline with an earlier tier's answer in hand:
                # answer from the best tier already available
                treq.timed_out = True
                self._c_timeouts.inc()
                treq.span.event("timeout", tier=tname)
                self._finalize(treq, best=True)
            else:
                treq.shed = True
                self._c_sheds.inc()
                treq.span.event("shed", tier=tname)
                self._finalize(treq, best=False)
            return
        if status == "failed":
            # tier faulted on this request past its retry budget (or its
            # breaker is open): re-route down-ladder rather than lose it
            treq.fail_reason = inner.fail_reason
            nxt = self._tier_for(treq.kind, treq.X.shape[0], after=i)
            if nxt is not None:
                treq.reroutes += 1
                self._c_reroutes.inc()
                treq.span.event("reroute", tier=tname,
                                to=self.tiers[nxt].name,
                                reason=inner.fail_reason)
                self._enqueue(nxt, treq)
                return
            if treq.answers:
                self._finalize(treq, best=True)
            else:
                treq.failed = True
                self._c_failures.inc()
                treq.span.event("failure", tier=tname,
                                reason=inner.fail_reason)
                self._finalize(treq, best=False)
            return
        if inner.latency_s is not None:
            self._tier_lat[i].update(inner.latency_s)
            self._g_budget[i].set(self._budget(i))
        self._record_agreement(treq, tname, inner.result)
        treq.answers[tname] = inner.result
        nxt = self._last_tier_for(treq.kind, treq.X.shape[0], after=i)
        if (treq.kind == "predict" and nxt is not None
                and self.escalate_margin > 0):
            margin = prediction_margin(inner.result["scores"])
            if margin.size and float(margin.min()) < self._live_margin():
                if treq.deadline_at is None or \
                        self._clock() <= treq.deadline_at:
                    treq.escalations += 1
                    self._c_escalations.inc()
                    treq.span.event("escalate", tier=tname,
                                    to=self.tiers[nxt].name,
                                    margin=float(margin.min()))
                    self._enqueue(nxt, treq)
                    return
                treq.timed_out = True
                self._c_timeouts.inc()
                treq.span.event("timeout", tier=tname)
        self._finalize(treq, best=True)

    # ---------------- adaptive escalation margin ----------------
    def _record_agreement(self, treq: TieredRequest, tname: str,
                          result: Any) -> None:
        """Feed the calibration window when an escalated ``predict``
        settles: pair each row's *shallow* margin with whether the deeper
        tier agreed on its label."""
        if not self.adaptive_margin or treq.kind != "predict" \
                or not treq.escalations or not isinstance(result, dict):
            return
        prev = None
        for name in treq.tier_path:
            if name != tname and name in treq.answers:
                prev = treq.answers[name]
                break
        if not isinstance(prev, dict) or "scores" not in prev:
            return
        pm = prediction_margin(prev["scores"])
        agree = np.asarray(prev["labels"]) == np.asarray(result["labels"])
        with self._margin_lock:
            for m, a in zip(pm, agree):
                self._margin_obs.append((float(m), bool(a)))

    def _live_margin(self) -> float:
        """Current escalation threshold.  Fixed ``escalate_margin`` unless
        adaptive mode has enough observations; then the smallest shallow
        margin whose above-threshold agreement with the deep tier still
        meets ``margin_target`` (escalate-everything fallback when even
        confident answers disagree)."""
        if not self.adaptive_margin:
            return self.escalate_margin
        with self._margin_lock:
            if len(self._margin_obs) < self._margin_min:
                return self.escalate_margin
            obs = sorted(self._margin_obs, key=lambda t: -t[0])
        agreed = 0
        best = float(obs[0][0])     # nothing qualifies -> escalate all
        for n, (m, a) in enumerate(obs, 1):
            agreed += a
            if agreed / n >= self.margin_target:
                best = m
        return float(best)

    def _finalize(self, treq: TieredRequest, best: bool) -> None:
        if best and treq.tier_path:
            # deepest tier that answered (tier_path order = ladder order)
            for name in reversed(treq.tier_path):
                if name in treq.answers:
                    treq.final_tier = name
                    treq.result = treq.answers[name]
                    break
        if treq.fail_reason is not None and treq.result is not None:
            self._c_recoveries.inc()    # answered despite an engine fault
        treq.done_at = self._clock()
        treq.span.event("final", t=treq.done_at,
                        tier=treq.final_tier or "",
                        escalations=treq.escalations,
                        reroutes=treq.reroutes, shed=treq.shed,
                        timed_out=treq.timed_out, failed=treq.failed)
        treq.span.end(treq.done_at)
        with self._finished_lock:
            self.finished.append(treq)
        treq.done.set()

    # ---------------- synchronous loop ----------------
    def _pump_tier(self, i: int) -> bool:
        """Tick tier i until drained, settle its completions.  Returns
        whether any work happened."""
        srv = self._servers[i]
        busy = False
        with self._locks[i]:
            while srv.queue or srv.active:
                srv.step()
                busy = True
        for inner, status in self._collect(i):
            self._settle(i, inner, status)
            busy = True
        return busy

    def run_until_drained(self, max_rounds: int = 10_000) -> None:
        """Deterministic synchronous drain: route, then pump tiers in
        ladder order until no tier has work (escalations settle in the
        same round they are issued)."""
        for _ in range(max_rounds):
            busy = self._route_inbox() > 0
            for i in range(len(self.tiers)):
                busy = self._pump_tier(i) or busy
            if not busy:
                return

    def serve(self, requests) -> List[Any]:
        """Submit ``(kind, X[, k])`` tuples, drain synchronously, return
        results in submission order (``None`` for shed requests)."""
        uids = [self.submit(*r) for r in requests]
        self.run_until_drained()
        return [self._requests[u].result for u in uids]

    # ---------------- async loop ----------------
    def start(self) -> "TieredProximityServer":
        """Spawn the admission thread and one worker per tier."""
        if self._threads:
            return self
        self._stop.clear()
        self._threads.append(threading.Thread(
            target=self._admission_loop, name="prox-admit", daemon=True))
        for i in range(len(self.tiers)):
            self._worker_threads[i] = threading.Thread(
                target=self._worker_loop, args=(i,),
                name=f"prox-tier-{self.tiers[i].name}", daemon=True)
            self._threads.append(self._worker_threads[i])
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        self.stop_metrics_http()

    def wait(self, uids: Sequence[int], timeout: Optional[float] = None
             ) -> List[Any]:
        """Block until the given requests finish; returns their results."""
        for u in uids:
            self._requests[u].done.wait(timeout)
        return [self._requests[u].result for u in uids]

    def _admission_loop(self) -> None:
        while not self._stop.is_set():
            self._respawn_dead_workers()
            if self._route_inbox() == 0:
                time.sleep(0.0005)

    def _respawn_dead_workers(self) -> None:
        """Supervision of the worker threads themselves: a worker that died
        (anything escaping the in-loop crash guard) is restarted so its
        tier keeps draining."""
        for i, t in list(self._worker_threads.items()):
            # ident is None until a thread has actually started — don't
            # "respawn" workers start() hasn't launched yet
            if t.ident is None or t.is_alive() or self._stop.is_set():
                continue
            self._c_worker_restarts.inc()
            nt = threading.Thread(
                target=self._worker_loop, args=(i,),
                name=f"prox-tier-{self.tiers[i].name}-r{self.worker_restarts}",
                daemon=True)
            self._worker_threads[i] = nt
            self._threads.append(nt)
            nt.start()

    def _worker_loop(self, i: int) -> None:
        srv = self._servers[i]
        while not self._stop.is_set():
            try:
                with self._locks[i]:
                    retired = srv.step() if (srv.queue or srv.active) else 0
                    idle = not (srv.queue or srv.active)
                settled = 0
                for inner, status in self._collect(i):
                    self._settle(i, inner, status)
                    settled += 1
            except Exception:       # noqa: BLE001 — worker must survive
                self._c_worker_crashes.inc()
                time.sleep(0.001)
                continue
            if retired == 0 and settled == 0 and idle:
                time.sleep(0.0005)

    # ---------------- accounting ----------------
    def stats(self) -> Dict[str, Any]:
        """Ladder-level counters plus each tier's inner server stats."""
        with self._finished_lock:
            n_done = len(self.finished)
        predicts = sum(1 for r in self._requests.values()
                       if r.kind == "predict")
        out: Dict[str, Any] = {
            "requests": n_done,
            "escalations": self.escalations,
            "escalation_rate": self.escalations / max(predicts, 1),
            "shed": self.sheds,
            "timeouts": self.timeouts,
            "live_margin": self._live_margin(),
            "reliability": {
                "faults": sum(s.faults for s in self._servers),
                "retries": sum(s.retries for s in self._servers),
                "recovered_calls": sum(s.recovered_calls
                                       for s in self._servers),
                "failed_calls": sum(s.failed_calls for s in self._servers),
                "spills": self.spills,
                "reroutes": self.reroutes,
                "recoveries": self.recoveries,
                "failures": self.failures,
                "budget_skips": self.budget_skips,
                "worker_crashes": self.worker_crashes,
                "worker_restarts": self.worker_restarts,
            },
            "tiers": {},
        }
        for i, t in enumerate(self.tiers):
            st = self._servers[i].stats()
            st["routed_requests"] = self._tier_requests[i]
            st["budget_s"] = self._budget(i)
            st["reliability"]["breaker"] = self._breakers[i].snapshot()
            out["tiers"][t.name] = st
        return out
