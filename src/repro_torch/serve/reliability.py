"""Reliability primitives for the proximity serving stack (the port's copy
of the reference's; host Python and numpy only — the server hands them the
host copies of each tick's results).

Three small, composable pieces — all with injectable clocks / sleeps so
every recovery path is deterministically testable without real time:

``FaultInjector``
    A seeded chaos source the engine workers consult around every engine
    call.  At configurable rates it raises :class:`InjectedFault`, injects
    synthetic latency, or corrupts a result buffer (NaN poisoning — the
    detectable analogue of a bad DMA / truncated RPC).  One RNG stream,
    drawn under a lock, so a given seed produces one deterministic fault
    schedule per call sequence.

``RetryPolicy``
    Bounded retry-with-exponential-backoff for a failed engine call.  The
    sleep is injectable (tests pass a no-op; the tick loop's own latency
    accounting still sees the added service time through the clock).

``CircuitBreaker``
    Per-tier failure gate: ``fail_threshold`` *consecutive* faults trip it
    open; while open, the tier fails fast (the tiered server re-routes its
    queue down-ladder instead of burning retries against a broken engine);
    after ``cooldown_s`` one probe call is allowed (half-open) and a success
    closes it again.

``CorruptedResult`` is raised by the server's result validation when an
engine call returns non-finite values — whether injected or real — so
corruption is handled by the same retry/re-route machinery as exceptions.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["FaultInjector", "InjectedFault", "CorruptedResult",
           "RetryPolicy", "CircuitBreaker", "validate_finite"]


class InjectedFault(RuntimeError):
    """Synthetic engine failure raised by :class:`FaultInjector`."""


class CorruptedResult(RuntimeError):
    """An engine call returned a buffer with non-finite entries."""


def validate_finite(kind: str, arrays) -> None:
    """Raise :class:`CorruptedResult` if any result array is non-finite.

    ``arrays`` is the tuple of kind-level result buffers an engine call
    produced (scores / top-k values / embeddings ...).  Integer arrays pass
    untouched; float arrays must be fully finite.
    """
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind == "f" and a.size and not np.isfinite(a).all():
            raise CorruptedResult(
                f"{kind!r} result contains non-finite values")


@dataclasses.dataclass
class FaultInjector:
    """Seeded synthetic-fault source consulted around engine calls.

    Rates are independent per call: with probability ``error_rate`` the
    call raises before touching the engine, with ``latency_rate`` it sleeps
    ``latency_s`` first, and with ``corrupt_rate`` the *result* gets one
    entry poisoned to NaN (caught by :func:`validate_finite` downstream).
    ``ops``/``scopes`` restrict injection to specific request kinds or
    server names (empty = all).  Thread-safe: workers of several tiers may
    share one injector and still consume a single deterministic RNG stream.
    """

    error_rate: float = 0.0
    latency_rate: float = 0.0
    latency_s: float = 0.0
    corrupt_rate: float = 0.0
    seed: int = 0
    ops: tuple = ()                 # restrict to these request kinds
    scopes: tuple = ()              # restrict to these server/tier names
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected: Dict[str, int] = {"error": 0, "latency": 0,
                                         "corrupt": 0}
        self.by_op: Dict[str, int] = {}
        self._metrics = None            # optional registry counter family

    def bind_registry(self, registry) -> "FaultInjector":
        """Mirror injected-fault counts into the registry's
        ``fault_injected_total{type,op}`` counter family.  Optional — an
        unbound injector keeps its plain dict accounting only."""
        self._metrics = registry.counter(
            "fault_injected_total", "synthetic faults injected",
            labels=("type", "op"))
        return self

    def _in_scope(self, op: str, scope: Optional[str]) -> bool:
        if self.ops and op not in self.ops:
            return False
        if self.scopes and scope is not None and scope not in self.scopes:
            return False
        return True

    def before_call(self, op: str, scope: Optional[str] = None) -> None:
        """Consulted before an engine call; may sleep or raise."""
        with self._lock:
            self.calls += 1
            if not self._in_scope(op, scope):
                return
            u_err, u_lat = self._rng.random(2)
            fire_err = u_err < self.error_rate
            fire_lat = u_lat < self.latency_rate
            if fire_err:
                self.injected["error"] += 1
                self.by_op[op] = self.by_op.get(op, 0) + 1
                if self._metrics is not None:
                    self._metrics.labels(type="error", op=op).inc()
            if fire_lat:
                self.injected["latency"] += 1
                if self._metrics is not None:
                    self._metrics.labels(type="latency", op=op).inc()
        # side effects happen outside the lock
        if fire_lat and self.latency_s > 0:
            self.sleep(self.latency_s)
        if fire_err:
            raise InjectedFault(f"injected engine fault (op={op!r})")

    def corrupt(self, op: str, arrays, scope: Optional[str] = None):
        """Possibly poison one entry of one float result buffer with NaN.

        Returns the (possibly copied-and-corrupted) arrays tuple; the
        originals are never mutated in place.
        """
        with self._lock:
            if not self._in_scope(op, scope) or \
                    not (self._rng.random() < self.corrupt_rate):
                return arrays
            self.injected["corrupt"] += 1
            self.by_op[op] = self.by_op.get(op, 0) + 1
            if self._metrics is not None:
                self._metrics.labels(type="corrupt", op=op).inc()
            picks = self._rng.random(2)
        out = list(arrays)
        floats = [i for i, a in enumerate(out)
                  if np.asarray(a).dtype.kind == "f"
                  and np.asarray(a).size]
        if floats:
            i = floats[int(picks[0] * len(floats)) % len(floats)]
            a = np.array(out[i], dtype=np.float64, copy=True)
            flat = a.reshape(-1)
            flat[int(picks[1] * flat.size) % flat.size] = np.nan
            out[i] = a
        return tuple(out)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"calls": self.calls, "injected": dict(self.injected),
                    "by_op": dict(self.by_op)}


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry-with-backoff for failed engine calls.

    ``max_retries`` is the number of *re-attempts* after the first failure
    (so a call runs at most ``max_retries + 1`` times).  Backoff is
    exponential: attempt ``k`` sleeps ``backoff_s * 2**(k-1)``, capped at
    ``max_backoff_s``.  ``sleep`` is injectable — deterministic tests pass
    a no-op and the sync drain stays instant.
    """

    max_retries: int = 2
    backoff_s: float = 0.01
    max_backoff_s: float = 0.25
    sleep: Callable[[float], None] = time.sleep

    def backoff(self, attempt: int) -> float:
        """Sleep for attempt ``attempt`` (1-based); returns the delay."""
        delay = min(self.backoff_s * (2.0 ** max(attempt - 1, 0)),
                    self.max_backoff_s)
        if delay > 0:
            self.sleep(delay)
        return delay


@dataclasses.dataclass
class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    States: ``closed`` (normal) → ``open`` after ``fail_threshold``
    consecutive failures (``allow()`` returns False: the owner fails fast)
    → ``half_open`` once ``cooldown_s`` has elapsed (``allow()`` lets one
    probe call through) → ``closed`` on probe success, back to ``open`` on
    probe failure.  The clock is injectable (matching the serving stack).
    """

    fail_threshold: int = 5
    cooldown_s: float = 5.0
    clock: Callable[[], float] = time.time

    def __post_init__(self):
        self.state = "closed"
        self.consecutive_failures = 0
        self.trips = 0
        self.opened_at: Optional[float] = None
        self._lock = threading.Lock()
        self._m_transitions = None      # optional registry hooks
        self._g_open = None
        self._tier = ""

    def bind_registry(self, registry, tier: str = "") -> "CircuitBreaker":
        """Mirror state transitions into
        ``breaker_transitions_total{tier,state}`` and the ``breaker_open``
        gauge (1 while open).  Optional — an unbound breaker keeps its
        plain ``snapshot()`` accounting only."""
        self._tier = str(tier)
        self._m_transitions = registry.counter(
            "breaker_transitions_total", "circuit-breaker state entries",
            labels=("tier", "state"))
        self._g_open = registry.gauge(
            "breaker_open", "1 while the breaker is open",
            labels=("tier",)).labels(tier=self._tier)
        return self

    def _note_state(self, new: str) -> None:
        if self._m_transitions is not None:
            self._m_transitions.labels(tier=self._tier, state=new).inc()
            self._g_open.set(1.0 if new == "open" else 0.0)

    def allow(self) -> bool:
        """Whether the next engine call may proceed."""
        with self._lock:
            if self.state == "open":
                if self.clock() - self.opened_at >= self.cooldown_s:
                    self.state = "half_open"     # one probe allowed
                    self._note_state("half_open")
                    return True
                return False
            return True                          # closed or half_open

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0
            if self.state != "closed":
                self.state = "closed"
                self.opened_at = None
                self._note_state("closed")

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            tripped = (self.state == "half_open" or
                       self.consecutive_failures >= self.fail_threshold)
            if tripped and self.state != "open":
                self.state = "open"
                self.trips += 1
                self.opened_at = self.clock()
                self._note_state("open")
            elif self.state == "open":
                self.opened_at = self.clock()    # extend the cooldown

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self.state, "trips": self.trips,
                    "consecutive_failures": self.consecutive_failures}
