"""Thread-safe metrics registry: Counter / Gauge / Histogram families
(the port's copy of the reference's registry; host Python and numpy only).

Design notes
------------
- **Families and children.**  ``registry.counter("serve_requests_total",
  labels=("tier", "kind"))`` returns a :class:`Family`; ``family.labels(
  tier="full", kind="predict")`` returns (creating on first use) the child
  metric for that label combination.  A family declared with no label
  names *is* its own single child, so unlabeled metrics read naturally
  (``registry.counter("ticks_total").inc()``).
- **Histograms** hold fixed log-spaced buckets (upper bounds, +Inf
  implicit) for exposition *and* a bounded reservoir of raw samples for
  percentiles: below the reservoir cap percentiles are **exact**
  (``np.percentile`` over every observation — bit-equal to the per-request
  latency lists they replace in ``ProximityServer.stats()``); past the cap
  they fall back to linear interpolation within the matching bucket.
- **Disabled registries** (``MetricsRegistry(enabled=False)``) hand out
  shared no-op children whose ``inc``/``set``/``observe`` do nothing, so a
  serving stack built against a disabled registry pays only an attribute
  load per call site.
- **Exposition.**  ``snapshot()`` returns a JSON-ready dict;
  ``exposition()`` renders Prometheus text format (counter / gauge /
  histogram with ``_bucket``/``_sum``/``_count`` series);
  :func:`parse_exposition` parses that text back into a value map for
  round-trip tests and CI validation.

Everything is plain Python + numpy; one lock per registry guards family
creation, one lock per child guards its own state.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "EWMA", "Family",
           "MetricsRegistry", "global_registry", "set_global_registry",
           "default_latency_buckets", "parse_exposition"]


def default_latency_buckets(lo: float = 1e-4, hi: float = 60.0,
                            per_decade: int = 5) -> Tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds (seconds), 100µs → 60s.

    ``per_decade`` bounds per factor-of-10; the +Inf bucket is implicit.
    """
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    edges = lo * np.power(10.0, np.arange(n) / per_decade)
    return tuple(float(e) for e in edges if e <= hi * (1 + 1e-9))


class EWMA:
    """Exponentially-weighted moving average with first-sample seeding.

    ``value`` is ``None`` until the first ``update``; afterwards
    ``v ← (1 - alpha)·v + alpha·x`` — the exact blend the tiered server's
    learned deadline budgets used inline before this primitive existed.
    """

    __slots__ = ("alpha", "_value", "_lock", "count")

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._value: Optional[float] = None
        self.count = 0
        self._lock = threading.Lock()

    @property
    def value(self) -> Optional[float]:
        return self._value

    def update(self, x: float) -> float:
        with self._lock:
            self.count += 1
            if self._value is None:
                self._value = float(x)
            else:
                self._value = (1.0 - self.alpha) * self._value \
                    + self.alpha * float(x)
            return self._value


class Counter:
    """Monotone counter (float increments allowed)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Set/inc/dec instantaneous value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        # a single attribute store is atomic under the GIL — no lock on the
        # hot path (inc/dec read-modify-write still locks)
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with a bounded exact-sample reservoir.

    ``buckets`` are ascending upper bounds; the +Inf bucket is implicit.
    The first ``sample_cap`` observations are retained verbatim, so
    ``percentile(p)`` is exact (``np.percentile``) until the reservoir
    fills, after which it interpolates within the cumulative-count bucket
    that crosses the requested rank (error bounded by bucket width).
    """

    __slots__ = ("buckets", "counts", "sum", "count", "min", "max",
                 "sample_cap", "_samples", "_lock")

    def __init__(self, buckets: Optional[Sequence[float]] = None,
                 sample_cap: int = 4096):
        self.buckets = tuple(float(b) for b in (
            buckets if buckets is not None else default_latency_buckets()))
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be ascending")
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        self.sample_cap = int(sample_cap)
        self._samples: List[float] = []
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        x = float(x)
        # bisect over a small tuple; buckets are ~25 wide at most
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if x <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.sum += x
            self.count += 1
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x
            if len(self._samples) < self.sample_cap:
                self._samples.append(x)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100]; exact below the reservoir cap, else bucket interp."""
        with self._lock:
            n = self.count
            if not n:
                return 0.0
            if n <= len(self._samples):
                return float(np.percentile(self._samples, p))
            counts = list(self.counts)
            lo_v, hi_v = self.min, self.max
        # cumulative rank walk over buckets
        rank = (p / 100.0) * n
        cum = 0
        prev_edge = lo_v
        for i, c in enumerate(counts):
            if not c:
                if i < len(self.buckets):
                    prev_edge = max(prev_edge, min(self.buckets[i], hi_v))
                continue
            if cum + c >= rank:
                edge = self.buckets[i] if i < len(self.buckets) else hi_v
                edge = min(edge, hi_v)
                frac = (rank - cum) / c
                return float(prev_edge + frac * (edge - prev_edge))
            cum += c
            prev_edge = min(self.buckets[i], hi_v) \
                if i < len(self.buckets) else hi_v
        return float(hi_v)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out = {
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.sum / self.count if self.count else 0.0,
                "buckets": {f"{b:g}": c
                            for b, c in zip(self.buckets, self.counts)},
                "inf": self.counts[-1],
            }
        if self.count:
            out["p50"] = self.percentile(50)
            out["p95"] = self.percentile(95)
            out["p99"] = self.percentile(99)
        return out


class _NullMetric:
    """Shared no-op child handed out by disabled registries."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    def percentile(self, p: float) -> float:
        return 0.0

    @property
    def mean(self) -> float:
        return 0.0

    @property
    def sum(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def value(self) -> float:
        return 0.0

    def labels(self, **kv) -> "_NullMetric":
        return self

    def snapshot(self):
        return 0.0


NULL_METRIC = _NullMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family; children keyed by label values."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Tuple[str, ...] = (), **child_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.label_names:                 # unlabeled: self is child
            self._children[()] = _KINDS[kind](**child_kw)

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(f"{self.name}: labels {sorted(kv)} != declared "
                             f"{sorted(self.label_names)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(
                    key, _KINDS[self.kind](**self._child_kw))
        return child

    # unlabeled convenience: the family proxies its single child
    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name}: labeled family needs .labels()")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def observe(self, x: float) -> None:
        self._solo().observe(x)

    def percentile(self, p: float) -> float:
        return self._solo().percentile(p)

    @property
    def value(self):
        return self._solo().value

    @property
    def count(self):
        return self._solo().count

    @property
    def sum(self):
        return self._solo().sum

    @property
    def mean(self):
        return self._solo().mean

    def items(self):
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Process- or server-scoped collection of metric families.

    ``enabled=False`` turns every factory into a no-op metric source —
    call sites keep working, nothing is recorded, and the serving hot
    path's instrumentation cost collapses to attribute loads.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    # ---------------- factories ----------------
    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], **child_kw) -> Family:
        if not self.enabled:
            return NULL_METRIC
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help=help,
                             label_names=tuple(labels), **child_kw)
                self._families[name] = fam
            elif fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-declared as {kind}{tuple(labels)} "
                    f"(was {fam.kind}{fam.label_names})")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None,
                  sample_cap: int = 4096) -> Family:
        return self._family(name, "histogram", help, labels,
                            buckets=buckets, sample_cap=sample_cap)

    # ---------------- export ----------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-ready nested dict of every family's children."""
        out: Dict[str, object] = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            entry: Dict[str, object] = {"kind": fam.kind}
            if fam.help:
                entry["help"] = fam.help
            series = {}
            for key, child in fam.items():
                lbl = ",".join(f"{k}={v}"
                               for k, v in zip(fam.label_names, key))
                series[lbl] = child.snapshot()
            entry["series"] = series
            out[fam.name] = entry
        return out

    def exposition(self) -> str:
        """Prometheus text exposition (version 0.0.4 format)."""
        lines: List[str] = []
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        for fam in fams:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.items()):
                base = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        lines.append(_series(f"{fam.name}_bucket",
                                             {**base, "le": f"{b:g}"}, cum))
                    lines.append(_series(f"{fam.name}_bucket",
                                         {**base, "le": "+Inf"},
                                         child.count))
                    lines.append(_series(f"{fam.name}_sum", base, child.sum))
                    lines.append(_series(f"{fam.name}_count", base,
                                         child.count))
                else:
                    lines.append(_series(fam.name, base, child.value))
        return "\n".join(lines) + ("\n" if lines else "")


def _series(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in labels.items())
        name = f"{name}{{{body}}}"
    if isinstance(value, float) and value == int(value) \
            and abs(value) < 1e15:
        value = int(value)
    return f"{name} {value}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


_LINE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                         ...]], float]:
    """Parse Prometheus text back into ``{(name, ((k, v), ...)): value}``.

    Minimal but strict: every non-comment line must match the series
    grammar (raises ``ValueError`` otherwise), so CI can assert a
    registry's exposition is well-formed by round-tripping it.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, labels_body, value = m.groups()
        labels: Tuple[Tuple[str, str], ...] = ()
        if labels_body:
            labels = tuple(
                (k, v.replace(r'\"', '"').replace(r"\n", "\n")
                 .replace(r"\\", "\\"))
                for k, v in _LABEL_RE.findall(labels_body))
        out[(name, labels)] = float(value)
    return out


# ---------------------------------------------------------------------------
# process-wide default registry (training / snapshot profiling hooks)
# ---------------------------------------------------------------------------

_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide registry the training and snapshot hooks emit to."""
    return _GLOBAL


def set_global_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests / overhead benchmarks);
    returns the previous one."""
    global _GLOBAL
    old, _GLOBAL = _GLOBAL, reg
    return old
