"""Observability layer: metrics, tracing, profiling hooks.

Three dependency-free pillars shared by serving, the engine, and training
(the port's copies of the reference's ``obs`` package):

``obs.metrics``
    Thread-safe :class:`MetricsRegistry` of Counter / Gauge / Histogram
    families (labeled children, log-spaced latency buckets, exact
    percentiles from a bounded sample reservoir), JSON snapshots and
    Prometheus text exposition, plus the shared :class:`EWMA` primitive.

``obs.trace``
    Per-request span trees on an injectable clock, sampled into a bounded
    ring buffer, exportable as Chrome ``chrome://tracing`` JSON; and the
    engine's regions (``region``, switched by ``set_regions``, off by
    default): ``torch.profiler`` ranges named ``repro:<name>``.

``obs.profile``
    ``instrument(engine)`` — a transparent proxy timing every
    ``ProximityEngine`` op into ``engine_op_seconds{op,backend,tier}``
    (on the card, up to the end of the op's device work) and mirroring
    qs-cache hit/miss gauges.

A process-wide default registry (``metrics.global_registry()``) collects
the training / snapshot / engine-memory hooks; the serving stack owns
explicit registries (one per server ladder).
"""
from .http import EXPOSITION_CONTENT_TYPE, MetricsHTTPServer
from .metrics import (EWMA, Counter, Gauge, Histogram, MetricsRegistry,
                      global_registry, parse_exposition)
from .profile import InstrumentedEngine, instrument
from .trace import NULL_REGION, NULL_SPAN, Span, Tracer, region, set_regions

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram", "EWMA",
           "global_registry", "parse_exposition", "Tracer", "Span",
           "NULL_SPAN", "NULL_REGION", "region", "set_regions", "instrument",
           "InstrumentedEngine", "MetricsHTTPServer",
           "EXPOSITION_CONTENT_TYPE"]
