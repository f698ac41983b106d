"""The port's observability layer against the reference's.

Counterparts of ``tests/test_obs.py``: the metrics registry, per-request
tracing, the engine profiling hooks and their wiring into the port's
serving stack, the training / snapshot / engine-memory hooks on the
process-wide registry, and the ``/metrics`` endpoint (on localhost).  Also:
the same observations into the port's and the reference's registries give
the same exposition text, each package's parser reads the other's
exposition, and the trainer's level metrics appear on the ``torch`` branch.

Everything runs on the CPU (``device="cpu"``); histograms are checked
against numpy on fixed samples and the tracer runs on fake clocks.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.obs import metrics as ref_metrics
from repro_torch.core.api import ForestKernel
from repro_torch.data.synthetic import gaussian_classes
from repro_torch.obs.metrics import (EWMA, Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_METRIC,
                                     default_latency_buckets,
                                     global_registry, parse_exposition,
                                     set_global_registry)
from repro_torch.obs.profile import ENGINE_OPS, InstrumentedEngine, instrument
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.serve.proximity import ProximityServer
from repro_torch.serve.reliability import RetryPolicy


@pytest.fixture(scope="module")
def obs_setup():
    X, y = gaussian_classes(400, d=8, n_classes=3, sep=3.0, seed=7)
    fk = ForestKernel(kernel_method="gap", n_trees=12, seed=0,
                      device="cpu").fit(X, y)
    Xq = np.ascontiguousarray(X[:64] + 1e-3)
    return {"fk": fk, "X": X, "y": y, "Xq": Xq}


@pytest.fixture
def fresh_global():
    """A fresh process-wide registry for the test, the old one restored."""
    old = global_registry()
    reg = MetricsRegistry()
    set_global_registry(reg)
    try:
        yield reg
    finally:
        set_global_registry(old)


def _fake_clock(start=0.0):
    t = [start]

    def clock():
        return t[0]

    clock.t = t
    return clock


# ---------------------------------------------------------------- metrics
class TestPrimitives:
    def test_counter_and_gauge(self):
        c, g = Counter(), Gauge()
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        g.set(7.0)
        g.inc()
        g.dec(3.0)
        assert g.value == 5.0

    def test_ewma_seeds_then_blends(self):
        e = EWMA(alpha=0.5)
        assert e.value is None
        assert e.update(10.0) == 10.0
        assert e.update(20.0) == pytest.approx(15.0)
        assert e.count == 2

    def test_histogram_exact_percentiles_vs_numpy(self):
        rng = np.random.default_rng(0)
        xs = rng.lognormal(mean=-5.0, sigma=1.5, size=2000)
        h = Histogram()
        for x in xs:
            h.observe(float(x))
        for p in (50, 90, 95, 99):
            assert h.percentile(p) == pytest.approx(
                float(np.percentile(xs, p)))
        assert h.mean == pytest.approx(float(xs.mean()))
        assert h.count == len(xs)
        assert h.min == pytest.approx(xs.min())
        assert h.max == pytest.approx(xs.max())

    def test_histogram_bucket_counts(self):
        h = Histogram(buckets=(1.0, 2.0, 4.0))
        for x in (0.5, 1.5, 1.7, 3.0, 100.0):
            h.observe(x)
        assert h.counts == [1, 2, 1, 1]      # last bucket is +Inf overflow

    def test_histogram_interpolates_past_reservoir(self):
        h = Histogram(buckets=tuple(float(b) for b in range(1, 101)),
                      sample_cap=100)
        xs = np.linspace(0.5, 99.5, 10_000)
        for x in xs:
            h.observe(float(x))
        assert abs(h.percentile(50) - float(np.percentile(xs, 50))) <= 1.0
        assert abs(h.percentile(95) - float(np.percentile(xs, 95))) <= 1.0

    def test_histogram_rejects_unsorted_buckets(self):
        with pytest.raises(ValueError):
            Histogram(buckets=(2.0, 1.0))

    def test_default_buckets_ascending_subsecond(self):
        b = default_latency_buckets()
        assert list(b) == sorted(b)
        assert b[0] < 1e-3 and b[-1] >= 10.0

    def test_thread_safety_exact_counts(self):
        reg = MetricsRegistry()
        c = reg.counter("c_total", "c")
        h = reg.histogram("h_seconds", "h")
        n_threads, per_thread = 8, 2000

        def work():
            for i in range(per_thread):
                c.inc()
                h.observe(0.001 * (i % 7))

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert c.value == n_threads * per_thread
        assert h.count == n_threads * per_thread
        assert sum(h.labels().counts) == n_threads * per_thread


class TestRegistry:
    def test_labeled_families(self):
        reg = MetricsRegistry()
        fam = reg.counter("req_total", "requests", labels=("tier", "kind"))
        fam.labels(tier="a", kind="x").inc(2)
        fam.labels(tier="b", kind="x").inc()
        assert fam.labels(tier="a", kind="x").value == 2
        with pytest.raises(ValueError):
            fam.labels(tier="a")
        with pytest.raises(ValueError):
            fam.labels(tier="a", kind="x", extra="y")

    def test_disabled_registry_returns_null_metric(self):
        reg = MetricsRegistry(enabled=False)
        c = reg.counter("c_total", "c")
        h = reg.histogram("h_seconds", "h", labels=("tier",))
        c.inc()
        h.labels(tier="z").observe(1.0)
        assert c is NULL_METRIC
        assert c.value == 0 and h.labels(tier="z").count == 0
        assert h.labels(tier="z").percentile(95) == 0.0
        assert reg.snapshot() == {}
        assert reg.exposition() == ""

    def test_snapshot_shape(self):
        reg = MetricsRegistry()
        reg.counter("a_total", "a").inc(3)
        reg.gauge("g", "g").set(1.5)
        reg.histogram("h_seconds", "h").observe(0.25)
        snap = reg.snapshot()
        assert snap["a_total"]["kind"] == "counter"
        assert snap["g"]["kind"] == "gauge"
        assert snap["h_seconds"]["kind"] == "histogram"

    def test_exposition_round_trip(self):
        reg = MetricsRegistry()
        reg.counter("req_total", "requests",
                    labels=("tier", "kind")).labels(
                        tier="full", kind="predict").inc(5)
        reg.gauge("depth", "queue depth").set(3.0)
        reg.histogram("lat_seconds", "latency",
                      labels=("tier",)).labels(tier="full").observe(0.125)
        series = parse_exposition(reg.exposition())
        assert series[('req_total', (('tier', 'full'),
                                     ('kind', 'predict')))] == 5.0
        assert series[("depth", ())] == 3.0
        assert series[('lat_seconds_count', (('tier', 'full'),))] == 1.0
        assert series[('lat_seconds_sum', (('tier', 'full'),))] == \
            pytest.approx(0.125)
        assert any(name == "lat_seconds_bucket" and
                   any(k == "le" for k, _ in labels)
                   for name, labels in series)

    def test_global_registry_swap(self):
        old = global_registry()
        try:
            mine = MetricsRegistry()
            set_global_registry(mine)
            assert global_registry() is mine
        finally:
            set_global_registry(old)


def _observe_sequence(reg):
    """One fixed sequence of observations, applied to a registry of either
    package."""
    rng = np.random.default_rng(3)
    fam = reg.counter("serve_requests_total", "requests by status",
                      labels=("tier", "kind", "status"))
    for i in range(40):
        fam.labels(tier=("full", "shallow")[i % 2], kind="predict",
                   status=("done", "shed", "failed")[i % 3]).inc(1 + i % 4)
    g = reg.gauge("serve_queue_depth", "queued requests", labels=("tier",))
    g.labels(tier="full").set(7.0)
    g.labels(tier="a\"b\\c\nd").inc(2.5)          # escaped label value
    reg.gauge("depth", "").set(-3.25)
    h = reg.histogram("serve_request_seconds", "latency",
                      labels=("tier", "kind"))
    for x in rng.lognormal(-6.0, 1.5, size=300):
        h.labels(tier="full", kind="topk").observe(float(x))
    small = reg.histogram("small_seconds", "capped", buckets=(0.5, 1.0, 2.0),
                          sample_cap=8)
    for x in rng.random(50) * 3:
        small.observe(float(x))


def test_exposition_text_equals_reference():
    """The same observations give the same Prometheus text (and JSON
    snapshot) in the port and the reference."""
    port, ref = MetricsRegistry(), ref_metrics.MetricsRegistry()
    _observe_sequence(port)
    _observe_sequence(ref)
    assert port.exposition() == ref.exposition()
    assert json.dumps(port.snapshot(), sort_keys=True) == \
        json.dumps(ref.snapshot(), sort_keys=True)


def test_parse_exposition_round_trips_across_packages():
    """Each package's parser reads the other's exposition to the same
    series, and every series of the text comes back."""
    port, ref = MetricsRegistry(), ref_metrics.MetricsRegistry()
    _observe_sequence(port)
    _observe_sequence(ref)
    p_text, r_text = port.exposition(), ref.exposition()
    parsed = parse_exposition(p_text)
    assert parsed == ref_metrics.parse_exposition(p_text)
    assert parsed == parse_exposition(r_text)
    n_series = sum(1 for ln in p_text.splitlines()
                   if ln and not ln.startswith("#"))
    assert len(parsed) == n_series
    assert parsed[("serve_queue_depth", (("tier", "a\"b\\c\nd"),))] == 2.5
    with pytest.raises(ValueError):
        parse_exposition("not a series line at all\n")


# ---------------------------------------------------------------- tracing
class TestTrace:
    def test_span_nesting_and_deterministic_timestamps(self):
        clock = _fake_clock(100.0)
        tr = Tracer(clock=clock, capacity=8)
        root = tr.root("request", kind="predict")
        assert root.t0 == 100.0
        clock.t[0] = 100.5
        child = root.child("tier:full", tier="full")
        child.event("admit", slots=4)
        clock.t[0] = 101.0
        child.end()
        root.end()
        (got,) = tr.spans()
        assert got is root
        d = got.to_dict()
        assert d["t0"] == 100.0 and d["t1"] == 101.0
        assert d["children"][0]["name"] == "tier:full"
        assert d["children"][0]["t0"] == 100.5
        assert d["children"][0]["events"][0]["t"] == 100.5

    def test_record_pre_measured_interval(self):
        tr = Tracer(clock=_fake_clock(), capacity=4)
        root = tr.root("request")
        c = root.record("engine:predict", 1.0, 2.5, rows=8)
        assert c.t0 == 1.0 and c.t1 == 2.5
        root.end(3.0)
        assert tr.spans()[0].children[0].attrs["rows"] == 8

    def test_ring_buffer_bounded(self):
        tr = Tracer(clock=_fake_clock(), capacity=4)
        for i in range(10):
            tr.root(f"r{i}").end(float(i))
        spans = tr.spans()
        assert len(spans) == 4
        assert [s.name for s in spans] == ["r6", "r7", "r8", "r9"]

    def test_sampling(self):
        tr = Tracer(clock=_fake_clock(), capacity=16, sample_every=3)
        roots = [tr.root(f"r{i}") for i in range(9)]
        sampled = [r for r in roots if r is not NULL_SPAN]
        assert len(sampled) == 3
        assert tr.started == 3 and tr.dropped == 6

    def test_disabled_tracer_is_null(self):
        tr = Tracer(enabled=False)
        sp = tr.root("x")
        assert sp is NULL_SPAN
        sp.event("e")
        sp.child("c").end()
        sp.record("r", 0.0, 1.0)
        sp.end()
        assert tr.spans() == []

    def test_chrome_trace_export(self, tmp_path):
        clock = _fake_clock(10.0)
        tr = Tracer(clock=clock, capacity=4)
        root = tr.root("request", kind="topk")
        clock.t[0] = 10.001
        root.event("escalate", to="full")
        root.record("engine:topk", 10.0005, 10.0009)
        clock.t[0] = 10.002
        root.end()
        path = tmp_path / "trace.json"
        obj = tr.export(str(path))
        on_disk = json.loads(path.read_text())
        assert on_disk == obj
        phases = {e["ph"] for e in obj["traceEvents"]}
        assert {"M", "X", "i"} <= phases
        xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
        assert {e["name"] for e in xs} == {"request", "engine:topk"}
        req = next(e for e in xs if e["name"] == "request")
        assert req["dur"] == pytest.approx(2000.0)


# ----------------------------------------------------------- engine hooks
class TestInstrument:
    def test_ops_timed_and_counted(self, obs_setup):
        fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]
        reg = MetricsRegistry()
        eng = instrument(fk.engine, reg, tier="full")
        assert isinstance(eng, InstrumentedEngine)
        assert instrument(eng, reg) is eng            # idempotent
        out = eng.predict(y, n_classes=3, X=Xq)
        assert out.shape == (len(Xq), 3)
        # the backend label is the engine's device type
        hist = reg.histogram("engine_op_seconds", labels=("op", "backend",
                                                          "tier"))
        timer = hist.labels(op="predict", backend="cpu", tier="full")
        assert timer.count == 1 and timer.sum > 0
        calls = reg.counter("engine_op_calls_total",
                            labels=("op", "backend", "tier"))
        assert calls.labels(op="predict", backend="cpu",
                            tier="full").value == 1
        assert "unknown" not in reg.exposition()

    def test_delegation_untouched(self, obs_setup):
        fk = obs_setup["fk"]
        eng = instrument(fk.engine, MetricsRegistry(), tier="t")
        assert eng.wrapped is fk.engine
        assert eng.W is fk.engine.W
        assert eng.device == fk.engine.device
        for op in ENGINE_OPS:
            if hasattr(fk.engine, op):
                assert callable(getattr(eng, op))


# --------------------------------------------------------- serving wiring
class TestServingWiring:
    def test_stats_backward_compat(self, obs_setup):
        fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]
        srv = ProximityServer(fk.engine, y=y, n_slots=32)
        srv.serve([("predict", Xq[:8]), ("topk", Xq[:4], 3)])
        st = srv.stats()
        assert st["requests"] == 2 and st["rows"] == 12
        ks = st["kinds"]["predict"]
        for key in ("requests", "p50_ms", "p95_ms", "p50_service_ms",
                    "mean_wait_ms"):
            assert key in ks
        assert ks["requests"] == 1

    def test_registry_families_populated(self, obs_setup):
        fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]
        srv = ProximityServer(fk.engine, y=y, n_slots=32, name="solo")
        srv.serve([("predict", Xq[:8])])
        reg = srv.registry
        done = reg.counter("serve_requests_total",
                           labels=("tier", "kind", "status"))
        assert done.labels(tier="solo", kind="predict",
                           status="done").value == 1
        lat = reg.histogram("serve_request_seconds", labels=("tier", "kind"))
        assert lat.labels(tier="solo", kind="predict").count == 1
        ops = reg.counter("engine_op_calls_total",
                          labels=("op", "backend", "tier"))
        assert ops.labels(op="predict", backend="cpu",
                          tier="solo").value >= 1

    def test_disabled_registry_serves_identically(self, obs_setup):
        fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]
        on = ProximityServer(fk.engine, y=y, n_slots=32)
        off = ProximityServer(fk.engine, y=y, n_slots=32,
                              registry=MetricsRegistry(enabled=False))
        r_on = on.serve([("predict", Xq[:8])])[0]["labels"]
        r_off = off.serve([("predict", Xq[:8])])[0]["labels"]
        np.testing.assert_array_equal(r_on, r_off)
        assert not isinstance(off.engine, InstrumentedEngine)
        assert off.stats()["kinds"] == {}

    def test_tiered_full_causal_path_trace(self, obs_setup):
        fk, Xq = obs_setup["fk"], obs_setup["Xq"]
        srv = fk.serve_tiered(prefix_depth=2, escalate_margin=0.95,
                              n_slots=32)
        srv.serve([("predict", Xq[:8])])
        spans = srv.tracer.spans()
        assert len(spans) == 1
        root = spans[0]
        assert root.name == "request" and root.t1 is not None
        ev = [name for _, name, _ in root.events]
        assert ev[0] == "submit" and ev[-1] == "final"
        assert "escalate" in ev
        tiers = [c for c in root.children if c.name.startswith("tier:")]
        assert len(tiers) >= 2
        for tier_span in tiers:
            tev = [name for _, name, _ in tier_span.events]
            assert "submit" in tev and "admit" in tev
            engine_kids = [c for c in tier_span.children
                           if c.name.startswith("engine:")]
            assert engine_kids and all(c.t1 >= c.t0 for c in engine_kids)
        assert srv.escalations >= 1
        assert srv.registry.counter(
            "serve_ladder_total",
            labels=("event",)).labels(event="escalation").value >= 1

    def test_trace_records_fault_and_retry(self, obs_setup):
        fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]

        class Flaky:
            def __init__(self, engine, fail):
                self._engine = engine
                self.fails_left = fail

            def __getattr__(self, name):
                return getattr(self._engine, name)

            def predict(self, *a, **kw):
                if self.fails_left > 0:
                    self.fails_left -= 1
                    raise RuntimeError("flaky")
                return self._engine.predict(*a, **kw)

        srv = ProximityServer(
            Flaky(fk.engine, fail=1), y=y, n_slots=32,
            retry=RetryPolicy(max_retries=2, backoff_s=0.0,
                              sleep=lambda s: None),
            tracer=Tracer(capacity=8))
        (res,) = srv.serve([("predict", Xq[:4])])
        assert res is not None
        (root,) = srv.tracer.spans()
        ev = [name for _, name, _ in root.events]
        assert "retry" in ev
        assert srv.faults == 1 and srv.retries == 1
        fault_counter = srv.registry.counter(
            "serve_engine_faults_total", labels=("tier", "event"))
        assert fault_counter.labels(tier="server", event="retry").value == 1


# ------------------------------------------------------- training/snapshot
class TestGlobalHooks:
    def test_training_and_snapshot_metrics(self, tmp_path, fresh_global):
        reg = fresh_global
        X, y = gaussian_classes(200, d=6, n_classes=2, seed=1)
        fk = ForestKernel(kernel_method="gap", n_trees=4, seed=0,
                          device="cpu").fit(X, y)
        levels = reg.counter("train_levels_total", labels=("backend",))
        snap = reg.snapshot()
        assert "train_level_seconds" in snap
        assert sum(c.value for c in levels._children.values()) > 0

        path = tmp_path / "fk.npz"
        from repro_torch.core.snapshot import load_kernel, save_kernel
        save_kernel(fk, path)
        load_kernel(path, device="cpu")
        h = reg.histogram("snapshot_seconds", labels=("op",))
        assert h.labels(op="save").count == 1
        assert h.labels(op="load").count == 1

    def test_trainer_level_metrics_on_the_torch_branch(self, fresh_global):
        """The device trainer's level loop (``tree_backend="torch"``, through
        the kernels' plain versions here) times every level under
        ``backend="torch"`` and sets the frontier gauges."""
        reg = fresh_global
        X, y = gaussian_classes(300, d=6, n_classes=3, seed=2)
        fk = ForestKernel(kernel_method="gap", n_trees=5, seed=0,
                          device="cpu", tree_backend="torch")
        fk.fit_forest(X, y)
        levels = reg.counter("train_levels_total", labels=("backend",))
        n_levels = levels.labels(backend="torch").value
        assert n_levels == max(t.depth for t in fk.forest.trees_)
        hist = reg.histogram("train_level_seconds", labels=("backend",))
        assert hist.labels(backend="torch").count == n_levels
        assert ("numpy",) not in dict(levels.items())
        series = parse_exposition(reg.exposition())
        # the last level's frontier: its nodes, and the rows still in it
        # (early-leaf pruning may have dropped every one)
        assert series[("train_frontier_nodes", ())] >= 1
        assert series[("train_frontier_rows", ())] >= 0
        assert series[("train_levels_total",
                       (("backend", "torch"),))] == n_levels

    def test_engine_memory_gauges(self, obs_setup, fresh_global):
        """``memory_bytes`` pushes the reference's four components to the
        process-wide ``engine_memory_bytes`` gauge family."""
        mem = obs_setup["fk"].engine.memory_bytes()
        g = fresh_global.gauge("engine_memory_bytes",
                               labels=("component",))
        for comp in ("dense_factors", "Q", "W", "total"):
            assert g.labels(component=comp).value == float(mem[comp])


# ------------------------------------------------------- /metrics endpoint
class TestMetricsHTTP:
    def test_scrape_roundtrip_and_404(self):
        import urllib.error
        import urllib.request

        from repro_torch.obs.http import (EXPOSITION_CONTENT_TYPE,
                                          MetricsHTTPServer)

        reg = MetricsRegistry()
        reg.counter("scrapes_total", "n", labels=("who",)).labels(
            who="test").inc(3)
        srv = MetricsHTTPServer(reg).start()
        try:
            assert srv.port is not None and srv.url.endswith("/metrics")
            with urllib.request.urlopen(srv.url, timeout=5) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == EXPOSITION_CONTENT_TYPE
                body = resp.read().decode("utf-8")
            parsed = parse_exposition(body)
            assert parsed[("scrapes_total", (("who", "test"),))] == 3.0
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/other", timeout=5)
            assert exc.value.code == 404
        finally:
            srv.stop()
        assert srv.port is None and srv.url is None
        srv.stop()                                  # idempotent

    def test_server_helper_exposes_registry(self, obs_setup):
        import urllib.request

        fk = obs_setup["fk"]
        srv = ProximityServer(fk.engine, y=obs_setup["y"], n_slots=8)
        try:
            http = srv.start_metrics_http()
            assert srv.start_metrics_http() is http     # idempotent
            srv.serve([("predict", obs_setup["Xq"][:8])])
            with urllib.request.urlopen(http.url, timeout=5) as resp:
                body = resp.read().decode("utf-8")
            assert "serve_requests_total" in body
        finally:
            srv.stop_metrics_http()
        assert srv._metrics_http is None


def test_instrumented_engine_results_are_the_engines(obs_setup):
    """The timing proxy returns exactly what the engine returns."""
    fk, y, Xq = obs_setup["fk"], obs_setup["y"], obs_setup["Xq"]
    eng = instrument(fk.engine, MetricsRegistry(), tier="x")
    assert torch.equal(eng.predict(y, n_classes=3, X=Xq),
                       fk.engine.predict(y, n_classes=3, X=Xq))
    i1, v1 = eng.topk(k=4, X=Xq)
    i2, v2 = fk.engine.topk(k=4, X=Xq)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
