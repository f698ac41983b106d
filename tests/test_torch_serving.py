"""The port's proximity servers against the reference's.

Counterparts of ``tests/test_serving_prox.py`` (slot admission and
retirement, determinism under reordering and slot widths, one routed batch
a tick, compressed serving, the buffer-aliasing race, priorities and
deadlines, the tiered ladder, the async loop) and of
``tests/test_reliability.py`` (fault injection, retry and backoff, circuit
breakers, the supervised server, re-routing, spill, budgets, the adaptive
margin, worker respawn, chaos), on the port's engines on the CPU
(``device="cpu"``).  Request results are host numpy arrays, as the
reference server's are, and share no memory with the slot buffer.

Also the port's server against the reference's server on one forest (a
reference kernel carried across by the snapshot) and the same requests:
``predict`` labels equal, ``topk`` values within 1e-8 and ids equal on rows
whose top values have no ties (the port orders tied proximities by column,
the reference as ``argpartition`` leaves them), and the tiered ladder's
escalation decisions equal in sync mode on a fake clock.
"""
import threading

import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.serve.proximity import ProximityServer as RefServer
from repro_torch.applications.embed import ProximityEmbedding
from repro_torch.applications.prototypes import (CompressedProximityEngine,
                                                 compress)
from repro_torch.core.api import ForestKernel
from repro_torch.data.synthetic import gaussian_classes
from repro_torch.serve.proximity import (KINDS, ProximityServer, Tier,
                                         TieredProximityServer)
from repro_torch.serve.reliability import (CircuitBreaker, CorruptedResult,
                                           FaultInjector, InjectedFault,
                                           RetryPolicy, validate_finite)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


@pytest.fixture(scope="module")
def serving_setup():
    X, y = gaussian_classes(500, d=8, n_classes=3, sep=3.0, seed=5)
    fk = ForestKernel(kernel_method="gap", n_trees=15, seed=0,
                      device="cpu").fit(X, y)
    rng = np.random.default_rng(0)
    labeled = rng.random(len(y)) < 0.2
    prop = fk.propagate_labels(labeled, online=True)
    emb = ProximityEmbedding(n_components=2).fit(fk.engine)
    Xq = np.ascontiguousarray(X[:60] + 1e-3)
    return {"fk": fk, "X": X, "y": y, "Xq": Xq,
            "propagator": prop, "embedding": emb}


@pytest.fixture(scope="module")
def rel_setup():
    X, y = gaussian_classes(400, d=8, n_classes=3, sep=3.0, seed=7)
    fk = ForestKernel(kernel_method="gap", n_trees=12, seed=0,
                      device="cpu").fit(X, y)
    Xq = np.ascontiguousarray(X[:64] + 1e-3)
    return {"fk": fk, "X": X, "y": y, "Xq": Xq}


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """One forest in both packages: a reference kernel (numpy router and
    trainer, scipy engine) and the port kernel loaded from its archive."""
    X, y = gaussian_classes(500, d=8, n_classes=3, sep=3.0, seed=5)
    ref = RefKernel(kernel_method="gap", n_trees=15, seed=0,
                    routing_backend="numpy", tree_backend="numpy",
                    engine_backend="scipy").fit(X, y)
    path = tmp_path_factory.mktemp("cross") / "gap.npz"
    ref.save(path)
    port = ForestKernel.load(path, device="cpu")
    Xq = np.ascontiguousarray(X[:60] + 1e-3)
    return {"ref": ref, "port": port, "X": X, "y": y, "Xq": Xq}


def _server(setup, n_slots=16, engine=None):
    fk = setup["fk"]
    return fk.serve(n_slots=n_slots, engine=engine,
                    propagator=setup["propagator"],
                    embedding=setup["embedding"])


def _mixed_requests(Xq):
    return [("predict", Xq[:5]), ("topk", Xq[5:13], 4),
            ("outlier", Xq[13:20]), ("propagate", Xq[20:30]),
            ("embed", Xq[30:40]), ("predict", Xq[40:43])]


def _fake_clock():
    t = [0.0]

    def clock():
        return t[0]

    clock.t = t
    return clock


def _noop_retry(n=2):
    return RetryPolicy(max_retries=n, backoff_s=0.0, sleep=lambda s: None)


class FlakyEngine:
    """Engine proxy whose ``predict`` fails the first ``fail`` calls."""

    def __init__(self, engine, fail):
        self._engine = engine
        self.fails_left = fail
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def predict(self, *a, **kw):
        self.calls += 1
        if self.fails_left > 0:
            self.fails_left -= 1
            raise RuntimeError("flaky")
        return self._engine.predict(*a, **kw)


# ------------------------------------------------- admission/retirement ---
def test_slot_admission_and_retirement_invariants(serving_setup):
    srv = _server(serving_setup, n_slots=8)
    Xq = serving_setup["Xq"]
    uids = [srv.submit("predict", Xq[i * 5:(i + 1) * 5]) for i in range(5)]
    assert len(srv.queue) == 5 and not srv.active
    seen_rows = 0
    while srv.queue or srv.active:
        srv.step()
        owned = sorted(int(s) for r in srv.active.values() for s in r.slots)
        assert sorted(srv._slot_free + owned) == list(range(8))
        assert len(set(owned)) == len(owned), "slot double-booked"
        seen_rows = srv.rows_served
    assert seen_rows == 25
    assert len(srv.finished) == 5 and not srv.queue and not srv.active
    assert len(srv._slot_free) == 8
    assert [r.uid for r in srv.finished] == uids
    for r in srv.finished:
        assert r.done_at >= r.admitted_at >= r.submitted_at >= 0
        assert r.result is not None
    st = srv.stats()
    assert st["requests"] == 5 and st["rows"] == 25
    assert st["kinds"]["predict"]["requests"] == 5
    assert st["kinds"]["predict"]["p95_ms"] >= st["kinds"]["predict"]["p50_ms"]


def test_oversized_and_unknown_requests_rejected(serving_setup):
    srv = _server(serving_setup, n_slots=4)
    Xq = serving_setup["Xq"]
    with pytest.raises(ValueError, match="exceed"):
        srv.submit("predict", Xq[:5])
    with pytest.raises(ValueError, match="unknown request kind"):
        srv.submit("nonsense", Xq[:2])
    srv_plain = ProximityServer(serving_setup["fk"].engine,
                                y=serving_setup["y"], n_slots=4)
    with pytest.raises(ValueError, match="propagate"):
        srv_plain.submit("propagate", Xq[:2])
    with pytest.raises(ValueError, match="embed"):
        srv_plain.submit("embed", Xq[:2])
    no_labels = ProximityServer(serving_setup["fk"].engine, n_slots=4)
    with pytest.raises(ValueError, match="labels"):
        no_labels.submit("predict", Xq[:2])


def test_results_match_direct_engine_calls(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    srv = _server(serving_setup, n_slots=16)
    res = srv.serve(_mixed_requests(Xq))
    for r in res:
        for v in r.values():
            assert isinstance(v, np.ndarray)
    ref = fk.engine.predict(y, n_classes=3,
                            X=np.ascontiguousarray(Xq[:5])).argmax(1)
    np.testing.assert_array_equal(res[0]["labels"], _np(ref))
    idx, val = fk.engine.topk(k=4, X=np.ascontiguousarray(Xq[5:13]))
    np.testing.assert_allclose(res[1]["values"], _np(val), atol=1e-12)
    np.testing.assert_array_equal(res[1]["indices"], _np(idx))
    from repro_torch.applications.outliers import oos_outlier_scores
    np.testing.assert_allclose(res[2]["scores"], _np(oos_outlier_scores(
        fk.engine, y, np.ascontiguousarray(Xq[13:20]))), atol=1e-10)
    _, sc = serving_setup["propagator"].partial_fit(
        np.ascontiguousarray(Xq[20:30]))
    np.testing.assert_allclose(res[3]["scores"], _np(sc), atol=1e-10)
    Z = serving_setup["embedding"].transform(
        np.ascontiguousarray(Xq[30:40]))
    np.testing.assert_allclose(res[4]["embedding"], _np(Z), atol=1e-8)


# ------------------------------------------------------- determinism ------
def test_determinism_under_request_reordering(serving_setup):
    Xq = serving_setup["Xq"]
    reqs = _mixed_requests(Xq)
    perm = [3, 0, 5, 1, 4, 2]
    res_a = _server(serving_setup, n_slots=16).serve(reqs)
    res_b = _server(serving_setup, n_slots=16).serve([reqs[i] for i in perm])
    for out_pos, in_pos in enumerate(perm):
        a, b = res_a[in_pos], res_b[out_pos]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-10,
                                       err_msg=f"req {in_pos} field {key}")


def test_determinism_across_slot_widths(serving_setup):
    Xq = serving_setup["Xq"]
    reqs = [("predict", Xq[:5]), ("outlier", Xq[5:10]), ("topk", Xq[10:15], 3)]
    wide = _server(serving_setup, n_slots=32).serve(reqs)
    narrow = _server(serving_setup, n_slots=5).serve(reqs)
    for a, b in zip(wide, narrow):
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-10)


# ------------------------------------------- one routed batch per tick ----
def test_single_routing_pass_per_tick(serving_setup):
    """A tick with all five kinds present routes the slot batch through the
    forest exactly once; the per-kind engine calls reuse the cached state."""
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"] + 3.3e-5
    srv = _server(serving_setup, n_slots=64)
    calls = []
    orig_apply = fk.forest.apply

    def counting_apply(X):
        calls.append(tuple(X.shape))
        return orig_apply(X)

    fk.forest.apply = counting_apply
    try:
        srv.serve(_mixed_requests(Xq))   # fits in one tick (43 rows)
    finally:
        del fk.forest.apply
    assert srv.ticks == 1
    assert len(calls) == 1, f"expected one routing pass, saw {calls}"


# ------------------------------------------------- compressed serving -----
def test_compressed_vs_full_agreement(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    ce = compress(fk.engine, y, n_prototypes=8, k=60)
    assert ce.memory_bytes()["total"] < fk.engine.memory_bytes()["total"] / 4
    full = _server(serving_setup, n_slots=32)
    comp = fk.serve(n_slots=32, engine=ce)
    rf = full.serve([("predict", Xq[:30])])[0]
    rc = comp.serve([("predict", Xq[:30])])[0]
    agree = (rf["labels"] == rc["labels"]).mean()
    assert agree >= 0.9, f"compressed predict agreement {agree}"
    rt = comp.serve([("topk", Xq[:10], 3)])[0]
    real = rt["indices"] >= 0
    assert real.any()
    assert np.isin(rt["indices"][real], ce.prototype_indices_).all()
    wide = comp.serve([("topk", Xq[:10],
                        len(ce.prototype_indices_) + 5)])[0]
    pad = wide["values"] == 0
    assert pad.any(), "expected padded top-k slots beyond the prototype set"
    assert (wide["indices"][pad] == -1).all()
    assert (wide["indices"][~pad] >= 0).all()


# --------------------------------------------- buffer-aliasing regression -
def test_engine_never_aliases_slot_buffer(serving_setup):
    """Every engine call receives a batch that does NOT share memory with
    the slot buffer (on the CPU ``torch.as_tensor`` of a numpy batch is
    zero-copy), and no request result shares memory with it either."""
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]
    srv = _server(serving_setup, n_slots=8)
    seen = []
    orig_qs = fk.engine.query_state

    def recording_qs(X=None):
        if X is not None:
            seen.append(X)
        return orig_qs(X)

    fk.engine.query_state = recording_qs
    try:
        srv.serve([("predict", Xq[:6]), ("topk", Xq[6:12], 3)])
    finally:
        del fk.engine.query_state
    assert seen, "no engine batches observed"
    for X in seen:
        assert not np.shares_memory(X, srv._slot_X), \
            "engine batch aliases the mutable slot buffer"
    for r in srv.finished:
        for v in r.result.values():
            assert not np.shares_memory(v, srv._slot_X)


def test_results_survive_slot_buffer_mutation(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    srv = _server(serving_setup, n_slots=8)
    srv.submit("predict", Xq[:8])
    srv.step()
    res = srv.finished[0].result
    labels_before = res["labels"].copy()
    scores_before = res["scores"].copy()
    srv._slot_X[:] = 1e9                     # clobber, as admission would
    np.testing.assert_array_equal(res["labels"], labels_before)
    np.testing.assert_array_equal(res["scores"], scores_before)
    ref = fk.engine.predict(y, n_classes=3,
                            X=np.ascontiguousarray(Xq[:8])).argmax(1)
    np.testing.assert_array_equal(res["labels"], _np(ref))


# ------------------------------------------------- priorities/deadlines ---
def test_priority_order_and_fifo_within_level(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    srv = ProximityServer(fk.engine, y=y, n_slots=4)
    low1 = srv.submit("predict", Xq[:3], priority=0)
    low2 = srv.submit("predict", Xq[3:6], priority=0)
    high = srv.submit("predict", Xq[6:9], priority=5)
    srv.run_until_drained()
    order = [r.uid for r in srv.finished]
    assert order == [high, low1, low2], order


def test_deadline_shed_is_deterministic(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    clock = _fake_clock()
    srv = ProximityServer(fk.engine, y=y, n_slots=4, clock=clock)
    live = srv.submit("predict", Xq[:4], deadline_s=100.0)
    doomed = srv.submit("predict", Xq[4:8], deadline_s=10.0)
    clock.t[0] = 50.0
    srv.run_until_drained()
    assert [r.uid for r in srv.finished] == [live]
    assert [r.uid for r in srv.shed_requests] == [doomed]
    shed = srv.shed_requests[0]
    assert shed.shed and shed.result is None and shed.done_at == 50.0
    st = srv.stats()
    assert st["shed"] == 1 and st["requests"] == 1
    srv2 = ProximityServer(fk.engine, y=y, n_slots=4, clock=clock)
    u = srv2.submit("predict", Xq[:4], deadline_s=-1.0)
    srv2.run_until_drained()
    assert srv2.shed_requests[0].uid == u


def test_tiered_escalation_reproducible_under_reordering(serving_setup):
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]
    reqs = [("predict", Xq[:7]), ("predict", Xq[7:20]),
            ("topk", Xq[20:28], 4), ("predict", Xq[28:41])]
    perm = [2, 3, 0, 1]

    def fresh():
        return fk.serve_tiered(prefix_depth=3, n_prototypes=6, proto_k=60,
                               n_slots=32, escalate_margin=0.5)

    a_srv, b_srv = fresh(), fresh()
    res_a = a_srv.serve(reqs)
    res_b = b_srv.serve([reqs[i] for i in perm])
    for out_pos, in_pos in enumerate(perm):
        a, b = res_a[in_pos], res_b[out_pos]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-10,
                                       err_msg=f"req {in_pos} field {key}")
    path_a = {r.uid: r.tier_path for r in a_srv.finished}
    path_b = {r.uid: r.tier_path for r in b_srv.finished}
    uids_a = sorted(path_a)
    for out_pos, in_pos in enumerate(perm):
        assert path_a[uids_a[in_pos]] == \
            path_b[sorted(path_b)[out_pos]], (in_pos, out_pos)
    assert a_srv.stats()["escalations"] == b_srv.stats()["escalations"]


def test_tiered_deadline_answers_from_best_available(serving_setup):
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]
    clock = _fake_clock()
    srv = fk.serve_tiered(prefix_depth=2, n_prototypes=6, proto_k=60,
                          n_slots=32, escalate_margin=2.0, clock=clock)
    shallow_srv = srv._servers[0]
    orig_step = shallow_srv.step

    def stepping():
        n = orig_step()
        if n:
            clock.t[0] = 1000.0
        return n

    shallow_srv.step = stepping
    uid = srv.submit("predict", Xq[:6], deadline_s=500.0)
    srv.run_until_drained()
    treq = srv._requests[uid]
    assert treq.timed_out and not treq.shed
    assert treq.final_tier == srv.tiers[0].name
    assert treq.result is not None
    st = srv.stats()
    assert st["timeouts"] == 1 and st["shed"] == 0


def test_tiered_shed_before_any_answer(serving_setup):
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]
    clock = _fake_clock()
    srv = fk.serve_tiered(prefix_depth=2, n_prototypes=6, proto_k=60,
                          n_slots=32, clock=clock)
    uid = srv.submit("predict", Xq[:6], deadline_s=10.0)
    clock.t[0] = 20.0
    srv.run_until_drained()
    treq = srv._requests[uid]
    assert treq.shed and treq.result is None
    assert srv.stats()["shed"] == 1


def test_tiered_kind_routing_and_agreement(serving_setup):
    fk, y = serving_setup["fk"], serving_setup["y"]
    Xq = serving_setup["Xq"]
    srv = fk.serve_tiered(prefix_depth=3, n_prototypes=8, proto_k=60,
                          n_slots=32, escalate_margin=2.0,
                          propagator=serving_setup["propagator"],
                          embedding=serving_setup["embedding"])
    res = srv.serve([("predict", Xq[:20]), ("embed", Xq[20:30])])
    ref = fk.engine.predict(y, n_classes=3,
                            X=np.ascontiguousarray(Xq[:20])).argmax(1)
    np.testing.assert_array_equal(res[0]["labels"], _np(ref))
    pred_req = srv.finished[0] if srv.finished[0].kind == "predict" \
        else srv.finished[1]
    assert pred_req.final_tier == "full"
    assert pred_req.tier_path == ["shallow", "full"]
    embed_req = [r for r in srv.finished if r.kind == "embed"][0]
    assert embed_req.tier_path == ["full"]
    st = srv.stats()
    assert st["tiers"]["full"]["routed_requests"] == 2
    assert 0 < st["escalation_rate"] <= 2.0


def test_tiered_observability_counters(serving_setup):
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]
    srv = fk.serve_tiered(prefix_depth=3, n_prototypes=8, proto_k=60,
                          n_slots=32, escalate_margin=0.4)
    srv.serve([("predict", Xq[:10]), ("predict", Xq[10:20])])
    srv.serve([("predict", Xq[:10]), ("predict", Xq[10:20])])
    st = srv.stats()
    assert set(st["tiers"]) == {"shallow", "compressed", "full"}
    for tname, tstats in st["tiers"].items():
        assert {"qs_cache", "shed", "requests"} <= set(tstats)
    shallow = st["tiers"]["shallow"]["qs_cache"]
    assert shallow["hits"] >= 1 and 0 < shallow["hit_rate"] <= 1


# ------------------------------------------- threaded serving regression --
def test_async_tiered_matches_sync_and_never_aliases_slots(serving_setup):
    fk = serving_setup["fk"]
    Xq = serving_setup["Xq"]

    def fresh():
        return fk.serve_tiered(prefix_depth=3, n_prototypes=8, proto_k=60,
                               n_slots=16, escalate_margin=0.5)

    reqs = [("predict", Xq[i * 6:(i + 1) * 6]) for i in range(8)] + \
        [("topk", Xq[48:56], 4)]
    sync_res = fresh().serve(reqs)

    srv = fresh()
    seen = []
    engines = [t.engine for t in srv.tiers]
    originals = [e.query_state for e in engines]

    def record(orig):
        def recording(X=None):
            if X is not None:
                seen.append(X)
            return orig(X)
        return recording

    for e, orig in zip(engines, originals):
        e.query_state = record(orig)
    try:
        srv.start()
        uids = [srv.submit(*r) for r in reqs]
        out = srv.wait(uids, timeout=60.0)
    finally:
        srv.stop()
        for e in engines:
            del e.query_state
    assert not any(t.is_alive() for t in srv._worker_threads.values())
    assert seen, "no engine batches observed"
    for X in seen:
        for inner in srv._servers:
            if inner._slot_X is not None:
                assert not np.shares_memory(X, inner._slot_X), \
                    "engine batch aliases a tier's mutable slot buffer"
    for a, b in zip(sync_res, out):
        assert b is not None
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-10)


def test_every_kind_is_served(serving_setup):
    """All five kinds through one server; each result has the reference
    server's keys and host dtypes."""
    srv = _server(serving_setup, n_slots=64)
    res = srv.serve(_mixed_requests(serving_setup["Xq"]))
    keys = {"predict": {"scores", "labels"}, "topk": {"indices", "values"},
            "outlier": {"scores"}, "propagate": {"scores", "labels"},
            "embed": {"embedding"}}
    for (kind, *_), r in zip(_mixed_requests(serving_setup["Xq"]), res):
        assert kind in KINDS and set(r) == keys[kind]
    assert res[1]["indices"].dtype == np.int64
    assert res[1]["values"].dtype == np.float64


# ---------------------------------------------------------------------------
# reliability primitives
# ---------------------------------------------------------------------------

def test_fault_injector_deterministic_and_scoped():
    def drive(inj):
        fired = []
        for _ in range(300):
            try:
                inj.before_call("predict")
                fired.append(False)
            except InjectedFault:
                fired.append(True)
        return fired

    a = drive(FaultInjector(error_rate=0.3, seed=42))
    b = drive(FaultInjector(error_rate=0.3, seed=42))
    assert a == b
    assert 0 < sum(a) < 300
    inj = FaultInjector(error_rate=1.0, ops=("topk",), seed=0)
    inj.before_call("predict")
    with pytest.raises(InjectedFault):
        inj.before_call("topk")
    assert inj.stats()["injected"]["error"] == 1


def test_fault_injector_schedule_equals_reference():
    """The port's injector draws the reference's fault schedule from the
    same seed."""
    from repro.serve.reliability import FaultInjector as RefInjector

    def drive(inj, exc):
        out = []
        for i in range(200):
            try:
                inj.before_call(("predict", "topk")[i % 2])
                out.append(0)
            except exc:
                out.append(1)
            arrays = inj.corrupt("predict", (np.ones(5),))
            out.append(int(np.isnan(arrays[0]).any()))
        return out

    from repro.serve.reliability import InjectedFault as RefFault
    kw = dict(error_rate=0.2, latency_rate=0.1, corrupt_rate=0.05, seed=3,
              sleep=lambda s: None)
    assert drive(FaultInjector(**kw), InjectedFault) == \
        drive(RefInjector(**kw), RefFault)


def test_fault_injector_corrupt_and_validate_finite():
    inj = FaultInjector(corrupt_rate=1.0, seed=0)
    a = np.ones((4, 3))
    out = inj.corrupt("predict", (a,))
    assert np.isfinite(a).all()
    assert np.isnan(out[0]).any()
    with pytest.raises(CorruptedResult):
        validate_finite("predict", out)
    validate_finite("topk", (np.arange(6), np.ones(6)))


def test_retry_policy_backoff_schedule():
    slept = []
    rp = RetryPolicy(max_retries=5, backoff_s=0.01, max_backoff_s=0.04,
                     sleep=slept.append)
    for k in range(1, 5):
        rp.backoff(k)
    np.testing.assert_allclose(slept, [0.01, 0.02, 0.04, 0.04])


def test_circuit_breaker_state_machine():
    clock = _fake_clock()
    br = CircuitBreaker(fail_threshold=3, cooldown_s=5.0, clock=clock)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.allow()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock.t[0] += 4.9
    assert not br.allow()
    clock.t[0] += 0.2
    assert br.allow()
    assert br.state == "half_open"
    br.record_failure()
    assert br.state == "open" and br.snapshot()["trips"] == 2
    clock.t[0] += 6.0
    assert br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()


# ---------------------------------------------------------------------------
# supervised flat server
# ---------------------------------------------------------------------------

def test_supervised_retry_recovers(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    flaky = FlakyEngine(fk.engine, fail=2)
    srv = ProximityServer(flaky, y=y, n_slots=16, retry=_noop_retry(2))
    res = srv.serve([("predict", Xq[:8])])
    want = fk.engine.predict(y, n_classes=3, X=Xq[:8]).argmax(1)
    np.testing.assert_array_equal(res[0]["labels"], _np(want))
    assert flaky.calls == 3
    st = srv.stats()["reliability"]
    assert st["faults"] == 2 and st["retries"] == 2
    assert st["recovered_calls"] == 1 and st["failed_calls"] == 0
    assert st["failed_requests"] == 0
    assert srv.finished[0].attempts == 2 and not srv.finished[0].failed


def test_supervised_terminal_failure_recorded(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    flaky = FlakyEngine(fk.engine, fail=10**9)
    srv = ProximityServer(flaky, y=y, n_slots=16, retry=_noop_retry(1))
    u_pred = srv.submit("predict", Xq[:4])
    u_topk = srv.submit("topk", Xq[4:8], k=5)
    srv.run_until_drained()
    assert [r.uid for r in srv.failed_requests] == [u_pred]
    fr = srv.failed_requests[0]
    assert fr.failed and "flaky" in fr.fail_reason
    assert [r.uid for r in srv.finished] == [u_topk]
    assert srv.finished[0].result["indices"].shape == (4, 5)
    st = srv.stats()["reliability"]
    assert st["faults"] == st["retries"] + st["failed_calls"]
    assert st["failed_calls"] == 1 and st["retries"] == 1
    assert len(srv._slot_free) == srv.n_slots


def test_corrupted_result_is_retried(rel_setup):
    """A corrupted host result takes the retry path; the request is then
    answered with finite values."""
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    inj = FaultInjector(corrupt_rate=1.0, ops=("predict",), seed=0)
    srv = ProximityServer(fk.engine, y=y, n_slots=16, fault_injector=inj,
                          retry=_noop_retry(2))
    srv.serve([("predict", Xq[:4])])
    assert srv.faults == 3 and srv.failed_calls == 1
    assert "CorruptedResult" in srv.failed_requests[0].fail_reason
    inj.corrupt_rate = 0.0
    (res,) = srv.serve([("predict", Xq[:4])])
    assert np.isfinite(res["scores"]).all()


def test_breaker_trips_and_fails_fast(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    clock = _fake_clock()
    flaky = FlakyEngine(fk.engine, fail=10**9)
    br = CircuitBreaker(fail_threshold=2, cooldown_s=5.0, clock=clock)
    srv = ProximityServer(flaky, y=y, n_slots=16, clock=clock,
                          retry=_noop_retry(0), breaker=br)
    srv.serve([("predict", Xq[:2])])
    srv.serve([("predict", Xq[:2])])
    assert br.state == "open"
    calls_before = flaky.calls
    srv.serve([("predict", Xq[:2])])
    assert flaky.calls == calls_before
    assert srv.failed_requests[-1].fail_reason == "breaker_open"
    flaky.fails_left = 0
    clock.t[0] += 10.0
    res = srv.serve([("predict", Xq[:2])])
    assert res[0] is not None and br.state == "closed"
    assert srv.stats()["reliability"]["breaker"]["trips"] == 1


# ---------------------------------------------------------------------------
# tiered ladder: re-route, spill, budgets, adaptive margin
# ---------------------------------------------------------------------------

def test_tiered_reroute_down_ladder_no_request_lost(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    ce = fk.compress(n_prototypes=6, k=60)
    broken = FlakyEngine(ce, fail=10**9)
    tiers = [Tier("compressed", broken, y=ce.prototype_labels_,
                  kinds=("predict",), n_slots=16),
             Tier("full", fk.engine, y=y, kinds=("predict",), n_slots=16)]
    srv = TieredProximityServer(tiers, escalate_margin=0.0,
                                retry=_noop_retry(1))
    uids = [srv.submit("predict", Xq[i * 4:(i + 1) * 4]) for i in range(4)]
    srv.run_until_drained()
    assert len(srv.finished) == 4
    for u in uids:
        r = srv._requests[u]
        assert r.result is not None and not r.failed
        assert r.final_tier == "full" and r.reroutes == 1
        assert r.fail_reason is not None
    st = srv.stats()["reliability"]
    assert st["reroutes"] == 4 and st["failures"] == 0
    assert st["recoveries"] == 4


def test_tiered_terminal_failure_at_deepest_tier(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    broken = FlakyEngine(fk.engine, fail=10**9)
    srv = TieredProximityServer(
        [Tier("only", broken, y=y, kinds=("predict",), n_slots=16)],
        escalate_margin=0.0, retry=_noop_retry(0))
    u = srv.submit("predict", Xq[:4])
    srv.run_until_drained()
    r = srv._requests[u]
    assert r.failed and r.result is None and "flaky" in r.fail_reason
    assert srv.stats()["reliability"]["failures"] == 1


def test_tiered_overload_spill(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    ce = fk.compress(n_prototypes=6, k=60)
    tiers = [Tier("compressed", ce, y=ce.prototype_labels_,
                  kinds=("predict",), n_slots=4, spill_watermark=2),
             Tier("full", fk.engine, y=y, kinds=("predict",), n_slots=64)]
    srv = TieredProximityServer(tiers, escalate_margin=0.0)
    uids = [srv.submit("predict", Xq[i * 4:(i + 1) * 4]) for i in range(8)]
    srv.run_until_drained()
    assert len(srv.finished) == 8
    paths = [srv._requests[u].tier_path for u in uids]
    assert paths.count(["compressed"]) == 2
    assert paths.count(["full"]) == 6
    assert srv.stats()["reliability"]["spills"] == 6
    assert all(srv._requests[u].result is not None for u in uids)


def test_deadline_budget_routes_straight_to_deep_tier(rel_setup):
    fk, y, Xq = rel_setup["fk"], rel_setup["y"], rel_setup["Xq"]
    clock = _fake_clock()
    pe = fk.prefix_engine(3)
    tiers = [Tier("shallow", pe, y=y, kinds=("predict",), n_slots=16,
                  budget_s=5.0),
             Tier("full", fk.engine, y=y, kinds=("predict",), n_slots=16,
                  budget_s=5.0)]
    srv = TieredProximityServer(tiers, escalate_margin=0.5, clock=clock)
    u_slow = srv.submit("predict", Xq[:4], deadline_s=100.0)
    u_tight = srv.submit("predict", Xq[4:8], deadline_s=6.0)
    srv.run_until_drained()
    assert srv._requests[u_slow].tier_path[0] == "shallow"
    assert srv._requests[u_tight].tier_path == ["full"]
    assert srv.budget_skips == 1
    assert srv._requests[u_tight].result is not None
    assert srv.stats()["tiers"]["shallow"]["budget_s"] == 5.0


def test_adaptive_margin_live_threshold(rel_setup):
    fk = rel_setup["fk"]
    srv = fk.serve_tiered(prefix_depth=3, n_prototypes=6, proto_k=60,
                          adaptive_margin=True, margin_window=64,
                          margin_target=1.0, escalate_margin=0.05)
    srv._margin_obs.extend([(0.9, True)] * 3)
    assert srv._live_margin() == pytest.approx(0.05)
    srv._margin_obs.clear()
    srv._margin_obs.extend([(0.8, True)] * 40 + [(0.1, False)] * 20)
    assert srv._live_margin() == pytest.approx(0.8)
    assert srv.stats()["live_margin"] == pytest.approx(0.8)
    srv.margin_target = 0.95
    assert srv._live_margin() == pytest.approx(0.1)


def test_adaptive_margin_feeds_from_escalations(rel_setup):
    fk, Xq = rel_setup["fk"], rel_setup["Xq"]
    srv = fk.serve_tiered(prefix_depth=2, n_prototypes=6, proto_k=60,
                          escalate_margin=0.9, adaptive_margin=True,
                          margin_window=512)
    srv.serve([("predict", Xq[i * 8:(i + 1) * 8]) for i in range(4)])
    assert srv.escalations > 0
    assert len(srv._margin_obs) > 0
    assert all(isinstance(m, float) for m, _ in srv._margin_obs)
    assert np.isfinite(srv.stats()["live_margin"])


def test_worker_respawn_counts_dead_threads(rel_setup):
    fk = rel_setup["fk"]
    srv = fk.serve_tiered(prefix_depth=3, n_prototypes=6, proto_k=60)
    dead = threading.Thread(target=lambda: None)
    dead.start()
    dead.join()
    srv._worker_threads[0] = dead
    try:
        srv._respawn_dead_workers()
        assert srv.worker_restarts == 1
        assert srv._worker_threads[0].is_alive()
    finally:
        srv._stop.set()
        srv._worker_threads[0].join(timeout=5.0)
    assert not srv._worker_threads[0].is_alive()


def test_sync_chaos_no_silent_loss(rel_setup):
    fk, Xq = rel_setup["fk"], rel_setup["Xq"]
    inj = FaultInjector(error_rate=0.2, corrupt_rate=0.05, seed=3,
                        sleep=lambda s: None)
    srv = fk.serve_tiered(prefix_depth=3, n_prototypes=6, proto_k=60,
                          n_slots=8, escalate_margin=0.2,
                          fault_injector=inj, retry=_noop_retry(2))
    kinds = ["predict", "topk", "outlier"]
    uids = [srv.submit(kinds[i % 3], Xq[(i % 8) * 8:(i % 8) * 8 + 8])
            for i in range(36)]
    srv.run_until_drained()
    stats = srv.stats()
    assert stats["reliability"]["faults"] > 0
    lost = unaccounted = 0
    for u in uids:
        r = srv._requests[u]
        if not r.done.is_set():
            lost += 1
        if r.result is None and not (r.shed or r.failed or r.timed_out):
            unaccounted += 1
        if r.failed:
            assert r.fail_reason
    assert lost == 0 and unaccounted == 0
    for s in srv._servers:
        assert s.faults == s.retries + s.failed_calls


# ---------------------------------------------------------------------------
# the port's server against the reference's
# ---------------------------------------------------------------------------

def _cross_requests(Xq, k):
    return [("predict", Xq[:8]), ("topk", Xq[8:24], k),
            ("predict", Xq[24:40]), ("topk", Xq[40:56], k),
            ("outlier", Xq[:16])]


def test_server_matches_reference_server(cross):
    ref, port, y, Xq = cross["ref"], cross["port"], cross["y"], cross["Xq"]
    k = 6
    reqs = _cross_requests(Xq, k)
    got = port.serve(n_slots=32).serve(reqs)
    want = RefServer(ref.engine, y=y, n_slots=32).serve(reqs)
    n_exact = 0
    for (kind, X, *_), g, w in zip(reqs, got, want):
        if kind == "predict":
            np.testing.assert_array_equal(g["labels"], w["labels"])
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                       atol=1e-8)
        elif kind == "outlier":
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                       atol=1e-8)
        else:
            np.testing.assert_allclose(g["values"], w["values"], rtol=0,
                                       atol=1e-8)
            # ids exactly, on the rows whose top k + 1 values are distinct
            # (no tie at the k-th place nor above it)
            _, v1 = ref.engine.topk(k=k + 1, X=np.ascontiguousarray(X))
            distinct = (np.diff(v1, axis=1) < 0).all(axis=1)
            np.testing.assert_array_equal(g["indices"][distinct],
                                          w["indices"][distinct])
            n_exact += int(distinct.sum())
    assert n_exact >= 8, f"only {n_exact} top-k rows compared exactly"


def test_tiered_escalations_match_reference(cross):
    """Sync mode on a fake clock: the port's ladder escalates the same
    requests as the reference's, through the same tiers, to the same
    labels.  Both ladders hold the same prototype columns (the
    reference's)."""
    ref, port, y, Xq = cross["ref"], cross["port"], cross["y"], cross["Xq"]
    r_ce = ref.compress(n_prototypes=6, k=60)
    p_ce = CompressedProximityEngine(port.engine, r_ce.prototype_indices_,
                                     labels=r_ce.prototype_labels_)
    reqs = [("predict", Xq[i * 6:(i + 1) * 6]) for i in range(10)] + \
        [("topk", Xq[:8], 4), ("outlier", Xq[8:16])]
    out = {}
    for name, fk, ce in (("ref", ref, r_ce), ("port", port, p_ce)):
        clock = _fake_clock()
        srv = fk.serve_tiered(prefix_depth=3, compressed_engine=ce,
                              n_slots=32, escalate_margin=0.3, clock=clock)
        res = srv.serve(reqs)
        out[name] = (srv, res)
    (r_srv, r_res), (p_srv, p_res) = out["ref"], out["port"]
    assert p_srv.escalations == r_srv.escalations > 0
    assert p_srv.stats()["escalation_rate"] == \
        r_srv.stats()["escalation_rate"]
    assert [r.tier_path for r in p_srv._requests.values()] == \
        [r.tier_path for r in r_srv._requests.values()]
    for (kind, *_), g, w in zip(reqs, p_res, r_res):
        if kind == "predict":
            np.testing.assert_array_equal(g["labels"], w["labels"])
        elif kind == "topk":
            np.testing.assert_allclose(g["values"], w["values"], rtol=0,
                                       atol=1e-8)
        else:
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                       atol=1e-8)
