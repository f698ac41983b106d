"""The program's spans in a traced window (``pb/regions.py``) and the
tie rule's counter reader."""
from __future__ import annotations

import pytest

from conftest import tiny_run
from pb import common, regions, trace

NS = 1_000_000


def _trace():
    """A window of 100 ms: one ``topk`` call of the program, inside the
    benchmark's ``topk`` span, and an idle stretch after it.

    engine.topk 10–60 ms holds engine.k2 12–20, engine.select 20–30 and
    engine.spill_read 30–50; the benchmark's ``topk`` span 5–65 holds it
    all."""
    spans = [("window", 0, 100 * NS), ("topk", 5 * NS, 65 * NS)]
    ranges = [("engine.topk", 10 * NS, 60 * NS),
              ("engine.k2", 12 * NS, 20 * NS),
              ("engine.select", 20 * NS, 30 * NS),
              ("engine.spill_read", 30 * NS, 50 * NS)]
    device = [  # (name, start, end, launch)
        ("block_prox_kernel", 14 * NS, 22 * NS, 13 * NS),    # in k2
        ("topk_kernel", 22 * NS, 32 * NS, 21 * NS),          # in select
        ("sort_kernel", 32 * NS, 34 * NS, 29 * NS),          # in select
        ("zeros", 34 * NS, 35 * NS, 11 * NS),                # in topk only
        ("copy", 35 * NS, 36 * NS, 7 * NS),                  # in no range
        ("lost", 36 * NS, 37 * NS, -1),                      # no launch
        ("late", 150 * NS, 160 * NS, 55 * NS),               # past window
    ]
    return device, spans, ranges


def test_self_time_calls_and_host_seconds():
    t = regions.summarize(*_trace())
    sp = t["program"]["spans"]
    assert sp["engine.topk"]["calls"] == 1
    assert sp["engine.topk"]["host_s"] == pytest.approx(0.050)
    # 50 ms less its children's 8 + 10 + 20
    assert sp["engine.topk"]["self_s"] == pytest.approx(0.012)
    assert sp["engine.k2"]["self_s"] == pytest.approx(0.008)


def test_device_seconds_go_to_the_innermost_span_of_the_launch():
    t = regions.summarize(*_trace())
    sp = t["program"]["spans"]
    assert sp["engine.k2"]["device_s"] == pytest.approx(0.008)
    assert sp["engine.select"]["device_s"] == pytest.approx(0.012)
    assert sp["engine.topk"]["device_s"] == pytest.approx(0.001)
    assert sp["engine.spill_read"]["device_s"] == 0
    # the copy launched before the program's span, the op without a launch
    assert t["program"]["unspanned_device_s"] == pytest.approx(0.002)
    assert t["program"]["unmatched_ops"] == 1


def test_gaps_named_by_the_innermost_span_of_either_kind():
    device, spans, ranges = _trace()
    device += [("a", 40 * NS, 41 * NS, 31 * NS),
               ("b", 62 * NS, 63 * NS, 31 * NS)]
    t = regions.summarize(device, spans, ranges)
    gaps = {name: s for name, s in t["gaps"]}
    assert gaps["window"] == pytest.approx(0.037)             # 63–100 ms
    assert gaps["engine.topk"] == pytest.approx(0.021)        # 41–62 ms
    assert gaps["topk"] == pytest.approx(0.014)               # 0–14 ms
    assert gaps["engine.spill_read"] == pytest.approx(0.003)  # 37–40 ms


def test_without_program_ranges_the_summary_is_trace_summarize():
    device, spans, _ = _trace()
    plain = trace.summarize([d[:3] for d in device], spans)
    assert regions.summarize(device, spans, []) == plain
    assert regions.summarize(device, spans, [("engine.k2", 150 * NS,
                                               160 * NS)]) == plain
    assert regions.per_pass(plain, 3) is None


def test_busy_and_ops_are_trace_summarize_s():
    device, spans, ranges = _trace()
    t = regions.summarize(device, spans, ranges)
    plain = trace.summarize([d[:3] for d in device], spans)
    assert (t["busy_s"], t["ops"], t["window_s"]) == \
        (plain["busy_s"], plain["ops"], plain["window_s"])


def test_per_pass():
    t = regions.summarize(*_trace())
    p = regions.per_pass(t, 2)
    assert p["topk_select_ms"] == pytest.approx(6.0)
    assert p["k2_ms"] == pytest.approx(4.0)
    assert p["class_sums_ms"] == 0
    assert p["unspanned_ms"] == pytest.approx(1.0)
    assert p["engine_wait_ms"] == pytest.approx(10.0)
    assert p["engine_host_ms"] == pytest.approx(15.0)
    assert regions.per_pass(t, 0) is None
    assert regions.per_pass(None, 2) is None


@pytest.fixture
def fresh_registry():
    from repro_torch.obs.metrics import MetricsRegistry, set_global_registry
    old = set_global_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_global_registry(old)


def test_spill_reader_is_none_without_counters_or_passes(fresh_registry):
    read = common.load_module("metrics", "topk_spill_pct.allpairs").read
    assert read({"passes": 3}) is None
    assert read({}) is None


def test_spill_reader_reads_a_run(fresh_registry):
    from repro_torch.obs.metrics import global_registry
    _, _, res, _ = tiny_run("rf_gap_covtype.allpairs", seconds=0.2)
    read = common.load_module("metrics", "topk_spill_pct.allpairs").read
    snap = global_registry().snapshot()
    rows = snap["engine_topk_rows_total"]["series"][""]
    spill = snap["engine_topk_spill_rows_total"]["series"][""]
    # the warm-up pass and the window's, every row of each
    assert rows == res["record"]["rows"] * (res["record"]["passes"] + 1)
    assert read(res["record"]) == 100.0 * spill / rows
    assert 0 <= read(res["record"]) <= 100
