"""The engine's regions and counters (``obs.trace.region``, PERF.md §3).

With regions off, ``region`` hands out the shared no-op and a
``torch.profiler`` trace of ``topk`` and ``squared_row_sums`` holds no
``repro:`` range; with them on it holds the engine's spans, nested as the
engine's docstring names them, and the answers keep their bits.  The
top-k counters count each call's rows once, and the spill counter, which
the benchmark reads, stays 0.  The tests marked ``cuda`` (skipped without
a card) hold K2's launch counts by form to the form the engine picks, and
the card engine's top-k through the ``row_topk`` kernel to the plain
version on its block: the same answers, one launch a block, and no span
but the top-k's own.  They keep the card engine's train-side calls on
dense blocks (``dense_blocks``); the collision path's spans and counters
are ``tests/test_torch_collide.py``'s.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine as eng_mod
from repro_torch.core.api import ForestKernel
from repro_torch.data.synthetic import friedman1, gaussian_classes
from repro_torch.kernels.block_prox.ops import block_prox
from repro_torch.kernels.row_topk.ops import row_topk
from repro_torch.kernels.row_topk.ref import row_topk_ref
from repro_torch.obs import (NULL_REGION, MetricsRegistry, global_registry,
                             region, set_regions)
from repro_torch.obs.metrics import set_global_registry

K = 10
# each span's innermost enclosing span (None: outermost)
PARENTS = {
    "engine.topk": {None},
    "engine.squared_row_sums": {None},
    "engine.k2": {"engine.topk", "engine.squared_row_sums"},
    "engine.select": {"engine.topk"},
    "engine.class_ids": {"engine.squared_row_sums"},
    "engine.class_sums": {"engine.squared_row_sums"},
}


@pytest.fixture(scope="module")
def data():
    return gaussian_classes(300, d=6, n_classes=3, seed=1)


@pytest.fixture(scope="module")
def tied(data):
    """Two stumps: most of a row's columns tie at its k-th value."""
    X, y = data
    return ForestKernel(kernel_method="gap", n_trees=2, max_depth=1, seed=0,
                        device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def untied(data):
    """Forty KeRF trees of depth 4: few columns tie at a row's k-th
    value."""
    X, y = data
    return ForestKernel(kernel_method="kerf", n_trees=40, max_depth=4,
                        seed=0, device="cpu").fit(X, y)


@pytest.fixture
def regions_off():
    """Regions off for the test, the previous state restored."""
    old = set_regions(False)
    try:
        yield
    finally:
        set_regions(old)


@pytest.fixture
def fresh_global():
    old = set_global_registry(MetricsRegistry())
    try:
        yield global_registry()
    finally:
        set_global_registry(old)


def _pass(fk, y):
    idx, val = fk.engine.topk(k=K)
    sq = fk.engine.squared_row_sums(class_ids=y, n_classes=3)
    return idx, val, sq


def _traced_pass(fk, y):
    """(answers, [(name, start_ns, end_ns)] of the trace's repro ranges)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _pass(fk, y)
    ranges = [(e.name()[6:], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro:")]
    return out, ranges


def _parent(r, ranges):
    """The innermost range of ``ranges`` that holds ``r`` (None if none)."""
    best = None
    for o in ranges:
        if o is not r and o[1] <= r[1] and r[2] <= o[2] and \
                (best is None or o[2] - o[1] < best[2] - best[1]):
            best = o
    return None if best is None else best[0]


def test_region_is_the_shared_noop_while_off(regions_off):
    assert region("engine.topk") is NULL_REGION
    assert region("anything") is NULL_REGION
    with region("engine.k2") as r:
        assert r is None


def test_set_regions_returns_the_previous_state(regions_off):
    assert set_regions(True) is False
    assert region("engine.topk") is not NULL_REGION
    assert set_regions(False) is True
    assert set_regions(False) is False


def test_no_ranges_while_off(regions_off, tied, data):
    _, ranges = _traced_pass(tied, data[1])
    assert ranges == []


@pytest.mark.parametrize("kernel", ["tied", "untied"])
def test_ranges_nested_and_answers_bit_identical(regions_off, data, kernel,
                                                 request):
    fk, y = request.getfixturevalue(kernel), data[1]
    off, _ = _traced_pass(fk, y)
    set_regions(True)
    on, ranges = _traced_pass(fk, y)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    names = {r[0] for r in ranges}
    assert names == set(PARENTS)
    for r in ranges:
        assert _parent(r, ranges) in PARENTS[r[0]], r[0]
    # once a call: the outer spans and the one-hot
    for name in set(PARENTS) - {"engine.k2", "engine.select",
                                "engine.class_sums"}:
        assert sum(r[0] == name for r in ranges) == 1, name
    # a selection a K2 block
    assert sum(r[0] == "engine.select" for r in ranges) == \
        sum(_parent(r, ranges) == "engine.topk" for r in ranges
            if r[0] == "engine.k2")


@pytest.mark.parametrize("kernel", ["tied", "untied"])
def test_spill_counter_counts_the_flagged_rows(fresh_global, regions_off,
                                               kernel, request):
    """Every row counted, ties at the k-th value or none, and the spill
    counter, which the benchmark reads, present and 0."""
    fk = request.getfixturevalue(kernel)
    fk.engine.topk(k=K)
    fk.engine.topk(k=K)
    snap = fresh_global.snapshot()
    n = fk.engine.n_ref
    assert snap["engine_topk_rows_total"]["series"][""] == 2 * n
    assert snap["engine_topk_spill_rows_total"]["series"][""] == 0


def test_counters_count_once_per_call_not_per_block(fresh_global,
                                                    regions_off, tied):
    """Blocks of 32 rows: ten blocks, one increment of each counter."""
    names = ("engine_topk_rows_total", "engine_topk_spill_rows_total")
    seen = {name: [] for name in names}
    for name in names:
        fam = fresh_global.counter(name)
        fam.inc = lambda n=1.0, inc=fam.inc, name=name: (
            seen[name].append(n), inc(n))
    try:
        tied.engine.topk(k=K, block=32)
    finally:
        for name in names:
            del fresh_global.counter(name).inc
    assert seen == {"engine_topk_rows_total": [tied.engine.n_ref],
                    "engine_topk_spill_rows_total": [0]}


def test_topk_on_host_csr_counts_nothing(fresh_global, regions_off, tied,
                                         monkeypatch):
    """Large train-side jobs of a CPU engine take the host CSR path: the
    outer span only, and no selection from dense blocks to count."""
    eng = tied.engine
    monkeypatch.setattr(type(eng), "_SPARSE_TRAIN_CUTOVER", 10)
    set_regions(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.topk(k=K)
        eng.squared_row_sums(class_ids=np.zeros(eng.n_ref, np.int64))
    names = sorted(e.name() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("repro:"))
    assert names == ["repro:engine.squared_row_sums", "repro:engine.topk"]
    assert "engine_topk_rows_total" not in fresh_global.snapshot()


# ---------------- on the card ----------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def dense_blocks(monkeypatch):
    """No engine in collision mode: train-side calls on dense blocks."""
    monkeypatch.setattr(eng_mod, "COLLIDE_SHARE_MAX", float("-inf"))


def _card_engine(kind, dtype=np.float64):
    rng = np.random.default_rng(7)
    if kind == "leaf":                 # random labels: one-sample leaves
        X = rng.normal(size=(3000, 8))
        fk = ForestKernel(kernel_method="gap", n_trees=8, seed=1,
                          device="cuda", dtype=dtype
                          ).fit(X, rng.integers(0, 5, 3000))
        return fk.engine, rng.integers(0, 5, 3000)
    X, y = friedman1(3000, d=8, seed=2)  # depth 6: leaves of hundreds
    fk = ForestKernel(model_type="gbt", task="regression",
                      kernel_method="boosted", n_trees=20, max_depth=6,
                      seed=0, device="cuda", dtype=dtype).fit(X, y)
    return fk.engine, rng.integers(0, 5, 3000)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["leaf", "dense"])
def test_card_counts_launches_by_form(dev, dense_blocks, regions_off, kind):
    eng, cls = _card_engine(kind)
    assert eng.leaf_mode() == (kind == "leaf")
    before = dict(block_prox.form_launches)
    n64 = block_prox.launches
    eng.topk(k=K)
    eng.squared_row_sums(class_ids=cls, n_classes=5)
    torch.cuda.synchronize()
    delta = {f: block_prox.form_launches[f] - before[f] for f in before}
    other = "dense" if kind == "leaf" else "leaf"
    assert delta[kind] > 0
    assert delta[other] == delta["leaf_f32"] == delta["dense_f32"] == 0
    assert block_prox.launches - n64 == delta[kind]


@pytest.mark.cuda
def test_card_answers_bit_identical_with_regions_on(dev, dense_blocks,
                                                    regions_off):
    eng, cls = _card_engine("leaf")
    off = (*eng.topk(k=K), eng.squared_row_sums(class_ids=cls, n_classes=5))
    set_regions(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = (*eng.topk(k=K),
              eng.squared_row_sums(class_ids=cls, n_classes=5))
        torch.cuda.synchronize()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"repro:engine.k2", "repro:engine.select",
            "repro:engine.class_sums"} <= names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["leaf", "dense"])
def test_card_topk_kernel_equals_plain_version(dev, dense_blocks,
                                               regions_off, fresh_global,
                                               kind, dtype):
    """k = 10 and 50, in one block and in 64-row blocks: the engine's
    answer is the plain version's on its whole block, one kernel launch a
    block, every row counted and none as spilled."""
    eng, _ = _card_engine(kind, dtype)
    n = eng.n_ref
    B = eng.kernel_block()
    for k in (10, 50):
        want = row_topk_ref(B, k)
        for block in (4096, 64):
            launches = row_topk.launches
            got = eng.topk(k=k, block=block)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (k, block)
            assert torch.equal(got[1], want[1]), (k, block)
            step = eng._op_row_chunk(block)
            assert row_topk.launches - launches == -(-n // step)
    snap = fresh_global.snapshot()
    assert snap["engine_topk_rows_total"]["series"][""] == 4 * n
    assert snap["engine_topk_spill_rows_total"]["series"][""] == 0


@pytest.mark.cuda
def test_card_topk_past_the_kernel_takes_the_plain_version(dev,
                                                           dense_blocks,
                                                           regions_off):
    """k = 100, past ``row_topk``'s MAX_K, on a CUDA engine: no kernel
    launch, and the lexicographic (value descending, column ascending)
    order of the engine's block."""
    eng, _ = _card_engine("dense")
    P = eng.kernel_block().cpu().numpy()
    want = np.lexsort((np.broadcast_to(np.arange(P.shape[1]), P.shape), -P),
                      axis=1)[:, :100]
    launches = row_topk.launches
    idx, val = eng.topk(k=100, block=64)
    torch.cuda.synchronize()
    assert row_topk.launches == launches
    np.testing.assert_array_equal(idx.cpu().numpy(), want)
    np.testing.assert_array_equal(val.cpu().numpy(),
                                  np.take_along_axis(P, want, 1))


@pytest.mark.cuda
def test_card_topk_kernel_path_reads_nothing_back(dev, dense_blocks,
                                                  regions_off):
    """A top-k call on the kernel's path is the plain version's answer and
    holds only its own spans: ``engine.topk`` around ``engine.k2`` and
    ``engine.select`` a block, nothing between the selections."""
    eng, _ = _card_engine("dense")
    want = row_topk_ref(eng.kernel_block(), K)
    set_regions(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = eng.topk(k=K)
        torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("repro:")]
    assert set(names) == {"repro:engine.topk", "repro:engine.k2",
                          "repro:engine.select"}
    assert names.count("repro:engine.k2") == \
        names.count("repro:engine.select")
