"""The engine's regions and counters (``obs.trace.region``, PERF.md §3).

With regions off, ``region`` hands out the shared no-op and a
``torch.profiler`` trace of ``topk`` and ``squared_row_sums`` holds no
``repro:`` range; with them on it holds the engine's spans, nested as the
engine's docstring names them, and the answers keep their bits.  The
top-k counters count exactly the rows ``_topk_rows`` flags.  The tests
marked ``cuda`` (skipped without a card) hold K2's launch counts by form
to the form the engine picks, and the card engine's top-k through the
``row_topk`` kernel to its ``torch.topk`` path: the same answers, the
kernel's counts, and no tie-rule host read.  They keep the card engine's
train-side calls on dense blocks (``dense_blocks``); the collision path's
spans and counters are ``tests/test_torch_collide.py``'s.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine as eng_mod
from repro_torch.core.api import ForestKernel
from repro_torch.core.engine import _topk_rows, _topk_rows_exact
from repro_torch.data.synthetic import friedman1, gaussian_classes
from repro_torch.kernels.block_prox.ops import block_prox
from repro_torch.kernels.row_topk.ops import row_topk
from repro_torch.obs import (NULL_REGION, MetricsRegistry, global_registry,
                             region, set_regions)
from repro_torch.obs.metrics import set_global_registry

K = 10
# each span's innermost enclosing span (None: outermost)
PARENTS = {
    "engine.topk": {None},
    "engine.squared_row_sums": {None},
    "engine.k2": {"engine.topk", "engine.squared_row_sums",
                  "engine.spill_redo"},
    "engine.select": {"engine.topk", "engine.spill_redo"},
    "engine.spill_read": {"engine.topk"},
    "engine.spill_redo": {"engine.topk"},
    "engine.class_ids": {"engine.squared_row_sums"},
    "engine.class_sums": {"engine.squared_row_sums"},
}


@pytest.fixture(scope="module")
def data():
    return gaussian_classes(300, d=6, n_classes=3, seed=1)


@pytest.fixture(scope="module")
def tied(data):
    """Two stumps: most of a row's columns tie at its k-th value, past the
    16 spare candidates."""
    X, y = data
    return ForestKernel(kernel_method="gap", n_trees=2, max_depth=1, seed=0,
                        device="cpu").fit(X, y)


@pytest.fixture(scope="module")
def untied(data):
    """Forty KeRF trees of depth 4: every row's candidates end below its
    k-th value."""
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
    want = set(PARENTS) - ({"engine.spill_redo"} if kernel == "untied"
                           else set())
    assert names == want
    for r in ranges:
        assert _parent(r, ranges) in PARENTS[r[0]], r[0]
    # once a call: the outer spans, the host read, the one-hot, the redo
    for name in want - {"engine.k2", "engine.select", "engine.class_sums"}:
        assert sum(r[0] == name for r in ranges) == 1, name
    if kernel == "tied":     # the redo holds its own K2 call and selection
        redo = next(r for r in ranges if r[0] == "engine.spill_redo")
        inner = {r[0] for r in ranges if _parent(r, ranges) ==
                 "engine.spill_redo" and redo[1] <= r[1] <= redo[2]}
        assert inner == {"engine.k2", "engine.select"}


@pytest.mark.parametrize("kernel,spills", [("tied", True),
                                           ("untied", False)])
def test_spill_counter_counts_the_flagged_rows(fresh_global, regions_off,
                                               kernel, spills, request):
    fk = request.getfixturevalue(kernel)
    _, _, flag = _topk_rows(fk.engine.kernel_block(), K)
    n_flag = int(flag.sum())
    assert (n_flag > 0) == spills
    fk.engine.topk(k=K)
    fk.engine.topk(k=K)
    snap = fresh_global.snapshot()
    n = fk.engine.n_ref
    assert snap["engine_topk_rows_total"]["series"][""] == 2 * n
    assert snap["engine_topk_spill_rows_total"]["series"][""] == 2 * n_flag


def test_counters_count_once_per_call_not_per_block(fresh_global,
                                                    regions_off, tied):
    """Blocks of 32 rows: ten blocks, one increment of each counter."""
    _, _, flag = _topk_rows(tied.engine.kernel_block(), K)
    fam = fresh_global.counter("engine_topk_spill_rows_total")
    seen = []
    inc = fam.inc
    fam.inc = lambda n=1.0: (seen.append(n), inc(n))
    try:
        tied.engine.topk(k=K, block=32)
    finally:
        del fam.inc
    assert seen == [int(flag.sum())]


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


def _torch_topk_path(eng, k):
    """The engine's answer through ``_topk_rows`` and, for the rows it
    flags, ``_topk_rows_exact``, on its whole dense block."""
    B = eng.kernel_block()
    kk = min(k, eng.n_ref)
    idx, val, spill = _topk_rows(B, kk)
    idx, val = idx.clone(), val.to(torch.float64)
    rows = spill.nonzero()[:, 0]
    if rows.numel():
        ix, v = _topk_rows_exact(B[rows], kk)
        idx[rows], val[rows] = ix, v.to(torch.float64)
    return idx, val


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["leaf", "dense"])
def test_card_topk_kernel_equals_torch_topk_path(dev, dense_blocks,
                                                 regions_off, fresh_global,
                                                 kind, dtype):
    """k = 10 and 50, in one block and in 64-row blocks: the kernel's
    answer is the torch.topk path's, one launch a block, every row counted
    as the kernel's and none as spilled."""
    eng, _ = _card_engine(kind, dtype)
    n = eng.n_ref
    for k in (10, 50):
        want = _torch_topk_path(eng, k)
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
    assert snap["engine_topk_kernel_rows_total"]["series"][""] == 4 * n
    assert snap["engine_topk_spill_rows_total"]["series"][""] == 0


@pytest.mark.cuda
def test_card_topk_kernel_path_reads_nothing_back(dev, dense_blocks,
                                                  regions_off):
    """On the kernel's path a top-k call has no tie-rule host read or
    redo: no ``engine.spill_read`` or ``engine.spill_redo`` range, and
    ``engine.select`` still around each block's selection."""
    eng, _ = _card_engine("dense")
    set_regions(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.topk(k=K)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("repro:")]
    assert "repro:engine.select" in names
    assert "repro:engine.spill_read" not in names
    assert "repro:engine.spill_redo" not in names
