"""The port's CUDA kernels against their plain versions, on the card.

Edge cases the acceptance-size run in ``chip_smoke.py`` does not reach:
NaN features, stumps and padding, ragged tiles, a single tree.  Marked
``cuda``; on a machine without a card every test skips (the fixture
decides, at run time).  On the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.forest.trees import Tree, TreeArrays
from repro_torch.kernels.block_prox.ops import block_prox
from repro_torch.kernels.block_prox.ref import block_prox_ref
from repro_torch.kernels.leaf_route.ops import route, route_tables
from repro_torch.kernels.leaf_route.ref import route_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tree(rng, n_nodes, d, p_split=0.8):
    feature = np.full(n_nodes, -1, np.int32)
    threshold = np.zeros(n_nodes, np.float32)
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    depth = np.zeros(n_nodes, np.int64)
    nxt = 1
    for node in range(n_nodes):
        if nxt + 1 >= n_nodes or node >= nxt:
            continue
        if rng.random() < p_split or node == 0:
            feature[node] = rng.integers(0, d)
            threshold[node] = np.float32(rng.normal())
            left[node], right[node] = nxt, nxt + 1
            depth[nxt:nxt + 2] = depth[node] + 1
            nxt += 2
    leaf = feature == -1
    leaf_id = np.full(n_nodes, -1, np.int32)
    leaf_id[leaf] = np.arange(leaf.sum(), dtype=np.int32)
    return Tree(feature, threshold, left, right, leaf_id,
                np.ones((n_nodes, 2), np.float32),
                np.ones(n_nodes, np.int32), int(depth.max()))


def _stump():
    return Tree(np.array([-1], np.int32), np.array([np.inf], np.float32),
                np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.ones((1, 2), np.float32),
                np.ones(1, np.int32), 0)


def _check_route(trees, X, dev):
    tables = route_tables(TreeArrays.from_trees(trees), dev)
    Xd = torch.as_tensor(X, dtype=torch.float64, device=dev)
    n0 = route.launches
    got = route(Xd, tables)
    torch.cuda.synchronize()
    assert route.launches == n0 + 1
    want = route_ref(Xd, tables.feature, tables.threshold, tables.lr,
                     tables.leaf_id, tables.n_trees, tables.max_nodes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,T,nodes", [(1, 1, 3), (257, 9, 63),
                                       (1000, 17, 511)])
def test_route_kernel_small_trees(dev, n, T, nodes):
    rng = np.random.default_rng(n + T)
    X = rng.normal(size=(n, 5))
    X[::5, 1] = np.nan                                # NaN goes right
    thr = [_tree(rng, nodes, 5) for _ in range(T)]
    X[: min(n, 50), 0] = thr[0].threshold[0]          # exactly on a split
    _check_route(thr, X, dev)


def test_route_kernel_stumps_next_to_a_deep_tree(dev):
    rng = np.random.default_rng(3)
    _check_route([_stump(), _tree(rng, 255, 4), _stump()],
                 rng.normal(size=(300, 4)), dev)


def test_route_kernel_deep_trees(dev):
    """Trees whose node tables exceed a block's shared memory."""
    rng = np.random.default_rng(4)
    trees = [_tree(rng, 20_001, 6, p_split=1.0) for _ in range(3)]
    _check_route(trees, rng.normal(size=(700, 6)), dev)


@pytest.mark.parametrize("nq,nw,T", [(1, 1, 1), (63, 65, 15), (64, 64, 16),
                                     (130, 1000, 33), (700, 129, 100)])
def test_block_prox_kernel_ragged(dev, nq, nw, T):
    rng = np.random.default_rng(nq * nw + T)
    gl_q = torch.as_tensor(rng.integers(0, 4, (nq, T)), dtype=torch.int32,
                           device=dev)
    gl_w = torch.as_tensor(rng.integers(0, 4, (nw, T)), dtype=torch.int32,
                           device=dev)
    q = torch.as_tensor(rng.random((nq, T)), device=dev)
    w = torch.as_tensor(rng.random((nw, T)), device=dev)
    n0 = block_prox.launches
    got = block_prox(gl_q, q, gl_w, w)
    torch.cuda.synchronize()
    assert block_prox.launches == n0 + 1
    want = block_prox_ref(gl_q, q, gl_w, w)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_forest_kernel_runs_on_the_card(dev):
    """The slice on the card equals the slice on the CPU: same leaves and
    factors bit for bit, ops within 1e-8."""
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes, train_test_split
    X, y = gaussian_classes(2000, d=10, n_classes=4, seed=2)
    Xtr, ytr, Xte, _ = train_test_split(X, y, test_frac=0.25, seed=1)
    kw = dict(kernel_method="kerf", n_trees=10, seed=3)
    gpu = ForestKernel(device="cuda", **kw).fit(Xtr, ytr)
    cpu = ForestKernel(device="cpu", **kw).fit(Xtr, ytr)
    assert torch.equal(gpu.engine.gl.cpu(), cpu.engine.gl)
    assert torch.equal(gpu.engine.q.cpu(), cpu.engine.q)
    for a, b in [(gpu.predict(Xte), cpu.predict(Xte)),
                 (gpu.row_sums(Xte), cpu.row_sums(Xte)),
                 (gpu.kernel_block(None, X_rows=Xte), cpu.kernel_block(
                     None, X_rows=Xte)),
                 (gpu.topk(5, X=Xte)[1], cpu.topk(5, X=Xte)[1])]:
        torch.testing.assert_close(a.cpu().double(), b.double(), rtol=0,
                                   atol=1e-8)


def test_large_train_side_jobs_stay_on_the_card(dev, monkeypatch):
    """Above the CPU engine's sparse cutover, a CUDA engine still computes
    train-side top-k and squared row sums in block-kernel row blocks, and
    they match the CPU engine's host CSR results."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.api import ForestKernel
    from repro_torch.data.synthetic import gaussian_classes
    X, y = gaussian_classes(1500, d=8, n_classes=3, seed=5)
    kw = dict(kernel_method="gap", n_trees=12, seed=4)
    gpu = ForestKernel(device="cuda", **kw).fit(X, y)
    cpu = ForestKernel(device="cpu", **kw).fit(X, y)
    monkeypatch.setattr(eng_mod.ProximityEngine, "_SPARSE_TRAIN_CUTOVER", 10)
    n0 = block_prox.launches
    got_s = gpu.engine.squared_row_sums(y, 3)
    got_i, got_v = gpu.engine.topk(6)
    torch.cuda.synchronize()
    assert block_prox.launches >= n0 + 2
    want_s = cpu.engine.squared_row_sums(y, 3)
    want_v = cpu.engine.topk(6)[1]
    torch.testing.assert_close(got_s.cpu(), want_s, rtol=0, atol=1e-8)
    torch.testing.assert_close(got_v.cpu(), want_v, rtol=0, atol=1e-8)
    P = cpu.engine.kernel_block()
    torch.testing.assert_close(P.gather(1, got_i.cpu()), got_v.cpu(),
                               rtol=0, atol=1e-8)
