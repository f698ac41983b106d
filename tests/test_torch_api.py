"""The slice end to end: the port's ForestKernel against the reference's.

``repro_torch.core.api.ForestKernel(device="cpu").fit`` must grow the same
trees and build the same factors, bit for bit, as the reference
``ForestKernel(routing_backend="numpy", tree_backend="numpy")`` with the
same seed, and serve every op within 1e-8 of it.  The entry points run on
the card unless the caller asks for the CPU, and never fall back.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.data.synthetic import friedman1, gaussian_classes, train_test_split
from repro_torch import resolve_device
from repro_torch.core.api import ForestKernel
from repro_torch.core.convert import forest_kernel_from_arrays
from repro_torch.forest import training
from repro_torch.forest.ensemble import RandomForest
from repro_torch.kernels.collide.ops import MAX_K as PAIR_TOPK_MAX_K

ATOL = 1e-8


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


@pytest.fixture(scope="module")
def data():
    X, y = gaussian_classes(900, d=10, n_classes=4, seed=13)
    return train_test_split(X, y, test_frac=0.2, seed=5)


@pytest.mark.parametrize("model_type,method", [
    ("rf", "gap"), ("rf", "oob"), ("rf", "kerf"), ("et", "original")])
def test_fit_matches_reference_end_to_end(data, model_type, method):
    Xtr, ytr, Xte, yte = data
    kw = dict(model_type=model_type, kernel_method=method, n_trees=10, seed=4)
    ref = RefKernel(routing_backend="numpy", tree_backend="numpy",
                    **kw).fit(Xtr, ytr)
    port = ForestKernel(device="cpu", **kw).fit(Xtr, ytr)
    for a, b in zip(ref.forest.trees_, port.forest.trees_):
        for f in ("feature", "threshold", "left", "right", "leaf_id",
                  "value", "n_node_samples"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(_np(port.ctx.leaves), ref.ctx.leaves)
    np.testing.assert_array_equal(_np(port.engine.gl), ref.engine.gl)
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    np.testing.assert_array_equal(_np(port.engine.w), ref.engine.w)
    np.testing.assert_array_equal(_np(port.ctx.leaf_mass), ref.ctx.leaf_mass)
    np.testing.assert_array_equal(_np(port.ctx.leaf_mass_inbag),
                                  ref.ctx.leaf_mass_inbag)

    def close(a, b):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(_np(port.predict()), ref.predict())
    np.testing.assert_array_equal(_np(port.predict(Xte)), ref.predict(Xte))
    close(port.row_sums(), ref.row_sums())
    close(port.row_sums(Xte), ref.row_sums(Xte))
    close(port.kernel_block(np.arange(30)), ref.kernel_block(np.arange(30)))
    close(port.kernel_block(None, X_rows=Xte[:25]),
          ref.kernel_block(None, X_rows=Xte[:25]))
    close(port.topk(5)[1], ref.topk(5)[1])
    close(port.engine.squared_row_sums(ytr, 4, X=Xte),
          ref.engine.squared_row_sums(ytr, 4, X=Xte))
    assert (port.kernel() != ref.kernel()).nnz == 0
    assert port.memory_bytes() == ref.memory_bytes()


def test_leaf_pca_matches_reference(data):
    Xtr, ytr, _, _ = data
    kw = dict(kernel_method="original", n_trees=8, seed=1)
    ref = RefKernel(routing_backend="numpy", tree_backend="numpy",
                    **kw).fit(Xtr, ytr)
    port = ForestKernel(device="cpu", **kw).fit(Xtr, ytr)
    np.testing.assert_allclose(port.leaf_pca(5).singular_values_,
                               ref.leaf_pca(5).singular_values_,
                               rtol=1e-8, atol=0)


def test_large_train_side_jobs_take_the_host_csr_path(data, monkeypatch):
    """On a CPU engine above the sparse cutover, train-side top-k and
    squared row sums run on the host CSR factors, as on every reference
    backend."""
    Xtr, ytr, _, _ = data
    port = ForestKernel(device="cpu", n_trees=6, seed=2).fit(Xtr, ytr)
    dense = port.engine.squared_row_sums(ytr, 4), port.engine.topk(4)
    monkeypatch.setattr(type(port.engine), "_SPARSE_TRAIN_CUTOVER", 10)
    from repro_torch.core import engine as eng_mod

    def forbidden(*a, **k):
        raise AssertionError("dense block path used above the cutover")
    monkeypatch.setattr(eng_mod, "block_prox", forbidden)
    sparse = port.engine.squared_row_sums(ytr, 4), port.engine.topk(4)
    np.testing.assert_allclose(_np(sparse[0]), _np(dense[0]), atol=ATOL)
    np.testing.assert_allclose(_np(sparse[1][1]), _np(dense[1][1]),
                               atol=ATOL)


@pytest.mark.parametrize("device,cutover,collides,side,k,want", [
    ("cpu", 10, False, "train", None, "csr"),
    ("cpu", 10, True, "train", 10, "csr"),
    ("cpu", 10, False, "oos", 10, "dense"),
    ("cpu", None, True, "train", 10, "dense"),
    ("cuda", 10, False, "train", None, "dense"),
    ("cuda", 10, False, "train", 10, "dense"),
    ("cuda", 10, True, "train", None, "collide"),
    ("cuda", 10, True, "train", PAIR_TOPK_MAX_K, "collide"),
    ("cuda", 10, True, "train", PAIR_TOPK_MAX_K + 1, "dense"),
    ("cuda", 10, True, "oos", 10, "dense"),
])
def test_card_engine_keeps_large_train_side_jobs_on_the_card(
        data, device, cutover, collides, side, k, want):
    """Only a CPU engine above the cutover hands train-side jobs to the
    host CSR factors; a CUDA engine keeps them on the card at every size:
    over leaf collisions in collision mode (a top-k up to the pair
    kernel's MAX_K), else through the block kernel.  OOS batches take
    dense blocks on every engine."""
    Xtr, ytr, _, _ = data
    eng = ForestKernel(device="cpu", n_trees=4, seed=2).fit(Xtr, ytr).engine
    if cutover is not None:
        eng._SPARSE_TRAIN_CUTOVER = cutover
    eng.collision_mode = lambda: collides
    eng.device = torch.device(device, 0) if device == "cuda" else eng.device
    assert eng._train_path(None if side == "train" else Xtr, k) == want


def test_cuda_requested_without_a_card_raises(data, monkeypatch):
    """device='cuda' never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xtr, ytr, _, _ = data
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ForestKernel(n_trees=2).fit(Xtr, ytr)
    with pytest.raises(RuntimeError, match="CUDA"):
        RandomForest(n_trees=2).fit(Xtr, ytr)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_options_raise(data, tmp_path):
    """Gradient boosting, the instance-hardness rule, snapshots and serving
    are ported now; float32 kernels and the reference's own trainer
    backends are not, and raise."""
    from repro_torch.core.snapshot import SnapshotError
    Xtr, ytr, _, _ = data
    fk = ForestKernel(kernel_method="ih", n_trees=2, device="cpu").fit(Xtr,
                                                                       ytr)
    path = tmp_path / "fk.npz"
    fk.save(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
    manifest["config"]["dtype"] = "float32"
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       dtype=np.uint8)
    np.savez(tmp_path / "f32.npz", **arrays)
    with pytest.raises(SnapshotError, match="float32"):
        ForestKernel.load(tmp_path / "f32.npz", device="cpu")
    with pytest.raises(ValueError, match="tree backend"):
        ForestKernel(tree_backend="native", n_trees=2,
                     device="cpu").fit(Xtr, ytr)
    with pytest.raises(ValueError, match="model_type"):
        ForestKernel(model_type="xgb", device="cpu").fit(Xtr, ytr)


def test_quickstart_twin_runs_on_cpu(capsys):
    from repro_torch.quickstart import main
    res = main(n=700, n_trees=6, device="cpu")
    assert res["test_acc"] > 0.5 and res["nnz"] > 0
    assert "leaf-PCA" in capsys.readouterr().out


@pytest.fixture(scope="module")
def reg_data():
    X, y = friedman1(700, d=8, seed=6)
    return train_test_split(X, y, test_frac=0.2, seed=1)


GBT_KW = dict(model_type="gbt", task="regression", kernel_method="boosted",
              n_trees=10, max_depth=4, seed=2)


def _ops_close(port, ref, Xtr, ytr, Xte):
    def close(a, b):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=ATOL)
    close(port.predict(), ref.predict())
    close(port.predict(Xte), ref.predict(Xte))
    close(port.row_sums(), ref.row_sums())
    close(port.row_sums(Xte), ref.row_sums(Xte))
    close(port.kernel_block(np.arange(20)), ref.kernel_block(np.arange(20)))
    close(port.kernel_block(None, X_rows=Xte[:15]),
          ref.kernel_block(None, X_rows=Xte[:15]))
    close(port.topk(5)[1], ref.topk(5)[1])
    close(port.topk(5, X=Xte)[1], ref.engine.topk(5, X=Xte)[1])
    assert (port.kernel() != ref.kernel()).nnz == 0


def test_gbt_boosted_matches_reference_scipy_engine(reg_data):
    """model_type='gbt' with kernel_method='boosted': same trees, tree
    weights and factors bit for bit as the reference's scipy engine, ops
    within 1e-8."""
    Xtr, ytr, Xte, _ = reg_data
    ref = RefKernel(routing_backend="numpy", tree_backend="numpy",
                    engine_backend="scipy", **GBT_KW).fit(Xtr, ytr)
    port = ForestKernel(device="cpu", **GBT_KW).fit(Xtr, ytr)
    for a, b in zip(ref.forest.trees_, port.forest.trees_):
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_array_equal(a.value, b.value)
    np.testing.assert_array_equal(port.forest.tree_weights_,
                                  ref.forest.tree_weights_)
    assert port.forest.base_score_ == ref.forest.base_score_
    np.testing.assert_array_equal(_np(port.engine.gl), ref.engine.gl)
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    np.testing.assert_array_equal(_np(port.engine.w), ref.engine.w)
    np.testing.assert_allclose(_np(port.forest.predict(Xte)),
                               ref.forest.predict(Xte), rtol=0, atol=1e-10)
    _ops_close(port, ref, Xtr, ytr, Xte)


def test_gbt_snapshot_carries_across(reg_data, tmp_path):
    """A reference gbt kernel, saved by its snapshot writer, comes across
    with its base score and tree weights and serves the same ops."""
    Xtr, ytr, Xte, _ = reg_data
    ref = RefKernel(engine_backend="scipy", tree_backend="native",
                    **GBT_KW).fit(Xtr, ytr)
    path = tmp_path / "gbt.npz"
    ref.save(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("manifest")).decode())
    assert manifest["config"]["tree_backend"] == "native"   # dropped
    port = forest_kernel_from_arrays(arrays, manifest["config"],
                                     device="cpu",
                                     base_score=manifest["base_score"])
    assert port.forest.base_score_ == ref.forest.base_score_
    np.testing.assert_array_equal(port.forest.tree_weights_,
                                  ref.forest.tree_weights_)
    np.testing.assert_allclose(_np(port.forest.decision_function(Xte)),
                               ref.forest.decision_function(Xte), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    _ops_close(port, ref, Xtr, ytr, Xte)


def test_auto_tree_backend_is_the_host_trainer_on_the_cpu(data, monkeypatch):
    """tree_backend='auto' on the CPU grows trees with the host numpy
    trainer (no histogram wrapper is called); 'torch' on the CPU runs the
    device driver through the plain versions, with the same trees."""
    Xtr, ytr, _, _ = data
    calls = []
    real = training.hops

    class Spy:
        def histogram(self, *a, **k):
            calls.append("histogram")
            return real.histogram(*a, **k)

        def moments(self, *a, **k):
            calls.append("moments")
            return real.moments(*a, **k)

    monkeypatch.setattr(training, "hops", Spy())
    auto = ForestKernel(device="cpu", n_trees=4, seed=1).fit_forest(Xtr, ytr)
    assert calls == []
    dev = ForestKernel(device="cpu", n_trees=4, seed=1,
                       tree_backend="torch").fit_forest(Xtr, ytr)
    assert calls and set(calls) == {"histogram"}
    for a, b in zip(auto.forest.trees_, dev.forest.trees_):
        np.testing.assert_array_equal(a.threshold, b.threshold)
        np.testing.assert_array_equal(a.value, b.value)
