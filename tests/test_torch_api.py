"""The slice end to end: the port's ForestKernel against the reference's.

``repro_torch.core.api.ForestKernel(device="cpu").fit`` must grow the same
trees and build the same factors, bit for bit, as the reference
``ForestKernel(routing_backend="numpy", tree_backend="numpy")`` with the
same seed, and serve every op within 1e-8 of it.  The entry points run on
the card unless the caller asks for the CPU, and never fall back.
"""
import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.data.synthetic import gaussian_classes, train_test_split
from repro_torch import resolve_device
from repro_torch.core.api import ForestKernel
from repro_torch.forest.ensemble import RandomForest

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


def test_card_engine_keeps_large_train_side_jobs_on_the_card(data):
    """Only a CPU engine hands train-side jobs to the host CSR factors; a
    CUDA engine runs them through the block kernel at every size."""
    Xtr, ytr, _, _ = data
    eng = ForestKernel(device="cpu", n_trees=4, seed=2).fit(Xtr, ytr).engine
    eng._SPARSE_TRAIN_CUTOVER = 10
    assert eng._sparse_train(None) and not eng._sparse_train(Xtr)
    eng.device = torch.device("cuda", 0)
    assert not eng._sparse_train(None)


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


def test_unported_options_raise(data):
    Xtr, ytr, _, _ = data
    with pytest.raises(NotImplementedError, match="gbt"):
        ForestKernel(model_type="gbt", device="cpu").fit(Xtr, ytr)
    with pytest.raises(NotImplementedError, match="ih"):
        ForestKernel(kernel_method="ih", n_trees=2, device="cpu").fit(Xtr, ytr)


def test_quickstart_twin_runs_on_cpu(capsys):
    from repro_torch.quickstart import main
    res = main(n=700, n_trees=6, device="cpu")
    assert res["test_acc"] > 0.5 and res["nnz"] > 0
    assert "leaf-PCA" in capsys.readouterr().out
