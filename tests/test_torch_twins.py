"""The example twins run on the CPU, and the generators they and the
benchmarks draw from equal the reference's for the same seed."""
import numpy as np
import pytest

from repro.data import synthetic as ref_synthetic
from repro_torch.data import synthetic


@pytest.mark.parametrize("name,kw", [
    ("two_spirals", dict(n=501, noise=0.3)),
    ("two_spirals", dict(n=64)),
    ("image_classes", dict(n=300, side=8, n_classes=5)),
    ("image_classes", dict(n=50)),
    ("gaussian_classes", dict(n=200, d=9, n_classes=3, sep=0.8)),
    ("friedman1", dict(n=150, d=7)),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_equal_reference(name, kw, seed):
    X, y = getattr(synthetic, name)(seed=seed, **kw)
    Xr, yr = getattr(ref_synthetic, name)(seed=seed, **kw)
    assert X.dtype == Xr.dtype and y.dtype == yr.dtype
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(y, yr)


def test_paper_pipeline_twin_runs_on_cpu(capsys):
    from repro_torch.paper_pipeline import main
    res = main(n=1500, n_trees=6, device="cpu")
    assert res["acc"] > 0.5 and res["nnz"] > 0
    assert res["embedding"] == (1425, 20)
    out = capsys.readouterr().out
    assert "[5] leaf-PCA" in out and "device cpu" in out


def test_proximity_applications_twin_runs_on_cpu(capsys):
    from repro_torch.proximity_applications import main
    res = main(n=600, d=8, n_trees=6, device="cpu")
    assert res["impute_err"] < res["median_err"]
    assert res["prototype_acc"] > 0.5 and res["propagation_acc"] > 0.5
    assert capsys.readouterr().out.rstrip().endswith("OK")


@pytest.mark.parametrize("module", ["paper_pipeline",
                                    "proximity_applications"])
def test_twins_default_to_the_card(module):
    """Each twin takes ``--device``, default ``cuda``, as does its
    ``main``."""
    import importlib
    import inspect
    mod = importlib.import_module(f"repro_torch.{module}")
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    assert 'add_argument("--device", default="cuda")' in \
        inspect.getsource(mod)
