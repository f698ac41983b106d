"""The port's snapshots against the reference's.

Counterparts of ``tests/test_snapshot.py``: ``save`` → ``load`` reproduces
the saved engine without refitting (the saved factors are injected, so the
loaded kernel computes the saved kernel's bits), and tampered archives,
wrong versions and foreign npz files are refused with ``SnapshotError``.
Also, across the packages (one archive format):

- an archive the reference wrote (scipy engine) loads into the port, and
  the port's ops agree with the reference's scipy ops at 1e-8;
- an archive the port wrote loads into the reference's
  ``ForestKernel.load(path, engine_backend="scipy")``, with the same
  agreement;
- the context and factor digests are the same strings in both packages;
- a float32 archive is refused (float32 factors are not ported).

Everything runs on the CPU (``device="cpu"``).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.api import ForestKernel as RefKernel
from repro.core.factorization import factor_digest as ref_factor_digest
from repro_torch.core.api import ForestKernel
from repro_torch.core.factorization import factor_digest
from repro_torch.core.snapshot import (SNAPSHOT_VERSION, SnapshotError,
                                       _checksum, load_kernel, save_kernel)
from repro_torch.data.synthetic import gaussian_classes

from _hyp import given, settings, st

ATOL = 1e-8
REF_KW = dict(routing_backend="numpy", tree_backend="numpy",
              engine_backend="scipy")


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


@pytest.fixture(scope="module")
def snap_setup(tmp_path_factory):
    X, y = gaussian_classes(400, d=8, n_classes=3, sep=3.0, seed=11)
    fk = ForestKernel(kernel_method="gap", n_trees=12, seed=0,
                      device="cpu").fit(X, y)
    path = tmp_path_factory.mktemp("snap") / "kernel.npz"
    manifest = save_kernel(fk, path)
    Xq = np.ascontiguousarray(X[:32] + 1e-3)
    return {"fk": fk, "path": path, "manifest": manifest,
            "X": X, "y": y, "Xq": Xq}


@pytest.fixture(scope="module")
def ref_archives(tmp_path_factory, snap_setup):
    """Reference kernels on the same data, one per weight rule, fitted
    with its numpy router and trainer on the scipy engine and saved by its
    own snapshot writer."""
    X, y = snap_setup["X"], snap_setup["y"]
    d = tmp_path_factory.mktemp("ref")
    out = {}
    for method in ("gap", "original", "ih"):
        ref = RefKernel(kernel_method=method, n_trees=12, seed=0,
                        **REF_KW).fit(X, y)
        path = d / f"{method}.npz"
        ref.save(path)
        out[method] = (ref, path)
    return out


def _tamper(src, dst, mutate):
    """Re-save ``src`` with ``mutate(arrays)`` applied (manifest included),
    preserving the zip-level integrity so only *our* validation can object."""
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    mutate(arrays)
    np.savez(dst, **arrays)
    return dst


def _edit_manifest(arrays, **updates):
    manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
    manifest.update(updates)
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)


def _ops_agree(port, ref, y, Xq, atol=ATOL):
    """Every op of a port kernel within ``atol`` of a reference kernel's."""
    np.testing.assert_allclose(np.asarray(port.kernel().todense()),
                               np.asarray(ref.kernel().todense()),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(
        _np(port.engine.predict(y, n_classes=3, X=Xq)),
        ref.engine.predict(y, n_classes=3, X=Xq), rtol=0, atol=atol)
    np.testing.assert_allclose(_np(port.engine.row_sums(X=Xq)),
                               ref.engine.row_sums(X=Xq), rtol=0, atol=atol)
    _, v1 = ref.engine.topk(k=5, X=Xq)
    _, v2 = port.engine.topk(k=5, X=Xq)
    np.testing.assert_allclose(_np(v2), v1, rtol=0, atol=atol)
    rows, cols = np.arange(10), np.arange(25)
    np.testing.assert_allclose(_np(port.engine.kernel_block(rows, cols)),
                               ref.engine.kernel_block(rows, cols), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(
        _np(port.engine.squared_row_sums(y, n_classes=3, X=Xq)),
        ref.engine.squared_row_sums(y, n_classes=3, X=Xq), rtol=0,
        atol=atol)
    np.testing.assert_array_equal(_np(port.forest.apply(Xq)),
                                  ref.forest.apply(Xq))


# ---------------------------------------------------------------------------
# round-trip conformance
# ---------------------------------------------------------------------------

def test_roundtrip_all_ops_conformant(snap_setup):
    """A loaded port kernel computes the saved kernel's bits, op for op."""
    fk, Xq, y = snap_setup["fk"], snap_setup["Xq"], snap_setup["y"]
    fk2 = ForestKernel.load(snap_setup["path"], device="cpu")
    assert fk2.engine.device == torch.device("cpu")
    assert (fk2.kernel() != fk.kernel()).nnz == 0
    assert torch.equal(fk2.engine.predict(y, n_classes=3, X=Xq),
                       fk.engine.predict(y, n_classes=3, X=Xq))
    assert torch.equal(fk2.engine.row_sums(X=Xq), fk.engine.row_sums(X=Xq))
    i1, v1 = fk.engine.topk(k=5, X=Xq)
    i2, v2 = fk2.engine.topk(k=5, X=Xq)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    rows, cols = np.arange(10), np.arange(25)
    assert torch.equal(fk2.engine.kernel_block(rows, cols),
                       fk.engine.kernel_block(rows, cols))
    assert torch.equal(fk2.engine.squared_row_sums(y, n_classes=3, X=Xq),
                       fk.engine.squared_row_sums(y, n_classes=3, X=Xq))
    # the rebuilt forest routes queries identically
    assert torch.equal(fk2.forest.apply(Xq), fk.forest.apply(Xq))


def test_roundtrip_is_bit_identical(snap_setup):
    fk = snap_setup["fk"]
    fk2 = ForestKernel.load(snap_setup["path"], device="cpu")
    assert torch.equal(fk2.engine.q, fk.engine.q)
    assert torch.equal(fk2.engine.w, fk.engine.w)
    assert torch.equal(fk2.ctx.leaves, fk.ctx.leaves)
    assert fk2.ctx.digest() == fk.ctx.digest() == \
        snap_setup["manifest"]["ctx_digest"]
    assert factor_digest(fk2.engine.gl, fk2.engine.q, fk2.engine.w) == \
        snap_setup["manifest"]["factor_digest"]


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_roundtrip_random_query_batches(snap_setup, seed):
    """Property: any OOS batch sees identical predictions pre/post reload."""
    fk, X, y = snap_setup["fk"], snap_setup["X"], snap_setup["y"]
    fk2 = ForestKernel.load(snap_setup["path"], device="cpu")
    rng = np.random.default_rng(seed)
    Xq = X[rng.integers(0, len(X), size=16)] + \
        rng.normal(scale=0.05, size=(16, X.shape[1]))
    Xq = np.ascontiguousarray(Xq)
    assert torch.equal(fk2.engine.predict(y, n_classes=3, X=Xq),
                       fk.engine.predict(y, n_classes=3, X=Xq))


def test_warm_start_skips_weight_recompute(tmp_path, monkeypatch):
    """Loading must not re-run the assignment's (possibly expensive) weight
    computation — factors come from the file."""
    from repro_torch.core import weights as W

    X, y = gaussian_classes(300, d=6, n_classes=2, sep=3.0, seed=3)
    fk = ForestKernel(kernel_method="ih", n_trees=8, seed=0,
                      device="cpu").fit(X, y)
    p = tmp_path / "ih.npz"
    fk.save(p)

    def boom(self, *a, **kw):
        raise AssertionError("weights recomputed on load")

    monkeypatch.setattr(W.InstanceHardness, "reference_weights", boom)
    monkeypatch.setattr(W.InstanceHardness, "query_weights", boom)
    fk2 = ForestKernel.load(p, device="cpu")
    assert (fk2.kernel() != fk.kernel()).nnz == 0


def test_gbt_snapshot_restores_base_score(tmp_path):
    X, y = gaussian_classes(300, d=6, n_classes=2, sep=3.0, seed=9)
    fk = ForestKernel(model_type="gbt", kernel_method="boosted",
                      n_trees=8, seed=0, device="cpu").fit(X, y)
    p = tmp_path / "gbt.npz"
    fk.save(p)
    fk2 = ForestKernel.load(p, device="cpu")
    assert fk2.forest.base_score_ == fk.forest.base_score_
    np.testing.assert_array_equal(fk2.forest.tree_weights_,
                                  fk.forest.tree_weights_)
    Xq = np.ascontiguousarray(X[:20] + 1e-3)
    assert torch.equal(fk2.forest.decision_function(Xq),
                       fk.forest.decision_function(Xq))
    assert torch.equal(fk2.engine.q, fk.engine.q)


def test_v1_dense_factor_archive_loads(snap_setup, tmp_path):
    """A format-v1 archive (dense ``factor_q``/``factor_w``) loads to the
    same kernel, with a migration note."""
    fk = snap_setup["fk"]

    def to_v1(arrays):
        for k in [k for k in arrays if k.startswith("factor_")]:
            del arrays[k]
        arrays["factor_q"] = _np(fk.engine.q)
        arrays["factor_w"] = _np(fk.engine.w)
        manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
        manifest["version"] = 1
        manifest["checksums"] = {k: _checksum(v) for k, v in arrays.items()
                                 if k != "manifest"}
        arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.uint8)

    v1 = _tamper(snap_setup["path"], tmp_path / "v1.npz", to_v1)
    from repro_torch.core import snapshot
    snapshot._v1_migration_noted = False
    with pytest.warns(UserWarning, match="v1"):
        fk2 = load_kernel(v1, device="cpu")
    assert torch.equal(fk2.engine.w, fk.engine.w)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gap", "original", "ih"])
def test_reference_archive_loads_into_the_port(snap_setup, ref_archives,
                                               method):
    ref, path = ref_archives[method]
    port = ForestKernel.load(path, device="cpu")
    assert port.kernel_method == method and port.device == "cpu"
    np.testing.assert_array_equal(_np(port.engine.q), ref.engine.q)
    np.testing.assert_array_equal(_np(port.engine.w), ref.engine.w)
    _ops_agree(port, ref, snap_setup["y"], snap_setup["Xq"])


@pytest.mark.parametrize("method", ["gap", "original", "ih"])
def test_port_archive_loads_into_the_reference(snap_setup, ref_archives,
                                               tmp_path, method):
    ref, path = ref_archives[method]
    port = ForestKernel.load(path, device="cpu")
    out = tmp_path / f"port_{method}.npz"
    manifest = port.save(out)
    assert "device" not in manifest["config"]
    assert manifest["config"]["engine_backend"] == "scipy"
    back = RefKernel.load(out, engine_backend="scipy")
    assert back.engine.backend == "scipy"
    assert back.ctx.digest() == manifest["ctx_digest"]
    np.testing.assert_array_equal(back.engine.w, ref.engine.w)
    _ops_agree(port, back, snap_setup["y"], snap_setup["Xq"])


def test_port_fitted_archive_loads_into_the_reference(snap_setup, tmp_path):
    """An archive of a kernel the port fitted itself reads in the
    reference, whose scipy ops then agree with the port's."""
    fk = snap_setup["fk"]
    back = RefKernel.load(snap_setup["path"], engine_backend="scipy")
    np.testing.assert_array_equal(back.engine.q, _np(fk.engine.q))
    np.testing.assert_array_equal(back.ctx.leaves, _np(fk.ctx.leaves))
    _ops_agree(fk, back, snap_setup["y"], snap_setup["Xq"])


@pytest.mark.parametrize("method", ["gap", "original", "ih"])
def test_digests_equal_across_packages(snap_setup, ref_archives, method):
    """For the same forest the two packages give the same context and
    factor digest strings."""
    ref, path = ref_archives[method]
    port = ForestKernel.load(path, device="cpu")
    assert port.ctx.digest() == ref.ctx.digest()
    assert factor_digest(port.engine.gl, port.engine.q, port.engine.w) == \
        ref_factor_digest(ref.engine.gl, ref.engine.q, ref.engine.w)


def test_float32_archive_refused(ref_archives, tmp_path):
    _, path = ref_archives["gap"]

    def to_f32(arrays):
        manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
        manifest["config"]["dtype"] = "float32"
        arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.uint8)

    bad = _tamper(path, tmp_path / "f32.npz", to_f32)
    with pytest.raises(SnapshotError, match="float32"):
        load_kernel(bad, device="cpu")


def test_out_of_core_settings_load_in_memory(ref_archives, snap_setup,
                                             tmp_path):
    """An archive that records a scratch directory and a memory budget
    loads with both honoured (the kernel keeps them and its engine is
    built under the budget, its factors spilled to the scratch directory
    when they exceed it), with the same answers; the settings cross back
    into the reference through the port's own archive."""
    ref, path = ref_archives["gap"]
    scratch = str(tmp_path / "scratch")

    def ooc(arrays):
        manifest = json.loads(bytes(arrays["manifest"].tobytes()).decode())
        manifest["config"].update(scratch_dir=scratch,
                                  memory_budget_bytes=1 << 10)
        arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                           dtype=np.uint8)

    port = load_kernel(_tamper(path, tmp_path / "ooc.npz", ooc),
                       device="cpu")
    assert port.scratch_dir == scratch
    assert port.memory_budget_bytes == 1 << 10
    assert port.engine.memory_budget_bytes == 1 << 10
    assert port.engine.memory_bytes()["budget"] == 1 << 10
    # past the budget, the CSR factors live in unlinked scratch memmaps
    assert isinstance(port.engine.Q.data, np.memmap)
    assert os.listdir(scratch) == []
    _ops_agree(port, ref, snap_setup["y"], snap_setup["Xq"])
    again = tmp_path / "again.npz"
    save_kernel(port, again)
    back = RefKernel.load(again, engine_backend="scipy")
    assert back.scratch_dir == scratch
    assert back.memory_budget_bytes == 1 << 10


# ---------------------------------------------------------------------------
# rejection paths
# ---------------------------------------------------------------------------

def test_corrupted_array_rejected(snap_setup, tmp_path):
    def flip(arrays):
        a = arrays["factor_q_data"].copy()
        a.flat[0] += 1.0
        arrays["factor_q_data"] = a

    bad = _tamper(snap_setup["path"], tmp_path / "bad.npz", flip)
    with pytest.raises(SnapshotError, match="checksum mismatch"):
        load_kernel(bad, device="cpu")


def test_missing_array_rejected(snap_setup, tmp_path):
    bad = _tamper(snap_setup["path"], tmp_path / "missing.npz",
                  lambda arrays: arrays.pop("factor_q_data"))
    with pytest.raises(SnapshotError, match="missing array"):
        load_kernel(bad, device="cpu")


def test_version_mismatch_rejected(snap_setup, tmp_path):
    bad = _tamper(snap_setup["path"], tmp_path / "ver.npz",
                  lambda a: _edit_manifest(a, version=SNAPSHOT_VERSION + 1))
    with pytest.raises(SnapshotError, match="version"):
        load_kernel(bad, device="cpu")


def test_foreign_format_rejected(snap_setup, tmp_path):
    bad = _tamper(snap_setup["path"], tmp_path / "fmt.npz",
                  lambda a: _edit_manifest(a, format="something-else"))
    with pytest.raises(SnapshotError, match="format"):
        load_kernel(bad, device="cpu")

    plain = tmp_path / "plain.npz"
    np.savez(plain, a=np.arange(3))
    with pytest.raises(SnapshotError, match="manifest"):
        load_kernel(plain, device="cpu")


def test_digest_mismatch_rejected(snap_setup, tmp_path):
    """A rebuild that no longer reproduces the saved context or factors is
    refused."""
    for key in ("ctx_digest", "factor_digest"):
        bad = _tamper(snap_setup["path"], tmp_path / f"{key}.npz",
                      lambda a: _edit_manifest(a, **{key: "0" * 64}))
        with pytest.raises(SnapshotError, match="digest mismatch"):
            load_kernel(bad, device="cpu")


def test_unfitted_kernel_refuses_to_save(tmp_path):
    fk = ForestKernel(n_trees=4, device="cpu")
    with pytest.raises(ValueError, match="fit"):
        fk.save(tmp_path / "nope.npz")
