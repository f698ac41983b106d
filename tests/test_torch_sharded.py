"""The port's sharded SWLC product against the reference's.

``repro_torch.core.torch_ops.sharded_swlc_matmat`` runs the reference's
``jax_ops.sharded_swlc_matmat`` (rows over the data axis, trees over the
model axis, a bucket sum over data and an output sum over model) in one
process over a grid of torch devices.  Here every cell is
``torch.device("cpu")``; the reference runs on an 8-host-device jax mesh
in a subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
``jax_enable_x64``), calling ``jax_ops`` directly because the reference
engine's jax backend does not import on this jax.  Both are held in
float64 at atol 1e-12, against each other and against the port's segment
product, on grids (1, 1), (2, 1), (1, 2), (2, 2) and (4, 1).

The engine's gate is the reference's: a train-state product takes the
sharded path when ``default_mesh()`` is a grid whose data axis divides the
training rows (and, in the port, whose devices are of the engine's type);
OOS batches take the segment path; ``last_matmat_path`` says which.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import jax_ops as ref_ops
from repro_torch.core import torch_ops
from repro_torch.core.api import ForestKernel
from repro_torch.data.synthetic import gaussian_classes
from repro_torch.obs.metrics import (MetricsRegistry, global_registry,
                                     set_global_registry)

GRIDS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1)]
ATOL = 1e-12
CPU = torch.device("cpu")


def _grid(dp, mp, dev=CPU):
    mesh = np.empty((dp, mp), dtype=object)
    for a in range(dp):
        for b in range(mp):
            mesh[a, b] = dev
    return mesh


@pytest.fixture(scope="module")
def fk():
    """A port kernel on the CPU: 200 training rows (divisible by 4) and 10
    trees (divisible by 2)."""
    X, y = gaussian_classes(240, d=8, n_classes=3, seed=5)
    return ForestKernel(kernel_method="gap", n_trees=10, seed=0,
                        device="cpu").fit(X[:200], y[:200]), X[200:]


@pytest.fixture(scope="module")
def inputs(fk):
    k, _ = fk
    e = k.engine
    V = np.random.default_rng(0).normal(size=(e.n_ref, 5))
    return {"gl": e.gl.numpy(), "q": e.q.numpy(), "w": e.w.numpy(), "V": V,
            "L": e.total_leaves}


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The reference's sharded product on each grid, and whether it raises
    on an uneven split, from one subprocess with 8 host devices."""
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "in.npz", gl=inputs["gl"], q=inputs["q"], w=inputs["w"],
             V=inputs["V"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(repo, "src"))
    code = textwrap.dedent(f"""
        import json
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import Mesh
        from repro.core import jax_ops
        z = np.load({str(d / "in.npz")!r})
        gl, q, w, V = (jnp.asarray(z[k]) for k in ("gl", "q", "w", "V"))
        out = {{}}
        for dp, mp in {GRIDS!r}:
            mesh = Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp),
                        ("data", "model"))
            out[f"{{dp}}x{{mp}}"] = np.asarray(jax_ops.sharded_swlc_matmat(
                mesh, gl, q, w, V, {inputs["L"]}))
        raised = {{}}
        for name, (dp, mp, n) in {{"rows": (3, 1, 200),
                                   "trees": (1, 3, 200)}}.items():
            mesh = Mesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp),
                        ("data", "model"))
            try:
                jax_ops.sharded_swlc_matmat(mesh, gl[:n], q[:n], w[:n],
                                            V[:n], {inputs["L"]})
                raised[name] = False
            except Exception:
                raised[name] = True
        np.savez({str(d / "out.npz")!r}, **out)
        print(json.dumps({{"devices": jax.device_count(),
                          "raised": raised}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["devices"] == 8
    with np.load(d / "out.npz") as z:
        return {k: z[k] for k in z.files}, info["raised"]


def _port(inputs, mesh, dtype=torch.float64):
    t = {k: torch.as_tensor(inputs[k]) for k in ("gl", "q", "w", "V")}
    return torch_ops.sharded_swlc_matmat(
        mesh, t["gl"], t["q"].to(dtype), t["w"].to(dtype), t["V"].to(dtype),
        inputs["L"])


@pytest.mark.parametrize("dp,mp", GRIDS)
def test_sharded_matches_reference(inputs, reference, dp, mp):
    got = _port(inputs, _grid(dp, mp))
    assert got.dtype == torch.float64 and got.device == CPU
    np.testing.assert_allclose(got.numpy(), reference[0][f"{dp}x{mp}"],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("dp,mp", GRIDS)
def test_sharded_matches_segment_product(inputs, dp, mp):
    """Against the port's own segment product; and a grid whose cells are
    all one CPU device gives the same bits on every run."""
    t = {k: torch.as_tensor(inputs[k]) for k in ("gl", "q", "w", "V")}
    want = torch_ops.swlc_matmat(t["gl"], t["q"], t["w"], t["V"],
                                 inputs["L"])
    got = _port(inputs, _grid(dp, mp))
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(_port(inputs, _grid(dp, mp)), got)


def test_sharded_float32(inputs):
    """Float32 factors stay float32, within 1e-5 of the largest value of
    the float64 product."""
    got = _port(inputs, _grid(2, 2), torch.float32)
    want = _port(inputs, _grid(1, 1))
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * scale)


def test_uneven_splits_raise_as_in_the_reference(inputs, reference):
    _, raised = reference
    assert raised == {"rows": True, "trees": True}
    with pytest.raises(ValueError, match="split evenly"):
        _port(inputs, _grid(3, 1))
    with pytest.raises(ValueError, match="split evenly"):
        _port(inputs, _grid(1, 3))
    with pytest.raises(ValueError, match="2-D grid"):
        _port(inputs, np.array([CPU, CPU], dtype=object))


@pytest.mark.parametrize("n_local,T,C", [(100, 10, 5), (25_000, 100, 7),
                                         (25_000, 100, 64), (50_000, 100, 1),
                                         (1, 1, 1 << 25), (10 ** 6, 40, 3),
                                         (4096, 4096, 2)])
def test_auto_c_chunk_equals_reference(n_local, T, C):
    assert torch_ops.auto_c_chunk(n_local, T, C) == \
        ref_ops.auto_c_chunk(n_local, T, C)


def test_default_mesh(monkeypatch):
    """None without two cards (this CPU); an (n, 1) grid of the cards
    with them."""
    assert torch_ops.default_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_ops.default_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = torch_ops.default_mesh()
    assert mesh.shape == (3, 1)
    assert [d for d in mesh[:, 0]] == [torch.device("cuda", i)
                                       for i in range(3)]


@pytest.fixture
def fresh_registry():
    old = global_registry()
    reg = MetricsRegistry()
    set_global_registry(reg)
    try:
        yield reg
    finally:
        set_global_registry(old)


def _calls(reg):
    return reg.counter("engine_op_calls_total", "engine op invocations",
                       labels=("op", "backend", "tier")).labels(
        op="sharded_matmat", backend="cpu", tier="").value


def test_engine_gate(fk, monkeypatch, fresh_registry):
    """Segment on one device; with ``default_mesh`` a CPU grid, train-state
    products (matmat, matvec, row sums, predict) go sharded with the
    segment path's answers and are counted, OOS batches stay on the
    segment path, and a grid that does not divide the rows, or of another
    device type, is not used."""
    k, Xq = fk
    e = k.engine
    V = np.random.default_rng(1).normal(size=(e.n_ref, 3))
    y = k.ctx.y
    want = e.matmat(V)
    assert e.last_matmat_path == "segment"
    want_rs, want_pred = e.row_sums().clone(), e.predict(y, 3)
    want_oos = e.matmat(V, X=Xq)
    e._train_row_sums = None

    monkeypatch.setattr(torch_ops, "default_mesh", lambda: _grid(2, 1))
    got = e.matmat(V)
    assert e.last_matmat_path == "sharded"
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    torch.testing.assert_close(e.matvec(V[:, 0]), want[:, 0], rtol=0,
                               atol=ATOL)
    torch.testing.assert_close(e.row_sums(), want_rs, rtol=0, atol=ATOL)
    torch.testing.assert_close(e.predict(y, 3), want_pred, rtol=0,
                               atol=ATOL)
    assert _calls(fresh_registry) == 4
    hist = fresh_registry.histogram(
        "engine_op_seconds", "engine op latency (s)",
        labels=("op", "backend", "tier")).labels(
        op="sharded_matmat", backend="cpu", tier="")
    assert hist.count == 4
    torch.testing.assert_close(e.matmat(V, X=Xq), want_oos, rtol=0,
                               atol=ATOL)
    assert e.last_matmat_path == "segment"

    monkeypatch.setattr(torch_ops, "default_mesh", lambda: _grid(3, 1))
    e.matmat(V)
    assert e.last_matmat_path == "segment"       # 200 rows over 3
    monkeypatch.setattr(torch_ops, "default_mesh",
                        lambda: _grid(2, 1, torch.device("cuda", 0)))
    e.matmat(V)
    assert e.last_matmat_path == "segment"       # a CPU engine stays put
    e._train_row_sums = None


def test_engine_sharded_column_blocks(fk, monkeypatch):
    """Wide V goes in ``auto_c_chunk`` column blocks, inside the budget's
    own column blocks, with the whole product's answers."""
    k, _ = fk
    e = k.engine
    V = np.random.default_rng(2).normal(size=(e.n_ref, 11))
    want = e.matmat(V)
    monkeypatch.setattr(torch_ops, "default_mesh", lambda: _grid(2, 1))
    widths = []
    real = torch_ops.sharded_swlc_matmat

    def spy(mesh, gl, q, w, Vc, L):
        widths.append(Vc.shape[1])
        return real(mesh, gl, q, w, Vc, L)

    monkeypatch.setattr(torch_ops, "sharded_swlc_matmat", spy)
    monkeypatch.setattr(torch_ops, "auto_c_chunk", lambda *a, **kw: 3)
    torch.testing.assert_close(e.matmat(V), want, rtol=0, atol=ATOL)
    assert widths == [3, 3, 3, 2]
    widths.clear()
    monkeypatch.setattr(e, "memory_budget_bytes", 2 * 8 * e.total_leaves * 5)
    torch.testing.assert_close(e.matmat(V), want, rtol=0, atol=ATOL)
    assert widths == [3, 2, 3, 2, 1]             # budget blocks 5 + 5 + 1
