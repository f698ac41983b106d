"""The port's dry-run tools (``repro_torch.launch.inputs``, ``.dryrun``)
against the reference's.

* ``input_specs`` against the reference's ``ShapeDtypeStruct``s for every
  arch × applicable shape (names, shapes, dtypes; the caches' keys).
* The reference test's own cell (granite_8b reduced as in
  ``tests/test_distributed.py``'s dry-run test, on a (4, 4) mesh where
  every sharded dim divides): train, prefill and decode traced by the port
  in a fake 16-rank world, against the reference's compiled cell in a jax
  subprocess with 16 host devices.  ``argument_size`` equals XLA's
  ``argument_size_in_bytes``; ``tc_flops`` is within 2% (prefill, decode)
  and 5% (train) of ``analyze_hlo``'s.  (Both were equal when this was
  written.)
* Each arch with its published head, KV-head, SSM-head, expert and vocab
  counts at tiny widths, train, prefill and decode traced on the (16, 16)
  and (2, 16, 16) production meshes: the guard for head counts that do
  not divide the model axis (8 KV heads at tp = 16, hymba's 25 heads).
* ``main`` writes one record with the documented keys and exits nonzero
  when a cell fails; the tool refuses a real world.

Every world is built in a subprocess (``tests/_torch_dryrun_cells.py``),
the subprocesses of one fixture started together.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.launch import inputs as ref_inputs
from repro_torch.configs.base import (ALL_ARCHS, SHAPES, applicable_shapes,
                                      get_config)
from repro_torch.launch import inputs

import _torch_dryrun_cells as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600          # seconds a subprocess may take
TOL = {"train": 0.05, "prefill": 0.02, "decode": 0.02}
RECORD_KEYS = {"ok", "arch", "shape", "mesh", "n_devices", "params",
               "trace_s", "tc_flops", "tc_hbm_bytes", "collectives",
               "tc_collective_total", "memory"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute", "count", "total"}
MEMORY_KEYS = {"argument_size", "output_size", "temp_size",
               "generated_code_size"}
CELLS = [(a, c.name) for a in ALL_ARCHS
         for c in applicable_shapes(get_config(a))]
MESHES = {"16x16": False, "2x16x16": True}
# processes a mesh the tiny archs split over (a (2, 16, 16) train step
# traces ~4x slower than a (16, 16) one)
GROUPS = {"16x16": 2, "2x16x16": 4}


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]),
                **extra)


def _start(d, name, spec):
    path = d / f"{name}.json"
    spec = dict(spec, out=str(d / f"{name}.out.json"))
    path.write_text(json.dumps(spec))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_dryrun_cells.py"),
         str(path)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, spec["out"]


def _finish(proc, out, what):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"{what} timed out:\n{stderr[-3000:]}")
    assert proc.returncode == 0, \
        f"{what}:\nstdout:\n{stdout[-2000:]}\nstderr:\n{stderr[-4000:]}"
    if out is None:
        return stdout
    with open(out) as f:
        return json.load(f)


def _same_dtype(t: torch.Tensor, ref) -> bool:
    return str(t.dtype).replace("torch.", "") == str(np.dtype(ref.dtype))


# ------------------------------------------------------------ input_specs
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    port = inputs.input_specs(get_config(arch), SHAPES[shape])
    ref = ref_inputs.input_specs(ref_base.get_config(arch),
                                 ref_base.SHAPES[shape])
    assert sorted(port) == sorted(ref)
    flat = dict(port.get("batch", {}), **port.get("cache", {}))
    want = dict(ref.get("batch", {}), **ref.get("cache", {}))
    for k in ("token", "pos"):
        if k in port:
            flat[k], want[k] = port[k], ref[k]
    assert sorted(flat) == sorted(want)
    for k, t in flat.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _same_dtype(t, want[k]), (k, t.dtype, want[k].dtype)
        assert t.device.type == "meta", k


# ------------------------------------------------- the reference's cell
REF_CODE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_config
    from repro.distributed.logical import axis_env
    from repro.distributed.sharding import (_batch_axes_for, batch_specs,
                                            cache_specs, param_specs,
                                            with_named_sharding)
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.inputs import batch_struct
    from repro.launch.mesh import compat_mesh
    from repro.models import lm
    from repro.train.steps import (abstract_train_state, make_decode_step,
                                   make_prefill_step, make_train_step)

    spec = json.loads(sys.argv[1])
    cfg = dataclasses.replace(get_config("granite_8b"), **spec["cfg"])
    B, S, chunk = spec["B"], spec["S"], spec["chunk"]
    mesh = compat_mesh((4, 4), ("data", "model"))
    out = {}

    def record(kind, c):
        out[kind] = {"argument_size":
                     c.memory_analysis().argument_size_in_bytes,
                     "flops": analyze_hlo(c.as_text()).flops}

    with mesh, axis_env(mesh):
        bs = batch_specs(mesh)
        batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype,
                                         sharding=NamedSharding(mesh, bs[k]))
                 for k, v in batch_struct(cfg, B, S).items()}
        st = abstract_train_state(cfg)
        ps = param_specs(st["params"], mesh)
        st = {"params": with_named_sharding(st["params"], ps, mesh),
              "opt": {"m": with_named_sharding(st["opt"]["m"], ps, mesh),
                      "v": with_named_sharding(st["opt"]["v"], ps, mesh),
                      "step": jax.ShapeDtypeStruct((), jnp.int32)}}
        record("train", jax.jit(make_train_step(cfg, attn_chunk=chunk),
                                donate_argnums=(0,)).lower(st, batch)
               .compile())
        params = with_named_sharding(lm.abstract_params(cfg), ps, mesh)
        record("prefill", jax.jit(make_prefill_step(cfg, attn_chunk=chunk))
               .lower(params, batch).compile())
        cache = lm.abstract_cache(cfg, B, S)
        cache = with_named_sharding(cache, cache_specs(cfg, cache, mesh),
                                    mesh)
        token = jax.ShapeDtypeStruct(
            (B, 1), jnp.int32,
            sharding=NamedSharding(mesh, P(_batch_axes_for(mesh, B), None)))
        record("decode", jax.jit(make_decode_step(cfg), donate_argnums=(2,))
               .lower(params, token, cache,
                      jax.ShapeDtypeStruct((), jnp.int32)).compile())
    print("REF", json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world of this file at once: the port's (4, 4) cell, the
    reference's compiled cell, and the tiny cells of each production mesh
    (``GROUPS[mesh]`` processes a mesh)."""
    d = tmp_path_factory.mktemp("dryrun")
    spec = {"cfg": C.SMALL, "B": C.SMALL_B, "S": C.SMALL_S,
            "chunk": C.SMALL_CHUNK}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE, json.dumps(spec)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=16"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _start(d, "small", {"task": "small"})
    tiny = {(mesh, g): _start(d, f"{mesh}_{g}", {
        "task": "tiny", "archs": ALL_ARCHS[g::GROUPS[mesh]],
        "multi_pod": multi_pod})
        for mesh, multi_pod in MESHES.items() for g in range(GROUPS[mesh])}
    out = {"small": _finish(*port, "the port's (4, 4) cell")}
    line = next(l for l in _finish(ref, None, "the reference's cell")
                .splitlines() if l.startswith("REF "))
    out["ref"] = json.loads(line[4:])
    out["tiny"] = {}
    for (mesh, g), started in tiny.items():
        recs = _finish(*started, f"tiny cells {mesh} {g}")
        out["tiny"].update({f"{mesh}/{k}": v for k, v in recs.items()})
    return out


@pytest.fixture(scope="module")
def small_cell(runs):
    """The port's records of the reference's cell and the reference's
    compiled numbers."""
    return runs["small"], runs["ref"]


@pytest.mark.parametrize("kind", C.KINDS)
def test_small_cell_matches_reference(small_cell, kind):
    got, ref = small_cell
    rec = got[kind]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "4x4" and rec["n_devices"] == 16
    assert rec["memory"]["argument_size"] == ref[kind]["argument_size"]
    gap = abs(rec["tc_flops"] - ref[kind]["flops"]) / ref[kind]["flops"]
    assert gap <= TOL[kind], (rec["tc_flops"], ref[kind]["flops"])


def test_small_cell_counts_are_per_rank(small_cell):
    """A (4, 4) cell's train step gathers weights and reduce-scatters
    gradients (FSDP), allocates beyond its arguments, and returns its
    (donated) state."""
    rec = small_cell[0]["train"]
    mem = rec["memory"]
    assert mem["temp_size"] > 0 and mem["generated_code_size"] == 0
    batch = 2 * 4 * (C.SMALL_B // 4) * C.SMALL_S   # int32 tokens + labels
    assert mem["output_size"] >= mem["argument_size"] - batch
    coll = rec["collectives"]
    assert coll["count"] > 0 and coll["total"] == rec["tc_collective_total"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert rec["tc_hbm_bytes"] > 0


# ------------------------------------- published counts at tiny widths
@pytest.fixture(scope="module")
def tiny_cells(runs):
    return runs["tiny"]


@pytest.mark.parametrize("kind", C.KINDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_published_counts_trace_on_production_meshes(tiny_cells, mesh,
                                                     arch, kind):
    rec = tiny_cells[f"{mesh}/{arch}/{kind}"]
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == mesh
    assert rec["n_devices"] == (512 if MESHES[mesh] else 256)
    assert rec["tc_flops"] > 0 and rec["memory"]["argument_size"] > 0


def test_tiny_configs_keep_published_counts():
    for arch in ALL_ARCHS:
        pub, tiny = get_config(arch), C.tiny_config(arch)
        keys = ("n_heads", "n_kv_heads", "n_experts", "top_k", "vocab") \
            + (("ssm_heads",) if pub.ssm_state else ())
        for k in keys:
            assert getattr(tiny, k) == getattr(pub, k), (arch, k)
        assert tiny.d_model <= 320 and tiny.n_layers == 2


# ------------------------------------------------------------------ main
def _main(args, d):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(d)], env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT)


def test_main_writes_one_record(tmp_path):
    r = _main(["--arch", "granite_8b", "--shape", "decode_32k"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK   granite_8b" in r.stdout
    files = os.listdir(tmp_path)
    assert files == ["granite_8b__decode_32k__16x16.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert set(rec) == RECORD_KEYS
    assert set(rec["collectives"]) == COLLECTIVE_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["params"] == get_config("granite_8b").param_count()


def test_main_both_meshes_runs_each_in_its_own_world(tmp_path):
    r = _main(["--arch", "granite_8b", "--shape", "decode_32k",
               "--both-meshes"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(os.listdir(tmp_path)) == [
        "granite_8b__decode_32k__16x16.json",
        "granite_8b__decode_32k__2x16x16.json"]
    big = json.loads(
        (tmp_path / "granite_8b__decode_32k__2x16x16.json").read_text())
    assert big["ok"] and big["n_devices"] == 512


def test_main_fails_on_a_failed_cell(tmp_path):
    """long_500k is refused for a pure full-attention arch, as the
    reference's ``lower_cell`` refuses it."""
    r = _main(["--arch", "granite_8b", "--shape", "long_500k"], tmp_path)
    assert r.returncode != 0
    assert "1 cells failed" in r.stderr
    assert "FAIL granite_8b" in r.stdout
    rec = json.loads(
        (tmp_path / "granite_8b__long_500k__16x16.json").read_text())
    assert not rec["ok"] and "ValueError" in rec["error"]
    assert "traceback" in rec


def test_dryrun_refuses_a_real_world(tmp_path):
    code = textwrap.dedent(f"""
        import torch.distributed as dist
        from repro_torch.launch import dryrun
        dist.init_process_group("gloo", init_method="file://{tmp_path}/s",
                                rank=0, world_size=1)
        try:
            dryrun.fake_world(256)
        except RuntimeError as e:
            print("REFUSED", e)
    """)
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert "REFUSED the dry run needs its own fake world" in r.stdout, \
        r.stderr[-2000:]
