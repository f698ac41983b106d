"""The port's sharded LM path in multi-process gloo worlds on the CPU.

Each world is ``tests/_torch_dist_worker.py`` in a subprocess, one
process a rank, rendezvoused through a ``FileStore`` under ``tmp_path`` (no
port is opened, so parallel test workers cannot collide), each with its own
timeout.  One world a grid:

* every grid: the sharded train step against the one-device step in
  float32 (bf16 on (2, 1));
* (1, 1), its own world: the bf16 train step on a one-rank mesh equals
  one device's bit for bit (the same local kernels);
* (1, 4), its own world: tp = 4 with 6 heads and 2 KV heads (heads that
  do not divide the model axis, KV heads below it), the float32 train
  step and two flash-decode steps (granite_8b and hymba reduced) against
  one device;
* (2, 2): the int8 round trip on sharded gradients and a checkpoint save;
* (1, 2) and (2, 1): that checkpoint restored onto the grid (placements
  of the like-state, and the reference's ``shardings=``), and
  ``launch/train.py --data-par/--model-par``; (1, 2) also runs the padded
  forward and loss at tp = 2 on odd widths (5 heads, 5 KV heads, vocab
  257, 5 experts), with the padding on and off.

The worlds run at the same time; the restoring ones wait for the (2, 2)
world's checkpoint.

The reference runs the same padded computations at tp = 2 on an
8-host-device (4, 2) mesh in a jax subprocess, loads the port's archive and
writes one of its own for the port.  Float32 parity: loss, grad norm and
every gradient within 1e-5 of the leaf's largest; parameters after the
AdamW step within 1e-5 of the leaf's largest where the gradient is decided
(|g| at least 1e-4 of the leaf's largest: the first step moves each element
by about lr·sign(g), so a gradient at the rounding floor may move either
way) and within the reference test's own bounds (rtol 2e-2, atol 2e-3)
everywhere.  bf16 uses the reference's tolerances.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_dist_worker as W
from _torch_lm import compute_dtype
from repro_torch.launch import train as port_launch
from repro_torch.models import lm
from repro_torch.models.convert import params_to_reference
from repro_torch.train import checkpoint, steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [(2, 2), (1, 2), (2, 1)]
TIMEOUT = 300          # seconds a world may take, start-up included
F32 = 1e-5
DECIDED = 1e-4
PAD_TOL = 1e-4


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                            os.path.join(REPO, "tests")]))


def _start_world(d, grid, ckpt, task="grid"):
    out = d / f"{task}_{grid[0]}x{grid[1]}"
    out.mkdir()
    spec = {"task": task, "grid": list(grid), "store": str(out / "store"),
            "timeout": TIMEOUT - 60, "out": str(out), "ckpt": str(ckpt)}
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
         str(path)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, out


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
    with np.load(out / "res.npz") as z:
        res = {k: z[k] for k in z.files}
    meta = json.loads((out / "meta.json").read_text())
    return res, meta


REF_CODE = textwrap.dedent("""
    import dataclasses, json, os, sys, time
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import get_config
    from repro.models import lm
    from repro.distributed.logical import axis_env, perf_env
    from repro.launch.mesh import compat_mesh
    from repro.train.checkpoint import restore_checkpoint, save_checkpoint
    from repro.train.optimizer import AdamWConfig
    from repro.train.steps import (abstract_train_state, init_train_state,
                                   make_train_step)

    spec = json.load(open(sys.argv[1]))
    out = {}
    mesh = compat_mesh((4, 2), ("data", "model"))
    lm.COMPUTE_DTYPE = jnp.float32
    for kind, (arch, over) in spec["odd"].items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        params = {}
        with np.load(spec["params"][kind]) as z:
            for key in z.files:
                node = params
                *path, leaf = key.split("::")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(z[key])
        tok = jnp.asarray(np.load(spec["tokens"][kind]))
        for pad, flags in (("pad", {}),
                           ("nopad", {"head_pad": False,
                                      "expert_pad": False})):
            with mesh, axis_env(mesh), perf_env(**flags):
                logits, aux = jax.jit(lambda p, t: lm.forward(
                    p, cfg, t, attn_chunk=16, remat=False))(params, tok)
                loss = jax.jit(lambda p, t: lm.loss_fn(
                    p, cfg, t, t, attn_chunk=16, remat=False))(params, tok)
            out[f"{kind}/{pad}/logits"] = np.asarray(logits)
            out[f"{kind}/{pad}/aux"] = np.asarray(aux)
            out[f"{kind}/{pad}/loss"] = np.asarray(loss)
    lm.COMPUTE_DTYPE = jnp.bfloat16
    # the port's archive, read by the reference (once the port wrote it)
    deadline = time.time() + spec["timeout"]
    while not os.path.exists(os.path.join(spec["port_ckpt"], "LATEST")):
        assert time.time() < deadline, "no port checkpoint"
        time.sleep(0.2)
    cfg = get_config("granite_8b").reduced()
    got = restore_checkpoint(spec["port_ckpt"], abstract_train_state(cfg))
    for kp, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        key = "::".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        out["port_in_ref/" + key] = np.asarray(leaf)
    # an archive of the reference's, for the port
    state = init_train_state(cfg, jax.random.PRNGKey(0))
    tok = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, cfg.vocab)
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                     schedule="const")
    state, _ = jax.jit(make_train_step(cfg, oc, attn_chunk=16))(
        state, {"tokens": tok, "labels": tok})
    save_checkpoint(spec["ref_ckpt"], 1, state)
    np.savez(spec["out"], **out)
    print("REF OK")
""")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's results and the reference's, all run at once (the
    restoring worlds and the reference wait for (2, 2)'s checkpoint)."""
    d = tmp_path_factory.mktemp("worlds")
    ckpt = d / "ckpt22"
    started = {g: _start_world(d, g, ckpt) for g in GRIDS}
    started["tp4"] = _start_world(d, (1, 4), ckpt, task="tp4")
    started["one"] = _start_world(d, (1, 1), ckpt, task="one")
    # the odd configs' parameters and tokens for the reference, meanwhile
    spec = {"odd": W.ODD, "params": {}, "tokens": {},
            "port_ckpt": str(ckpt), "ref_ckpt": str(d / "ref_ckpt"),
            "out": str(d / "ref.npz"), "timeout": TIMEOUT - 60}
    for kind in W.ODD:
        cfg = W.odd_config(kind)
        tree = params_to_reference(lm.init_params(cfg, 0, device="cpu"))
        flat = checkpoint._flatten(tree)
        spec["params"][kind] = str(d / f"params_{kind}.npz")
        np.savez(spec["params"][kind], **flat)
        spec["tokens"][kind] = str(d / f"tokens_{kind}.npy")
        np.save(spec["tokens"][kind], W.tokens_for(cfg.vocab, seed=3).numpy())
    (d / "ref_spec.json").write_text(json.dumps(spec))
    results = {}
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(d / "ref_spec.json")],
        env=dict(_env(),
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for g, (p, o) in started.items():
        results[g] = _finish(p, o, f"world {g}")
    assert "REF OK" in _finish(ref, None, "the reference's subprocess")
    with np.load(spec["out"]) as z:
        results["ref"] = {k: z[k] for k in z.files}
    results["ckpt"] = ckpt
    results["ref_ckpt"] = d / "ref_ckpt"
    return results


def _names(res, prefix):
    return sorted(k[len(prefix):] for k in res if k.startswith(prefix))


# ------------------------------------------------------------ step parity
def _check_f32_step(res):
    l1, l2 = res["f32/loss"]
    assert abs(l1 - l2) <= F32 * abs(l1)
    n1, n2 = res["f32/gnorm"]
    assert abs(n1 - n2) <= F32 * n1
    for n in _names(res, "f32/g1/"):
        g1, g2 = res[f"f32/g1/{n}"], res[f"f32/g2/{n}"]
        assert np.abs(g1 - g2).max() <= F32 * np.abs(g1).max(), n
        p1, p2 = res[f"f32/p1/{n}"], res[f"f32/p2/{n}"]
        decided = np.abs(g1) >= DECIDED * np.abs(g1).max()
        assert np.abs(p1 - p2)[decided].max(initial=0) \
            <= F32 * np.abs(p1).max(), n
        np.testing.assert_allclose(p2, p1, rtol=2e-2, atol=2e-3, err_msg=n)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_sharded_train_step_matches_one_device_f32(worlds, grid):
    res, meta = worlds[grid]
    _check_f32_step(res)
    # the leaves were really sharded on the grid's axes
    placed = meta["placements"]
    if grid[1] > 1:
        assert "Shard(dim=1)" in placed["layers.0.attn.wq"]
    if grid[0] > 1:
        assert placed["layers.0.attn.wq"].startswith("(Shard(dim=0)")


def test_sharded_train_step_matches_one_device_f32_tp4(worlds):
    """6 heads and 2 KV heads at tp = 4: the heads replicate over the model
    axis before each projection's split, the attention runs on 8 padded
    heads, and the step still equals one device's."""
    res, meta = worlds["tp4"]
    _check_f32_step(res)
    placed = meta["placements"]
    assert "Shard(dim=1)" not in placed["layers.0.attn.wq"]
    assert "Shard(dim=1)" not in placed["layers.0.attn.wk"]
    assert "Shard(dim=1)" in placed["layers.0.mlp.w_gate"]


@pytest.mark.parametrize("arch", ["granite_8b", "hymba_1p5b"])
def test_flash_decode_matches_one_device_tp4(worlds, arch):
    """Two decode steps with the cache's sequence split over 4 ranks: the
    logits, and every cache leaf written in place (the new keys and values
    land in the rank that holds their slot)."""
    res, _ = worlds["tp4"]
    pre = f"decode/{arch}/"
    for i in range(2):
        l1, l2 = res[f"{pre}logits1/{i}"], res[f"{pre}logits2/{i}"]
        assert np.abs(l1 - l2).max() <= F32 * np.abs(l1).max(), i
    names = _names(res, f"{pre}cache1/")
    assert names
    for k in names:
        c1, c2 = res[f"{pre}cache1/{k}"], res[f"{pre}cache2/{k}"]
        assert np.abs(c1 - c2).max() <= F32 * np.abs(c1).max(), k


@pytest.mark.parametrize("arch", ["granite_8b", "hymba_1p5b"])
def test_one_rank_mesh_train_step_is_one_device_bit_for_bit(worlds, arch):
    res, _ = worlds["one"]
    pre = f"{arch}/"
    np.testing.assert_array_equal(res[pre + "loss"][0], res[pre + "loss"][1])
    np.testing.assert_array_equal(res[pre + "gnorm"][0],
                                  res[pre + "gnorm"][1])
    names = _names(res, pre + "p1/")
    assert names
    for n in names:
        np.testing.assert_array_equal(res[f"{pre}g2/{n}"],
                                      res[f"{pre}g1/{n}"], err_msg=n)
        np.testing.assert_array_equal(res[f"{pre}p2/{n}"],
                                      res[f"{pre}p1/{n}"], err_msg=n)


def test_sharded_train_step_matches_one_device_bf16(worlds):
    res, _ = worlds[(2, 1)]
    l1, l2 = res["bf16/loss"]
    assert abs(l1 - l2) < 2e-2
    for n in _names(res, "bf16/p1/"):
        np.testing.assert_allclose(res[f"bf16/p2/{n}"], res[f"bf16/p1/{n}"],
                                   rtol=2e-2, atol=2e-3, err_msg=n)


def test_int8_round_trip_on_sharded_grads_is_the_one_device_one(worlds):
    """Block scales come from the whole stacked leaf, not a shard."""
    res, _ = worlds[(2, 2)]
    names = _names(res, "int8/plain/")
    assert names
    for n in names:
        np.testing.assert_array_equal(res[f"int8/sharded/{n}"],
                                      res[f"int8/plain/{n}"], err_msg=n)


# -------------------------------------------------------- re-sharded restore
@pytest.mark.parametrize("how", ["restored", "restored2"])
@pytest.mark.parametrize("grid", GRIDS[1:], ids=str)
def test_checkpoint_restores_onto_another_grid_bit_for_bit(worlds, grid,
                                                           how):
    saved, _ = worlds[(2, 2)]
    res, meta = worlds[grid]
    keys = _names(saved, "saved/")
    assert keys == _names(res, f"{how}/")
    for k in keys:
        np.testing.assert_array_equal(res[f"{how}/{k}"], saved[f"saved/{k}"],
                                      err_msg=k)
    if how == "restored":
        assert meta["restored_placements"] == meta["placements"]
    else:
        assert meta["restored2_dtensor"]


def test_checkpoint_restores_on_one_device_bit_for_bit(worlds):
    saved, _ = worlds[(2, 2)]
    cfg = W.get_config("granite_8b").reduced()
    got = checkpoint.restore_checkpoint(
        str(worlds["ckpt"]), steps.init_train_state(cfg, 0, device="cpu"))
    flat = checkpoint._flatten(got)
    assert sorted(flat) == _names(saved, "saved/")
    for k, v in flat.items():
        np.testing.assert_array_equal(v, saved[f"saved/{k}"], err_msg=k)


def test_port_archive_loads_into_the_reference(worlds):
    saved, _ = worlds[(2, 2)]
    ref = worlds["ref"]
    keys = _names(saved, "saved/")
    assert keys == _names(ref, "port_in_ref/")
    for k in keys:
        np.testing.assert_array_equal(ref[f"port_in_ref/{k}"],
                                      saved[f"saved/{k}"], err_msg=k)


def test_reference_archive_loads_into_the_port(worlds):
    cfg = W.get_config("granite_8b").reduced()
    d = str(worlds["ref_ckpt"])
    got = checkpoint.restore_checkpoint(
        d, steps.init_train_state(cfg, 0, device="cpu"))
    flat = checkpoint._flatten(got)
    with np.load(os.path.join(d, "step_00000001", "shard_0.npz")) as z:
        assert sorted(z.files) == sorted(flat)
        for k in z.files:
            np.testing.assert_array_equal(flat[k], z[k], err_msg=k)


# ------------------------------------------------------------- padding
@pytest.mark.parametrize("pad", ["pad", "nopad"])
@pytest.mark.parametrize("kind", list(W.ODD))
def test_padded_paths_match_the_reference_at_tp2(worlds, kind, pad):
    res, _ = worlds[(1, 2)]
    ref = worlds["ref"]
    for what in ("logits", "aux", "loss"):
        got = res[f"padded/{kind}/{pad}/{what}"]
        want = ref[f"{kind}/{pad}/{what}"]
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, rtol=PAD_TOL, atol=PAD_TOL,
                                   err_msg=f"{kind} {pad} {what}")


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_head_and_vocab_padding_are_exact(worlds, kind):
    """Padded heads project through zero rows and padded vocab entries are
    masked, so tp = 2 gives the one-device logits; expert padding is not
    exact (each real expert's capacity shrinks by E/E_pad)."""
    res, _ = worlds[(1, 2)]
    np.testing.assert_allclose(res[f"padded/{kind}/pad/logits"],
                               res[f"padded/{kind}/pad/one"],
                               rtol=PAD_TOL, atol=PAD_TOL)


# ------------------------------------------------------------- launcher
@pytest.fixture(scope="module")
def launch_baseline():
    with compute_dtype(True):
        _, hist = port_launch.main(W.LAUNCH + ["--data-par", "1",
                                               "--model-par", "1"])
    return hist


@pytest.mark.parametrize("grid", GRIDS[1:], ids=str)
def test_train_launcher_data_and_model_par(worlds, launch_baseline, grid):
    _, meta = worlds[grid]
    hist = meta["launch"]
    assert len(hist) == len(launch_baseline) == 3
    for got, want in zip(hist, launch_baseline):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got,
                                                                   want)


def test_train_launcher_refuses_a_grid_that_is_not_the_world():
    with pytest.raises(ValueError, match="must equal the world size, 1"):
        port_launch.main(W.LAUNCH + ["--data-par", "2"])
