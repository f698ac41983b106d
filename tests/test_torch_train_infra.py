"""The port's training infrastructure against the JAX package: int8
gradient compression bit for bit, checkpoints in the reference's format
(each package restores the other's), the fault supervisor (the reference's
own cases on the port's copy), resume-exact, and the launchers on the CPU.
"""
import dataclasses
import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.compression as ref_comp
import repro.train.checkpoint as ref_ckpt
import repro.train.optimizer as ref_opt
import repro.train.steps as ref_steps
import repro_torch.distributed.compression as port_comp
import repro_torch.launch.train as port_launch
import repro_torch.train.steps as port_steps
import repro_torch.train_lm_e2e as twin
from repro.configs.base import get_config
from repro_torch.models.convert import params_to_reference
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault_tolerance import (HeartbeatMonitor,
                                               plan_elastic_mesh,
                                               train_with_recovery)
from _torch_lm import carry, port_cfg


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint8 if a.dtype == np.int8 else np.uint32)


# ---------------------------------------------------------- compression ---
SIZES = [(255,), (256,), (1000,), (33, 129), (4, 5, 6, 7)]


@pytest.mark.parametrize("shape", SIZES, ids=str)
def test_quantize_matches_reference_bit_for_bit(shape):
    """Codes and scales, and the dequantized values, for a leaf of 255
    elements, one block exactly, and sizes no multiple of 256; zeros and
    exact halves (round half to even) included."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * rng.exponential(size=shape)) \
        .astype(np.float32)
    x.reshape(-1)[::17] = 0.0
    x.reshape(-1)[5] = 127.0 * 2.5 / 127.0        # an exact .5 code
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = port_comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    np.testing.assert_array_equal(_bits(s), _bits(rs))
    rd = ref_comp.dequantize_int8(rq, rs, x.shape, jnp.float32)
    d = port_comp.dequantize_int8(q, s, x.shape, torch.float32)
    np.testing.assert_array_equal(_bits(d), _bits(rd))


def test_compress_and_error_feedback_match_reference():
    """``compress_decompress_grads`` (a leaf under 256 elements passes
    through) and five steps of ``ef_compress``: outputs and residuals bit
    for bit."""
    rng = np.random.default_rng(3)
    shapes = [(255,), (300,), (16, 40), (7,)]
    gs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ref = ref_comp.compress_decompress_grads([jnp.asarray(g) for g in gs])
    got = port_comp.compress_decompress_grads([torch.from_numpy(g)
                                               for g in gs])
    for g, r, x in zip(got, ref, gs):
        np.testing.assert_array_equal(_bits(g), _bits(r))
    np.testing.assert_array_equal(got[0].numpy(), gs[0])
    ref_ef = ref_comp.EFState([jnp.zeros(s, jnp.float32) for s in shapes])
    ef = port_comp.EFState([torch.zeros(s) for s in shapes])
    for step in range(5):
        gs = [(rng.normal(size=s) * 1e-3).astype(np.float32)
              for s in shapes]
        rout, ref_ef = ref_comp.ef_compress([jnp.asarray(g) for g in gs],
                                            ref_ef)
        out, ef = port_comp.ef_compress([torch.from_numpy(g) for g in gs],
                                        ef)
        for a, b in zip(out + ef.residual, list(rout) + list(ref_ef.residual)):
            np.testing.assert_array_equal(_bits(a), _bits(b), f"step {step}")


def test_error_feedback_reduces_bias():
    """The reference's own case on the port: with error feedback the
    accumulated compressed sum tracks the true sum."""
    rng = np.random.default_rng(2)
    gs = [torch.from_numpy(rng.normal(size=512).astype(np.float32) * 1e-3)
          for _ in range(50)]
    ef = port_comp.EFState([torch.zeros(512)])
    acc = torch.zeros(512)
    for g in gs:
        (out,), ef = port_comp.ef_compress([g], ef)
        acc = acc + out
    err = float((acc + ef.residual[0] - sum(gs)).abs().max())
    assert err < 1e-5


def test_compress_stacked_matches_reference_leaves():
    """The train step compresses the reference's stacked leaves: hymba's
    per-layer norms (under 256 elements alone) are compressed as their
    stack is, and blocks span layers."""
    cfg = get_config("hymba_1p5b").reduced()
    params = jax.tree.map(np.asarray, ref_steps.init_train_state(
        cfg, jax.random.PRNGKey(0))["params"])
    tparams = carry(cfg, params)
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for p in tparams.parameters()]
    by_name = dict(zip((n for n, _ in tparams.named_parameters()), grads))
    from repro_torch.models.lm import map_params
    tree = params_to_reference(map_params(tparams, lambda n, p: by_name[n]))
    ref = ref_comp.compress_decompress_grads(tree)
    got = port_steps.compress_stacked(tparams, grads)
    by_name = dict(zip((n for n, _ in tparams.named_parameters()), got))
    got_tree = params_to_reference(map_params(tparams,
                                              lambda n, p: by_name[n]))
    for kp, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        g = got_tree
        for k in kp:
            g = g[k.key]
        np.testing.assert_array_equal(_bits(g), _bits(r),
                                      jax.tree_util.keystr(kp))


# ----------------------------------------------------------- checkpoint ---
def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"a": torch.arange(6.0).reshape(2, 3),
                        "nested": {"b": torch.ones(4, dtype=torch.int32)}},
             "step": np.int32(7)}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state)
    assert latest_step(d) == 7
    restored = restore_checkpoint(d, state)
    assert torch.equal(restored["params"]["a"], state["params"]["a"])
    assert torch.equal(restored["params"]["nested"]["b"],
                       state["params"]["nested"]["b"])
    assert restored["step"] == 7


def test_checkpoint_prune_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    state = {"x": torch.zeros(2)}
    for s in [10, 20, 30]:
        save_checkpoint(d, s, state, keep=2)
    assert latest_step(d) == 30
    dirs = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert dirs == ["step_00000020", "step_00000030"]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)


def _train_states(arch):
    """Each package's train state after one step from the same weights."""
    cfg = get_config(arch).reduced()
    rstate = ref_steps.init_train_state(cfg, jax.random.PRNGKey(1))
    tcfg = port_cfg(cfg)
    tstate = {"params": carry(cfg, rstate["params"]),
              "opt": port_steps.adamw_init(carry(cfg, rstate["params"]))}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    opt = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1, schedule="const")
    rstate, _ = ref_steps.make_train_step(cfg, opt, attn_chunk=8)(
        rstate, batch)
    tstate, _ = port_steps.make_train_step(
        tcfg, port_steps.AdamWConfig(lr=1e-2, warmup_steps=1,
                                     schedule="const"), attn_chunk=8)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    return cfg, tcfg, rstate, tstate


def _port_tree(state):
    return {"params": params_to_reference(state["params"]),
            "opt": {"m": params_to_reference(state["opt"]["m"]),
                    "v": params_to_reference(state["opt"]["v"]),
                    "step": np.asarray(state["opt"]["step"])}}


@pytest.mark.parametrize("arch", ["granite_8b", "hymba_1p5b"])
def test_checkpoints_cross_packages(arch, tmp_path):
    """A reference checkpoint restores into the port's train state (and
    trains on), a port checkpoint through the reference's
    ``restore_checkpoint``: every leaf, the optimizer's moments and step
    included, equal, under the reference's key paths."""
    cfg, tcfg, rstate, tstate = _train_states(arch)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_checkpoint(d_ref, 1, rstate)
    like = port_steps.init_train_state(tcfg, 5, device="cpu")
    got = restore_checkpoint(d_ref, like)
    assert isinstance(got["params"], type(like["params"]))
    assert all(p.requires_grad for p in got["params"].parameters())
    assert not any(p.requires_grad for p in got["opt"]["m"].parameters())
    want = jax.tree.map(np.asarray, rstate)
    jax.tree.map(np.testing.assert_array_equal, _port_tree(got), want)
    assert int(got["opt"]["step"]) == 1

    save_checkpoint(d_port, 1, tstate)
    with np.load(os.path.join(d_port, "step_00000001", "shard_0.npz")) as z:
        with np.load(os.path.join(d_ref, "step_00000001",
                                  "shard_0.npz")) as zr:
            assert sorted(z.files) == sorted(zr.files)
            for k in zr.files:
                assert z[k].shape == zr[k].shape and \
                    z[k].dtype == zr[k].dtype, k
    back = ref_ckpt.restore_checkpoint(d_port, rstate)
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, back), _port_tree(tstate))


def test_restore_places_leaves_on_the_device(tmp_path):
    _, tcfg, _, tstate = _train_states("granite_8b")
    save_checkpoint(str(tmp_path), 3, tstate)
    got = restore_checkpoint(str(tmp_path), tstate, device="cpu")
    assert got["params"].device == torch.device("cpu")
    assert isinstance(got["opt"]["step"], torch.Tensor)
    wider = dataclasses.replace(tcfg, d_model=2 * tcfg.d_model)
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore_checkpoint(str(tmp_path), port_steps.init_train_state(
            wider, 0, device="cpu"))


# ------------------------------------------------------ fault tolerance ---
def _ticking_clock():
    t = [0.0]

    def clock():
        return t[0]

    clock.t = t
    return clock


def test_recovery_loop_times_steps_with_monitor_clock(tmp_path):
    clock = _ticking_clock()
    mon = HeartbeatMonitor(n_hosts=1, slack=2.0, timeout=50.0, clock=clock)

    def step_fn(state, batch):
        clock.t[0] += 1.0 + 0.5 * batch
        return state + 1, {"loss": float(batch)}

    state, hist = train_with_recovery(step_fn, 0, list(range(6)),
                                      str(tmp_path), save_every=100,
                                      monitor=mon)
    assert state == 6 and len(hist) == 6
    np.testing.assert_allclose(mon.step_times[0],
                               [1.0 + 0.5 * b for b in range(6)])
    assert mon.dead() == []
    clock.t[0] += 51.0
    assert mon.dead() == [0]


def test_recovery_loop_straggler_detection_deterministic(tmp_path):
    clock = _ticking_clock()
    mon = HeartbeatMonitor(n_hosts=3, slack=2.0, timeout=1e9, clock=clock)

    def step_fn(state, batch):
        clock.t[0] += 1.0
        return state + 1, {"loss": 0.0}

    train_with_recovery(step_fn, 0, list(range(8)), str(tmp_path),
                        save_every=100, monitor=mon)
    for _ in range(8):
        mon.beat(1, 1.0)
        mon.beat(2, 5.0)
    assert mon.stragglers() == [2]


def test_recovery_loop_resume_consumes_skipped_batches(tmp_path):
    clock = _ticking_clock()
    mon = HeartbeatMonitor(n_hosts=1, timeout=1e9, clock=clock)
    seen = []

    def step_fn(state, batch):
        clock.t[0] += 1.0
        seen.append(batch)
        return state + batch, {"loss": 0.0}

    batches = list(range(10))
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train_with_recovery(step_fn, 0, batches, str(tmp_path),
                            save_every=3, fail_at=4, monitor=mon)
    assert latest_step(str(tmp_path)) == 3
    state, hist = train_with_recovery(step_fn, sum(range(4)), batches,
                                      str(tmp_path), save_every=100,
                                      start_step=4, monitor=mon)
    assert seen == list(range(10))
    assert state == sum(batches) and len(hist) == 6
    np.testing.assert_allclose(mon.step_times[0], [1.0] * 10)


def test_heartbeat_straggler_detection():
    clock = [0.0]
    mon = HeartbeatMonitor(n_hosts=4, slack=2.0, timeout=10.0,
                           clock=lambda: clock[0])
    for step in range(8):
        clock[0] += 1.0
        for h in range(4):
            mon.beat(h, 1.0 if h != 2 else 5.0)
    assert mon.stragglers() == [2]
    assert mon.dead() == []
    clock[0] += 100.0
    assert set(mon.dead()) == {0, 1, 2, 3}


def test_elastic_plan_pod_loss():
    plan = plan_elastic_mesh(total_pods=2, failed_pods=[1],
                             global_batch=256)
    assert plan.mesh_shape == (16, 16)
    assert plan.axis_names == ("data", "model")
    assert plan.global_batch == 128
    plan4 = plan_elastic_mesh(total_pods=4, failed_pods=[2],
                              global_batch=512)
    assert plan4.mesh_shape == (3, 16, 16)
    assert plan4.global_batch == 384


def test_train_resume_exact(tmp_path):
    """Crash at step 6, resume from the checkpoint at 5: the resumed
    steps' losses are the uninterrupted run's (deterministic skip-ahead
    data), the reference's criterion."""
    cfg = port_cfg(get_config("granite_8b").reduced())
    kw = dict(steps=8, global_batch=2, seq_len=32, save_every=5,
              attn_chunk=8, log_every=100, device="cpu")
    _, hist_full = port_launch.train_loop(cfg, ckpt_dir=str(tmp_path / "a"),
                                          **kw)
    d2 = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="simulated failure"):
        port_launch.train_loop(cfg, ckpt_dir=d2, fail_at=6, **kw)
    assert latest_step(d2) == 5
    _, hist_resumed = port_launch.train_loop(cfg, ckpt_dir=d2, **kw)
    assert len(hist_resumed) == 3
    np.testing.assert_allclose([h["loss"] for h in hist_full[5:]],
                               [h["loss"] for h in hist_resumed], rtol=1e-4)


# ------------------------------------------------------------ launchers ---
def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    state, hist = port_launch.main([
        "--arch", "granite_8b", "--reduced", "--device", "cpu", "--steps",
        "3", "--batch", "2", "--seq", "32", "--compress-grads",
        "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 3 and np.isfinite([h["loss"] for h in hist]).all()
    assert latest_step(str(tmp_path)) == 3
    assert "[train] step     2" in capsys.readouterr().out


def test_e2e_twin_runs_on_cpu_and_resumes(tmp_path, capsys):
    argv = ["--quick", "--steps", "12", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    _, hist = twin.main(argv)
    assert len(hist) == 12 and latest_step(str(tmp_path)) == 12
    first, last, _ = twin.summary(hist)
    assert np.isfinite([first, last]).all()
    _, again = twin.main(argv)                 # resumes at its last step
    assert again == []
    out = capsys.readouterr().out
    assert "[e2e] loss" in out and "resumed from step 12" in out


def test_e2e_twin_config_is_the_reference_example():
    cfg = twin.e2e_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.d_head) == (12, 768, 12, 4, 2048,
                                                 8192, 64)
    assert 80e6 < cfg.param_count() < 130e6     # 88.1M
    assert twin.run_kw()["steps"] == 300
    assert twin.summary([{"loss": 5.0}] * 10 + [{"loss": 4.6}] * 10)[2]
    assert not twin.summary([{"loss": 5.0}] * 10 + [{"loss": 4.8}] * 10)[2]


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg = port_cfg(get_config("granite_8b").reduced())
    for call in (lambda: port_steps.init_train_state(cfg),
                 lambda: port_launch.train_loop(
                     cfg, steps=1, global_batch=2, seq_len=8, ckpt_dir=""),
                 lambda: twin.main(["--quick", "--steps", "1", "--ckpt-dir",
                                    ""])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for mod in (port_launch, twin):
        src = inspect.getsource(importlib.import_module(mod.__name__))
        assert 'add_argument("--device", default="cuda")' in src
    assert inspect.signature(port_launch.train_loop).parameters[
        "device"].default == "cuda"
