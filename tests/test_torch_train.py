"""The port's LM training against the JAX package: the schedules and the
AdamW update on the same numpy state, the loss and every leaf's gradient
for each reduced arch (float32 compute, weights carried across and
gradients mapped back with ``params_to_reference``), rematerialization,
and the train step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
import repro.models.layers as ref_layers
import repro.models.lm as ref_lm
import repro.models.moe as ref_moe
import repro.models.ssm as ref_ssm
import repro.train.optimizer as ref_opt
import repro.train.steps as ref_steps
import repro_torch.train.optimizer as port_opt
import repro_torch.train.steps as port_steps
from repro.configs.base import ALL_ARCHS, get_config
from repro_torch.models import attention as port_attn
from repro_torch.models import lm as port_lm
from repro_torch.models import moe as port_moe
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import params_to_reference
from _torch_lm import TOL_F32, assert_f32_close, carry, compute_dtype, \
    port_cfg


# ------------------------------------------------------------ schedules ---
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_lr_at_matches_reference(schedule):
    """Warmup, the stable phase and the decay tail, to 1e-7 relative.  In
    the cosine tail ``1 + cos`` cancels, so one float32 ulp between XLA's
    ``cos`` and torch's grows to ~2e-6 of the value there (both compute in
    float32); that is still within 1e-7 of the peak rate, the bound the
    tail is held to."""
    cfg_kw = dict(lr=3e-3, warmup_steps=17, total_steps=400,
                  schedule=schedule, wsd_decay_frac=0.2)
    ref = ref_opt.AdamWConfig(**cfg_kw)
    got = port_opt.AdamWConfig(**cfg_kw)
    steps = list(range(0, 40)) + list(range(300, 420, 7))
    for s in steps:
        r = float(ref_opt.lr_at(ref, jnp.int32(s)))
        g = port_opt.lr_at(got, s)
        assert g == pytest.approx(r, rel=1e-7, abs=1e-7 * cfg_kw["lr"]), \
            (schedule, s)
        if s <= 300:
            assert g == pytest.approx(r, rel=1e-7, abs=0), (schedule, s)


# ------------------------------------------------------------ optimizer ---
def _opt_state(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip):
    """Three steps from the same numpy params and gradients; the norms and
    a (1,)-leaf decay too, as the reference decays every leaf."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 33), "b": (300,), "c": (1,), "d": (4, 5, 6)}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
                  weight_decay=0.1)
    ref_cfg, port_cfgo = ref_opt.AdamWConfig(**cfg_kw), \
        port_opt.AdamWConfig(**cfg_kw)
    p0 = _opt_state(rng, shapes)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    ropt = ref_opt.adamw_init(rp)
    keys = sorted(shapes)
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    topt = port_opt.adamw_init(tp)
    for step in range(3):
        g = _opt_state(rng, shapes)
        rp, ropt, rm = ref_opt.adamw_update(
            ref_cfg, {k: jnp.asarray(v) for k, v in g.items()}, ropt, rp)
        tm = port_opt.adamw_update(
            port_cfgo, [torch.from_numpy(g[k]) for k in keys], topt, tp)
        if clip < 1:
            assert float(rm["grad_norm"]) > clip
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(rm[name]),
                                                    rel=1e-6), (step, name)
        assert int(topt["step"]) == int(ropt["step"]) == step + 1
        for i, k in enumerate(keys):
            for got, ref in ((tp[i], rp[k]), (topt["m"][i], ropt["m"][k]),
                             (topt["v"][i], ropt["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"step {step} {k}")


# -------------------------------------------------------- loss and grads ---
def _model(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, port_cfg(cfg), carry(cfg, params)


def _batch(cfg, B=2, S=20, seed=0):
    """Seeded tokens, their next tokens as labels and, for vlm, stub patch
    embeddings.  S = 20 is ragged for the 8-wide attention chunks and
    crosses the reduced hybrid's 16-token window."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.family == "vlm":
        batch["image_embed"] = rng.normal(
            size=(B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _grads_tree(tparams, grads):
    """The port's gradients (aligned with ``parameters()``) in the
    reference's stacked layout."""
    by_name = dict(zip((n for n, _ in tparams.named_parameters()), grads))
    return params_to_reference(port_lm.map_params(tparams,
                                                  lambda n, p: by_name[n]))


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, params, tcfg, tparams = _model(arch)
    batch = _batch(cfg)
    with compute_dtype(True):
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(
            lambda p: ref_lm.loss_fn(
                p, cfg, batch["tokens"], batch["labels"],
                image_embed=batch.get("image_embed"), block_causal=True,
                attn_chunk=8, remat=True)))(params)
        loss, grads = port_steps.value_and_grad(tcfg, tparams,
                                                _port_batch(batch),
                                                attn_chunk=8)
    assert_f32_close(loss, ref_loss, "loss")
    got = _grads_tree(tparams, grads)
    paths = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(paths) == len(jax.tree.leaves(got))
    for kp, ref in paths:
        node = got
        for k in kp:
            node = node[k.key]
        assert node.dtype == np.float32
        assert np.isfinite(node).all(), kp
        assert_f32_close(node, ref, jax.tree_util.keystr(kp))


# ------------------------------------------- the backward's trouble spots ---
def _module_grads(ref_fn, port_fn, params, x):
    """Gradients of ``sum(out * w)`` (a fixed seeded ``w``) for the
    parameters and the input, from the reference (``jax.grad``) and the
    port (autograd), float32 inputs."""
    out_shape = jax.eval_shape(ref_fn, params, jnp.asarray(x)).shape
    w = np.random.default_rng(9).normal(size=out_shape).astype(np.float32)
    ref = jax.grad(lambda p, xx: jnp.sum(ref_fn(p, xx) * w),
                   argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (port_fn(tp, tx) * torch.from_numpy(w)).sum().backward()
    return ref, ({k: v.grad for k, v in tp.items()}, tx.grad)


def _assert_grads(ref, got):
    for k, r in ref[0].items():
        g = got[0][k]
        assert torch.isfinite(g).all(), k
        assert_f32_close(g, r, k)
    assert torch.isfinite(got[1]).all()
    assert_f32_close(got[1], ref[1], "input")


def test_ssd_gradient_finite_where_masked_in_log_space():
    """The SSD masks the decay in log space (-inf) before ``exp``: the
    gradient through the masked entries is 0, never a NaN, as the
    reference's ``jnp.where(tri, seg, -inf)`` gives it."""
    ini = ref_layers.Initializer(jax.random.PRNGKey(0))
    p = ref_ssm.init_ssm(ini, 32, 64, 4, 8, 4)
    key = jax.random.PRNGKey(1)
    p["A_log"] = jax.random.normal(key, p["A_log"].shape) * 0.5 + 1.0
    p["dt_bias"] = jax.random.normal(key, p["dt_bias"].shape) * 0.3
    p = jax.tree.map(np.asarray, p)
    kw = dict(d_inner=64, state=8, n_heads=4, head_dim=16, chunk=8)
    x = np.random.default_rng(2).normal(size=(2, 24, 32)).astype(np.float32)
    _assert_grads(*_module_grads(
        lambda pp, xx: ref_ssm.ssm_forward(pp, xx, **kw),
        lambda pp, xx: port_ssm.ssm_forward(pp, xx, **kw), p, x))


@pytest.mark.parametrize("case", ["padded_keys_window", "prefix"])
def test_attention_gradient_finite_on_fully_masked_rows(case):
    """Padded query rows past a 3-wide window see no valid key (a fully
    masked row of -1e30 scores): their gradients are finite and equal the
    reference's, as are a prefix-LM mask's."""
    ini = ref_layers.Initializer(jax.random.PRNGKey(3))
    p = jax.tree.map(np.asarray, ref_attn.init_attn(ini, 32, 4, 2, 8, True))
    kw = dict(n_heads=4, n_kv=2, head_dim=8, rope_theta=1e4, chunk=4,
              **({"window": 3} if case == "padded_keys_window"
                 else {"prefix_len": 5}))
    x = np.random.default_rng(4).normal(size=(2, 11, 32)).astype(np.float32)
    _assert_grads(*_module_grads(
        lambda pp, xx: ref_attn.attn_forward(pp, xx, **kw),
        lambda pp, xx: port_attn.attn_forward(pp, xx, **kw), p, x))


def test_moe_dropped_pairs_send_no_gradient():
    """Pairs over capacity write the spare row of the dispatch buffer,
    which is cut off: a token whose every pair was dropped gets no
    gradient from the output, and the rest match the reference's."""
    ini = ref_layers.Initializer(jax.random.PRNGKey(5))
    p = jax.tree.map(np.asarray, ref_moe.init_moe(ini, 32, 8, 16))
    kw = dict(n_experts=8, top_k=2, capacity_factor=0.5)
    x = np.random.default_rng(6).normal(size=(2, 24, 32)).astype(np.float32)
    ref, got = _module_grads(
        lambda pp, xx: ref_moe.moe_forward(pp, xx, **kw)[0],
        lambda pp, xx: port_moe.moe_forward(pp, xx, **kw)[0], p, x)
    _assert_grads(ref, got)
    out, _ = port_moe.moe_forward({k: torch.from_numpy(np.array(v))
                                   for k, v in p.items()},
                                  torch.from_numpy(x), **kw)
    dropped = (out == 0).all(-1)
    assert dropped.any()
    assert (got[1][dropped] == 0).all()


def test_gradients_come_back_in_float32_under_bf16_compute():
    """The float32 leaves reach the bf16 compute through ``.to(cd)``; the
    cast's backward returns float32 gradients, for the tied embedding too
    (minicpm; that its two uses sum is held against the reference by
    ``test_loss_and_grads_match_reference``)."""
    _, _, tcfg, tparams = _model("minicpm_2b")
    assert tparams.lm_head is None
    loss, grads = port_steps.value_and_grad(
        tcfg, tparams, _port_batch(_batch(tcfg)), attn_chunk=8)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    assert grads[0].shape == tparams.embed.shape
    assert grads[0].abs().sum() > 0


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m",
                                  "mamba2_2p7b", "hymba_1p5b"])
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each block in the backward pass changes no bit here."""
    _, _, tcfg, tparams = _model(arch)
    batch = _port_batch(_batch(tcfg))
    runs = [port_steps.value_and_grad(tcfg, tparams, batch, attn_chunk=8,
                                      remat=r) for r in (True, False)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_forward_builds_a_graph_unless_inference():
    _, _, tcfg, tparams = _model("granite_8b")
    tokens = _batch(tcfg)["tokens"]
    logits, _ = port_lm.forward(tparams, tcfg, tokens, attn_chunk=8)
    assert logits.requires_grad
    with torch.inference_mode():
        logits, _ = port_lm.forward(tparams, tcfg, tokens, attn_chunk=8)
    assert not logits.requires_grad
    cache = port_lm.init_cache(tcfg, 2, 8, device="cpu")
    logits, _ = port_lm.decode_step(tparams, tcfg, tokens[:, :1], cache, 0)
    assert not logits.requires_grad


# ------------------------------------------------------------ the step ---
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_reduces_loss(arch):
    """The reference's own yardstick, on the port (bf16 compute): five
    steps on one batch lower the loss."""
    cfg = get_config(arch).reduced()
    tcfg = port_cfg(cfg)
    state = port_steps.init_train_state(tcfg, 0, device="cpu")
    step = port_steps.make_train_step(
        tcfg, port_opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100,
                                   schedule="const"), attn_chunk=8)
    batch = _batch(tcfg, S=16, seed=1)
    batch["labels"] = batch["tokens"]
    losses = []
    for _ in range(5):
        state, m = step(state, _port_batch(batch))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_3b_a800m",
                                  "hymba_1p5b"])
@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_first_step_matches_reference(arch, compress):
    """One train step of each package from the same weights and batch
    (float32 compute): the metrics, and the updated parameters and
    moments.  The first update is ``lr * g / (|g| + eps)``, whose value
    turns on a gradient's relative error where ``|g|`` is small, so the
    parameters are compared where ``|m|`` is within 100x of its leaf's
    largest.  With int8 compression a gradient's float32 rounding can move
    a value across a code boundary, so the moments may differ by one code
    (1/127 of their leaf's largest; twice that for ``v``)."""
    cfg, params, tcfg, tparams = _model(arch)
    batch = _batch(cfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const")
    with compute_dtype(True):
        rstate = {"params": params, "opt": ref_opt.adamw_init(params)}
        rstate, rm = jax.jit(ref_steps.make_train_step(
            cfg, ref_opt.AdamWConfig(**kw), attn_chunk=8,
            compress_grads=compress))(rstate, batch)
        state = {"params": tparams, "opt": port_opt.adamw_init(tparams)}
        state, m = port_steps.make_train_step(
            tcfg, port_opt.AdamWConfig(**kw), attn_chunk=8,
            compress_grads=compress)(state, _port_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=TOL_F32), k
    assert int(state["opt"]["step"]) == int(rstate["opt"]["step"]) == 1
    ref_p = jax.tree.map(np.asarray, rstate["params"])
    ref_m = jax.tree.map(np.asarray, rstate["opt"]["m"])
    got_p = params_to_reference(state["params"])
    got_m = params_to_reference(state["opt"]["m"])
    got_v = params_to_reference(state["opt"]["v"])
    for kp, rp in jax.tree_util.tree_flatten_with_path(ref_p)[0]:
        gp, gm, gv, rmv, rv = got_p, got_m, got_v, ref_m, \
            rstate["opt"]["v"]
        for k in kp:
            gp, gm, gv, rmv, rv = (x[k.key] for x in (gp, gm, gv, rmv, rv))
        what = jax.tree_util.keystr(kp)
        rv = np.asarray(rv)
        scale = np.abs(rmv).max()
        code = 1 / 127 if compress else 0.0
        np.testing.assert_allclose(gm, rmv, rtol=TOL_F32,
                                   atol=(TOL_F32 + code) * scale,
                                   err_msg=what)
        np.testing.assert_allclose(gv, rv, rtol=TOL_F32,
                                   atol=TOL_F32 * scale ** 2
                                   + 2 * code * np.abs(rv).max(),
                                   err_msg=what)
        big = np.abs(rmv) > 1e-2 * scale
        np.testing.assert_allclose(gp[big], rp[big], rtol=TOL_F32,
                                   atol=TOL_F32 * kw["lr"], err_msg=what)
