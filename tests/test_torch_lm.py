"""The port's LM modules against the JAX package at small sizes.

Weights come from the reference's initializers and are carried across with
``params_from_reference``; inputs are seeded numpy.  Float32 compute
(``COMPUTE_DTYPE`` set to float32 in both packages, here only) agrees
within 1e-4; the bf16 path meets the contract of ``_lm_contract``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_configs
import repro.models.attention as ref_attn
import repro.models.layers as ref_layers
import repro.models.lm as ref_lm
import repro.models.moe as ref_moe
import repro.models.ssm as ref_ssm
import repro_torch.configs.base as port_configs
import repro_torch.models.attention as port_attn
import repro_torch.models.layers as port_layers
import repro_torch.models.lm as port_lm
import repro_torch.models.moe as port_moe
import repro_torch.models.ssm as port_ssm
from _lm_contract import ROUTER_TIE, bf16_contract, np32, router_gaps
from _torch_lm import assert_f32_close, carry, compute_dtype, port_cfg

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _leaves(tree):
    """A reference param dict as the port's (numpy -> torch, float32)."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _pair(rng, shape, dt):
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got, ref, dt, what=""):
    if dt == "f32":
        return assert_f32_close(got, ref, what)
    got, ref = np32(got), np32(ref)
    tol = 0.02 * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (what, np.abs(got - ref).max())


# --------------------------------------------------------------- layers ---
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_and_rope_match_reference(dt):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, (2, 5, 3, 16), dt)
    g = rng.normal(size=16).astype(np.float32)
    _close(port_layers.rms_norm(xt, torch.from_numpy(g), 1e-6),
           ref_layers.rms_norm(xj, jnp.asarray(g), 1e-6), dt, "rms_norm")
    pos = np.array([0, 3, 17, 1000, 5])
    cj, sj = ref_layers.rotary_embedding(jnp.asarray(pos), 16, 5e5)
    ct, st = port_layers.rotary_embedding(torch.from_numpy(pos), 16, 5e5)
    assert_f32_close(ct, cj, "cos")
    assert_f32_close(st, sj, "sin")
    out_t = port_layers.apply_rope(xt, ct, st)
    out_j = ref_layers.apply_rope(xj, cj, sj)
    assert out_t.dtype == DTYPES[dt][1]
    _close(out_t, out_j, dt, "apply_rope")
    _close(port_layers.silu(xt), ref_layers.silu(xj), dt, "silu")


def test_initializer_distributions_and_default_device():
    ini = port_layers.Initializer(torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    w = ini.normal((256, 512), fan_in=256)
    assert w.dtype == port_layers.PARAM_DTYPE == torch.float32
    assert port_layers.COMPUTE_DTYPE == torch.bfloat16
    assert abs(float(w.std()) - 256 ** -0.5) < 2e-3
    assert abs(float(ini.normal((4096,)).std()) - 0.02) < 2e-3
    assert float(ini.zeros((3,)).abs().sum()) == 0
    assert torch.equal(ini.ones((3,)), torch.ones(3))


# ------------------------------------------------------------ attention ---
def _attn_params(use_bias, D=32, H=4, KV=2, hd=8, seed=0):
    ini = ref_layers.Initializer(jax.random.PRNGKey(seed))
    p = ref_attn.init_attn(ini, D, H, KV, hd, use_bias)
    if use_bias:   # non-zero biases, so the bias path is compared
        p = {k: (v + 0.1 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
                 if k.startswith("b") else v) for k, v in p.items()}
    return p, _leaves(p)


ATTN_CASES = {
    "causal": dict(),
    "window": dict(window=5),
    "prefix": dict(prefix_len=6),
    "block_causal": dict(block_causal=True),
    "window_dynamic": dict(window_dynamic=4),
    "ragged": dict(S=13),                 # S not a multiple of the chunk
    "bias_ragged_window": dict(S=11, window=3, bias=True),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_forward_matches_reference(case, dt):
    kw = dict(ATTN_CASES[case])
    S = kw.pop("S", 16)
    pj, pt = _attn_params(kw.pop("bias", False))
    xj, xt = _pair(np.random.default_rng(1), (2, S, 32), dt)
    common = dict(n_heads=4, n_kv=2, head_dim=8, rope_theta=1e4, chunk=4)
    ref = ref_attn.attn_forward(pj, xj, **common, **kw)
    got = port_attn.attn_forward(pt, xt, **common, **kw)
    assert got.dtype == DTYPES[dt][1]
    _close(got, ref, dt, case)


def test_mask_fn_matches_reference():
    q, k = np.arange(12), np.arange(12)
    for kw in (dict(), dict(window=3), dict(prefix_len=4),
               dict(window=2, prefix_len=5), dict(window_dynamic=6)):
        np.testing.assert_array_equal(
            port_attn.mask_fn(torch.from_numpy(q), torch.from_numpy(k),
                              **kw).numpy(),
            np.asarray(ref_attn.mask_fn(jnp.asarray(q), jnp.asarray(k),
                                        **kw)))


DECODE_CASES = {
    # (window, S_max, positions per step: int = lockstep, list = per slot)
    "scalar": (0, 8, [0, 1, 2, 3, 4]),
    "scalar_clamped": (0, 4, [2, 3, 4, 6]),        # past S_max: clamp
    "scalar_ring_wrap": (4, 4, [0, 1, 2, 3, 4, 5, 9]),
    "per_slot": (0, 8, [[0, 3], [1, 4], [2, 5]]),
    "per_slot_clamped": (0, 6, [[4, 5], [5, 6], [6, 9]]),
    "per_slot_ring_wrap": (4, 4, [[0, 2], [3, 5], [4, 6], [8, 11]]),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_attn_decode_matches_reference(case, dt):
    window, S_max, steps = DECODE_CASES[case]
    pj, pt = _attn_params(True)
    rng = np.random.default_rng(2)
    B = 2
    kc = rng.normal(size=(B, S_max, 2, 8)).astype(np.float32)
    vc = rng.normal(size=(B, S_max, 2, 8)).astype(np.float32)
    jd, td = DTYPES[dt]
    kj, vj = jnp.asarray(kc).astype(jd), jnp.asarray(vc).astype(jd)
    kt, vt = torch.from_numpy(kc).to(td), torch.from_numpy(vc).to(td)
    common = dict(n_heads=4, n_kv=2, head_dim=8, rope_theta=1e4,
                  window=window)
    for i, pos in enumerate(steps):
        xj, xt = _pair(rng, (B, 1, 32), dt)
        if isinstance(pos, list):
            pos_j, pos_t = jnp.asarray(pos, jnp.int32), torch.tensor(pos)
        else:
            pos_j, pos_t = jnp.int32(pos), pos
        yj, kj, vj = ref_attn.attn_decode(pj, xj, kj, vj, pos_j, **common)
        yt, kt, vt = port_attn.attn_decode(pt, xt, kt, vt, pos_t, **common)
        _close(yt, yj, dt, f"{case} step {i} y")
        _close(kt, kj, dt, f"{case} step {i} k cache")
        _close(vt, vj, dt, f"{case} step {i} v cache")


# ------------------------------------------------------------------ ssm ---
def _ssm_params(seed=0, D=32, d_inner=64, H=4, N=8):
    ini = ref_layers.Initializer(jax.random.PRNGKey(seed))
    p = ref_ssm.init_ssm(ini, D, d_inner, H, N, 4)
    key = jax.random.PRNGKey(seed + 1)   # non-trivial A, dt bias, conv bias
    p["A_log"] = jax.random.normal(key, p["A_log"].shape) * 0.5
    p["dt_bias"] = jax.random.normal(key, p["dt_bias"].shape) * 0.3 - 1.0
    p["conv_b"] = jax.random.normal(key, p["conv_b"].shape) * 0.1
    return p, _leaves(p)


SSM_KW = dict(d_inner=64, state=8, n_heads=4, head_dim=16)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,chunk", [(32, 8), (16, 256), (24, 8)])
def test_ssm_forward_matches_reference(S, chunk, dt):
    pj, pt = _ssm_params()
    xj, xt = _pair(np.random.default_rng(3), (2, S, 32), dt)
    ref = ref_ssm.ssm_forward(pj, xj, chunk=chunk, **SSM_KW)
    got = port_ssm.ssm_forward(pt, xt, chunk=chunk, **SSM_KW)
    _close(got, ref, dt, f"S={S} chunk={chunk}")


def test_ssm_forward_keeps_the_chunk_limit():
    _, pt = _ssm_params()
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        port_ssm.ssm_forward(pt, torch.zeros(1, 12, 32), chunk=8, **SSM_KW)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_decode_matches_reference(dt):
    pj, pt = _ssm_params(seed=4)
    jd, td = DTYPES[dt]
    cj, hj = ref_ssm.init_ssm_cache(None, 2, 64, 8, 4, 16, 4, dtype=jd)
    cj = cj.astype(jd)
    hj = hj.astype(jnp.float32)
    ct, ht = port_ssm.init_ssm_cache(2, 64, 8, 4, 16, 4, dtype=td,
                                     device="cpu")
    ht = ht.float()
    rng = np.random.default_rng(5)
    for i in range(6):
        xj, xt = _pair(rng, (2, 1, 32), dt)
        yj, cj, hj = ref_ssm.ssm_decode(pj, xj, cj, hj, **SSM_KW)
        yt, ct, ht = port_ssm.ssm_decode(pt, xt, ct, ht, **SSM_KW)
        _close(yt, yj, dt, f"step {i} y")
        _close(ct, cj, dt, f"step {i} conv state")
        _close(ht, hj, dt, f"step {i} ssm state")


# ------------------------------------------------------------------ moe ---
def _moe_params(E=8, D=32, F=16, seed=0):
    ini = ref_layers.Initializer(jax.random.PRNGKey(seed))
    p = ref_moe.init_moe(ini, D, E, F)
    return p, _leaves(p)


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_moe_forward_matches_reference_f32(cf):
    """Drop-free, default and overflowing capacity (tokens dropped)."""
    pj, pt = _moe_params()
    xj, xt = _pair(np.random.default_rng(6), (2, 24, 32), "f32")
    ref, aux_r = ref_moe.moe_forward(pj, xj, n_experts=8, top_k=2,
                                     capacity_factor=cf)
    got, aux_t = port_moe.moe_forward(pt, xt, n_experts=8, top_k=2,
                                      capacity_factor=cf)
    assert_f32_close(got, ref, f"cf={cf}")
    assert_f32_close(aux_t, aux_r, "aux")
    # does some expert get more pairs than its capacity in a sequence?
    probs = torch.softmax(xt.reshape(48, 32) @ pt["router"], -1)
    ids = torch.topk(probs, 2).indices.reshape(2, 48).numpy()
    C = int(24 * 2 * cf / 8) + 1
    overflow = max(np.bincount(g, minlength=8).max() for g in ids) > C
    assert overflow == (cf < 8.0)      # 8.0 is drop-free


def test_moe_forward_bf16_and_deterministic_combine():
    pj, pt = _moe_params(seed=1)
    xj, xt = _pair(np.random.default_rng(7), (2, 24, 32), "bf16")
    ref, _ = ref_moe.moe_forward(pj, xj, n_experts=8, top_k=2,
                                 capacity_factor=1.25)
    gaps = []
    with router_gaps(gaps):
        got, _ = port_moe.moe_forward(pt, xt, n_experts=8, top_k=2,
                                      capacity_factor=1.25)
    again, _ = port_moe.moe_forward(pt, xt, n_experts=8, top_k=2,
                                    capacity_factor=1.25)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    tie = (gaps[0] < ROUTER_TIE).reshape(2, 24)
    g, r = np32(got), np32(ref)
    tol = 0.02 * np.abs(r).max()
    assert (np.abs(g - r).max(-1)[~tie] <= tol).all()


# --------------------------------------------------------- whole models ---
def _model(arch, seed=0):
    cfg = ref_configs.get_config(arch).reduced()
    if cfg.family == "moe":
        # drop-free, as the reference's decode-vs-forward test: teacher-
        # forced and incremental dispatch compete for capacity differently
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, port_cfg(cfg), carry(cfg, params)


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    img = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model))
           .astype(np.float32) if cfg.family == "vlm" else None)
    return tokens, img


def _run_both(arch, f32):
    """Forward, a teacher-forced decode and the final caches, from both
    packages, plus the port's router gaps (MoE)."""
    cfg, params, tcfg, tparams = _model(arch)
    tokens, img = _inputs(cfg)
    out = {}
    with compute_dtype(f32):
        jd = jnp.float32 if f32 else jnp.bfloat16
        td = torch.float32 if f32 else torch.bfloat16
        fwd = jax.jit(lambda p, t, i: ref_lm.forward(
            p, cfg, t, image_embed=i, attn_chunk=8, remat=False))
        out["ref_fwd"] = fwd(params, tokens, img)
        gaps_f, gaps_d = [], []
        with router_gaps(gaps_f):
            out["fwd"] = port_lm.forward(
                tparams, tcfg, tokens, attn_chunk=8,
                image_embed=None if img is None else torch.from_numpy(img))
        out["gaps_fwd"] = gaps_f
        if cfg.family == "vlm":        # the reference skips vlm decode
            return cfg, out
        B, S = tokens.shape
        rc = ref_lm.init_cache(cfg, B, 32, dtype=jd)
        tc = port_lm.init_cache(tcfg, B, 32, dtype=td, device="cpu")
        step = jax.jit(lambda p, t, c, pos: ref_lm.decode_step(p, cfg, t, c,
                                                               pos))
        rl, tl = [], []
        with router_gaps(gaps_d):
            for pos in range(S):
                lg, rc = step(params, tokens[:, pos:pos + 1], rc,
                              jnp.int32(pos))
                rl.append(np32(lg[:, 0]))
                lg, tc = port_lm.decode_step(tparams, tcfg,
                                             tokens[:, pos:pos + 1], tc, pos)
                tl.append(np32(lg[:, 0]))
        out.update(ref_dec=np.stack(rl, 1), dec=np.stack(tl, 1),
                   ref_cache=rc, cache=tc, gaps_dec=gaps_d)
    return cfg, out


@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_lm_matches_reference_f32(arch):
    cfg, out = _run_both(arch, f32=True)
    assert_f32_close(out["fwd"][0], out["ref_fwd"][0], "forward logits")
    assert_f32_close(out["fwd"][1], out["ref_fwd"][1], "aux loss")
    if cfg.family == "moe":
        assert float(out["fwd"][1]) > 0
    if cfg.family == "vlm":
        return
    assert_f32_close(out["dec"], out["ref_dec"], "decode logits")
    assert sorted(out["cache"]) == sorted(out["ref_cache"])
    for k, v in out["ref_cache"].items():
        assert out["cache"][k].dtype == (torch.float32)
        assert_f32_close(out["cache"][k], v, f"cache {k}")


def _tie_mask(gaps, shape):
    """Positions where some layer's router had a near-tie."""
    if not gaps:
        return None
    return np.any([g.reshape(shape) < ROUTER_TIE for g in gaps], axis=0)


@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_lm_matches_reference_bf16(arch):
    cfg, out = _run_both(arch, f32=False)
    fwd = out["fwd"][0]
    assert fwd.dtype == torch.bfloat16
    B, S = fwd.shape[:2]
    skip = _tie_mask(out["gaps_fwd"], (B, -1))
    if skip is not None:
        skip = skip[:, -S:]
    bf16_contract(fwd, out["ref_fwd"][0], skip, "forward")
    if cfg.family == "vlm":
        return
    dec_skip = None
    if out["gaps_dec"]:
        L = cfg.n_layers
        g = np.stack(out["gaps_dec"]).reshape(S, L, B) < ROUTER_TIE
        dec_skip = g.any(1).T
    bf16_contract(out["dec"], out["ref_dec"], dec_skip, "decode")
    for k, v in out["ref_cache"].items():
        c, r = np32(out["cache"][k]), np32(v)
        assert out["cache"][k].dtype == (torch.float32 if k == "ssm"
                                         else torch.bfloat16), k
        # a routing tie changes that position's later-layer cache entries
        if dec_skip is None or not dec_skip.any():
            assert np.abs(c - r).max() <= 0.05 * np.abs(r).max(), k


def test_hymba_global_vs_swa_differs():
    """Global-attention layers see beyond the window, in both packages and
    alike."""
    cfg, params, tcfg, tparams = _model("hymba_1p5b")
    assert cfg.window and cfg.global_layers
    rng = np.random.default_rng(9)
    t1 = rng.integers(0, cfg.vocab, (1, 64)).astype(np.int32)
    t2 = t1.copy()
    t2[0, 1] = (t2[0, 1] + 7) % cfg.vocab     # outside every SWA window
    with compute_dtype(True):
        l1, _ = port_lm.forward(tparams, tcfg, t1, attn_chunk=8)
        l2, _ = port_lm.forward(tparams, tcfg, t2, attn_chunk=8)
        r1, _ = ref_lm.forward(params, cfg, t1, attn_chunk=8, remat=False)
        r2, _ = ref_lm.forward(params, cfg, t2, attn_chunk=8, remat=False)
    d_port = np32(l1[0, -1] - l2[0, -1])
    assert np.abs(d_port).max() > 0
    assert_f32_close(d_port, np32(r1[0, -1]) - np32(r2[0, -1]),
                     "global-layer effect")
    # with every layer on the window, the far token no longer reaches the
    # last position through attention (the SSM state still carries it)
    swa = dataclasses.replace(tcfg, global_layers=())
    with compute_dtype(True):
        s1, _ = port_lm.forward(tparams, swa, t1, attn_chunk=8)
        s2, _ = port_lm.forward(tparams, swa, t2, attn_chunk=8)
    assert not np.allclose(np32(s1[0, -1] - s2[0, -1]), d_port)


def test_loss_fn_matches_reference():
    cfg, params, tcfg, tparams = _model("granite_moe_3b_a800m")
    tokens, _ = _inputs(cfg, S=16, seed=3)
    labels = np.roll(tokens, -1, axis=1)
    with compute_dtype(True):
        ref = ref_lm.loss_fn(params, cfg, tokens, labels, attn_chunk=8,
                             remat=False)
        got = port_lm.loss_fn(tparams, tcfg, tokens, labels, attn_chunk=8)
    assert_f32_close(got, ref, "loss")


# -------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ref_configs.ALL_ARCHS)
def test_configs_equal_reference(arch):
    ref = ref_configs.get_config(arch)
    got = port_configs.get_config(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    for r, g in ((ref, got), (ref.reduced(), got.reduced())):
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
        assert g.param_count() == r.param_count()
        for prop in ("head_dim", "d_inner", "ssm_heads", "attention_free",
                     "subquadratic"):
            assert getattr(g, prop) == getattr(r, prop), prop
    assert [c.name for c in port_configs.applicable_shapes(got)] == \
        [c.name for c in ref_configs.applicable_shapes(ref)]


def test_config_registry_equals_reference():
    assert port_configs.ALL_ARCHS == ref_configs.ALL_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()
            } == {k: dataclasses.asdict(v)
                  for k, v in ref_configs.SHAPES.items()}
    assert 1.5e9 < port_configs.get_config("hymba_1p5b").param_count() \
        < 1.7e9


@pytest.mark.parametrize("arch", ["hymba_1p5b", "qwen3_moe_235b_a22b",
                                  "paligemma_3b", "mamba2_2p7b"])
def test_init_params_layout_matches_reference(arch):
    cfg = ref_configs.get_config(arch).reduced()
    shapes = jax.tree.map(lambda s: s.shape, ref_lm.abstract_params(cfg))
    got = port_lm.init_params(port_cfg(cfg), 0, device="cpu")
    assert tuple(got.embed.shape) == shapes["embed"]
    assert (got.lm_head is None) == ("lm_head" not in shapes)
    assert len(got.layers) == cfg.n_layers
    n = 0
    for blk in got.layers:
        for name, p in blk.named_parameters():
            path = name.split(".")
            ref_shape = shapes["layers"]
            for part in path:
                ref_shape = ref_shape[part]
            assert (cfg.n_layers,) + tuple(p.shape) == ref_shape, name
            assert p.dtype == torch.float32
            n += p.numel()
    n_ref = sum(np.prod(s) for s in jax.tree.leaves(
        shapes["layers"], is_leaf=lambda x: isinstance(x, tuple)))
    assert n == n_ref
    # the same seed draws the same weights
    again = port_lm.init_params(port_cfg(cfg), 0, device="cpu")
    assert torch.equal(got.layers[-1].ln1, again.layers[-1].ln1)
    assert torch.equal(got.embed, again.embed)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg = port_configs.get_config("granite_8b").reduced()
    for call in (lambda: port_lm.init_params(cfg),
                 lambda: port_lm.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


if __name__ == "__main__":
    # The contract's measured maxima over every reduced arch:
    #   JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/test_torch_lm.py
    for arch in ref_configs.ALL_ARCHS:
        for f32 in (True, False):
            cfg, out = _run_both(arch, f32)
            B, S = out["fwd"][0].shape[:2]
            pairs = [("forward", out["fwd"][0], out["ref_fwd"][0],
                      _tie_mask(out["gaps_fwd"], (B, -1)))]
            if "dec" in out:
                skip = None
                if out["gaps_dec"]:
                    skip = (np.stack(out["gaps_dec"]).reshape(
                        S, cfg.n_layers, B) < ROUTER_TIE).any(1).T
                pairs.append(("decode", out["dec"], out["ref_dec"], skip))
            row = []
            for name, got, ref, skip in pairs:
                g, r = np32(got), np32(ref)
                if f32:
                    row.append(f"{name} {np.abs(g - r).max():.3g}")
                    continue
                rel = np.abs(g - r).max(-1) / np.abs(r).max(-1)
                if skip is not None:
                    skip = skip[:, -S:]
                    row.append(f"{name} {rel[~skip].max():.4f} "
                               f"({int(skip.sum())} of {skip.size} exempt, "
                               f"{rel.max():.4f} with them)")
                else:
                    row.append(f"{name} {rel.max():.4f}")
            if f32 and "cache" in out:
                row.append("caches " + str(max(
                    float(np.abs(np32(out["cache"][k]) - np32(v)).max())
                    for k, v in out["ref_cache"].items())))
            print(arch, "float32 max abs" if f32 else
                  "bf16 max gap / max|logit|", "; ".join(row), flush=True)
