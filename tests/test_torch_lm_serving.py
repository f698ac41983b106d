"""The port's LM serving path against the JAX package: the token pipeline
bit for bit, ``generate``, the continuous-batching ``ServingEngine`` and the
prefill step, then the twins on the CPU.

Float32 compute gives the reference's tokens exactly; the bf16 path gives
them until a near-tie (``_torch_lm.first_divergence_ok``).  The reference
runs are shared through module-scoped fixtures.
"""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.tokens as ref_tokens
import repro.launch.serve as ref_serve
import repro.models.lm as ref_lm
import repro.serve.engine as ref_engine
import repro.train.steps as ref_steps
import repro_torch.data.tokens as port_tokens
import repro_torch.launch.serve as port_serve
import repro_torch.models.lm as port_lm
import repro_torch.serve as port_serve_pkg
import repro_torch.train.steps as port_steps
from repro.configs.base import get_config
from _torch_lm import (assert_f32_close, carry, compute_dtype,
                       first_divergence_ok, np32, port_cfg)


# --------------------------------------------------------------- tokens ---
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab", [256, 4096, 32001])
def test_synthetic_corpus_equals_reference(seed, vocab):
    ref = ref_tokens.SyntheticCorpus(vocab=vocab, seed=seed)
    got = port_tokens.SyntheticCorpus(vocab=vocab, seed=seed)
    np.testing.assert_array_equal(got.motifs, ref.motifs)
    a = got.sample(np.random.default_rng(seed + 3), 5, 77)
    b = ref.sample(np.random.default_rng(seed + 3), 5, 77)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(vocab=512, global_batch=8, seq_len=64, seed=7),
    dict(vocab=300, global_batch=6, seq_len=17, seed=2, host_id=1,
         n_hosts=3),
    dict(vocab=256, global_batch=4, seq_len=12, seed=0,
         d_model_for_image=16, image_prefix=4),
])
def test_token_pipeline_equals_reference(kw):
    ref, got = ref_tokens.TokenPipeline(**kw), port_tokens.TokenPipeline(**kw)
    assert got.host_batch == ref.host_batch and len(got) == len(ref)
    for step in (0, 1, 5, 123):
        a, b = got[step], ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------- shared model ---
@pytest.fixture(scope="module")
def granite():
    cfg = get_config("granite_8b").reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, port_cfg(cfg), carry(cfg, params)


def _requests(cls, cfg, n, seed, lens=(6, 3, 9, 4, 7), new=5):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, cfg.vocab, lens[i % len(lens)])
                .astype(np.int32), max_new_tokens=new) for i in range(n)]


def _drain(engine_mod, cfg, params, f32, n_slots=2):
    with compute_dtype(f32):
        eng = engine_mod.ServingEngine(cfg, params, n_slots=n_slots,
                                       max_seq=32)
        for r in _requests(engine_mod.Request, cfg, 5, seed=0):
            eng.submit(r)
        done = eng.run_until_drained()
    return {r.uid: r for r in done}, eng


def _ref_greedy_logits(cfg, params, seq, f32):
    """The reference's single-request decode teacher-forced along
    ``seq``: its logits at each position."""
    with compute_dtype(f32):
        step = jax.jit(lambda p, t, c, pos: ref_lm.decode_step(p, cfg, t, c,
                                                               pos))
        cache = ref_lm.init_cache(cfg, 1, 32)
        out = []
        for pos, t in enumerate(seq):
            lg, cache = step(params, np.array([[t]], np.int32), cache,
                             jnp.int32(pos))
            out.append(np32(lg[0, 0]))
    return np.stack(out)


@pytest.fixture(scope="module")
def ref_engine_runs(granite):
    cfg, params, _, _ = granite
    return {f32: _drain(ref_engine, cfg, params, f32)[0]
            for f32 in (True, False)}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_engine_matches_reference_engine(granite, ref_engine_runs, f32):
    """Continuous admission (5 requests, 2 slots, prompts of 3-9 tokens),
    so lanes decode at different positions in one step."""
    cfg, params, tcfg, tparams = granite
    ref = ref_engine_runs[f32]
    got, eng = _drain(port_serve_pkg, tcfg, tparams, f32)
    assert sorted(got) == sorted(ref) == list(range(5))
    for uid, r in ref.items():
        g = got[uid]
        assert len(g.generated) == len(r.generated) == 5
        if f32 or g.generated == r.generated:
            assert g.generated == r.generated, uid
            continue
        seq = list(r.prompt) + r.generated
        logits = _ref_greedy_logits(cfg, params, seq, f32)[len(r.prompt)
                                                           - 1:]
        assert first_divergence_ok(g.generated, r.generated, logits), uid
    s = eng.stats()
    assert s["requests"] == 5 and s["tokens"] == 25
    assert s["mean_latency_s"] >= s["mean_ttft_s"] > 0


def _greedy(tcfg, tparams, prompt, n_new):
    """The port's single-request greedy decode."""
    cache = port_lm.init_cache(tcfg, 1, 32, device="cpu")
    toks, nxt = list(prompt), None
    for pos in range(len(prompt) + n_new - 1):
        cur = [[toks[pos]]] if pos < len(prompt) else [[nxt]]
        logits, cache = port_lm.decode_step(tparams, tcfg,
                                            np.array(cur, np.int32), cache,
                                            pos)
        nxt = int(torch.argmax(logits[0, -1]))
        if pos >= len(prompt) - 1:
            toks.append(nxt)
    return toks[len(prompt):]


def test_engine_matches_single_request_decode(granite):
    """The port's own form of the reference's engine test: every request
    the engine serves equals a single-request greedy decode."""
    _, _, tcfg, tparams = granite
    with compute_dtype(True):
        got, _ = _drain(port_serve_pkg, tcfg, tparams, True, n_slots=3)
        for r in got.values():
            assert r.generated == _greedy(tcfg, tparams, r.prompt, 5), r.uid


@pytest.mark.parametrize("arch", ["mamba2_2p7b", "hymba_1p5b"])
def test_engine_keeps_recurrent_lanes_apart(arch):
    """SSM and hybrid models: admission starts the admitted lane's SSM
    state from zero and leaves the other lanes' as they were, so each
    request gets its single-request greedy tokens."""
    cfg = get_config(arch).reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(3))
    tcfg, tparams = port_cfg(cfg), carry(cfg, params)
    with compute_dtype(True):
        got, _ = _drain(port_serve_pkg, tcfg, tparams, True)
        for uid, r in got.items():
            assert r.generated == _greedy(tcfg, tparams, r.prompt, 5), uid


def test_reference_engine_drifts_on_recurrent_lanes():
    """Why the port departs from the reference's engine there: the
    reference advances every lane's SSM state at each admission step (and
    keeps a recycled lane's), so on hymba its requests drift from its own
    single-request decode."""
    cfg = get_config("hymba_1p5b").reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(3))
    ref, _ = _drain(ref_engine, cfg, params, True)
    drift = 0
    for r in ref.values():
        lg = _ref_greedy_logits(cfg, params, list(r.prompt) + r.generated,
                                True)
        P = len(r.prompt)
        drift += int(np.any(lg[P - 1:P + 4].argmax(-1) != r.generated))
    assert drift > 0


def test_per_slot_position_decode(granite):
    """Vector-pos decode at mixed offsets (lane 1 a step behind lane 0)
    equals scalar-pos decode of each lane alone."""
    _, _, tcfg, tparams = granite
    rng = np.random.default_rng(3)
    seq = rng.integers(0, tcfg.vocab, 8).astype(np.int32)
    with compute_dtype(True):
        cache_v = port_lm.init_cache(tcfg, 2, 32, device="cpu")
        out = {0: [], 1: []}
        # lane 0 alone first (lane 1 rewrites its position 0 with seq[0])
        lg, cache_v = port_lm.decode_step(
            tparams, tcfg, np.array([[seq[0]], [seq[0]]], np.int32),
            cache_v, torch.tensor([0, 0]))
        out[0].append(lg[0])
        for step in range(1, 6):
            tok = np.array([[seq[step]], [seq[step - 1]]], np.int32)
            lg, cache_v = port_lm.decode_step(
                tparams, tcfg, tok, cache_v, torch.tensor([step, step - 1]))
            out[0].append(lg[0])
            out[1].append(lg[1])
        cache_s = port_lm.init_cache(tcfg, 1, 32, device="cpu")
        ref = []
        for pos in range(6):
            ls, cache_s = port_lm.decode_step(tparams, tcfg,
                                              seq[pos:pos + 1][None],
                                              cache_s, pos)
            ref.append(ls[0])
    for pos in range(6):
        assert_f32_close(out[0][pos], ref[pos], f"lane 0 pos {pos}")
    for pos in range(5):
        assert_f32_close(out[1][pos], ref[pos], f"lane 1 pos {pos}")


def test_engine_continuous_admission(granite):
    """More requests than slots: the pool recycles its slots."""
    _, _, tcfg, tparams = granite
    eng = port_serve_pkg.ServingEngine(tcfg, tparams, n_slots=2, max_seq=64)
    rng = np.random.default_rng(1)
    for i in range(5):
        eng.submit(port_serve_pkg.Request(
            uid=i, prompt=rng.integers(0, tcfg.vocab, 4).astype(np.int32),
            max_new_tokens=3))
    done = eng.run_until_drained()
    assert len(done) == 5 and not eng.active and not eng.queue
    assert {r.slot for r in done} == {0, 1}
    s = eng.stats()
    assert s["requests"] == 5 and s["tokens"] == 15
    assert s["mean_latency_s"] > 0


# ------------------------------------------------------------- generate ---
@pytest.fixture(scope="module")
def hymba():
    cfg = get_config("hymba_1p5b").reduced()
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(1))
    return cfg, params, port_cfg(cfg), carry(cfg, params)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("model", ["granite", "hymba"])
def test_generate_matches_reference(model, f32, request):
    """Lockstep generation past hymba's reduced window (16): 14-token
    prompts and 10 new tokens."""
    cfg, params, tcfg, tparams = request.getfixturevalue(model)
    prompts = ref_tokens.SyntheticCorpus(vocab=cfg.vocab, seed=1).sample(
        np.random.default_rng(0), 3, 14)[:, :14]
    with compute_dtype(f32):
        ref, _ = ref_serve.generate(cfg, params, prompts, 10)
        got, stats = port_serve.generate(tcfg, tparams, prompts, 10)
    assert got.shape == ref.shape == (3, 10) and got.dtype == np.int32
    assert stats["steps"] == 23
    if f32:
        np.testing.assert_array_equal(got, ref)
        return
    for b in range(3):
        if not np.array_equal(got[b], ref[b]):
            seq = list(prompts[b]) + list(ref[b])
            lg = _ref_greedy_logits(cfg, params, seq, False)
            assert first_divergence_ok(got[b], ref[b], lg[13:]), b


def test_prefill_step_matches_reference(granite):
    cfg, params, tcfg, tparams = granite
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 20)) \
        .astype(np.int32)
    with compute_dtype(True):
        ref = ref_steps.make_prefill_step(cfg, attn_chunk=8)(
            params, {"tokens": jnp.asarray(tokens)})
        got = port_steps.make_prefill_step(tcfg, attn_chunk=8)(
            tparams, {"tokens": tokens})
        full, _ = port_lm.forward(tparams, tcfg, tokens, attn_chunk=8)
    assert_f32_close(got, ref, "prefill logits")
    assert_f32_close(got, full, "block-causal vs full scan")
    cache = port_lm.init_cache(tcfg, 2, 8, device="cpu")
    nxt, logits, _ = port_steps.make_decode_step(tcfg)(
        tparams, tokens[:, :1], cache, 0)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).int())


# ---------------------------------------------------------------- twins ---
def test_serve_lm_twin_runs_on_cpu(capsys):
    from repro_torch.serve_lm import ARCHS, main
    out = main(device="cpu")
    assert sorted(out) == sorted(ARCHS)
    for toks in out.values():
        assert toks.shape == (4, 12)
    text = capsys.readouterr().out
    assert text.count("device cpu") == 3 and "hybrid" in text


def test_proximity_head_lm_twin_runs_on_cpu(capsys):
    from repro_torch.proximity_head_lm import main
    res = main(device="cpu")
    assert res["embedding"] == (512, 8)
    assert res["acc"] > 0.5
    assert "leaf-PCA" in capsys.readouterr().out


def test_serve_launcher_runs_on_cpu(capsys):
    out, stats = port_serve.main(["--arch", "mamba2_2p7b", "--reduced",
                                  "--batch", "2", "--prompt-len", "6",
                                  "--gen", "4", "--device", "cpu"])
    assert out.shape == (2, 4) and stats["steps"] == 9
    assert "[serve] generated (2, 4)" in capsys.readouterr().out


@pytest.mark.parametrize("module", ["repro_torch.serve_lm",
                                    "repro_torch.proximity_head_lm",
                                    "repro_torch.launch.serve"])
def test_lm_entry_points_default_to_the_card(module):
    mod = importlib.import_module(module)
    src = inspect.getsource(mod)
    assert 'add_argument("--device", default="cuda")' in src
    if "device" in inspect.signature(mod.main).parameters:
        assert inspect.signature(mod.main).parameters["device"].default \
            == "cuda"
