"""The port's sharding rules and abstract state against the reference's,
with no process group.

Every architecture of ``ALL_ARCHS`` at its published width (qwen3_moe_235b
included) is built on torch's ``meta`` device (``abstract_params``,
``abstract_cache``, ``abstract_train_state``) and held against the
reference's abstract trees, shape and dtype for every leaf.  The placement
rules (``param_specs``, ``opt_state_specs``, ``cache_specs``,
``batch_specs``) take an ``AbstractMesh`` of axis names and sizes and are
held against the reference's ``PartitionSpec``s on
``jax.sharding.AbstractMesh`` of the same shapes: (1, 1), (2, 2), (4, 2),
(16, 16) and the multi-pod (2, 16, 16).  The port keeps one block per
layer, so a layer leaf's spec is the reference's stacked spec without its
leading ``L`` entry (never sharded).  Caches are taken at every
``applicable_shapes(cfg)`` cell's batch and length.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.configs import base as ref_base
from repro.distributed import logical as ref_logical
from repro.distributed import sharding as ref_sharding
from repro.models import lm as ref_lm
from repro.train import steps as ref_steps
from repro_torch.configs.base import ALL_ARCHS, applicable_shapes, get_config
from repro_torch.distributed import logical, sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import layers, lm
from repro_torch.models.convert import reference_path
from repro_torch.train import steps

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = get_config(arch)
    return cfg, lm.abstract_params(cfg), ref_lm.abstract_params(
        ref_base.get_config(arch))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _same_struct(port_leaf, ref_leaf, layer):
    want = tuple(ref_leaf.shape)
    if layer is not None:
        want = want[1:]
    assert tuple(port_leaf.shape) == want
    assert port_leaf.dtype == DTYPES[jnp.dtype(ref_leaf.dtype)]
    assert port_leaf.device.type == "meta"


def _meshes(shape, names):
    return logical.AbstractMesh(shape, names), RefAbstractMesh(shape, names)


# ---------------------------------------------------------------- abstract
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_match_reference(arch):
    cfg, port, ref = _abstract(arch)
    seen = set()
    for name, p in port.named_parameters():
        path, layer = reference_path(name)
        ref_leaf = _at(ref, path)
        _same_struct(p, ref_leaf, layer)
        if layer is not None:
            assert ref_leaf.shape[0] == cfg.n_layers
        seen.add(path)
    assert seen == set(_ref_leaves(ref))
    assert len(port.layers) == cfg.n_layers


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_train_state_matches_reference(arch):
    cfg = get_config(arch)
    port = steps.abstract_train_state(cfg)
    ref = ref_steps.abstract_train_state(ref_base.get_config(arch))
    for tree in ("m", "v"):
        for name, p in port["opt"][tree].named_parameters():
            path, layer = reference_path(name)
            _same_struct(p, _at(ref["opt"][tree], path), layer)
            assert not p.requires_grad
    step = port["opt"]["step"]
    assert step.shape == ref["opt"]["step"].shape == ()
    assert step.dtype == torch.int32 and step.device.type == "meta"
    assert sum(1 for _ in port["params"].parameters()) \
        == sum(1 for _ in port["opt"]["m"].parameters())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_cache_matches_reference(arch):
    cfg = get_config(arch)
    rcfg = ref_base.get_config(arch)
    for cell in applicable_shapes(cfg):
        port = lm.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        ref = ref_lm.abstract_cache(rcfg, cell.global_batch, cell.seq_len)
        assert set(port) == set(ref)
        for k, t in port.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(ref[k].shape), (cell.name, k)
            assert t.dtype == DTYPES[jnp.dtype(ref[k].dtype)]


def test_initializer_const_and_abstract_leaves():
    value = np.arange(6, dtype=np.float64).reshape(2, 3) / 7
    ini = layers.Initializer(torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    got = ini.const(value)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), value.astype(np.float32))
    assert ini.const(value, dtype=torch.float64).numpy().tolist() \
        == value.tolist()
    abstract = layers.Initializer()
    assert abstract.abstract
    for t in (abstract.const(value), abstract.normal((4, 5), fan_in=4),
              abstract.zeros((3,)), abstract.ones((2, 2), torch.bfloat16)):
        assert t.device.type == "meta"
    assert abstract.const(value).shape == (2, 3)
    assert abstract.ones((2, 2), torch.bfloat16).dtype == torch.bfloat16


def test_abstract_params_allocate_nothing():
    """qwen3_moe_235b's 235B parameters exist only as shapes."""
    cfg, port, _ = _abstract("qwen3_moe_235b_a22b")
    n = sum(p.numel() for p in port.parameters())
    assert n > 2e11
    assert all(p.device.type == "meta" for p in port.parameters())


# ------------------------------------------------------------------ specs
def _check_param_specs(port_specs, ref_specs, port_params):
    for name, p in port_params.named_parameters():
        path, layer = reference_path(name)
        want = tuple(_at(ref_specs, path))
        if layer is not None:
            assert want[0] is None
            want = want[1:]
        assert port_specs[name] == want, (name, port_specs[name], want)


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, shape, names):
    _, port, ref = _abstract(arch)
    pm, rm = _meshes(shape, names)
    _check_param_specs(sharding.param_specs(port, pm),
                       ref_sharding.param_specs(ref, rm), port)


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_opt_state_specs_match_reference(arch, shape, names):
    cfg = get_config(arch)
    port = steps.abstract_train_state(cfg)
    ref = ref_steps.abstract_train_state(ref_base.get_config(arch))
    pm, rm = _meshes(shape, names)
    _check_param_specs(sharding.opt_state_specs(port["opt"]["m"], pm),
                       ref_sharding.opt_state_specs(ref["opt"]["m"], rm),
                       port["opt"]["m"])


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch, shape, names):
    cfg = get_config(arch)
    rcfg = ref_base.get_config(arch)
    pm, rm = _meshes(shape, names)
    for cell in applicable_shapes(cfg):
        port = lm.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        ref = ref_lm.abstract_cache(rcfg, cell.global_batch, cell.seq_len)
        got = sharding.cache_specs(cfg, port, pm)
        want = ref_sharding.cache_specs(rcfg, ref, rm)
        for k in port:
            assert got[k] == tuple(want[k]), (cell.name, k)


@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_batch_specs_match_reference(shape, names, with_image):
    pm, rm = _meshes(shape, names)
    got = sharding.batch_specs(pm, with_image=with_image)
    want = ref_sharding.batch_specs(rm, with_image=with_image)
    assert set(got) == set(want)
    for k in got:
        assert got[k] == tuple(want[k])
    assert sharding.tp_size(pm) == ref_sharding.tp_size(rm)


@pytest.mark.parametrize("arch", ["hymba_1p5b", "minicpm_2b",
                                  "granite_moe_3b_a800m"])
def test_fallbacks_for_heads_and_experts_that_do_not_divide(arch):
    """25 and 36 heads and 40 experts on a 16-wide model axis: the
    reference's fallback dims, not the head or expert dims."""
    _, port, _ = _abstract(arch)
    specs = sharding.param_specs(port,
                                 logical.AbstractMesh((16, 16),
                                                      ("data", "model")))
    if arch == "granite_moe_3b_a800m":
        # (E=40, D, Fe): experts do not divide 16, d_ff_expert does
        assert specs["layers.0.moe.w_gate"] == (None, "data", "model")
        assert specs["layers.0.moe.w_down"] == (None, "model", "data")
    else:
        # (D, H, hd): heads do not divide 16, and head_dim is never sharded
        assert specs["layers.0.attn.wq"] == ("data", None, None)
        assert specs["layers.0.attn.wo"] == (None, None, "data")


def test_placements_and_named_sharding_on_meta():
    from torch.distributed.tensor import Replicate, Shard
    # a stand-in with the DeviceMesh's names and shape (no process group)
    mesh = logical.AbstractMesh((2, 4, 2), ("pod", "data", "model"))
    assert logical.placements_for((("pod", "data"), "model", None), mesh) \
        == [Shard(0), Shard(0), Shard(1)]
    assert logical.placements_for((None, "data"), mesh) \
        == [Replicate(), Shard(1), Replicate()]
    # a mesh dim of size 1 shards nothing
    one = logical.AbstractMesh((1, 2), ("data", "model"))
    assert logical.placements_for(("data", "model"), one) \
        == [Replicate(), Shard(1)]
    cfg = get_config("granite_8b")
    st = steps.abstract_train_state(cfg)
    pm = logical.AbstractMesh((16, 16), ("data", "model"))
    ps = sharding.param_specs(st["params"], pm)
    named = {n: p for n, p in st["params"].named_parameters()}
    out = sharding.with_named_sharding(named, ps, pm)
    wq = out["layers.0.attn.wq"]
    assert wq.spec == ps["layers.0.attn.wq"] == ("data", "model", None)
    assert wq.full.shape == named["layers.0.attn.wq"].shape
    D, H, hd = wq.full.shape
    assert tuple(wq.local.shape) == (D // 16, H // 16, hd)
    assert wq.local.device.type == "meta" and wq.local.dtype == torch.float32


# ---------------------------------------------------------------- logical
@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_resolve_matches_reference(shape, names):
    pm, rm = _meshes(shape, names)
    for name in (None, "batch", "tp", "sp"):
        assert logical._resolve(name, logical.mesh_axes(pm)) \
            == ref_logical._resolve(name, rm)
    with pytest.raises(KeyError):
        logical._resolve("heads", logical.mesh_axes(pm))


def test_hint_spec_leaves_dims_that_do_not_divide_unsharded():
    pm = logical.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    # hymba: 25 heads on 16 stay unsharded; 32,001 vocab too
    assert logical.hint_spec((64, 25, 4096, 64), ("batch", "tp", None, None),
                             pm) == (("pod", "data"), None, None, None)
    assert logical.hint_spec((64, 4096, 32001), ("batch", None, "tp"), pm) \
        == (("pod", "data"), None, None)
    assert logical.hint_spec((64, 4096, 32000), ("batch", "sp", "tp"), pm) \
        == (("pod", "data"), "model", "model")
    # a batch smaller than the axes, and a size-1 axis
    assert logical.hint_spec((16, 8), ("batch", None), pm) == (None, None)
    one = logical.AbstractMesh((4, 1), ("data", "model"))
    assert logical.hint_spec((8, 16), ("batch", "tp"), one) == ("data", None)
    with pytest.raises(ValueError):
        logical.hint_spec((8, 16), ("batch",), one)


def test_shard_hint_is_identity_without_a_mesh_or_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert logical.current_mesh() is None
    assert logical.shard_hint(x, "batch", "tp") is x
    with logical.axis_env(logical.AbstractMesh((2, 2), ("data", "model"))):
        assert logical.shard_hint(x, "batch", "tp") is x
        assert logical.tp_size_of() == 2
    assert logical.tp_size_of() == 1


def test_axis_env_and_perf_env_nest_and_restore():
    a = logical.AbstractMesh((1, 2), ("data", "model"))
    b = logical.AbstractMesh((2, 4), ("data", "model"))
    assert logical.get_opt("head_pad") and logical.get_opt("expert_pad")
    with logical.axis_env(a):
        assert logical.current_mesh() is a and logical.tp_size_of() == 2
        with logical.axis_env(b):
            assert logical.current_mesh() is b and logical.tp_size_of() == 4
        assert logical.current_mesh() is a
        with logical.perf_env(head_pad=False):
            assert not logical.get_opt("head_pad")
            assert logical.get_opt("expert_pad")
            with logical.perf_env(expert_pad=False):
                assert not logical.get_opt("head_pad")
                assert not logical.get_opt("expert_pad")
            assert logical.get_opt("expert_pad")
        assert logical.get_opt("head_pad")
    assert logical.current_mesh() is None
    assert logical.get_opt("unknown") is None
    with pytest.raises(RuntimeError):
        with logical.axis_env(a):
            raise RuntimeError("restores on the way out")
    assert logical.current_mesh() is None


def test_defaults_are_the_references():
    assert logical._DEFAULT_OPTS == ref_logical._DEFAULT_OPTS


def test_production_mesh_shapes_and_axis_helpers():
    single = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert logical.mesh_axes(single) == {"data": 16, "model": 16}
    assert logical.mesh_axes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert port_mesh.batch_axes(multi) == ("pod", "data")
    assert port_mesh.fsdp_axes(single) == ("data",)
    assert port_mesh.MODEL_AXIS == "model"
    with pytest.raises(ValueError):
        logical.AbstractMesh((2, 2), ("data",))


def test_captured_env_reenters_on_another_thread():
    """The autograd engine recomputes checkpointed blocks on a device
    thread for CUDA tensors: the forward passes ``captured_env`` to the
    recompute so it sees the same mesh and options."""
    import threading
    mesh = logical.AbstractMesh((1, 2), ("data", "model"))
    seen = {}
    with logical.axis_env(mesh), logical.perf_env(head_pad=False):
        env = logical.captured_env()

    def other():
        seen["before"] = logical.current_mesh()
        with env():
            seen["inside"] = (logical.current_mesh(), logical.tp_size_of(),
                              logical.get_opt("head_pad"))
        seen["after"] = logical.current_mesh()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen["before"] is None and seen["after"] is None
    assert seen["inside"] == (mesh, 2, False)
