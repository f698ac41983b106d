"""Helpers shared by the LM port's tests: the numeric contract against the
JAX package and the weights carried across.  The bf16 rule itself lives in
``_lm_contract`` (no jax), which ``chip_smoke.py`` shares."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.lm as ref_lm
import repro_torch.models.lm as port_lm
from _lm_contract import BF16_REL, np32
from repro_torch.configs.base import ArchConfig as PortArchConfig
from repro_torch.models.convert import params_from_reference

TOL_F32 = 1e-4          # float32 compute: atol = rtol


@contextlib.contextmanager
def compute_dtype(f32: bool):
    """Both packages' LM compute dtype: float32, or their bf16 default."""
    old = ref_lm.COMPUTE_DTYPE, port_lm.COMPUTE_DTYPE
    if f32:
        ref_lm.COMPUTE_DTYPE, port_lm.COMPUTE_DTYPE = \
            jnp.float32, torch.float32
    try:
        yield
    finally:
        ref_lm.COMPUTE_DTYPE, port_lm.COMPUTE_DTYPE = old


def port_cfg(cfg):
    """The port's copy of a reference ``ArchConfig``."""
    return PortArchConfig(**dataclasses.asdict(cfg))


def carry(cfg, params, device="cpu"):
    """The reference's parameters as the port's module (same weights)."""
    return params_from_reference(port_cfg(cfg),
                                 jax.tree.map(np.asarray, params),
                                 device=device)


def assert_f32_close(got, ref, what=""):
    got, ref = np32(got), np32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=TOL_F32, rtol=TOL_F32,
                               err_msg=what)
    return float(np.abs(got - ref).max()) if got.size else 0.0


def first_divergence_ok(got, ref, ref_logits):
    """Greedy token streams in bf16: equal until the first difference,
    where the reference's own top-2 margin lies within the contract's
    tolerance (a near-tie the two rounding orders may break apart)."""
    got, ref = np.asarray(got), np.asarray(ref)
    diff = np.flatnonzero(got != ref)
    if diff.size == 0:
        return True
    j = diff[0]
    lg = np32(ref_logits[j])
    top2 = np.sort(lg)[-2:]
    return top2[1] - top2[0] <= BF16_REL * np.abs(lg).max()
