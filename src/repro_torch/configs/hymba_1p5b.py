"""Hymba-1.5B: hybrid parallel attention + mamba heads.  [arXiv:2411.13676]

Parallel attn+SSM in every block; sliding-window attention everywhere except
3 global-attention layers (first/middle/last), per the paper.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba_1p5b", family="hybrid", n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_ff=5504, vocab=32001, d_head=64,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    window=1024, global_layers=(0, 15, 31),
    notes="SWA + 3 global layers; SSM state 16; subquadratic -> long_500k runs",
)
