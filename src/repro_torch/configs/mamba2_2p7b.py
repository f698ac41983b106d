"""Mamba2-2.7B: attention-free SSD (state-space duality).  [arXiv:2405.21060]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_2p7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, tie_embeddings=True,
    notes="SSD chunked scan; O(1)-state decode enables long_500k",
)
