"""Qwen3-MoE-235B-A22B: 94L, 128 experts top-8, GQA kv=4.  [hf:Qwen/Qwen3-*]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b_a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, d_head=128,
    n_experts=128, top_k=8, d_ff_expert=1536,
    notes="expert-parallel over the model axis (8 experts/chip at mp=16)",
)
