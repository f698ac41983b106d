"""Granite-MoE-3B-A800M: 40 experts top-8, GQA kv=8.  [hf:ibm-granite]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_moe_3b_a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8, d_ff_expert=512,
    notes="40 experts do not divide mp=16; EP uses padded expert sharding",
)
