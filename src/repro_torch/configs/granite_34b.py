"""Granite-34B-Code: llama-arch dense decoder, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite_34b", family="dense", n_layers=88, d_model=6144, n_heads=48,
    n_kv_heads=1, d_ff=24576, vocab=49152, use_bias=True,
    notes="GQA kv=1 (MQA); code model; bias per granite config",
)
