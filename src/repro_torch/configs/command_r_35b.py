"""Command-R 35B: dense GQA kv=8, no-bias, 256k vocab.  [hf:CohereForAI/c4ai-command-r-v01]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command_r_35b", family="dense", n_layers=40, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22528, vocab=256000, use_bias=False, rope_theta=8e6,
    notes="large vocab stresses embedding/logit sharding",
)
