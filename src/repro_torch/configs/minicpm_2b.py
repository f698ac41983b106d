"""MiniCPM-2B: llama-like dense, MHA (kv=36), WSD LR schedule.  [arXiv:2404.06395; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm_2b", family="dense", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, d_ff=5760, vocab=122753, lr_schedule="wsd",
    tie_embeddings=True,
    notes="WSD (warmup-stable-decay) schedule wired into the optimizer",
)
