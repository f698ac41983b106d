"""PaliGemma-3B: SigLIP + gemma decoder; prefix-LM masking.  [arXiv:2407.07726]

Backbone only: SigLIP patch embeddings arrive precomputed (stub frontend);
the 256-token image prefix attends bidirectionally, text is causal.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma_3b", family="vlm", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, d_ff=16384, vocab=257216, d_head=256, prefix_len=256,
    tie_embeddings=True,
    notes="gemma-style wide d_ff, MQA, huge vocab; image frontend stubbed",
)
