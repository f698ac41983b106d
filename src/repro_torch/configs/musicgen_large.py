"""MusicGen-large: decoder-only over EnCodec tokens.  [arXiv:2306.05284]

Backbone only (per brief): the EnCodec frontend is a stub — input_specs()
provides precomputed frame token ids over the 2048-entry codebook.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
    notes="audio-token LM; MHA; modality frontend stubbed",
)
