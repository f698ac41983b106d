"""Architecture + shape configuration system.

Every assigned architecture is a :class:`ArchConfig` in its own module
(``repro_torch/configs/<id>.py``), field for field the JAX package's own
copy.  ``reduced()`` returns a tiny same-family config for CPU tests; the
full configs run on the card (``chip_smoke.py`` drives hymba_1p5b at its
published width).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

__all__ = ["ArchConfig", "ShapeCell", "get_config", "ALL_ARCHS", "SHAPES",
           "applicable_shapes"]

ALL_ARCHS = [
    "granite_34b", "minicpm_2b", "granite_8b", "command_r_35b", "mamba2_2p7b",
    "qwen3_moe_235b_a22b", "granite_moe_3b_a800m", "musicgen_large",
    "paligemma_3b", "hymba_1p5b",
]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str            # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None          # default d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64

    # attention pattern
    window: int = 0               # 0 = full attention; >0 = sliding window
    global_layers: Tuple[int, ...] = ()   # hybrid: layers with full attention
    prefix_len: int = 0           # vlm: bidirectional prefix (patch tokens)

    # training defaults
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    lr_schedule: str = "cosine"   # 'cosine' | 'wsd'
    use_bias: bool = False

    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (paper brief: skip pure
        full-attention archs for long_500k)."""
        return self.family == "ssm" or (self.family == "hybrid" and self.window > 0)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, H, KV, hd, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.head_dim, self.d_ff, self.vocab,
                                 self.n_layers)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            per_layer += D * (H + 2 * KV) * hd + H * hd * D   # qkv + o
            per_layer += 2 * D                                  # norms
        if self.family == "moe":
            per_layer += D * self.n_experts
            per_layer += self.n_experts * 3 * D * self.d_ff_expert
        elif self.family in ("dense", "vlm", "audio", "hybrid"):
            per_layer += 3 * D * F
        if self.family in ("ssm", "hybrid"):
            di, st, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += D * (2 * di + 2 * st + nh)   # in_proj
            per_layer += di * self.ssm_conv + 3 * nh + di  # conv, A/D/dt_bias, norm
            per_layer += di * D                       # out_proj
            per_layer += D if self.family == "ssm" else 0
        emb = V * D * (1 if self.tie_embeddings else 2)
        return emb + L * per_layer + D

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4),
            d_ff=128,
            vocab=256,
            d_head=16,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=32 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            window=min(self.window, 16) if self.window else 0,
            global_layers=(0,) if self.global_layers else (),
            prefix_len=4 if self.prefix_len else 0,
        )


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def applicable_shapes(cfg: ArchConfig) -> List[ShapeCell]:
    """All 4 shapes, minus long_500k for pure full-attention archs."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        cells.append(SHAPES["long_500k"])
    return cells
