"""Unified decoder LM over all assigned architecture families.

One parameter layout + the reference's entry points:

  - ``forward(params, cfg, tokens, ...)``       — logits for prefill
  - ``decode_step(params, cfg, token, cache, pos)`` — one-token serve step
  - ``init_params(cfg, seed)`` / ``init_cache(cfg, batch, seq_len)``
  - ``loss_fn`` (forward only: the training slice adds the backward pass)

``params`` is an :class:`LM` module with one :class:`Block` per layer in an
``nn.ModuleList``; each block holds the JAX package's leaves under the same
names (``blk.attn["wq"]``, ``blk.ssm["in_proj"]``, ``blk.mlp["w_gate"]``,
...), and :mod:`.convert` carries the reference's stacked pytree across.
Layers run in a Python loop with no rematerialization (inference).  Caches
keep the reference's stacked layout (a leading layer axis) and are updated
in place; ``decode_step`` returns them all the same.

VLM (paligemma): ``image_embed`` (B, P, D) precomputed patch embeddings (stub
frontend) are prepended to the token embeddings and the mask is prefix-LM.
Audio (musicgen): token ids over the EnCodec codebook — the frontend is
likewise a stub.

The reference shards and pads the vocabulary, heads and experts when
``tp > 1`` (``shard_hint``, ``tp_size_of``, ``get_opt``); on one device
those are no-ops, and they come back with the multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from .attention import attn_decode, attn_forward, init_attn
from .layers import COMPUTE_DTYPE, Initializer, rms_norm, silu
from .moe import init_moe, moe_forward
from .ssm import init_ssm, ssm_decode, ssm_forward

__all__ = ["LM", "Block", "init_params", "forward", "decode_step",
           "init_cache", "loss_fn"]


def _pdict(leaves: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in leaves.items()})


class Block(nn.Module):
    """One decoder layer: ``ln1``/``ln2`` and the family's sub-blocks
    (``attn``, ``ssm``, ``mlp``, ``moe``), each a ``ParameterDict``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, v in leaves.items():
            if isinstance(v, dict):
                setattr(self, name, _pdict(v))
            else:
                setattr(self, name, nn.Parameter(v, requires_grad=False))


class LM(nn.Module):
    """The parameters of one decoder LM (``embed``, ``layers``,
    ``final_norm``, ``lm_head`` unless tied)."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = None if lm_head is None else \
            nn.Parameter(lm_head, requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.t() if self.lm_head is None else self.lm_head


# --------------------------------------------------------------------------
# parameter construction
# --------------------------------------------------------------------------
def _init_block(ini: Initializer, cfg: ArchConfig) -> dict:
    D = cfg.d_model
    p = {"ln1": ini.ones((D,))}
    fam = cfg.family
    if fam in ("dense", "vlm", "audio", "moe", "hybrid"):
        p["attn"] = init_attn(ini, D, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.use_bias)
    if fam in ("ssm", "hybrid"):
        p["ssm"] = init_ssm(ini, D, cfg.d_inner, cfg.ssm_heads,
                            cfg.ssm_state, cfg.ssm_conv)
    if fam == "moe":
        p["ln2"] = ini.ones((D,))
        p["moe"] = init_moe(ini, D, cfg.n_experts, cfg.d_ff_expert)
    elif fam in ("dense", "vlm", "audio", "hybrid"):
        p["ln2"] = ini.ones((D,))
        p["mlp"] = {
            "w_gate": ini.normal((D, cfg.d_ff), fan_in=D),
            "w_up": ini.normal((D, cfg.d_ff), fan_in=D),
            "w_down": ini.normal((cfg.d_ff, D), fan_in=cfg.d_ff),
        }
    return p


def init_params(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0,
                device="cuda") -> LM:
    """Random parameters on ``device`` from ``seed`` (an int or a
    ``torch.Generator`` on that device), drawn in the reference's order."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    ini = Initializer(gen, dev)
    embed = ini.normal((cfg.vocab, cfg.d_model), fan_in=cfg.d_model)
    blocks = [Block(_init_block(ini, cfg)) for _ in range(cfg.n_layers)]
    final_norm = ini.ones((cfg.d_model,))
    head = None if cfg.tie_embeddings else \
        ini.normal((cfg.d_model, cfg.vocab), fan_in=cfg.d_model)
    return LM(embed, blocks, final_norm, head)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def _mlp(mp, h2, cd):
    g = silu(h2 @ mp["w_gate"].to(cd))
    u = h2 @ mp["w_up"].to(cd)
    return (g * u) @ mp["w_down"].to(cd)


def _block_forward(cfg: ArchConfig, bp: Block, x: torch.Tensor,
                   is_global: bool, *, block_causal: bool, chunk: int):
    fam = cfg.family
    h = rms_norm(x, bp.ln1, cfg.norm_eps)
    mix = 0.0
    if fam in ("dense", "vlm", "audio", "moe"):
        mix = attn_forward(
            bp.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=cfg.window, prefix_len=cfg.prefix_len, chunk=chunk,
            block_causal=block_causal)
    elif fam == "ssm":
        mix = ssm_forward(bp.ssm, h, d_inner=cfg.d_inner,
                          state=cfg.ssm_state, n_heads=cfg.ssm_heads,
                          head_dim=cfg.ssm_head_dim)
    elif fam == "hybrid":
        # hymba: parallel attention + SSM heads, averaged.  SWA everywhere
        # except the global layers, whose window covers the sequence.
        S = x.shape[1]
        attn_out = attn_forward(
            bp.attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            window=0, window_dynamic=S + 1 if is_global else cfg.window,
            chunk=chunk, block_causal=block_causal)
        s = ssm_forward(bp.ssm, h, d_inner=cfg.d_inner,
                        state=cfg.ssm_state, n_heads=cfg.ssm_heads,
                        head_dim=cfg.ssm_head_dim)
        mix = 0.5 * (attn_out + s)
    x = x + mix

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam == "moe":
        h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
        m, aux = moe_forward(bp.moe, h2, n_experts=cfg.n_experts,
                             top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
        x = x + m
    elif fam in ("dense", "vlm", "audio", "hybrid"):
        h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
        x = x + _mlp(bp.mlp, h2, x.dtype)
    return x, aux


def _embed(params: LM, cfg: ArchConfig, tokens, cd):
    tokens = torch.as_tensor(tokens, device=params.device).long()
    return params.embed[tokens].to(cd) * (cfg.d_model ** 0.5)


def forward(params: LM, cfg: ArchConfig, tokens,
            image_embed: Optional[torch.Tensor] = None,
            block_causal: bool = False, attn_chunk: int = 512
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (logits (B, S, V), aux_loss)."""
    cd = COMPUTE_DTYPE
    x = _embed(params, cfg, tokens, cd)
    if cfg.family == "vlm":
        if image_embed is None:
            raise ValueError("vlm needs stub patch embeddings")
        image_embed = torch.as_tensor(image_embed, device=x.device)
        x = torch.cat([image_embed.to(cd), x], dim=1)
    glob = set(cfg.global_layers)
    auxs = []
    with torch.no_grad():
        for l, bp in enumerate(params.layers):
            x, aux = _block_forward(cfg, bp, x, l in glob,
                                    block_causal=block_causal,
                                    chunk=attn_chunk)
            auxs.append(aux)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x @ params.head().to(cd)
    if cfg.family == "vlm":
        logits = logits[:, image_embed.shape[1]:]
    return logits, torch.stack(auxs).mean()


def loss_fn(params: LM, cfg: ArchConfig, tokens, labels,
            image_embed: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01, **kw) -> torch.Tensor:
    """Next-token cross-entropy + ``aux_weight`` x the MoE aux loss."""
    logits, aux = forward(params, cfg, tokens, image_embed=image_embed, **kw)
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - ll).mean() + aux_weight * aux


# --------------------------------------------------------------------------
# serve (decode) path
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=COMPUTE_DTYPE, device="cuda") -> Dict[str, torch.Tensor]:
    """Zero caches in the reference's layout.  Hymba keeps two stacked
    attention caches (SWA ring buffers + full-length global layers); the
    SSM state is float32 whatever ``dtype``."""
    dev = resolve_device(device)

    def mk(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)
    c: Dict[str, torch.Tensor] = {}
    fam = cfg.family
    L = cfg.n_layers
    kv = (cfg.n_kv_heads, cfg.head_dim)
    if fam in ("dense", "vlm", "audio", "moe"):
        c["k"] = mk((L, batch, seq_len) + kv, dtype)
        c["v"] = mk((L, batch, seq_len) + kv, dtype)
    if fam in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        c["conv"] = mk((L, batch, cfg.ssm_conv - 1, conv_ch), dtype)
        c["ssm"] = mk((L, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state), torch.float32)
    if fam == "hybrid":
        n_glob = len(cfg.global_layers)
        w = min(cfg.window, seq_len) if cfg.window else seq_len
        c["k_swa"] = mk((L, batch, w) + kv, dtype)
        c["v_swa"] = mk((L, batch, w) + kv, dtype)
        c["k_glob"] = mk((n_glob, batch, seq_len) + kv, dtype)
        c["v_glob"] = mk((n_glob, batch, seq_len) + kv, dtype)
    return c


def decode_step(params: LM, cfg: ArchConfig, token, cache: dict,
                pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, dict]:
    """token: (B, 1) int; pos: an int (lockstep) or a (B,) tensor (one
    position per lane).

    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    cd = COMPUTE_DTYPE
    fam = cfg.family
    attn_kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                   head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
    ssm_kw = dict(d_inner=cfg.d_inner, state=cfg.ssm_state,
                  n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim)
    glob_slot = {l: i for i, l in enumerate(cfg.global_layers)}
    with torch.no_grad():
        x = _embed(params, cfg, token, cd)
        for l, bp in enumerate(params.layers):
            h = rms_norm(x, bp.ln1, cfg.norm_eps)
            if fam in ("dense", "vlm", "audio", "moe"):
                a, _, _ = attn_decode(bp.attn, h, cache["k"][l],
                                      cache["v"][l], pos, window=cfg.window,
                                      **attn_kw)
                x = x + a
            elif fam == "ssm":
                y, conv_c, ssm_c = ssm_decode(bp.ssm, h, cache["conv"][l],
                                              cache["ssm"][l], **ssm_kw)
                cache["conv"][l] = conv_c
                cache["ssm"][l] = ssm_c
                x = x + y
                continue
            else:  # hybrid (hymba): global layers keep full-length caches
                if l in glob_slot:
                    g = glob_slot[l]
                    a, _, _ = attn_decode(bp.attn, h, cache["k_glob"][g],
                                          cache["v_glob"][g], pos, window=0,
                                          **attn_kw)
                else:
                    a, _, _ = attn_decode(bp.attn, h, cache["k_swa"][l],
                                          cache["v_swa"][l], pos,
                                          window=cfg.window, **attn_kw)
                y, conv_c, ssm_c = ssm_decode(bp.ssm, h, cache["conv"][l],
                                              cache["ssm"][l], **ssm_kw)
                cache["conv"][l] = conv_c
                cache["ssm"][l] = ssm_c
                x = x + 0.5 * (a + y)
            h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
            if fam == "moe":
                m, _ = moe_forward(bp.moe, h2, n_experts=cfg.n_experts,
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
                x = x + m
            else:
                x = x + _mlp(bp.mlp, h2, cd)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x @ params.head().to(cd)
    return logits, cache
