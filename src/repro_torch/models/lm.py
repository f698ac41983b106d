"""Unified decoder LM over all assigned architecture families.

One parameter layout + the reference's entry points:

  - ``forward(params, cfg, tokens, ...)``       — logits for train/prefill
  - ``loss_fn(params, cfg, tokens, labels)``    — the training loss
  - ``decode_step(params, cfg, token, cache, pos)`` — one-token serve step
  - ``init_params(cfg, seed)`` / ``init_cache(cfg, batch, seq_len)``

``params`` is an :class:`LM` module with one :class:`Block` per layer in an
``nn.ModuleList``; each block holds the JAX package's leaves under the same
names (``blk.attn["wq"]``, ``blk.ssm["in_proj"]``, ``blk.mlp["w_gate"]``,
...), and :mod:`.convert` carries the reference's stacked pytree across in
both directions.  Every leaf is a float32 ``nn.Parameter`` that requires
grad, so ``forward`` builds an autograd graph unless the caller runs it
under ``torch.inference_mode()`` (the one-device inference callers do)
or ``torch.no_grad()`` (the prefill step, which may hold DTensors).  Layers run in a Python loop; with grad enabled and
``remat`` each block runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint(layer)``), so only the residual stream between blocks is
kept for the backward pass.  ``decode_step`` always runs without grad.
Caches keep the reference's stacked layout (a leading layer axis) and are
updated in place; ``decode_step`` returns them all the same.

VLM (paligemma): ``image_embed`` (B, P, D) precomputed patch embeddings (stub
frontend) are prepended to the token embeddings and the mask is prefix-LM.
Audio (musicgen): token ids over the EnCodec codebook — the frontend is
likewise a stub.

Sharded: under ``distributed.logical.axis_env(mesh)`` with the leaves and
the batch as DTensors (``distributed.sharding``), the same code runs
under DTensor dispatch.  The residual stream is hinted batch- and
sequence-parallel between blocks (gathered for each block's projections,
each sub-block's output reduce-scattered back before the add), the MLP's
hidden and the logits tensor-parallel, weights gathered over the batch
axes before use (``fsdp_gather``), and when the vocabulary does not
divide the model axis (``tp``) the head is padded to a multiple of it,
the padded logits masked to ``NEG_INF`` (``keep_padded_vocab`` keeps them
for the loss, whose ``logsumexp`` they do not change).  The sharded loss
reduces each rank's vocabulary slice in place (``_sharded_nll``); decode
settles the residual before each norm.  With no mesh or ``tp == 1`` the
hints and paddings are no-ops.

``abstract_params`` / ``abstract_cache`` give the same structures on the
``meta`` device: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..distributed.logical import (captured_env, current_mesh,
                                   fsdp_gather, get_opt, is_dtensor,
                                   local_map, pad_zeros, replicate_like,
                                   replicated, shard_hint, spec_of,
                                   tp_size_of)
from .attention import NEG_INF, attn_decode, attn_forward, init_attn
from .layers import COMPUTE_DTYPE, Initializer, rms_norm, silu
from .moe import init_moe, moe_forward
from .ssm import init_ssm, ssm_decode, ssm_forward

__all__ = ["LM", "Block", "init_params", "abstract_params", "map_params",
           "forward", "decode_step", "init_cache", "abstract_cache",
           "loss_fn"]


def _pdict(leaves: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in leaves.items()})


class Block(nn.Module):
    """One decoder layer: ``ln1``/``ln2`` and the family's sub-blocks
    (``attn``, ``ssm``, ``mlp``, ``moe``), each a ``ParameterDict``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, v in leaves.items():
            if isinstance(v, dict):
                setattr(self, name, _pdict(v))
            else:
                setattr(self, name, nn.Parameter(v))


class LM(nn.Module):
    """The parameters of one decoder LM (``embed``, ``layers``,
    ``final_norm``, ``lm_head`` unless tied)."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)

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
    return _build_params(cfg, Initializer(gen, dev))


def abstract_params(cfg: ArchConfig) -> LM:
    """The parameters' shapes and dtypes as an :class:`LM` of ``meta``
    tensors (qwen3_moe_235b's 235B included): nothing is allocated."""
    return _build_params(cfg, Initializer(None))


def _build_params(cfg: ArchConfig, ini: Initializer) -> LM:
    embed = ini.normal((cfg.vocab, cfg.d_model), fan_in=cfg.d_model)
    blocks = [Block(_init_block(ini, cfg)) for _ in range(cfg.n_layers)]
    final_norm = ini.ones((cfg.d_model,))
    head = None if cfg.tie_embeddings else \
        ini.normal((cfg.d_model, cfg.vocab), fan_in=cfg.d_model)
    return LM(embed, blocks, final_norm, head)


def map_params(params: LM, fn: Callable[[str, torch.Tensor], torch.Tensor]
               ) -> LM:
    """A new :class:`LM` of ``params``' layout whose leaf under each
    parameter name (``layers.3.attn.wq``) is ``fn(name, leaf)``: the
    optimizer's moments, a restored checkpoint."""
    def block(l, bp):
        leaves = {n: fn(f"layers.{l}.{n}", v)
                  for n, v in bp.named_parameters(recurse=False)}
        for n, sub in bp.named_children():
            leaves[n] = {k: fn(f"layers.{l}.{n}.{k}", v)
                         for k, v in sub.items()}
        return Block(leaves)
    head = None if params.lm_head is None else fn("lm_head", params.lm_head)
    return LM(fn("embed", params.embed),
              [block(l, bp) for l, bp in enumerate(params.layers)],
              fn("final_norm", params.final_norm), head)


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------
def _mlp(mp, h2, cd):
    g = silu(h2 @ fsdp_gather(mp["w_gate"].to(cd)))
    u = h2 @ fsdp_gather(mp["w_up"].to(cd))
    g = shard_hint(g, "batch", None, "tp")
    return (g * u) @ fsdp_gather(mp["w_down"].to(cd))


def _block_forward(cfg: ArchConfig, bp: Block, x: torch.Tensor,
                   is_global: bool, *, block_causal: bool, chunk: int):
    fam = cfg.family
    # the sequence-parallel residual gathered over the model axis for the
    # block's projections (Megatron-SP's all-gather; torch 2.11's DTensor
    # cannot flatten a sequence-sharded (B, S, D) into the GEMM's rows)
    h = shard_hint(rms_norm(x, bp.ln1, cfg.norm_eps), "batch", None, None)
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
    # each sub-block's output reduced (and scattered) to the residual's
    # sequence-parallel layout before the add: a placement autograd keeps,
    # so the gradient reaching the projections' backward is whole over the
    # sequence again (torch 2.11 cannot flatten a sequence-sharded one)
    x = x + shard_hint(mix, "batch", "sp", None)

    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    if fam in ("dense", "vlm", "audio", "moe", "hybrid"):
        h2 = shard_hint(rms_norm(x, bp.ln2, cfg.norm_eps),
                        "batch", None, None)
        if fam == "moe":
            m, aux = moe_forward(bp.moe, h2, n_experts=cfg.n_experts,
                                 top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor)
        else:
            m = _mlp(bp.mlp, h2, x.dtype)
        x = x + shard_hint(m, "batch", "sp", None)
    # sequence-parallel residual: the carries (what remat keeps) live
    # S-sharded over the model axis between blocks
    return shard_hint(x, "batch", "sp", None), aux


def _embed(params: LM, cfg: ArchConfig, tokens, cd):
    tokens = torch.as_tensor(tokens, device=params.device).long()
    if is_dtensor(tokens):
        # the whole table on every rank (gathered, as FSDP gathers a leaf
        # before use), so each rank looks up its own tokens locally; an
        # embedding op, whose backward torch 2.11's DTensor can place for
        # batch-sharded tokens (an index's it cannot)
        emb = shard_hint(torch.nn.functional.embedding(
            tokens, replicated(params.embed)), "batch", None, None)
    else:
        emb = params.embed[tokens]
    return emb.to(cd) * (cfg.d_model ** 0.5)


def _logits(params: LM, x, cd, keep_padded_vocab: bool):
    """``x @ head`` with the vocab padded to a multiple of ``tp`` when it
    does not divide (``head_pad``): padded entries are ``NEG_INF``, so
    ``logsumexp`` and ``argmax`` are exact; the caller gets the sliced
    view unless ``keep_padded_vocab``."""
    head = params.head()
    V = head.shape[1]
    tp = tp_size_of()
    if get_opt("head_pad") and tp > 1 and V % tp != 0:
        V_pad = (V + tp - 1) // tp * tp
        # the padded vocab sharded over the model axis before the GEMM, so
        # each rank computes its own slice of the logits
        head = shard_hint(pad_zeros(head, 1, V_pad), "batch", "tp")
        logits = shard_hint(x @ fsdp_gather(head.to(cd)), "batch", None,
                            "tp")
        pad = torch.arange(V_pad, device=x.device) >= V
        logits = logits.masked_fill(replicate_like(pad, logits), NEG_INF)
        return logits if keep_padded_vocab else logits[..., :V]
    return shard_hint(x @ fsdp_gather(head.to(cd)), "batch", None, "tp")


def forward(params: LM, cfg: ArchConfig, tokens,
            image_embed: Optional[torch.Tensor] = None,
            block_causal: bool = False, attn_chunk: int = 512,
            remat: bool = True, keep_padded_vocab: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int -> (logits (B, S, V), aux_loss).

    Differentiable in ``params`` when grad mode is on; ``remat`` then
    recomputes each block in the backward pass instead of keeping its
    activations (no effect without grad)."""
    cd = COMPUTE_DTYPE
    x = shard_hint(_embed(params, cfg, tokens, cd), "batch", "sp", None)
    if cfg.family == "vlm":
        if image_embed is None:
            raise ValueError("vlm needs stub patch embeddings")
        image_embed = replicate_like(
            torch.as_tensor(image_embed, device=x.device), x)
        x = torch.cat([image_embed.to(cd), x], dim=1)
    glob = set(cfg.global_layers)
    recompute = remat and torch.is_grad_enabled()
    ck = {}
    if recompute and current_mesh() is not None:
        # the recompute re-enters the forward's mesh and options
        env = captured_env()
        ck["context_fn"] = lambda: (contextlib.nullcontext(), env())
    auxs = []
    for l, bp in enumerate(params.layers):
        kw = dict(block_causal=block_causal, chunk=attn_chunk)
        if recompute:
            x, aux = checkpoint(_block_forward, cfg, bp, x, l in glob,
                                use_reentrant=False, **ck, **kw)
        else:
            x, aux = _block_forward(cfg, bp, x, l in glob, **kw)
        auxs.append(aux)
    x = shard_hint(rms_norm(x, params.final_norm, cfg.norm_eps),
                   "batch", None, None)
    logits = _logits(params, x, cd, keep_padded_vocab)
    if cfg.family == "vlm":
        logits = logits[:, image_embed.shape[1]:]
    return logits, torch.stack(auxs).mean()


def loss_fn(params: LM, cfg: ArchConfig, tokens, labels,
            image_embed: Optional[torch.Tensor] = None,
            aux_weight: float = 0.01, **kw) -> torch.Tensor:
    """Next-token cross-entropy + ``aux_weight`` x the MoE aux loss, the
    reference's training loss; ``kw`` goes to :func:`forward`."""
    logits, aux = forward(params, cfg, tokens, image_embed=image_embed,
                          keep_padded_vocab=True, **kw)
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    if is_dtensor(logits) and spec_of(logits)[-1] is not None:
        return _sharded_nll(logits, labels) + aux_weight * aux
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    ll = torch.gather(logits, -1, labels[..., None])
    return (logz - ll).mean() + aux_weight * aux


def _sharded_nll(logits, labels) -> torch.Tensor:
    """The mean negative log-likelihood of DTensor ``logits`` (B, S, V)
    whose vocab ``_logits`` shards over the model axis, without gathering
    the vocab (DTensor would gather the global batch's logits onto every
    rank for ``logsumexp`` and ``gather``): each rank reduces its own slice
    to a maximum, a sum of exponentials and the logit of the labels it
    holds (``local_map``), and those (B, S, shards) combine into the
    log-partition as flash attention combines its blocks.  A vocab whole
    on every rank (one rank, or no model axis) takes the one-device ops
    instead, so a one-rank mesh keeps the one-device bits."""
    spec = spec_of(logits)
    V_loc = logits.to_local().shape[-1]
    v0 = logits.device_mesh.get_local_rank("model") * V_loc

    def reduce_slice(lg, lb):           # each (B, S, 1)
        top = lg.detach().amax(-1, keepdim=True)
        sumexp = torch.exp(lg - top).sum(-1, keepdim=True)
        idx = lb - v0
        mine = ((idx >= 0) & (idx < lg.shape[-1]))[..., None]
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
        return top, sumexp, torch.where(mine, got, torch.zeros_like(got))
    top, sumexp, ll = local_map(reduce_slice, (logits, labels),
                                (spec, spec[:2]), (spec, spec, spec))
    big = top.amax(-1, keepdim=True)
    logz = big + torch.log((sumexp * torch.exp(top - big))
                           .sum(-1, keepdim=True))
    return (logz - ll.sum(-1, keepdim=True)).mean()


# --------------------------------------------------------------------------
# serve (decode) path
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=COMPUTE_DTYPE, device="cuda") -> Dict[str, torch.Tensor]:
    """Zero caches in the reference's layout.  Hymba keeps two stacked
    attention caches (SWA ring buffers + full-length global layers); the
    SSM state is float32 whatever ``dtype``."""
    return _cache_struct(cfg, batch, seq_len, dtype, resolve_device(device))


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int,
                   dtype=COMPUTE_DTYPE) -> Dict[str, torch.Tensor]:
    """:func:`init_cache`'s structure as ``meta`` tensors."""
    return _cache_struct(cfg, batch, seq_len, dtype, torch.device("meta"))


def _cache_struct(cfg: ArchConfig, batch: int, seq_len: int, dtype,
                  dev: torch.device) -> Dict[str, torch.Tensor]:
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
            # under a mesh the residual is settled (the row-parallel
            # outputs' partial sums reduced) before each norm, or DTensor
            # would carry the partial sums into the next projections
            x = shard_hint(x, "batch", None, None)
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
            x = shard_hint(x, "batch", None, None)
            h2 = rms_norm(x, bp.ln2, cfg.norm_eps)
            if fam == "moe":
                m, _ = moe_forward(bp.moe, h2, n_experts=cfg.n_experts,
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
                x = x + m
            else:
                x = x + _mlp(bp.mlp, h2, cd)
        x = rms_norm(shard_hint(x, "batch", None, None), params.final_norm,
                     cfg.norm_eps)
        logits = x @ fsdp_gather(params.head().to(cd))
    return logits, cache
