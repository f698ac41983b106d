"""Attention: GQA projections, chunked (flash-style) softmax, decode path.

Prefill never materializes the (S, S) score matrix: a loop over KV chunks
keeps the online-softmax running max and denominator, the JAX package's
formulation step for step (its ``lax.scan`` becomes a Python loop), so the
two agree to float32 rounding when both compute in float32.

Masks: causal, sliding-window, and prefix-LM (bidirectional prefix) are all
expressed as a predicate on (q_pos, k_pos) evaluated per chunk.

``block_causal=True`` skips KV chunks that are entirely in the masked
future of the current query chunk.

The reference pads heads to a multiple of the tensor-parallel width when
``tp > 1``; on one device that is a no-op, and it comes back with the
multi-GPU slice.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from .layers import Initializer, apply_rope, rotary_embedding

__all__ = ["init_attn", "attn_forward", "attn_decode", "mask_fn"]

NEG_INF = -1e30


def init_attn(ini: Initializer, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, use_bias: bool = False) -> dict:
    p = {
        "wq": ini.normal((d_model, n_heads, head_dim), fan_in=d_model),
        "wk": ini.normal((d_model, n_kv, head_dim), fan_in=d_model),
        "wv": ini.normal((d_model, n_kv, head_dim), fan_in=d_model),
        "wo": ini.normal((n_heads, head_dim, d_model),
                         fan_in=n_heads * head_dim),
    }
    if use_bias:
        p["bq"] = ini.zeros((n_heads, head_dim))
        p["bk"] = ini.zeros((n_kv, head_dim))
        p["bv"] = ini.zeros((n_kv, head_dim))
        p["bo"] = ini.zeros((d_model,))
    return p


def mask_fn(q_pos, k_pos, *, window: int = 0, prefix_len: int = 0,
            window_dynamic: Optional[int] = None):
    """Boolean attend-mask for (q_pos[:,None], k_pos[None,:]) grids.

    ``window_dynamic`` overrides ``window``; hybrid archs pass each layer's
    width (SWA or global) through it.
    """
    qp, kp = q_pos[:, None], k_pos[None, :]
    m = kp <= qp
    if window_dynamic is not None:
        m &= (qp - kp) < window_dynamic
    elif window:
        m &= (qp - kp) < window
    if prefix_len:
        m |= (qp < prefix_len) & (kp < prefix_len)
    return m


def _proj(x, w):
    """``einsum('bsd,dnh->bsnh')`` as one GEMM."""
    D, n, h = w.shape
    return (x @ w.reshape(D, n * h)).reshape(*x.shape[:-1], n, h)


def _proj_qkv(p, x, cd):
    q = _proj(x, p["wq"].to(cd))
    k = _proj(x, p["wk"].to(cd))
    v = _proj(x, p["wv"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return q, k, v


def _out_proj(p, o, cd):
    """``einsum('bsnh,nhd->bsd')`` (+ bias)."""
    n, h, D = p["wo"].shape
    y = o.reshape(*o.shape[:-2], n * h) @ p["wo"].to(cd).reshape(n * h, D)
    if "bo" in p:
        y = y + p["bo"].to(cd)
    return y


def attn_forward(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                 head_dim: int, rope_theta: float, window: int = 0,
                 prefix_len: int = 0, chunk: int = 512,
                 block_causal: bool = False,
                 window_dynamic: Optional[int] = None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill). x: (B, S, D)."""
    B, S_in, D = x.shape
    cd = x.dtype
    dev = x.device
    q, k, v = _proj_qkv(p, x, cd)
    # pad the sequence to a chunk multiple; padded keys are masked out below
    S = (S_in + chunk - 1) // chunk * chunk
    if S != S_in:
        pad = (0, 0, 0, 0, 0, S - S_in)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    pos = torch.arange(S, device=dev) if positions is None else positions
    cos, sin = rotary_embedding(pos, head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    group = n_heads // n_kv
    if group > 1:
        k = k.repeat_interleave(group, dim=2)        # (B, S, H, hd)
        v = v.repeat_interleave(group, dim=2)
    q = q.transpose(1, 2)                            # (B, H, S, hd)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    scale = head_dim ** -0.5

    n_chunks = S // chunk
    valid_k = pos < S_in                             # padded keys invalid
    outs = []
    for qi in range(n_chunks):
        q_blk = q[:, :, qi * chunk:(qi + 1) * chunk]
        q_pos = pos[qi * chunk:(qi + 1) * chunk]
        m_run = torch.full((B, n_heads, chunk), NEG_INF, device=dev)
        l_run = torch.zeros((B, n_heads, chunk), device=dev)
        o_run = torch.zeros((B, n_heads, chunk, head_dim), device=dev)
        n_kv_chunks = qi + 1 if (block_causal and prefix_len == 0) \
            else n_chunks
        for ci in range(n_kv_chunks):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            k_pos = pos[sl]
            s = (q_blk @ k[:, :, sl].transpose(-1, -2)) * scale
            mask = mask_fn(q_pos, k_pos, window=window,
                           prefix_len=prefix_len,
                           window_dynamic=window_dynamic)
            mask &= valid_k[sl][None, :]
            s = s.float().masked_fill(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            prob = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + prob.sum(-1)
            o_run = o_run * alpha[..., None] + (
                prob.to(cd) @ v[:, :, sl]).float()
            m_run = m_new
        outs.append((o_run / torch.clamp(l_run[..., None], min=1e-30)
                     ).to(cd))
    out = torch.cat(outs, dim=2)                     # (B, H, S, hd)
    out = out.transpose(1, 2)[:, :S_in]              # (B, S_in, H, hd)
    return _out_proj(p, out, cd)


@functools.lru_cache(maxsize=16)
def _lockstep_tables(pos: int, S_max: int, window: int, head_dim: int,
                     theta: float, device: torch.device):
    """Rope tables and the masked cache slots of a lockstep decode step at
    ``pos``; every layer of a step asks for the same ones."""
    cos, sin = rotary_embedding(
        torch.full((1,), pos, device=device, dtype=torch.int64), head_dim,
        theta)
    kpos = torch.arange(S_max, device=device)
    valid = kpos < min(pos + 1, S_max) if window else kpos <= pos
    return cos, sin, ~valid.reshape(1, 1, S_max)


def attn_decode(p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: Union[int, torch.Tensor], *,
                n_heads: int, n_kv: int, head_dim: int, rope_theta: float,
                window: int = 0):
    """One-token decode. x: (B, 1, D); caches: (B, S_max, KV, hd).

    ``pos`` is either an ``int`` (all lanes in lockstep) or a (B,) tensor
    (continuous batching: each slot at its own position).  For
    sliding-window layers the cache is a ring buffer indexed by
    ``pos % S_max``.  Full-attention layers write at ``min(pos, S_max -
    1)``, the clamp the reference's cache update applies in both forms.
    The caches are written in place and returned.
    """
    B, _, D = x.shape
    cd = x.dtype
    dev = x.device
    S_max = k_cache.shape[1]
    q, k, v = _proj_qkv(p, x, cd)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(dev)
        cos, sin = rotary_embedding(pos[:, None], head_dim, rope_theta)
        kpos = torch.arange(S_max, device=dev)
        if window:
            slot = pos % S_max
            valid = kpos < torch.clamp(pos + 1, max=S_max)[:, None]
        else:
            slot = torch.clamp(pos, max=S_max - 1)
            valid = kpos <= pos[:, None]
        masked = ~valid[:, None, :]
        slot = (torch.arange(B, device=dev), slot)
    else:
        cos, sin, masked = _lockstep_tables(pos, S_max, window, head_dim,
                                            rope_theta, dev)
        slot = (slice(None), pos % S_max if window
                else min(max(pos, 0), S_max - 1))
    # q and k rotate together (one elementwise pass, the same values)
    qk = apply_rope(torch.cat([q, k], dim=2), cos, sin)
    q, k = qk[:, :, :n_heads], qk[:, :, n_heads:]
    k_cache[slot] = k[:, 0].to(k_cache.dtype)
    v_cache[slot] = v[:, 0].to(v_cache.dtype)
    group = n_heads // n_kv
    qh = q.reshape(B, n_heads, 1, head_dim)
    scale = head_dim ** -0.5
    kk = k_cache.to(cd)
    vv = v_cache.to(cd)
    if group > 1:
        kk = kk.repeat_interleave(group, dim=2)      # (B, S, H, hd)
        vv = vv.repeat_interleave(group, dim=2)
    kk = kk.permute(0, 2, 3, 1)                      # (B, H, hd, S)
    vv = vv.transpose(1, 2)                          # (B, H, S, hd)
    s = ((qh @ kk) * scale)[:, :, 0]                 # (B, H, S)
    s = s.float().masked_fill(masked, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(cd)
    o = (prob[:, :, None] @ vv)[:, :, 0]             # (B, H, hd)
    y = _out_proj(p, o.reshape(B, 1, n_heads, head_dim), cd)
    return y, k_cache, v_cache
