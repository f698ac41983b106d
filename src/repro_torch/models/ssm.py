"""Mamba2 (SSD — state-space duality) blocks: chunked scan + O(1) decode.

The SSD form computes, per head, y_i = Σ_{j<=i} C_i^T (Π_{j<l<=i} a_l) B_j
(dt_j x_j).  The chunked algorithm (chunk Q) does the intra-chunk part as a
masked quadratic product and carries the inter-chunk state
h ∈ R^{heads×head_dim×state} across chunks, as the JAX package does.  Each
three-operand contraction there runs here as two steps (an elementwise
product, then a batched GEMM), so no six-dimensional intermediate exists.

Following mamba2, the short causal conv runs over the concatenated (x, B, C)
channels, and the output is RMS-norm-gated by z before out-projection.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Initializer, rms_norm, silu

__all__ = ["init_ssm", "ssm_forward", "ssm_decode", "init_ssm_cache"]


def init_ssm(ini: Initializer, d_model: int, d_inner: int, n_heads: int,
             state: int, conv: int = 4) -> dict:
    conv_ch = d_inner + 2 * state
    return {
        "in_proj": ini.normal((d_model, 2 * d_inner + 2 * state + n_heads),
                              fan_in=d_model),
        "conv_w": ini.normal((conv, conv_ch), fan_in=conv),
        "conv_b": ini.zeros((conv_ch,)),
        "A_log": ini.zeros((n_heads,)),
        "D": ini.ones((n_heads,)),
        "dt_bias": ini.zeros((n_heads,)),
        "out_norm": ini.ones((d_inner,)),
        "out_proj": ini.normal((d_inner, d_model), fan_in=d_inner),
    }


def _split_proj(p, u, d_inner, state, n_heads, cd):
    zxbcdt = u @ p["in_proj"].to(cd)
    z, xbc, dt = torch.split(
        zxbcdt, [d_inner, d_inner + 2 * state, n_heads], dim=-1)
    return z, xbc, dt


def _causal_conv(p, xbc, cd, conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K. xbc: (B, S, Cch)."""
    K = p["conv_w"].shape[0]
    w = p["conv_w"].to(cd)
    if conv_state is None:
        pad = torch.zeros_like(xbc[:, :K - 1])
        xp = torch.cat([pad, xbc], dim=1)
    else:
        xp = torch.cat([conv_state.to(cd), xbc], dim=1)
    S = xbc.shape[1]
    # the reference's order: ((0 + t_0) + t_1) + ..., each sum rounded to cd
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return silu(out + p["conv_b"].to(cd)), new_state


def ssm_forward(p: dict, u: torch.Tensor, *, d_inner: int, state: int,
                n_heads: int, head_dim: int, chunk: int = 256
                ) -> torch.Tensor:
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D).  S must be a multiple
    of ``min(chunk, S)``, the reference's own limit."""
    B, S, D = u.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {chunk}")
    cd = u.dtype
    f32 = torch.float32
    z, xbc, dt = _split_proj(p, u, d_inner, state, n_heads, cd)
    xbc, _ = _causal_conv(p, xbc, cd)
    x, Bm, Cm = torch.split(xbc, [d_inner, state, state], dim=-1)
    x = x.reshape(B, S, n_heads, head_dim)

    dt = F.softplus(dt.float() + p["dt_bias"].float())           # (B,S,H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    da = dt * A[None, None, :]                                   # (B,S,H) <= 0

    nc = S // chunk
    Q, H, P, N = chunk, n_heads, head_dim, state
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N).to(cd)
    Cc = Cm.reshape(B, nc, Q, N).to(cd)
    dac = da.reshape(B, nc, Q, H)
    dtc = dt.reshape(B, nc, Q, H)

    cum = torch.cumsum(dac, dim=2)                               # (B,nc,Q,H)
    # intra-chunk decay L[i,j] = exp(cum_i - cum_j), i >= j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    # mask in log-space BEFORE exp, as the reference does
    Lmat = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                     float("-inf")))
    del seg

    xdt = xc * dtc[..., None].to(cd)                             # (B,nc,Q,H,P)
    xdt32 = xdt.float()
    CB = (Cc @ Bc.transpose(-1, -2)).float()                     # (B,nc,Q,Q)
    # y_intra[b,n,q,h,p] = Σ_k CB[b,n,q,k] L[b,n,q,k,h] xdt[b,n,k,h,p]
    W = (Lmat * CB[..., None]).permute(0, 1, 4, 2, 3)            # (B,nc,H,Q,Q)
    del Lmat
    y_intra = (W @ xdt32.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del W

    # inter-chunk state recurrence
    chunk_sum = cum[:, :, -1, :]                                 # (B,nc,H)
    # state contribution of each chunk: Σ_j exp(chunk_sum - cum_j) B_j ⊗ xdt_j
    decay_to_end = torch.exp(chunk_sum[:, :, None, :] - cum)     # (B,nc,Q,H)
    xw = (xdt32 * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)
    S_chunk = (xw.reshape(B, nc, H * P, Q) @ Bc.float()
               ).reshape(B, nc, H, P, N)                         # (B,nc,H,P,N)

    h = torch.zeros((B, H, P, N), dtype=f32, device=u.device)
    h_prev = []
    for n in range(nc):                                          # emit PREVIOUS
        h_prev.append(h)
        h = h * torch.exp(chunk_sum[:, n])[:, :, None, None] + S_chunk[:, n]
    h_prev = torch.stack(h_prev, dim=1)                          # (B,nc,H,P,N)

    decay_from_start = torch.exp(cum)                            # (B,nc,Q,H)
    # y_inter[b,n,q,h,p] = dfs[b,n,q,h] Σ_s C[b,n,q,s] h_prev[b,n,h,p,s]
    hp = h_prev.reshape(B, nc, H * P, N).transpose(-1, -2)       # (B,nc,N,HP)
    y_inter = (Cc.float() @ hp).reshape(B, nc, Q, H, P) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + x.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, d_inner).to(cd)
    y = rms_norm(y, p["out_norm"]) * silu(z)
    return y @ p["out_proj"].to(cd)


def init_ssm_cache(B: int, d_inner: int, state: int, n_heads: int,
                   head_dim: int, conv: int = 4, dtype=torch.float32,
                   device="cuda"):
    """(conv_state, ssm_state) zero caches for decode."""
    conv_ch = d_inner + 2 * state
    return (torch.zeros((B, conv - 1, conv_ch), dtype=dtype, device=device),
            torch.zeros((B, n_heads, head_dim, state), dtype=dtype,
                        device=device))


def ssm_decode(p: dict, u: torch.Tensor, conv_state: torch.Tensor,
               ssm_state: torch.Tensor, *, d_inner: int, state: int,
               n_heads: int, head_dim: int):
    """One-token step. u: (B, 1, D). Returns (y, conv_state, ssm_state)."""
    B, _, D = u.shape
    cd = u.dtype
    z, xbc, dt = _split_proj(p, u, d_inner, state, n_heads, cd)
    xbc, new_conv = _causal_conv(p, xbc, cd, conv_state=conv_state)
    x, Bm, Cm = torch.split(xbc[:, 0], [d_inner, state, state], dim=-1)
    x = x.reshape(B, n_heads, head_dim)

    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())    # (B,H)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dtv * A[None, :])                             # (B,H)

    x32 = x.float()
    xdt = x32 * dtv[..., None]
    upd = xdt[..., None] * Bm.float()[:, None, None, :]          # (B,H,P,N)
    h = ssm_state * da[:, :, None, None] + upd
    y = (h @ Cm.float()[:, None, :, None])[..., 0]               # (B,H,P)
    y = y + x32 * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, d_inner).to(cd)
    y = rms_norm(y, p["out_norm"]) * silu(z)
    out = y @ p["out_proj"].to(cd)
    return out, new_conv.to(conv_state.dtype), h
