"""Mixture-of-Experts FFN with sort-based capacity dispatch (GShard-style).

As in the JAX package:

  1. router: top-k experts + softmax-renormalized gates per token,
  2. sort (token, k) pairs by expert id (a stable sort, as ``jnp.argsort``
     is); rank-within-expert via a searchsorted over the sorted ids,
  3. scatter token activations into an (E, C, D) buffer (rank >= C drops —
     capacity truncation; C = tokens·top_k·cf / E + 1),
  4. batched expert FFN,
  5. gather back + gate-weighted combine.

Dispatch groups are sequences (G = B), each with its own sort and capacity.

Router logits are the float32 product of the compute-dtype operands, as
XLA computes the reference's ``einsum(...).astype(float32)`` under ``jit``
(a rounding there would move routing decisions near a tie).

Ties: ``jax.lax.top_k`` picks the lower expert index among equal router
probabilities; ``torch.topk`` promises no order among ties (on the card
none is guaranteed), so an exact tie may route a token differently.

The combine sums each token's ``top_k`` contributions in the reference's
order (ascending expert id, one at a time, in the compute dtype, starting
from zero) instead of an ``index_add_``, whose atomics on the card would
change the low bits from run to run.

The reference pads experts to a multiple of the tensor-parallel width when
``tp > 1``; on one device that is a no-op, and it comes back with the
multi-GPU slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .layers import Initializer, silu

__all__ = ["init_moe", "moe_forward"]


def init_moe(ini: Initializer, d_model: int, n_experts: int,
             d_ff: int) -> dict:
    return {
        "router": ini.normal((d_model, n_experts), fan_in=d_model),
        "w_gate": ini.normal((n_experts, d_model, d_ff), fan_in=d_model),
        "w_up": ini.normal((n_experts, d_model, d_ff), fan_in=d_model),
        "w_down": ini.normal((n_experts, d_ff, d_model), fan_in=d_ff),
    }


def moe_forward(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  aux = load-balancing loss (Switch)."""
    B, S, D = x.shape
    cd = x.dtype
    dev = x.device
    N = B * S
    E, k = n_experts, top_k
    xf = x.reshape(N, D)

    # the reference's jitted ``einsum(...).astype(float32)`` fuses the cast
    # into the product: the router logits are never rounded to ``cd``
    logits = xf.float() @ p["router"].to(cd).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)          # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balance auxiliary loss (Switch-style)
    density = torch.nn.functional.one_hot(expert_ids[:, 0], E).float() \
        .mean(0)
    router_mean = probs.mean(0)
    aux = E * torch.sum(density * router_mean)

    # ---- group-local sort-based dispatch ----
    G = B if N % B == 0 else 1
    Ng = N // G
    C = int(Ng * k * capacity_factor / E) + 1
    flat_e = expert_ids.reshape(G, Ng * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(sorted_e, experts, side="left")
    rank = torch.arange(Ng * k, device=dev) - torch.gather(start, 1,
                                                           sorted_e)
    tok = order // k
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    xg = xf.reshape(G, Ng, D)
    # a dropped pair writes the spare last row, which is cut off
    buf = torch.zeros((G, E * C + 1, D), dtype=cd, device=dev)
    buf.scatter_(1, slot[..., None].expand(G, Ng * k, D),
                 torch.gather(xg, 1, tok[..., None].expand(G, Ng * k, D)))
    buf = buf[:, :-1].reshape(G, E, C, D)

    # ---- expert FFN, batched over experts ----
    be = buf.transpose(0, 1).reshape(E, G * C, D)
    h = silu(be @ p["w_gate"].to(cd)) * (be @ p["w_up"].to(cd))
    out_buf = (h @ p["w_down"].to(cd)).reshape(E, G, C, D).transpose(0, 1)

    # ---- gather + combine (group-local) ----
    flat = out_buf.reshape(G, E * C, D)
    gathered = torch.gather(
        flat, 1, torch.clamp(slot, max=E * C - 1)[..., None]
        .expand(G, Ng * k, D))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=cd, device=dev))
    gates_s = torch.gather(gate_vals.reshape(G, Ng * k), 1, order)
    contrib = gathered * gates_s[..., None].to(cd)              # sorted order
    # each token's k pairs at their sorted places, ascending (= by expert)
    inv = torch.argsort(order, dim=-1)
    places = inv.reshape(G, Ng, k).sort(dim=-1).values.reshape(G, Ng * k)
    per_tok = torch.gather(contrib, 1, places[..., None].expand(
        G, Ng * k, D)).reshape(G, Ng, k, D)
    out = torch.zeros((G, Ng, D), dtype=cd, device=dev)
    for j in range(k):
        out = out + per_tok[:, :, j]
    return out.reshape(B, S, D), aux
