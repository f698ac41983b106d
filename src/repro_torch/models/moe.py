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

Sharded (under ``distributed.logical.axis_env`` with DTensor leaves):
when the expert count does not divide the model axis (``tp``), phantom
experts with zero weights and zero router probability pad it to a
multiple (``perf_env(expert_pad=...)``, on by default), as in the
reference — not exact against the unpadded model, since each real
expert's capacity C shrinks by E/E_pad.  The routing, the sort-based
dispatch and the combine have no DTensor sharding rule (top-k, sort,
searchsorted, scatter, gather); they run group-local on each rank's
groups (``logical.group_local``: dim 0 over the batch axes, replicated
over the model axis), so no collective crosses the data axis there, and
the expert buffer between them is hinted (G→data, E→model) for the
expert-parallel FFN.  With no mesh every step runs as one plain call.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distributed.logical import (fsdp_gather, get_opt, group_local,
                                   pad_zeros, reshape_hinted, shard_hint,
                                   tp_size_of)
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


def _route(probs, k: int):
    """Top-k experts, renormalized gates, and the one-hot of each row's
    first choice (for the load-balance loss)."""
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)          # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    first = torch.nn.functional.one_hot(expert_ids[:, 0],
                                        probs.shape[-1]).float()
    return gate_vals, expert_ids, first


def _dispatch(xg, eg, gg, E: int, C: int, k: int):
    """Group-local sort-based dispatch. xg: (G, Ng, D); eg/gg: (G, Ng*k).
    Returns the (G, E, C, D) buffer and, per sorted (token, k) pair, its
    slot, whether it was kept, its gate and each token's pair places."""
    G, Ng, D = xg.shape
    dev = xg.device
    order = torch.argsort(eg, dim=-1, stable=True)
    sorted_e = torch.gather(eg, 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(sorted_e, experts, side="left")
    rank = torch.arange(Ng * k, device=dev) - torch.gather(start, 1,
                                                           sorted_e)
    tok = order // k
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    # a dropped pair writes the spare last row, which is cut off
    buf = torch.zeros((G, E * C + 1, D), dtype=xg.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(G, Ng * k, D),
                 torch.gather(xg, 1, tok[..., None].expand(G, Ng * k, D)))
    buf = buf[:, :-1].reshape(G, E, C, D)
    gates_s = torch.gather(gg, 1, order)
    # each token's k pairs at their sorted places, ascending (= by expert)
    inv = torch.argsort(order, dim=-1)
    places = inv.reshape(G, Ng, k).sort(dim=-1).values.reshape(G, Ng * k)
    return buf, slot, keep, gates_s, places


def _combine(out_buf, slot, keep, gates_s, places, k: int):
    """Gather each pair's expert output back and sum a token's ``k``
    gate-weighted contributions in ascending expert order."""
    G, E, C, D = out_buf.shape
    cd = out_buf.dtype
    Ng = slot.shape[1] // k
    flat = out_buf.reshape(G, E * C, D)
    gathered = torch.gather(
        flat, 1, torch.clamp(slot, max=E * C - 1)[..., None]
        .expand(G, Ng * k, D))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=cd, device=flat.device))
    contrib = gathered * gates_s[..., None].to(cd)              # sorted order
    per_tok = torch.gather(contrib, 1, places[..., None].expand(
        G, Ng * k, D)).reshape(G, Ng, k, D)
    out = torch.zeros((G, Ng, D), dtype=cd, device=flat.device)
    for j in range(k):
        out = out + per_tok[:, :, j]
    return out


def moe_forward(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  aux = load-balancing loss (Switch)."""
    B, S, D = x.shape
    cd = x.dtype
    N = B * S
    E, k = n_experts, top_k
    xf = reshape_hinted(x, (N, D), "batch", None, None)

    # the reference's jitted ``einsum(...).astype(float32)`` fuses the cast
    # into the product: the router logits are never rounded to ``cd``
    logits = xf.float() @ fsdp_gather(p["router"].to(cd)).float()
    probs = torch.softmax(logits, dim=-1)

    # expert padding: phantom experts (zero weights, zero probability —
    # never selected) so the expert buffer still shards E over "model"
    w_gate, w_up, w_down = p["w_gate"], p["w_up"], p["w_down"]
    tp = tp_size_of()
    if get_opt("expert_pad") and tp > 1 and E % tp != 0:
        e_pad = (E + tp - 1) // tp * tp
        probs = pad_zeros(probs, 1, e_pad)
        w_gate, w_up, w_down = (pad_zeros(w, 0, e_pad)
                                for w in (w_gate, w_up, w_down))
        E = e_pad
    gate_vals, expert_ids, first = group_local(
        lambda pr: _route(pr, k), probs)

    # load-balance auxiliary loss (Switch-style)
    density = first.mean(0)
    router_mean = probs.mean(0)
    aux = E * torch.sum(density * router_mean)

    # ---- group-local sort-based dispatch ----
    G = B if N % B == 0 else 1
    Ng = N // G
    C = int(Ng * k * capacity_factor / E) + 1
    buf, slot, keep, gates_s, places = group_local(
        lambda xg, eg, gg: _dispatch(xg, eg, gg, E, C, k),
        reshape_hinted(xf, (G, Ng, D), "batch", None, None),
        expert_ids.reshape(G, Ng * k),
        gate_vals.reshape(G, Ng * k))
    buf = shard_hint(buf, "batch", "tp", None, None)  # G->data, E->model

    # ---- expert FFN, batched over experts ----
    be = reshape_hinted(buf.transpose(0, 1), (E, G * C, D),
                        "tp", "batch", None, None)
    h = silu(be @ fsdp_gather(w_gate.to(cd))) \
        * (be @ fsdp_gather(w_up.to(cd)))
    h = shard_hint(h, "tp", "batch", None)
    out_buf = reshape_hinted(h @ fsdp_gather(w_down.to(cd)), (E, G, C, D),
                             "tp", "batch", None, None).transpose(0, 1)
    out_buf = shard_hint(out_buf, "batch", "tp", None, None)

    # ---- gather + combine (group-local) ----
    out = group_local(lambda *a: _combine(*a, k), out_buf, slot, keep,
                      gates_s, places)
    return out.reshape(B, S, D), aux
