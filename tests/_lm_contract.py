"""The bf16 acceptance rule of the LM port, in one place for its CPU tests
(``_torch_lm``) and for ``chip_smoke.py``'s phase 10 on the card.  It
imports torch and numpy only, never jax, so the card run can use it.

Per position (all axes but the last): |got - ref| within ``BF16_REL`` x
max|ref|, and the same argmax wherever the reference's top-2 margin exceeds
that tolerance.  A MoE position at a router near-tie (top-k probability gap
under ``ROUTER_TIE``, recorded by ``router_gaps``) may be exempt."""
import contextlib

import numpy as np
import torch

BF16_REL = 0.05         # bf16: per position, a share of the largest |logit|
ROUTER_TIE = 0.01       # MoE: router probability gap below which bf16 may
#                         route a token to another expert


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def logit_stats(got, ref, what=""):
    """Per position, computed on ``got``'s device: the largest |got - ref|,
    max|ref|, the reference's top-2 margin and whether the argmaxes agree,
    as host arrays.  Either may be a tensor or any array numpy reads."""
    got, ref = (x if isinstance(x, torch.Tensor)
                else torch.from_numpy(np32(x)) for x in (got, ref))
    got, ref = got.float(), ref.to(got.device).float()
    assert got.shape == ref.shape, (what, tuple(got.shape), tuple(ref.shape))
    assert bool(got.isfinite().all()), (what, "non-finite logits")
    top, arg = ref.max(-1, keepdim=True)
    second = ref.scatter(-1, arg, float("-inf")).amax(-1)
    return (np32((got - ref).abs().amax(-1)), np32(ref.abs().amax(-1)),
            np32(top[..., 0] - second),
            (got.argmax(-1) == arg[..., 0]).cpu().numpy())


def bf16_contract(got, ref, skip=None, what=""):
    """Assert the contract; ``skip`` marks exempt positions.  Returns the
    largest gap as a share of its position's max|ref| and the count of
    positions whose argmax was decided (and so checked)."""
    gap, scale, margin, agree = logit_stats(got, ref, what)
    tol = BF16_REL * scale
    keep = np.ones(gap.shape, bool) if skip is None else ~np.asarray(skip)
    assert keep.mean() > 0.5, (what, "most positions exempt")
    bad = keep & (gap > tol)
    assert not bad.any(), (what, "logit gap", gap[bad][:4], tol[bad][:4])
    decided = keep & (margin > tol)
    assert agree[decided].all(), (what, "argmax differs at", np.argwhere(
        decided & ~agree)[:4].tolist())
    return float((gap / np.maximum(scale, 1e-30))[keep].max()), \
        int(decided.sum())


@contextlib.contextmanager
def router_gaps(out: list):
    """Record, for every top-k the port's MoE router takes, each token's
    gap between its k-th and (k+1)-th router probability (host arrays)."""
    topk = torch.topk

    def spy(probs, k, dim=-1, **kw):
        s = probs.sort(dim=-1, descending=True).values
        out.append(np32(s[..., k - 1] - s[..., k]))
        return topk(probs, k, dim=dim, **kw)
    torch.topk = spy
    try:
        yield out
    finally:
        torch.topk = topk
