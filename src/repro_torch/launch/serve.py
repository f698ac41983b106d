"""Serving launcher: batched prefill + decode with KV/SSM caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1p5b \\
      --reduced [--batch 4 --prompt-len 32 --gen 16] [--device cpu]

Prefills the prompt token by token into the cache (the reference's
portable path), then generates greedily with the one-token step, all
lanes in lockstep (a scalar position).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..data.tokens import SyntheticCorpus
from ..models.lm import init_cache, init_params
from ..train.steps import make_decode_step

__all__ = ["generate", "main"]


@torch.inference_mode()
def generate(cfg, params, prompts: np.ndarray, gen_len: int,
             max_seq: int = 0):
    """prompts: (B, P) int32. Greedy decode ``gen_len`` tokens on the
    device that holds ``params``."""
    B, P = prompts.shape
    dev = params.device
    max_seq = max_seq or (P + gen_len)
    cache = init_cache(cfg, B, max_seq, device=dev)
    step = make_decode_step(cfg)
    toks = torch.as_tensor(np.asarray(prompts), device=dev)
    out = []
    nxt = None
    t0 = time.time()
    for pos in range(P + gen_len - 1):
        cur = toks[:, pos:pos + 1] if pos < P else nxt
        nxt, logits, cache = step(params, cur, cache, pos)
        if pos >= P - 1:
            out.append(nxt[:, 0])
    toks_out = torch.stack(out, dim=1).cpu().numpy()
    dt = time.time() - t0
    return toks_out, {"steps": P + gen_len - 1,
                      "ms_per_token": dt * 1e3 / (P + gen_len - 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, 0, device=args.device)
    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=1)
    rng = np.random.default_rng(0)
    prompts = corpus.sample(rng, args.batch,
                            args.prompt_len)[:, :args.prompt_len]
    out, stats = generate(cfg, params, prompts, args.gen)
    print(f"[serve] generated {out.shape} tokens; "
          f"{stats['ms_per_token']:.1f} ms/token")
    print(out[:2])
    return out, stats


if __name__ == "__main__":
    main()
