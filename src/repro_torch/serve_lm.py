"""Serving example: batched generation with KV/SSM caches across families
(twin of the reference's ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.serve_lm [--device cpu]

Runs a dense (granite), an SSM (mamba2) and a hybrid (hymba) reduced model
through prefill + batched greedy decode.
"""
from __future__ import annotations

import argparse

import numpy as np

from .configs.base import get_config
from .data.tokens import SyntheticCorpus
from .launch.serve import generate
from .models.lm import init_params

ARCHS = ("granite_8b", "mamba2_2p7b", "hymba_1p5b")


def main(device: str = "cuda") -> dict:
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, 0, device=device)
        corpus = SyntheticCorpus(vocab=cfg.vocab, seed=1)
        prompts = corpus.sample(np.random.default_rng(0), 4, 16)[:, :16]
        toks, stats = generate(cfg, params, prompts, gen_len=12)
        print(f"[{arch:14s}] generated {toks.shape[1]} tokens x "
              f"{toks.shape[0]} seqs, {stats['ms_per_token']:.1f} ms/token "
              f"(cache family: {cfg.family}, device {params.device})")
        out[arch] = toks
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
