"""End-to-end LM training (twin of the reference's
``examples/train_lm_e2e.py``): a ~100M-class model, a few hundred steps
on the synthetic motif corpus, with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.train_lm_e2e [--quick] \\
        [--steps N] [--device cpu] [--ckpt-dir DIR]

The checkpoints go to ``repro_e2e_ckpt`` in the temporary directory unless
``--ckpt-dir``, so a second run resumes from the first, as the reference's
does.  It passes when the mean loss of the last 10 steps is more than 0.3
under that of the first 10.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from .configs.base import get_config
from .launch.train import train_loop

__all__ = ["e2e_config", "run_kw", "summary", "main"]


def e2e_config(quick: bool = False):
    """granite_8b's family shrunk to ~100M parameters (12 x 768, vocab
    8,192, ``d_ff`` 2,048, 4 KV heads); ``quick``: 4 x 256."""
    cfg = dataclasses.replace(
        get_config("granite_8b"), n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=8192, d_head=64)
    if quick:
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, n_heads=4,
                                  n_kv_heads=2, d_ff=512, d_head=64)
    return cfg


def run_kw(quick: bool = False, steps: int = 0) -> dict:
    """``train_loop``'s arguments for the run (all but the directory)."""
    return dict(steps=steps or (50 if quick else 300),
                global_batch=4 if quick else 8,
                seq_len=128 if quick else 256, save_every=100, lr=6e-4,
                attn_chunk=64, log_every=10)


def summary(hist):
    """(first, last, passed): the mean loss of the first and the last 10
    steps, and the PASS rule ``last < first - 0.3``."""
    first = sum(h["loss"] for h in hist[:10]) / 10
    last = sum(h["loss"] for h in hist[-10:]) / 10
    return first, last, last < first - 0.3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_e2e_ckpt"))
    args = ap.parse_args(argv)

    cfg = e2e_config(args.quick)
    kw = run_kw(args.quick, args.steps)
    print(f"[e2e] {cfg.name}-derived model: {cfg.param_count() / 1e6:.1f}M "
          f"params, {kw['steps']} steps")
    state, hist = train_loop(cfg, ckpt_dir=args.ckpt_dir, device=args.device,
                             **kw)
    first, last, ok = summary(hist)
    print(f"[e2e] loss {first:.3f} -> {last:.3f} "
          f"({'PASS' if ok else 'CHECK'})")
    return state, hist


if __name__ == "__main__":
    main()
