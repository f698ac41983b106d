"""Training launcher: the end-to-end loop with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
      --reduced --steps 200 --batch 16 --seq 256 --ckpt-dir CKPT \\
      [--device cpu]

One device: the card unless ``--device cpu``.  Features exercised end to
end: deterministic skip-ahead data (``TokenPipeline.batch_at``), atomic
checkpoints in the reference's format, resume from the latest one,
WSD/cosine schedules, int8 gradient compression, straggler monitoring.
A data- or model-parallel mesh (``--data-par``, ``--model-par`` other than
1) comes with the multi-GPU slice (ROADMAP Queue 1) and raises here.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.base import get_config
from ..data.tokens import TokenPipeline
from ..device import resolve_device
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.fault_tolerance import HeartbeatMonitor
from ..train.optimizer import AdamWConfig
from ..train.steps import init_train_state, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str, device="cuda", save_every: int = 50,
               lr: float = 3e-4, compress_grads: bool = False,
               attn_chunk: int = 128, log_every: int = 10,
               monitor: HeartbeatMonitor = None, fail_at: int = None):
    """Train ``cfg`` from seed 0 (or from the latest checkpoint under
    ``ckpt_dir``) up to ``steps``; returns the state and each step's
    metrics as floats.  ``fail_at`` raises before that step (a simulated
    failure)."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=min(50, steps // 10 + 1),
                          schedule=cfg.lr_schedule)
    pipe = TokenPipeline(
        vocab=cfg.vocab, global_batch=global_batch, seq_len=seq_len,
        d_model_for_image=cfg.d_model,
        image_prefix=cfg.prefix_len if cfg.family == "vlm" else 0)

    start = latest_step(ckpt_dir) if ckpt_dir else None
    state = init_train_state(cfg, 0, device=dev)
    if start is not None:
        state = restore_checkpoint(ckpt_dir, state, device=dev)
        print(f"[train] resumed from step {start}", flush=True)
    start = start or 0
    step_fn = make_train_step(cfg, opt_cfg, attn_chunk=attn_chunk,
                              compress_grads=compress_grads,
                              block_causal=True)
    hist = []
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"simulated failure at step {step}")
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        if monitor is not None:
            monitor.beat(0, dt)
        hist.append(metrics)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e} "
                  f"{dt*1e3:.0f}ms", flush=True)
        if ckpt_dir and (step + 1) % save_every == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, state)
    return state, hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny same-family config")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model (e.g. ~100M class model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError(
            "a data- or model-parallel mesh is not ported yet: it comes "
            "with the multi-GPU slice (ROADMAP Queue 1, 'Multi-GPU, with "
            "the sharding layer'); run with --data-par 1 --model-par 1")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return train_loop(cfg, steps=args.steps, global_batch=args.batch,
                      seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                      device=args.device, save_every=args.save_every,
                      lr=args.lr, compress_grads=args.compress_grads)


if __name__ == "__main__":
    main()
