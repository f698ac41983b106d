"""Training launcher: the end-to-end loop with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b \\
      --reduced --steps 200 --batch 16 --seq 256 --ckpt-dir CKPT \\
      [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite_8b --reduced --data-par 2 --model-par 2 [--device cpu]

One device (the card unless ``--device cpu``) when ``--data-par`` and
``--model-par`` are 1 and no world was started; otherwise a ``(data,
model)`` mesh over the world's ranks (NCCL on cards, gloo with ``--device
cpu``), whose size must be ``data x model``.  Features exercised end to
end: sharded state, deterministic skip-ahead data
(``TokenPipeline.batch_at``), atomic checkpoints in the reference's
format, resume from the latest one (onto any grid), WSD/cosine schedules,
int8 gradient compression, straggler monitoring.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from ..configs.base import get_config
from ..data.tokens import TokenPipeline
from ..device import resolve_device
from ..distributed.logical import axis_env, distribute_full, placements_for
from ..distributed.sharding import batch_specs
from ..launch.mesh import make_local_mesh
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.fault_tolerance import HeartbeatMonitor
from ..train.optimizer import AdamWConfig
from ..train.steps import (distribute_train_state, init_train_state,
                           make_train_step)

__all__ = ["train_loop", "launch_mesh", "main"]


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str, device="cuda", mesh=None, save_every: int = 50,
               lr: float = 3e-4, compress_grads: bool = False,
               attn_chunk: int = 128, log_every: int = 10,
               monitor: HeartbeatMonitor = None, fail_at: int = None):
    """Train ``cfg`` from seed 0 (or from the latest checkpoint under
    ``ckpt_dir``) up to ``steps``; returns the state and each step's
    metrics as floats.  ``fail_at`` raises before that step (a simulated
    failure).

    With a ``mesh`` (a ``DeviceMesh`` named ``("data", "model")``, from
    ``launch.mesh.make_local_mesh``) every rank draws the full state from
    seed 0 and keeps its shards (``param_specs``), each step's global
    batch is placed by ``batch_specs``, and the step runs under
    ``axis_env(mesh)``; the device is the mesh's (``device`` is then not
    read).  A resumed state takes the same placements."""
    if mesh is not None:
        dev = torch.device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
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
    if mesh is not None:
        distribute_train_state(state, mesh)
        bspec = batch_specs(mesh, with_image=cfg.family == "vlm")
    if start is not None:
        state = restore_checkpoint(ckpt_dir, state,
                                   device=None if mesh is not None else dev)
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
        if mesh is not None:
            batch = {k: distribute_full(v, mesh,
                                        placements_for(bspec[k], mesh))
                     for k, v in batch.items()}
        with axis_env(mesh) if mesh is not None \
                else contextlib.nullcontext():
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

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return train_loop(cfg, steps=args.steps, global_batch=args.batch,
                      seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                      device=args.device,
                      mesh=launch_mesh(args.data_par, args.model_par,
                                       args.device),
                      save_every=args.save_every,
                      lr=args.lr, compress_grads=args.compress_grads)


def launch_mesh(data: int, model: int, device):
    """The ``(data, model)`` mesh of a launch, or None for one device
    (both 1 and no world).  Under ``torchrun`` (``WORLD_SIZE`` set) this
    starts the world from its environment: NCCL on cards, gloo for the
    CPU.  The world's size must be ``data x model``."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized() and data * model == 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"--data-par {data} x --model-par {model} must "
                         f"equal the world size, {world}")
    return make_local_mesh(data, model, device=device)


if __name__ == "__main__":
    main()
