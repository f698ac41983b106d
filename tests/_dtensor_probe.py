"""Which grids the sharded LM train step runs on with this torch.

    PYTHONPATH=src python tests/_dtensor_probe.py

Starts CPU gloo worlds (1, 1), (1, 2), (2, 1) and (1, 4), one process a
rank rendezvoused through a ``FileStore`` in a temporary directory, and
runs one float32 train step of every reduced arch on each: at tp = 2 with
5 heads, 5 KV heads, vocab 257 and 5 experts, so every padding path fires;
at tp = 4 with 6 heads and 2 KV heads (KV heads below tp, heads that do
not divide it) and 5 experts; ``granite_8b:padS`` pads the sequence to the
attention chunk.  Prints one ``WORLD`` line per (grid, arch): ``OK`` with
the loss, or ``FAIL`` with the error DTensor raised.  It is a probe of a
torch build (DTensor's sharding rules differ between versions), not a
test: a failure is reported and the next arch runs.  Imports neither jax
nor the reference.
"""
import dataclasses
import datetime
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import ALL_ARCHS, get_config
from repro_torch.distributed.logical import (axis_env, distribute_full,
                                             placements_for)
from repro_torch.distributed.sharding import batch_specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.train import steps

GRIDS = ((1, 1), (1, 2), (2, 1), (1, 4))
# odd widths a model-axis size: every padding path, KV heads below tp
ODD = {2: dict(n_heads=5, n_kv_heads=5, vocab=257),
       4: dict(n_heads=6, n_kv_heads=2, vocab=257)}


def _config(arch, tp):
    cfg = get_config(arch).reduced()
    if tp > 1 and cfg.family != "ssm":
        cfg = dataclasses.replace(
            cfg, **ODD[tp], **({"n_experts": 5} if cfg.n_experts else {}))
    return cfg


def _one(arch, pad_seq, mesh, tp):
    cfg = _config(arch, tp)
    state = steps.distribute_train_state(
        steps.init_train_state(cfg, 0, device="cpu"), mesh)
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (4, 12 if pad_seq else 16),
                        generator=gen)
    batch = {"tokens": tok, "labels": tok}
    if cfg.family == "vlm":
        batch["image_embed"] = torch.randn(4, cfg.prefix_len, cfg.d_model,
                                           generator=gen)
    bs = batch_specs(mesh, with_image=cfg.family == "vlm")
    placed = {k: distribute_full(v, mesh, placements_for(bs[k], mesh))
              for k, v in batch.items()}
    with axis_env(mesh):
        _, m = steps.make_train_step(cfg, attn_chunk=8)(state, placed)
    return float(m["loss"])


def _rank(rank, grid, store, queue):
    world = grid[0] * grid[1]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    lm.COMPUTE_DTYPE = torch.float32
    mesh = make_local_mesh(*grid, device="cpu")
    lines = []
    for name in tuple(ALL_ARCHS) + ("granite_8b:padS",):
        arch, _, pad = name.partition(":")
        try:
            lines.append(f"WORLD {grid} {name} OK loss "
                         f"{_one(arch, pad, mesh, grid[1]):.5f}")
        except Exception as err:                  # a probe: report, go on
            msg = " // ".join(l for l in str(err).splitlines() if l.strip())
            where = [l.strip() for l in traceback.format_exc().splitlines()
                     if "repro_torch" in l]
            lines.append(f"WORLD {grid} {name} FAIL {type(err).__name__}: "
                         f"{msg[-600:]} | {' / '.join(where)[-600:]}")
    if rank == 0:
        queue.put(lines)
    dist.destroy_process_group()


def main():
    print("torch", torch.__version__, flush=True)
    ctx = mp.get_context("spawn")
    for grid in GRIDS:
        queue = ctx.Queue()
        store = os.path.join(tempfile.mkdtemp(prefix="dtensor_probe_"),
                             "store")
        procs = [ctx.Process(target=_rank, args=(r, grid, store, queue))
                 for r in range(grid[0] * grid[1])]
        for p in procs:
            p.start()
        try:
            for line in queue.get(timeout=600):
                print(line, flush=True)
        finally:
            for p in procs:
                p.join(60)
                if p.is_alive():
                    p.kill()


if __name__ == "__main__":
    sys.exit(main())
