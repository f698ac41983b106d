"""Ranks of the gloo worlds ``tests/test_torch_distributed.py`` starts.

    python tests/_torch_dist_worker.py SPEC.json

``SPEC`` names a ``task``, the grid ``(data, model)``, a ``FileStore``
path, a timeout and an output directory; the worker spawns one process a
rank, each rendezvouses through the store (no port is opened), runs the
task on a ``launch.mesh.make_local_mesh`` mesh and rank 0 writes what the
test compares.  Imports neither jax nor the reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs.base import get_config
from repro_torch.distributed.logical import (axis_env, distribute_full,
                                             full_tensor, perf_env,
                                             placements_for)
from repro_torch.distributed.sharding import (NamedSharding, batch_specs,
                                             cache_specs, distribute_params,
                                             param_specs)
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_launch
from repro_torch.models import lm
from repro_torch.train import checkpoint, steps
from repro_torch.train.optimizer import AdamWConfig

# the odd widths that make every padding path fire at tp = 2
ODD = {
    "dense": ("granite_8b", dict(n_heads=5, n_kv_heads=5, vocab=257)),
    "moe": ("granite_moe_3b_a800m",
            dict(n_heads=5, n_kv_heads=5, vocab=257, n_experts=5, top_k=2)),
    "hybrid": ("hymba_1p5b", dict(n_heads=5, n_kv_heads=5, vocab=257)),
}
# tp = 4 on a (1, 4) world: 6 heads do not divide it, 2 KV heads fall below
TP4 = dict(n_heads=6, n_kv_heads=2)
B, S, CHUNK = 4, 16, 16
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const")
LAUNCH = ["--arch", "granite_8b", "--reduced", "--steps", "3", "--batch",
          "4", "--seq", "16", "--device", "cpu"]


def odd_config(kind):
    arch, over = ODD[kind]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def tokens_for(vocab, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, S), generator=g)


def _flat(state):
    return {k: v for k, v in checkpoint._flatten(state).items()}


def _step_pair(cfg, mesh, compute, compress=False):
    """One train step on one device and the same step sharded on ``mesh``:
    the losses, grad norms, gradients (whole) and updated parameters."""
    old = lm.COMPUTE_DTYPE
    lm.COMPUTE_DTYPE = compute
    try:
        tok = tokens_for(cfg.vocab)
        batch = {"tokens": tok, "labels": tok}
        step = steps.make_train_step(cfg, OPT, attn_chunk=CHUNK,
                                     compress_grads=compress)
        one = steps.init_train_state(cfg, 0, device="cpu")
        _, g1 = steps.value_and_grad(cfg, one["params"], batch,
                                     attn_chunk=CHUNK)
        one, m1 = step(one, batch)
        two = steps.distribute_train_state(
            steps.init_train_state(cfg, 0, device="cpu"), mesh)
        bs = batch_specs(mesh)
        b2 = {k: distribute_full(v, mesh, placements_for(bs[k], mesh))
              for k, v in batch.items()}
        with axis_env(mesh):
            _, g2 = steps.value_and_grad(cfg, two["params"], b2,
                                         attn_chunk=CHUNK)
            two, m2 = step(two, b2)
        out = {"loss": np.array([float(m1["loss"]), float(m2["loss"])]),
               "gnorm": np.array([float(m1["grad_norm"]),
                                  float(m2["grad_norm"])])}
        names = [n for n, _ in one["params"].named_parameters()]
        for n, a, b in zip(names, g1, g2):
            out[f"g1/{n}"] = a.numpy()
            out[f"g2/{n}"] = full_tensor(b).numpy()
        for (n, a), (_, b) in zip(one["params"].named_parameters(),
                                  two["params"].named_parameters()):
            out[f"p1/{n}"] = a.detach().numpy()
            out[f"p2/{n}"] = full_tensor(b.detach()).numpy()
        placed = {n: str(tuple(p.placements))
                  for n, p in two["params"].named_parameters()}
        return out, two, placed
    finally:
        lm.COMPUTE_DTYPE = old


def _padded(mesh, kind, flags):
    """The padded forward and loss at this mesh's tp (float32), and the
    one-device forward, for one odd config."""
    cfg = odd_config(kind)
    old = lm.COMPUTE_DTYPE
    lm.COMPUTE_DTYPE = torch.float32
    try:
        tok = tokens_for(cfg.vocab, seed=3)
        with torch.no_grad():
            plain = lm.init_params(cfg, 0, device="cpu")
            one, _ = lm.forward(plain, cfg, tok, attn_chunk=CHUNK,
                                remat=False)
            params = lm.init_params(cfg, 0, device="cpu")
            distribute_params(params, param_specs(params, mesh), mesh)
            bs = batch_specs(mesh)
            t2 = distribute_full(tok, mesh, placements_for(bs["tokens"],
                                                           mesh))
            with axis_env(mesh), perf_env(**flags):
                logits, aux = lm.forward(params, cfg, t2, attn_chunk=CHUNK,
                                         remat=False)
                loss = lm.loss_fn(params, cfg, t2, t2, attn_chunk=CHUNK,
                                  remat=False)
        return {"logits": full_tensor(logits).numpy(),
                "aux": full_tensor(aux).numpy(),
                "loss": full_tensor(loss).numpy(),
                "one": one.numpy()}
    finally:
        lm.COMPUTE_DTYPE = old


def _launch(argv):
    old = lm.COMPUTE_DTYPE
    lm.COMPUTE_DTYPE = torch.float32
    try:
        _, hist = port_launch.main(argv)
    finally:
        lm.COMPUTE_DTYPE = old
    return hist


def _wait_for_checkpoint(path, timeout):
    """The (2, 2) world writes the checkpoint the others restore; they run
    at the same time and wait here for its ``LATEST`` pointer."""
    deadline = time.time() + timeout
    while checkpoint.latest_step(path) is None:
        if time.time() > deadline:
            raise TimeoutError(f"no checkpoint under {path}")
        time.sleep(0.2)


def task_grid(rank, spec, mesh):
    """Step parity on this grid in float32 (and bf16 on (2, 1)); on (2, 2)
    the int8 round trip and the checkpoint save; on the others the
    re-sharded restore and the launcher; on (1, 2) the padded paths at
    tp = 2."""
    cfg = get_config("granite_8b").reduced()
    grid = tuple(spec["grid"])
    res, meta = {}, {}
    f32, state, placed = _step_pair(cfg, mesh, torch.float32)
    res.update({f"f32/{k}": v for k, v in f32.items()})
    meta["placements"] = placed
    if grid == (2, 2):
        checkpoint.save_checkpoint(spec["ckpt"], 1, state)
        res.update({f"saved/{k}": v for k, v in _flat(state).items()})
        # int8: the same whole gradients, compressed plain and sharded
        names = [n for n, _ in state["params"].named_parameters()]
        grads = [torch.from_numpy(f32[f"g1/{n}"]) for n in names]
        plain = steps.compress_stacked(state["params"], grads)
        placed_g = [distribute_full(g, p.device_mesh, p.placements)
                    for g, p in zip(grads, state["params"].parameters())]
        sharded = steps.compress_stacked(state["params"], placed_g)
        for n, a, b in zip(names, plain, sharded):
            res[f"int8/plain/{n}"] = a.numpy()
            res[f"int8/sharded/{n}"] = full_tensor(b).numpy()
        return res, meta
    if grid == (2, 1):
        bf, _, _ = _step_pair(cfg, mesh, torch.bfloat16)
        res.update({f"bf16/{k}": v for k, v in bf.items()})
    if grid == (1, 2):
        for kind in ODD:
            for pad, flags in (("pad", {}),
                               ("nopad", dict(head_pad=False,
                                              expert_pad=False))):
                out = _padded(mesh, kind, flags)
                res.update({f"padded/{kind}/{pad}/{k}": v
                            for k, v in out.items()})
    _wait_for_checkpoint(spec["ckpt"], spec["timeout"])
    like = steps.distribute_train_state(
        steps.init_train_state(cfg, 0, device="cpu"), mesh)
    got = checkpoint.restore_checkpoint(spec["ckpt"], like)
    res.update({f"restored/{k}": v for k, v in _flat(got).items()})
    meta["restored_placements"] = {
        n: str(tuple(p.placements))
        for n, p in got["params"].named_parameters()}
    # the reference's shardings=: specs on this mesh, a plain like
    plain = steps.init_train_state(cfg, 0, device="cpu")
    sh = {n: NamedSharding(mesh, sp)
          for n, sp in param_specs(plain["params"], mesh).items()}
    got2 = checkpoint.restore_checkpoint(
        spec["ckpt"], plain, shardings={"params": sh, "opt": {"m": sh,
                                                              "v": sh}})
    res.update({f"restored2/{k}": v for k, v in _flat(got2).items()})
    meta["restored2_dtensor"] = all(
        hasattr(p, "placements") for p in got2["params"].parameters())
    meta["launch"] = _launch(LAUNCH + ["--data-par", str(grid[0]),
                                       "--model-par", str(grid[1])])
    return res, meta


def _decode_pair(cfg, mesh):
    """Two float32 decode steps (a lockstep int position, then one position
    a lane, so the new keys land in several ranks' sequence blocks) on one
    device and on ``mesh`` from the same seeded parameters and cache: the
    logits and the updated caches."""
    old = lm.COMPUTE_DTYPE
    lm.COMPUTE_DTYPE = torch.float32
    try:
        gen = torch.Generator().manual_seed(5)
        cache = {k: torch.randn(v.shape, generator=gen)
                 for k, v in lm.init_cache(cfg, B, S, dtype=torch.float32,
                                           device="cpu").items()}
        toks = [tokens_for(cfg.vocab, seed=s)[:, :1] for s in (6, 7)]
        poss = [5, torch.tensor([6, 2, 9, 15])]
        one = lm.init_params(cfg, 0, device="cpu")
        c1 = {k: v.clone() for k, v in cache.items()}
        two = lm.init_params(cfg, 0, device="cpu")
        distribute_params(two, param_specs(two, mesh), mesh)
        cs = cache_specs(cfg, cache, mesh)
        c2 = {k: distribute_full(v.clone(), mesh, placements_for(cs[k], mesh))
              for k, v in cache.items()}
        bs = batch_specs(mesh)
        out = {}
        for i, (tok, pos) in enumerate(zip(toks, poss)):
            l1, c1 = lm.decode_step(one, cfg, tok, c1, pos)
            t2 = distribute_full(tok, mesh, placements_for(bs["tokens"], mesh))
            with axis_env(mesh):
                l2, c2 = lm.decode_step(two, cfg, t2, c2, pos)
            out[f"logits1/{i}"] = l1.numpy()
            out[f"logits2/{i}"] = full_tensor(l2).numpy()
        for k in cache:
            out[f"cache1/{k}"] = c1[k].numpy()
            out[f"cache2/{k}"] = full_tensor(c2[k]).numpy()
        return out
    finally:
        lm.COMPUTE_DTYPE = old


def task_tp4(rank, spec, mesh):
    """tp = 4 with 6 heads and 2 KV heads: the float32 train step against
    one device (granite_8b reduced), and the flash-decode step against one
    device (granite_8b and hymba reduced)."""
    cfg = dataclasses.replace(get_config("granite_8b").reduced(), **TP4)
    f32, _, placed = _step_pair(cfg, mesh, torch.float32)
    res = {f"f32/{k}": v for k, v in f32.items()}
    for arch in ("granite_8b", "hymba_1p5b"):
        dcfg = dataclasses.replace(get_config(arch).reduced(), **TP4)
        res.update({f"decode/{arch}/{k}": v
                    for k, v in _decode_pair(dcfg, mesh).items()})
    return res, {"placements": placed}


def task_one(rank, spec, mesh):
    """A one-rank mesh runs one device's local kernels: the bf16 train
    step of granite_8b and hymba reduced, for the bits."""
    res = {}
    for arch in ("granite_8b", "hymba_1p5b"):
        out, _, _ = _step_pair(get_config(arch).reduced(), mesh,
                               torch.bfloat16)
        res.update({f"{arch}/{k}": v for k, v in out.items()})
    return res, {}


TASKS = {"grid": task_grid, "tp4": task_tp4, "one": task_one}


def _rank(rank, spec):
    torch.set_num_threads(1)
    world = spec["grid"][0] * spec["grid"][1]
    store = dist.FileStore(spec["store"], world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        mesh = port_mesh.make_local_mesh(*spec["grid"], device="cpu")
        res, meta = TASKS[spec["task"]](rank, spec, mesh)
        if rank == 0:
            np.savez(os.path.join(spec["out"], "res.npz"), **res)
            with open(os.path.join(spec["out"], "meta.json"), "w") as f:
                json.dump(meta, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(path):
    with open(path) as f:
        spec = json.load(f)
    world = spec["grid"][0] * spec["grid"][1]
    mp.spawn(_rank, args=(spec,), nprocs=world, join=True)


if __name__ == "__main__":
    main(sys.argv[1])
