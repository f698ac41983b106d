"""Dry-run cells of ``tests/test_torch_dryrun.py``, one world a process.

    python tests/_torch_dryrun_cells.py SPEC.json

``SPEC`` names a ``task``, its arguments and an output path; the worker
sets up the task's fake world, runs its cells with
``repro_torch.launch.dryrun.run_cell`` and writes the records as JSON.
Imports neither jax nor the reference.

* ``tiny``: each arch of ``archs`` with its published head, KV-head,
  SSM-head, expert and vocab counts at tiny widths (:func:`tiny_config`),
  train, prefill and decode on the production mesh (``multi_pod``).
* ``small``: the reference test's reduced granite_8b on a (4, 4) mesh of
  a 16-rank world, train, prefill and decode (the reference's own cell).
"""
from __future__ import annotations

import dataclasses
import json
import sys

from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.launch import dryrun

TINY_B, TINY_S, TINY_CHUNK = 32, 64, 16
# the reference test's cell (tests/test_distributed.py's dry-run test)
SMALL = dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
             vocab=1024, d_head=32)
SMALL_B, SMALL_S, SMALL_CHUNK = 16, 256, 128
KINDS = ("train", "prefill", "decode")


def tiny_config(arch: str):
    """``arch`` at tiny widths (2 layers, 8-wide heads, small FFNs) with
    its published head, KV-head, SSM-head, expert, top-k and vocab
    counts; an SSM's ``d_model`` is what keeps its head count at 8-wide
    SSM heads."""
    cfg = get_config(arch)
    over = dict(n_layers=2, d_head=8, d_ff=32 if cfg.d_ff else 0,
                d_ff_expert=16 if cfg.n_experts else 0,
                prefix_len=min(cfg.prefix_len, 8),
                window=min(cfg.window, 32),
                global_layers=(0,) if cfg.global_layers else ())
    if cfg.ssm_state:
        over.update(ssm_head_dim=8, ssm_state=8,
                    d_model=cfg.ssm_heads * 8 // cfg.ssm_expand)
    else:
        over["d_model"] = 64
    return dataclasses.replace(cfg, **over)


def _cells(B, S):
    return {k: ShapeCell(f"{k}_{S}", S, B, k) for k in KINDS}


def task_tiny(spec):
    out = {}
    for arch in spec["archs"]:
        cfg = tiny_config(arch)
        for kind, cell in _cells(TINY_B, TINY_S).items():
            rec = dryrun.run_cell(arch, kind, multi_pod=spec["multi_pod"],
                                  cfg=cfg, cell=cell, attn_chunk=TINY_CHUNK)
            out[f"{arch}/{kind}"] = rec
    return out


def task_small(spec):
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_world(16)
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("granite_8b"), **SMALL)
    return {kind: dryrun.run_cell("granite_8b", kind, cfg=cfg, cell=cell,
                                  mesh=mesh, attn_chunk=SMALL_CHUNK)
            for kind, cell in _cells(SMALL_B, SMALL_S).items()}


TASKS = {"tiny": task_tiny, "small": task_small}


def main(path):
    with open(path) as f:
        spec = json.load(f)
    out = TASKS[spec["task"]](spec)
    with open(spec["out"], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
