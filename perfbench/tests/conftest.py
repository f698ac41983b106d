"""Shared helpers of the benchmark's own tests: every cell's driver run on
the CPU at a tiny size (the port's plain kernel versions), and a fixture
that skips card-only tests without a card."""
from __future__ import annotations

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CFG = {"n_train": 1500, "n_trees": 12}
TINY_MIX = {"check_rows": 64}
SEED = 2 ** 31 + 12345


def tiny_run(cell_name: str, trace: bool = False, dtype=None,
             seconds: float = 0.5, device: str = "cpu", cfg=None,
             seed: int = SEED):
    """Drive one cell of ``BENCHMARK.json`` end to end at a tiny size;
    returns (correct, checks, driver result, {metric: reading})."""
    import torch
    from pb import common
    from pb.checks import verdict
    from pb.context import Ctx
    man = common.manifest()
    cell = common.cell(man, cell_name)
    c = dict(common.config(man, cell["config"]))
    c.update(TINY_CFG)
    c.update(cfg or {})
    mix = dict(common.mix(cell["traffic"]))
    mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
    data = common.cell_data(cell_name)
    ctx = Ctx(torch=torch, device=torch.device(device), cell=cell_name,
              cfg=c, mix=mix, data=data, seed=seed, seconds=seconds,
              trace=trace, t_start=time.perf_counter(), dtype=dtype)
    res = common.load_module("drivers", mix["driver"]).run(ctx)
    ok, checks = verdict(res["values"], data["limits"])
    wanted = [m["name"] for m in (common.per_layer(man, cell_name) if trace
                                  else common.end_to_end(man, cell_name))]
    metrics = {m: common.load_module("metrics", m).read(res["record"])
               for m in wanted}
    return ok, checks, res, metrics


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
