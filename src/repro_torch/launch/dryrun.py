"""Multi-pod dry run: trace every (arch × shape × mesh) cell on ``meta``.

The reference lowers and compiles each cell for 512 host devices and reads
XLA's memory and cost analyses.  Here the same cell runs once, as the
program would run it, with nothing behind it:

* **World.** A fake process group (``torch.testing``'s ``fake`` backend:
  no communication) of 256 ranks for the (16, 16) ``("data", "model")``
  mesh or 512 for (2, 16, 16) ``("pod", "data", "model")``, set up before
  any mesh is built (``launch/mesh.py::make_production_mesh(device=
  "cpu")``).  The tool refuses to start inside a real world.  A process
  holds one world, so ``--both-meshes`` runs each mesh in a subprocess.
* **Inputs.** Every input is a DTensor over a ``meta`` local shard (rank
  0's: ``with_named_sharding``'s ``ShardedMeta.local``) with the spec's
  placements and the global shape: the train state by ``param_specs``
  (its step a host scalar, as ``distribute_train_state`` keeps it), the
  batch by ``batch_specs``, a decode cache by ``cache_specs`` and its
  token by ``_batch_axes_for``.
* **"Lowering".** One call of the step under counters.  No device is
  touched and nothing is allocated: a host tool, as the reference's is,
  not a CPU fallback of a device path (no compute runs).  There is no
  compile step, so the record has ``trace_s`` in place of ``lower_s`` and
  ``compile_s``.

The counters see every op a rank runs: the local shards are wrapped in a
tensor subclass whose dispatch counts each op DTensor runs on them (and a
dispatch mode counts the ops run outside DTensor), so all numbers are per
rank, on local shapes:

* ``tc_flops``: ``dot``-class ops only (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, which ``matmul`` becomes), 2·numel(result)·contraction
  each, the definition of the reference's ``hlo_analysis``;
* ``tc_hbm_bytes``: operand plus result bytes of every op on the device.
  Eager torch runs each op as its own kernel, so this is the unfused
  count; ops that only make a view or allocate (no kernel) and
  collectives are left out;
* ``collectives``: result bytes per rank of each collective DTensor asks
  for, under the reference's keys, with ``count`` and ``total``, and
  ``tc_collective_total``.  DTensor's all-to-all counts as one (the CPU
  group's all-gather + chunk fallback is not what a card runs);
* ``memory``: ``argument_size`` (the per-rank bytes of the step's inputs
  that it reads: XLA drops an unused one, such as prefill's labels),
  ``output_size`` (of its outputs, the state updated in place included),
  ``temp_size`` (the peak of live per-rank bytes the step allocates beyond
  its arguments, remat as the step runs it) and ``generated_code_size``
  0.

Left out of the reference's record: ``lower_s``/``compile_s`` (no
compile), ``flops``/``hlo_bytes`` (XLA's ``cost_analysis``),
``tc_hbm_bytes_fused`` (no fusion in eager torch) and ``tc_collectives``
(the same numbers as ``collectives`` here: nothing runs in a loop XLA
would count once).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out results/dryrun]

With ``--all``, ``--arch`` or ``--shape`` keep only that arch's or shape's
cells (``--all --shape decode_32k``: every arch's decode).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from ..configs.base import ALL_ARCHS, SHAPES, applicable_shapes, get_config
from ..distributed.logical import axis_env, perf_env, placements_for
from ..distributed.sharding import (_batch_axes_for, batch_specs,
                                    cache_specs, param_specs,
                                    with_named_sharding)
from ..launch.inputs import input_specs
from ..launch.mesh import make_production_mesh
from ..models import lm
from ..train.steps import (abstract_train_state, make_decode_step,
                           make_prefill_step, make_train_step)

__all__ = ["lower_cell", "run_cell", "collective_bytes", "fake_world",
           "Tally", "main"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# DTensor's collectives (``_c10d_functional.all_gather_into_tensor``, ...)
# by the start of their names
_KIND_OF = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"))
_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
# ops that launch no kernel: views and bare allocations
_NO_KERNEL = {"empty", "empty_strided", "new_empty", "new_empty_strided",
              "detach", "alias", "lift_fresh"}


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks (this process is rank 0):
    collectives return tensors of the right shape and move nothing.
    Refuses a real world; a fake one of the same size is reused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own fake world; this "
                               f"process is in a {dist.get_backend()} world")
        if dist.get_world_size() != size:
            raise RuntimeError(f"a fake world of {dist.get_world_size()} "
                               f"ranks exists; this mesh needs {size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


# ---------------------------------------------------------------- counting
class Tally:
    """Per-rank counts of one traced step (see the module docstring)."""

    def __init__(self):
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = {k: 0 for k in _COLLECTIVES}
        self.n_collectives = 0
        self.live = 0
        self.peak = 0
        self.paused = False
        self._seen = WeakIdKeyDictionary()
        self._args = WeakIdKeyDictionary()

    # memory: one entry a storage, released when torch frees it
    def known(self, t: torch.Tensor) -> None:
        """Mark ``t``'s storage as an argument's (not the step's)."""
        st = t.untyped_storage()
        self._seen[st] = True
        self._args[st] = False

    def read(self, t: torch.Tensor) -> bool:
        """Whether an op of the step took argument ``t``'s storage (XLA
        leaves an unused argument out of ``argument_size``)."""
        return bool(self._args.get(t.untyped_storage(), False))

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen[st] = True
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def collective(self, kind: str, out) -> None:
        self.collectives[kind] += sum(
            t.numel() * t.element_size() for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor))
        self.n_collectives += 1

    def op(self, func, args, kwargs, out) -> None:
        """Count one op on plain (unwrapped) tensors."""
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in ins:
            st = t.untyped_storage()
            if st in self._args:
                self._args[st] = True
        if not any(t.device.type == "meta" for t in ins + outs):
            return                     # host scalars (the optimizer's step)
        for t in outs:
            self.track(t)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":     # wait_tensor & co. move nothing
            kind = next((k for key, k in _KIND_OF if name.startswith(key)),
                        None)
            if kind is not None:
                self.collective(kind, out)
            return
        if name in _DOTS:                # 2 · numel(result) · contraction
            self.flops += 2.0 * outs[0].numel() * args[-2].shape[-1]
        if func.is_view or name in _NO_KERNEL:
            return
        self.hbm_bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)


class _Local(torch.Tensor):
    """A ``meta`` local shard whose ops are counted: DTensor runs its
    local ops on these."""
    elem: torch.Tensor

    @staticmethod
    def __new__(cls, elem):
        r = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=False)
        r.elem = elem
        return r

    def __repr__(self):
        return f"_Local({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return _run(func, args, kwargs or {})


_TALLY: Optional[Tally] = None


def _unwrap(t):
    return t.elem if isinstance(t, _Local) else t


def _wrap(t):
    if isinstance(t, torch.Tensor) and not isinstance(t, _Local) \
            and t.device.type == "meta":
        return _Local(t)
    return t


def _run(func, args, kwargs):
    uargs, ukw = tree_map(_unwrap, args), tree_map(_unwrap, kwargs)
    out = func(*uargs, **ukw)
    if _TALLY is not None and not _TALLY.paused:
        _TALLY.op(func, uargs, ukw, out)
    # an in-place (or out=) op returns the wrapper it was given; a view a
    # new wrapper over the view (the data lives in the wrapped tensors)
    given = {id(t.elem): t for t in tree_flatten((args, kwargs))[0]
             if isinstance(t, _Local)}
    return tree_map(lambda t: given[id(t)] if id(t) in given else _wrap(t),
                    out)


class _Mode(TorchDispatchMode):
    """Counts the ops run outside DTensor (and wraps their ``meta``
    results, so DTensor's ops on them are counted too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return func(*args, **(kwargs or {}))
        return _run(func, args, kwargs or {})


@contextlib.contextmanager
def _counting(tally: Tally):
    """Count into ``tally``; DTensor's all-to-all counts as one
    collective, not as the CPU group's all-gather + chunk fallback."""
    import torch.distributed.tensor._collective_utils as cu
    from torch.distributed.tensor import placement_types as pt
    global _TALLY
    orig = cu.shard_dim_alltoall

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        tally.paused = True
        try:
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            tally.paused = False
        tally.collective("all-to-all", _unwrap(out))
        tally.track(_unwrap(out))
        return out

    patched = [m for m in (cu, pt) if getattr(m, "shard_dim_alltoall",
                                              None) is orig]
    for m in patched:
        m.shard_dim_alltoall = all_to_all
    prev, _TALLY = _TALLY, tally
    try:
        with _Mode():
            yield tally
    finally:
        _TALLY = prev
        for m in patched:
            m.shard_dim_alltoall = orig


def collective_bytes(tally: Tally) -> dict:
    """The reference's collective record: result bytes per rank of each
    kind, their ``count`` and ``total``."""
    out = dict(tally.collectives)
    out["count"] = tally.n_collectives
    out["total"] = sum(tally.collectives[c] for c in _COLLECTIVES)
    return out


# ---------------------------------------------------------------- inputs
def _placed(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A DTensor over ``t``'s rank-0 ``meta`` shard with ``spec``'s
    placements and ``t``'s global shape."""
    sm = with_named_sharding({"t": t}, {"t": spec}, mesh)["t"]
    return DTensor.from_local(_Local(sm.local), mesh,
                              placements_for(sm.spec, mesh), run_check=False,
                              shape=sm.full.shape, stride=sm.full.stride())


def _place_module(module: nn.Module, specs, mesh) -> nn.Module:
    """Every parameter of ``module`` as a placed ``meta`` DTensor, in
    place (``distribute_params`` without a full tensor behind it)."""
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        new = nn.Parameter(_placed(p, specs[name], mesh),
                           requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[leaf] = new
        else:
            setattr(owner, leaf, new)
    return module


class Lowered(NamedTuple):
    """A cell ready to trace: ``step(*args)``."""
    step: Any
    args: tuple


def _mesh(multi_pod: bool):
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               block_causal: bool = True, attn_chunk: int = 512,
               perf_opts: Optional[dict] = None, *, cfg=None, cell=None,
               mesh=None):
    """Place one (arch, shape, mesh) cell's inputs; returns ``(lowered,
    mesh, cfg)``.  ``cfg``, ``cell`` and ``mesh`` replace the arch's
    config, the shape's ``ShapeCell`` and the production mesh (a smaller
    cell's; a ``mesh`` needs its world set up by the caller)."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    if cell.name == "long_500k" and not cfg.subquadratic:
        raise ValueError(f"{arch} is pure full-attention; long_500k skipped "
                         "(DESIGN.md §Arch-applicability)")
    mesh = mesh if mesh is not None else _mesh(multi_pod)
    ins = input_specs(cfg, cell)
    opts = perf_opts or {}
    with_image = cfg.family == "vlm"

    def batch():
        bs = batch_specs(mesh, with_image=with_image)
        return {k: _placed(v, bs[k], mesh) for k, v in ins["batch"].items()}

    if cell.step == "train":
        state = abstract_train_state(cfg)
        specs = param_specs(state["params"], mesh)
        for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
            _place_module(tree, specs, mesh)
        state["opt"]["step"] = torch.zeros((), dtype=torch.int32)
        step = make_train_step(cfg, block_causal=block_causal,
                               attn_chunk=attn_chunk)
        args = (state, batch())
    elif cell.step == "prefill":
        params = lm.abstract_params(cfg)
        _place_module(params, param_specs(params, mesh), mesh)
        step = make_prefill_step(cfg, attn_chunk=attn_chunk,
                                 block_causal=block_causal)
        args = (params, batch())
    else:  # decode
        params = lm.abstract_params(cfg)
        _place_module(params, param_specs(params, mesh), mesh)
        cspecs = cache_specs(cfg, ins["cache"], mesh)
        cache = {k: _placed(v, cspecs[k], mesh)
                 for k, v in ins["cache"].items()}
        b = _batch_axes_for(mesh, ins["token"].shape[0])
        token = _placed(ins["token"], (b, None), mesh)
        step = make_decode_step(cfg)
        args = (params, token, cache, _Local(ins["pos"]))

    def traced(*a):
        with axis_env(mesh), perf_env(**opts):
            return step(*a)
    return Lowered(traced, args), mesh, cfg


def _local_tensors(tree):
    """The plain ``meta`` (and host) tensors one rank holds in ``tree``."""
    leaves = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, nn.Module):
            leaves += _local_tensors(list(t.parameters()))
        elif isinstance(t, dict):
            leaves += _local_tensors(list(t.values()))
        elif isinstance(t, torch.Tensor):
            if isinstance(t, DTensor):
                t = t._local_tensor
            leaves.append(_unwrap(t))
    return leaves


def _bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def trace(lowered: Lowered) -> dict:
    """Run ``lowered`` once under a :class:`Tally`: the record's counts."""
    arg_t = _local_tensors(lowered.args)
    tally = Tally()
    for t in arg_t:
        tally.known(t)
    with _counting(tally):
        out = lowered.step(*lowered.args)
    return {
        "tc_flops": tally.flops,
        "tc_hbm_bytes": tally.hbm_bytes,
        "collectives": collective_bytes(tally),
        "tc_collective_total": float(sum(tally.collectives.values())),
        "memory": {"argument_size": _bytes(t for t in arg_t
                                           if tally.read(t)),
                   "output_size": _bytes(_local_tensors(out)),
                   "temp_size": tally.peak,
                   "generated_code_size": 0},
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             out_dir: Optional[str] = None, **kw) -> dict:
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    try:
        lowered, mesh, cfg = lower_cell(arch, shape, multi_pod=multi_pod,
                                        **kw)
        counts = trace(lowered)
        rec["mesh"] = "x".join(str(s) for s in mesh.shape)
        rec.update({"ok": True, "trace_s": round(time.time() - t0, 1),
                    **counts, "n_devices": int(mesh.size()),
                    "params": cfg.param_count()})
    except Exception as e:  # noqa: BLE001 — recorded, not swallowed silently
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _report(rec: dict) -> bool:
    if rec["ok"]:
        mm = rec["memory"]
        per_dev = (mm["argument_size"] + mm["temp_size"]) / 1e9
        print(f"OK   {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"flops={rec['tc_flops']:.3e} hbm={rec['tc_hbm_bytes']:.3e} "
              f"coll={rec['tc_collective_total']:.3e}B "
              f"mem/dev≈{per_dev:.2f}GB (trace {rec['trace_s']}s)",
              flush=True)
        return True
    print(f"FAIL {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
          f"{rec['error']}", flush=True)
    return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name a cell with --arch and --shape, or pass --all")

    if args.both_meshes:
        # one world a process: each mesh in its own
        base = [a for a in (argv if argv is not None else sys.argv[1:])
                if a not in ("--both-meshes", "--multi-pod")]
        rcs = [subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.dryrun"] + base
                              + extra).returncode
               for extra in ([], ["--multi-pod"])]
        if any(rcs):
            raise SystemExit(f"a mesh's cells failed (exit codes {rcs})")
        return

    if args.all:       # every applicable cell, or those of --arch/--shape
        cells = [(a, cell.name) for a in ALL_ARCHS
                 for cell in applicable_shapes(get_config(a))
                 if args.arch in (None, a) and args.shape in (None, cell.name)]
    else:
        cells = [(args.arch, args.shape)]
    n_fail = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, multi_pod=args.multi_pod,
                       out_dir=args.out)
        n_fail += not _report(rec)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
