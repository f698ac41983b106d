"""Run one cell of the benchmark of the PyTorch/CUDA port (``repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json``) names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/mixes/<traffic>.json``), whose ``driver``
(``perfbench/drivers/<driver>.py``) makes the inputs from the seed, builds
the program, warms up, runs the window and compares what the window
produced with the plain reference (``perfbench/reference/``) against the
cell's limits (``perfbench/cells/<cell>.json``).  Each metric is read from
the run's record by ``perfbench/metrics/<metric>.py``: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics (from the
benchmark's own spans and a ``torch.profiler`` trace of the window) with
``--trace 1``.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.

Not used by the benchmark's own runs: ``--dtype float32`` builds the
program with float32 factors (the lower-precision control, which has to
come out not correct).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
# every build and kernel cache at a fixed path inside the checkout (the
# port's own kernels build into src/repro_torch/kernels/_build/)
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _dir)

# one process with few threads: the host's thread pools take no cores
# from the serving loop and the driver of the kernels
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(k for k in list(sys.modules)
                  if k.split(".")[0] in FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dtype", choices=("float64", "float32"), default=None)
    args = ap.parse_args(argv)

    from pb import common
    from pb.checks import verdict
    from pb.context import Ctx
    man = common.manifest()
    cell = common.cell(man, args.workload)
    cfg = common.config(man, cell["config"])
    mix = common.mix(cell["traffic"])
    data = common.cell_data(cell["name"])

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import _build
    _build.build()
    ctx = Ctx(torch=torch, device=dev, cell=cell["name"], cfg=cfg, mix=mix,
              data=data, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t_start=T_START, dtype=args.dtype)
    res = common.load_module("drivers", mix["driver"]).run(ctx)
    correct, checks = verdict(res["values"], data["limits"])
    rec = res["record"]

    metrics = {}
    wanted = common.per_layer(man, cell["name"]) if args.trace else \
        common.end_to_end(man, cell["name"])
    for m in wanted:
        v = common.load_module("metrics", m["name"]).read(rec)
        if v is None:
            if not args.trace:
                print(f"no reading of the end-to-end metric {m['name']}",
                      file=sys.stderr)
                return 5
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power": power_limit()}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device}
    t = rec.get("trace")
    if args.trace:
        from pb import trace as tr
        device["busy_s"] = float(t["busy_s"])
        device["window_s"] = float(t["window_s"])
        out["breakdown"] = {"device_ops": tr.top_ops(t),
                            "idle_gaps": t["gaps"]}
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    print(f"correct: {correct}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
