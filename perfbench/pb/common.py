"""What every run shares: the manifest, a cell's files found by name, the
cell's metrics, and the modules (drivers, generators, metric readers)
loaded from their files.

Nothing here knows a particular configuration, mix or metric: each is a
file of its own (``configs/<config>.json``, ``mixes/<traffic>.json``,
``drivers/<driver>.py``, ``data/<generator>.py``, ``metrics/<metric>.py``,
``cells/<cell>.json``), found from the names in ``BENCHMARK.json``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]     # perfbench/
ROOT = BENCH.parent                             # the checkout


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in man['workloads']]}")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return load_json(BENCH / "mixes" / f"{name}.json")


def cell_data(cell_name: str) -> dict:
    """The cell's own numbers: the limits of its checks."""
    return load_json(BENCH / "cells" / f"{cell_name}.json")


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(man: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics this cell reports (``--trace 0``)."""
    return [m for m in man["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(man: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics this cell reports (``--trace 1``): those that
    list it, and those without a list whose ``moves`` it reports."""
    mine = {m["name"] for m in end_to_end(man, cell_name)}
    return [m for m in man["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]
