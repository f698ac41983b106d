"""``BENCHMARK.json`` keeps to the benchmark's format and limits, and
every name in it finds its file."""
from __future__ import annotations

import json
import os
import re

from conftest import BENCH, ROOT
from pb import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok")


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_manifest_shape():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    man = common.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"].startswith("perfbench/")
        cfg = common.load_json(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and not WIDTH.search(k)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    names = [w["name"] for w in man["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(names)
    cfgs = {c["name"] for c in man["configs"]}
    used = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
        used.add(w["config"])
    assert used == cfgs
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= \
        max(1, len(names) // 4)
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= len(man["per_layer"]) <= 128
    layers = {}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  common.end_to_end(man, w)}
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in names:
        mine = [m["name"] for m in common.end_to_end(man, w)]
        assert "setup_s" in mine and len(mine) >= 2
        assert common.per_layer(man, w)


def test_every_name_finds_its_files():
    man = common.manifest()
    for w in man["workloads"]:
        mix = common.mix(w["traffic"])
        assert _line(mix["why"])
        assert os.path.isfile(os.path.join(BENCH, "drivers",
                                           mix["driver"] + ".py"))
        data = common.cell_data(w["name"])
        assert data["limits"]
        cfg = common.config(man, w["config"])
        assert os.path.isfile(os.path.join(BENCH, "data",
                                           cfg["generator"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH, "reference", "methods",
                                           cfg["kernel_method"] + ".py"))


def test_every_cell_file_is_a_cell():
    man = common.manifest()
    names = {w["name"] for w in man["workloads"]}
    files = {f[:-len(".json")]
             for f in os.listdir(os.path.join(BENCH, "cells"))}
    assert files == names


def test_file_names_are_names():
    ok = re.compile(r"^[A-Za-z0-9_./-]+$")
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert ok.match(rel), rel
            if f.endswith(".json"):
                with open(os.path.join(d, f)) as fh:
                    json.load(fh)
