"""Nothing the benchmark runs loads JAX, Flax or the JAX package
(``repro``), and nothing of it reads the JAX package's benchmarks.  Top-level
module names are compared whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import os
import re
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {src!r}]
sys.argv = ["run.py"]
import run                                       # the entry point's imports
from pb import common
man = common.manifest()
sys.path.insert(0, {tests!r})
from conftest import tiny_run
cells = man["workloads"]
for kind, names in (("drivers", {{common.mix(w["traffic"])["driver"]
                                   for w in cells}}),
                    ("data", {{common.config(man, c["name"])["generator"]
                               for c in man["configs"]}}),
                    ("metrics", {{m["name"] for m in man["end_to_end"]
                                  + man["per_layer"]}})):
    for n in names:
        common.load_module(kind, n)
for w in cells:                                  # a whole run of each cell
    tiny_run(w["name"], seconds=0.2)
bad = sorted(k for k in sys.modules if k.split(".")[0] in {forbidden!r})
print("FORBIDDEN", bad)
print("PORT", "repro_torch.core.api" in sys.modules)
"""


def test_no_jax_or_jax_package_in_a_run():
    code = PROBE.format(bench=BENCH, src=os.path.join(ROOT, "src"),
                        tests=os.path.join(BENCH, "tests"),
                        forbidden=FORBIDDEN)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "PORT True" in out.stdout


def test_run_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, BENCH)
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", object())
    assert "repro_torch_fake.x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in run.forbidden_modules()


def test_no_reads_under_benchmarks():
    pat = re.compile(r"(^|[^\w])(import\s+benchmarks|from\s+benchmarks"
                     r"|['\"]benchmarks/|['\"]\.\./benchmarks)")
    me = os.path.abspath(__file__)
    hits = []
    for d, _, files in os.walk(BENCH):
        for f in files:
            p = os.path.join(d, f)
            if p == me or not f.endswith((".py", ".json", ".txt")):
                continue
            with open(p, encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    if pat.search(line):
                        hits.append(f"{p}:{i}: {line.strip()}")
    assert not hits, hits
