"""The entry point's refusals: without a card, and in a directory holding
only the benchmark's own files, it exits with another code than 0 and
prints no result."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

ARGS = ["--workload", "rf_gap_covtype.allpairs", "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
