"""Build and load the port's CUDA kernels.

Every ``kernels/<name>/csrc/<name>.cu`` is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into a shared library with a plain C interface, which is loaded with
``ctypes``.  Each library is named by a hash of its source, the headers the
sources share (``kernels/*/csrc/*.cuh``) and the flags, and written under
``kernels/_build/`` (listed in ``.gitignore``), so a changed source or
header rebuilds and an unchanged one is reused within a checkout.

``--use_fast_math`` is deliberately absent: routing relies on ``x <= thr``
being false for NaN, the proximity kernel on IEEE float64 products, and
the histogram kernels on plain float32 adds in a fixed order.

A missing toolkit, a failed build or a missing card raises; nothing here
selects a plain version instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNEL_NAMES", "build", "load", "check", "nvcc_path"]

_ROOT = Path(__file__).resolve().parent
BUILD_DIR = _ROOT / "_build"
KERNEL_NAMES = ("leaf_route", "block_prox", "histogram", "row_topk",
                "collide")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("CUDA kernels need nvcc (set CUDA_HOME or put nvcc "
                       "on PATH); none was found")


def _source(name: str) -> Path:
    if name not in KERNEL_NAMES:
        raise ValueError(f"unknown kernel {name!r}; have {KERNEL_NAMES}")
    return _ROOT / name / "csrc" / f"{name}.cu"


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    for header in sorted(_ROOT.glob("*/csrc/*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_NAMES) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: ptxas report}`` for the
    sources compiled by this call; raises if any build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(n))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))     # atomic: readers never see a
            reports[n] = out                  # half-written library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point of
    ``lib`` (each library exports ``repro_error_string`` for the text)."""
    if err != 0:
        fn = lib.repro_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} failed with CUDA error {err}: "
                           f"{fn(err).decode()}")
