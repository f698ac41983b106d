"""Durable engine snapshots — warm-start serving without refitting.

The reference's archive format, written and read by the port, so that an
archive crosses between the two packages in either direction.

``save_kernel`` captures a fitted :class:`~repro_torch.core.api.ForestKernel`
as a single ``np.savez_compressed`` archive: the packed trees, binner edges,
in-bag state, training references, routed training leaves, and the engine
weight factors as **compressed CSR components** (``indptr/indices/data`` of
the leaf maps Q/W — zeros dropped; format v2).  v1 archives, which stored
the dense ``q``/``w``, load with a one-time migration note.  A JSON
**manifest** (stored as a uint8 array inside the archive) records the format
name, a version field, the kernel config, a per-array sha256 checksum, and
two structural digests:

- ``ctx_digest``   — sha256 of the rebuilt ensemble context (T, θ),
- ``factor_digest`` — sha256 of the dense factors of P = Q Wᵀ.

Both digests hash host copies in the reference's dtypes, so they are the
reference's strings for the same forest.  The config is written under the
reference's field names, with the values the reference reads as its own
defaults (``dtype`` float64, the scipy engine, ``auto`` routing and
trainer), the kernel's own out-of-core settings (``scratch_dir``,
``memory_budget_bytes``) and no ``device``, so the reference's
``ForestKernel.load`` accepts a port archive.

``load_kernel`` verifies every checksum, rebuilds forest → context → engine
on the requested device (the saved leaves skip routing the training set:
no routing kernel launch), restores the dense factors bit for bit from the
CSR on the host, moves them to the device once and injects them (no weight
is recomputed — the point of warm-starting), and refuses to return an
engine whose digests disagree with the save-time record.  A loaded kernel
therefore computes the saved kernel's bits: same leaves, same factors, same
kernels.  The reference's engine and routing backends are ignored (they
agree to 1e-8 and the port has one of each), its trainer backend maps to
``"auto"``, and an archive's out-of-core settings (``scratch_dir``,
``memory_budget_bytes``) are honoured: the loaded kernel keeps them and
builds its engine under them, with the same answers.  An archive
whose ``dtype`` is not float64 is refused: float32 factors are not ported.

Failure modes all raise :class:`SnapshotError` with a reason: unknown
format, version mismatch, missing arrays, checksum mismatch (corruption),
digest mismatch (a rebuild that no longer reproduces the saved engine), or
a float32 archive.
"""
from __future__ import annotations

import hashlib
import json
import time
import warnings

import numpy as np

from ..forest.training import Binner
from ..forest.trees import pack_trees, unpack_trees
from ..obs.metrics import global_registry
from .context import EnsembleContext
from .engine import ProximityEngine
from .factorization import factor_digest
from .weights import get_assignment

__all__ = ["save_kernel", "load_kernel", "SnapshotError",
           "SNAPSHOT_FORMAT", "SNAPSHOT_VERSION"]

SNAPSHOT_FORMAT = "repro-forest-kernel"
SNAPSHOT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

# one-time note when a dense-factor v1 archive is loaded
_v1_migration_noted = False

_TREE_KEYS = ("node_offset", "depth", "feature", "threshold", "left",
              "right", "leaf_id", "value", "n_node_samples")
# ForestKernel fields the two packages share, in the reference's order
_SHARED_CONFIG = ("model_type", "kernel_method", "task", "n_trees",
                  "max_depth", "min_samples_leaf", "max_features", "n_bins",
                  "seed")


class SnapshotError(RuntimeError):
    """A snapshot failed validation (corruption, version, or digest)."""


def _observe_snapshot(op: str, dt: float) -> None:
    """Time a successful save/load into ``snapshot_seconds{op}`` on the
    process-wide registry (no-op when it is disabled)."""
    global_registry().histogram(
        "snapshot_seconds", "engine snapshot save/load time",
        labels=("op",)).labels(op=op).observe(dt)


def _checksum(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _reference_config(fk) -> dict:
    """The kernel's config as the reference's ``ForestKernel(**config)``
    takes it: the shared fields, then the reference's own settings at the
    values that match the port (float64), and the out-of-core settings."""
    config = {k: getattr(fk, k) for k in _SHARED_CONFIG}
    config.update(dtype="float64", engine_backend="scipy",
                  routing_backend="auto", tree_backend="auto",
                  n_jobs=fk.n_jobs, scratch_dir=fk.scratch_dir,
                  memory_budget_bytes=fk.memory_budget_bytes)
    return config


def save_kernel(fk, path) -> dict:
    """Write a fitted ForestKernel to ``path`` (npz).  Returns the manifest."""
    t0 = time.perf_counter()
    if fk.engine is None or fk.forest is None or fk.ctx is None:
        raise ValueError("fit the kernel before saving (engine is not built)")
    forest, eng = fk.forest, fk.engine
    binner = forest.binner_

    arrays = {f"tree_{k}": v for k, v in pack_trees(forest.trees_).items()}
    arrays["inbag"] = forest.inbag_
    arrays["tree_weights"] = forest.tree_weights_
    arrays["binner_edges_flat"] = binner.edges_flat
    arrays["binner_edge_offset"] = binner.edge_offset
    arrays["binner_edge_count"] = binner.edge_count
    arrays["X"] = np.asarray(forest.X_, dtype=np.float64)
    arrays["y"] = np.asarray(forest.y_)
    arrays["leaves"] = np.ascontiguousarray(fk.ctx.leaves.cpu().numpy(),
                                            dtype=np.int32)
    # factors as CSR components (v2): the dense (N, T) weight arrays are
    # recovered exactly on load (dropped entries were exactly 0.0), while
    # the archive only pays for the nonzeros
    arrays["factor_q_data"] = np.asarray(eng.Q.data)
    arrays["factor_q_indices"] = np.asarray(eng.Q.indices)
    arrays["factor_q_indptr"] = np.asarray(eng.Q.indptr)
    if eng.w is not eng.q:
        arrays["factor_w_data"] = np.asarray(eng.W.data)
        arrays["factor_w_indices"] = np.asarray(eng.W.indices)
        arrays["factor_w_indptr"] = np.asarray(eng.W.indptr)

    manifest = {
        "format": SNAPSHOT_FORMAT,
        "version": SNAPSHOT_VERSION,
        "config": _reference_config(fk),
        "n_classes": int(forest.n_classes_),
        "base_score": (float(forest.base_score_)
                       if hasattr(forest, "base_score_") else None),
        "symmetric": bool(eng.w is eng.q),
        "binner_n_bins": int(binner.n_bins),
        "checksums": {k: _checksum(v) for k, v in arrays.items()},
        "ctx_digest": fk.ctx.digest(),
        "factor_digest": factor_digest(eng.gl, eng.q, eng.w),
    }
    arrays["manifest"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    _observe_snapshot("save", time.perf_counter() - t0)
    return manifest


def _dense_factor_from_csr(data: np.ndarray, indices: np.ndarray,
                           indptr: np.ndarray, leaf_offset: np.ndarray,
                           n_trees: int) -> np.ndarray:
    """Exact inverse of ``build_leaf_map`` for forest leaf maps, on the host.

    Global leaf ranges are disjoint per tree, so each stored column index
    maps to a unique tree via ``searchsorted(leaf_offset)``; entries the
    CSR dropped carried weight exactly 0.0, which the zero initialization
    restores bit-for-bit (weights are nonnegative — no -0.0 to lose).
    """
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    t = np.searchsorted(leaf_offset, indices, side="right") - 1
    q = np.zeros((n, n_trees), dtype=data.dtype)
    q[rows, t] = data
    return q


def _read(path):
    """(manifest, arrays) of an archive, or SnapshotError."""
    try:
        with np.load(path) as data:
            if "manifest" not in data.files:
                raise SnapshotError(f"{path}: no manifest — not a "
                                    f"{SNAPSHOT_FORMAT} snapshot")
            manifest = json.loads(bytes(data["manifest"].tobytes()).decode())
            arrays = {k: data[k] for k in data.files if k != "manifest"}
    except (OSError, ValueError, KeyError) as exc:
        raise SnapshotError(f"{path}: unreadable snapshot ({exc})") from exc
    return manifest, arrays


def load_kernel(path, device="cuda"):
    """Rebuild a ForestKernel on ``device`` from an archive that either
    package wrote (see the module docstring).  Raises
    :class:`SnapshotError` on any validation failure."""
    from .api import ForestKernel      # circular at module scope

    t0 = time.perf_counter()
    manifest, arrays = _read(path)
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(f"{path}: format {manifest.get('format')!r} != "
                            f"{SNAPSHOT_FORMAT!r}")
    version = manifest.get("version")
    if version not in SUPPORTED_VERSIONS:
        raise SnapshotError(
            f"{path}: snapshot version {version!r} not "
            f"supported (have {SUPPORTED_VERSIONS})")
    if version == 1:
        global _v1_migration_noted
        if not _v1_migration_noted:
            _v1_migration_noted = True
            warnings.warn(
                f"{path}: dense-factor snapshot (format v1) — loads fine, "
                "but re-saving writes the compressed CSR v2 layout and "
                "shrinks the archive", stacklevel=2)
    for name, want in manifest["checksums"].items():
        if name not in arrays:
            raise SnapshotError(f"{path}: missing array {name!r}")
        if _checksum(arrays[name]) != want:
            raise SnapshotError(f"{path}: checksum mismatch on {name!r} "
                                "(corrupted snapshot)")

    config = manifest["config"]
    dtype = np.dtype(config.get("dtype", "float64"))
    if dtype != np.float64:
        raise SnapshotError(
            f"{path}: a {dtype.name} kernel; the port computes in float64 "
            "only (float32 factors are not ported)")
    fk = ForestKernel(**{k: config[k] for k in _SHARED_CONFIG
                         if k in config},
                      n_jobs=config.get("n_jobs", 0), device=device,
                      scratch_dir=config.get("scratch_dir"),
                      memory_budget_bytes=config.get("memory_budget_bytes"))

    forest = fk._forest()
    forest.trees_ = unpack_trees({k: arrays[f"tree_{k}"]
                                  for k in _TREE_KEYS})
    forest.inbag_ = np.ascontiguousarray(arrays["inbag"], dtype=np.int32)
    forest.n_classes_ = int(manifest["n_classes"])
    forest.binner_ = Binner.from_state(
        arrays["binner_edges_flat"], arrays["binner_edge_offset"],
        arrays["binner_edge_count"], manifest["binner_n_bins"])
    forest.X_ = arrays["X"]
    forest.y_ = arrays["y"]
    forest.tree_weights_ = np.asarray(arrays["tree_weights"],
                                      dtype=np.float64)
    if manifest.get("base_score") is not None and \
            hasattr(forest, "base_score_"):
        forest.base_score_ = float(manifest["base_score"])
    forest._cache_tables()
    fk.forest = forest

    # saved leaves skip re-routing the training set; masses are cheap
    ctx = EnsembleContext.from_forest(
        forest, leaves=np.ascontiguousarray(arrays["leaves"],
                                            dtype=np.int32))
    if ctx.digest() != manifest["ctx_digest"]:
        raise SnapshotError(f"{path}: rebuilt context digest mismatch")
    fk.ctx = ctx
    fk.assignment = get_assignment(fk.kernel_method, ctx)

    if version == 1:
        q, w = arrays["factor_q"], arrays.get("factor_w")
    else:
        T = ctx.n_trees
        q = _dense_factor_from_csr(
            arrays["factor_q_data"], arrays["factor_q_indices"],
            arrays["factor_q_indptr"], ctx.leaf_offset, T)
        w = None
        if "factor_w_data" in arrays:
            w = _dense_factor_from_csr(
                arrays["factor_w_data"], arrays["factor_w_indices"],
                arrays["factor_w_indptr"], ctx.leaf_offset, T)
    fk.engine = ProximityEngine(ctx, fk.assignment, forest=forest,
                                factors=(q, w),
                                memory_budget_bytes=fk.memory_budget_bytes,
                                factor_scratch_dir=fk.scratch_dir)
    if factor_digest(fk.engine.gl, fk.engine.q,
                     fk.engine.w) != manifest["factor_digest"]:
        raise SnapshotError(f"{path}: rebuilt factor digest mismatch")
    fk.Q_, fk.W_ = fk.engine.Q, fk.engine.W
    _observe_snapshot("load", time.perf_counter() - t0)
    return fk
