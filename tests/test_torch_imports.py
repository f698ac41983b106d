"""The port stands alone: it imports neither jax nor the reference."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
# chip_smoke.py, the gloo-world and dry-run workers of the port's tests,
# the DTensor probe, the LM A/B timer and the collision crossover probe,
# and the bf16 and float32 contracts chip_smoke shares with the tests
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "tests" / "_lm_contract.py",
                                     ROOT / "tests" / "_f32_contract.py",
                                     ROOT / "tests" / "_torch_dist_worker.py",
                                     ROOT / "tests" / "_torch_dryrun_cells.py",
                                     ROOT / "tests" / "_dtensor_probe.py",
                                     ROOT / "tests" / "_lm_ab.py",
                                     ROOT / "tests" / "_collide_probe.py"]


def _module_names():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(PKG.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


# the application layer, the observability, snapshot and serving layers
# over it, the out-of-core modules, the LM serving and training paths, the
# LM's sharding layer, the dry-run tools and the example twins
LM_MODULES = (
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.command_r_35b", "repro_torch.configs.granite_34b",
    "repro_torch.configs.granite_8b",
    "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.configs.hymba_1p5b", "repro_torch.configs.mamba2_2p7b",
    "repro_torch.configs.minicpm_2b", "repro_torch.configs.musicgen_large",
    "repro_torch.configs.paligemma_3b",
    "repro_torch.configs.qwen3_moe_235b_a22b",
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.ssm",
    "repro_torch.models.moe", "repro_torch.models.lm",
    "repro_torch.models.convert", "repro_torch.data.tokens",
    "repro_torch.train", "repro_torch.train.steps", "repro_torch.launch",
    "repro_torch.launch.serve", "repro_torch.serve.engine",
    "repro_torch.serve_lm", "repro_torch.proximity_head_lm",
    "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
    "repro_torch.train.fault_tolerance", "repro_torch.launch.train",
    "repro_torch.distributed", "repro_torch.distributed.compression",
    "repro_torch.train_lm_e2e", "repro_torch.distributed.logical",
    "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
    "repro_torch.launch.inputs", "repro_torch.launch.dryrun")
SLICE_MODULES = LM_MODULES + (
    "repro_torch.applications", "repro_torch.applications.embed",
    "repro_torch.applications.imputation",
    "repro_torch.applications.outliers",
    "repro_torch.applications.propagate",
    "repro_torch.applications.prototypes",
    "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
    "repro_torch.obs.profile", "repro_torch.obs.http",
    "repro_torch.core.snapshot", "repro_torch.serve",
    "repro_torch.serve.proximity", "repro_torch.serve.reliability",
    "repro_torch.serve_proximities", "repro_torch.core.factorization",
    "repro_torch.core.context", "repro_torch.core.engine",
    "repro_torch.forest.training", "repro_torch.forest.ensemble",
    "repro_torch.data.synthetic", "repro_torch.quickstart",
    "repro_torch.paper_pipeline", "repro_torch.proximity_applications")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_every_application_module_is_covered(module):
    """The import check above walks the package; the application, obs,
    snapshot, serving, out-of-core and LM modules and the twins are among
    what it imports."""
    assert module in _module_names()


@pytest.mark.parametrize("module", LM_MODULES)
def test_every_lm_source_is_scanned(module):
    """The source scan below reads each LM module's file."""
    rel = module.replace(".", "/")
    assert (ROOT / "src" / f"{rel}.py") in FILES or \
        (ROOT / "src" / rel / "__init__.py") in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {n}"
