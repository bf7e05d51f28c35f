"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the reference package
``repro`` (checked on the source, so a lazy import inside a function is
caught too), and importing the port builds nothing."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, repro_torch, repro_torch.kernels.ops, "
        "repro_torch.kernels.conflict, repro_torch.kernels.kv_commit, "
        "repro_torch.convert, repro_torch.core.workloads, "
        "repro_torch.core.oracle, repro_torch.models.lm, "
        "repro_torch.serve.session, repro_torch.launch.serve, "
        "repro_torch.kernels.fused_adamw, repro_torch.optim, "
        "repro_torch.train, repro_torch.data.pipeline, "
        "repro_torch.ckpt.checkpoint, repro_torch.core.checkpoint, "
        "repro_torch.launch.train, repro_torch.tree, "
        "repro_torch.kernels.validate, repro_torch.core.occ, "
        "repro_torch.core.pogl, repro_torch.core.destm, "
        "repro_torch.core.legacy_scan, repro_torch.launch.train_lm, "
        "repro_torch.runtime.straggler\n"
        "from repro_torch.configs import get_config\n"
        "get_config('stablelm-12b')\n"
        "from repro_torch.kernels import _build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not _build._loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)
