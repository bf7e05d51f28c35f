"""The port's mesh construction (``repro_torch.launch.mesh``): importing
it touches no device and no process group, the production mesh's shape
arithmetic on H100 NVLink domains, and ``make_host_mesh`` over a gloo
world of 2 ranks."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

import _torch_dist

from repro_torch.launch import mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_import_touches_no_device_and_no_group():
    code = (
        "import torch, torch.distributed as dist\n"
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun, "
        "repro_torch.launch.roofline_model, repro_torch.runtime.shardings\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)


@pytest.mark.parametrize("n,multi_pod,shape,axes", [
    (8, False, (1, 8), ("data", "model")),
    (64, False, (8, 8), ("data", "model")),
    (256, False, (32, 8), ("data", "model")),
    (16, True, (2, 1, 8), ("pod", "data", "model")),
    (64, True, (2, 4, 8), ("pod", "data", "model")),
    (512, True, (2, 32, 8), ("pod", "data", "model")),
])
def test_production_mesh_shape(n, multi_pod, shape, axes):
    assert mesh.production_mesh_shape(n, multi_pod) == (shape, axes)


@pytest.mark.parametrize("n,multi_pod", [
    (1, False), (4, False), (12, False), (8, True), (24, True)])
def test_production_mesh_shape_rejects(n, multi_pod):
    with pytest.raises(ValueError):
        mesh.production_mesh_shape(n, multi_pod)


def test_host_mesh_over_gloo(tmp_path):
    _torch_dist.spawn(_torch_dist.mesh_worker, 2, tmp_path / "rdv",
                      str(tmp_path / "done"))
    assert sorted(p.name for p in tmp_path.glob("done.*")) == [
        "done.0", "done.1"]
