"""Shared fixtures of the benchmark's CPU tests: the repository's
``src`` on the path, and each cell of ``BENCHMARK.json`` cut to a size
the CPU runs in seconds (its configuration's family and limits, its
traffic's shape of microbatches, tiny widths)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from potbench import spec  # noqa: E402

CELLS = [w["name"] for w in
         spec.read_json(ROOT / "BENCHMARK.json")["workloads"]]
TINY = {"dense": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                  "n_kv_heads": 2, "d_ff": 256, "vocab": 512},
        "moe": {"n_layers": 2, "d_model": 128, "n_heads": 4,
                "n_kv_heads": 4, "d_ff": 64, "vocab": 512, "n_experts": 8,
                "top_k": 3, "n_shared_experts": 2}}


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` at tiny widths: 8 rows of 64 tokens in 4
    microbatches, its limits and its metrics as they are."""
    cell = spec.load_cell(ROOT, name)
    port = dict(cell.config["port"])
    port.update(TINY[port["family"]])
    traffic = dict(cell.traffic, seq_len=64, global_batch=8, microbatches=4,
                   trace_steps=1)
    return dataclasses.replace(cell, config=dict(cell.config, port=port),
                               traffic=traffic)


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
