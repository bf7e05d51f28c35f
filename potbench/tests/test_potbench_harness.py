"""CPU tests of the harness: what it finds by name, the rules its names
and last line keep, what it imports and reads, and that it needs a
card."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import pytest
import torch
from conftest import CELLS, ROOT, tiny_cell

from potbench import bench, spec, trace

BENCH = spec.read_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_cells_configs_traffic_and_metrics_are_found_by_name(cell_name):
    cell = spec.load_cell(ROOT, cell_name)
    work = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    assert cell.traffic["name"] == work["traffic"]
    assert cell.config["name"] == work["config"]
    # the limits name some of the numbers the comparison computes
    assert cell.limits and set(cell.limits) <= {
        "loss_gap", "grad_gap", "grad_gap_median", "change_gap",
        "change_gap_median"}
    assert spec.load_module("reference", cell.config["port"]["family"])
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s",
                                                    "setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    with pytest.raises(KeyError):
        spec.load_cell(ROOT, "no-such-cell")
    with pytest.raises(KeyError):
        spec.load_module("metrics", "no_such_metric")


def test_benchmark_json_keeps_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["potbench"] and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and LINE.fullmatch(c["source"])
        assert LINE.fullmatch(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith("potbench/")
        f = spec.read_json(ROOT / c["file"])
        assert f["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert f["published"][k] != f[k]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert LINE.fullmatch(w["why"])
    ends = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in ends
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"]) and m["moves"] in ends
    for path in (ROOT / "potbench").rglob("*"):
        if "__pycache__" in path.parts or path.parent.name == "out":
            continue
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+",
                            str(path.relative_to(ROOT))), path


def run_tiny(name: str, trace_on: bool) -> dict:
    return bench.run(tiny_cell(name), seed=2 ** 31 + 11, seconds=0.2,
                     trace_on=trace_on, device="cpu", t0=time.time())


@pytest.mark.parametrize("trace_on", [False, True])
def test_last_line_has_only_the_contracts_keys(cell_name, trace_on):
    result = run_tiny(cell_name, trace_on)
    keys = RESULT_KEYS + (["breakdown"] if trace_on else []) + ["checks"]
    assert list(result) == keys
    line = json.dumps(result, allow_nan=False)
    assert "\n" not in line
    assert set(result["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
    if trace_on:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device ran: no device metric is written from a CPU run
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


DRIVE = """
import sys, time
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1], sys.argv[1] + "/potbench/tests"]
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str) else None)
import run as entry  # potbench/run.py
from conftest import tiny_cell
from potbench import bench
for name in sys.argv[2:]:
    bench.run(tiny_cell(name), seed=5, seconds=0.2, trace_on=True,
              device="cpu", t0=time.time())
print(repr((entry.imported_forbidden(),
            sorted({m.split('.')[0] for m in sys.modules}), opened)))
"""


@pytest.fixture(scope="module")
def driven():
    out = subprocess.run(
        [sys.executable, "-c", DRIVE, str(ROOT), *CELLS],
        capture_output=True, text=True, cwd=ROOT / "potbench",
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_no_jax_module_is_imported(driven):
    forbidden, names, _ = driven
    assert forbidden == []
    assert "repro_torch" in names       # the port itself was run
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in names         # whole top-level names


def test_nothing_of_the_jax_side_is_read(driven):
    _, _, opened = driven
    for path in opened:
        p = path.replace(str(ROOT), "")
        assert not p.startswith("/benchmarks"), path
        assert not p.startswith(("/BENCH_engines.json", "/chip_smoke.py",
                                 "/src/repro/")), path


@pytest.mark.parametrize("path", sorted((ROOT / "potbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    import ast
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "repro"), (path, name)


def test_no_card_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is seen: the run would measure")
    out = subprocess.run(
        [sys.executable, "potbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def synthetic_run(config, traffic) -> trace.TraceRun:
    """Two steps in a 1 s window: fills, AdamW kernels and a GEMM."""
    kernels = [("void at::native::FillFunctor<float>", 0.0, 0.1),
               ("void adamw_kernel<float, true>(float const*)", 0.2, 0.3),
               ("nvjet_gemm", 0.3, 0.55),
               ("void adamw_kernel<float, true>(float const*)", 0.6, 0.7)]
    host = [("aten::mm", 0.0, 0.9), ("cudaMalloc", 0.52, 0.58)]
    return trace.TraceRun(kernels=kernels, host_ops=host, window_s=1.0,
                          busy_s=0.55, steps=2, config=config,
                          traffic=traffic)


def test_metric_readers_on_a_synthetic_trace(cell_name):
    from potbench.yardstick import adamw, flops, peaks
    cell = spec.load_cell(ROOT, cell_name)
    run = synthetic_run(cell.config, cell.traffic)
    read = {m: spec.load_module("metrics", m).read
            for m in ("train_mfu", "fill_ms", "adamw_ms", "adamw_roofline",
                      "device_idle")}
    assert math.isclose(read["fill_ms"](run), 50.0)
    assert math.isclose(read["adamw_ms"](run), 100.0)
    need = adamw.param_elements(cell.config["port"]) * 28
    assert math.isclose(read["adamw_roofline"](run),
                        100 * need / peaks.HBM_BYTES_PER_S / 0.1)
    assert math.isclose(read["device_idle"](run), 45.0)
    tr = cell.traffic
    step = flops.model_flops_per_token(cell.config["port"], tr["seq_len"]) \
        * tr["seq_len"] * tr["global_batch"]
    assert math.isclose(read["train_mfu"](run),
                        100 * 2 * step / peaks.BF16_DENSE_FLOPS)
    empty = trace.TraceRun([], [], 1.0, 0.0, 2, cell.config, cell.traffic)
    assert all(f(empty) is None for f in read.values())
    b = trace.breakdown(run)
    assert b["device_ops"][0] == ["nvjet_gemm", pytest.approx(0.25)]
    assert b["idle_gaps"][0] == ["aten::mm", pytest.approx(0.4)]
    assert dict(b["idle_gaps"])["cudaMalloc"] == pytest.approx(0.05)


def test_union_merges_overlaps():
    assert trace.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    run = synthetic_run({}, {})
    assert math.isclose(
        sum(e - s for s, e in trace.union((s, e) for _, s, e in run.kernels)),
        run.busy_s)
