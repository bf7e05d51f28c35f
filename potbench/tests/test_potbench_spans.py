"""CPU tests of the span attribution (``potbench/spans.py``) and its
readers: the path walk on a synthetic Chrome trace, the rule of
``Spans.seconds``, the eight readers, and a traced tiny CPU run of each
cell in which every span of its family owns some host operation."""

from __future__ import annotations

import json
import math
import time

import pytest
from conftest import CELLS, ROOT, tiny_cell

from potbench import bench, spans, spec, trace

READERS = ("attn_ms", "mlp_ms", "moe_ms", "moe_dispatch_ms", "head_ms",
           "grad_sum_ms", "commit_ms", "unspanned_ms")
PID, MAIN, BWD = 1, 10, 20     # the process, the forward and autograd threads


def host(name, ts, dur, tid=MAIN, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def launch(ts, corr, tid=MAIN):
    return host("cudaLaunchKernel", ts, 1.0, tid, "cuda_runtime",
                correlation=corr)


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def flow(ph, ts, tid, fid):
    return {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": fid,
            "pid": PID, "tid": tid, "ts": ts}


def annotation(name, ts, dur, tid=MAIN):
    return host(name, ts, dur, tid, "user_annotation")


def synthetic_events(with_spans=True) -> list:
    """One step in a window of 1,000 us, kernels in us (corr: owner):
    1 ``pot.attn`` forward, 2 ``("pot.moe", "pot.mlp")`` forward,
    3 ``pot.moe.dispatch`` under ``pot.moe``, 4 no span (a norm),
    5 the backward of the matmul of kernel 2 (linked by a flow),
    6 the recompute of ``pot.attn`` inside a backward node,
    7 the commit, whose launch no aten operation encloses,
    8 the recompute of a norm (no span) inside that backward node."""
    a = annotation if with_spans else (lambda n, ts, dur, tid=MAIN:
                                       host("aten::view", ts, dur, tid))
    ev = [annotation("potbench.window", 0.0, 1000.0),
          a("pot.attn", 10.0, 40.0),
          host("aten::mm", 20.0, 20.0), launch(25.0, 1),
          a("pot.moe", 60.0, 100.0),
          a("pot.mlp", 70.0, 30.0),
          host("aten::matmul", 75.0, 20.0), host("aten::mm", 76.0, 10.0),
          launch(80.0, 2), flow("s", 76.0, MAIN, 9),
          a("pot.moe.dispatch", 110.0, 40.0),
          host("aten::cumsum", 120.0, 10.0), launch(121.0, 3),
          host("aten::mul", 200.0, 10.0), launch(201.0, 4),
          host("autograd::engine::evaluate_function: MmBackward0", 300.0,
               50.0, BWD),
          host("MmBackward0", 301.0, 40.0, BWD), flow("f", 301.0, BWD, 9),
          host("aten::mm", 310.0, 10.0, BWD), launch(311.0, 5, BWD),
          host("autograd::engine::evaluate_function: TanhBackward0", 400.0,
               100.0, BWD),
          a("pot.attn", 410.0, 30.0, BWD),
          host("aten::mm", 420.0, 10.0, BWD), launch(421.0, 6, BWD),
          host("aten::mul", 450.0, 10.0, BWD, **{"Sequence number": 7,
                                                 "Fwd thread id": 0}),
          launch(451.0, 8, BWD),
          a("pot.commit", 600.0, 50.0), launch(610.0, 7)]
    kernels = [kernel("gemm", 30.0, 10.0, 1), kernel("gemm", 85.0, 20.0, 2),
               kernel("scan", 125.0, 40.0, 3), kernel("mul", 205.0, 5.0, 4),
               kernel("gemm", 315.0, 30.0, 5), kernel("gemm", 425.0, 10.0, 6),
               kernel("adamw_kernel", 615.0, 20.0, 7),
               kernel("mul", 455.0, 2.0, 8)]
    return ev + kernels


OWNERS = {1: (("pot.attn",), False), 2: (("pot.moe", "pot.mlp"), False),
          3: (("pot.moe", "pot.moe.dispatch"), False), 4: ((), False),
          5: (("pot.moe", "pot.mlp"), True), 6: (("pot.attn",), False),
          7: (("pot.commit",), False), 8: ((), False)}


def test_the_walk_gives_nested_paths_backward_marks_and_empty_paths():
    ev = synthetic_events()
    tree = spans.HostTree(ev)
    got = {e["args"]["correlation"]: tree.owner(i) for i, e in enumerate(ev)
           if e["cat"] == "cuda_runtime"}
    assert got == OWNERS
    # a backward node that no flow links to a forward operation
    orphan = host("autograd::engine::evaluate_function: AddBackward0",
                  900.0, 5.0, BWD)
    tree = spans.HostTree(ev + [orphan])
    assert tree.owner(len(ev)) == ((), True)


def test_seconds_counts_any_element_of_the_path_forward_and_backward():
    owned = spans.read_trace(synthetic_events(), steps=1)
    us = lambda s: round(s * 1e6, 6)
    assert us(owned.seconds("pot.moe")) == 20 + 40 + 30
    assert us(owned.seconds("pot.mlp")) == 20 + 30
    assert [us(t) for path, bwd, t in owned.owned
            if "pot.mlp" in path and bwd] == [30]
    assert us(owned.seconds("pot.attn")) == 10 + 10
    assert us(owned.seconds("pot.attn", "pot.commit")) == 10 + 10 + 20
    assert us(owned.unspanned_s()) == 5 + 2
    assert owned.ms("pot.loss") is None
    # a trace with no program span gives nothing to read
    assert spans.read_trace(synthetic_events(with_spans=False), 1) is None


def _traced(tmp_path, monkeypatch, cell: str, events: list,
            steps: int = 1) -> trace.TraceRun:
    """A run as ``trace.run_traced`` leaves it, its Chrome trace under
    ``tmp_path``."""
    monkeypatch.setattr(spans, "OUT", tmp_path)
    (tmp_path / f"{cell}.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    c = spec.load_cell(ROOT, cell)
    kernels = [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
               for e in events if e["cat"] == "kernel"]
    return trace.TraceRun(kernels, [], 1e-3, sum(k[2] - k[1]
                                                 for k in kernels),
                          steps, c.config, c.traffic)


def test_the_readers_on_a_synthetic_trace(tmp_path, monkeypatch, cell_name):
    run = _traced(tmp_path, monkeypatch, cell_name, synthetic_events(), 2)
    read = {m: spec.load_module("metrics", m).read(run) for m in READERS}
    ms = lambda us: us / 1e3 / 2
    assert read == pytest.approx({
        "attn_ms": ms(20), "mlp_ms": ms(50), "moe_ms": ms(90),
        "moe_dispatch_ms": ms(40), "head_ms": None, "grad_sum_ms": None,
        "commit_ms": ms(20), "unspanned_ms": ms(7)})
    # the outermost spans and the unspanned kernels partition the time
    parts = ("attn_ms", "moe_ms", "commit_ms", "unspanned_ms")
    assert math.isclose(sum(read[m] for m in parts),
                        1e3 * run.busy_s / run.steps)


def test_the_readers_read_nothing_without_spans_or_the_runs_trace(
        tmp_path, monkeypatch, cell_name):
    read = [spec.load_module("metrics", m).read for m in READERS]
    plain = _traced(tmp_path, monkeypatch, cell_name,
                    synthetic_events(with_spans=False))
    assert all(f(plain) is None for f in read)
    # another window's trace (the run's is 1 ms long)
    other = _traced(tmp_path, monkeypatch, cell_name, synthetic_events())
    other.window_s = 2e-3
    assert all(f(other) is None for f in read)
    cell = spec.load_cell(ROOT, cell_name)
    empty = trace.TraceRun([], [], 1.0, 0.0, 2, cell.config, cell.traffic)
    assert all(f(empty) is None for f in read)


FAMILY = {"dense": {"pot.attn", "pot.mlp", "pot.logits", "pot.loss",
                    "pot.grad_sum", "pot.commit"},
          "moe": {"pot.attn", "pot.mlp", "pot.moe", "pot.moe.route",
                  "pot.moe.dispatch", "pot.moe.experts", "pot.moe.combine",
                  "pot.logits", "pot.loss", "pot.grad_sum", "pot.commit"}}


@pytest.mark.parametrize("name", CELLS)
def test_every_span_owns_host_time_in_a_traced_tiny_run(name):
    cell = tiny_cell(name)
    bench.run(cell, seed=2 ** 31 + 5, seconds=0.2, trace_on=True,
              device="cpu", t0=time.time())
    path = bench.OUT / f"{name}.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    tree = spans.HostTree(events)
    owned, backward = set(), set()
    for i, e in enumerate(events):
        if e.get("cat") == "cpu_op" and e["dur"] > 0:
            path_, bwd = tree.owner(i)
            owned.update(path_)
            if bwd:
                backward.update(path_)
    assert owned == FAMILY[cell.config["port"]["family"]]
    # the backward pass is owned by the layers' forward spans
    assert {"pot.attn", "pot.mlp", "pot.logits", "pot.loss"} <= backward
    assert "pot.commit" not in backward and "pot.grad_sum" not in backward
