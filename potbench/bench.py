"""One run of one cell: the port's Pot training step on its cell's
configuration and traffic.

1. Set-up builds the program's one training object: the initial
   float32 weights from the seed (``weights.py``), ``train.init_state``
   and ``train.make_train_step(cfg, mode="pot", optimizer="adamw",
   n_microbatches=M)`` with its default ``remat=True``, and drives it
   through the first ``checked_steps`` steps of the feed.  Those steps
   warm up every shape the window uses and give the readings the
   reference is held to: each step's loss, the first gradient's norm
   of each leaf as AdamW got it (its first moment after one step over
   1 - b1) and the norm of each leaf's change after those steps.
2. The window runs whole steps of the same object and feed, untraced
   (``--trace 0``: ``train_tokens_per_s``) or under the profiler
   (``--trace 1``: the per-layer metrics of ``metrics/``).
3. After the window, with the peak memory read and the program's state
   freed, the plain reference of the configuration's family
   (``reference/<family>.py``) runs the same steps from the same
   weights and batches, and ``verdict`` decides ``correct`` from the
   numbers of ``gaps`` that the cell's limits file names.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import subprocess
import sys
import time

import torch

from potbench import spec, trace
from potbench.feed import Feed
from potbench.reference.common import Precision, flatten, run_steps
from potbench.weights import Weights
from potbench.yardstick import peaks

OUT = spec.HERE / "out"
MOVED = 1e-3     # a leaf whose reference gradient is under MOVED x the
                 # median leaf's moves by round-off alone under AdamW


@dataclasses.dataclass
class Readings:
    losses: list        # each checked step's loss
    grad_norms: list    # each leaf's first gradient norm
    change_norms: list  # each leaf's change after the checked steps


@dataclasses.dataclass
class Program:
    weights: Weights
    feed: Feed
    state: object
    step: object
    index: int = 0      # the next batch of the feed
    losses: list = dataclasses.field(default_factory=list)

    def step_once(self):
        self.state, loss = self.step(self.state, self.feed(self.index))
        self.losses.append(loss)
        self.index += 1


def model_config(config: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["port"].items()})


def weights_of(cfg, seed: int, device) -> Weights:
    """The seed's weights in the port's parameter tree for ``cfg``."""
    from repro_torch.models import lm
    return Weights(lm.init_params(None, cfg, dtype=torch.float32,
                                  device="meta"), seed, device)


def build(cell: spec.Cell, seed: int, device) -> Program:
    """The program's training object at step 0."""
    from repro_torch import train

    torch.use_deterministic_algorithms(True)
    cfg = model_config(cell.config)
    tr = cell.traffic
    weights = weights_of(cfg, seed, device)
    state = train.init_state(weights.build())
    step = train.make_train_step(cfg, mode="pot", optimizer="adamw",
                                 n_microbatches=tr["microbatches"],
                                 lr=tr["adamw"]["lr"], wd=tr["adamw"]["wd"])
    return Program(weights, Feed(tr, cfg.vocab, seed, device), state, step)


def first_steps(prog: Program, traffic: dict) -> Readings:
    """The checked steps, through the window's own call and feed."""
    one_minus_b1 = 1.0 - torch.tensor(traffic["adamw"]["b1"],
                                      dtype=torch.float32)
    grad_norms = None
    for _ in range(traffic["checked_steps"]):
        prog.step_once()
        if grad_norms is None:
            grad_norms = [float(m.norm() / one_minus_b1)
                          for _, m in flatten(prog.state.opt["m"])]
    readings = Readings([float(x) for x in prog.losses], grad_norms,
                        prog.weights.change_norms(prog.state.params))
    prog.losses.clear()
    return readings


def reference(cell: spec.Cell, seed: int, device,
              precision: str = "float32") -> Readings:
    """The reference's readings of the checked steps, from the seed's
    weights and batches."""
    cfg = model_config(cell.config)
    family = spec.load_module("reference", cell.config["port"]["family"])
    weights = weights_of(cfg, seed, device)
    feed = Feed(cell.traffic, cfg.vocab, seed, device)
    params = weights.build()
    losses, grads = run_steps(family, params, feed, cell.config["port"],
                              cell.traffic, Precision(precision),
                              cell.traffic["checked_steps"])
    return Readings(losses, grads, weights.change_norms(params))


def _gap(a: float, b: float, scale: float) -> float:
    g = abs(a - b) / scale if scale > 0 else math.inf
    return g if math.isfinite(g) else math.inf


def leaf_gaps(prog: Readings, ref: Readings) -> tuple[list, list]:
    """Each leaf's relative gap of its first gradient norm and of its
    change's norm: the gap between the program's norm and the
    reference's over the larger of the reference's norm of that leaf and
    of the median leaf.  The change is held over the leaves the
    reference moves (``MOVED``), None for the others."""
    med = statistics.median(ref.grad_norms)
    grad = [_gap(a, b, max(b, med))
            for a, b in zip(prog.grad_norms, ref.grad_norms)]
    moved = [g >= MOVED * med for g in ref.grad_norms]
    medc = statistics.median(c for c, m in zip(ref.change_norms, moved)
                             if m)
    change = [_gap(a, b, max(b, medc)) if m else None
              for a, b, m in zip(prog.change_norms, ref.change_norms,
                                 moved)]
    return grad, change


def gaps(prog: Readings, ref: Readings) -> dict:
    """The numbers a cell may compare (its limits file names those it
    does): the largest relative gap of a checked step's loss; the worst
    leaf's gap of the first gradient norm and of the change's norm
    (:func:`leaf_gaps`), and the median leaf's."""
    grad, change = leaf_gaps(prog, ref)
    change = [c for c in change if c is not None]
    return {"loss_gap": max(_gap(a, b, abs(b))
                            for a, b in zip(prog.losses, ref.losses)),
            "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}


def timed(step_once, seconds: float, device: torch.device):
    """Whole steps until ``seconds`` have passed; the window ends at the
    end of the last step that began inside it.  Returns (steps,
    seconds)."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        step_once()
        n += 1
    sync()
    return n, time.perf_counter() - t0


def verdict(found: dict, limits: dict) -> tuple[dict, bool]:
    """Each number compared beside its limit, and whether every one is
    within it; a gap that is not a number is not (null in JSON)."""
    checks = {k: {"value": found[k] if math.isfinite(found[k]) else None,
                  "limit": limit} for k, limit in limits.items()}
    return checks, all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values())


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


def run(cell: spec.Cell, *, seed: int, seconds: float, trace_on: bool,
        device, t0: float) -> dict:
    """One run; returns the result's line as a dict."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    t_start = time.time()
    prog = build(cell, seed, device)
    t = time.time()
    t_build = t - t_start
    readings = first_steps(prog, cell.traffic)
    t_first = time.time() - t
    metrics, extra = {}, {}
    if trace_on:
        path = OUT / f"{cell.name}.trace.json"
        tr = trace.run_traced(prog.step_once, cell.traffic["trace_steps"],
                              device, path, cell.config, cell.traffic)
        for m in cell.per_layer:
            value = spec.load_module("metrics", m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = trace.breakdown(tr)
    else:
        setup_s = time.time() - t0
        n, secs = timed(prog.step_once, seconds, device)
        tokens = n * prog.feed.tokens_per_step
        values = {"train_tokens_per_s": (tokens / secs, "tokens/s"),
                  "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    window_losses = [float(x) for x in prog.losses]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.time()
    ref = reference(cell, seed, device)
    t_ref = time.time() - t
    failed = sum(not math.isfinite(x) for x in window_losses)
    found = gaps(readings, ref)
    checks, within = verdict(found, cell.limits)
    correct = failed == 0 and within
    result = {"correct": correct, "attempted": len(window_losses),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": peak, **extra}}
    if trace_on:
        result["breakdown"] = breakdown
    result["checks"] = checks
    if cuda:
        print(f"card: {_power_limit()} (peaks at 700 W: bf16 "
              f"{peaks.BF16_DENSE_FLOPS:.4g} FLOP/s, HBM "
              f"{peaks.HBM_BYTES_PER_S:.4g} B/s)", file=sys.stderr)
    print(f"set-up: {t_start - t0:.3f} s to start, {t_build:.3f} s to build, "
          f"{t_first:.3f} s of checked steps; reference {t_ref:.3f} s; losses: "
          f"program {readings.losses}, reference {ref.losses}",
          file=sys.stderr)
    print("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in found.items() if k not in checks),
        file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return result
