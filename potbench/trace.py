"""The traced window: a few whole steps under ``torch.profiler``, and
what the per-layer readers and the ``breakdown`` read from it.

The benchmark records two spans of its own, ``potbench.window`` around
the traced steps (closed after ``torch.cuda.synchronize()``) and
``potbench.step`` around each step.  The window's length is the
``potbench.window`` span's; device activity is every kernel, copy and
fill on the card, clipped to the window; ``busy_s`` is the length of
their union, and every gap in it is named by the innermost host
operation that covers its middle."""

from __future__ import annotations

import bisect
import dataclasses

import torch

WINDOW, STEP = "potbench.window", "potbench.step"
TOP = 10           # entries of each list of the breakdown
NAME_CHARS = 120   # of a kernel's name in the breakdown


@dataclasses.dataclass
class TraceRun:
    """What a per-layer reader gets (``metrics/<name>.py``)."""
    kernels: list      # (name, start s, end s) from the window's start
    host_ops: list     # (name, start s, end s), sorted by start
    window_s: float
    busy_s: float
    steps: int
    config: dict       # the configuration's file
    traffic: dict      # the traffic's file

    def kernel_s(self, part: str) -> float:
        """Seconds of the kernels whose name holds ``part``."""
        return sum(e - s for n, s, e in self.kernels if part in n)

    def kernel_names(self, part: str) -> list[str]:
        return sorted({n for n, _, _ in self.kernels if part in n})


def union(spans) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def run_traced(step_once, n_steps: int, device: torch.device, out_path,
               config: dict, traffic: dict) -> TraceRun:
    """Trace ``n_steps`` calls of ``step_once()`` and write the Chrome
    trace to ``out_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n_steps):
                with record_function(STEP):
                    step_once()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    events = prof.events()
    span = [e for e in events if e.name == WINDOW
            and e.device_type == DeviceType.CPU]
    if not span:
        raise RuntimeError("the trace holds no potbench.window span")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    kernels, host = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        item = (e.name, (s - w0) * 1e-6, (t - w0) * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("potbench.")):
                kernels.append(item)
        elif e.device_type == DeviceType.CPU and e.name != WINDOW:
            host.append(item)
    host.sort(key=lambda x: x[1])
    busy = sum(e - s for s, e in union((s, e) for _, s, e in kernels))
    return TraceRun(kernels=kernels, host_ops=host,
                    window_s=(w1 - w0) * 1e-6, busy_s=busy, steps=n_steps,
                    config=config, traffic=traffic)


def _innermost(host: list, starts: list, t: float) -> str:
    """The host operation covering time ``t`` that began last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 5000), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "(no host operation)"


def breakdown(run: TraceRun) -> dict:
    """The device operations that took most time, and the idle time of
    the device by what the host was doing, in seconds of the window."""
    ops: dict[str, float] = {}
    for n, s, e in run.kernels:
        ops[n[:NAME_CHARS]] = ops.get(n[:NAME_CHARS], 0.0) + (e - s)
    gaps, t = [], 0.0
    for s, e in union((s, e) for _, s, e in run.kernels):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < run.window_s:
        gaps.append((t, run.window_s))
    starts = [s for _, s, _ in run.host_ops]
    idle: dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:1000]:
        name = _innermost(run.host_ops, starts, (s + e) / 2)
        idle[name] = idle.get(name, 0.0) + (e - s)
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
