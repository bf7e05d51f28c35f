"""The program's spans in a traced window: which ``pot.*`` spans own each
device kernel, read from the Chrome trace that ``trace.run_traced``
writes (``out/<cell>.trace.json``).

A kernel's owner is its **span path**: the ``pot.*`` spans
(``repro_torch.runtime.spans``) over the host call that launched it,
outermost first, and whether it is backward:

- Walk up from the launch (the ``cuda_runtime`` or ``cuda_driver`` event
  of the kernel's ``correlation``) through the host events that enclose
  it on its thread, collecting ``pot.*`` names, up to the first
  autograd node (``autograd::engine::evaluate_function: ...``) or the
  thread's outermost event.
- Names collected are the path: forward code, or remat's recompute,
  which runs inside a backward node.
- None collected, stopped at an autograd node with no forward operation
  on the way (one that records a sequence number for a node it makes,
  as the recompute's do and the backward formulas' do not): the kernel
  is backward, and its path is that of the forward operation that made
  the node.  The profiler links the two (its ``fwdbwd`` flow, which it
  draws from the node's forward thread and sequence number).
- Otherwise the path is empty and the kernel forward, ``((), False)``:
  no span owns it, in the forward pass or remat's recompute.

The whole path is kept because spans nest (a MoE layer's shared experts
are ``pot.mlp`` inside ``pot.moe``).  A trace without ``pot.*`` spans
(a program that has none) gives no :class:`Spans`, so every reader of
them returns None there, as on a CPU run without kernels.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

from potbench import spec

OUT = spec.HERE / "out"
PREFIX = "pot."
NODE = "autograd::engine::evaluate_function: "
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH = ("cuda_runtime", "cuda_driver")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "potbench.window"


def _ns(us: float) -> int:
    return round(us * 1000)


def _forward_op(e: dict) -> bool:
    """An operation run with autograd recording: it holds the sequence
    number of a node it makes, and no forward thread of its own."""
    args = e.get("args", {})
    return "Sequence number" in args and not args.get("Fwd thread id")


class HostTree:
    """The host events of a Chrome trace nested by time on each thread,
    and the profiler's links from autograd nodes to forward operations."""

    def __init__(self, events: list):
        self.parent: dict[int, int] = {}      # index -> enclosing index
        self.start: dict[tuple, list] = {}    # (pid, tid, ts) -> indices
        self.events = events
        by_thread: dict[tuple, list] = {}
        for i, e in enumerate(events):
            if e.get("ph") == "X" and e.get("cat") in HOST:
                by_thread.setdefault((e["pid"], e["tid"]), []).append(i)
        for key, idx in by_thread.items():
            idx.sort(key=lambda i: (_ns(events[i]["ts"]),
                                    -_ns(events[i]["dur"])))
            stack: list[tuple[int, int]] = []      # (index, end ns)
            for i in idx:
                s = _ns(events[i]["ts"])
                end = s + _ns(events[i]["dur"])
                while stack and (s >= stack[-1][1] or end > stack[-1][1]):
                    stack.pop()
                if stack:
                    self.parent[i] = stack[-1][0]
                stack.append((i, end))
                self.start.setdefault((*key, events[i]["ts"]), []).append(i)
        self.forward: dict[int, int] = {}     # node index -> forward index
        flows: dict[int, dict] = {}
        for e in events:
            if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
                flows.setdefault(e["id"], {})[e["ph"]] = e
        for f in flows.values():
            if "s" in f and "f" in f:
                fwd, node = self._at(f["s"]), self._node(self._at(f["f"]))
                if fwd is not None and node is not None:
                    self.forward[node] = fwd

    def _at(self, e) -> int | None:
        """The innermost host event starting at a flow's end point."""
        found = self.start.get((e["pid"], e["tid"], e["ts"]))
        return found[-1] if found else None

    def _node(self, i: int | None) -> int | None:
        """The autograd node event at or over event ``i``."""
        while i is not None and not self.events[i]["name"].startswith(NODE):
            i = self.parent.get(i)
        return i

    def owner(self, i: int) -> tuple[tuple[str, ...], bool]:
        """(span path, backward) of host event ``i`` (module docstring)."""
        names, forward = [], False
        while i is not None:
            e = self.events[i]
            if e["name"].startswith(NODE):
                break
            if e["name"].startswith(PREFIX):
                names.append(e["name"])
            forward = forward or _forward_op(e)
            i = self.parent.get(i)
        if names or forward or i is None:
            return tuple(reversed(names)), False
        fwd = self.forward.get(i)
        if fwd is None:
            return (), True
        return self.owner(fwd)[0], True


@dataclasses.dataclass
class Spans:
    """The device events of a traced window, each with its owner."""
    owned: list    # (span path, backward, seconds in the window)
    steps: int

    def seconds(self, *names: str) -> float:
        """Seconds of the device events whose path holds any of
        ``names`` (any element of it, not only the innermost), forward
        and backward alike."""
        return sum(s for path, _, s in self.owned
                   if any(n in path for n in names))

    def ms(self, *names: str) -> float | None:
        """ms a step of :meth:`seconds`, None where those spans own no
        device time."""
        s = self.seconds(*names)
        return 1e3 * s / self.steps if s > 0 else None

    def unspanned_s(self) -> float:
        """Seconds of the device events that no span owns."""
        return sum(s for path, _, s in self.owned if not path)


def read_trace(events: list, steps: int) -> Spans | None:
    """Each device event of the ``potbench.window`` span, clipped to it,
    with its owner; None where the trace holds no ``pot.*`` span."""
    if not any(e.get("name", "").startswith(PREFIX) and
               e.get("cat") == "user_annotation" for e in events):
        return None
    window = next(e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation")
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    tree = HostTree(events)
    launch = {e["args"]["correlation"]: i for i, e in enumerate(events)
              if e.get("cat") in LAUNCH and "correlation" in e.get("args", {})}
    owned = []
    for e in events:
        if e.get("cat") not in DEVICE:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        i = launch.get(e.get("args", {}).get("correlation"))
        path, bwd = ((), False) if i is None else tree.owner(i)
        owned.append((path, bwd, (t - s) * 1e-6))
    return Spans(owned, steps)


def cell_name(config: dict, traffic: dict) -> str | None:
    """The cell of ``BENCHMARK.json`` that runs this configuration under
    this traffic mix."""
    bench = spec.read_json(spec.HERE.parent / "BENCHMARK.json")
    for w in bench["workloads"]:
        if (w["config"], w["traffic"]) == (config.get("name"),
                                           traffic.get("name")):
            return w["name"]
    return None


@functools.lru_cache(maxsize=1)
def _load(path: str, stamp: tuple, steps: int):
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    window = [e["dur"] * 1e-6 for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    return window[0] if window else None, read_trace(events, steps)


def of(run) -> Spans | None:
    """The owners of ``run``'s device events (a ``trace.TraceRun``), from
    the Chrome trace its traced window wrote; None without device
    events, without a trace of that window, or without program spans.
    The last trace read stays in memory for the next reader."""
    name = cell_name(run.config, run.traffic)
    if not run.kernels or name is None:
        return None
    path = Path(OUT) / f"{name}.trace.json"
    if not path.is_file():
        return None
    st = path.stat()
    window_s, spans = _load(str(path), (st.st_mtime_ns, st.st_size),
                            run.steps)
    # the same window as the run's (not a trace another run left)
    if window_s is None or abs(window_s - run.window_s) > 1e-5:
        return None
    return spans
