"""moe_dispatch_ms (ms): device time a step of the MoE dispatch, the
``pot.moe.dispatch`` span (``moe.dispatch_positions`` and
``moe.dispatch``: each assignment's slot, the positions' scan, and the
gather into the experts' slots): every kernel whose span path holds it,
forward, remat's recompute and backward (``potbench/spans.py``).
Nothing without device events or without the span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.moe.dispatch")
