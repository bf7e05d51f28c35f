"""moe_ms (ms): device time a step of the MoE layer, the ``pot.moe`` span
(``moe.moe_apply``: route, dispatch, experts, combine, and the shared
experts, ``pot.mlp`` inside it): every kernel whose span path holds it,
forward, remat's recompute and backward (``potbench/spans.py``).
Nothing without device events or without the span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.moe")
