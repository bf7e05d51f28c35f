"""mlp_ms (ms): device time a step of the dense MLP, the ``pot.mlp`` span
(``blocks.mlp_apply``): every kernel whose span path holds it, forward,
remat's recompute and backward (``potbench/spans.py``).  Nothing without
device events or without the span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.mlp")
