"""attn_ms (ms): device time a step of attention, the ``pot.attn`` span
(``blocks.attn_apply``: projections, RoPE, scores, softmax, the output
projection): every kernel whose span path holds it, forward, remat's
recompute and backward (``potbench/spans.py``).  Nothing without device
events or without the span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.attn")
