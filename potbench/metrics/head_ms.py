"""head_ms (ms): device time a step of the head and the loss, the
``pot.logits`` span (``lm._logits``: the final norm and the head's
product) and the ``pot.loss`` span (``train_step.loss_fn`` from the
logits' cast to float32 to the mean): every kernel whose span path holds
either, forward, remat's recompute and backward (``potbench/spans.py``).
Nothing without device events or without the spans in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.logits", "pot.loss")
