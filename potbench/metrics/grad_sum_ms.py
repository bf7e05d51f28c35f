"""grad_sum_ms (ms): device time a step of the ordered commit of the
microbatch transactions, the ``pot.grad_sum`` spans
(``train_step._accumulate``: the zeroed float32 sums, each microbatch's
fixed-order adds, the division): every kernel whose span path holds them
(``potbench/spans.py``).  Nothing without device events or without the
span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.grad_sum")
