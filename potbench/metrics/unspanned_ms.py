"""unspanned_ms (ms): device time a step of the kernels that no program
span owns (``potbench/spans.py``): the norms, residual adds and the
embedding, forward and backward.  Nothing without device events or
without program spans in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else 1e3 * owned.unspanned_s() / run.steps
