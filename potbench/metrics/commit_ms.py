"""commit_ms (ms): device time a step of the optimizer commit, the
``pot.commit`` span (the fused AdamW launches, one a leaf, and the
wrapper's fills): every kernel whose span path holds it
(``potbench/spans.py``).  Nothing without device events or without the
span in the trace."""

from potbench import spans


def read(run):
    owned = spans.of(run)
    return None if owned is None else owned.ms("pot.commit")
