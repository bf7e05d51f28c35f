"""fill_ms (ms): device time a step of the fill kernels (CUDA kernels
named ``FillFunctor``): the fills of fresh outputs under deterministic
mode, and the zeroing of buffers.  0 where the traced steps ran none;
nothing without device activity in the trace."""

FILL = "FillFunctor"


def read(run):
    if not run.kernels:
        return None
    return 1e3 * run.kernel_s(FILL) / run.steps
