"""adamw_ms (ms): device time a step of the optimizer commit: the port's
fused AdamW kernels (``csrc/fused_adamw.cu``, CUDA kernels named
``adamw_kernel``), one a parameter leaf.  Nothing where the trace holds
none."""

KERNEL = "adamw_kernel"


def read(run):
    s = run.kernel_s(KERNEL)
    if s <= 0.0:
        return None
    return 1e3 * s / run.steps
