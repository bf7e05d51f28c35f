"""adamw_roofline (%): the least time the commit's bytes take at the
H100's published HBM rate (``yardstick/adamw``: 28 B an element with a
float32 gradient, 26 B with a bf16 one, over every parameter element of
the configuration), over the device time of the fused AdamW kernels a
step.  The gradient's type is read from the kernels' names (the
template argument).  Nothing where the trace holds none of them."""

from potbench.yardstick import adamw, peaks

KERNEL = "adamw_kernel"


def read(run):
    s = run.kernel_s(KERNEL)
    if s <= 0.0:
        return None
    bf16 = all("bfloat16" in n for n in run.kernel_names(KERNEL))
    need = adamw.param_elements(run.config["port"]) \
        * adamw.bytes_per_element(2 if bf16 else 4)
    return 100.0 * (need / peaks.HBM_BYTES_PER_S) / (s / run.steps)
