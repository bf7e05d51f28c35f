"""train_mfu (%): the whole pot step's model FLOPs (``yardstick/flops``)
over the traced step time, as a share of the H100's published bf16
dense peak.  Nothing without device activity in the trace."""

from potbench.yardstick import flops, peaks


def read(run):
    if not run.kernels:
        return None
    tr = run.traffic
    per_step = flops.model_flops_per_token(run.config["port"],
                                           tr["seq_len"]) \
        * tr["global_batch"] * tr["seq_len"]
    rate = per_step * run.steps / run.window_s
    return 100.0 * rate / peaks.BF16_DENSE_FLOPS
