"""device_idle (%): the traced window less the union of the device's
kernel, copy and fill intervals, over the traced window.  Nothing
without device activity in the trace."""


def read(run):
    if not run.kernels:
        return None
    return 100.0 * (run.window_s - run.busy_s) / run.window_s
