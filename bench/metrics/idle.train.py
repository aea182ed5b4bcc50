"""idle.train: share of the traced window in which no operation runs on
the device: one less the union of the kernel, copy and fill intervals
(not their sum) over the window."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
