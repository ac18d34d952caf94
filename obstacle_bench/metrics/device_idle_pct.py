"""The share of the traced window in which no device operation runs: the
union of the trace's device intervals against the window's wall time."""


def read(run):
    if not run.trace or not run.trace["device_ops"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
