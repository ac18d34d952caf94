"""Scans completed in the measured window over its wall time (a fullscale
window is one scan)."""


def read(run):
    return run.requests * run.batch / run.window_s
