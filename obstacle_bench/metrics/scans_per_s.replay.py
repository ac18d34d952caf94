"""Scans completed in the measured window over its wall time, in a cell
whose card is busy through the window (the offline replay): the same
reading as ``scans_per_s``, held to a bound set from that cell's own
spread."""


def read(run):
    return run.requests * run.batch / run.window_s
