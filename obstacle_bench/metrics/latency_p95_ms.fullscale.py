"""The 95th percentile over every request of the measured window, each
timed from the upload of its clouds to its outputs on the host, in the
fullscale cell whose card is busy most of the window: the same reading as
``latency_p95_ms``, held to a bound set from that cell's own spread."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
