"""The 95th percentile over every request of the measured window, each
timed from the upload of its clouds to its outputs on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
