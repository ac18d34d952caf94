"""Host time inside the entry call until it returns, a request, in ms (in
the fullscale configuration it holds the banded sweep's host reads)."""


def read(run):
    return 1e3 * sum(run.issues) / run.requests
