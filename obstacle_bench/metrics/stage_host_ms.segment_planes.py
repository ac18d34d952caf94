"""Host time a request inside RANSAC's stage span (``segment_planes``), in
ms, over the measured window of a traced run."""


def read(run):
    if "segment_planes" not in run.span_host_s:
        return None
    return 1e3 * run.span_host_s["segment_planes"] / run.requests
