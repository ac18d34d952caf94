"""Device operations (kernels, copies, memsets) a request, from the
profiler's trace of the traced requests."""


def read(run):
    if not run.trace or not run.trace["device_ops"]:
        return None
    return run.trace["device_ops"] / run.trace_requests
