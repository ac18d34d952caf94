"""The program's own count of device-to-host reads a call
(``PipelineResult.host_syncs``), averaged over the window's requests."""


def read(run):
    return sum(run.host_syncs) / run.requests
