"""Reading a ``torch.profiler`` trace of the requests a traced run profiles.

``run.py`` profiles a few requests after its measured window (CPU and CUDA
activity, the stage spans of ``spans.json`` as ``record_function`` ranges,
one ``ProfilerStep`` a request after a warm-up step) and exports the
chrome trace.  From it this module takes:

* the traced window: the first step's start to the last step's end (each
  request ends in a synchronise, so its device work lies inside its step);
* every device operation (a kernel, a copy or a memset) inside the window,
  and the union of their intervals, the device's busy time;
* each device operation's stage: the stage span that holds the host call
  that launched it (the runtime call of the same correlation id);
* the idle gaps: the stretches of the window in which no device operation
  runs, each named by the stage span the host was in at the gap's start
  (``outside stages``: the upload, the fetch, the wait, the loop).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
OUTSIDE = "outside stages"


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Spans:
    """Non-nested host spans, found by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return OUTSIDE


def read(path: str, span_names) -> dict:
    """The trace's numbers (seconds; the window's device operations):
    ``window_s``, ``busy_s``, ``device_ops``, ``steps``, ``stage_device_s``
    (device seconds by stage), ``op_device_s`` (device seconds by operation
    name) and ``idle_by_host`` (idle seconds by the host's stage)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span_names = set(span_names)
    steps, stage_spans, device, launch_ts = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, (ev.get("args") or {}).get("correlation")))
        elif cat in HOST_LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        elif cat.startswith("gpu_"):  # a span's projection onto the device's timeline
            continue
        elif name.startswith("ProfilerStep#"):
            steps.append((ts, ts + dur))
        elif name in span_names:
            stage_spans.append((ts, ts + dur, name))
    if not steps:
        raise ValueError(f"{path}: no ProfilerStep span")
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    device = [d for d in device if d[0] >= w0 and d[1] <= w1]
    busy = _union((s, e) for s, e, _, _ in device)
    host = Spans(stage_spans)

    stage_device = defaultdict(float)
    op_device = defaultdict(float)
    for s, e, name, corr in device:
        t = launch_ts.get(corr)
        stage_device[OUTSIDE if t is None else host.at(t)] += (e - s) * 1e-6
        op_device[name] += (e - s) * 1e-6

    idle_by_host = defaultdict(float)
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            idle_by_host[host.at(edge)] += (s - edge) * 1e-6
        edge = max(edge, e)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": len(device),
        "steps": len(steps),
        "stage_device_s": dict(stage_device),
        "op_device_s": dict(op_device),
        "idle_by_host": dict(idle_by_host),
    }


def top(by_name: dict, n: int = 10, width: int = 120) -> list:
    """The ``n`` largest ``[name, seconds]``, largest first, each name cut
    to ``width`` characters (a templated kernel's name runs to hundreds)."""
    return [[k[:width], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]
