"""Reading the program's own spans in a ``torch.profiler`` trace.

While the program's tracing is on (``utils.timing.tracing``) and a profiler
records, each of the port's spans lies in the chrome trace as a
``record_function`` range named ``pcp.*``, on the profiler's clock:
``pcp.call`` (a pipeline call), ``pcp.stage.<stage>``,
``pcp.kernel.<kernel>`` (a kernel wrapper) and ``pcp.host_read`` (a
device-to-host read).  From the trace ``trace.py`` reads (the same window
and the same union of device intervals) this module takes:

* each idle gap of the window, named by the innermost ``pcp.*`` span open
  on the host at the gap's start (``outside``: none open);
* the device time of every operation, named by the innermost ``pcp.*``
  span open at its runtime launch;
* the idle split three ways, as shares of the window: ``host_read`` (the
  host in ``pcp.host_read``), ``issue`` (inside a ``pcp.call`` and in no
  read: the host issuing) and ``outside`` (in no ``pcp.call``: the caller's
  upload, fetch and loop); the three sum to ``trace.py``'s idle share.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .trace import DEVICE_CATS, HOST_LAUNCH_CATS

PREFIX = "pcp."
CALL = "pcp.call"
HOST_READ = "pcp.host_read"
OUTSIDE = "outside"


def union(intervals):
    """Merged ``[start, end)`` intervals, sorted (the device's busy time,
    as ``trace.py`` merges it)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Nested:
    """Nested host spans, found by time: the innermost open at ``t``."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (start, end, name)
        self.starts = [s for s, _, _ in self.spans]

    def open_at(self, t: float) -> list:
        """The names of the spans open at ``t``, innermost first."""
        out = []
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s, e, name = self.spans[i]
            if e >= t:
                out.append(name)
        return out


def read(path: str) -> dict:
    """The trace's numbers (seconds; the window's device operations):
    ``window_s``, ``busy_s``, ``idle_by_span`` and ``device_by_span``
    (by innermost ``pcp.*`` span), ``idle_split_s`` (``host_read``,
    ``issue``, ``outside``) and ``idle_pct`` (the same as shares of the
    window)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps, spans, device, launches = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, corr))
        elif cat in HOST_LAUNCH_CATS:
            if corr is not None:
                launches[corr] = ts
        elif cat.startswith("gpu_"):  # a span's projection onto the device's timeline
            continue
        elif name.startswith("ProfilerStep#"):
            steps.append((ts, ts + dur))
        elif name.startswith(PREFIX):
            spans.append((ts, ts + dur, name))
    if not steps:
        raise ValueError(f"{path}: no ProfilerStep span")
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    host = Nested(spans)

    def innermost(t):
        names = host.open_at(t)
        return names[0] if names else OUTSIDE

    def kind(t):
        names = host.open_at(t)
        if names and names[0] == HOST_READ:
            return "host_read"
        return "issue" if CALL in names else "outside"

    device = [d for d in device if d[0] >= w0 and d[1] <= w1]
    busy = union((s, e) for s, e, _, _ in device)
    device_by_span = defaultdict(float)
    for s, e, _, corr in device:
        t = launches.get(corr)
        device_by_span[OUTSIDE if t is None else innermost(t)] += (e - s) * 1e-6
    idle_by_span = defaultdict(float)
    idle_split = {"host_read": 0.0, "issue": 0.0, "outside": 0.0}
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            idle_by_span[innermost(edge)] += (s - edge) * 1e-6
            idle_split[kind(edge)] += (s - edge) * 1e-6
        edge = max(edge, e)

    window_s = (w1 - w0) * 1e-6
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "idle_by_span": dict(idle_by_span),
        "device_by_span": dict(device_by_span),
        "idle_split_s": idle_split,
        "idle_pct": {k: 100.0 * v / window_s for k, v in idle_split.items()},
    }
