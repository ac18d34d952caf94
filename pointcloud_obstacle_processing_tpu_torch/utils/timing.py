"""Spans and counters inside the port, and the reference's stage table.

Counterpart of ``pointcloud_obstacle_processing_tpu/utils/timing.py``.  The
reference node brackets every stage with ``std::chrono`` and logs seconds +
percent-of-total each cycle (obstacle_detection.cpp:872-925).  Here the
program marks its own layer boundaries with spans:

* ``pcp.call``: one ``pipeline.process_scan`` or
  ``parallel.sharding.process_scan_point_sharded`` call, the root, which
  carries the request id;
* ``pcp.stage.<stage>``: each of the nine stages of the call;
* ``pcp.kernel.<kernel>``: a kernel wrapper from its entry to its launch's
  return (``_build.launch``), counting ``launches``;
* ``pcp.host_read``: a device-to-host read on the card path, counting
  ``host_reads``.

Tracing is off by default and is a switch of the process
(``tracing(True)``).  Off, ``span`` returns one shared context that does
nothing.  On, a span records its name, its start and end on
``time.perf_counter_ns``, its parent and the request id of its root in a
bounded buffer, one span stack a thread (the node's async mode runs the
pipeline on its dispatch thread); a span's counter adds one to the span
and to every span open around it on its thread.  ``take()`` returns what
was recorded and clears it.  A span its thread closes inside a
``collect()`` block goes to that block's list instead, and not to the
buffer, so a reader that collects (the node) leaves nothing behind.
While a ``torch.profiler`` session records, each span also opens a
``torch.profiler.record_function`` range of its name, so the spans lie in
the profiler's trace beside the CUDA runtime calls and device operations,
on its clock.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from types import MappingProxyType

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["tracing", "is_tracing", "span", "host_read", "current", "collect", "take", "totals",
           "OFF", "Span", "Record", "Totals", "StageTimer", "profile_trace", "CAPACITY"]

CAPACITY = 1 << 19  # spans held between two takes; later ones are counted as dropped

_on = False
_lock = threading.Lock()
_spans: list = []
_dropped = 0
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans; .sinks: its collect() lists
_NO_COUNTS = MappingProxyType({})


def tracing(on: bool) -> bool:
    """Turn the program's tracing on or off for the whole process; returns
    the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def is_tracing() -> bool:
    """Whether the program's tracing is on."""
    return _on


class _Off:
    """The context ``span`` returns while tracing is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One span: while open, the context; once closed, its record.
    ``start_ns``/``end_ns`` on ``time.perf_counter_ns``; ``parent`` the
    enclosing span's ``id`` (0 for a root); ``request`` the root's id;
    ``thread`` its thread's ident; ``counts`` the counters of this span and
    of every span inside it (a read-only empty mapping where none counted)."""

    __slots__ = ("name", "count", "id", "parent", "request", "thread", "start_ns", "end_ns",
                 "counts", "_range")

    def __init__(self, name: str, count: str | None = None):
        self.name = name
        self.count = count
        self.counts = _NO_COUNTS

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.request, self.thread = top.id, top.request, top.thread
        else:
            self.parent, self.request, self.thread = 0, next(_requests), threading.get_ident()
        stack.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:  # a flag, not a dispatcher call
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        stack = _local.stack
        stack.pop()
        if self.count is not None and exc_type is None:
            key = self.count
            for s in (*stack, self):
                if s.counts is _NO_COUNTS:
                    s.counts = {}
                s.counts[key] = s.counts.get(key, 0) + 1
        sinks = getattr(_local, "sinks", None)
        if sinks:
            for sink in sinks:
                sink.append(self)
            return False
        with _lock:
            if len(_spans) < CAPACITY:
                _spans.append(self)
            else:
                _dropped += 1
        return False


def span(name: str, count: str | None = None):
    """A span of ``name`` around a ``with`` block; ``count`` names a counter
    the span adds one to (on itself and every span around it) when its
    block ends without an exception.  While tracing is off: ``OFF``."""
    if not _on:
        return OFF
    return Span(name, count)


def host_read():
    """The span around a device-to-host read on the card path, counting
    ``host_reads``."""
    if not _on:
        return OFF
    return Span("pcp.host_read", "host_reads")


def current() -> str | None:
    """The name of this thread's innermost open span, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].name if stack else None


class collect:
    """Collects the spans this thread closes inside the ``with`` block into
    a list (the ``as`` target, and that of every ``collect`` block open
    around it) instead of the buffer ``take`` empties; the list is the
    caller's to keep or drop."""

    def __enter__(self) -> list:
        self.spans = []
        if not hasattr(_local, "sinks"):
            _local.sinks = []
        _local.sinks.append(self.spans)
        return self.spans

    def __exit__(self, *exc):
        _local.sinks.pop()  # a thread's blocks nest: this block's list is the last
        return False


@dataclass(frozen=True)
class Totals:
    """A span name's spans: ``seconds`` inside them, ``self_seconds`` of
    that in none of their children, how many closed, and their counters."""

    seconds: float
    self_seconds: float
    count: int
    counts: dict


def totals(spans) -> dict:
    """``{name: Totals}`` over ``spans`` (a child missing from ``spans``
    counts as the parent's own time)."""
    spans = list(spans)
    child_ns = defaultdict(int)
    for s in spans:
        if s.parent:
            child_ns[s.parent] += s.end_ns - s.start_ns
    acc = defaultdict(lambda: [0, 0, 0, defaultdict(int)])
    for s in spans:
        a = acc[s.name]
        dur = s.end_ns - s.start_ns
        a[0] += dur
        a[1] += dur - child_ns.get(s.id, 0)
        a[2] += 1
        for k, v in s.counts.items():
            a[3][k] += v
    return {name: Totals(a[0] * 1e-9, a[1] * 1e-9, a[2], dict(a[3])) for name, a in acc.items()}


@dataclass(frozen=True)
class Record:
    """What ``take`` returns: the closed spans in the order they closed, and
    how many the full buffer dropped."""

    spans: list
    dropped: int

    def totals(self) -> dict:
        return totals(self.spans)


def take() -> Record:
    """The spans recorded since the last take (every thread's), and clear
    them."""
    global _spans, _dropped
    with _lock:
        out = Record(_spans, _dropped)
        _spans, _dropped = [], 0
    return out


def profile_trace(fn, *args, trace_dir: str | None = None) -> str:
    """Capture a ``torch.profiler`` trace of one ``fn(*args)`` call (the
    host's operators, the program's spans and, on the card, its kernels,
    memsets and copies) as a Chrome trace in ``trace_dir`` (a new temporary
    directory by default); returns the trace file's path.  The program's
    tracing is on for the call (its spans stay for ``take``).  View it in
    Perfetto or ``chrome://tracing``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="pcp_torch_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    was = tracing(True)
    try:
        with profile(activities=activities) as prof:
            fn(*args)
            if cuda:
                torch.cuda.synchronize()
    finally:
        tracing(was)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@dataclass
class StageTimer:
    """Collects named stage timings and renders the reference's table."""

    stages: dict = field(default_factory=dict)
    clamped: set = field(default_factory=set)

    def record(self, name: str, seconds: float, clamped: bool = False) -> None:
        """``clamped``: the measurement protocol clamped a non-positive
        marginal to zero — the stage is BELOW the measurement noise floor,
        not free.  The table prints it as ``<noise`` instead of a
        misleading 0.000000."""
        self.stages[name] = seconds
        if clamped:
            self.clamped.add(name)

    def table(self) -> str:
        """Seconds + percent per stage, like obstacle_detection.cpp:913-925."""
        total = sum(self.stages.values())
        lines = [f"{'-'*19}TOTAL TIME: {total:.6f} seconds"]
        width = max((len(k) for k in self.stages), default=10)
        for name, t in self.stages.items():
            if name in self.clamped:
                lines.append(
                    f"{name.rjust(width)}: <noise (marginal below the "
                    f"measurement floor; not free)"
                )
                continue
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"{name.rjust(width)}: {t:.6f} seconds ({pct:.3f}) percent")
        return "\n".join(lines)
