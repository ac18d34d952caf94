"""Per-stage timing harness.

Counterpart of ``pointcloud_obstacle_processing_tpu/utils/timing.py``.  The
reference node brackets every stage with ``std::chrono`` and logs seconds +
percent-of-total each cycle (obstacle_detection.cpp:872-925).  Here a stage
is timed by calling its function on the intermediate data of a real run:
on the card between two ``torch.cuda.Event``s (device time, the stream's
own clock), on the CPU with ``time.perf_counter``.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

__all__ = ["StageTimer", "time_fn", "profile_trace"]


def _first_tensor(out):
    """The first tensor in a (nested) result, or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "__dataclass_fields__"):
        out = [getattr(out, f) for f in out.__dataclass_fields__]
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _on_cuda(args) -> bool:
    return any(t is not None and t.is_cuda for t in map(_first_tensor, args))


def time_fn(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds of ``fn(*args)``.  With a CUDA tensor among the
    arguments each call is timed between two CUDA events on the current
    stream (the call's device time, host gaps inside it included), else on
    the host's clock."""
    cuda = _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def profile_trace(fn, *args, trace_dir: str | None = None) -> str:
    """Capture a ``torch.profiler`` trace of one ``fn(*args)`` call (the
    host's operators and, on the card, its kernels, memsets and copies) as
    a Chrome trace in ``trace_dir`` (a new temporary directory by default);
    returns the trace file's path.  View it in Perfetto or
    ``chrome://tracing``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = _on_cuda(args)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="pcp_torch_trace_")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        fn(*args)
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@dataclass
class StageTimer:
    """Collects named stage timings and renders the reference's table."""

    stages: dict = field(default_factory=dict)
    clamped: set = field(default_factory=set)

    def measure(self, name: str, fn, *args, iters: int = 10) -> float:
        t = time_fn(fn, *args, iters=iters)
        self.stages[name] = t
        return t

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
