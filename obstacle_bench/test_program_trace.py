"""The reader of the program's ``pcp.*`` spans in a profiler trace
(``program_trace.py``), on a small synthetic trace.

    python -m pytest obstacle_bench -q
"""

import json

import pytest

from obstacle_bench import program_trace, trace


def _synthetic_trace(path):
    """A profiled window of 100 us: a call [5, 90] holding stage a [10, 40]
    (a host read [20, 30] inside it) and stage b [45, 80] (a kernel span
    [50, 55] inside it); device operations launched at 12, 52 and 85 run
    [12, 18], [56, 60] and [86, 95]."""
    def x(name, ts, dur, cat="user_annotation", **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [
        x("ProfilerStep#1", 0, 100), x("pcp.call", 5, 85), x("pcp.stage.a", 10, 30),
        x("pcp.host_read", 20, 10), x("pcp.stage.b", 45, 35), x("pcp.kernel.k", 50, 5),
        x("cudaLaunchKernel", 12, 1, "cuda_runtime", correlation=1),
        x("cudaLaunchKernel", 52, 1, "cuda_runtime", correlation=2),
        x("cudaLaunchKernel", 85, 1, "cuda_runtime", correlation=3),
        x("kernel_one", 12, 6, "kernel", correlation=1),
        x("k_kernel", 56, 4, "kernel", correlation=2),
        x("memcpy", 86, 9, "gpu_memcpy", correlation=3),
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_program_trace_names_each_gap_by_the_innermost_span(tmp_path):
    path = _synthetic_trace(tmp_path / "trace.json")
    r = program_trace.read(path)
    # gaps: [0, 12) outside; [18, 56) opened in stage a at 18; [60, 86) in
    # stage b at 60; [95, 100) outside
    assert r["idle_by_span"] == pytest.approx({"outside": 17e-6, "pcp.stage.a": 38e-6,
                                               "pcp.stage.b": 26e-6})
    assert r["device_by_span"] == pytest.approx({"pcp.stage.a": 6e-6, "pcp.kernel.k": 4e-6,
                                                 "pcp.call": 9e-6})
    # a gap that opens inside the read: the host waits on the card
    events = json.load(open(path))
    events["traceEvents"][9]["dur"] = 10  # the first operation runs [12, 22)
    (tmp_path / "read.json").write_text(json.dumps(events))
    r = program_trace.read(str(tmp_path / "read.json"))
    assert r["idle_split_s"] == pytest.approx({"host_read": 34e-6, "issue": 26e-6,
                                               "outside": 17e-6})
    whole = trace.read(str(tmp_path / "read.json"), [])
    device_idle_pct = 100.0 * (1.0 - whole["busy_s"] / whole["window_s"])
    assert sum(r["idle_pct"].values()) == pytest.approx(device_idle_pct, abs=1e-9)
    assert r["idle_pct"]["host_read"] == pytest.approx(34.0)
    assert r["busy_s"] == pytest.approx(whole["busy_s"])
