"""The program's spans and counters (``utils.timing``): off, a call records
nothing; on, a call is one ``pcp.call`` holding the nine stage spans in the
reference's order under one request id, each thread keeps its own stack,
the ``pcp.host_read`` count equals ``PipelineResult.host_syncs``, a kernel
wrapper's ``launch`` counts ``LAUNCHES`` and its span, and the node adds a
cycle's host seconds by stage to its ``metrics`` entry, leaving nothing in
the buffer.  On the card
(marked ``cuda``, skipped where there is none): every ``pcp.kernel.<name>``
span of a profiled batch holds the runtime launch of that wrapper's kernel,
and every synchronising call of a flagship and a banded batch lies inside
a ``pcp.host_read`` span:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q

This file imports no JAX.
"""

from __future__ import annotations

import json
import logging
import threading
import traceback
import warnings
from collections import defaultdict

import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu_torch import _build
from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG
from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
from pointcloud_obstacle_processing_tpu_torch.runtime import launch as node_launch
from pointcloud_obstacle_processing_tpu_torch.types import Cloud
from pointcloud_obstacle_processing_tpu_torch.utils import timing
from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

# the reference node's stage order (obstacle_detection.cpp:699-927)
STAGES = ("crop_and_seed", "voxel_downsample", "remove_statistical_outliers", "segment_planes",
          "compact", "euclidean_cluster", "cluster_centroids", "cast_shadows", "mark_obstacles")

# a small banded configuration: a 256-column cluster band over 1,024 slots
CFG = REFERENCE_YAML_CONFIG.replace(
    max_points=8192, max_voxels=2048, cluster_capacity=1024, max_clusters=8,
    downsample_leaf_size=0.1, knn_row_tile=128, knn_band=192, cluster_band_window=256,
)
SPEC = SceneSpec(n_ground=6000, n_rocks=2, points_per_rock=400, n_noise=80)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and the buffer empty."""
    timing.tracing(False)
    timing.take()
    yield
    timing.tracing(False)
    timing.take()


def _batch(b: int, n: int = CFG.max_points, spec: SceneSpec = SPEC, seed0: int = 0) -> Cloud:
    pts = np.zeros((b, n, 3), np.float32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        p = make_scene(seed=seed0 + i, spec=spec).points[:n]
        pts[i, :len(p)] = p
        valid[i, :len(p)] = True
    return Cloud(points=torch.tensor(pts), valid=torch.tensor(valid))


def _call(cfg, cloud, seed=0):
    gen = torch.Generator(device=cloud.device)
    gen.manual_seed(seed)
    return batched_pipeline(cfg)(cloud, generator=gen)


def test_tracing_off_records_nothing():
    assert timing.span("pcp.call") is timing.OFF and timing.host_read() is timing.OFF
    _call(CFG, _batch(2))
    rec = timing.take()
    assert rec.spans == [] and rec.dropped == 0


def test_a_call_holds_the_nine_stages_in_order_under_one_request():
    cloud = _batch(2)
    timing.tracing(True)
    res = _call(CFG, cloud)
    _call(CFG, cloud)
    spans = timing.take().spans
    calls = [s for s in spans if s.name == "pcp.call"]
    assert len(calls) == 2 and calls[0].request != calls[1].request
    call = calls[0]
    mine = [s for s in spans if s.request == call.request]
    stages = [s for s in mine if s.parent == call.id]
    assert [s.name for s in stages] == ["pcp.stage." + n for n in STAGES]
    by_id = {s.id: s for s in mine}
    for s in mine:  # every span of the request lies inside its call
        if s is not call:
            assert s.parent in by_id and call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    assert call.parent == 0 and call.counts.get("host_reads", 0) == res.host_syncs
    assert stages == sorted(stages, key=lambda s: s.start_ns)
    totals = timing.totals(mine)
    assert totals["pcp.call"].count == 1
    assert totals["pcp.call"].self_seconds < totals["pcp.call"].seconds


@pytest.mark.parametrize("band_window", [256, 0], ids=["banded", "full_sweep"])
def test_host_read_spans_count_the_host_syncs(band_window):
    """A read a sweep of the banded loop (and of the plain full-sweep loop
    that CPU tensors take): the ``pcp.host_read`` spans, their counter on
    the call and ``PipelineResult.host_syncs`` agree."""
    cfg = CFG.replace(cluster_band_window=band_window)
    cloud = _batch(3, seed0=4)
    timing.tracing(True)
    res = _call(cfg, cloud)
    rec = timing.take()
    reads = [s for s in rec.spans if s.name == "pcp.host_read"]
    assert res.host_syncs > 0 and len(reads) == res.host_syncs
    assert all(s.counts == {"host_reads": 1} for s in reads)
    (call,) = [s for s in rec.spans if s.name == "pcp.call"]
    assert call.counts["host_reads"] == res.host_syncs
    stage_of = {s.id: s.name for s in rec.spans}
    assert {stage_of[s.parent] for s in reads} == {"pcp.stage.euclidean_cluster"}


def test_two_threads_keep_separate_stacks():
    timing.tracing(True)
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with timing.span(f"pcp.call.{tag}"):
            barrier.wait()  # both roots open at once
            with timing.span(f"pcp.stage.{tag}"):
                barrier.wait()
                assert timing.current() == f"pcp.stage.{tag}"
            with timing.host_read():
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    spans = timing.take().spans
    assert len(spans) == 6
    roots = {s.name[-1]: s for s in spans if s.name.startswith("pcp.call.")}
    assert roots["a"].request != roots["b"].request and roots["a"].thread != roots["b"].thread
    for s in spans:
        if s.parent:
            root = roots[s.name[-1]] if s.name != "pcp.host_read" else \
                next(r for r in roots.values() if r.id == s.parent)
            assert s.parent == root.id and s.request == root.request and s.thread == root.thread
            if s.name == "pcp.host_read":
                assert root.counts == {"host_reads": 1}
    assert timing.current() is None


def test_launch_counts_launches_and_is_the_kernel_span():
    _build.reset_launch_counts()
    with _build.launch("xla_sum"):
        pass
    with _build.launch("xla_sum") as launch:
        launch.skip()
    with pytest.raises(RuntimeError):
        with _build.launch("xla_sum"):
            raise RuntimeError("the launch failed")
    assert _build.LAUNCHES["xla_sum"] == 1 and timing.take().spans == []

    timing.tracing(True)
    with timing.span("pcp.call"):
        with timing.span("pcp.stage.segment_planes"):
            for _ in range(3):
                with _build.launch("fma_chain"):
                    assert timing.current() == "pcp.kernel.fma_chain"
            with _build.launch("xla_sum") as launch:
                launch.skip()
    spans = timing.take().spans
    assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES}, "xla_sum": 1, "fma_chain": 3}
    totals = timing.totals(spans)
    assert totals["pcp.kernel.fma_chain"].count == 3
    assert totals["pcp.kernel.fma_chain"].counts == {"launches": 3}
    assert totals["pcp.kernel.xla_sum"].counts == {}
    assert totals["pcp.stage.segment_planes"].counts == {"launches": 3}
    assert totals["pcp.call"].counts == {"launches": 3}
    _build.reset_launch_counts()


def test_collect_keeps_its_spans_out_of_the_buffer():
    """A span closed inside ``collect`` goes to its list (and the lists of
    the blocks around it) and not to ``take``'s buffer; one closed outside,
    or on another thread, goes to the buffer."""
    timing.tracing(True)
    other = threading.Thread(target=lambda: timing.span("pcp.other").__enter__().__exit__(
        None, None, None))
    with timing.collect() as outer:
        with timing.span("pcp.call"):
            with timing.collect() as inner:
                with timing.span("pcp.stage.a"):
                    pass
            other.start()
            other.join(timeout=10)
    with timing.span("pcp.call.after"):
        pass
    assert [s.name for s in inner] == ["pcp.stage.a"]
    assert [s.name for s in outer] == ["pcp.stage.a", "pcp.call"]
    assert [s.name for s in timing.take().spans] == ["pcp.other", "pcp.call.after"]


def test_the_buffer_is_bounded_and_take_clears_it(monkeypatch):
    monkeypatch.setattr(timing, "CAPACITY", 3)
    timing.tracing(True)
    for _ in range(5):
        with timing.span("pcp.call"):
            pass
    rec = timing.take()
    assert len(rec.spans) == 3 and rec.dropped == 2
    rec = timing.take()
    assert rec.spans == [] and rec.dropped == 0


def test_totals_give_seconds_self_seconds_and_counters():
    def rec(i, name, parent, start, end, counts=None):
        s = timing.Span(name)
        s.id, s.parent, s.request, s.thread = i, parent, 1, 0
        s.start_ns, s.end_ns, s.counts = start, end, counts or {}
        return s

    spans = [rec(2, "pcp.stage.a", 1, 10, 40, {"launches": 2}),
             rec(3, "pcp.stage.b", 1, 40, 90, {"host_reads": 1}),
             rec(1, "pcp.call", 0, 0, 100, {"launches": 2, "host_reads": 1})]
    t = timing.Record(spans, 0).totals()
    call, a = t["pcp.call"], t["pcp.stage.a"]
    assert (call.seconds, call.self_seconds) == pytest.approx((100e-9, 20e-9), rel=1e-12)
    assert (call.count, call.counts) == (1, {"launches": 2, "host_reads": 1})
    assert (a.seconds, a.self_seconds) == pytest.approx((30e-9, 30e-9), rel=1e-12)
    assert (a.count, a.counts) == (1, {"launches": 2})


def test_profile_trace_holds_the_pipeline_spans(tmp_path):
    cloud = _batch(2)
    path = timing.profile_trace(_call, CFG, cloud, trace_dir=str(tmp_path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"pcp.call", "pcp.host_read", *("pcp.stage." + s for s in STAGES)} <= names
    assert {s.name for s in timing.take().spans} <= names
    assert timing.span("pcp.call") is timing.OFF


def _node_run(async_mode: bool, caplog):
    cfg = CFG.replace(max_points=16384, max_voxels=4096, accumulate_count=4)
    caplog.set_level(logging.DEBUG, logger="pointcloud_obstacle_processing_tpu_torch")
    node, _ = node_launch.launch(config=cfg, cycles=2, points_per_frame=4096,
                                 async_pipeline=async_mode, device="cpu")
    node.flush()
    node.close()
    return node.metrics, node.last_result.host_syncs


@pytest.mark.parametrize("async_mode", [False, True], ids=["sync", "async"])
def test_the_node_adds_each_cycles_host_seconds_by_stage(async_mode, caplog):
    """A short window of two cycles: off, the entries are as they were; on,
    each holds its host seconds by stage (the dispatch thread's spans in
    async mode), in its reads and in the kernel wrappers, and its counts,
    the stage table is logged at debug level, and the process-wide buffer
    stays empty."""
    plain, _ = _node_run(async_mode, caplog)
    assert len(plain) == 2 and not {"host_seconds", "launches", "host_reads"} & set(plain[0])
    timing.tracing(True)
    metrics, last_syncs = _node_run(async_mode, caplog)
    assert timing.take().spans == []  # the node collects its spans; none stay behind
    assert len(metrics) == 2 and metrics[-1]["host_reads"] == last_syncs
    for m, p in zip(metrics, plain):
        assert set(m) == set(p) | {"host_seconds", "launches", "host_reads"}
        assert list(m["host_seconds"]) == [*STAGES, "host_read", "kernels"]
        assert all(v >= 0.0 for v in m["host_seconds"].values())
        assert m["launches"] == 0  # the CPU runs no kernel
        assert (m["host_seconds"]["host_read"] > 0.0) == (m["host_reads"] > 0)
    tables = [r.getMessage() for r in caplog.records if "TOTAL TIME" in r.getMessage()]
    assert len(tables) == 2 and all(s in tables[0] for s in STAGES)


# ------------------------------------------------------------------ the card
FLAGSHIP = REFERENCE_YAML_CONFIG.replace(
    max_points=100352, max_voxels=81920, cluster_capacity=8192, max_clusters=64,
    knn_row_tile=1024, knn_band=1280, publish_point_clouds=True,
)
FLAGSHIP_SPEC = SceneSpec(n_ground=80000, n_rocks=4, points_per_rock=2000, n_noise=1000)
BANDED = FLAGSHIP.replace(cluster_band_window=1024)

# a kernel span's key -> a piece of the name of the device kernel it launches
KERNEL_OF = {
    "runreduce": "rr_window<", "runreduce_counts": "rr_window<", "compact_gather": "scatter<",
    "knn_mean": "knn_mean<", "knn_mean_rows": "knn_mean<", "cluster_loop": "cluster_loop",
    "cluster_grid_loop": "cluster_grid_loop(", "cluster_sweep": "cluster_sweep(",
    "cluster_sweep_rows": "cluster_sweep(", "cluster_sweep_banded": "cluster_sweep_banded(",
    "cluster_sweep_banded_rows": "cluster_sweep_banded(", "segscan": "segscan_",
    "binned_sum": "binned_sum", "xla_sum": "xla_sum_", "covariance_tail": "xla_sum_cluster<",
    "segment_fold": "segment_fold<", "shadow_slots": "shadow_slots(",
    "shadow_raster": "shadow_raster(", "libm32": "libm32_eval", "fma_chain": "fma_chain<",
    "ransac_hypotheses_score": "ransac_score<", "plane_inliers": "plane_inliers(",
    "plane_inliers_close": "plane_inliers_close(",
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_kernel_table_names_every_launch_key():
    assert set(KERNEL_OF) == set(_build.LAUNCHES)


def _kernel_spans(events) -> list:
    """Each ``pcp.kernel.*`` span of a chrome trace's events, with the names
    of the device operations that the runtime launches inside it started
    (matched by correlation id)."""
    events = [e for e in events if e.get("ph") == "X"]
    ops, launches, spans = defaultdict(list), [], []
    for e in events:
        cat, corr = e.get("cat", ""), (e.get("args") or {}).get("correlation")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops[corr].append(e["name"])
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches.append((float(e["ts"]), corr))
        elif e.get("name", "").startswith("pcp.kernel.") and not cat.startswith("gpu_"):
            spans.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
    return [(name, [op for t, corr in launches if s <= t <= end for op in ops[corr]])
            for name, s, end in sorted(spans, key=lambda x: x[1])]


@pytest.mark.cuda
def test_kernel_spans_hold_their_launches_on_the_profilers_clock(dev, tmp_path):
    """A profiled flagship batch of four scans: each ``pcp.kernel.<name>``
    span holds the runtime launch of that wrapper's device kernel, and the
    spans count the launches ``LAUNCHES`` counts."""
    cloud = _batch(4, FLAGSHIP.max_points, FLAGSHIP_SPEC).to(dev)
    _call(FLAGSHIP, cloud)  # the build and the warm-up
    _build.reset_launch_counts()
    timing.take()
    path = timing.profile_trace(_call, FLAGSHIP, cloud, trace_dir=str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    launched = sum(_build.LAUNCHES.values())
    spans = _kernel_spans(events)
    assert len(spans) == launched > 0
    for name, ops in spans:
        want = KERNEL_OF[name[len("pcp.kernel."):]]
        assert any(want in op for op in ops), (name, ops)
    calls = [s for s in timing.take().spans if s.name == "pcp.call"]
    assert [c.counts.get("launches") for c in calls] == [launched]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [FLAGSHIP, BANDED], ids=["flagship", "banded"])
def test_every_synchronising_call_lies_in_a_host_read(dev, cfg):
    """A batch of four flagship scans (the grid loop kernel, no read) and
    the same with the cluster band on (a read a sweep) under
    ``torch.cuda.set_sync_debug_mode("warn")``: each synchronising call the
    mode reports is made inside a ``pcp.host_read`` span."""
    cloud = _batch(4, cfg.max_points, FLAGSHIP_SPEC, seed0=20).to(dev)
    _call(cfg, cloud)
    torch.cuda.synchronize()
    timing.tracing(True)
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):  # not the mode's own notice
            seen.append((timing.current(), "".join(traceback.format_stack(limit=6))))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = _call(cfg, cloud)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    outside = [where for span, where in seen if span != "pcp.host_read"]
    assert not outside, outside[0]
    assert len(seen) == res.host_syncs
    assert (res.host_syncs > 0) == bool(cfg.cluster_band_window)
