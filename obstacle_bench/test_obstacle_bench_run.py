"""The harness end to end on the CPU at a tiny size, its refusals, the
comparison failing its control and each fault, and the trace reader.

    python -m pytest obstacle_bench -q      # the card test skips here
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from obstacle_bench import harness, trace

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DEVICE_METRICS = {"device_idle_pct", "device_ops_per_call", "roofline_pct.outlier",
                  "roofline_pct.voxel"}


def tiny_cell(name="flagship.b32", batch=2):
    """The cell at a size the CPU runs in seconds: tiny scenes, ``batch``
    scans a request, the cell's own comparison sample."""
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, max_points=8192, max_voxels=8192, cluster_capacity=512,
                       cluster_band_window=cell.config["cluster_band_window"] and 512)
    t = copy.deepcopy(cell.traffic)
    t["scene"].update(n_ground=6000, points_per_rock=300, n_noise=200)
    t.update(batch=batch, pool=2 * batch, trace_requests=2, observations=1,
             arenas=list(range(100, 100 + 2 * batch)))
    cell.traffic = t
    return cell


def run_tiny(name="flagship.b32", traced=False, fault=None, seed=4_100_000_003, batch=2):
    return harness.run_cell(tiny_cell(name, batch), seed, 0.5, traced, "cpu",
                            time.perf_counter(), fault=fault, info=lambda _: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_on_the_cpu_is_correct_and_reports_no_device_metric(name):
    """Every metric of the cell but those only a card's trace gives."""
    wanted = {kind: {m["name"] for m in harness.load_cell(name).metrics if m["kind"] == kind}
              for kind in ("end_to_end", "per_layer")}
    result, checks = run_tiny(name)
    assert result["correct"] and result["attempted"] >= 2 and result["failed"] == 0
    assert set(result["metrics"]) == wanted["end_to_end"]
    assert list(result)[-1] == "checks" and all(c["value"] == 0 for c in checks.values())
    traced, _ = run_tiny(name, traced=True)
    assert traced["correct"]
    assert set(traced["metrics"]) == wanted["per_layer"] - DEVICE_METRICS
    assert "busy_s" not in traced["device"] and "breakdown" not in traced


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["bf16_points", "half_batch", "altered_answer"])
def test_the_control_and_each_fault_come_out_not_correct(fault, name):
    """At each cell's own comparison sample (``check``), with four scans a
    request so that each half of the batch holds two."""
    result, checks = run_tiny(name, fault=fault, batch=4)
    assert not result["correct"], checks


@pytest.mark.parametrize("batch,n", [(2, 2), (32, 2), (128, 2), (128, 4), (7, 3)])
def test_the_sample_holds_a_scan_of_each_half_of_the_batch(batch, n):
    from obstacle_bench import check
    for seed in range(50):
        picked = check.scans_to_compare(np.random.default_rng(seed), batch, n)
        assert len(set(picked)) == n and all(0 <= b < batch for b in picked)
        assert min(picked) < batch // 2 <= max(picked)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "obstacle_bench/run.py", "--workload", "flagship.b32",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_loaded_is_jax_or_the_jax_package():
    """A tiny run in a fresh process, then the reference alone in another:
    whole top-level names, since the port's begins with the JAX package's."""
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from obstacle_bench import test_obstacle_bench_run as t, harness; "
            "r, _ = t.run_tiny(); assert r['correct']; print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
    code = ("import sys; sys.path.insert(0, '.'); import obstacle_bench.check, "
            "obstacle_bench.reference.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'pointcloud_obstacle_processing_tpu', 'pointcloud_obstacle_processing_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr[-2000:]


def test_every_metric_and_traffic_of_the_benchmark_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "obstacle_bench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        assert (ROOT / "obstacle_bench" / "traffic" / f"{w['traffic']}.json").exists()
        harness.load_cell(w["name"])


def test_trace_reader_on_a_constructed_trace(tmp_path):
    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "ProfilerStep#1", 0, 100),
        ev("user_annotation", "segment_planes", 10, 30),
        ev("gpu_user_annotation", "segment_planes", 12, 40),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 2, 2),
        ev("kernel", "k_a", 20, 10, 1),
        ev("kernel", "k_b", 25, 10, 2),  # overlaps k_a: the union counts 15
        ev("gpu_memcpy", "Memcpy HtoD", 60, 5, 3),
        ev("kernel", "before the window", -50, 10, 4),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace.read(str(path), ["segment_planes"])
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(20e-6) and out["device_ops"] == 3
    assert out["stage_device_s"]["segment_planes"] == pytest.approx(10e-6)
    assert out["stage_device_s"][trace.OUTSIDE] == pytest.approx(15e-6)
    assert out["idle_by_host"] == pytest.approx({trace.OUTSIDE: 55e-6, "segment_planes": 25e-6})


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "obstacle_bench/run.py", "--workload", "flagship.b32",
                        "--seed", "4100000001", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert 0 < result["metrics"]["roofline_pct.outlier"]["value"] <= 100
