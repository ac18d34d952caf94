#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card, at the flagship shape.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. Names the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit) and builds the CUDA kernels from ``csrc/`` with nvcc.
2. Calls each kernel (K1 run-reduce, K2 compaction, K3 banded k-select,
   K4 cluster sweep) on seeded tensors on the card at the flagship shapes
   and holds it bitwise against its plain PyTorch version on the same
   inputs, then times both with CUDA events.
3. Drives ``ObstacleDetectionModel(FLAGSHIP_CONFIG)`` on the card over
   three seeded scenes, checks that every kernel was launched, that no
   overflow flag is set and that each rock of the scene is matched by a
   cluster, and compares each scan with the same scan through the plain
   versions on the CPU (same RANSAC draws): grid, stage counts and flags
   exact, centroids within 1e-5.
4. Times ``process_scan`` per scan (p50) and counts its host syncs.

Its last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON list of kernels with their launches, errors and times.  There is
no CPU fallback: without a CUDA card the script raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "pointcloud_obstacle_processing_tpu_torch"
RANSAC_SEED = 5
SCENE_SEEDS = (0, 1, 2)
TIMED_SCANS = 30


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _assert_equal(name: str, a, b) -> float:
    """Bitwise equality of two tensors (NaN-free); returns max |a - b|."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
    diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel differs from its plain version (max |d| {diff})")
    return diff


def check_kernels(dev, card: str) -> list[dict]:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster, compaction, outliers, runreduce

    rng = np.random.default_rng(0)
    rows = []

    # K1: a key-sorted flagship point buffer with 16-bit packed payloads
    n, cap = cfg.max_points, cfg.max_voxels
    sentinel = 230_000
    n_valid = 90_000
    skey = np.full(n, sentinel, np.int32)
    skey[:n_valid] = np.sort(rng.integers(0, sentinel, n_valid))
    pxy = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    pz = rng.integers(0, 65536, n).astype(np.int32)
    quantum = cfg.downsample_leaf_size / 65536.0
    args = [torch.tensor(skey, device=dev), (torch.tensor(pxy, device=dev), torch.tensor(pz, device=dev))]
    vk, nk = runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum)
    vp, np_ = runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum)
    if int(nk) != int(np_):
        raise AssertionError(f"K1 run count {int(nk)} != plain {int(np_)}")
    k = min(int(nk), cap)
    err = _assert_equal("K1 runreduce", vk[:k], vp[:k])
    rows.append(dict(
        name="runreduce", route="cuda", source=f"{PKG}/csrc/runreduce.cu",
        replaces="pointcloud_obstacle_processing_tpu/ops/pallas_runreduce.py:462",
        max_abs_err=err,
        ms=_time_ms(lambda: runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum)),
        plain_ms=_time_ms(lambda: runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum), 3),
    ))

    # K2: the non-plane cloud of a flagship voxel buffer into the cluster buffer
    nv, ccap = cfg.max_voxels, cfg.cluster_capacity
    occ = torch.tensor(rng.random(nv) < 0.025, device=dev)
    bins = torch.tensor(rng.standard_normal((4, nv)).astype(np.float32), device=dev)
    bins[3] = occ.to(torch.float32)
    occ2d = occ.reshape(nv // 128, 128)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, ccap)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ2d, ccap)
    if int(nk) != int(np_):
        raise AssertionError("K2 occupied count differs")
    k = min(int(nk), ccap)
    _assert_equal("K2 compaction loc", lk[:k], lp[:k])
    err = _assert_equal("K2 compaction vals", vk[:k], vp[:k])
    rows.append(dict(
        name="compact_gather", route="cuda", source=f"{PKG}/csrc/compaction.cu",
        replaces="pointcloud_obstacle_processing_tpu/ops/pallas_compaction.py:59",
        max_abs_err=err,
        ms=_time_ms(lambda: compaction.compact_and_gather_exact(bins, occ2d, ccap)),
        plain_ms=_time_ms(lambda: compaction.compact_and_gather_plain(bins, occ2d, ccap)),
    ))

    # K3: a lattice-ordered, front-compacted voxel cloud (21.5k of 24576 valid)
    pts = rng.uniform([0, 0, -0.1], [4.5, 3.78, 0.3], (nv, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(nv) < 21_500, device=dev)
    p = torch.tensor(pts, device=dev)
    pch = [torch.where(valid, p[:, c] - p[:, c].mean(), 0.0).contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    rt, band = cfg.knn_row_tile, cfg.knn_band
    tiles = -(-nv // rt)
    starts = outliers.band_starts(nv, rt, band, tiles, dev)
    width = rt + 2 * band
    sk = outliers.knn_select(pch, p_sq, valid, starts, rt, width)
    sp = outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width)
    err = _assert_equal("K3 knn_select", sk, sp)
    rows.append(dict(
        name="knn_select", route="cuda", source=f"{PKG}/csrc/knn_select.cu",
        replaces="pointcloud_obstacle_processing_tpu/ops/outliers.py:142",
        max_abs_err=err,
        ms=_time_ms(lambda: outliers.knn_select(pch, p_sq, valid, starts, rt, width)),
        plain_ms=_time_ms(lambda: outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width), 5),
    ))

    # K4: a centered cluster buffer (600 of 1024 valid) with chained labels
    c = cfg.cluster_capacity
    cp = rng.uniform(-1.5, 1.5, (c, 3)).astype(np.float32)
    cvalid = torch.tensor(np.arange(c) < 600, device=dev)
    cpt = torch.where(cvalid[:, None], torch.tensor(cp, device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)  # labels[i] <= i, as the sweep loop keeps them
    lab[:600] = rng.integers(0, np.arange(600) + 1)
    labels = torch.tensor(lab, device=dev)
    tol2 = cfg.euc_cluster_tolerance ** 2
    ok_ = cluster.sweep_jump(cpt, cvalid, labels, tol2)
    op_ = cluster.sweep_jump_plain(cpt, cvalid, labels, tol2)
    err = _assert_equal("K4 cluster_sweep", ok_, op_)
    rows.append(dict(
        name="cluster_sweep", route="cuda", source=f"{PKG}/csrc/cluster_sweep.cu",
        replaces="pointcloud_obstacle_processing_tpu/ops/cluster.py:86",
        max_abs_err=err,
        ms=_time_ms(lambda: cluster.sweep_jump(cpt, cvalid, labels, tol2)),
        plain_ms=_time_ms(lambda: cluster.sweep_jump_plain(cpt, cvalid, labels, tol2)),
    ))
    for r in rows:
        print(f"kernel {r['name']}: equal to plain; {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms [{card}]")
    return rows


def _scene(seed: int):
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

    return make_scene(seed=seed, spec=SceneSpec(
        n_ground=90_000, n_rocks=4, points_per_rock=2_000, n_noise=500))


def _check_rocks(scene, res) -> None:
    """Every rock of the scene is reported as a cluster: a centroid within
    0.15 m of the rock's centre in x-y with a radius of at least r - 0.12
    (the check of tests/test_pipeline.py), or, where clutter has chained
    onto the rock's cluster, a cluster whose x-y circle holds the whole
    rock.  That test's upper radius bound is not applied: with the flagship
    scenes' 500 clutter points, clutter chains onto rock clusters and
    widens them (in the JAX package as well), as the comment on that
    test's scene explains."""
    got = res.centroids.points.xyzr.cpu().numpy()[res.centroids.valid.cpu().numpy()]
    if len(got) < len(scene.rock_centers):
        raise AssertionError(f"{len(got)} clusters for {len(scene.rock_centers)} rocks")
    for c, r in zip(scene.rock_centers, scene.rock_radii):
        d = np.linalg.norm(got[:, :2] - c[None, :2], axis=1)
        j = int(np.argmin(d))
        near = d[j] < 0.15 and got[j, 3] >= r - 0.12
        if not (near or d[j] + r <= got[j, 3]):
            raise AssertionError(
                f"rock at {c} (r {r:.3f}) unmatched: nearest {d[j]:.3f}, r {got[j, 3]:.3f}")


_COUNTS = ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
           "nonplane_points", "num_planes", "num_clusters")
_FLAGS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow",
          "planes_truncated", "cluster_unconverged")


def _compare(seed: int, a, b) -> float:
    """CUDA run ``a`` against CPU run ``b``: the crosscheck bar."""
    import torch

    if not torch.equal(a.grid.data.cpu(), b.grid.data.cpu()):
        raise AssertionError(f"scene {seed}: grids differ")
    for k in _COUNTS + _FLAGS:
        va, vb = getattr(a.stats, k).item(), getattr(b.stats, k).item()
        if va != vb:
            raise AssertionError(f"scene {seed}: {k} cuda={va} cpu={vb}")
    ca = a.centroids.points.xyzr.cpu().numpy()[a.centroids.valid.cpu().numpy()]
    cb = b.centroids.points.xyzr.cpu().numpy()[b.centroids.valid.cpu().numpy()]
    if ca.shape != cb.shape:
        raise AssertionError(f"scene {seed}: cluster counts differ")
    err = float(np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max()) if len(ca) else 0.0
    if err >= 1e-5:
        raise AssertionError(f"scene {seed}: centroids differ by {err}")
    return err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside the script")
    sys.path.insert(0, str(ROOT))
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG, ObstacleDetectionModel
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    card = f"{name}; nvidia-smi: {smi}"
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(smi)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {sum(_build.BUILD_SECONDS):.1f} s)")

    rows = check_kernels(dev, card)

    cfg = FLAGSHIP_CONFIG
    model = ObstacleDetectionModel(cfg, device=dev)
    model_cpu = ObstacleDetectionModel(cfg, device="cpu")
    u = np.random.default_rng(RANSAC_SEED).random(
        (cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    draw_cuda = draw_from_uniform(torch.tensor(u, device=dev))
    draw_cpu = draw_from_uniform(torch.tensor(u))
    scenes = {s: _scene(s) for s in SCENE_SEEDS}
    clouds = {s: Cloud.pad_to(scenes[s].points[: cfg.max_points], cfg.max_points) for s in SCENE_SEEDS}
    gpu_clouds = {s: clouds[s].to(dev) for s in SCENE_SEEDS}

    # main path: counts from 0, one scan of each scene on the card
    _build.reset_launch_counts()
    results = {}
    for s in SCENE_SEEDS:
        before = dict(_build.LAUNCHES)
        results[s] = model(gpu_clouds[s], draw=draw_cuda)
        torch.cuda.synchronize()
        missing = [k for k in before if _build.LAUNCHES[k] <= before[k]]
        if missing:
            raise AssertionError(f"scene {s}: kernels not launched: {missing}")
    launches = dict(_build.LAUNCHES)

    for s in SCENE_SEEDS:
        res = results[s]
        flags = {k: bool(getattr(res.stats, k).item()) for k in _FLAGS}
        if any(flags[k] for k in ("voxel_overflow", "cluster_overflow", "cluster_band_overflow")):
            raise AssertionError(f"scene {s}: overflow flag set: {flags}")
        _check_rocks(scenes[s], res)
        ref = model_cpu(clouds[s], draw=draw_cpu)
        err = _compare(s, res, ref)
        counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
        print(f"scene {s}: cuda == cpu plain (grid, counts, flags exact; centroid max |d| "
              f"{err:.2e}); {counts}; host syncs {res.host_syncs}")

    times = []
    for i in range(TIMED_SCANS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(gpu_clouds[SCENE_SEEDS[i % len(SCENE_SEEDS)]], draw=draw_cuda)
        torch.cuda.synchronize()
        if i:  # the first run warms the allocator
            times.append((time.perf_counter() - t) * 1e3)
    # host syncs of one scan, as torch's sync debug mode reports them
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = model(gpu_clouds[SCENE_SEEDS[0]], draw=draw_cuda)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("called a synchronizing" in str(w.message) for w in caught)
    print(f"process_scan p50 {statistics.median(times):.3f} ms per scan over {len(times)} scans "
          f"(min {min(times):.3f}, max {max(times):.3f}); host syncs per scan {n_sync} "
          f"(sync debug mode; cluster loop counts {res.host_syncs}) [{card}]")

    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on the main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
