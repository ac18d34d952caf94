#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship scan and the
fullscale 2M-point window.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. Names the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit) and builds the CUDA kernels from ``csrc/`` with nvcc.
2. Calls each kernel on seeded tensors on the card and holds it bitwise
   against its plain PyTorch version on the same inputs, then times both
   with CUDA events: K1 run-reduce, K2 compaction, K3 banded k-select and
   K4 cluster sweep at the flagship shapes; K1, K2 and K3 at the fullscale
   shapes; K5 banded cluster sweep at the fullscale shape, once with every
   tile live and once with a seeded random ``tile_live``.
3. Flagship path: counts from 0, ``ObstacleDetectionModel(FLAGSHIP_CONFIG)``
   on the card over three seeded scenes; checks that K1-K4 were launched,
   that no overflow flag is set and that each rock of the scene is matched
   by a cluster, and compares each scan with the same scan through the
   plain versions on the CPU (same RANSAC draws): grid, stage counts and
   flags exact, centroids within 1e-5.  Times ``process_scan`` per scan
   (p50) and counts its host syncs.
4. Fullscale path: counts from 0, one scan of the canonical fullscale
   window (``make_fullscale_window(2_097_152)``) through
   ``ObstacleDetectionModel(REFERENCE_FULLSCALE_CONFIG)`` on the card;
   checks that K1, K2, K3 and K5 were launched and that no overflow flag is
   set, and compares it with the same window through the plain versions on
   the CPU by the same bar.  Times a few scans (p50) and counts host syncs.

Its last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON list of kernels, one entry per kernel and path, with launches on
that path, errors, times and the bound.  There is no CPU fallback: without
a CUDA card the script raises.
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
TPU = "pointcloud_obstacle_processing_tpu"
RANSAC_SEED = 5
SCENE_SEEDS = (0, 1, 2)
TIMED_SCANS = 20
FULLSCALE_POINTS = 2_097_152
FULLSCALE_TIMED_SCANS = 5

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores; bound_ms is the larger of bytes / HBM rate and operations / fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
D2_OPS = 9  # flops per scored pair: cross 3 mul + 2 add; d2 add, mul, sub; the compare


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


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def _row(name, path, shape, source, replaces, err, ms, plain_ms, bound, library_ms=None):
    return dict(
        name=name, path=path, shape=shape, route="cuda", source=f"{PKG}/csrc/{source}",
        replaces=f"{TPU}/ops/{replaces}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=library_ms,
    )


def check_k1(dev, rng, path, n, cap, n_valid, n_keys, sentinel, leaf):
    """K1 on a key-sorted point buffer with 16-bit packed payloads."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import runreduce

    keys = np.sort(rng.choice(sentinel, n_keys, replace=False))
    skey = np.full(n, sentinel, np.int32)
    skey[:n_valid] = np.sort(rng.choice(keys, n_valid))
    pxy = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    pz = rng.integers(0, 65536, n).astype(np.int32)
    quantum = leaf / 65536.0
    args = [torch.tensor(skey, device=dev), (torch.tensor(pxy, device=dev), torch.tensor(pz, device=dev))]
    vk, nk = runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum)
    vp, np_ = runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum)
    if int(nk) != int(np_):
        raise AssertionError(f"K1 {path}: run count {int(nk)} != plain {int(np_)}")
    k = min(int(nk), cap)
    err = _assert_equal(f"K1 runreduce {path}", vk[:k], vp[:k])
    w = runreduce.default_group(n) * 128
    # keys + two payloads in, [cap, 5] out; 4 channels x log2(w) Hillis-Steele adds a row
    bound = _bound(n * 12 + cap * 20, 4 * n * int(np.log2(w)))
    return _row(
        "runreduce", path, f"{n} rows, {w}-row windows, {int(nk)} runs, cap {cap}",
        "runreduce.cu", "pallas_runreduce.py:462", err,
        _time_ms(lambda: runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum)),
        _time_ms(lambda: runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum), 3),
        bound,
    )


def check_k2(dev, rng, path, nv, ccap, density):
    """K2: the non-plane cloud of a voxel buffer into the cluster buffer."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import compaction

    occ = torch.tensor(rng.random(nv) < density, device=dev)
    bins = torch.tensor(rng.standard_normal((4, nv)).astype(np.float32), device=dev)
    bins[3] = occ.to(torch.float32)
    occ2d = occ.reshape(nv // 128, 128)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, ccap)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ2d, ccap)
    if int(nk) != int(np_):
        raise AssertionError(f"K2 {path}: occupied count differs")
    k = min(int(nk), ccap)
    _assert_equal(f"K2 compaction loc {path}", lk[:k], lp[:k])
    err = _assert_equal(f"K2 compaction vals {path}", vk[:k], vp[:k])
    return _row(
        "compact_gather", path, f"{nv} -> {ccap} slots, {int(nk)} occupied",
        "compaction.cu", "pallas_compaction.py:59", err,
        _time_ms(lambda: compaction.compact_and_gather_exact(bins, occ2d, ccap)),
        _time_ms(lambda: compaction.compact_and_gather_plain(bins, occ2d, ccap)),
        _bound(nv * (16 + 1) + ccap * (4 + 16), 0),
        library_ms=_time_ms(lambda: bins.T[occ]),  # boolean-mask gather
    )


def _lattice_buffer(dev, rng, n, n_valid, lo, hi):
    """A lattice-ordered (x-sorted), front-compacted, centered point buffer."""
    import torch

    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(n) < n_valid, device=dev)
    p = torch.tensor(pts, device=dev)
    p = torch.where(valid[:, None], p - torch.where(valid[:, None], p, 0.0).sum(0) / n_valid, 0.0)
    return p, valid


def check_k3(dev, rng, path, nv, n_valid, rt, band):
    """K3 on a lattice-ordered, front-compacted voxel cloud."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    p, valid = _lattice_buffer(dev, rng, nv, n_valid, [0, 0, -0.1], [4.5, 3.78, 0.3])
    pch = [p[:, c].contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-nv // rt)
    starts = outliers.band_starts(nv, rt, band, tiles, dev)
    width = rt + 2 * band
    sk = outliers.knn_select(pch, p_sq, valid, starts, rt, width)
    sp = outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width)
    err = _assert_equal(f"K3 knn_select {path}", sk, sp)
    live_tiles = -(-n_valid // rt)  # the buffer is front-compacted
    return _row(
        "knn_select", path, f"{nv} queries, row tile {rt}, window {width}",
        "knn_select.cu", "outliers.py:142", err,
        _time_ms(lambda: outliers.knn_select(pch, p_sq, valid, starts, rt, width)),
        _time_ms(lambda: outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width), 3),
        _bound(nv * 17 + tiles * 4 + 16 * tiles * rt * 4, live_tiles * rt * width * D2_OPS),
    )


def _cluster_buffer(dev, rng, c, n_valid, spread):
    import torch

    p, valid = _lattice_buffer(dev, rng, c, n_valid, [0, 0, -0.3], [spread, 3.78, 0.3])
    lab = np.arange(c, dtype=np.int32)  # labels[i] <= i, as the sweep loop keeps them
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    return p, valid, torch.tensor(lab, device=dev)


def check_k4(dev, rng, path, c, n_valid, tol2):
    """K4 on a centered cluster buffer with chained labels."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    p, valid, labels = _cluster_buffer(dev, rng, c, n_valid, 3.0)
    err = _assert_equal(f"K4 cluster_sweep {path}", cluster.sweep_jump(p, valid, labels, tol2),
                        cluster.sweep_jump_plain(p, valid, labels, tol2))
    return _row(
        "cluster_sweep", path, f"C {c}, {n_valid} valid",
        "cluster_sweep.cu", "cluster.py:86", err,
        _time_ms(lambda: cluster.sweep_jump(p, valid, labels, tol2)),
        _time_ms(lambda: cluster.sweep_jump_plain(p, valid, labels, tol2)),
        _bound(c * 21 + c * 4, n_valid * c * D2_OPS),
    )


def check_k5(dev, rng, path, c, n_valid, window, tolerance):
    """K5 on a lattice-ordered, centered cluster buffer, every tile live and
    with a seeded random tile_live; starts from ``band_starts``."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    p, valid, labels = _cluster_buffer(dev, rng, c, n_valid, 4.5)
    tol2 = tolerance ** 2
    starts, _ = cluster.band_starts(p, valid, 128, window, tolerance)
    has_valid = valid.reshape(c // 128, 128).any(dim=1)
    rows = []
    for gated in (False, True):
        live = torch.tensor(rng.random(c // 128) < 0.5, device=dev) if gated else None
        args = (p, valid, labels, tol2, 128, window, starts, live)
        err = _assert_equal(f"K5 cluster_sweep_banded {path} gated={gated}",
                            cluster.sweep_jump_banded(*args), cluster.sweep_jump_banded_plain(*args))
        computed = int((has_valid & live).sum()) if gated else int(has_valid.sum())
        rows.append(_row(
            "cluster_sweep_banded", path,
            f"C {c}, {n_valid} valid, window {window}, "
            f"{'random tile_live' if gated else 'every tile live'}, {computed} tiles computed",
            "cluster_sweep_banded.cu", "cluster.py:329", err,
            _time_ms(lambda: cluster.sweep_jump_banded(*args)),
            _time_ms(lambda: cluster.sweep_jump_banded_plain(*args)),
            _bound(c * 21 + (c // 128) * 5 + c * 4, computed * 128 * window * D2_OPS),
        ))
    return rows


def check_kernels(dev, card: str) -> list[dict]:
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs

    rng = np.random.default_rng(0)
    rows = [
        check_k1(dev, rng, "flagship", fl.max_points, fl.max_voxels, 90_000, 21_500, 230_000,
                 fl.downsample_leaf_size),
        check_k2(dev, rng, "flagship", fl.max_voxels, fl.cluster_capacity, 0.025),
        check_k3(dev, rng, "flagship", fl.max_voxels, 21_500, fl.knn_row_tile, fl.knn_band),
        check_k4(dev, rng, "flagship", fl.cluster_capacity, 600, fl.euc_cluster_tolerance ** 2),
        # the fullscale window: ~2.0 M points, ~166 k voxels of a 302 x 254 x
        # 52 lattice, ~7 k non-plane points
        check_k1(dev, rng, "fullscale", fs.max_points, fs.max_voxels, 2_000_000, 166_000,
                 3_988_816, fs.downsample_leaf_size),
        check_k2(dev, rng, "fullscale", fs.max_voxels, fs.cluster_capacity, 7_000 / fs.max_voxels),
        check_k3(dev, rng, "fullscale", fs.max_voxels, 166_000, fs.knn_row_tile, fs.knn_band),
        *check_k5(dev, rng, "fullscale", fs.cluster_capacity, 7_000, fs.cluster_band_window,
                  fs.euc_cluster_tolerance),
    ]
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; "
              f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']} ms [{card}]")
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
_OVERFLOWS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow")


def _compare(label: str, a, b) -> float:
    """CUDA run ``a`` against CPU run ``b``: the crosscheck bar."""
    import torch

    if not torch.equal(a.grid.data.cpu(), b.grid.data.cpu()):
        raise AssertionError(f"{label}: grids differ")
    for k in _COUNTS + _FLAGS:
        va, vb = getattr(a.stats, k).item(), getattr(b.stats, k).item()
        if va != vb:
            raise AssertionError(f"{label}: {k} cuda={va} cpu={vb}")
    ca = a.centroids.points.xyzr.cpu().numpy()[a.centroids.valid.cpu().numpy()]
    cb = b.centroids.points.xyzr.cpu().numpy()[b.centroids.valid.cpu().numpy()]
    if ca.shape != cb.shape:
        raise AssertionError(f"{label}: cluster counts differ")
    if not np.isfinite(ca).all():
        raise AssertionError(f"{label}: non-finite centroids")
    err = float(np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max()) if len(ca) else 0.0
    if err >= 1e-5:
        raise AssertionError(f"{label}: centroids differ by {err}")
    return err


def _check_overflows(label: str, res) -> None:
    flags = {k: bool(getattr(res.stats, k).item()) for k in _OVERFLOWS}
    if any(flags.values()):
        raise AssertionError(f"{label}: overflow flag set: {flags}")


def _drive(model, cloud, draw, path: list[str]) -> tuple[object, dict]:
    """One main-path scan with the launch counts from 0; fails if a kernel
    of ``path`` was not launched.  Returns the result and the counts."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build

    _build.reset_launch_counts()
    res = model(cloud, draw=draw)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return res, counts


def _time_scans(model, clouds, draw, n: int) -> list[float]:
    import torch

    times = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(clouds[i % len(clouds)], draw=draw)
        torch.cuda.synchronize()
        if i:  # the first run warms the allocator
            times.append((time.perf_counter() - t) * 1e3)
    return times


def _count_syncs(model, cloud, draw) -> tuple[int, object]:
    """Host syncs of one scan, as torch's sync debug mode reports them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = model(cloud, draw=draw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught), res


def _draws(cfg, dev):
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform

    u = np.random.default_rng(RANSAC_SEED).random(
        (cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    return draw_from_uniform(torch.tensor(u, device=dev)), draw_from_uniform(torch.tensor(u))


def run_flagship(dev, card: str) -> dict:
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG, ObstacleDetectionModel

    cfg = FLAGSHIP_CONFIG
    model = ObstacleDetectionModel(cfg, device=dev)
    model_cpu = ObstacleDetectionModel(cfg, device="cpu")
    draw_cuda, draw_cpu = _draws(cfg, dev)
    scenes = {s: _scene(s) for s in SCENE_SEEDS}
    clouds = {s: Cloud.pad_to(scenes[s].points[: cfg.max_points], cfg.max_points) for s in SCENE_SEEDS}
    gpu_clouds = [clouds[s].to(dev) for s in SCENE_SEEDS]

    # main path: counts from 0, one scan of each scene on the card
    path = ["runreduce", "compact_gather", "knn_select", "cluster_sweep"]
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    results = {}
    for s, gc in zip(SCENE_SEEDS, gpu_clouds):
        results[s], counts = _drive(model, gc, draw_cuda, path)
        launches = {k: launches[k] + counts[k] for k in launches}

    for s in SCENE_SEEDS:
        res = results[s]
        _check_overflows(f"scene {s}", res)
        _check_rocks(scenes[s], res)
        err = _compare(f"scene {s}", res, model_cpu(clouds[s], draw=draw_cpu))
        counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
        print(f"flagship scene {s}: cuda == cpu plain (grid, counts, flags exact; centroid max "
              f"|d| {err:.2e}); {counts}; host syncs {res.host_syncs}")

    times = _time_scans(model, gpu_clouds, draw_cuda, TIMED_SCANS)
    n_sync, res = _count_syncs(model, gpu_clouds[0], draw_cuda)
    print(f"flagship process_scan p50 {statistics.median(times):.3f} ms per scan over "
          f"{len(times)} scans (min {min(times):.3f}, max {max(times):.3f}); host syncs per scan "
          f"{n_sync} (sync debug mode; cluster loop counts {res.host_syncs}); kernel launches "
          f"over the {len(SCENE_SEEDS)} main-path scans {launches} [{card}]")
    return launches


def run_fullscale(dev, card: str) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.models import (
        REFERENCE_FULLSCALE_CONFIG,
        ObstacleDetectionModel,
    )
    from pointcloud_obstacle_processing_tpu_torch.types import Cloud
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cfg = REFERENCE_FULLSCALE_CONFIG
    model = ObstacleDetectionModel(cfg, device=dev)
    model_cpu = ObstacleDetectionModel(cfg, device="cpu")
    draw_cuda, draw_cpu = _draws(cfg, dev)
    pts, valid = make_fullscale_window(FULLSCALE_POINTS)
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid))
    gpu_cloud = cloud.to(dev)

    path = ["runreduce", "compact_gather", "knn_select", "cluster_sweep_banded"]
    res, launches = _drive(model, gpu_cloud, draw_cuda, path)
    _check_overflows("fullscale", res)
    if int(res.stats.num_clusters) < 1:
        raise AssertionError("fullscale: no cluster found")
    t = time.perf_counter()
    ref = model_cpu(cloud, draw=draw_cpu)
    cpu_s = time.perf_counter() - t
    err = _compare("fullscale", res, ref)
    counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
    print(f"fullscale window: cuda == cpu plain (grid, counts, flags exact; centroid max |d| "
          f"{err:.2e}); {counts}; host syncs {res.host_syncs}; cpu plain run {cpu_s:.1f} s")

    times = _time_scans(model, [gpu_cloud], draw_cuda, FULLSCALE_TIMED_SCANS)
    n_sync, res = _count_syncs(model, gpu_cloud, draw_cuda)
    print(f"fullscale process_scan p50 {statistics.median(times):.3f} ms per scan over "
          f"{len(times)} scans (min {min(times):.3f}, max {max(times):.3f}); host syncs per scan "
          f"{n_sync} (sync debug mode; cluster loop counts {res.host_syncs}); kernel launches on "
          f"the main-path scan {launches} [{card}]")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside the script")
    sys.path.insert(0, str(ROOT))
    from pointcloud_obstacle_processing_tpu_torch import _build

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
    launches = {"flagship": run_flagship(dev, card), "fullscale": run_fullscale(dev, card)}

    for r in rows:
        r["launches"] = launches[r["path"]][r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on the {r['path']} path")
    keys = ("name", "path", "shape", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
