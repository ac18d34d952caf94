#!/usr/bin/env python3
"""Where the time of one scan goes in the PyTorch port, on one CUDA card.

    python3 scripts/torch_profile_scan.py --config fullscale --runs 10
    python3 scripts/torch_profile_scan.py --config flagship --batch 32

For the flagship scene (seed 0) or the canonical fullscale window, or with
``--batch B`` for a batch of B flagship scans (8 scenes, seeds 0-7, tiled,
a RANSAC draw of its own for each scan; one ``process_scan`` call a
batch), it prints:

* per-stage host wall time, with a ``torch.cuda.synchronize()`` before and
  after each stage of ``pipeline.process_scan``, p50 over ``--runs`` scans
  after one warm-up (the syncs serialise the stages, so the sum exceeds
  an unprofiled scan);
* from ``torch.profiler`` over ``--profiled`` scans: device time and
  device operations per scan, the kernels that take the most device time,
  and the device's busy share: device time per scan over the unprofiled
  p50 (the profiler's own host cost stretches the profiled scans).

Every line names the card and its power limit.  It needs a CUDA card and
raises without one.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("crop_and_seed", "voxel_downsample", "remove_statistical_outliers", "segment_planes",
          "compact", "euclidean_cluster", "cluster_centroids", "cast_shadows", "mark_obstacles")


def _inputs(name: str, dev, batch: int = 0):
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud
    from pointcloud_obstacle_processing_tpu_torch.models import (
        FLAGSHIP_CONFIG,
        REFERENCE_FULLSCALE_CONFIG,
    )
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import (
        SceneSpec,
        make_fullscale_window,
        make_scene,
    )

    spec = SceneSpec(n_ground=90_000, n_rocks=4, points_per_rock=2_000, n_noise=500)
    if batch:
        if name != "flagship":
            raise SystemExit("torch_profile_scan: --batch takes the flagship config")
        cfg = FLAGSHIP_CONFIG
        n = cfg.max_points
        scenes = [make_scene(seed=s, spec=spec).points[:n] for s in range(min(batch, 8))]
        pts = np.zeros((batch, n, 3), np.float32)
        valid = np.zeros((batch, n), bool)
        for b in range(batch):
            p = scenes[b % len(scenes)]
            pts[b, : len(p)] = p
            valid[b, : len(p)] = True
        cloud = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))
        u = np.random.default_rng(5).random((batch, cfg.max_planes, cfg.ransac_hypotheses, 3))
        return cfg, cloud, draw_from_uniform(torch.tensor(u.astype(np.float32), device=dev))
    if name == "flagship":
        cfg = FLAGSHIP_CONFIG
        pts = make_scene(seed=0, spec=spec).points
        cloud = Cloud.pad_to(pts[: cfg.max_points], cfg.max_points, device=dev)
    else:
        cfg = REFERENCE_FULLSCALE_CONFIG
        pts, valid = make_fullscale_window(cfg.max_points)
        cloud = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))
    u = np.random.default_rng(5).random((cfg.max_planes, cfg.ransac_hypotheses, 3))
    return cfg, cloud, draw_from_uniform(torch.tensor(u.astype(np.float32), device=dev))


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("flagship", "fullscale"), default="fullscale")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--batch", type=int, default=0,
                    help="B flagship scans a call (0: one scan, no batch axis)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_scan: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from pointcloud_obstacle_processing_tpu_torch import pipeline
    from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = f"[{smi}]"
    dev = torch.device("cuda")
    cfg, cloud, draw = _inputs(args.config, dev, args.batch)
    what = f"{args.config} batch of {args.batch}" if args.batch else args.config
    model = ObstacleDetectionModel(cfg, device=dev)

    # unprofiled p50 first, then the profiler, then the per-stage syncs
    model(cloud, draw=draw)
    walls = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(cloud, draw=draw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    unit = "batches" if args.batch else "scans"
    print(f"{what}: process_scan p50 {statistics.median(walls):.3f} ms over {args.runs} "
          f"{unit} (min {min(walls):.3f}, max {max(walls):.3f}) {card}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profiled):
            model(cloud, draw=draw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name][0] += e.time_range.elapsed_us() / 1e3
            per_kernel[e.name][1] += 1
    dev_ms = sum(v[0] for v in per_kernel.values())
    n_ops = sum(v[1] for v in per_kernel.values())
    n = args.profiled
    one = unit[:-2] if args.batch else unit[:-1]
    print(f"{what}: profiler over {n} {unit}: device time {dev_ms / n:.3f} ms and "
          f"{n_ops / n:.0f} device operations per {one} (wall {wall_ms / n:.3f} ms per profiled "
          f"{one}); device busy {100 * dev_ms / n / statistics.median(walls):.1f}% of the "
          f"unprofiled p50 {card}")
    for name, (ms, cnt) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {ms / n:9.4f} ms {cnt / n:7.1f} calls per {one}  {name[:90]}")

    stage_ms = collections.defaultdict(list)

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    for name in STAGES:
        setattr(pipeline, name, timed(name, getattr(pipeline, name)))
    for _ in range(args.runs + 1):
        model(cloud, draw=draw)
    print(f"{what}: stage wall time with a sync around each stage, p50 of {args.runs} "
          f"{unit} after one warm-up {card}")
    total = 0.0
    for name in sorted(STAGES, key=lambda s: -statistics.median(stage_ms[s][1:])):
        p50 = statistics.median(stage_ms[name][1:])
        total += p50
        print(f"  {name:28s} {p50:9.3f} ms")
    print(f"  {'sum':28s} {total:9.3f} ms")


if __name__ == "__main__":
    main()
