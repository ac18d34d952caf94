#!/usr/bin/env python3
"""Kernels of two checkouts of the PyTorch port, and their scans, timed in
turns on one CUDA card: the shadow stage's kernels, RANSAC's round, its
stage and its scoring entry, and the fused multiply-add chain wrapper.

    python3 scripts/torch_shadow_fma_ab.py --parent _parent --out shadow_fma_ab.json

``--parent`` names a directory that holds another checkout's
``pointcloud_obstacle_processing_tpu_torch/`` (for example the parent
commit's, from ``git archive``).  The script runs the parent, this
checkout, this checkout and the parent, each in a process of its own that
imports the package from its checkout and builds that checkout's kernels,
with ``chip_smoke.py``'s timers from this checkout.  Each run times the
measures ``--measures`` names (all by default), each by call ms (CUDA
events around 20 calls), device ms and device operations a call
(``torch.profiler``) and host ms (200 calls issued back to back):

* ``shadow_slots``: ``ops.shadow.shadow_slots`` on ``utils.shadow_cases``'
  seeded inputs, 64 slots, at the flagship (1 x 1,024 cluster points),
  fullscale (1 x 16,384) and batch (32 x 1,024; 32 x 16,384) shapes, held
  bitwise against that package's plain twin on a CPU copy;
* ``shadow_raster``: ``ops.shadow.shadow_raster`` on the seeded slot lines
  (64 slots of a 120 x 101 grid) at the flagship, fullscale and
  batch-of-32 shapes;
* ``round``: ``ops.ransac.ransac_plane_once`` (one round: scoring,
  selection, two refinement passes) on seeded clouds at the flagship (1 x
  24,576 rows), fullscale (1 x 262,144) and batch (32 x 24,576) shapes, K
  = 128, with its peak device memory above the inputs;
* ``dot3``: ``ops.dot3`` at RANSAC's scoring shapes, seeded [B, N, 1]
  points against [B, 1, 128] planes (the wrapper's host ms);
* ``stage``: ``ops.ransac.segment_planes`` on the cloud that enters it in
  the flagship scan (scene 0), the fullscale window and the flagship batch
  of 32, with that run's config and draws: besides the timings above, its
  synced time (p50 of 10 calls, each between two synchronizes, as
  ``scripts/torch_profile_scan.py`` times a stage) and peak device memory;
* ``score``: a round's scoring on the first round's inputs of the same
  three clouds (K = 128, seeded draws): ``score``, the entry the round
  calls (``ransac_hypotheses_score``; in a checkout without it,
  ``ransac_score`` on planes built eagerly beforehand, which also launches
  the winner's mask), and ``score_and_mask``, the hypotheses, their
  scoring and the winner's mask, the same function in both checkouts;

then the ``process_scan`` p50 and the device operations and device time of
one scan: the flagship scenes (20 scans), the fullscale window (5) and the
flagship batch of 32 (10 batches, one ``batched_pipeline`` call a batch).

Outputs are digested, so the two checkouts are seen to agree.  It prints
one line per measure and run, and with ``--out FILE`` writes every number
to FILE as JSON.  Every line names the card and its power limit.  It needs
a CUDA card.

    python3 scripts/torch_shadow_fma_ab.py --run DIR --label NAME

is one such run, printing its results as one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHADOW_SHAPES = {"flagship": (1, 1024), "fullscale": (1, 16_384), "batch": (32, 1024),
                 "batch_fullscale": (32, 16_384)}
SCORING_SHAPES = {"flagship": (1, 24_576), "fullscale": (1, 262_144), "batch": (32, 24_576)}
RASTER_SHAPES = {"flagship": (1, 1024), "fullscale": (1, 16_384), "batch": (32, 1024)}
HYPOTHESES = 128


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _timed(cs, fn) -> dict:
    dev_ms, dev_ops = cs._device_profile(fn)
    return {"ms": cs._time_ms(fn), "device_ms": dev_ms, "device_ops": dev_ops,
            "host_ms": cs._host_ms(fn)}


def _batch_inputs(cs, dev):
    """The flagship batch of 32 as ``chip_smoke.py`` phase 8 builds it:
    8 scenes tiled, a RANSAC draw of its own for each scan."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform

    n = cfg.max_points
    scenes = [cs._scene(s) for s in range(cs.BATCH_SCENES)]
    pts = np.zeros((cs.BATCH, n, 3), np.float32)
    valid = np.zeros((cs.BATCH, n), bool)
    for b in range(cs.BATCH):
        p = scenes[b % cs.BATCH_SCENES].points[:n]
        pts[b, : len(p)] = p
        valid[b, : len(p)] = True
    u = np.random.default_rng(cs.RANSAC_SEED).random(
        (cs.BATCH, cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    clouds = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))
    return clouds, draw_from_uniform(torch.tensor(u, device=dev))


def _peak_mib(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _shadow_slots(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

    out = {}
    for name, (scans, c) in SHADOW_SHAPES.items():
        case = shadow_cases.random_slots(2, scans, c, 64, pose_per_scan=scans > 1)
        args = [torch.tensor(case[k]) for k in ("points", "valid", "point_cluster", "slot_valid")]
        tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
        want = shadow.shadow_slots_plain(*args, tf, cfg)
        on_card = ([a.to(dev) for a in args], tf.to(dev))

        def call(on_card=on_card):
            return shadow.shadow_slots(*on_card[0], on_card[1], cfg)

        cs._assert_equal(f"shadow_slots {name}", call(), want)
        out[name] = {**_timed(cs, call), "digest": _digest(want)}
    return out


def _shadow_raster(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

    out = {}
    for seed, (name, (scans, c)) in enumerate(RASTER_SHAPES.items()):
        case = shadow_cases.random_slots(seed, scans, c, 64, pose_per_scan=scans > 1)
        args = [torch.tensor(case[k]) for k in ("points", "valid", "point_cluster", "slot_valid")]
        tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
        lines = shadow.shadow_slots_plain(*args, tf, cfg).to(dev)
        grid = torch.tensor(np.random.default_rng(3).choice(
            [0, 100], (*lines.shape[:-2], cfg.grid_height, cfg.grid_width)).astype(np.int8),
            device=dev)

        def raster(grid=grid, lines=lines):
            return shadow.shadow_raster(grid, lines, 50)

        out[name] = {**_timed(cs, raster), "digest": _digest(raster()),
                     "active": int(lines[..., 6].sum())}
    return out


def _round(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud
    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    rcfg = cfg.replace(ransac_hypotheses=HYPOTHESES)
    out = {}
    for name, (b, n) in SCORING_SHAPES.items():
        rng = np.random.default_rng(b + n)
        m = n // 2
        pts = np.concatenate([
            np.stack([rng.uniform(0, 4, (b, m)), rng.uniform(0, 3, (b, m)),
                      rng.normal(0, 0.01, (b, m))], -1),
            rng.uniform([0, 0, -0.3], [4, 3, 0.8], (b, n - m, 3))], 1).astype(np.float32)
        valid = rng.random((b, n)) < 0.85
        cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)).to(dev)
        draws = torch.tensor(rng.integers(0, int(valid.sum(-1).min()), (b, HYPOTHESES, 3)),
                             device=dev)

        def one_round(cloud=cloud, draws=draws):
            return ransac.ransac_plane_once(cloud, draws, rcfg, vmapped=True)

        res = one_round()
        out[name] = {**_timed(cs, one_round), "peak_mib": _peak_mib(one_round),
                     "digest": _digest(torch.cat([res.normal.view(-1), res.d.view(-1),
                                                  res.inliers.view(-1).float()]))}
    return out


def _dot3(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch import ops

    g = torch.Generator().manual_seed(0)
    out = {}
    for name, (b, n) in SCORING_SHAPES.items():
        pts = [torch.rand(b, n, 1, generator=g).to(dev) * 8 for _ in range(3)]
        planes = [torch.randn(b, 1, HYPOTHESES, generator=g).to(dev) for _ in range(3)]
        args = (*pts, *planes)
        out[name] = {**_timed(cs, lambda args=args: ops.dot3(*args)),
                     "digest": _digest(ops.dot3(*args))}
    return out


def _stage_inputs(cs, dev) -> dict:
    """The arguments of ``segment_planes`` in the flagship scan of scene 0,
    the fullscale window and the flagship batch of 32, captured from one run
    of each."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud, pipeline
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs
    from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    def capture(run):
        seen, fn = [], pipeline.segment_planes
        pipeline.segment_planes = lambda *a, **kw: seen.append((a, kw)) or fn(*a, **kw)
        try:
            run()
        finally:
            pipeline.segment_planes = fn
        return seen[0]

    draw, _ = cs._draws(fl, dev)
    cloud = Cloud.pad_to(cs._scene(cs.SCENE_SEEDS[0]).points[: fl.max_points],
                         fl.max_points).to(dev)
    out = {"flagship": capture(lambda: ObstacleDetectionModel(fl, device=dev)(cloud, draw=draw))}
    draw, _ = cs._draws(fs, dev)
    pts, valid = make_fullscale_window(cs.FULLSCALE_POINTS)
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)).to(dev)
    out["fullscale"] = capture(lambda: ObstacleDetectionModel(fs, device=dev)(cloud, draw=draw))
    clouds, draw = _batch_inputs(cs, dev)
    out["batch"] = capture(lambda: batched_pipeline(fl)(clouds, draw=draw))
    return out


def _synced_ms(fn, reps: int = 10) -> float:
    import time

    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _stage(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    out = {}
    for name, (args, kw) in _stage_inputs(cs, dev).items():
        def stage(args=args, kw=kw):
            return ransac.segment_planes(*args, **kw)

        res = stage()
        out[name] = {**_timed(cs, stage), "synced_ms": _synced_ms(stage),
                     "peak_mib": _peak_mib(stage),
                     "digest": _digest(torch.cat([res.planes.coeffs.view(-1),
                                                  res.nonplane_cloud.valid.view(-1).float(),
                                                  res.last_plane.view(-1).float()]))}
    return out


def _eager_hypotheses(points, tri, n_valid, eps):
    """The hypotheses as the round built them eagerly before the score
    kernel took them in: the cross product, norm and offset through
    ``ops.fma``/``add_sq3``/``dot3`` launches, the axis gate through
    ``torch.arccos``."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import add_sq3, dot3, f32, fma, sqrt32

    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def g(v, idx):
        return v.gather(-1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)

    (p0x, p0y, p0z), (p1x, p1y, p1z), (p2x, p2y, p2z) = (
        (g(x, tri[..., v]), g(y, tri[..., v]), g(z, tri[..., v])) for v in range(3))
    ux, uy, uz = p1x - p0x, p1y - p0y, p1z - p0z
    vx, vy, vz = p2x - p0x, p2y - p0y, p2z - p0z
    nx, ny, nz = fma(uy, vz, -(uz * vy)), fma(uz, vx, -(ux * vz)), fma(ux, vy, -(uy * vx))
    norms = sqrt32(add_sq3(nx, ny, nz))
    inv = 1.0 / torch.clamp_min(norms, 1e-20)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ds = -dot3(nx, ny, nz, p0x, p0y, p0z)
    cosang = torch.clamp(torch.abs(nx * f32(0.0) + ny * f32(0.0) + nz * f32(1.0)), 0.0, 1.0)
    gate = (torch.arccos(cosang) <= f32(eps)) & ~(norms < f32(1e-12)) & (n_valid >= 3)[:, None]
    return nx, ny, nz, ds, gate


def _score(cs, dev) -> dict:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import f32, ransac

    out = {}
    for name, (args, _) in _stage_inputs(cs, dev).items():
        cloud, cfg = args[0], args[1]
        points, valid = cloud.points, cloud.valid
        if points.dim() == 2:
            points, valid = points[None], valid[None]
        points, valid = points.contiguous(), valid.contiguous()
        n_valid = valid.sum(-1, dtype=torch.int32)
        u = np.random.default_rng(0).random((valid.shape[0], HYPOTHESES, 3))
        u = torch.tensor(u * n_valid.cpu().numpy()[:, None, None], device=dev).long()
        perm = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
        tri = perm.gather(-1, u.reshape(u.shape[0], -1)).reshape(u.shape)
        thresh, eps = f32(cfg.plane_segment_dist_thresh), cfg.eps_angle_radians
        if hasattr(ransac, "ransac_hypotheses_score"):
            cos_min = ransac.axis_cos_min(eps)

            def score():
                return ransac.ransac_hypotheses_score(points, valid, tri, n_valid, thresh,
                                                      cos_min)

            def score_and_mask():
                s = score()
                return s.found, s.normal, s.d, ransac.plane_inliers(points, valid, s.normal, s.d,
                                                                    thresh)
        else:
            planes = _eager_hypotheses(points, tri, n_valid, eps)

            def score():
                return ransac.ransac_score(points, valid, *planes, thresh)

            def score_and_mask():
                s = ransac.ransac_score(points, valid, *_eager_hypotheses(points, tri, n_valid,
                                                                          eps), thresh)
                return s.found, s.normal, s.d, s.inliers

        found, normal, d, mask = score_and_mask()
        digest = _digest(torch.cat([found.float(), normal.view(-1), d, mask.view(-1).float()]))
        out[name] = {**_timed(cs, score), "digest": digest}
        out[f"{name}_with_hypotheses_and_mask"] = {**_timed(cs, score_and_mask), "digest": digest}
    return out


MEASURES = {"shadow_slots": _shadow_slots, "shadow_raster": _shadow_raster, "round": _round,
            "dot3": _dot3, "stage": _stage, "score": _score}


def run(root: str, label: str, measures: list[str]) -> dict:
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs
    from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_shadow_fma_ab: no CUDA device")
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs._nvidia_smi()}"
    _build.kernels()
    out = {"label": label, "root": root, "card": card, "scan": {}}
    for what in measures:
        out[what] = MEASURES[what](cs, dev)

    model = ObstacleDetectionModel(fl, device=dev)
    draw, _ = cs._draws(fl, dev)
    clouds = [Cloud.pad_to(cs._scene(s).points[: fl.max_points], fl.max_points).to(dev)
              for s in cs.SCENE_SEEDS]
    ops_, dev_ms = cs.scan_device_ops(model, clouds[0], draw)
    out["scan"]["flagship"] = {
        "p50_ms": statistics.median(cs._time_scans(model, clouds, draw, cs.TIMED_SCANS)),
        "device_ops": ops_, "device_ms": dev_ms}
    model = ObstacleDetectionModel(fs, device=dev)
    draw, _ = cs._draws(fs, dev)
    pts, valid = make_fullscale_window(cs.FULLSCALE_POINTS)
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)).to(dev)
    ops_, dev_ms = cs.scan_device_ops(model, cloud, draw)
    out["scan"]["fullscale"] = {
        "p50_ms": statistics.median(cs._time_scans(model, [cloud], draw,
                                                   cs.FULLSCALE_TIMED_SCANS)),
        "device_ops": ops_, "device_ms": dev_ms}
    clouds, draw = _batch_inputs(cs, dev)
    pipe = batched_pipeline(fl)

    def batch(c, draw):
        return pipe(c, draw=draw)

    ops_, dev_ms = cs.scan_device_ops(batch, clouds, draw)
    out["scan"]["batch"] = {
        "p50_ms": statistics.median(cs._time_scans(batch, [clouds], draw, cs.BATCH_TIMED)),
        "device_ops": ops_, "device_ms": dev_ms}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout to compare this one with, in turns")
    ap.add_argument("--run", help="one run: the checkout whose package to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="JSON file for every run's numbers")
    ap.add_argument("--measures", default=",".join(MEASURES),
                    help=f"comma-separated, of {', '.join(MEASURES)} (default: all)")
    args = ap.parse_args()
    measures = args.measures.split(",")
    if not set(measures) <= set(MEASURES):
        ap.error(f"--measures: of {', '.join(MEASURES)}")
    if args.run:
        print(json.dumps(run(args.run, args.label, measures)))
        return
    if not args.parent:
        ap.error("give --parent DIR (or --run DIR)")
    runs = []
    for label, root in (("parent", args.parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", args.parent)):
        res = subprocess.run([sys.executable, __file__, "--run", root, "--label", label,
                              "--measures", args.measures],
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise SystemExit(f"torch_shadow_fma_ab: the {label} run failed ({res.returncode})")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    ms = _chip_smoke()._ms  # "not measured" where the profiler recorded nothing
    for i, r in enumerate(runs):
        for what in measures:
            for name, v in r[what].items():
                extra = f", peak {v['peak_mib']:.1f} MiB" if "peak_mib" in v else ""
                extra += f", synced {v['synced_ms']:.4f} ms" if "synced_ms" in v else ""
                print(f"run {i} {r['label']}: {what} {name}: call {v['ms']:.4f} ms, device "
                      f"{ms(v['device_ms'])} in {v['device_ops']} operations, host "
                      f"{v['host_ms']:.4f} ms{extra} (output {v['digest']}) [{r['card']}]")
        for name, v in r["scan"].items():
            print(f"run {i} {r['label']}: process_scan {name} p50 {v['p50_ms']:.3f} ms, device "
                  f"operations {v['device_ops']} ({ms(v['device_ms'])}) [{r['card']}]")
    for what in measures:
        for name in runs[0][what]:
            same = len({r[what][name]["digest"] for r in runs}) == 1
            print(f"{what} {name}: the two checkouts' outputs "
                  f"{'are equal' if same else 'differ'}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
