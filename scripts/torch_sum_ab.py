#!/usr/bin/env python3
"""The sum kernel and RANSAC's refinement step of two checkouts of the
PyTorch port, timed in turns on one CUDA card.

    python3 scripts/torch_sum_ab.py --parent _parent --out sum_ab.json

``--parent`` names a directory that holds another checkout's
``pointcloud_obstacle_processing_tpu_torch/`` (for example the parent
commit's, from ``git archive``).  The script runs the parent, this checkout,
this checkout and the parent, each in a process of its own that imports the
package from its checkout and builds that checkout's kernels.  Each run
calls ``ops._xla_sum_kernel`` at every shape a flagship scan, a fullscale
window and the flagship batch of 32 give it (the outlier gate, the kNN and
cluster centerings, the refinement's masked sums and its covariance), holds
each call bitwise against ``sum_like_xla_plain`` and times it (CUDA events
around 20 calls, device time alone from ``torch.profiler``, host time alone
over 200 calls), beside ``.sum(-1)`` of the same values (the library call)
and the bound (each operand row read once, the sums written, at the card's
3.35 TB/s).  Then the refinement step's covariance and 3x3 tail: in a
checkout with ``ops.ransac.covariance_tail`` that call (one launch), in an
older one the covariance sum and ``plane_tail`` (two launches or three).
Then the ``process_scan`` p50 of a flagship scene (20 scans) and of the
fullscale window (5 scans), each scan's device operations and the kernel
launches of one scan.  A checkout whose ``_xla_sum_kernel`` takes a block
count is also timed at 1, 2, 4, 8 and 16 blocks a cluster on the
covariance shapes (``blocks`` lines).  Every line names the card and its
power limit; ``--out FILE`` writes every number as JSON.  It needs a CUDA
card.

    python3 scripts/torch_sum_ab.py --run DIR --label NAME

is one such run, printing its results as one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BLOCK_SWEEP = (1, 2, 4, 8, 16)
# name -> (a shape, b shape or None, strided): every shape a scan gives the sum kernel
SHAPES = {
    "flagship covariance": ((1, 3, 24_576), (1, 3, 24_576), False),
    "fullscale covariance": ((1, 3, 262_144), (1, 3, 262_144), False),
    "batch covariance": ((32, 3, 24_576), (32, 3, 24_576), False),
    "flagship masked sums [1,4,N]": ((1, 4, 24_576), None, False),
    "fullscale masked sums [1,4,N]": ((1, 4, 262_144), None, False),
    "batch masked sums [32,4,N]": ((32, 4, 24_576), None, False),
    "flagship gate [2,N]": ((2, 24_576), None, False),
    "fullscale gate [2,N]": ((2, 262_144), None, False),
    "flagship kNN centering [3,N]": ((3, 24_576), None, False),
    "fullscale kNN centering [3,N]": ((3, 262_144), None, False),
    "flagship cluster centering [3,C] strided": ((3, 1_024), None, True),
    "fullscale cluster centering [3,C] strided": ((3, 16_384), None, True),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(dev, shape_a, shape_b, strided, seed):
    import torch

    rng = np.random.default_rng(seed)
    if strided:  # the clustering's [C, 3] buffer, summed as its transpose
        a = torch.tensor(rng.standard_normal(shape_a[::-1]).astype(np.float32), device=dev).T
    else:
        a = torch.tensor(rng.standard_normal(shape_a).astype(np.float32), device=dev)
    b = None if shape_b is None else torch.tensor(
        rng.standard_normal(shape_b).astype(np.float32), device=dev)
    return a, b


def _tail_args(dev, scans, n, seed):
    """The refinement step's operands: offsets of plane-like points from
    their centroid, the inliers' masked, and the current plane."""
    import torch

    rng = np.random.default_rng(seed)
    pts = torch.tensor(np.stack([rng.uniform(0, 4, (scans, n)), rng.uniform(0, 3, (scans, n)),
                                 rng.normal(0, 0.02, (scans, n))], 1).astype(np.float32),
                       device=dev)
    inl = torch.tensor(rng.random((scans, n)) < 0.8, device=dev)
    n_inl = inl.sum(-1).float()
    cen = torch.where(inl[:, None], pts, 0.0).sum(-1) / n_inl[:, None]
    off = pts - cen[..., None]
    normal = torch.tensor(np.tile([0.0, 0.0, 1.0], (scans, 1)).astype(np.float32), device=dev)
    d = torch.zeros(scans, device=dev)
    return torch.where(inl[:, None], off, 0.0), off, cen, n_inl, normal, d


def run(root: str, label: str) -> dict:
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build, ops
    from pointcloud_obstacle_processing_tpu_torch.models import (
        FLAGSHIP_CONFIG,
        REFERENCE_FULLSCALE_CONFIG,
        ObstacleDetectionModel,
    )
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cs = _chip_smoke()
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs._nvidia_smi()}"
    _build.kernels()
    takes_blocks = "blocks" in inspect.signature(ops._xla_sum_kernel).parameters
    rows, sweep = [], []

    def timed(name, fn, plain, library, n_bytes, n_ops):
        _build.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        plain() if isinstance(got, tuple) else (plain(),)):
            cs._assert_equal(f"{label} {name}", g.view(torch.int32), w.view(torch.int32))
        bound = cs._bound(n_bytes, n_ops)
        row = dict(name=name, launches=launches, ms=cs._time_ms(fn), device_ms=cs._device_ms(fn),
                   host_ms=cs._host_ms(fn), bound_ms=bound[0], bound_by=bound[1],
                   library_ms=None if library is None else cs._time_ms(library),
                   library_device_ms=None if library is None else cs._device_ms(library),
                   library_host_ms=None if library is None else cs._host_ms(library))
        rows.append(row)
        return row

    for i, (name, (sa, sb, strided)) in enumerate(SHAPES.items()):
        a, b = _inputs(dev, sa, sb, strided, i)
        lead, s, n = a[..., 0, 0].numel(), a.shape[-2], a.shape[-1]
        t = 1 if b is None else b.shape[-2]
        lib = (lambda a=a: a.sum(-1)) if b is None else \
            (lambda a=a, b=b: (a[..., :, None, :] * b[..., None, :, :]).sum(-1))
        timed(name, lambda a=a, b=b: ops._xla_sum_kernel(a, b),
              lambda a=a, b=b: ops.sum_like_xla_plain(a, b), lib,
              # each operand row read once, the sums written; a product and an add a term
              lead * (s + (0 if b is None else t)) * n * 4 + lead * s * t * 4,
              lead * s * t * n * (1 if b is None else 2))
        if takes_blocks and "covariance" in name:
            want = ops.sum_like_xla_plain(a, b).view(torch.int32)
            for nb in BLOCK_SWEEP:
                cs._assert_equal(f"{label} {name} blocks {nb}",
                                 ops._xla_sum_kernel(a, b, nb).view(torch.int32), want)
                fn = lambda a=a, b=b, nb=nb: ops._xla_sum_kernel(a, b, nb)  # noqa: E731
                sweep.append(dict(name=name, blocks=nb, ms=cs._time_ms(fn),
                                  device_ms=cs._device_ms(fn)))

    for name, scans, n in (("flagship covariance + tail", 1, 24_576),
                           ("fullscale covariance + tail", 1, 262_144),
                           ("batch covariance + tail", 32, 24_576)):
        args = _tail_args(dev, scans, n, n + scans)
        masked, off, rest = args[0], args[1], args[2:]
        vm = scans > 1

        def plain(masked=masked, off=off, rest=rest, vm=vm):
            return ransac.plane_tail_plain(ops.sum_like_xla_plain(masked, off), *rest, vm)

        if hasattr(ransac, "covariance_tail"):
            fn = lambda args=args, vm=vm: ransac.covariance_tail(*args, vm)  # noqa: E731
        else:
            fn = lambda masked=masked, off=off, rest=rest, vm=vm: ransac.plane_tail(  # noqa: E731
                ops._xla_sum_kernel(masked, off), *rest, vm)
        # six rows read once, 8 floats in and 4 out a scan; the nine sums'
        # products and adds, then the tail's 24 steps of ~50 operations
        timed(name, fn, plain, None, scans * (6 * n + 12) * 4, scans * (9 * n * 2 + 24 * 50))

    scans = {}
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

    scene = make_scene(seed=0, spec=SceneSpec(n_ground=90_000, n_rocks=4, points_per_rock=2_000,
                                              n_noise=500))
    fs_pts, fs_valid = make_fullscale_window(cs.FULLSCALE_POINTS)
    for key, cfg, cloud, reps in (
            ("flagship", FLAGSHIP_CONFIG,
             Cloud.pad_to(scene.points[: FLAGSHIP_CONFIG.max_points], FLAGSHIP_CONFIG.max_points),
             cs.TIMED_SCANS),
            ("fullscale", REFERENCE_FULLSCALE_CONFIG,
             Cloud(points=torch.tensor(fs_pts), valid=torch.tensor(fs_valid)),
             cs.FULLSCALE_TIMED_SCANS)):
        model = ObstacleDetectionModel(cfg, device=dev)
        draw, _ = cs._draws(cfg, dev)
        c = cloud.to(dev)
        _build.reset_launch_counts()
        model(c, draw=draw)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        times = cs._time_scans(model, [c], draw, reps)
        n_ops, dev_ms = cs.scan_device_ops(model, c, draw)
        scans[key] = dict(p50_ms=statistics.median(times), min_ms=min(times), max_ms=max(times),
                          device_ops=n_ops, device_ms=dev_ms, launches=launches)
    return dict(label=label, root=root, card=card, rows=rows, blocks=sweep, scans=scans)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout to compare this one with, in turns")
    ap.add_argument("--run", help="one run: the checkout whose package to time")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", help="JSON file for every run's numbers")
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run(args.run, args.label)))
        return
    pairs = [("change", str(ROOT))]
    if args.parent:
        pairs = [("parent", args.parent), ("change", str(ROOT)), ("change", str(ROOT)),
                 ("parent", args.parent)]
    runs = []
    for label, root in pairs:
        out = subprocess.run([sys.executable, __file__, "--run", root, "--label", label],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
            raise SystemExit(f"torch_sum_ab: the {label} run failed ({out.returncode})")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    ms = _chip_smoke()._ms  # "not measured" where the profiler recorded nothing
    for i, r in enumerate(runs):
        print(f"run {i} {r['label']} [{r['card']}]")
        for key, s in r["scans"].items():
            print(f"  {key} process_scan p50 {s['p50_ms']:.3f} ms (min {s['min_ms']:.3f}, max "
                  f"{s['max_ms']:.3f}); device operations {s['device_ops']} "
                  f"({ms(s['device_ms'])}); launches {s['launches']}")
        for row in r["rows"]:
            lib = row["library_ms"]
            print(f"  {row['name']:42s} call {row['ms']:.4f} ms, device {ms(row['device_ms'])}, "
                  f"host {row['host_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms"
                  + ("" if lib is None else
                     f", .sum(-1) {lib:.4f} ms (device {ms(row['library_device_ms'])}, host "
                     f"{row['library_host_ms']:.4f} ms)") + f"; launches {row['launches']}")
        for row in r["blocks"]:
            print(f"  blocks: {row['name']} at {row['blocks']} blocks a cluster: call "
                  f"{row['ms']:.4f} ms, device {ms(row['device_ms'])}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
