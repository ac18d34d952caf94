#!/usr/bin/env python3
"""Two checkouts of the PyTorch port, timed in turns on one CUDA card.

    python3 scripts/torch_kernel_ab.py --parent _parent

``--parent`` names a directory that holds another checkout's
``pointcloud_obstacle_processing_tpu_torch/`` (for example the parent
commit's, from ``git archive``).  The script runs the parent, this checkout,
this checkout and the parent, each in a process of its own that imports the
package from its checkout and builds that checkout's kernels.  Each run
takes ``chip_smoke.py``'s kernel checks from this checkout and applies them
to its own package: K1, K2, K3 and the cluster loop (K4) at the flagship
shapes, K1, K2, K3 and K5 at the fullscale shapes, K7 at its documented
shape, each held against that
package's plain version and timed (CUDA events around 20 calls, and device
time alone from ``torch.profiler`` and host time alone, beside the library
call where there is one); then the ``process_scan`` p50 of the flagship scenes (20 scans) and of
the fullscale window (5 scans), the device operations of one scan of each,
and K3 once more on the inputs each scan gives it (its voxel cloud).
A checkout from before the kNN mean was fused into K3 and before the
clustering packed its sweep points is driven through the same calls by
``_adapt``: its K3 row times the selection and ``mean_from_sorted``, the
function the fused kernel computes, its K4 and K5 rows take the points
and |p|^2 apart, as that checkout's cluster loop does, and its cluster
loop row is this checkout's per-sweep loop (``ops.cluster._sweep_loop``)
over that checkout's K4 (one launch, the hook and a host read a sweep).  It prints one line per kernel and run,
and with ``--out FILE`` writes every number to FILE as JSON.  Every line
names the card and its power limit.  It needs a CUDA card.

    python3 scripts/torch_kernel_ab.py --run DIR --label NAME

is one such run, printing its results as one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("name", "path", "shape", "max_abs_err", "ms", "device_ms", "host_ms", "plain_ms",
        "bound_ms", "library_ms", "library_device_ms", "library_host_ms")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _this_cluster():
    """This checkout's ``ops.cluster``, from this checkout's package loaded
    under another name (``_pcp_torch_ab``), so that its imports resolve in
    this checkout whatever package the run times."""
    name = "_pcp_torch_ab"
    if name not in sys.modules:
        pkg = ROOT / "pointcloud_obstacle_processing_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.cluster")


def _adapt(ops):
    """Give an older checkout's ``ops.outliers`` and ``ops.cluster`` the
    calls this checkout's kernel checks make (``knn_mean``,
    ``pack_points``, ``point_channels``, ``cluster_loop``), as stand-ins on
    the ``ops`` package that the modules' own code never sees; returns the
    function that puts the modules back."""
    saved = {name: getattr(ops, name) for name in ("outliers", "cluster")}
    outliers, cluster = saved["outliers"], saved["cluster"]
    if not hasattr(outliers, "knn_mean"):
        def mean(select):
            return lambda pch, p_sq, valid, starts, rt, width, k: outliers.mean_from_sorted(
                select(pch, p_sq, valid, starts, rt, width), k)

        ops.outliers = types.SimpleNamespace(
            **vars(outliers), knn_mean=mean(outliers.knn_select),
            knn_mean_plain=mean(outliers.knn_select_plain))
    if not hasattr(cluster, "cluster_loop"):
        # the loop as such a checkout runs it: this checkout's per-sweep loop
        # (one K4 launch a sweep, the hook in PyTorch, a host read of the
        # change test after each sweep) over that checkout's sweeps
        here = _this_cluster()

        def loop(sweep):
            def run_loop(pk, valid, labels, tol2, max_iters):
                pch = cluster.point_channels(pk[:, :3], pk[:, 3])
                return here._sweep_loop(lambda lab: sweep(pch, valid, lab, tol2), labels,
                                        max_iters)
            return run_loop

        cluster = types.SimpleNamespace(**vars(cluster), cluster_loop=loop(cluster.sweep_jump),
                                        cluster_loop_plain=loop(cluster.sweep_jump_plain))
        ops.cluster = cluster
    if not hasattr(cluster, "pack_points"):
        def split(fn):
            return lambda pk, *a: fn(pk[0], *a, p_sq=pk[1])

        ops.cluster = types.SimpleNamespace(**{
            **vars(cluster),
            "pack_points": lambda p, p_sq=None: (p, p_sq),
            "point_channels": lambda p, p_sq=None: (p, p_sq),
            **{name: split(getattr(cluster, name)) for name in (
                "sweep_jump", "sweep_jump_plain", "sweep_jump_banded", "sweep_jump_banded_plain")},
        })

    def restore():
        for name, module in saved.items():
            setattr(ops, name, module)

    return restore


def _scan_k3_args(cs, model, cloud, draw, k: int) -> tuple:
    """K3's operands in one scan, taken from the kNN stage's own call (the
    fused ``knn_mean`` or, in an older checkout, ``knn_select``)."""
    module = sys.modules["pointcloud_obstacle_processing_tpu_torch.ops.outliers"]
    if hasattr(module, "knn_mean"):
        return cs.capture_k3_args(model, cloud, draw)
    return (*cs.capture_k3_args(model, cloud, draw, "knn_select"), k)


def run(root: str, label: str) -> dict:
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs
    from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel
    from pointcloud_obstacle_processing_tpu_torch import ops as ops_pkg
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cs = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs._nvidia_smi()}"
    _build.kernels()
    restore = _adapt(ops_pkg)
    rng = np.random.default_rng(0)
    rows = [
        cs.check_k1(dev, rng, "flagship", fl.max_points, fl.max_voxels, 90_000, 21_500, 230_000,
                    fl.downsample_leaf_size),
        cs.check_k2(dev, rng, "flagship", fl.max_voxels, fl.cluster_capacity, 0.025),
        cs.check_k3(dev, rng, "flagship", fl.max_voxels, 21_500, fl.knn_row_tile, fl.knn_band,
                    fl.statistical_outlier_mean_k),
        cs.check_loop(dev, rng, "flagship", fl.cluster_capacity, 600,
                      fl.euc_cluster_tolerance ** 2, fl.cluster_max_iters),
        cs.check_k1(dev, rng, "fullscale", fs.max_points, fs.max_voxels, 2_000_000, 166_000,
                    3_988_816, fs.downsample_leaf_size),
        cs.check_k2(dev, rng, "fullscale", fs.max_voxels, fs.cluster_capacity,
                    7_000 / fs.max_voxels),
        cs.check_k3(dev, rng, "fullscale", fs.max_voxels, 166_000, fs.knn_row_tile, fs.knn_band,
                    fs.statistical_outlier_mean_k),
        *cs.check_k5(dev, rng, "fullscale", fs.cluster_capacity, 7_000, fs.cluster_band_window,
                     fs.euc_cluster_tolerance),
        cs.check_k7(dev, *cs.binning_inputs(dev, rng)),
    ]
    restore()

    p50, ops = {}, {}
    model = ObstacleDetectionModel(fl, device=dev)
    draw, _ = cs._draws(fl, dev)
    clouds = [Cloud.pad_to(cs._scene(s).points[: fl.max_points], fl.max_points).to(dev)
              for s in cs.SCENE_SEEDS]
    p50["flagship"] = statistics.median(cs._time_scans(model, clouds, draw, cs.TIMED_SCANS))
    ops["flagship"] = cs.scan_device_ops(model, clouds[0], draw)
    scan_k3 = [("flagship",
                _scan_k3_args(cs, model, clouds[0], draw, fl.statistical_outlier_mean_k))]
    model = ObstacleDetectionModel(fs, device=dev)
    draw, _ = cs._draws(fs, dev)
    pts, valid = make_fullscale_window(cs.FULLSCALE_POINTS)
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)).to(dev)
    p50["fullscale"] = statistics.median(
        cs._time_scans(model, [cloud], draw, cs.FULLSCALE_TIMED_SCANS))
    ops["fullscale"] = cs.scan_device_ops(model, cloud, draw)
    scan_k3.append(("fullscale",
                    _scan_k3_args(cs, model, cloud, draw, fs.statistical_outlier_mean_k)))
    restore = _adapt(ops_pkg)
    for path, args in scan_k3:
        rows.append(cs._k3_row(path, "the scan's voxel cloud", args))
    restore()
    return {"label": label, "root": root, "card": card, "scan_p50_ms": p50,
            "scan_device_ops": ops,
            "rows": [{k: r[k] for k in KEYS} for r in rows]}


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
    if not args.parent:
        ap.error("give --parent DIR (or --run DIR)")
    runs = []
    for label, root in (("parent", args.parent), ("change", str(ROOT)), ("change", str(ROOT)),
                        ("parent", args.parent)):
        out = subprocess.run([sys.executable, __file__, "--run", root, "--label", label],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
            raise SystemExit(f"torch_kernel_ab: the {label} run failed ({out.returncode})")
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    ms = _chip_smoke()._ms  # "not measured" where the profiler recorded nothing
    for i, r in enumerate(runs):
        p50, ops = r["scan_p50_ms"], r["scan_device_ops"]
        print(f"run {i} {r['label']}: process_scan p50 flagship {p50['flagship']:.3f} ms, "
              f"fullscale {p50['fullscale']:.3f} ms; device operations per scan flagship "
              f"{ops['flagship'][0]} ({ms(ops['flagship'][1])}), fullscale "
              f"{ops['fullscale'][0]} ({ms(ops['fullscale'][1])}) [{r['card']}]")
        for row in r["rows"]:
            lib = row["library_ms"]
            print(f"  {row['name']:20s} {row['path']:9s} call {row['ms']:.4f} ms, device "
                  f"{ms(row['device_ms'])}, host {row['host_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms"
                  + ("" if lib is None else
                     f", library {lib:.4f} ms (device {ms(row['library_device_ms'])}, "
                     f"host {row['library_host_ms']:.4f} ms)")
                  + f"  [{row['shape']}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
