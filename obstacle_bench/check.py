"""The comparison that decides ``correct``.

After the window has closed, the scans the window sampled are worked out
again by the plain reference (``obstacle_bench.reference``, a
frozen copy of the port's plain path, on CPU tensors) from the same input
cloud and the same RANSAC uniforms, and each published output of the
program is held against it.  Every number below is summed over the
compared scans (the centroid gap is their largest), and each has a limit:

* ``grid_cells``: occupancy-grid cells that differ (crop, occupancy,
  shadows, marking);
* ``stage_counts``: stage counts and truncation flags that differ (crop,
  voxel, outliers, RANSAC, compaction, clustering);
* ``plane_words``: plane coefficients (float32 words, bit for bit) and
  plane flags that differ (RANSAC);
* ``obstacle_points``: coordinates of the compacted obstacle cloud and
  their valid flags that differ (compaction);
* ``labels``: obstacle points whose cluster label differs, and centroid
  slots whose valid flag differs (clustering);
* ``centroid_gap``: the largest absolute difference of a centroid's x, y,
  z or radius over slots valid on both sides.

The program's card runs equal the reference bit for bit in everything but
the centroids, so every count's limit is 0; the centroids' limit is the
crosscheck bar the port is held to (1e-5).  ``PERF.md`` gives the readings
each limit was set from: each number reads 0 (the gap under 1e-6) in sound
runs and above its limit under the control.
"""

from __future__ import annotations

import numpy as np
import torch

# stage counts and flags in the order ``run.py`` stacks ``StageStats``
STAT_COUNTS = ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
               "nonplane_points", "num_planes", "num_clusters")
STAT_FLAGS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow", "planes_truncated",
              "cluster_unconverged")

LIMITS = {
    "grid_cells": 0,
    "stage_counts": 0,
    "plane_words": 0,
    "obstacle_points": 0,
    "labels": 0,
    "centroid_gap": 1e-5,
}


def published(result) -> dict:
    """The fields of a ``PipelineResult`` (the port's or the reference's,
    with a leading scan axis) that the benchmark fetches and compares."""
    s = result.stats
    return {
        "grid": result.grid.data,
        "xyzr": result.centroids.points.xyzr,
        "centroid_valid": result.centroids.valid,
        "obstacles": result.obstacle_cloud.points,
        "obstacle_valid": result.obstacle_cloud.valid,
        "labels": result.clusters.point_cluster,
        "plane_coeffs": result.planes.coeffs,
        "plane_valid": result.planes.valid,
        "stats": torch.stack([getattr(s, k).to(torch.int32) for k in STAT_COUNTS + STAT_FLAGS],
                             -1),
    }


def scans_to_compare(rng, batch: int, n: int) -> list[int]:
    """``n`` scans of a request of ``batch``, one drawn from each of ``n``
    equal strata of the batch, so that a sample of two or more holds a scan
    of each half (a batch that leaves half of its scans out fails)."""
    n = min(n, batch)
    edges = [j * batch // n for j in range(n + 1)]
    return [int(rng.integers(edges[j], edges[j + 1])) for j in range(n)]


def reference_scan(fields: dict, points: np.ndarray, valid: np.ndarray,
                   uniforms: np.ndarray) -> dict:
    """The reference's published fields for one scan, as numpy arrays:
    ``points`` [N, 3], ``valid`` [N], ``uniforms`` [rounds, K, 3] (the
    RANSAC draws' uniform numbers).  It runs as a batch of one, the form
    the program's batch takes."""
    from .reference.config import PipelineConfig
    from .reference.ops.ransac import draw_from_uniform
    from .reference.pipeline import process_scan
    from .reference.types import Cloud

    cfg = PipelineConfig(**fields)
    cloud = Cloud(points=torch.from_numpy(np.ascontiguousarray(points))[None],
                  valid=torch.from_numpy(np.ascontiguousarray(valid))[None])
    draw = draw_from_uniform(torch.from_numpy(np.ascontiguousarray(uniforms))[None])
    with torch.no_grad():
        res = process_scan(cloud, cfg, draw=draw)
    return {k: v[0].numpy() for k, v in published(res).items()}


def _words_differ(a: np.ndarray, b: np.ndarray) -> int:
    """float32 words that differ bit for bit."""
    return int((np.ascontiguousarray(a).view(np.int32)
                != np.ascontiguousarray(b).view(np.int32)).sum())


def compare_scan(prog: dict, ref: dict) -> dict:
    """The numbers of the module docstring for one scan."""
    both_planes = prog["plane_valid"] & ref["plane_valid"]
    both_obst = prog["obstacle_valid"] & ref["obstacle_valid"]
    both_cent = prog["centroid_valid"] & ref["centroid_valid"]
    gap = np.abs(prog["xyzr"][both_cent].astype(np.float64) - ref["xyzr"][both_cent])
    return {
        "grid_cells": int((prog["grid"] != ref["grid"]).sum()),
        "stage_counts": int((prog["stats"] != ref["stats"]).sum()),
        "plane_words": _words_differ(prog["plane_coeffs"][both_planes],
                                     ref["plane_coeffs"][both_planes])
        + int((prog["plane_valid"] != ref["plane_valid"]).sum()),
        "obstacle_points": _words_differ(prog["obstacles"][both_obst],
                                         ref["obstacles"][both_obst])
        + int((prog["obstacle_valid"] != ref["obstacle_valid"]).sum()),
        "labels": int((prog["labels"] != ref["labels"]).sum())
        + int((prog["centroid_valid"] != ref["centroid_valid"]).sum()),
        "centroid_gap": float(gap.max()) if gap.size else 0.0,
    }


def combine(readings: list[dict]) -> dict:
    """Counts summed over the compared scans, the centroid gap their
    largest; ``{name: {"value": v, "limit": limit}}``."""
    out = {}
    for name, limit in LIMITS.items():
        values = [r[name] for r in readings]
        value = max(values) if name == "centroid_gap" else sum(values)
        out[name] = {"value": value, "limit": limit}
    return out


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
