"""The least time an H100 could take for a pipeline stage's work.

A frozen copy of the arithmetic of the port's ``utils/bounds.py``
(``stage_bounds``, ``_bound`` and the peaks its stages use), with three
changes:

* the point streams count the points that are valid in each scan (the
  input's valid points for the crop, the cropped points for the voxel
  stage, the voxel-table rows the voxel stage kept for the kNN), where the
  port's counts the capacities ``max_points`` and ``max_voxels``;
* ``stage_bounds`` takes the counts of every scan of a call and sums the
  scans' bounds;
* the voxel stage counts what the stage must move (each cropped point read
  once, each kept voxel written once), where the port's counts the sort
  engine's radix passes and gathers.

The counts come from the inputs and from the stage counts the call
returned (``StageStats``), never from the shapes a kernel was launched
with, so a share reads the same work whatever kernel implements a stage.
A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the card's memory rate,
and its operations over the card's float32 rate (no stage here does
float64 work).  The cluster stage and the glue are left out: their work
needs the sweep count, which no stage count returns.

The card's published peaks (NVIDIA H100 SXM data sheet, 700 W, dense, no
sparsity); ``run.py`` prints the card's power limit beside every share.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# float32 operations a scored pair of points in the distance kernels: the
# cross term's multiply and two fused multiply-adds; the d2 add, multiply
# and subtract; the compare with the tolerance
D2_OPS = 9

# float32 operations a (point, plane) test in RANSAC: the plane distance's
# three products and three adds, the absolute value, the compare
PLANE_TEST_OPS = 8


def _bound(n_bytes: float, fp32_ops: float = 0.0) -> tuple[float, str]:
    """``(seconds, limiter)``: the larger of the bytes' time and the
    operations' time; ``limiter`` is "bytes" or "operations"."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = fp32_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bounds(cfg, n_valid: int, n_cropped: int, n_voxels: int,
                n_cluster_rows: int) -> dict:
    """``{stage: (seconds, limiter)}`` for one scan: ``n_valid`` valid input
    points, ``n_cropped`` points left by the crop, ``n_voxels`` voxel-table
    rows entering the kNN stage, ``n_cluster_rows`` live rows entering the
    compaction before clustering."""
    V, C = cfg.max_voxels, cfg.cluster_capacity
    H, W = cfg.grid_height, cfg.grid_width
    out = {}

    # crop + seed: the valid points (12 B) and their mask read, the cropped
    # cloud and its mask written; the [H, W] int32 histogram written once
    out["crop"] = _bound(n_valid * 13 * 2 + H * W * 4)

    # voxel: what the stage must move, whatever engine does it: each cropped
    # point (12 B) and its valid flag read once, each kept voxel's centroid
    # (12 B) and valid flag written once.  The sort engine's passes, the
    # permutation and the gathers are one implementation's work, not the
    # stage's, and are left out
    out["voxel"] = _bound(n_cropped * 13 + n_voxels * 13)

    # outlier (the banded kNN): each live query tile scores its rows against
    # its band's window, D2_OPS a pair; the kept rows (17 B) read once, their
    # means written
    T = cfg.knn_row_tile
    Wk = min(T + 2 * cfg.knn_band, V)
    live_tiles = math.ceil(n_voxels / T)
    out["outlier"] = _bound(n_voxels * 17 + n_voxels * 4, live_tiles * T * Wk * D2_OPS)

    # RANSAC: each round scores every hypothesis against every live row in
    # float32, then refines the best; the points (16 B) read twice a round,
    # the inlier mask written
    K, rounds = cfg.ransac_hypotheses, cfg.max_planes
    out["ransac"] = _bound(rounds * n_voxels * (16 * 2 + 1),
                           fp32_ops=float(PLANE_TEST_OPS) * rounds * K * n_voxels)

    # compact: the mask once, the non-plane rows' 4 channels moved
    rows = min(n_cluster_rows, C)
    out["compact"] = _bound(V + rows * (16 + 4 + 16) + 4)
    return out


def stage_bounds(cfg, scans) -> dict:
    """``{stage: seconds}`` summed over ``scans``, an iterable of
    ``(n_valid, n_cropped, n_voxels, n_cluster_rows)`` a scan."""
    total: dict = {}
    for counts in scans:
        for stage, (seconds, _) in scan_bounds(cfg, *counts).items():
            total[stage] = total.get(stage, 0.0) + seconds
    return total
