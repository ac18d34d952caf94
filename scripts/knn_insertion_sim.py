#!/usr/bin/env python3
"""How often kernel K3's top-16 selection inserts, under several column
orders, on the CPU.

    python3 scripts/knn_insertion_sim.py --config flagship

K3 keeps each query's 16 smallest squared distances in a sorted list and
inserts any value below the 16th, so its time depends on how many values
arrive below the 16th, which depends on the order it scores the window's
columns in.  On the voxel cloud of the flagship scene (seed 0) or of the
fullscale window, each at its config's leaf, row tile, band and voxel
capacity (``models.FLAGSHIP_CONFIG``, ``REFERENCE_FULLSCALE_CONFIG``), both
in lattice order as the voxel stage emits them,
this replays the selection over six tiles spread along the cloud and
prints, for each order, the insertions a query makes and the share of
(warp, column) steps on which some query of the warp inserts (32
consecutive rows a warp).  The orders: the window's columns in order;
centre-out as K3 takes them (the 256-column chunks covering the tile
first, then left and right chunks in turns); and each query's 32 or 64
rank neighbours first, then either.

The voxel cloud is built here with NumPy (floor(p / leaf), lattice-key
sort, per-voxel means), not by the port's voxel stage, and the distances
are float32 norms of float64 differences: the counts, not the values, are
the point.  Times nothing; needs no card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _voxels(points: np.ndarray, leaf: float) -> np.ndarray:
    """Centered per-voxel means in (ix, iy, iz) lattice order."""
    q = np.floor(points / leaf).astype(np.int64)
    q -= q.min(0)
    key = (q[:, 0] * (q[:, 1].max() + 1) + q[:, 1]) * (q[:, 2].max() + 1) + q[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros((len(uniq), 3))
    np.add.at(sums, inv, points)
    v = (sums / np.bincount(inv)[:, None]).astype(np.float32)
    return v - v.mean(0)


def simulate(vox: np.ndarray, rt: int, band: int, cap: int, centre_out: bool, local: int):
    """(insertions a query, share of warp-steps with an insertion)."""
    from pointcloud_obstacle_processing_tpu_torch.ops.outliers import centre_out_chunks

    nv, width = len(vox), rt + 2 * band
    pts = torch.tensor(vox)
    inserts, queries, hot, steps = 0, 0, 0, 0
    for t in np.linspace(1, nv // rt - 2, 6).astype(int):
        start = min(max(t * rt - band, 0), cap - width)
        cols = torch.arange(start, start + width)
        rows = torch.arange(t * rt, (t + 1) * rt)
        d2 = torch.cdist(pts[rows].double(), pts[cols.clamp(max=nv - 1)].double()).pow(2).float()
        d2[:, cols >= nv] = float("inf")
        d2[rows[:, None] == cols[None, :]] = float("inf")
        top = torch.full((rt, 16), float("inf"))
        seen = torch.zeros(rt, width, dtype=torch.bool)
        if local:
            lo = (rows - start - local // 2).clamp(0, width - local)
            idx = lo[:, None] + torch.arange(local)
            seen.scatter_(1, idx, True)
            top = torch.cat([top, torch.gather(d2, 1, idx)], 1).sort(1).values[:, :16]
        warp = torch.arange(rt) // 32
        off = t * rt - start
        order = ([j for b, e in centre_out_chunks(off, width, rt) for j in range(b, e)]
                 if centre_out else range(width))
        for j in order:
            hit = (d2[:, j] < top[:, 15]) & ~seen[:, j]
            if hit.any():
                h = hit.nonzero()[:, 0]
                top[h] = torch.cat([top[h], d2[h, j, None]], 1).sort(1).values[:, :16]
                inserts += int(hit.sum())
                hot += int(torch.zeros(rt // 32, dtype=torch.bool).index_put_(
                    (warp,), hit, accumulate=True).sum())
            steps += rt // 32
        queries += rt
    return inserts / queries, hot / steps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("flagship", "fullscale"), default="flagship")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from pointcloud_obstacle_processing_tpu_torch.models import (
        FLAGSHIP_CONFIG,
        REFERENCE_FULLSCALE_CONFIG,
    )
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import (
        SceneSpec,
        make_fullscale_window,
        make_scene,
    )

    cfg = FLAGSHIP_CONFIG if args.config == "flagship" else REFERENCE_FULLSCALE_CONFIG
    leaf, rt, band, cap = (cfg.downsample_leaf_size, cfg.knn_row_tile, cfg.knn_band,
                           cfg.max_voxels)
    if args.config == "flagship":
        pts = make_scene(seed=0, spec=SceneSpec(
            n_ground=90_000, n_rocks=4, points_per_rock=2_000, n_noise=500)).points
    else:
        pts, valid = make_fullscale_window(2_097_152)
        pts = pts[valid]
    vox = _voxels(pts, leaf)
    print(f"{args.config}: {len(vox)} voxels, row tile {rt}, window {rt + 2 * band} (CPU)")
    for name, centre, local in (("columns in order", False, 0), ("centre-out", True, 0),
                                ("32 rank neighbours, then in order", False, 32),
                                ("32 rank neighbours, then centre-out", True, 32),
                                ("64 rank neighbours, then centre-out", True, 64)):
        per_query, share = simulate(vox, rt, band, cap, centre, local)
        print(f"  {name:38s} insertions a query {per_query:7.1f}, "
              f"warp-steps with an insertion {share:.3f}")


if __name__ == "__main__":
    main()
