"""Euclidean cluster extraction (pcl::EuclideanClusterExtraction).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/cluster.py``:
connected components of the "distance <= tolerance" graph by min-label
propagation over the compacted non-plane buffer.

* the cloud is centered; consecutive-rank points within a margin of the
  tolerance seed each run with its head index;
* each sweep computes ``min(label[i], label[label[i]], neighbour labels)``
  (kernel K4, ``csrc/cluster_sweep.cu``; ``sweep_jump_plain`` for CPU
  tensors), then hooks each point's minimum onto its root;
* with ``band_window`` the sweep is banded: query tile t (128 rows) scores
  only the ``band_window`` columns at ``starts[t]`` (``band_starts``, from
  the x envelopes of the lattice-ordered cloud), tiles whose window saw no
  label change in the previous sweep write their labels through, and each
  sweep ends with one full-array pointer jump (kernel K5,
  ``csrc/cluster_sweep_banded.cu``; ``sweep_jump_banded_plain`` for CPU
  tensors);
* sweeps repeat until no label changes, at most ``max_iters`` times.  The
  loop reads ``changed.any()`` back to the host once per sweep after the
  first; ``ClusterOutput.host_syncs`` counts those reads.

The reference tracks the frontier only on its TPU path; the port tracks it
on every device, which is output-identical (see ``sweep_jump_banded``).

Slots are assigned by size descending, ties by smaller root.  The reference
relies on ``lax.top_k`` being stable; ``torch.topk`` is not, so the order
comes from a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import f32
from .. import _build
from ..types import Cloud, ClusterSet, PointIndicesArray, PointWithRad

__all__ = [
    "euclidean_cluster",
    "cluster_centroids",
    "sweep_jump",
    "sweep_jump_plain",
    "band_starts",
    "sweep_jump_banded",
    "sweep_jump_banded_plain",
    "ClusterOutput",
]

BAND_TILE = 128  # query rows per tile of the banded sweep


def _sq3(x, y, z):
    """x*x + y*y + z*z, left to right (the reference's 3-term sums)."""
    return x * x + y * y + z * z


def sweep_jump_plain(p, valid, labels, tol2: float) -> torch.Tensor:
    """Plain PyTorch version of kernel K4 (the reference's ``_xla_sweep_jump``
    contract): min over {label[i]} ∪ {label_col[label[i]]} ∪ neighbours."""
    n = p.shape[0]
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    p_sq = _sq3(x, y, z)
    t2 = f32(tol2)
    labels_col = torch.where(valid, labels, n)
    col_ids = torch.arange(n, device=p.device)
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    for r0 in range(0, n, 256):  # 256-row tiles bound the [T, C] temporaries
        r = slice(r0, min(r0 + 256, n))
        cross = x[r, None] * x[None, :] + y[r, None] * y[None, :] + z[r, None] * z[None, :]
        d2 = (p_sq[r, None] + p_sq[None, :]) - 2.0 * cross
        adj = (d2 <= t2) & valid[None, :] & valid[r, None]
        hit = adj | (labels[r, None] == col_ids[None, :])
        cand = torch.where(hit, labels_col[None, :], n)
        out[r] = torch.minimum(cand.min(dim=1).values, labels[r])
    return out


def sweep_jump(p, valid, labels, tol2: float) -> torch.Tensor:
    """One fused neighbour-min + pointer-jump sweep: kernel K4 for CUDA
    tensors, the plain version for CPU tensors."""
    if p.device.type == "cpu":
        return sweep_jump_plain(p, valid, labels, tol2)
    n = p.shape[0]
    if p.shape != (n, 3) or valid.shape != (n,) or labels.shape != (n,):
        raise ValueError("sweep_jump: points [C, 3], valid [C] and labels [C]")
    x, y, z = (p[:, c].contiguous() for c in range(3))
    p_sq = _sq3(x, y, z)
    _build.require_cuda("sweep_jump", x, y, z, p_sq, valid, labels,
                        dtypes=[torch.float32] * 4 + [torch.bool, torch.int32])
    lib = _build.kernels()
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    err = lib.pcp_cluster_sweep(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), p_sq.data_ptr(), valid.data_ptr(),
        labels.data_ptr(), n, float(np.float32(tol2)), out.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_sweep")
    _build.LAUNCHES["cluster_sweep"] += 1
    return out


def band_starts(p, valid, tile: int, window: int, tolerance: float):
    """Column-window start of each ``tile``-row query tile of the banded
    sweep, and whether some tile's edges reach past its window (the
    reference's ``_band_starts``).

    With the masked prefix max of x (``runmax``) and suffix min
    (``runmin_r``): ``lo(t)`` counts the columns with ``runmax < min_x(t) -
    tol``, ``hi(t)`` is n less the columns with ``runmin_r > max_x(t) +
    tol``; ``start = clamp(lo, 0, n - window)`` aligned down to 128 and
    ``overflow = any(hi - start > window)``.  Max and min are exact, so the
    starts equal the reference's.  Returns (starts [n // tile] int32,
    overflow [] bool).
    """
    n = p.shape[0]
    tiles = n // tile
    tol = f32(tolerance)
    x = p[:, 0]
    runmax = torch.cummax(torch.where(valid, x, -torch.inf), dim=0).values
    runmin_r = torch.cummin(torch.where(valid, x, torch.inf).flip(0), dim=0).values.flip(0)
    xt = x.reshape(tiles, tile)
    vt = valid.reshape(tiles, tile)
    tmin = torch.where(vt, xt, torch.inf).min(dim=1).values
    tmax = torch.where(vt, xt, -torch.inf).max(dim=1).values
    lo = (runmax[None, :] < (tmin - tol)[:, None]).sum(dim=1)
    hi = n - (runmin_r[None, :] > (tmax + tol)[:, None]).sum(dim=1)
    start = torch.clamp(lo, 0, n - window) // 128 * 128
    return start.to(torch.int32), ((hi - start) > window).any()


def sweep_jump_banded_plain(p, valid, labels, tol2: float, tile: int, window: int, starts,
                            tile_live=None) -> torch.Tensor:
    """Plain PyTorch version of kernel K5 (the reference's
    ``_xla_sweep_jump_banded`` contract): for row i of tile t,
    ``min(labels[i], labels_col[j])`` over the window columns j in
    ``[starts[t], starts[t] + window)`` that are neighbours of i or equal
    ``labels[i]``.  Tiles with ``tile_live[t]`` False write ``labels``
    through, as the kernel skips them."""
    n = p.shape[0]
    tiles = n // tile
    dev = p.device
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    p_sq = _sq3(x, y, z)
    t2 = f32(tol2)
    labels_col = torch.where(valid, labels, n)
    w_ids = torch.arange(window, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for t0 in range(0, tiles, 8):  # 8 tiles per [t, T, W] block bound the temporaries
        t1 = min(t0 + 8, tiles)
        cols = starts[t0:t1].long()[:, None] + w_ids  # [t, W]
        rows = slice(t0 * tile, t1 * tile)
        q = [v[rows].reshape(t1 - t0, tile, 1) for v in (x, y, z, p_sq, labels, valid)]
        cross = q[0] * x[cols][:, None, :] + q[1] * y[cols][:, None, :] + q[2] * z[cols][:, None, :]
        d2 = (q[3] + p_sq[cols][:, None, :]) - 2.0 * cross
        adj = (d2 <= t2) & valid[cols][:, None, :] & q[5]
        hit = adj | (q[4] == cols[:, None, :])
        cand = torch.where(hit, labels_col[cols][:, None, :], n)
        out[rows] = torch.minimum(cand.min(dim=2).values, q[4][:, :, 0]).reshape(-1)
    if tile_live is not None:
        out = torch.where(tile_live[:, None].expand(tiles, tile).reshape(n), out, labels)
    return out


def sweep_jump_banded(p, valid, labels, tol2: float, tile: int, window: int, starts,
                      tile_live=None) -> torch.Tensor:
    """One banded neighbour-min + in-window pointer-jump sweep: kernel K5 for
    CUDA tensors, the plain version for CPU tensors.

    A tile is skipped (its labels written through) where ``tile_live`` is
    False or it holds no valid row.  Both skips leave the cluster loop's
    result unchanged: a padding row's sweep value is its own label anyway,
    and for a tile whose window saw no label change the hook that follows
    reads the same minima (the reference's skip note,
    ``_pallas_sweep_jump_banded``)."""
    if p.device.type == "cpu":
        return sweep_jump_banded_plain(p, valid, labels, tol2, tile, window, starts, tile_live)
    n = p.shape[0]
    if tile != BAND_TILE or n % tile or window % 128 or not tile <= window < n:
        raise ValueError(
            f"sweep_jump_banded: needs tile {BAND_TILE}, a capacity divisible by it and "
            f"a window that is a multiple of 128 below the capacity (got tile={tile}, "
            f"window={window}, capacity={n})"
        )
    tiles = n // tile
    if p.shape != (n, 3) or valid.shape != (n,) or labels.shape != (n,) or \
            starts.shape != (tiles,) or (tile_live is not None and tile_live.shape != (tiles,)):
        raise ValueError("sweep_jump_banded: points [C, 3], valid and labels [C], "
                         "starts and tile_live [C / 128]")
    x, y, z = (p[:, c].contiguous() for c in range(3))
    p_sq = _sq3(x, y, z)
    ops = [x, y, z, p_sq, valid, labels, starts]
    dtypes = [torch.float32] * 4 + [torch.bool, torch.int32, torch.int32]
    if tile_live is not None:
        ops.append(tile_live)
        dtypes.append(torch.bool)
    _build.require_cuda("sweep_jump_banded", *ops, dtypes=dtypes)
    lib = _build.kernels()
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    err = lib.pcp_cluster_sweep_banded(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), p_sq.data_ptr(), valid.data_ptr(),
        labels.data_ptr(), starts.data_ptr(),
        None if tile_live is None else tile_live.data_ptr(), n, window,
        float(np.float32(tol2)), out.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_sweep_banded")
    _build.LAUNCHES["cluster_sweep_banded"] += 1
    return out


class ClusterOutput(NamedTuple):
    clusters: ClusterSet
    labels: torch.Tensor  # [C] int32 component roots (min index), self for invalid
    root_slot: torch.Tensor  # [C] int32 root index -> slot id or -1
    overflow: torch.Tensor  # [] bool: more gated clusters than max_clusters
    band_overflow: torch.Tensor  # [] bool: a tile's edges reach past its band window
    unconverged: torch.Tensor  # [] bool: max_iters hit with changes pending
    host_syncs: int = 0  # device-to-host reads made by the sweep loop


def euclidean_cluster(cloud: Cloud, tolerance: float, min_size: int, max_size: int,
                      max_clusters: int, max_iters: int = 64,
                      band_window: int = 0) -> ClusterOutput:
    """Connected components + size gate + size-descending slot assignment.

    ``band_window`` takes the banded sweep where the reference does: a
    window of 128 columns or more, below the capacity, and a capacity
    divisible by 128; otherwise the full sweep runs."""
    pts = cloud.points
    valid = cloud.valid.contiguous()
    n = cloud.capacity
    dev = pts.device
    if max_clusters > n:
        raise ValueError(f"max_clusters={max_clusters} exceeds the cluster capacity {n}")

    denom = torch.clamp_min(valid.sum(dtype=torch.float32), 1.0)
    center = torch.where(valid[:, None], pts, 0.0).sum(dim=0) / denom
    p = torch.where(valid[:, None], pts - center, 0.0)
    tol2 = float(tolerance) ** 2
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    # chain seeding: consecutive-rank points within tolerance (with an
    # absolute margin for the expanded-form error of the sweep's d2) are
    # real edges; seed each run with its head index
    prev = torch.cat([p[:1], p[:-1]])
    dp = p - prev
    gap2 = _sq3(dp[:, 0], dp[:, 1], dp[:, 2])
    prev_valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), valid[:-1]])
    maxsq = torch.where(valid, _sq3(p[:, 0], p[:, 1], p[:, 2]), 0.0).max()
    seed_thresh = f32(tol2 * (1.0 - 1e-6)) - maxsq * (2.0**-20)
    chain = valid & prev_valid & (gap2 <= seed_thresh)
    head = valid & ~chain
    run_head = torch.cummax(torch.where(head, idx, -1), dim=0).values
    labels = torch.where(valid, run_head, idx).to(torch.int32)

    banded = bool(band_window) and BAND_TILE <= band_window < n and n % BAND_TILE == 0
    if banded:
        starts, band_overflow = band_starts(p, valid, BAND_TILE, band_window, tolerance)
        win_hi = (starts + (band_window - 1)).long()
        win_lo = (starts - 1).clamp_min(0).long()
    else:
        band_overflow = torch.zeros((), dtype=torch.bool, device=dev)

    # sweep loop: the first sweep always runs (the reference's loop state
    # starts with every point "changed"); later ones check on the host
    host_syncs = 0
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        if banded:
            # frontier: a tile is live when a label in its window changed
            # in the previous sweep (a prefix-sum difference per window)
            cs = torch.cumsum(changed, dim=0, dtype=torch.int32)
            tile_live = (cs[win_hi] - torch.where(starts > 0, cs[win_lo], 0)) > 0
            nbr_min = sweep_jump_banded(p, valid, labels, tol2, BAND_TILE, band_window, starts,
                                        tile_live)
        else:
            nbr_min = sweep_jump(p, valid, labels, tol2)
        # hook: each point's neighbourhood minimum onto its root (scatter-
        # min; the same int32 minima as the reference's one-hot form)
        upd = torch.full((n,), n, dtype=torch.int32, device=dev)
        upd.scatter_reduce_(0, labels.long(), nbr_min, reduce="amin", include_self=True)
        new = torch.minimum(torch.minimum(labels, upd), nbr_min)
        if banded:
            # window-unlimited pointer jump: a root outside a tile's window
            # is out of the sweep's reach; one full-array jump per sweep
            # keeps the doubling (labels[i] names an in-component point <= i)
            new = torch.minimum(new, new[new.long()])
        changed = new != labels
        labels = new
        if it + 1 < max_iters:
            host_syncs += 1
            if not bool(changed.any()):
                break
    unconverged = changed.any()

    # sizes and the size gate
    sizes_by_root = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    sizes_by_root.scatter_add_(
        0, torch.where(valid, labels, n).long(), torch.ones(n, dtype=torch.int32, device=dev)
    )
    sizes_by_root = sizes_by_root[:n]
    is_root = valid & (labels == idx)
    gate = is_root & (sizes_by_root >= min_size) & (sizes_by_root <= max_size)
    num_total = gate.sum(dtype=torch.int32)

    # slots: size descending, root ascending (stable sort on -size)
    gated_size = torch.where(gate, sizes_by_root, -1)
    top_roots = torch.sort(-gated_size, stable=True).indices[:max_clusters]
    slot_ids = torch.arange(max_clusters, dtype=torch.int32, device=dev)
    slot_valid = slot_ids < torch.clamp_max(num_total, max_clusters)
    root_slot = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    root_slot.scatter_(0, torch.where(slot_valid, top_roots, n), slot_ids)
    root_slot = root_slot[:n]

    point_cluster = torch.where(valid, root_slot[labels.long()], -1)
    slot_sizes = torch.where(slot_valid, sizes_by_root[top_roots], 0)
    clusters = ClusterSet(
        point_cluster=point_cluster,
        sizes=slot_sizes,
        valid=slot_valid,
        num_clusters=torch.clamp_max(num_total, max_clusters),
    )
    return ClusterOutput(
        clusters=clusters,
        labels=labels,
        root_slot=root_slot,
        overflow=num_total > max_clusters,
        band_overflow=band_overflow,
        unconverged=unconverged,
        host_syncs=host_syncs,
    )


def cluster_centroids(cloud: Cloud, clusters: ClusterSet) -> PointIndicesArray:
    """Per-cluster centroid + bounding radius as PointWithRad rows."""
    m = clusters.sizes.shape[0]
    pc = clusters.point_cluster
    slot = torch.arange(m, device=pc.device)
    member = (pc[:, None] == slot[None, :]) & (pc >= 0)[:, None]  # [n, m]
    wm = member.to(torch.float32)
    x, y, z = cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2]
    inv = 1.0 / torch.clamp_min(clusters.sizes.to(torch.float32), 1.0)
    cx = (wm * x[:, None]).sum(dim=0) * inv
    cy = (wm * y[:, None]).sum(dim=0) * inv
    cz = (wm * z[:, None]).sum(dim=0) * inv
    dx = x[:, None] - cx[None, :]
    dy = y[:, None] - cy[None, :]
    dz = z[:, None] - cz[None, :]
    d_all = torch.sqrt(_sq3(dx, dy, dz))
    radii = torch.where(member, d_all, 0.0).max(dim=0).values
    xyzr = torch.stack([cx, cy, cz, radii], dim=-1)
    xyzr = torch.where(clusters.valid[:, None], xyzr, 0.0)
    return PointIndicesArray(points=PointWithRad(xyzr=xyzr), valid=clusters.valid)
