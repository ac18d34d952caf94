"""Euclidean cluster extraction, full sweep (pcl::EuclideanClusterExtraction).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/cluster.py`` with
``band_window=0``: connected components of the "distance <= tolerance"
graph by min-label propagation over the compacted non-plane buffer.

* the cloud is centered; consecutive-rank points within a margin of the
  tolerance seed each run with its head index;
* each sweep computes ``min(label[i], label[label[i]], neighbour labels)``
  (kernel K4, ``csrc/cluster_sweep.cu``; ``sweep_jump_plain`` for CPU
  tensors), then hooks each point's minimum onto its root;
* sweeps repeat until no label changes, at most ``max_iters`` times.  The
  loop reads ``changed.any()`` back to the host once per sweep after the
  first; ``ClusterOutput.host_syncs`` counts those reads.

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
    "ClusterOutput",
]


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


class ClusterOutput(NamedTuple):
    clusters: ClusterSet
    labels: torch.Tensor  # [C] int32 component roots (min index), self for invalid
    root_slot: torch.Tensor  # [C] int32 root index -> slot id or -1
    overflow: torch.Tensor  # [] bool: more gated clusters than max_clusters
    band_overflow: torch.Tensor  # [] bool: always False (full sweep)
    unconverged: torch.Tensor  # [] bool: max_iters hit with changes pending
    host_syncs: int = 0  # device-to-host reads made by the sweep loop


def euclidean_cluster(cloud: Cloud, tolerance: float, min_size: int, max_size: int,
                      max_clusters: int, max_iters: int = 64) -> ClusterOutput:
    """Connected components + size gate + size-descending slot assignment."""
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

    # sweep loop: the first sweep always runs (the reference's loop state
    # starts with every point "changed"); later ones check on the host
    host_syncs = 0
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    for it in range(max_iters):
        nbr_min = sweep_jump(p, valid, labels, tol2)
        # hook: each point's neighbourhood minimum onto its root (scatter-
        # min; the same int32 minima as the reference's one-hot form)
        upd = torch.full((n,), n, dtype=torch.int32, device=dev)
        upd.scatter_reduce_(0, labels.long(), nbr_min, reduce="amin", include_self=True)
        new = torch.minimum(torch.minimum(labels, upd), nbr_min)
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
        band_overflow=torch.zeros((), dtype=torch.bool, device=dev),
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
