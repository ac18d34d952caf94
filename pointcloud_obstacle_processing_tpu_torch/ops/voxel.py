"""VoxelGrid downsampling, sort engine (pcl::VoxelGrid equivalent).

Counterpart of the sort engine of ``pointcloud_obstacle_processing_tpu/ops/
voxel.py``: points bin into leaf-size cubes by ``floor(coord / leaf)``, the
packed lattice key is sorted stably with the voxel-corner-relative offsets
as payloads, and kernel K1 (``ops/runreduce.py``) reduces each run of equal
keys.  The output is one centroid per occupied voxel, in ascending
(ix, iy, iz) order, for the first ``max_voxels`` voxels.  Lattice order and
both payload modes (three float32 offsets, or 16-bit fixed point packed in
two int32 columns) are ported; the dense-bin engines and the Morton order
are not (``PipelineConfig.validate`` refuses them).  Every function takes
one cloud or a batch of them (``[B, N]``, each scan on its own).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import f32, fma, recip32
from ..types import Cloud
from .runreduce import sorted_run_reduce

__all__ = ["voxel_downsample", "voxel_partials", "finalize_voxels", "VoxelResult", "VoxelPartials"]

_I32_MAX = 2**31 - 1


class VoxelResult(NamedTuple):  # a leading [B] on every field for a batch
    cloud: Cloud  # [max_voxels] centroids, key-sorted
    num_voxels: torch.Tensor  # [] int32: true number of occupied voxels
    overflow: torch.Tensor  # [] bool: num_voxels > max_voxels


class VoxelPartials(NamedTuple):  # a leading [B] on every field for a batch
    keys: torch.Tensor  # [cap, 3] int32 voxel coords (INT32_MAX = empty slot)
    sums: torch.Tensor  # [cap, 3] float32 coordinate sums
    counts: torch.Tensor  # [cap] float32 member counts (0 = empty)
    num_voxels: torch.Tensor  # [] int32
    overflow: torch.Tensor  # [] bool


def _pack_spec(bounds, leaf_size: float):
    """Static packing of (ix, iy, iz) into one int32 if the crop-box voxel
    ranges fit: (imin, dims) as Python ints, or None."""
    if bounds is None:
        return None
    (x0, y0, z0), (x1, y1, z1) = bounds
    imin = [math.floor(v / leaf_size) for v in (x0, y0, z0)]
    imax = [math.floor(v / leaf_size) for v in (x1, y1, z1)]
    dims = [max(b - a + 2, 1) for a, b in zip(imin, imax)]  # +1 span, +1 safety
    if dims[0] * dims[1] * dims[2] >= 2**31 - 2:
        return None
    return imin, dims


def _unpack_keys(packed: torch.Tensor, spec):
    """Packed lattice key (clipped to [0, K)) -> absolute (lx, ly, lz)."""
    imin, dims = spec
    lx = torch.div(packed, dims[1] * dims[2], rounding_mode="floor") + imin[0]
    lrem = packed % (dims[1] * dims[2])
    ly = torch.div(lrem, dims[2], rounding_mode="floor") + imin[1]
    lz = lrem % dims[2] + imin[2]
    return lx, ly, lz


def _sort_segment_partials(pts, valid, ijk, imin, dims, leaf_size: float, capacity: int,
                           payload_packing: bool = False) -> VoxelPartials:
    """Stable sort on the packed key + the run-reduce kernel (the reference's
    ``_sort_segment_partials`` with lattice order), each scan of a batch on
    its own: the sort runs along the last axis, so a scan's rows keep the
    order they have alone, and K1 takes the batch in one launch."""
    n = pts.shape[-2]
    if n % 128:
        raise ValueError(
            f"the sort engine needs the point buffer length to be a multiple of 128 (got {n})"
        )
    K = dims[0] * dims[1] * dims[2]
    ix = torch.clamp(ijk[..., 0] - imin[0], 0, dims[0] - 1)
    iy = torch.clamp(ijk[..., 1] - imin[1], 0, dims[1] - 1)
    iz = torch.clamp(ijk[..., 2] - imin[2], 0, dims[2] - 1)
    sentinel = K
    packed = torch.where(valid, (ix * dims[1] + iy) * dims[2] + iz, K).to(torch.int32)

    # corner-relative offsets before the sort: a point's offset in its
    # voxel does not depend on its sorted position
    lf = f32(leaf_size)
    lattice = torch.stack([ix + imin[0], iy + imin[1], iz + imin[2]], dim=-1).to(torch.float32)
    # the reference contracts both multiply-adds of this stage; for these
    # operands (a lattice coordinate times the leaf, times a point count;
    # an offset next to its corner) the float64 sum inside ``fma`` is exact
    off0 = fma(-lattice, lf, pts)  # pts - lattice * leaf, [..., N, 3]
    off0 = torch.where(valid[..., None], off0, torch.zeros_like(off0))

    skey, order = torch.sort(packed, dim=-1, stable=True)
    if payload_packing:
        quantum = leaf_size / 65536.0
        q = f32(65536.0 / leaf_size)
        qx, qy, qz = (torch.clamp((off0[..., c] * q).to(torch.int32), 0, 65535)
                      for c in range(3))
        pxy = (qx << 16) | qy
        slot_vals, num = sorted_run_reduce(
            skey, (pxy.gather(-1, order), qz.gather(-1, order)), sentinel, capacity,
            quantum=quantum,
        )
    else:
        slot_vals, num = sorted_run_reduce(
            skey, tuple(off0[..., c].gather(-1, order) for c in range(3)), sentinel, capacity
        )

    target = torch.arange(capacity, device=pts.device)
    out_valid = target < torch.clamp_max(num, capacity)[..., None]
    slot_key = torch.clamp(slot_vals[..., 0].to(torch.int32), 0, sentinel - 1)
    lx, ly, lz = _unpack_keys(slot_key, (imin, dims))
    slot_counts = slot_vals[..., 4]
    key_cols, sum_cols = [], []
    for ch, l in ((1, lx), (2, ly), (3, lz)):
        key_cols.append(torch.where(out_valid, l, _I32_MAX))
        sum_cols.append(torch.where(
            out_valid, fma(l.to(torch.float32) * lf, slot_counts, slot_vals[..., ch]), 0.0))
    return VoxelPartials(
        keys=torch.stack(key_cols, dim=-1).to(torch.int32),
        sums=torch.stack(sum_cols, dim=-1),
        counts=torch.where(out_valid, slot_counts, 0.0),
        num_voxels=num,
        overflow=num > capacity,
    )


def voxel_partials(cloud: Cloud, leaf_size: float, capacity: int, bounds=None,
                   payload_packing: bool = False) -> VoxelPartials:
    """Per-voxel (key, sum, count), key-sorted, via the sort engine.

    ``bounds`` (the crop box enclosing every valid point) must pack the
    lattice into at most 2^23 bins: the reference's other engines, which
    serve unbounded clouds, are not ported.
    """
    pts = cloud.points
    valid = cloud.valid & torch.isfinite(pts).all(dim=-1)
    # the reference's floor(pts / leaf) as XLA:CPU evaluates it, a product
    # with the reciprocal; clamp before the int cast (a huge coordinate must
    # not wrap)
    ijk = torch.clamp(torch.floor(pts * recip32(leaf_size)), -(2.0**30), 2.0**30).to(torch.int32)
    spec = _pack_spec(bounds, leaf_size)
    if spec is None or spec[1][0] * spec[1][1] * spec[1][2] > (1 << 23):
        raise ValueError(
            "the ported sort engine needs packable bounds with <= 2^23 lattice bins "
            f"(got bounds={bounds!r}, leaf {leaf_size})"
        )
    imin, dims = spec
    return _sort_segment_partials(pts, valid, ijk, imin, dims, leaf_size, capacity,
                                  payload_packing)


def finalize_voxels(partials: VoxelPartials) -> VoxelResult:
    """Partials -> centroid cloud: one reciprocal per voxel, three multiplies
    (the reference's exact operation order)."""
    cap = partials.counts.shape[-1]
    slot = torch.arange(cap, device=partials.counts.device)
    valid = slot < torch.clamp_max(partials.num_voxels, cap)[..., None]
    inv = 1.0 / torch.clamp_min(partials.counts, 1.0)
    centroids = torch.stack([partials.sums[..., c] * inv for c in range(3)], dim=-1)
    return VoxelResult(
        cloud=Cloud(points=centroids, valid=valid),
        num_voxels=partials.num_voxels,
        overflow=partials.overflow,
    )


def voxel_downsample(cloud: Cloud, leaf_size: float, max_voxels: int, bounds=None,
                     payload_packing: bool = False) -> VoxelResult:
    """Downsample to per-voxel centroids (see the module docstring)."""
    return finalize_voxels(
        voxel_partials(cloud, leaf_size, max_voxels, bounds, payload_packing)
    )
