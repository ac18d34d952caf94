"""RANSAC perpendicular-plane segmentation (pcl::SACSegmentation).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/ransac.py``: K
batched 3-point hypotheses scored against every point, the best refined by
masked least squares (``setOptimizeCoefficients``), and the multi-plane
removal loop of obstacle_detection.cpp:376-399.

The reference draws its hypotheses from a ``jax.random`` key chain, which
torch cannot reproduce, so the draws are injected: ``segment_planes`` calls
``draw(round, n_valid)`` once per round for a [K, 3] int64 tensor of
indices into the valid points.  The loop runs exactly ``max_planes`` masked
rounds with no host sync; rounds after the reference's ``while_loop`` would
have stopped change nothing.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import f32
from ..config import PipelineConfig
from ..types import Cloud, PlaneModel

__all__ = [
    "ransac_plane_once",
    "segment_planes",
    "draw_from_uniform",
    "PlaneOnceResult",
    "SegmentPlanesResult",
]

Draw = Callable[[int, torch.Tensor], torch.Tensor]


def draw_from_uniform(u: torch.Tensor) -> Draw:
    """Draws from a [rounds, K, 3] tensor of uniform [0, 1) numbers:
    ``floor(u[round] * max(n_valid, 1))``, clamped below ``max(n_valid, 1)``.
    The same ``u`` gives the same draws on every device."""

    def draw(r: int, n_valid: torch.Tensor) -> torch.Tensor:
        hi = torch.clamp_min(n_valid, 1)
        idx = torch.floor(u[r] * hi.to(torch.float32)).to(torch.int64)
        return torch.minimum(idx, (hi - 1).to(torch.int64))

    return draw


def _smallest_eigvec_3x3(cov: torch.Tensor, init: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Smallest eigenvector of a symmetric 3x3 by power iteration on
    ``trace(cov) I - cov``, seeded with ``init``."""
    m = torch.trace(cov) * torch.eye(3, dtype=cov.dtype, device=cov.device) - cov
    v = init
    for _ in range(iters):
        w = m @ v
        nrm = torch.linalg.norm(w)
        v = torch.where(nrm > 1e-20, w / torch.clamp_min(nrm, 1e-20), v)
    return v


class PlaneOnceResult(NamedTuple):
    normal: torch.Tensor  # [3] unit normal
    d: torch.Tensor  # [] plane offset (n·p + d = 0)
    inliers: torch.Tensor  # [N] bool
    found: torch.Tensor  # [] bool


def ransac_plane_once(cloud: Cloud, u: torch.Tensor, config: PipelineConfig,
                      axis=(0.0, 0.0, 1.0)) -> PlaneOnceResult:
    """One plane extraction from the draws ``u`` ([K, 3] indices into the
    valid points, in input order)."""
    pts = cloud.points
    valid = cloud.valid
    thresh = f32(config.plane_segment_dist_thresh)
    eps_angle = f32(config.eps_angle_radians)
    ax = [f32(a) for a in axis]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]

    # valid-first permutation: a draw in [0, n_valid) names a valid point
    perm = torch.sort((~valid).to(torch.int8), stable=True).indices
    n_valid = valid.sum(dtype=torch.int32)
    tri = perm[u]
    i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
    p0x, p0y, p0z = x[i0], y[i0], z[i0]
    p1x, p1y, p1z = x[i1], y[i1], z[i1]
    p2x, p2y, p2z = x[i2], y[i2], z[i2]

    ux, uy, uz = p1x - p0x, p1y - p0y, p1z - p0z
    vx, vy, vz = p2x - p0x, p2y - p0y, p2z - p0z
    nx = uy * vz - uz * vy
    ny = uz * vx - ux * vz
    nz = ux * vy - uy * vx
    norms = torch.sqrt(nx * nx + ny * ny + nz * nz)
    degenerate = norms < f32(1e-12)
    inv = 1.0 / torch.clamp_min(norms, 1e-20)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ds = -(nx * p0x + ny * p0y + nz * p0z)

    cosang = torch.clamp(torch.abs(nx * ax[0] + ny * ax[1] + nz * ax[2]), 0.0, 1.0)
    axis_ok = torch.arccos(cosang) <= eps_angle

    dists = torch.abs(
        x[:, None] * nx[None, :] + y[:, None] * ny[None, :] + z[:, None] * nz[None, :]
        + ds[None, :]
    )  # [N, K]
    inl = (dists < thresh) & valid[:, None]
    counts = inl.sum(dim=0, dtype=torch.int32)
    counts = torch.where(axis_ok & ~degenerate & (n_valid >= 3), counts, -1)

    # the winner is gathered with a 1-element index tensor: indexing with a
    # 0-d tensor would read it back to the host
    best = torch.argmax(counts).reshape(1)
    found = counts[best][0] > 0
    normal = torch.stack([nx, ny, nz])[:, best][:, 0]
    d = ds[best][0]
    inliers = inl[:, best][:, 0]

    # refinement (setOptimizeCoefficients); the reference's lax.cond on
    # ``found`` becomes a select over an unconditional computation
    r_normal, r_d, r_in = normal, d, inliers
    for _ in range(config.ransac_refine_iters):
        w = r_in.to(torch.float32)
        n_inl = w.sum()
        cnt = torch.clamp_min(n_inl, 3.0)
        cx = (x * w).sum() / cnt
        cy = (y * w).sum() / cnt
        cz = (z * w).sum() / cnt
        dx, dy, dz = x - cx, y - cy, z - cz
        qx, qy, qz = dx * w, dy * w, dz * w
        cov = torch.stack([
            torch.stack([(qx * dx).sum(), (qx * dy).sum(), (qx * dz).sum()]),
            torch.stack([(qy * dx).sum(), (qy * dy).sum(), (qy * dz).sum()]),
            torch.stack([(qz * dx).sum(), (qz * dy).sum(), (qz * dz).sum()]),
        ])
        nrm = _smallest_eigvec_3x3(cov, r_normal)
        nrm = nrm * torch.sign((nrm * r_normal).sum() + 1e-30)
        nd = -(nrm[0] * cx + nrm[1] * cy + nrm[2] * cz)
        new_in = (torch.abs(x * nrm[0] + y * nrm[1] + z * nrm[2] + nd) < thresh) & valid
        ok = n_inl >= 3.0
        r_normal = torch.where(ok, nrm, r_normal)
        r_d = torch.where(ok, nd, r_d)
        r_in = torch.where(ok, new_in, r_in)
    normal = torch.where(found, r_normal, normal)
    d = torch.where(found, r_d, d)
    inliers = torch.where(found, r_in, inliers) & found
    return PlaneOnceResult(normal=normal, d=d, inliers=inliers, found=found)


class SegmentPlanesResult(NamedTuple):
    planes: PlaneModel
    nonplane_cloud: Cloud
    plane_union: torch.Tensor  # [N] bool
    last_plane: torch.Tensor  # [N] bool: the reference's indices_cloud
    truncated: torch.Tensor  # [] bool: max_planes stopped the loop


def segment_planes(cloud: Cloud, config: PipelineConfig, draw: Draw,
                   axis=(0.0, 0.0, 1.0)) -> SegmentPlanesResult:
    """Iterative multi-plane removal (cpp:376-399) as ``max_planes`` masked
    rounds.  Round r runs where the reference's loop condition holds:
    more than ``plane_min_remaining_frac`` of the points remain, the last
    round found a plane, and fewer than ``max_planes`` were extracted."""
    n = cloud.capacity
    dev = cloud.device
    max_planes = config.max_planes
    frac = f32(config.plane_min_remaining_frac)
    n0 = cloud.valid.sum(dtype=torch.int32)
    slots = torch.arange(max_planes, device=dev)

    valid = cloud.valid
    coeffs = torch.zeros(max_planes, 4, dtype=torch.float32, device=dev)
    pvalid = torch.zeros(max_planes, dtype=torch.bool, device=dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    found = torch.ones((), dtype=torch.bool, device=dev)
    union = torch.zeros(n, dtype=torch.bool, device=dev)
    last = torch.zeros(n, dtype=torch.bool, device=dev)
    for r in range(max_planes):
        remaining = valid.sum(dtype=torch.int32)
        active = (remaining.to(torch.float32) > frac * n0.to(torch.float32)) & found & (i < max_planes)
        res = ransac_plane_once(Cloud(points=cloud.points, valid=valid), draw(r, remaining),
                                config, axis)
        at_i = slots == i
        row = torch.cat([res.normal, res.d[None]])
        coeffs = torch.where((active & res.found & at_i)[:, None], row[None, :], coeffs)
        pvalid = torch.where(active & at_i, res.found, pvalid)
        valid = torch.where(active, valid & ~res.inliers, valid)
        union = torch.where(active, union | res.inliers, union)
        last = torch.where(active, res.inliers, last)
        i = i + (active & res.found).to(torch.int32)
        found = torch.where(active, res.found, found)
    remaining = valid.sum(dtype=torch.int32)
    truncated = (
        (remaining.to(torch.float32) > frac * n0.to(torch.float32)) & found & (i >= max_planes)
    )
    return SegmentPlanesResult(
        planes=PlaneModel(coeffs=coeffs, valid=pvalid, num_planes=i),
        nonplane_cloud=Cloud(points=cloud.points, valid=valid),
        plane_union=union,
        last_plane=last,
        truncated=truncated,
    )
