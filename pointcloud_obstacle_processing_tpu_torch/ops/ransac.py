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

Every function also takes a batch of clouds (``[B, N]``): each scan keeps
its own round state (``i``, ``found``, ``active`` are ``[B]``), the draw
gets ``n_valid`` [B] and returns [B, K, 3], and the hypotheses are scored
as one ``[B, N, K]`` table.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import add_sq3, dot3, f32, fma, sqrt32
from ..config import PipelineConfig
from ..types import Cloud, PlaneModel, batch_of, scan_of

__all__ = [
    "ransac_plane_once",
    "segment_planes",
    "draw_from_uniform",
    "PlaneOnceResult",
    "SegmentPlanesResult",
]

Draw = Callable[[int, torch.Tensor], torch.Tensor]


def draw_from_uniform(u: torch.Tensor) -> Draw:
    """Draws from a [rounds, K, 3] tensor of uniform [0, 1) numbers, or a
    [B, rounds, K, 3] one for a batch: ``floor(u[..., round, :, :] *
    max(n_valid, 1))``, clamped below ``max(n_valid, 1)``, each scan with
    its own ``n_valid``.  The same ``u`` gives the same draws on every
    device."""

    def draw(r: int, n_valid: torch.Tensor) -> torch.Tensor:
        hi = torch.clamp_min(n_valid, 1)[..., None, None]
        idx = torch.floor(u[..., r, :, :] * hi.to(torch.float32)).to(torch.int64)
        return torch.minimum(idx, (hi - 1).to(torch.int64))

    return draw


def _smallest_eigvec_3x3(cov: torch.Tensor, init: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Smallest eigenvector of each symmetric 3x3 ``cov`` [..., 3, 3] by
    power iteration on ``trace(cov) I - cov``, seeded with ``init`` [..., 3]."""
    trace = cov.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    m = trace[..., None, None] * torch.eye(3, dtype=cov.dtype, device=cov.device) - cov
    v = init
    for _ in range(iters):
        w = (m @ v[..., None])[..., 0]
        nrm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = torch.where(nrm > 1e-20, w / torch.clamp_min(nrm, 1e-20), v)
    return v


def _plane_dist(x, y, z, nx, ny, nz, d) -> torch.Tensor:
    """Signed point-plane distance ``x*nx + y*ny + z*nz + d`` as XLA:CPU
    evaluates the reference's scoring and refinement: the first product
    fused into the first add, the third into the second, then the offset,
    ``fma(z, nz, fma(x, nx, y * ny)) + d``.  An inlier decision at the
    threshold follows this rounding (tests/test_torch_ransac.py probes it
    at the threshold and 1, 2 and 8 ulps either side)."""
    return dot3(x, y, z, nx, ny, nz) + d


class PlaneOnceResult(NamedTuple):  # a leading [B] on every field for a batch
    normal: torch.Tensor  # [3] unit normal
    d: torch.Tensor  # [] plane offset (n·p + d = 0)
    inliers: torch.Tensor  # [N] bool
    found: torch.Tensor  # [] bool


def ransac_plane_once(cloud: Cloud, u: torch.Tensor, config: PipelineConfig,
                      axis=(0.0, 0.0, 1.0)) -> PlaneOnceResult:
    """One plane extraction from the draws ``u`` ([K, 3] indices into the
    valid points, in input order), or one a scan from [B, K, 3] draws over
    a batch of clouds."""
    cloud, single = batch_of(cloud)
    res = _plane_once(cloud, u[None] if single else u, config, axis)
    return scan_of(res) if single else res


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x [B, N] and idx [B, ...]."""
    return x.gather(-1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _plane_once(cloud: Cloud, u: torch.Tensor, config: PipelineConfig, axis) -> PlaneOnceResult:
    """``ransac_plane_once`` over a batch: cloud [B, N], draws [B, K, 3]."""
    pts = cloud.points
    valid = cloud.valid
    thresh = f32(config.plane_segment_dist_thresh)
    eps_angle = f32(config.eps_angle_radians)
    ax = [f32(a) for a in axis]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]  # [B, N]

    # valid-first permutation: a draw in [0, n_valid) names a valid point
    perm = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    tri = _gather(perm, u)  # [B, K, 3]
    i0, i1, i2 = tri[..., 0], tri[..., 1], tri[..., 2]
    p0x, p0y, p0z = _gather(x, i0), _gather(y, i0), _gather(z, i0)
    p1x, p1y, p1z = _gather(x, i1), _gather(y, i1), _gather(z, i1)
    p2x, p2y, p2z = _gather(x, i2), _gather(y, i2), _gather(z, i2)

    ux, uy, uz = p1x - p0x, p1y - p0y, p1z - p0z
    vx, vy, vz = p2x - p0x, p2y - p0y, p2z - p0z
    # cross product, norm and offset as XLA:CPU contracts the reference's
    # expressions (bitwise equal to it: tests/test_torch_ransac.py)
    nx = fma(uy, vz, -(uz * vy))
    ny = fma(uz, vx, -(ux * vz))
    nz = fma(ux, vy, -(uy * vx))
    norms = sqrt32(add_sq3(nx, ny, nz))
    degenerate = norms < f32(1e-12)
    inv = 1.0 / torch.clamp_min(norms, 1e-20)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ds = -dot3(nx, ny, nz, p0x, p0y, p0z)  # [B, K]

    cosang = torch.clamp(torch.abs(nx * ax[0] + ny * ax[1] + nz * ax[2]), 0.0, 1.0)
    axis_ok = torch.arccos(cosang) <= eps_angle

    dists = torch.abs(_plane_dist(x[..., None], y[..., None], z[..., None],
                                  nx[:, None, :], ny[:, None, :], nz[:, None, :],
                                  ds[:, None, :]))  # [B, N, K]
    inl = (dists < thresh) & valid[..., None]
    counts = inl.sum(dim=-2, dtype=torch.int32)
    counts = torch.where(axis_ok & ~degenerate & (n_valid >= 3)[:, None], counts, -1)

    # the winner of each scan, gathered with an index tensor: indexing with
    # a 0-d tensor would read it back to the host
    best = torch.argmax(counts, dim=-1, keepdim=True)  # [B, 1]
    found = counts.gather(-1, best)[:, 0] > 0
    normal = torch.stack([nx, ny, nz], dim=-1).gather(1, best[..., None].expand(-1, 1, 3))[:, 0]
    d = ds.gather(-1, best)[:, 0]
    inliers = inl.gather(-1, best[:, None, :].expand(-1, inl.shape[1], 1))[..., 0]

    # refinement (setOptimizeCoefficients); the reference's lax.cond on
    # ``found`` becomes a select over an unconditional computation
    r_normal, r_d, r_in = normal, d, inliers
    for _ in range(config.ransac_refine_iters):
        w = r_in.to(torch.float32)
        n_inl = w.sum(dim=-1)
        cnt = torch.clamp_min(n_inl, 3.0)
        cx = (x * w).sum(dim=-1) / cnt
        cy = (y * w).sum(dim=-1) / cnt
        cz = (z * w).sum(dim=-1) / cnt
        dx, dy, dz = x - cx[:, None], y - cy[:, None], z - cz[:, None]
        qx, qy, qz = dx * w, dy * w, dz * w
        cov = torch.stack([
            torch.stack([(qx * dx).sum(-1), (qx * dy).sum(-1), (qx * dz).sum(-1)], dim=-1),
            torch.stack([(qy * dx).sum(-1), (qy * dy).sum(-1), (qy * dz).sum(-1)], dim=-1),
            torch.stack([(qz * dx).sum(-1), (qz * dy).sum(-1), (qz * dz).sum(-1)], dim=-1),
        ], dim=-2)  # [B, 3, 3]
        nrm = _smallest_eigvec_3x3(cov, r_normal)
        nrm = nrm * torch.sign((nrm * r_normal).sum(dim=-1, keepdim=True) + 1e-30)
        nd = -(nrm[:, 0] * cx + nrm[:, 1] * cy + nrm[:, 2] * cz)
        new_in = (torch.abs(_plane_dist(x, y, z, nrm[:, 0, None], nrm[:, 1, None],
                                        nrm[:, 2, None], nd[:, None])) < thresh) & valid
        ok = n_inl >= 3.0
        r_normal = torch.where(ok[:, None], nrm, r_normal)
        r_d = torch.where(ok, nd, r_d)
        r_in = torch.where(ok[:, None], new_in, r_in)
    normal = torch.where(found[:, None], r_normal, normal)
    d = torch.where(found, r_d, d)
    inliers = torch.where(found[:, None], r_in, inliers) & found[:, None]
    return PlaneOnceResult(normal=normal, d=d, inliers=inliers, found=found)


class SegmentPlanesResult(NamedTuple):  # a leading [B] on every field for a batch
    planes: PlaneModel
    nonplane_cloud: Cloud
    plane_union: torch.Tensor  # [N] bool
    last_plane: torch.Tensor  # [N] bool: the reference's indices_cloud
    truncated: torch.Tensor  # [] bool: max_planes stopped the loop


def segment_planes(cloud: Cloud, config: PipelineConfig, draw: Draw,
                   axis=(0.0, 0.0, 1.0)) -> SegmentPlanesResult:
    """Iterative multi-plane removal (cpp:376-399) as ``max_planes`` masked
    rounds.  Round r runs, in each scan, where the reference's loop
    condition holds there: more than ``plane_min_remaining_frac`` of the
    points remain, the last round found a plane, and fewer than
    ``max_planes`` were extracted.  ``draw(r, n_valid)`` gets each scan's
    remaining count (``[]`` for one cloud, ``[B]`` for a batch) and returns
    [K, 3] or [B, K, 3] indices."""
    cloud, single = batch_of(cloud)
    if single:
        one_draw = draw
        draw = lambda r, n_valid: one_draw(r, n_valid[0])[None]  # noqa: E731
    res = _segment_planes(cloud, config, draw, axis)
    return scan_of(res) if single else res


def _segment_planes(cloud: Cloud, config: PipelineConfig, draw: Draw, axis) -> SegmentPlanesResult:
    b, n = cloud.valid.shape
    dev = cloud.device
    max_planes = config.max_planes
    frac = f32(config.plane_min_remaining_frac)
    n0 = cloud.valid.sum(dim=-1, dtype=torch.int32)
    slots = torch.arange(max_planes, device=dev)

    valid = cloud.valid
    coeffs = torch.zeros(b, max_planes, 4, dtype=torch.float32, device=dev)
    pvalid = torch.zeros(b, max_planes, dtype=torch.bool, device=dev)
    i = torch.zeros(b, dtype=torch.int32, device=dev)
    found = torch.ones(b, dtype=torch.bool, device=dev)
    union = torch.zeros(b, n, dtype=torch.bool, device=dev)
    last = torch.zeros(b, n, dtype=torch.bool, device=dev)
    for r in range(max_planes):
        remaining = valid.sum(dim=-1, dtype=torch.int32)
        active = (remaining.to(torch.float32) > frac * n0.to(torch.float32)) & found & (i < max_planes)
        res = _plane_once(Cloud(points=cloud.points, valid=valid), draw(r, remaining),
                          config, axis)
        at_i = slots == i[:, None]  # [B, max_planes]
        row = torch.cat([res.normal, res.d[:, None]], dim=-1)  # [B, 4]
        coeffs = torch.where((active & res.found)[:, None, None] & at_i[..., None],
                             row[:, None, :], coeffs)
        pvalid = torch.where(active[:, None] & at_i, res.found[:, None], pvalid)
        a = active[:, None]
        valid = torch.where(a, valid & ~res.inliers, valid)
        union = torch.where(a, union | res.inliers, union)
        last = torch.where(a, res.inliers, last)
        i = i + (active & res.found).to(torch.int32)
        found = torch.where(active, res.found, found)
    remaining = valid.sum(dim=-1, dtype=torch.int32)
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
