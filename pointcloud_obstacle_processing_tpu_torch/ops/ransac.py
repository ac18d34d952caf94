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

import math
from typing import Callable, NamedTuple

import torch

from . import (
    _SUM_ARGS,
    _launch_plan,
    add_sq3,
    dot3,
    f32,
    fma,
    sqrt32,
    sum_like_xla,
    sum_like_xla_plain,
)
from .. import _build
from ..config import PipelineConfig
from ..types import Cloud, PlaneModel, batch_of, scan_of

__all__ = [
    "ransac_plane_once",
    "segment_planes",
    "covariance_tail",
    "hypotheses_for_confidence",
    "draw_from_uniform",
    "draw_from_bits",
    "PlaneOnceResult",
    "SegmentPlanesResult",
]

Draw = Callable[[int, torch.Tensor], torch.Tensor]


def hypotheses_for_confidence(inlier_fraction: float, confidence: float = 0.99,
                              multiple_of: int = 64) -> int:
    """The hypothesis batch K equivalent to PCL's adaptive RANSAC count
    ``log(1 - confidence) / log(1 - w^3)`` (RandomSampleConsensus::
    computeModel) for the worst inlier fraction ``w`` a deployment must
    handle, rounded up to a multiple of ``multiple_of`` (the reference's
    ``hypotheses_for_confidence``, ransac.py:46)."""
    w3 = max(min(inlier_fraction, 1.0), 1e-6) ** 3
    if w3 >= 1.0:
        return multiple_of
    k = math.log(max(1.0 - confidence, 1e-12)) / math.log(1.0 - w3)
    return max(multiple_of, int(math.ceil(k / multiple_of)) * multiple_of)


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


def draw_from_bits(hi: torch.Tensor, lo: torch.Tensor) -> Draw:
    """Draws that replay the reference's ``jax.random.randint(key, (K, 3), 0,
    max(n_valid, 1))`` from the two words of random bits it takes for each
    index (``hi``, ``lo``: [rounds, K, 3], or [B, rounds, K, 3] for a
    batch, uint32 values held in int64), with its arithmetic: ``(hi % span)
    * (2^32 % span) + lo % span`` in uint32, modulo ``span``.  Every rank of
    a point-sharded run replays the reference's key chain from the same
    words."""
    mask = 0xFFFFFFFF

    def draw(r: int, n_valid: torch.Tensor) -> torch.Tensor:
        span = torch.clamp_min(n_valid, 1).to(torch.int64)[..., None, None]
        mult = ((65536 % span) * (65536 % span) & mask) % span
        h = hi[..., r, :, :].to(span.device) % span
        low = lo[..., r, :, :].to(span.device) % span
        return (((h * mult) & mask) + low & mask) % span

    return draw


def _sum3(a, b, vmapped: bool) -> torch.Tensor:
    """``jnp.sum`` of a three-vector ``a * b`` (last axis) as XLA:CPU
    evaluates it inside the refinement's loops: one scan contracts the
    products as a written-out sum, ``fma(a2, b2, fma(a0, b0, a1 * b1))``;
    under ``jax.vmap`` the reduce's chain, ``fma(a2, b2, fma(a1, b1, a0 *
    b0))``."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    if vmapped:
        return fma(a2, b2, fma(a1, b1, a0 * b0))
    return fma(a2, b2, fma(a0, b0, a1 * b1))


def _smallest_eigvec_3x3(cov: torch.Tensor, init: torch.Tensor, iters: int = 24,
                         vmapped: bool = False) -> torch.Tensor:
    """Smallest eigenvector of each symmetric 3x3 ``cov`` [..., 3, 3] by
    power iteration on ``trace(cov) I - cov``, seeded with ``init`` [..., 3],
    bitwise as XLA:CPU evaluates the reference's (``jnp.trace`` adds the
    diagonal in order; the matrix-vector product is the chain
    ``fma(m_i2, v2, fma(m_i1, v1, m_i0 * v0))`` for every row; the norm
    ``sqrt32(_sum3(w, w))``; ``vmapped`` takes the form of the reference's
    ``jax.vmap``)."""
    trace = (cov[..., 0, 0] + cov[..., 1, 1]) + cov[..., 2, 2]
    eye = torch.eye(3, dtype=torch.bool, device=cov.device)
    m = torch.where(eye, trace[..., None, None], 0.0) - cov
    v = init
    for _ in range(iters):
        w = fma(m[..., 2], v[..., 2:3], fma(m[..., 1], v[..., 1:2], m[..., 0] * v[..., 0:1]))
        nrm = sqrt32(_sum3(w, w, vmapped))[..., None]
        v = torch.where(nrm > 1e-20, w / torch.clamp_min(nrm, 1e-20), v)
    return v


def plane_tail_plain(cov, cen, n_inl, normal, d, vmapped: bool):
    """Plain PyTorch version of the refinement's per-scan tail (the epilogue
    of ``covariance_tail``'s kernel): the smallest eigenvector of ``cov``
    [B, 3, 3] seeded with ``normal`` [B, 3], turned to ``normal``'s side,
    and its offset through the centroid ``cen`` [B, 3]; where fewer than 3
    inliers were summed (``n_inl`` [B]) the plane (``normal``, ``d`` [B])
    stays.  Returns (normal [B, 3], d [B])."""
    nrm = _smallest_eigvec_3x3(cov, normal, vmapped=vmapped)
    nrm = nrm * torch.sign(_sum3(nrm, normal, vmapped) + f32(1e-30))[..., None]
    nd = -dot3(nrm[:, 0], nrm[:, 1], nrm[:, 2], cen[:, 0], cen[:, 1], cen[:, 2])
    ok = n_inl >= 3.0
    return torch.where(ok[:, None], nrm, normal), torch.where(ok, nd, d)


def covariance_tail(masked_off, off, cen, n_inl, normal, d, vmapped: bool):
    """One refinement step's covariance and 3x3 tail: ``cov =
    sum_like_xla(masked_off, off)`` ([B, 3, N] each: the inliers' and all
    points' offsets from the centroid ``cen`` [B, 3]), then
    ``plane_tail_plain(cov, cen, n_inl, normal, d, vmapped)``.  Returns
    (normal [B, 3], d [B]).  CPU tensors take those two plain versions;
    CUDA tensors one launch of the sum kernel (``csrc/xla_sum.cu``), one
    thread-block cluster a scan owning its nine sums, with the tail
    (``csrc/plane_tail.cuh``) as its epilogue."""
    if masked_off.device.type == "cpu":
        return plane_tail_plain(sum_like_xla_plain(masked_off, off), cen, n_inl, normal, d,
                                vmapped)
    bsz, n = masked_off.shape[0], masked_off.shape[-1]
    if masked_off.shape != (bsz, 3, n) or off.shape != (bsz, 3, n) or cen.shape != (bsz, 3) or \
            n_inl.shape != (bsz,) or normal.shape != (bsz, 3) or d.shape != (bsz,):
        raise ValueError("covariance_tail: masked_off and off [B, 3, N], cen [B, 3], n_inl [B], "
                         "normal [B, 3], d [B]")
    cen, normal, d = cen.contiguous(), normal.contiguous(), d.contiguous()
    index = masked_off.get_device()  # -1 for a CPU tensor
    if any(t.get_device() != index or t.dtype != torch.float32
           for t in (off, cen, n_inl, normal, d)) or masked_off.dtype != torch.float32:
        raise ValueError("covariance_tail: float32 operands on one CUDA device")
    out_n = torch.empty_like(normal)
    out_d = torch.empty_like(d)
    if bsz:
        plan = _launch_plan(index, bsz, 3, 3, n, True, None)
        args = _SUM_ARGS.pack(
            masked_off.data_ptr(), *masked_off.stride(), off.data_ptr(), *off.stride(), bsz, 3,
            3, n, *plan, 0, _build.stream_handle(), cen.data_ptr(), n_inl.data_ptr(),
            n_inl.stride(0), normal.data_ptr(), d.data_ptr(), int(vmapped), out_n.data_ptr(),
            out_d.data_ptr())
        _build.check(_build.kernels().pcp_covariance_tail(args), "covariance_tail")
        _build.LAUNCHES["covariance_tail"] += 1
    return out_n, out_d


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
                      axis=(0.0, 0.0, 1.0), vmapped: bool | None = None) -> PlaneOnceResult:
    """One plane extraction from the draws ``u`` ([K, 3] indices into the
    valid points, in input order), or one a scan from [B, K, 3] draws over
    a batch of clouds.  ``vmapped`` (by default: whether a batch was given)
    takes the refinement's arithmetic as the reference's ``jax.vmap``
    evaluates it, else as its single scan does (``_sum3``)."""
    cloud, single = batch_of(cloud)
    vmapped = not single if vmapped is None else vmapped
    res = _plane_once(cloud, u[None] if single else u, config, axis, vmapped,
                      _with_ones(cloud.points))
    return scan_of(res) if single else res


def _with_ones(pts: torch.Tensor) -> torch.Tensor:
    """[B, 4, N] rows x, y, z, 1 of points [B, N, 3]: the refinement's
    masked sums (the centroid's and the inlier count) as one call."""
    return torch.cat([pts.transpose(1, 2), torch.ones_like(pts[:, None, :, 0])], dim=1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x [B, N] and idx [B, ...]."""
    return x.gather(-1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _plane_once(cloud: Cloud, u: torch.Tensor, config: PipelineConfig, axis, vmapped: bool,
                pts1: torch.Tensor) -> PlaneOnceResult:
    """``ransac_plane_once`` over a batch: cloud [B, N], draws [B, K, 3];
    ``pts1``: ``_with_ones(cloud.points)``."""
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
    # ``found`` becomes a select over an unconditional computation.  Its
    # sums in XLA:CPU's order (``sum_like_xla``): the inlier count and the
    # centroid's sums in one call, the covariance's nine (products rounded,
    # then summed) and the per-scan 3x3 tail in another
    r_normal, r_d, r_in = normal, d, inliers
    for _ in range(config.ransac_refine_iters):
        s4 = sum_like_xla(torch.where(r_in[:, None, :], pts1, 0.0))  # [B, 4]: sx, sy, sz, n
        n_inl = s4[:, 3]
        cen = s4[:, :3] / torch.clamp_min(n_inl, 3.0)[:, None]
        off = pts1[:, :3] - cen[..., None]  # [B, 3, N]
        nrm, nd = covariance_tail(torch.where(r_in[:, None, :], off, 0.0), off, cen, n_inl,
                                  r_normal, r_d, vmapped)
        new_in = (torch.abs(_plane_dist(x, y, z, nrm[:, 0, None], nrm[:, 1, None],
                                        nrm[:, 2, None], nd[:, None])) < thresh) & valid
        r_normal, r_d = nrm, nd
        r_in = torch.where((n_inl >= 3.0)[:, None], new_in, r_in)
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
                   axis=(0.0, 0.0, 1.0), vmapped: bool | None = None) -> SegmentPlanesResult:
    """Iterative multi-plane removal (cpp:376-399) as ``max_planes`` masked
    rounds.  Round r runs, in each scan, where the reference's loop
    condition holds there: more than ``plane_min_remaining_frac`` of the
    points remain, the last round found a plane, and fewer than
    ``max_planes`` were extracted.  ``draw(r, n_valid)`` gets each scan's
    remaining count (``[]`` for one cloud, ``[B]`` for a batch) and returns
    [K, 3] or [B, K, 3] indices.  ``vmapped`` as for ``ransac_plane_once``
    (a batch through ``process_scan`` is the reference's vmapped
    ``batched_pipeline``)."""
    cloud, single = batch_of(cloud)
    vmapped = not single if vmapped is None else vmapped
    if single:
        one_draw = draw
        draw = lambda r, n_valid: one_draw(r, n_valid[0])[None]  # noqa: E731
    res = _segment_planes(cloud, config, draw, axis, vmapped)
    return scan_of(res) if single else res


def _segment_planes(cloud: Cloud, config: PipelineConfig, draw: Draw, axis,
                    vmapped: bool) -> SegmentPlanesResult:
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
    pts1 = _with_ones(cloud.points)  # fixed over the rounds
    for r in range(max_planes):
        remaining = valid.sum(dim=-1, dtype=torch.int32)
        active = (remaining.to(torch.float32) > frac * n0.to(torch.float32)) & found & (i < max_planes)
        res = _plane_once(Cloud(points=cloud.points, valid=valid), draw(r, remaining),
                          config, axis, vmapped, pts1)
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
