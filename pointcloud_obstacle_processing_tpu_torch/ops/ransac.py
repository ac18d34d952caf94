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
for the whole batch at once: ``ransac_score`` (on the CPU a ``[B, N, K]``
table; on the card one count-and-select launch that writes no such table,
then the winner's mask) and ``plane_inliers`` (the refinement's mask).
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
    "ransac_score",
    "ransac_score_plain",
    "plane_inliers",
    "plane_inliers_plain",
    "covariance_tail",
    "hypotheses_for_confidence",
    "draw_from_uniform",
    "draw_from_bits",
    "PlaneOnceResult",
    "ScoreResult",
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


class ScoreResult(NamedTuple):  # RANSAC's scoring and selection, a scan a row
    counts: torch.Tensor  # [B, K] int32 inliers a hypothesis, -1 where gated off
    best: torch.Tensor  # [B] int64 the winner: the least k among the largest counts
    found: torch.Tensor  # [B] bool: the winner's count > 0
    normal: torch.Tensor  # [B, 3] the winner's normal
    d: torch.Tensor  # [B] the winner's offset
    inliers: torch.Tensor  # [B, N] bool the winner's mask


def ransac_score_plain(points, valid, nx, ny, nz, ds, gate, thresh) -> ScoreResult:
    """Plain PyTorch version of ``ransac_score``: the ``[B, N, K]`` distance
    table, its mask and count, the gate, ``argmax`` and the gathers."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dists = torch.abs(_plane_dist(x[..., None], y[..., None], z[..., None],
                                  nx[:, None, :], ny[:, None, :], nz[:, None, :],
                                  ds[:, None, :]))  # [B, N, K]
    inl = (dists < thresh) & valid[..., None]
    counts = inl.sum(dim=-2, dtype=torch.int32)
    counts = torch.where(gate, counts, -1)

    # the winner of each scan, gathered with an index tensor: indexing with
    # a 0-d tensor would read it back to the host
    best = torch.argmax(counts, dim=-1, keepdim=True)  # [B, 1]
    found = counts.gather(-1, best)[:, 0] > 0
    normal = torch.stack([nx, ny, nz], dim=-1).gather(1, best[..., None].expand(-1, 1, 3))[:, 0]
    d = ds.gather(-1, best)[:, 0]
    inliers = inl.gather(-1, best[:, None, :].expand(-1, inl.shape[1], 1))[..., 0]
    return ScoreResult(counts, best[:, 0], found, normal, d, inliers)


# the score kernel's scratch: (device index, stream) -> int32 zeros, [B, K]
# counts then a ticket a scan, which every launch leaves zero
_SCORE_SCRATCH: dict = {}


def _score_scratch(ref: torch.Tensor, stream: int, size: int) -> torch.Tensor:
    """The cached scratch of ``ref``'s card and ``stream``, at least ``size``
    int32 long (a larger one replaces it, made once by ``torch.zeros``)."""
    key = (ref.get_device(), stream)
    scratch = _SCORE_SCRATCH.get(key)
    if scratch is None or scratch.numel() < size:
        scratch = _SCORE_SCRATCH[key] = ref.new_zeros(size, dtype=torch.int32)
    return scratch


def ransac_score(points: torch.Tensor, valid: torch.Tensor, nx: torch.Tensor, ny: torch.Tensor,
                 nz: torch.Tensor, ds: torch.Tensor, gate: torch.Tensor,
                 thresh: torch.Tensor) -> ScoreResult:
    """Score K plane hypotheses a scan against its points and pick the
    winner: ``points`` [B, N, 3] float32, ``valid`` [B, N] bool, the planes
    ``nx``, ``ny``, ``nz``, ``ds`` [B, K] float32, ``gate`` [B, K] bool (the
    hypotheses that may win), ``thresh`` the float32 distance threshold (a
    0-d CPU tensor, ``f32``).  A point is an inlier of plane k when it is
    valid and ``|fma(z, nz, fma(x, nx, y * ny)) + d| < thresh``.

    CPU tensors take ``ransac_score_plain``; CUDA tensors one launch of
    ``csrc/ransac_score.cu``'s score kernel (each row read once, a count a
    hypothesis by warp sums, the selection in the scan's last block; no
    [B, N, K] tensor, no host read) and one of ``plane_inliers`` for the
    winner's mask.  Bitwise alike."""
    if points.device.type == "cpu":
        return ransac_score_plain(points, valid, nx, ny, nz, ds, gate, thresh)
    b, n = valid.shape
    k = nx.shape[-1]
    if points.shape != (b, n, 3) or any(t.shape != (b, k) for t in (nx, ny, nz, ds, gate)):
        raise ValueError("ransac_score: points [B, N, 3], valid [B, N], the planes and gate [B, K]")
    if b and (n < 1 or k < 1):
        raise ValueError("ransac_score: N >= 1 points and K >= 1 hypotheses")
    pts, ok, g = points.contiguous(), valid.contiguous(), gate.contiguous()
    planes = [t.contiguous() for t in (nx, ny, nz, ds)]
    _build.require_cuda("ransac_score", pts, ok, *planes, g,
                        dtypes=(torch.float32, torch.bool, *[torch.float32] * 4, torch.bool))
    counts = pts.new_empty((b, k), dtype=torch.int32)
    best = pts.new_empty(b, dtype=torch.int64)
    found = pts.new_empty(b, dtype=torch.bool)
    normal = pts.new_empty((b, 3))
    d = pts.new_empty(b)
    if b:
        stream = _build.stream_handle()
        scratch = _score_scratch(pts, stream, b * k + b)
        err = _build.kernels().pcp_ransac_score(
            pts.data_ptr(), ok.data_ptr(), *[t.data_ptr() for t in planes], g.data_ptr(), b, n, k,
            float(thresh), scratch.data_ptr(), counts.data_ptr(), best.data_ptr(),
            found.data_ptr(), normal.data_ptr(), d.data_ptr(), stream)
        _build.check(err, "ransac_score")
        _build.LAUNCHES["ransac_score"] += 1
    return ScoreResult(counts, best, found, normal, d, plane_inliers(pts, ok, normal, d, thresh))


def plane_inliers_plain(points, valid, normal, d, thresh, prev=None, n_inl=None) -> torch.Tensor:
    """Plain PyTorch version of ``plane_inliers``."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    new_in = (torch.abs(_plane_dist(x, y, z, normal[:, 0, None], normal[:, 1, None],
                                    normal[:, 2, None], d[:, None])) < thresh) & valid
    if prev is None:
        return new_in
    return torch.where((n_inl >= 3.0)[:, None], new_in, prev)


def plane_inliers(points: torch.Tensor, valid: torch.Tensor, normal: torch.Tensor,
                  d: torch.Tensor, thresh: torch.Tensor, prev: torch.Tensor | None = None,
                  n_inl: torch.Tensor | None = None) -> torch.Tensor:
    """The inliers of one plane a scan: ``(|fma(z, nz, fma(x, nx, y * ny)) +
    d| < thresh) & valid`` [B, N] bool for ``points`` [B, N, 3], ``normal``
    [B, 3] and ``d`` [B]; with ``prev`` [B, N] and ``n_inl`` [B] float32,
    scans with ``n_inl < 3`` keep ``prev`` (the refinement's select).

    CPU tensors take ``plane_inliers_plain``; CUDA tensors one launch of
    ``csrc/ransac_score.cu``'s mask kernel, the plane read from device
    memory."""
    if points.device.type == "cpu":
        return plane_inliers_plain(points, valid, normal, d, thresh, prev, n_inl)
    b, n = valid.shape
    if points.shape != (b, n, 3) or normal.shape != (b, 3) or d.shape != (b,) or \
            (prev is None) != (n_inl is None) or \
            (prev is not None and (prev.shape != (b, n) or n_inl.shape != (b,))):
        raise ValueError("plane_inliers: points [B, N, 3], valid [B, N], normal [B, 3], d [B]; "
                         "prev [B, N] and n_inl [B] together")
    operands = [points.contiguous(), valid.contiguous(), normal.contiguous(), d.contiguous()]
    types = [torch.float32, torch.bool, torch.float32, torch.float32]
    if prev is not None:
        operands += [n_inl.contiguous(), prev.contiguous()]
        types += [torch.float32, torch.bool]
    _build.require_cuda("plane_inliers", *operands, dtypes=types)
    out = operands[1].new_empty((b, n))
    if out.numel():
        pts, ok, nrm, dd = operands[:4]
        err = _build.kernels().pcp_plane_inliers(
            pts.data_ptr(), ok.data_ptr(), nrm.data_ptr(), dd.data_ptr(),
            operands[4].data_ptr() if prev is not None else None,
            operands[5].data_ptr() if prev is not None else None, b, n, float(thresh),
            out.data_ptr(), _build.stream_handle())
        _build.check(err, "plane_inliers")
        _build.LAUNCHES["plane_inliers"] += 1
    return out


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

    gate = axis_ok & ~degenerate & (n_valid >= 3)[:, None]
    _, _, found, normal, d, inliers = ransac_score(pts, valid, nx, ny, nz, ds, gate, thresh)

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
        r_in = plane_inliers(pts, valid, nrm, nd, thresh, prev=r_in, n_inl=n_inl)
        r_normal, r_d = nrm, nd
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
