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
gets ``n_valid`` [B] and returns [B, K, 3], and a round runs for the whole
batch at once: ``ransac_hypotheses_score`` builds, gates, scores and
selects the hypotheses (on the CPU ``hypotheses_plain`` and a ``[B, N, K]``
table; on the card one launch that writes no such table),
``plane_inliers`` gives the winner's mask, the refinement's and
``ransac_plane_once``'s last (the round's last plane's, where it found
one), and in ``segment_planes`` that last mask closes the round
(``plane_inliers_close``: the round's mask applied to the loop's state in
place).
"""

from __future__ import annotations

import functools
import math
import struct
from typing import Callable, NamedTuple

import numpy as np
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
from .libm import acos_like_xla
from .. import _build
from ..config import PipelineConfig
from ..types import Cloud, PlaneModel, batch_of, scan_of

__all__ = [
    "ransac_plane_once",
    "segment_planes",
    "ransac_hypotheses_score",
    "ransac_hypotheses_score_plain",
    "hypotheses_plain",
    "axis_cos_min",
    "score_form",
    "ransac_score_plain",
    "plane_inliers",
    "plane_inliers_plain",
    "plane_inliers_close",
    "plane_inliers_close_plain",
    "covariance_tail",
    "hypotheses_for_confidence",
    "draw_from_uniform",
    "draw_from_bits",
    "PlaneOnceResult",
    "RoundPlane",
    "RoundScore",
    "RoundState",
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
    with _build.launch("covariance_tail") as launch:
        bsz, n = masked_off.shape[0], masked_off.shape[-1]
        if masked_off.shape != (bsz, 3, n) or off.shape != (bsz, 3, n) or cen.shape != (bsz, 3) or \
                n_inl.shape != (bsz,) or normal.shape != (bsz, 3) or d.shape != (bsz,):
            raise ValueError("covariance_tail: masked_off and off [B, 3, N], cen [B, 3], "
                             "n_inl [B], normal [B, 3], d [B]")
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
        else:
            launch.skip()
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


class RoundScore(NamedTuple):  # a round's winner, a scan a row
    found: torch.Tensor  # [B] bool: the winner's count > 0
    normal: torch.Tensor  # [B, 3] the winner's normal
    d: torch.Tensor  # [B] the winner's offset


@functools.lru_cache(maxsize=64)
def _cos_min(eps_bits: int) -> float:
    eps = np.int32(eps_bits).view(np.float32)

    def passes(bits: int) -> bool:
        c = torch.tensor([bits], dtype=torch.int32).view(torch.float32)
        return bool(acos_like_xla(c)[0] <= eps)

    lo, hi = 0, 0x3F800000  # the bits of 0.0 and 1.0
    if not passes(hi):
        return math.inf
    if passes(lo):
        return 0.0
    while hi - lo > 1:  # passes(hi), not passes(lo)
        mid = (lo + hi) // 2
        if passes(mid):
            hi = mid
        else:
            lo = mid
    return float(np.int32(hi).view(np.float32))


def axis_cos_min(eps_angle: float) -> torch.Tensor:
    """The axis gate's threshold for the float32 ``eps_angle``: the least
    float32 ``c`` in [0, 1] with ``arccos(c) <= eps_angle``, where arccos is
    the reference's ``jnp.arccos`` as XLA:CPU evaluates it
    (``libm.acos_like_xla``), as a 0-d CPU float32 tensor (``inf`` where no
    ``c`` passes).  arccos falls as ``c`` rises, so ``clamp(|cos|, 0, 1) >=
    cos_min`` is the reference's ``arccos(clamp(|cos|, 0, 1)) <= eps``; a
    NaN fails both.  Found once an ``eps`` by bisection over the float32
    bit patterns of [0, 1] (``tests/test_torch_ransac_round.py`` holds the
    two decisions equal around it)."""
    return f32(_cos_min(int(np.float32(eps_angle).view(np.int32))))


def hypotheses_plain(points, tri, n_valid, cos_min, axis):
    """The round's K planes a scan and their gates, from the drawn points
    ``tri`` [B, K, 3] (indices into ``points`` [B, N, 3]), ``n_valid`` [B]
    int32, ``cos_min`` (``axis_cos_min``) and ``axis`` (three floats): the
    reference's cross product, norm and offset as XLA:CPU contracts them
    (bitwise equal to it: tests/test_torch_ransac.py), the axis gate in its
    threshold form.  Returns (nx, ny, nz, ds, gate), [B, K] each."""
    ax = [f32(a) for a in axis]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]  # [B, N]
    i0, i1, i2 = tri[..., 0], tri[..., 1], tri[..., 2]
    p0x, p0y, p0z = _gather(x, i0), _gather(y, i0), _gather(z, i0)
    p1x, p1y, p1z = _gather(x, i1), _gather(y, i1), _gather(z, i1)
    p2x, p2y, p2z = _gather(x, i2), _gather(y, i2), _gather(z, i2)

    ux, uy, uz = p1x - p0x, p1y - p0y, p1z - p0z
    vx, vy, vz = p2x - p0x, p2y - p0y, p2z - p0z
    nx = fma(uy, vz, -(uz * vy))
    ny = fma(uz, vx, -(ux * vz))
    nz = fma(ux, vy, -(uy * vx))
    norms = sqrt32(add_sq3(nx, ny, nz))
    degenerate = norms < f32(1e-12)
    inv = 1.0 / torch.clamp_min(norms, 1e-20)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ds = -dot3(nx, ny, nz, p0x, p0y, p0z)  # [B, K]

    cosang = torch.clamp(torch.abs(nx * ax[0] + ny * ax[1] + nz * ax[2]), 0.0, 1.0)
    gate = (cosang >= cos_min) & ~degenerate & (n_valid >= 3)[:, None]
    return nx, ny, nz, ds, gate


def ransac_score_plain(points, valid, nx, ny, nz, ds, gate, thresh) -> ScoreResult:
    """A round's scoring and selection on given planes (``nx``, ``ny``,
    ``nz``, ``ds``, ``gate`` [B, K]) in plain PyTorch: the ``[B, N, K]``
    distance table, its mask and count, the gate, ``argmax`` and the
    gathers.  With ``hypotheses_plain`` it is the score kernel's reference
    (``ransac_hypotheses_score_plain``); the tests read the gated counts
    and the winner's index and mask from it."""
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


def ransac_hypotheses_score_plain(points, valid, tri, n_valid, thresh, cos_min,
                                  axis) -> RoundScore:
    """Plain PyTorch version of ``ransac_hypotheses_score``:
    ``hypotheses_plain``, then ``ransac_score_plain``'s selection."""
    planes = hypotheses_plain(points, tri, n_valid, cos_min, axis)
    return RoundScore(*ransac_score_plain(points, valid, *planes, thresh)[2:5])


SCORE_THREADS = 256  # rows a block of the score kernel takes R at a time
SCORE_CHUNK = 1024  # planes a block stages at a time
SCORE_BLOCKS_AN_SM = 2  # the blocks an SM a call aims for (the forms' rows and slices)


def score_form(scans: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """The score kernel's form for ``scans`` x ``n`` rows and ``k``
    hypotheses on a card of ``sms`` SMs: (rows a thread, hypotheses a
    z-slice).  8 rows a thread where the call's blocks still fill every SM
    twice (a batch of 32 flagship scans), else 2 (the flagship's 24,576
    rows, fullscale's 262,144).  Where the row blocks fall short of two an
    SM and the planes fit one staged chunk, the hypotheses are split over
    the grid's z into slices of a multiple of 32, as many as bring the
    blocks to two an SM (the flagship's 48 row blocks take 4 slices of 32);
    else one slice of all K."""
    target = SCORE_BLOCKS_AN_SM * sms
    rows = 8 if scans * n >= target * SCORE_THREADS * 8 else 2
    blocks = scans * -(-n // (SCORE_THREADS * rows))
    groups = -(-k // 32)
    slices = 1
    if k <= SCORE_CHUNK and 0 < blocks < target:
        slices = min(groups, -(-target // blocks))
    return rows, 32 * -(-groups // slices)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


# ``csrc/ransac_score.cu``'s ``ScoreArgs``: four operand pointers, five
# sizes, five float32 constants (each in the low half of its field), six
# output and scratch pointers and the stream; all 8-byte fields
_SCORE_ARGS = struct.Struct("<4q5q" + "fi" * 5 + "7q")
_SCORE_IN = struct.Struct("<4q")
_SCORE_OUT = struct.Struct("<7q")
_SCORE_OUT_AT = 8 * (4 + 5 + 5)
_SCORE_TYPES = (torch.float32, torch.bool, torch.int64, torch.int32)


def _is_contiguous(shape, stride) -> bool:
    """Whether a tensor of ``shape`` and ``stride`` is laid out row-major
    with no gaps (a dim of size 1 may take any stride)."""
    step = 1
    for size, st in zip(reversed(shape), reversed(stride)):
        if size != 1 and st != step:
            return False
        step *= size
    return True


@functools.lru_cache(maxsize=1024)
def _score_plan(layout: tuple, constants: tuple, form) -> tuple:
    """What a score launch's arguments hold that depends only on the
    operands' layout (points, valid, tri, n_valid: each one's shape,
    strides, device index and dtype), the constants (thresh, cos_min, the
    axis' three floats) and ``form`` (None: ``score_form``'s): (scans, K,
    ``ScoreArgs`` packed with every pointer zero).  Raises on operands the
    kernel does not take."""
    (p_shape, _, index, _), (v_shape, *_), (t_shape, *_), (c_shape, *_) = layout
    b, n = v_shape
    k = t_shape[1] if len(t_shape) == 3 else -1
    if p_shape != (b, n, 3) or t_shape != (b, k, 3) or c_shape != (b,):
        raise ValueError("ransac_hypotheses_score: points [B, N, 3], valid [B, N], "
                         "tri [B, K, 3], n_valid [B]")
    if b and (n < 1 or k < 1):
        raise ValueError("ransac_hypotheses_score: N >= 1 points and K >= 1 hypotheses")
    for i, ((shape, stride, dev, dtype), want) in enumerate(zip(layout, _SCORE_TYPES)):
        if dev < 0 or dev != index:
            raise ValueError("ransac_hypotheses_score: every operand must lie on one CUDA device")
        if not _is_contiguous(shape, stride):
            raise ValueError(f"ransac_hypotheses_score: operand {i} must be contiguous")
        if dtype != want:
            raise TypeError(f"ransac_hypotheses_score: operand {i} must be {want}, got {dtype}")
    rows, slice_ = form if form is not None else score_form(b, n, k, _sms(index))
    thresh, cos_min, axis = constants
    ax, ay, az = (float(np.float32(a)) for a in axis)
    packed = _SCORE_ARGS.pack(*[0] * 4, b, n, k, rows, slice_, thresh, 0, cos_min, 0, ax, 0,
                              ay, 0, az, 0, *[0] * 7)
    return b, k, packed


def _score_outputs(pts: torch.Tensor, b: int) -> RoundScore:
    """The score kernel's outputs for ``b`` scans, views of one allocation
    on ``pts``' device: normal [B, 3] and d [B] float32, then found [B]
    bool (a view that reinterprets the bytes)."""
    out = pts.new_empty(4 * b + -(-b // 4))
    return RoundScore(out.view(torch.bool).as_strided((b,), (1,), 16 * b),
                      out.as_strided((b, 3), (3, 1)), out.as_strided((b,), (1,), 3 * b))


def _score_launch(operands, constants, form=None, detail: bool = False):
    """One launch of the score kernel on ``operands`` (points, valid, tri,
    n_valid) and ``constants`` (thresh, cos_min, the axis), in ``form``
    (rows a thread, hypotheses a z-slice; None: ``score_form``'s, which the
    wrapper takes; the tests hold every form alike); the launch fields come
    from ``_score_plan``, cached a layout.  Returns a ``RoundScore``; with
    ``detail`` (the tests), also the gated counts [B, K] int32 and the
    winner's index [B] int64, which the kernel writes only then."""
    with _build.launch("ransac_hypotheses_score") as launch:
        pts, valid, tri, n_valid = operands
        b, k, packed = _score_plan(
            tuple((t.shape, t.stride(), t.get_device(), t.dtype) for t in operands), constants,
            form)
        found, normal, d = _score_outputs(pts, b)
        counts = best = None
        if detail:
            counts, best = tri.new_empty((b, k), dtype=torch.int32), tri.new_empty(b)
        if b:
            stream = _build.stream_handle()
            args = bytearray(packed)
            _SCORE_IN.pack_into(args, 0, pts.data_ptr(), valid.data_ptr(), tri.data_ptr(),
                                n_valid.data_ptr())
            _SCORE_OUT.pack_into(args, _SCORE_OUT_AT,
                                 _score_scratch(pts, stream, b * k + b).data_ptr(),
                                 found.data_ptr(), normal.data_ptr(), d.data_ptr(),
                                 0 if counts is None else counts.data_ptr(),
                                 0 if best is None else best.data_ptr(), stream)
            _build.check(_build.kernels().pcp_ransac_score(bytes(args)), "ransac_hypotheses_score")
        else:
            launch.skip()
    res = RoundScore(found, normal, d)
    return (res, counts, best) if detail else res


def ransac_hypotheses_score(points: torch.Tensor, valid: torch.Tensor, tri: torch.Tensor,
                            n_valid: torch.Tensor, thresh: torch.Tensor, cos_min: torch.Tensor,
                            axis=(0.0, 0.0, 1.0)) -> RoundScore:
    """A round's hypotheses built, gated, scored and selected: ``points``
    [B, N, 3] float32, ``valid`` [B, N] bool, ``tri`` [B, K, 3] int64 the
    drawn points (indices into the scan's rows, valid-first), ``n_valid``
    [B] int32, ``thresh`` the float32 distance threshold and ``cos_min``
    the axis gate's (``axis_cos_min``; 0-d CPU tensors, ``f32``), ``axis``
    three floats.  Hypothesis k is the plane through its three points
    (``hypotheses_plain``); it may win where its gate holds; a point is its
    inlier when valid and ``|fma(z, nz, fma(x, nx, y * ny)) + d| < thresh``.
    Returns the winner (the least k among the largest inlier counts):
    found (its count > 0), normal and offset.

    CPU tensors take ``ransac_hypotheses_score_plain``; CUDA tensors one
    launch of ``csrc/ransac_score.cu``'s score kernel, each block building
    the K planes from the drawn points in shared memory (no [B, K] plane
    tensor, no [B, N, K] table, no host read), in ``score_form``'s form.
    Bitwise alike."""
    if not points.is_cuda:
        return ransac_hypotheses_score_plain(points, valid, tri, n_valid, thresh, cos_min, axis)
    return _score_launch((points, valid, tri, n_valid),
                         (float(thresh), float(cos_min), tuple(axis)))


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
    with _build.launch("plane_inliers") as launch:
        b, n = valid.shape
        if points.shape != (b, n, 3) or normal.shape != (b, 3) or d.shape != (b,) or \
                (prev is None) != (n_inl is None) or \
                (prev is not None and (prev.shape != (b, n) or n_inl.shape != (b,))):
            raise ValueError("plane_inliers: points [B, N, 3], valid [B, N], normal [B, 3], "
                             "d [B]; prev [B, N] and n_inl [B] together")
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
        else:
            launch.skip()
    return out


class RoundState(NamedTuple):  # the removal loop's state, a scan a row
    valid: torch.Tensor  # [B, N] bool the points not yet taken by a plane
    union: torch.Tensor  # [B, N] bool the points every plane took
    last: torch.Tensor  # [B, N] bool the last active round's mask
    coeffs: torch.Tensor  # [B, max_planes, 4] float32 the planes kept
    pvalid: torch.Tensor  # [B, max_planes] bool
    i: torch.Tensor  # [B] int32 the planes kept
    found: torch.Tensor  # [B] bool: the last active round found a plane


def plane_inliers_close_plain(points, normal, d, found, active, thresh,
                              state: RoundState) -> RoundState:
    """Plain PyTorch version of ``plane_inliers_close``: the round's mask,
    the inliers of its plane where it found one, applied to the loop's
    state where the round is active (``_segment_planes``'s where chain)."""
    valid, union, last, coeffs, pvalid, i, state_found = state
    inliers = plane_inliers_plain(points, valid, normal, d, thresh) & found[:, None]
    at_i = torch.arange(coeffs.shape[1], device=i.device) == i[:, None]  # [B, max_planes]
    row = torch.cat([normal, d[:, None]], dim=-1)  # [B, 4]
    a = active[:, None]
    return RoundState(
        valid=torch.where(a, valid & ~inliers, valid),
        union=torch.where(a, union | inliers, union),
        last=torch.where(a, inliers, last),
        coeffs=torch.where((active & found)[:, None, None] & at_i[..., None], row[:, None, :],
                           coeffs),
        pvalid=torch.where(a & at_i, found[:, None], pvalid),
        i=i + (active & found).to(torch.int32),
        found=torch.where(active, found, state_found),
    )


def plane_inliers_close(points: torch.Tensor, normal: torch.Tensor, d: torch.Tensor,
                        found: torch.Tensor, active: torch.Tensor, thresh: torch.Tensor,
                        state: RoundState) -> RoundState:
    """Close a RANSAC round: its mask ``(|fma(z, nz, fma(x, nx, y * ny)) +
    d| < thresh) & valid & found`` for the round's plane (``normal`` [B, 3],
    ``d`` [B], ``found`` [B] bool), applied to the loop's ``state`` in scans
    where ``active`` [B] bool holds: ``valid &= ~mask``, ``union |= mask``,
    ``last = mask``, the plane into ``coeffs[i]`` where found, ``pvalid[i]
    = found``, ``i += found``, the loop's ``found`` set.  The refinement's
    running mask is the mask of its running plane, so the round's last
    refinement mask, with ``found``, is this mask (held pass by pass in
    ``tests/test_torch_ransac_round.py``).

    CPU tensors take ``plane_inliers_close_plain`` (new tensors); CUDA
    tensors one launch of ``csrc/ransac_score.cu``'s closing kernel, which
    updates the state's tensors in place and returns them."""
    if not points.is_cuda:
        return plane_inliers_close_plain(points, normal, d, found, active, thresh, state)
    with _build.launch("plane_inliers_close") as launch:
        b, n = state.valid.shape
        mp = state.coeffs.shape[1]
        shapes = [(b, n, 3), (b, 3), (b,), (b,), (b,), (b, n), (b, n), (b, n), (b, mp, 4), (b, mp),
                  (b,), (b,)]
        operands = [points, normal, d, found, active, *state]
        if any(t.shape != s for t, s in zip(operands, shapes)):
            raise ValueError("plane_inliers_close: points [B, N, 3], normal [B, 3], d, found "
                             "and active [B]; the state's masks [B, N], coeffs [B, P, 4], "
                             "pvalid [B, P], i and found [B]")
        _build.require_cuda("plane_inliers_close", *operands, dtypes=(
            torch.float32, torch.float32, torch.float32, torch.bool, torch.bool, torch.bool,
            torch.bool, torch.bool, torch.float32, torch.bool, torch.int32, torch.bool))
        if b:
            err = _build.kernels().pcp_plane_inliers_close(
                *[t.data_ptr() for t in operands[:5]], b, n, mp, float(thresh),
                *[t.data_ptr() for t in state], _build.stream_handle())
            _build.check(err, "plane_inliers_close")
        else:
            launch.skip()
    return state


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
    evaluates it, else as its single scan does (``_sum3``).  The round's
    mask is the inliers of its last plane where it found one (the
    refinement's running mask is its running plane's: ``_round_plane``)."""
    cloud, single = batch_of(cloud)
    vmapped = not single if vmapped is None else vmapped
    pts, valid = cloud.points.contiguous(), cloud.valid.contiguous()
    r = _round_plane(Cloud(points=pts, valid=valid), u[None] if single else u, config, axis,
                     vmapped, _with_ones(pts))
    inliers = plane_inliers(pts, valid, r.refined_normal, r.refined_d,
                            f32(config.plane_segment_dist_thresh)) & r.found[:, None]
    res = PlaneOnceResult(normal=torch.where(r.found[:, None], r.refined_normal, r.normal),
                          d=torch.where(r.found, r.refined_d, r.d), inliers=inliers,
                          found=r.found)
    return scan_of(res) if single else res


def _with_ones(pts: torch.Tensor) -> torch.Tensor:
    """[B, 4, N] rows x, y, z, 1 of points [B, N, 3]: the refinement's
    masked sums (the centroid's and the inlier count) as one call."""
    return torch.cat([pts.transpose(1, 2), torch.ones_like(pts[:, None, :, 0])], dim=1)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x [B, N] and idx [B, ...]."""
    return x.gather(-1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


class RoundPlane(NamedTuple):  # a round's planes before its last mask, a scan a row
    found: torch.Tensor  # [B] bool: the winner's count > 0
    normal: torch.Tensor  # [B, 3] the winner's normal
    d: torch.Tensor  # [B] the winner's offset
    refined_normal: torch.Tensor  # [B, 3] the last refinement pass's (the winner's if none ran)
    refined_d: torch.Tensor  # [B]


def _round_plane(cloud: Cloud, u: torch.Tensor, config: PipelineConfig, axis, vmapped: bool,
                 pts1: torch.Tensor, n_valid: torch.Tensor | None = None) -> RoundPlane:
    """A round up to its last mask over a batch: cloud [B, N] (contiguous),
    draws [B, K, 3]; ``pts1``: ``_with_ones(cloud.points)``; ``n_valid``:
    each scan's valid points, where the caller has counted them.  The
    winner, then ``ransac_refine_iters`` refinement passes, each but the
    last followed by its mask.  The tail keeps the plane where n_inl < 3
    and the mask keeps its mask, so the running mask is always the running
    plane's, and the round's mask is the inliers of ``refined_normal``,
    ``refined_d`` where found (``ransac_plane_once``,
    ``plane_inliers_close``)."""
    pts = cloud.points
    valid = cloud.valid
    thresh = f32(config.plane_segment_dist_thresh)

    # valid-first permutation: a draw in [0, n_valid) names a valid point
    perm = torch.sort(valid.to(torch.int8), dim=-1, descending=True, stable=True).indices
    if n_valid is None:
        n_valid = valid.sum(dim=-1, dtype=torch.int32)
    found, normal, d = ransac_hypotheses_score(
        pts, valid, _gather(perm, u), n_valid, thresh, axis_cos_min(config.eps_angle_radians),
        axis)
    iters = config.ransac_refine_iters
    r_normal, r_d = normal, d
    if not iters:
        return RoundPlane(found, normal, d, r_normal, r_d)

    # refinement (setOptimizeCoefficients); the reference's lax.cond on
    # ``found`` becomes a select over an unconditional computation.  Its
    # sums in XLA:CPU's order (``sum_like_xla``): the inlier count and the
    # centroid's sums in one call, the covariance's nine (products rounded,
    # then summed) and the per-scan 3x3 tail in another
    r_in = plane_inliers(pts, valid, normal, d, thresh)
    for p in range(iters):
        s4 = sum_like_xla(torch.where(r_in[:, None, :], pts1, 0.0))  # [B, 4]: sx, sy, sz, n
        n_inl = s4[:, 3]
        cen = s4[:, :3] / torch.clamp_min(n_inl, 3.0)[:, None]
        off = pts1[:, :3] - cen[..., None]  # [B, 3, N]
        r_normal, r_d = covariance_tail(torch.where(r_in[:, None, :], off, 0.0), off, cen, n_inl,
                                        r_normal, r_d, vmapped)
        if p < iters - 1:
            r_in = plane_inliers(pts, valid, r_normal, r_d, thresh, prev=r_in, n_inl=n_inl)
    return RoundPlane(found, normal, d, r_normal, r_d)


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
    thresh = f32(config.plane_segment_dist_thresh)
    n0 = cloud.valid.sum(dim=-1, dtype=torch.int32)
    floor = f32(config.plane_min_remaining_frac) * n0.to(torch.float32)
    pts = cloud.points.contiguous()
    # the loop's state; on the card each round's closing launch updates it
    # in place (valid is the caller's: copied)
    state = RoundState(
        valid=cloud.valid.clone(memory_format=torch.contiguous_format),
        union=torch.zeros(b, n, dtype=torch.bool, device=dev),
        last=torch.zeros(b, n, dtype=torch.bool, device=dev),
        coeffs=torch.zeros(b, max_planes, 4, dtype=torch.float32, device=dev),
        pvalid=torch.zeros(b, max_planes, dtype=torch.bool, device=dev),
        i=torch.zeros(b, dtype=torch.int32, device=dev),
        found=torch.ones(b, dtype=torch.bool, device=dev),
    )
    pts1 = _with_ones(pts)  # fixed over the rounds
    for r in range(max_planes):
        remaining = state.valid.sum(dim=-1, dtype=torch.int32)
        active = (remaining.to(torch.float32) > floor) & state.found & (state.i < max_planes)
        plane = _round_plane(Cloud(points=pts, valid=state.valid), draw(r, remaining), config,
                             axis, vmapped, pts1, n_valid=remaining)
        state = plane_inliers_close(pts, plane.refined_normal, plane.refined_d, plane.found,
                                    active, thresh, state)
    remaining = state.valid.sum(dim=-1, dtype=torch.int32)
    truncated = (remaining.to(torch.float32) > floor) & state.found & (state.i >= max_planes)
    return SegmentPlanesResult(
        planes=PlaneModel(coeffs=state.coeffs, valid=state.pvalid, num_planes=state.i),
        nonplane_cloud=Cloud(points=cloud.points, valid=state.valid),
        plane_union=state.union,
        last_plane=state.last,
        truncated=truncated,
    )
