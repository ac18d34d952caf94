"""Device-side compute stages of the port (mirrors the reference's ``ops``)."""

import functools
import struct

import numpy as np
import torch

from .. import _build


def query_range(n: int, span) -> tuple[int, int]:
    """(first, count) of the query rows or tiles a call computes: all ``n``,
    or ``span`` = (first, count) inside them (a rank's share on the
    point-sharded path)."""
    first, count = (0, n) if span is None else span
    if not (0 <= first and count >= 1 and first + count <= n):
        raise ValueError(f"query range {span} outside the {n} rows or tiles")
    return first, count


def f32(value: float) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d CPU tensor.

    The reference's Python constants enter float32 arithmetic rounded to
    float32; this makes that rounding explicit.  PyTorch takes a 0-d CPU
    tensor as an operand of a CUDA operation without copying it to the
    device, so, unlike ``torch.tensor(v, device="cuda")``, it never waits
    for the stream.
    """
    return torch.tensor(np.float32(value))


def recip32(value: float) -> torch.Tensor:
    """``1 / value`` rounded to float32 from the float32 ``value``, as a 0-d
    CPU tensor.  XLA:CPU evaluates a division by a constant, ``x /
    jnp.float32(c)``, as the product ``x * (1 / c)`` with this reciprocal;
    the port multiplies by it wherever a floor or ceil of such a quotient
    decides a cell or a voxel."""
    return torch.tensor(np.float32(1.0) / np.float32(value))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding.

    XLA:CPU contracts a multiply that feeds an add into a fused
    multiply-add, so the reference evaluates many of its float32 sums of
    products this way; the port writes out each such chain where a decision
    or a bitwise result depends on it.  The float64 product of two float32
    values is exact and the float64 sum rounds only when the addends lie
    far apart in magnitude, so rounding the sum to float32 once gives the
    fused result except in rare double-rounding ties.  The same float64
    operations run on every device, so the CPU and the card agree bit for
    bit."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, as
    XLA:CPU's ``sqrt`` gives it.  On the card that is ``torch.sqrt`` itself
    (IEEE round-to-nearest; ``tests/test_torch_cuda.py::
    test_card_sqrt_is_the_float64_root`` holds it bitwise to the float64
    form).  On the CPU the root is taken in float64 and rounded
    once (53 >= 2 * 24 + 2 bits, so the double rounding is innocuous):
    torch's vectorized float32 ``sqrt`` on an AVX-512 CPU misses it on about
    0.6% of inputs."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(torch.float32)


def sum_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(p * p, axis=-1)`` over (x, y, z) as XLA:CPU evaluates it:
    the reduction's chain ``fma(z, z, fma(y, y, x * x))``."""
    return fma(z, z, fma(y, y, x * x))


def dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """The written-out ``ax*bx + ay*by + az*bz`` as XLA:CPU evaluates it: the
    first product fused into the first add, the third into the second,
    ``fma(az, bz, fma(ax, bx, ay * by))`` (the distance kernels' cross term
    and RANSAC's plane distance)."""
    return fma(az, bz, fma(ax, bx, ay * by))


def add_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The written-out ``x*x + y*y + z*z`` as XLA:CPU evaluates it,
    ``fma(z, z, fma(x, x, y * y))``."""
    return dot3(x, y, z, x, y, z)


XLA_REDUCE_WINDOW = 32  # XLA:CPU's TreeReductionRewriter window


def xla_sum_levels(n: int) -> tuple[int, ...]:
    """The values at each level of XLA:CPU's tree for a row of ``n``
    values: ``n``, then ``ceil(c / 32)`` windows of the level below while
    it holds more than 32; the last level's (32 or fewer) values enter the
    plain reduce."""
    w = XLA_REDUCE_WINDOW
    sizes = [n]
    while sizes[-1] > w:
        sizes.append(-(-sizes[-1] // w))
    return tuple(sizes)


@functools.lru_cache(maxsize=None)
def xla_sum_plan(n: int, blocks: int) -> tuple[int, tuple[tuple[int, int], ...]]:
    """How the sum kernel's thread-block cluster splits a row of ``n``
    values over at most ``blocks`` blocks: ``(level, ranges)``, block ``b``
    summing the windows ``ranges[b][0] .. ranges[b][1] - 1`` of that level
    of XLA:CPU's tree (``xla_sum_levels``), and the first block then the
    levels above it and the plain reduce.  The level is the highest one
    with at least one window a block (a level boundary is the only cut that
    keeps XLA:CPU's order), never below level 2, whose windows (1,024 value
    slots) are a warp's unit: a row with fewer level-2 windows than blocks
    takes one block a window.  A row of 1,024 values or fewer is one block
    (level 1, its level-1 windows), one of 32 or fewer the plain reduce
    (level 0).  ``tests/test_torch_xla_sum.py`` replays a plan and holds it
    bitwise to ``sum_like_xla_plain``."""
    sizes = xla_sum_levels(n)
    top = len(sizes) - 1
    if top <= 1:
        return top, ((0, sizes[top]),)
    level = max((i for i in range(2, top + 1) if sizes[i] >= blocks), default=2)
    nb = min(blocks, sizes[level])
    cuts = [b * sizes[level] // nb for b in range(nb + 1)]
    return level, tuple(zip(cuts[:-1], cuts[1:]))


def sum_like_xla_plain(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``sum_like_xla``: one PyTorch add a step."""
    w = XLA_REDUCE_WINDOW
    if b is not None and a.shape[-1] <= w:  # the product fused into the plain reduce's adds
        a, b = a[..., :, None, :], b[..., None, :, :]
        acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1], dtype=a.dtype,
                          device=a.device)
        for k in range(a.shape[-1]):
            acc = fma(a[..., k], b[..., k], acc)
        return acc
    x = a if b is None else a[..., :, None, :] * b[..., None, :, :]
    while x.shape[-1] > w:
        pad = -x.shape[-1] % w
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, w)
        acc = torch.zeros_like(x[..., 0])
        for k in range(w):
            acc = acc + x[..., k]
        x = acc
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def sum_like_xla(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Float32 sum over the last axis in XLA:CPU's order for ``jnp.sum``.

    XLA:CPU's tree-reduction rewrite turns a reduction longer than 32 into
    a reduce-window of 32 (stride 32, the input padded with zeros, half
    the padding in front: ``pad // 2`` low, the rest high), repeated until
    32 or fewer values remain, then a plain reduce; each window and the
    last reduce add their values one after another from 0.  This replays
    that order (``tests/test_torch_outliers.py`` holds it bitwise to
    ``jnp.sum``).

    ``a`` [..., S, N] gives [..., S] (and [N] a 0-d sum).  With ``b``
    [..., T, N] it sums the
    products ``a[..., s, :] * b[..., t, :]`` into [..., S, T], as XLA:CPU
    evaluates ``jnp.sum(p * q)``: above 32 values the product is a fusion
    of its own, rounded before the windows add it (RANSAC's covariance);
    up to 32 it is fused into the plain reduce's adds, ``acc = fma(p_k,
    q_k, acc)``.  CUDA tensors take one launch of the sum kernel
    (``csrc/xla_sum.cu``) at every length; CPU tensors the plain version."""
    if a.device.type == "cpu":
        return sum_like_xla_plain(a, b)
    return _xla_sum_kernel(a, b)


@functools.lru_cache(maxsize=None)
def _launch_plan(index: int, lead: int, s_a: int, s_b: int, n: int, tail: bool,
                 blocks: int | None) -> tuple:
    """The sum kernel's tile and plan for ``lead`` x ``s_a`` rows of a and
    ``s_b`` of b (0: one operand) of ``n`` values on card ``index``: (tile
    rows of a, tile rows of b, level, blocks, 17 block bounds), as
    ``SumArgs`` takes them.

    A cluster owns one row (and one of b) while a cluster a row still
    leaves each at least 8 of the card's SMs: more SMs read a call's rows
    than one cluster's 16 can.  Else up to 4 rows of a, or 3 of a and 3 of
    b, each row read once for all of the tile's outputs; ``covariance_tail``
    (``tail``) always takes the 3 x 3 tile.  ``blocks`` a cluster (by
    default as many as fill the card's SMs), up to the largest cluster the
    card schedules, split by ``xla_sum_plan``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    if tail:
        t_a, t_b = 3, 3
    elif lead * s_a * max(s_b, 1) * 8 <= sms:
        t_a, t_b = 1, min(s_b, 1)
    else:
        t_a, t_b = (min(s_a, 3), min(s_b, 3)) if s_b else (min(s_a, 4), 0)
    clusters = lead * -(-s_a // t_a) * (-(-s_b // t_b) if s_b else 1)
    if blocks is None:
        blocks = sms // clusters
    cap = _build.kernels().pcp_xla_sum_max_blocks(t_a, t_b, int(tail))
    level, ranges = xla_sum_plan(n, max(1, min(cap, blocks)))
    bounds = [r[0] for r in ranges] + [ranges[-1][1]]
    return (t_a, t_b, level, len(ranges), *bounds, *[0] * (17 - len(bounds)))


# ``csrc/xla_sum.cu``'s ``SumArgs``: the sum kernel's arguments as one block
# of 43 8-byte fields (pointers, strides, sizes, the tile, the plan, out,
# stream; then covariance_tail's operands, zero for a plain sum)
_SUM_ARGS = struct.Struct("<43q")
_NO_TAIL = (0,) * 8


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """``t`` [..., S, N] as [L, S, N] rows: the tensor to read (``t``, or
    for more than one leading dim its reshape, a copy where no view
    exists; the caller keeps it until the launch) and (L, S, N, lead
    stride, row stride, value stride)."""
    if t.dim() == 3:
        return t, (*t.shape, *t.stride())
    if t.dim() == 2:
        return t, (1, *t.shape, 0, *t.stride())
    r = t.reshape(-1, *t.shape[-2:])
    return r, (*r.shape, *r.stride())


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor | None) -> None:
    """``a`` [..., S, N] and ``b`` [..., T, N]: float32 on one CUDA device,
    the same leading dims and N."""
    if a.dim() < 2 or (b is not None and (b.dim() != a.dim() or b.shape[:-2] != a.shape[:-2]
                                          or b.shape[-1] != a.shape[-1])):
        raise ValueError(f"{name}: a [..., S, N] and b [..., T, N] with the same leading "
                         "dims and N")
    if not a.is_cuda or (b is not None and b.get_device() != a.get_device()):
        raise ValueError(f"{name}: every operand must lie on one CUDA device")
    if a.dtype != torch.float32 or (b is not None and b.dtype != torch.float32):
        raise TypeError(f"{name}: float32 operands")


def _xla_sum_kernel(a: torch.Tensor, b: torch.Tensor | None,
                    blocks: int | None = None) -> torch.Tensor:
    """One launch of the sum kernel at every length: a thread-block cluster
    of up to ``blocks`` blocks a tile of rows (``csrc/xla_sum.cu``),
    strided operands read in place, no scratch."""
    one_row = b is None and a.dim() == 1  # [N] -> []
    _check_operands("sum_like_xla", a[None] if one_row else a, b)
    ta, ra = (a, (1, 1, a.shape[0], 0, 0, a.stride(0))) if one_row else _rows(a)
    tb, rb = (None, (0,) * 6) if b is None else _rows(b)
    lead, s_a, n = ra[:3]
    s_b = 1 if b is None else rb[1]
    out = torch.empty(a.shape[:-1] if b is None else (*a.shape[:-1], s_b),
                      dtype=torch.float32, device=a.device)
    if out.numel():
        plan = _launch_plan(a.get_device(), lead, s_a, 0 if b is None else s_b, n, False, blocks)
        args = _SUM_ARGS.pack(ta.data_ptr(), *ra[3:], 0 if tb is None else tb.data_ptr(),
                              *rb[3:], lead, s_a, s_b, n, *plan, out.data_ptr(),
                              _build.stream_handle(), *_NO_TAIL)
        _build.check(_build.kernels().pcp_xla_sum(args), "xla_sum")
        _build.LAUNCHES["xla_sum"] += 1
    return out


# the reference's ``ops`` names (imported last: the stages use the helpers above)
from .cluster import cluster_centroids, euclidean_cluster  # noqa: E402
from .compaction import compact, extract_indices  # noqa: E402
from .filters import crop_box_mask, euclidean_distance, passthrough_mask  # noqa: E402
from .histogram import histogram2d_mxu, weighted_histogram_mxu  # noqa: E402
from .occupancy import crop_and_seed, grid_cell_index, grid_cell_xy, mark_obstacles  # noqa: E402
from .outliers import knn_mean_distances, remove_statistical_outliers  # noqa: E402
from .ransac import ransac_plane_once, segment_planes  # noqa: E402
from .shadow import cast_shadows  # noqa: E402
from .transforms import RigidTransform, quat_rotate, quat_to_matrix  # noqa: E402
from .voxel import merge_voxel_partials, voxel_downsample, voxel_partials  # noqa: E402
