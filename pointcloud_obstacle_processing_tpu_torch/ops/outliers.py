"""Statistical outlier removal (pcl::StatisticalOutlierRemoval).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/outliers.py``.  For
every point, the mean distance to its ``k`` nearest valid neighbours (the
``knn_backend`` engines: a rank window of the lattice-ordered voxel cloud,
query tile t scoring the ``row_tile + 2*band`` columns at ``starts[t]``, or
the whole cloud); then PCL's global gate ``mean_dist <= mu + mult * sigma``
with the n-1 estimator.

Kernel K3 (``csrc/knn_select.cu``, wrapper ``knn_mean``) is the banded
sorting network (k <= 16, a window width divisible by 16): it selects the
16 smallest squared distances of each query and emits the masked mean of
the k smallest square roots.  Its plain version, taken only for CPU
tensors, is ``knn_select_plain`` (the sorted 16) followed by
``mean_from_sorted``.  The other engines (``kmin_mean``, ``k_smallest``,
``score_tile``, ``knn_mean_windows``) are plain XLA in the reference on
every backend, and plain PyTorch here on every device.

Every function but ``knn_select_plain`` also takes a batch of clouds
(``[B, N]``), each scan on its own: K3 takes the scan as a grid dimension,
the gate's sums run per scan.

On the point-sharded path (``shard``, a ``parallel.collectives.Axis``) each
rank scores one contiguous range of the query tiles against the whole
(replicated) cloud, K3's row-range form, and the ranges are gathered: the
reference's ``_map_query_tiles`` (outliers.py:407-416), replicated where
the tiles do not split evenly.  Every query's arithmetic is unchanged, so
the gathered means equal the replicated call bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import add_sq3, dot3, f32, fma, query_range, sqrt32, sum_like_xla
from .. import _build
from ..types import Cloud

__all__ = [
    "knn_mean_distances",
    "remove_statistical_outliers",
    "kmin_mean",
    "k_smallest",
    "score_tile",
    "knn_mean_windows",
    "knn_mean",
    "knn_mean_plain",
    "knn_select_plain",
    "mean_from_sorted",
    "band_starts",
    "centre_out_chunks",
    "gate_threshold",
    "gate_sums",
    "OutlierResult",
    "BIG",
]

BIG = 3.0e38  # sentinel squared distance for invalid and self columns
_SEL = 16
KNN_CHUNK = 256  # window columns per chunk of kernel K3 (kChunk)


def band_starts(n: int, row_tile: int, band: int, tiles: int, device) -> torch.Tensor:
    """Column-window start of each query tile, clamped inside the buffer (a
    function of the buffer's length: every scan of a batch shares it)."""
    width = row_tile + 2 * band
    t = torch.arange(tiles, dtype=torch.int32, device=device)
    return torch.clamp(t * row_tile - band, 0, n - width).to(torch.int32)


def centre_out_chunks(off: int, width: int, row_tile: int, chunk: int = KNN_CHUNK) -> list:
    """(begin, end) of kernel K3's chunks of a window [0, width), in the
    order the kernel takes them (``chunk_at``): the chunks right of the
    tile's first row ``off`` that cover the tile's rows, then left and right
    chunks in turns.  The selected values do not depend on it."""
    right = [(b, min(b + chunk, width)) for b in range(off, width, chunk)]
    left = [(max(e - chunk, 0), e) for e in range(off, 0, -chunk)]
    own = min(-(-row_tile // chunk), len(right))
    order, rest = right[:own], right[own:]
    for i in range(max(len(rest), len(left))):
        order += left[i:i + 1] + rest[i:i + 1]
    return order


def _tile_live(valid: torch.Tensor, tiles: int, row_tile: int) -> torch.Tensor:
    """[..., tiles]: whether each query tile (of each scan) holds a valid row."""
    pad = tiles * row_tile - valid.shape[-1]
    padded = torch.nn.functional.pad(valid, (0, pad))
    return padded.reshape(*valid.shape[:-1], tiles, row_tile).any(dim=-1)


def knn_select_plain(pch, p_sq, valid, starts, row_tile: int, width: int,
                     tile_range=None) -> torch.Tensor:
    """Plain PyTorch version of kernel K3: [16, n_q] ascending smallest d2 of
    each query over its tile's window; ``big`` for tiles with no valid
    query.  ``tile_range`` (first, count) scores those query tiles only
    (``n_q`` = count * row_tile)."""
    n = p_sq.shape[0]
    tiles = starts.shape[0]
    first, count = query_range(tiles, tile_range)
    n_q = tiles * row_tile
    dev = p_sq.device
    bigt = float(np.float32(BIG))  # a Python scalar: torch.where takes it as float32
    tile_chunk = 8  # tiles per [t, T, W] distance block: bounds the temporaries
    q_ch = [torch.nn.functional.pad(c, (0, n_q - n)).reshape(tiles, row_tile) for c in pch]
    q_sq = torch.nn.functional.pad(p_sq, (0, n_q - n)).reshape(tiles, row_tile)
    q_ids = torch.arange(n_q, device=dev).reshape(tiles, row_tile)
    live = _tile_live(valid, tiles, row_tile)
    out = torch.empty(count, row_tile, _SEL, dtype=torch.float32, device=dev)
    for t0 in range(first, first + count, tile_chunk):
        ts = slice(t0, min(t0 + tile_chunk, first + count))
        cols = starts[ts].long()[:, None] + torch.arange(width, device=dev)  # [t, W]
        qs = [c[ts][:, :, None] for c in q_ch]  # [t, T, 1]
        cs = [c[cols][:, None, :] for c in pch]  # [t, 1, W]
        cross = dot3(*qs, *cs)  # the reference's fused chain, as kernel K3
        d2 = (q_sq[ts][:, :, None] + p_sq[cols][:, None, :]) - 2.0 * cross
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(valid[cols][:, None, :], d2, bigt)
        d2 = torch.where(q_ids[ts][:, :, None] == cols[:, None, :], bigt, d2)
        out[ts.start - first:ts.stop - first] = torch.topk(
            d2, _SEL, dim=-1, largest=False, sorted=True).values
    out = torch.where(live[first:first + count, None, None], out, bigt)
    return out.reshape(count * row_tile, _SEL).T.contiguous()


def mean_from_sorted(vals: torch.Tensor, k: int) -> torch.Tensor:
    """[16, Q] ascending values -> mean of the k smallest real values'
    square roots (the reference's ``_sortnet_mean_from_sorted``); the sum
    runs row by row, the order XLA:CPU takes, on every device, over
    correctly rounded roots (``ops.sqrt32``)."""
    half = f32(BIG * 0.5)
    rows = min(k, _SEL)
    roots = sqrt32(vals[:rows])
    s = torch.zeros(vals.shape[1], dtype=torch.float32, device=vals.device)
    cnt = torch.zeros_like(s)
    for i in range(rows):
        take = vals[i] < half
        s = s + torch.where(take, roots[i], 0.0)
        cnt = cnt + take.to(torch.float32)
    return s / torch.clamp_min(cnt, 1.0)


def knn_mean_plain(pch, p_sq, valid, starts, row_tile: int, width: int, k: int,
                   tile_range=None) -> torch.Tensor:
    """Plain PyTorch version of kernel K3: [..., n_q] mean distance to the k
    nearest valid neighbours in each query's tile window, scan by scan."""
    if p_sq.dim() > 1:
        return torch.stack([knn_mean_plain([c[b] for c in pch], p_sq[b], valid[b], starts,
                                           row_tile, width, k, tile_range)
                            for b in range(p_sq.shape[0])])
    return mean_from_sorted(
        knn_select_plain(pch, p_sq, valid, starts, row_tile, width, tile_range), k)


def knn_mean(pch, p_sq, valid, starts, row_tile: int, width: int, k: int,
             tile_range=None) -> torch.Tensor:
    """[n_q] (or [B, n_q] for channels, |p|^2 and mask of a batch, [B, N])
    mean distance to the k nearest valid neighbours in each query's tile
    window (0 for tiles with no valid query): kernel K3 for CUDA tensors,
    one launch a call with the scan as a grid dimension; the plain version
    for CPU tensors.  ``starts`` [tiles] serve every scan.  ``tile_range``
    (first, count): score those query tiles only, against the whole cloud
    (K3's row-range form, the point-sharded path's; ``n_q`` = count *
    row_tile)."""
    if p_sq.device.type == "cpu":
        return knn_mean_plain(pch, p_sq, valid, starts, row_tile, width, k, tile_range)
    with _build.launch("knn_mean" if tile_range is None else "knn_mean_rows"):
        n = p_sq.shape[-1]
        lead = p_sq.shape[:-1]
        first, tiles = query_range(starts.shape[0], tile_range)
        if width > n or width % 16 or not 1 <= k <= _SEL:
            raise ValueError(f"knn_mean: window width {width} must be <= {n} and a multiple of 16, "
                             f"and 1 <= k <= {_SEL} (got k={k})")
        if any(t.shape != p_sq.shape for t in (*pch, valid)) or len(pch) != 3 or \
                p_sq.dim() > 2 or starts.dim() != 1:
            raise ValueError("knn_mean: three channels, p_sq and valid, all [N] or all [B, N]; "
                             "[tiles] starts")
        _build.require_cuda(
            "knn_mean", *pch, p_sq, valid, starts,
            dtypes=[torch.float32] * 4 + [torch.bool, torch.int32],
        )
        lib = _build.kernels()
        batch = p_sq[..., 0].numel()
        out = torch.empty(*lead, tiles * row_tile, dtype=torch.float32, device=p_sq.device)
        err = lib.pcp_knn_mean(
            pch[0].data_ptr(), pch[1].data_ptr(), pch[2].data_ptr(), p_sq.data_ptr(),
            valid.data_ptr(), starts.data_ptr(), batch, n, first, tiles, row_tile, width, k,
            float(np.float32(BIG)), float(f32(BIG * 0.5)), out.data_ptr(), _build.stream_handle(),
        )
        _build.check(err, "knn_mean")
    return out


I32_MAX = 2**31 - 1
KNN_BLOCK_ELEMENTS = 2**24  # distances a block of query tiles holds at once (the plain engines)


def kmin_mean(d2: torch.Tensor, k: int, big: float = BIG) -> torch.Tensor:
    """[..., W] squared distances -> [...] mean of the square roots of the
    k smallest, leaving out sentinels (>= big / 2): the reference's
    ``_kmin_mean``, plain XLA there on every backend and plain PyTorch here.

    Works on the int32 bit patterns (non-negative floats order as their
    bits).  Each of the k passes takes the row minimum with all its
    duplicates, up to the quota left, and masks them with INT32_MAX; a row
    with nothing left reads INT32_MAX, a NaN pattern that ``real`` guards.
    The sum runs pass by pass, ``s + take * sqrt(m)`` as XLA:CPU evaluates
    it (the product rounded, then the add), over correctly rounded roots."""
    iv = d2.contiguous().view(torch.int32)
    half = f32(big * 0.5)
    kf = f32(k)
    s = torch.zeros(iv.shape[:-1] + (1,), dtype=torch.float32, device=d2.device)
    taken = torch.zeros_like(s)
    for _ in range(k):
        m = iv.min(dim=-1, keepdim=True).values
        eq = iv == m
        cnt = eq.sum(dim=-1, keepdim=True, dtype=torch.float32)
        mf = m.view(torch.float32)
        real = mf < half
        take = torch.where(real, torch.minimum(cnt, kf - taken), 0.0)
        s = s + torch.where(real, take * sqrt32(mf), 0.0)
        taken = taken + take
        iv = torch.where(eq, I32_MAX, iv)
    return (s / torch.clamp_min(taken, 1.0))[..., 0]


def k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """[..., N] -> [..., k] the k smallest values of each row, ascending:
    the reference's two-level ``_k_smallest`` (the k smallest of each
    128-column chunk, then of their pool), or one flat selection where the
    width does not split into two or more chunks of 128 or ``k`` exceeds a
    chunk.  Either form gives the same multiset in the same order."""
    n = d2.shape[-1]
    chunk = 128
    if n % chunk or n // chunk < 2 or k > chunk:
        return torch.topk(d2, k, dim=-1, largest=False, sorted=True).values
    c = d2.reshape(*d2.shape[:-1], n // chunk, chunk)
    cand = torch.topk(c, k, dim=-1, largest=False, sorted=True).values
    cand = cand.reshape(*d2.shape[:-1], (n // chunk) * k)
    return torch.topk(cand, k, dim=-1, largest=False, sorted=True).values


def score_tile(d2: torch.Tensor, k: int, backend: str) -> torch.Tensor:
    """[..., W] masked squared distances of a tile's queries -> [...] the
    mean distance to the k nearest: the tail of the reference's
    ``_score_tile``.  ``banded`` selects with ``kmin_mean``; ``exact``,
    ``approx`` and ``banded_approx`` with ``k_smallest``.  The reference's
    ``approx`` is ``lax.approx_min_k``, which XLA lowers off the TPU to
    ``ApproxTopK``'s fallback, an exact sort: the port selects exactly, as
    the JAX package does on the CPU (the TPU's PartialReduce has recall
    0.98 instead)."""
    if backend == "banded":
        return kmin_mean(d2, k)
    if backend not in ("exact", "approx", "banded_approx"):
        raise ValueError(f"unknown knn_backend {backend!r}")
    dk2 = k_smallest(d2, k)
    real = dk2 < f32(BIG * 0.5)
    dk = sqrt32(torch.clamp_min(dk2, 0.0))
    s = sum_like_xla(torch.where(real, dk, 0.0))
    cnt = real.sum(dim=-1, dtype=torch.float32)
    return s / torch.clamp_min(cnt, 1.0)


def knn_mean_windows(pch, p_sq, valid, starts, row_tile: int, width: int, k: int,
                     backend: str, tile_range=None) -> torch.Tensor:
    """[..., n_q] mean distance to the k nearest valid neighbours among each
    query tile's ``width`` columns at ``starts[t]`` (the whole cloud for
    the full-width branch), selected by ``score_tile``: the reference's
    ``_score_tile`` engines, plain PyTorch on every device as the reference
    runs them in plain XLA.  ``pch``, ``p_sq`` and ``valid`` are [N] or
    [B, N] (each scan on its own); the query side is padded to whole tiles
    (ids >= N, never a column's).  Tiles are scored a block at a time, so
    the distances held at once stay near ``KNN_BLOCK_ELEMENTS``.
    ``tile_range`` (first, count): those query tiles only (``n_q`` =
    count * row_tile)."""
    n = p_sq.shape[-1]
    lead = p_sq.shape[:-1]
    tiles = starts.shape[0]
    first, count = query_range(tiles, tile_range)
    n_q = tiles * row_tile
    dev = p_sq.device
    bigt = float(np.float32(BIG))
    pad = n_q - n
    q_ch = [torch.nn.functional.pad(c, (0, pad)).reshape(*lead, tiles, row_tile)
            for c in (*pch, p_sq)]
    q_ids = torch.arange(n_q, device=dev).reshape(tiles, row_tile)
    w_ids = torch.arange(width, device=dev)
    block = max(1, KNN_BLOCK_ELEMENTS // (max(1, p_sq[..., 0].numel()) * row_tile * width))
    out = []
    for t0 in range(first, first + count, block):
        ts = slice(t0, min(t0 + block, first + count))
        cols = starts[ts].long()[:, None] + w_ids  # [t, W]
        qs = [c[..., ts, :, None] for c in q_ch]  # [..., t, T, 1]
        cs = [c[..., cols][..., None, :] for c in (*pch, p_sq, valid)]  # [..., t, 1, W]
        cross = dot3(*qs[:3], *cs[:3])  # the reference's fused chain
        d2 = (qs[3] + cs[3]) - 2.0 * cross
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(cs[4], d2, bigt)
        d2 = torch.where(q_ids[ts][:, :, None] == cols[:, None, :], bigt, d2)
        out.append(score_tile(d2, k, backend).reshape(*lead, -1))
    return torch.cat(out, dim=-1)


def knn_mean_distances(cloud: Cloud, k: int, row_tile: int = 512, band: int = 1024,
                       shard=None, backend: str = "banded") -> torch.Tensor:
    """Mean distance to the k nearest valid neighbours of each point
    ([..., N] float32; 0 for invalid points), the reference's dispatch:

    * ``banded`` / ``banded_approx`` with ``row_tile + 2*band < N``: query
      tile t scores the ``row_tile + 2*band`` columns at ``starts[t]``.  The
      cloud (or each scan of a batch) must be in voxel-lattice order, as
      ``voxel_downsample`` emits it.  ``banded`` with a width divisible by
      16 and k <= 16 takes the sorting network, kernel K3 (``knn_mean``);
      otherwise the window is scored by ``score_tile`` (the in-window
      ``kmin_mean``, or ``k_smallest`` for ``banded_approx``);
    * otherwise, and for ``exact`` and ``approx``, the full width: every
      query against the whole cloud, a block of query tiles at a time.

    ``shard``: score this rank's range of the query tiles and gather the
    ranges over the axis (see the module docstring)."""
    pts = cloud.points
    n = cloud.capacity
    valid = cloud.valid.contiguous()
    row_tile = min(row_tile, n)
    tiles = -(-n // row_tile)
    # center (cancellation in the expanded d2 scales with |p|^2); invalid
    # points are parked at the center, their columns masked below
    denom = torch.clamp_min(valid.sum(dim=-1, dtype=torch.float32), 1.0)[..., None]
    cols = pts.movedim(-1, 0)  # [3, ..., N]
    # the channels' sums in XLA:CPU's order (bitwise the reference's)
    centers = sum_like_xla(torch.where(valid, cols, 0.0))[..., None] / denom
    pch = [torch.where(valid, col - center_c, 0.0).contiguous()
           for col, center_c in zip(cols, centers)]
    p_sq = add_sq3(*pch)  # the reference's written-out sum, as XLA:CPU fuses it
    if backend in ("banded", "banded_approx") and row_tile + 2 * band < n:
        width = row_tile + 2 * band
        starts = band_starts(n, row_tile, band, tiles, pts.device)
    else:  # the full width
        width = n
        starts = torch.zeros(tiles, dtype=torch.int32, device=pts.device)
    if backend == "banded" and width < n and width % 16 == 0 and k <= _SEL:
        score = functools.partial(knn_mean, pch, p_sq, valid, starts, row_tile, width, k)
    else:
        score = functools.partial(knn_mean_windows, pch, p_sq, valid, starts, row_tile, width,
                                  k, backend)
    if shard is not None and shard.size > 1 and tiles % shard.size == 0:
        per = tiles // shard.size
        out = shard.all_gather(score(tile_range=(shard.rank * per, per)), dim=-1)
    else:
        out = score()
    return torch.where(valid, out[..., :n], 0.0)


def gate_threshold(n, s2, mu, std_dev_mult: float) -> torch.Tensor:
    """PCL's gate ``mu + mult * sigma`` from the count ``n``, the sum of
    squares ``s2`` and the mean ``mu``, with the n-1 estimator: the
    reference's ``max((s2 - n*mu*mu) / (n-1), 0)`` and ``mu + mult *
    sqrt(var)`` as XLA:CPU fuses them, ``fma(-(n*mu), mu, s2)`` and
    ``fma(mult, sqrt(var), mu)``, with the correctly rounded root."""
    var = torch.clamp_min(fma(-(n * mu), mu, s2) / (n - 1.0), 0.0)
    return fma(f32(std_dev_mult), sqrt32(var), mu)


class OutlierResult(NamedTuple):  # a leading [B] on every field for a batch
    cloud: Cloud  # same buffer, mask restricted to inliers
    mean_distances: torch.Tensor  # [N] float32
    threshold: torch.Tensor  # [] float32 mu + sigma * mult


def gate_sums(d: torch.Tensor, valid: torch.Tensor):
    """The gate's ``n``, ``s1`` and ``s2`` of each scan (``d`` [..., N]),
    summed in XLA:CPU's order (``ops.sum_like_xla``), so that they are
    the reference's ``jnp.sum`` to the bit; ``s1`` and ``s2`` share one
    pass of adds."""
    valid_f = valid.to(torch.float32)
    n = torch.clamp_min(valid_f.sum(dim=-1), 2.0)  # a count: exact in any order
    s = sum_like_xla(torch.stack([d * valid_f, d * d * valid_f]))
    return n, s[0], s[1]


def remove_statistical_outliers(cloud: Cloud, mean_k: int, std_dev_mult: float,
                                row_tile: int = 512, band: int = 1024, shard=None,
                                backend: str = "banded") -> OutlierResult:
    """PCL's filter (obstacle_detection.cpp:326-330) with its n-1 estimator,
    on one cloud or on each scan of a batch (``backend``: the kNN engine,
    see ``knn_mean_distances``; ``shard``: the kNN's query tiles split over
    that axis, the gathered means replicated)."""
    d = knn_mean_distances(cloud, mean_k, row_tile, band, shard, backend)
    n, s1, s2 = gate_sums(d, cloud.valid)
    threshold = gate_threshold(n, s2, s1 / n, std_dev_mult)
    keep = cloud.valid & (d <= threshold[..., None])
    return OutlierResult(
        cloud=Cloud(points=cloud.points, valid=keep), mean_distances=d, threshold=threshold
    )
