"""Statistical outlier removal, banded engine (pcl::StatisticalOutlierRemoval).

Counterpart of the banded sorting-network branch of
``pointcloud_obstacle_processing_tpu/ops/outliers.py``.  For every point of
the lattice-ordered voxel cloud, the mean distance to its ``k`` nearest
valid neighbours among a rank window (query tile t scores the ``row_tile +
2*band`` columns at ``starts[t]``); then PCL's global gate ``mean_dist <=
mu + mult * sigma`` with the n-1 estimator.

Kernel K3 (``csrc/knn_select.cu``) emits the 16 smallest squared distances
of each query, ascending; ``knn_select_plain`` is its plain version, taken
only for CPU tensors.  The masked mean of the k smallest square roots is
one PyTorch expression shared by both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import f32
from .. import _build
from ..types import Cloud

__all__ = [
    "knn_mean_distances",
    "remove_statistical_outliers",
    "knn_select",
    "knn_select_plain",
    "band_starts",
    "OutlierResult",
    "BIG",
]

BIG = 3.0e38  # sentinel squared distance for invalid and self columns
_SEL = 16


def band_starts(n: int, row_tile: int, band: int, tiles: int, device) -> torch.Tensor:
    """Column-window start of each query tile, clamped inside the buffer."""
    width = row_tile + 2 * band
    t = torch.arange(tiles, dtype=torch.int32, device=device)
    return torch.clamp(t * row_tile - band, 0, n - width).to(torch.int32)


def _tile_live(valid: torch.Tensor, tiles: int, row_tile: int) -> torch.Tensor:
    pad = tiles * row_tile - valid.shape[0]
    return torch.nn.functional.pad(valid, (0, pad)).reshape(tiles, row_tile).any(dim=1)


def knn_select_plain(pch, p_sq, valid, starts, row_tile: int, width: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K3: [16, n_q] ascending smallest d2 of
    each query over its tile's window; ``big`` for tiles with no valid query."""
    n = p_sq.shape[0]
    tiles = starts.shape[0]
    n_q = tiles * row_tile
    dev = p_sq.device
    bigt = float(np.float32(BIG))  # a Python scalar: torch.where takes it as float32
    tile_chunk = 8  # tiles per [t, T, W] distance block: bounds the temporaries
    q_ch = [torch.nn.functional.pad(c, (0, n_q - n)) for c in pch]
    q_sq = torch.nn.functional.pad(p_sq, (0, n_q - n))
    q_ids = torch.arange(n_q, device=dev)
    live = _tile_live(valid, tiles, row_tile)
    out = torch.empty(tiles, row_tile, _SEL, dtype=torch.float32, device=dev)
    for t0 in range(0, tiles, tile_chunk):
        ts = slice(t0, min(t0 + tile_chunk, tiles))
        cols = starts[ts].long()[:, None] + torch.arange(width, device=dev)  # [t, W]
        qs = [c.reshape(tiles, row_tile)[ts][:, :, None] for c in q_ch]  # [t, T, 1]
        cs = [c[cols][:, None, :] for c in pch]  # [t, 1, W]
        cross = qs[0] * cs[0] + qs[1] * cs[1] + qs[2] * cs[2]
        d2 = (q_sq.reshape(tiles, row_tile)[ts][:, :, None] + p_sq[cols][:, None, :]) - 2.0 * cross
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(valid[cols][:, None, :], d2, bigt)
        self_col = q_ids.reshape(tiles, row_tile)[ts][:, :, None] == cols[:, None, :]
        d2 = torch.where(self_col, bigt, d2)
        out[ts] = torch.topk(d2, _SEL, dim=-1, largest=False, sorted=True).values
    out = torch.where(live[:, None, None], out, bigt)
    return out.reshape(n_q, _SEL).T.contiguous()


def knn_select(pch, p_sq, valid, starts, row_tile: int, width: int) -> torch.Tensor:
    """The 16 smallest banded squared distances of every query, ascending:
    kernel K3 for CUDA tensors, the plain version for CPU tensors."""
    if p_sq.device.type == "cpu":
        return knn_select_plain(pch, p_sq, valid, starts, row_tile, width)
    n = p_sq.shape[0]
    tiles = starts.shape[0]
    n_q = tiles * row_tile
    if width > n or width % 16:
        raise ValueError(f"knn_select: window width {width} must be <= {n} and a multiple of 16")
    if any(t.shape != (n,) for t in (*pch, valid)) or len(pch) != 3 or starts.dim() != 1:
        raise ValueError("knn_select: three [N] channels, [N] p_sq and valid, [tiles] starts")
    _build.require_cuda(
        "knn_select", *pch, p_sq, valid, starts,
        dtypes=[torch.float32] * 4 + [torch.bool, torch.int32],
    )
    lib = _build.kernels()
    live = _tile_live(valid, tiles, row_tile).contiguous()
    out = torch.empty(_SEL, n_q, dtype=torch.float32, device=p_sq.device)
    err = lib.pcp_knn_select(
        pch[0].data_ptr(), pch[1].data_ptr(), pch[2].data_ptr(), p_sq.data_ptr(),
        valid.data_ptr(), starts.data_ptr(), live.data_ptr(), n, n_q, row_tile, width,
        float(np.float32(BIG)), out.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "knn_select")
    _build.LAUNCHES["knn_select"] += 1
    return out


def mean_from_sorted(vals: torch.Tensor, k: int) -> torch.Tensor:
    """[16, Q] ascending values -> mean of the k smallest real values'
    square roots (the reference's ``_sortnet_mean_from_sorted``); the sum
    runs row by row, the same order on every device."""
    half = f32(BIG * 0.5)
    s = torch.zeros(vals.shape[1], dtype=torch.float32, device=vals.device)
    cnt = torch.zeros_like(s)
    for i in range(min(k, _SEL)):
        take = vals[i] < half
        s = s + torch.where(take, torch.sqrt(vals[i]), 0.0)
        cnt = cnt + take.to(torch.float32)
    return s / torch.clamp_min(cnt, 1.0)


def knn_mean_distances(cloud: Cloud, k: int, row_tile: int = 512, band: int = 1024) -> torch.Tensor:
    """Mean distance to the k nearest valid neighbours in each point's rank
    window ([N] float32; 0 for invalid points).  The cloud must be in
    voxel-lattice order, as ``voxel_downsample`` emits it."""
    pts = cloud.points
    n = cloud.capacity
    valid = cloud.valid
    row_tile = min(row_tile, n)
    tiles = -(-n // row_tile)
    width = row_tile + 2 * band
    if not (width < n and width % 16 == 0 and k <= _SEL):
        raise ValueError(
            "the ported banded kNN needs row_tile + 2*band < capacity, a width "
            f"divisible by 16 and k <= 16 (got row_tile={row_tile}, band={band}, "
            f"n={n}, k={k}); the reference's full-width engines are not ported"
        )
    # center (cancellation in the expanded d2 scales with |p|^2); invalid
    # points are parked at the center, their columns masked below
    denom = torch.clamp_min(valid.sum(dtype=torch.float32), 1.0)
    pch = []
    for c in range(3):
        col = pts[:, c]
        center_c = torch.where(valid, col, 0.0).sum() / denom
        pch.append(torch.where(valid, col - center_c, 0.0).contiguous())
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    starts = band_starts(n, row_tile, band, tiles, pts.device)
    vals = knn_select(pch, p_sq, valid.contiguous(), starts, row_tile, width)
    out = mean_from_sorted(vals, k)[:n]
    return torch.where(valid, out, 0.0)


class OutlierResult(NamedTuple):
    cloud: Cloud  # same buffer, mask restricted to inliers
    mean_distances: torch.Tensor  # [N] float32
    threshold: torch.Tensor  # [] float32 mu + sigma * mult


def remove_statistical_outliers(cloud: Cloud, mean_k: int, std_dev_mult: float,
                                row_tile: int = 512, band: int = 1024) -> OutlierResult:
    """PCL's filter (obstacle_detection.cpp:326-330) with its n-1 estimator."""
    d = knn_mean_distances(cloud, mean_k, row_tile, band)
    valid_f = cloud.valid.to(torch.float32)
    n = torch.clamp_min(valid_f.sum(), 2.0)
    s1 = (d * valid_f).sum()
    s2 = (d * d * valid_f).sum()
    mu = s1 / n
    var = torch.clamp_min((s2 - n * mu * mu) / (n - 1.0), 0.0)
    threshold = mu + f32(std_dev_mult) * torch.sqrt(var)
    keep = cloud.valid & (d <= threshold)
    return OutlierResult(
        cloud=Cloud(points=cloud.points, valid=keep), mean_distances=d, threshold=threshold
    )
