"""Stable compaction with exact gather (kernel K2 and its plain version).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/compaction.py`` and
``ops/pallas_compaction.py``.  ``compact`` moves the valid points of a cloud
to the front in input order (PCL's index-order extraction) and shrinks the
buffer to ``capacity_out`` (through K2, or for a capacity off the 128 grid
by the reference's rank scatter); ``compact_and_gather_exact`` is the primitive
under it, which launches the CUDA kernel (``csrc/compaction.cu``) for CUDA
tensors and takes ``compact_and_gather_plain`` only for CPU tensors.  Both
take one cloud or a batch (``[B, ...]``, each scan compacted on its own;
the kernel takes the scan as a grid dimension).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..types import Cloud
from .histogram import compact_occupied_blocks

__all__ = [
    "compact",
    "extract_indices",
    "compact_and_gather_exact",
    "compact_and_gather_plain",
    "CompactResult",
]


_DTYPES = (torch.float32, torch.bool)  # bins, occupancy for kernel K2


class CompactResult(NamedTuple):  # a leading [B] on every field for a batch
    cloud: Cloud  # [capacity_out] valid-first compaction
    count: torch.Tensor  # [] int32 number of valid points moved
    source_index: torch.Tensor  # [capacity_out] int32 index into the input buffer
    overflow: torch.Tensor  # [] bool: valid points were dropped


def compact_and_gather_plain(bins: torch.Tensor, occ2d: torch.Tensor, capacity: int):
    """Plain PyTorch version of kernel K2: (loc [..., capacity] int32, num
    [...] int32, vals [..., capacity, C] f32) with ``vals == bins.T[loc]``
    for slots < num, each scan of a batch on its own."""
    scans = bins.dim() - 2
    loc, num = compact_occupied_blocks(occ2d, capacity, scan_dims=scans)
    idx = loc.long()[..., None].expand(*loc.shape, bins.shape[-2])
    vals = bins.transpose(-1, -2).gather(-2, idx)
    return loc, num, vals


def compact_and_gather_exact(bins: torch.Tensor, occ2d: torch.Tensor, capacity: int):
    """Compaction + exact per-slot gather.

    ``bins``: [C, A*128] float32 channel-leading table; ``occ2d``: its
    [A, 128] occupancy, at any start (a view such as ``valid[1:]`` of a
    padded buffer too).  A batch stacks both: [B, C, A*128] and [B, A,
    128].  Returns (loc, num, vals) as the plain version; slots at or past
    ``num`` are unspecified.  On the card: three allocations and one C call
    (kernel K2's two launches, the batch included); ``num`` stays on the
    device.
    """
    c, k = bins.shape[-2:]
    a, b = occ2d.shape[-2:]
    lead = bins.shape[:-2]
    if b != 128 or a * b != k or occ2d.shape[:-2] != lead or len(lead) > 1:
        raise ValueError("compact_and_gather_exact: occ2d must be the [K/128, 128] view of bins "
                         "(both with the same leading scan axis, if any)")
    if bins.device.type == "cpu":
        return compact_and_gather_plain(bins, occ2d, capacity)
    _build.require_cuda("compact_and_gather_exact", bins, occ2d, dtypes=_DTYPES)
    dev = bins.device
    batch = bins[..., 0, 0].numel()
    loc = torch.empty(*lead, capacity, dtype=torch.int32, device=dev)
    vals = torch.empty(*lead, capacity, c, dtype=torch.float32, device=dev)
    # num of each scan, then the kernel's per-1,024-column block counts
    scratch = torch.empty(batch * (1 + -(-k // 1024)), dtype=torch.int32, device=dev)
    err = _build.kernels().pcp_compact_gather(
        bins.data_ptr(), occ2d.data_ptr(), batch, c, k, capacity, loc.data_ptr(),
        vals.data_ptr(), scratch.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "compact_gather")
    _build.LAUNCHES["compact_gather"] += 1
    return loc, scratch[:batch].reshape(lead), vals


def compact(cloud: Cloud, capacity_out: int | None = None) -> CompactResult:
    """Move valid points to the front, stably; shrink to ``capacity_out``
    (one cloud, or each scan of a batch).  A cloud whose capacity is a
    multiple of 128 goes through kernel K2; others take the reference's
    rank scatter (compaction.py:83-101): each valid point's rank among the
    valid points is its slot, written by a scatter of unique indices."""
    n = cloud.capacity
    capacity_out = capacity_out or n
    if n % 128:
        return _rank_scatter(cloud, capacity_out)
    pts = cloud.points
    bins = torch.stack(
        [pts[..., 0], pts[..., 1], pts[..., 2], cloud.valid.to(torch.float32)], dim=-2
    )
    loc, count, vals = compact_and_gather_exact(
        bins, cloud.valid.reshape(*cloud.valid.shape[:-1], n // 128, 128), capacity_out
    )
    out_valid = torch.arange(capacity_out, device=cloud.device) < torch.clamp_max(
        count, capacity_out
    )[..., None]
    cols = [torch.where(out_valid, vals[..., c], 0.0) for c in range(3)]
    return CompactResult(
        cloud=Cloud(points=torch.stack(cols, dim=-1), valid=out_valid),
        count=torch.clamp_max(count, capacity_out),
        source_index=torch.where(out_valid, loc, 0),
        overflow=count > capacity_out,
    )


def _rank_scatter(cloud: Cloud, capacity_out: int) -> CompactResult:
    """``compact`` for capacities off the 128 grid: slots past the count
    hold zeros (source index 0); a slot's point is the input point as it
    is (the reference's ``.at[ids].set``)."""
    valid = cloud.valid
    lead, n = valid.shape[:-1], valid.shape[-1]
    pos = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    ids = torch.where(valid & (pos < capacity_out), pos, capacity_out).long()  # the drop slot
    pts = torch.zeros(*lead, capacity_out + 1, 3, dtype=torch.float32, device=cloud.device)
    pts.scatter_(-2, ids[..., None].expand(*lead, n, 3), cloud.points)
    src = torch.zeros(*lead, capacity_out + 1, dtype=torch.int32, device=cloud.device)
    src.scatter_(-1, ids, torch.arange(n, dtype=torch.int32, device=cloud.device).expand(
        *lead, n))
    count = valid.sum(dim=-1, dtype=torch.int32)
    out_valid = torch.arange(capacity_out, device=cloud.device) < count[..., None]
    return CompactResult(
        cloud=Cloud(points=pts[..., :capacity_out, :], valid=out_valid),
        count=torch.clamp_max(count, capacity_out),
        source_index=src[..., :capacity_out],
        overflow=count > capacity_out,
    )


def extract_indices(cloud: Cloud, keep: torch.Tensor, negative: bool = False) -> Cloud:
    """pcl::ExtractIndices as a mask op (setNegative -> ``negative=True``)."""
    return Cloud(points=cloud.points, valid=cloud.valid & (keep ^ negative))
