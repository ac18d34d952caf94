"""Stable compaction with exact gather (kernel K2 and its plain version).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/compaction.py`` and
``ops/pallas_compaction.py``.  ``compact`` moves the valid points of a cloud
to the front in input order (PCL's index-order extraction) and shrinks the
buffer to ``capacity_out``; ``compact_and_gather_exact`` is the primitive
under it, which launches the CUDA kernel (``csrc/compaction.cu``) for CUDA
tensors and takes ``compact_and_gather_plain`` only for CPU tensors.
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


class CompactResult(NamedTuple):
    cloud: Cloud  # [capacity_out] valid-first compaction
    count: torch.Tensor  # [] int32 number of valid points moved
    source_index: torch.Tensor  # [capacity_out] int32 index into the input buffer
    overflow: torch.Tensor  # [] bool: valid points were dropped


def compact_and_gather_plain(bins: torch.Tensor, occ2d: torch.Tensor, capacity: int):
    """Plain PyTorch version of kernel K2: (loc [capacity] int32, num [] int32,
    vals [capacity, C] f32) with ``vals == bins.T[loc]`` for slots < num."""
    loc, num = compact_occupied_blocks(occ2d, capacity)
    vals = bins.T[loc.long()]
    return loc, num, vals


def compact_and_gather_exact(bins: torch.Tensor, occ2d: torch.Tensor, capacity: int):
    """Compaction + exact per-slot gather.

    ``bins``: [C, A*128] float32 channel-leading table; ``occ2d``: its
    [A, 128] occupancy.  Returns (loc, num, vals) as the plain version;
    slots at or past ``num`` are unspecified.
    """
    c, k = bins.shape
    a, b = occ2d.shape
    if b != 128 or a * b != k:
        raise ValueError("compact_and_gather_exact: occ2d must be the [K/128, 128] view of bins")
    if bins.device.type == "cpu":
        return compact_and_gather_plain(bins, occ2d, capacity)
    occ = occ2d.reshape(k)
    _build.require_cuda("compact_and_gather_exact", bins, occ, dtypes=[torch.float32, torch.bool])
    lib = _build.kernels()
    per_block = occ2d.sum(dim=1, dtype=torch.int32)
    offsets = torch.cumsum(per_block, dim=0, dtype=torch.int32)
    num = offsets[-1]
    excl = (offsets - per_block).contiguous()
    loc = torch.zeros(capacity, dtype=torch.int32, device=bins.device)
    vals = torch.zeros(capacity, c, dtype=torch.float32, device=bins.device)
    err = lib.pcp_compact_gather(
        bins.data_ptr(), occ.data_ptr(), excl.data_ptr(), c, k, capacity,
        loc.data_ptr(), vals.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "compact_gather")
    _build.LAUNCHES["compact_gather"] += 1
    return loc, num, vals


def compact(cloud: Cloud, capacity_out: int | None = None) -> CompactResult:
    """Move valid points to the front, stably; shrink to ``capacity_out``."""
    n = cloud.capacity
    capacity_out = capacity_out or n
    if n % 128:
        raise ValueError(
            f"compact needs a cloud capacity that is a multiple of 128 (got {n}); "
            "the reference's rank-scatter form for other capacities is not ported"
        )
    bins = torch.stack(
        [cloud.points[:, 0], cloud.points[:, 1], cloud.points[:, 2],
         cloud.valid.to(torch.float32)]
    )
    loc, count, vals = compact_and_gather_exact(
        bins, cloud.valid.reshape(n // 128, 128), capacity_out
    )
    out_valid = torch.arange(capacity_out, device=cloud.device) < torch.clamp_max(
        count, capacity_out
    )
    cols = [torch.where(out_valid, vals[:, c], 0.0) for c in range(3)]
    return CompactResult(
        cloud=Cloud(points=torch.stack(cols, dim=-1), valid=out_valid),
        count=torch.clamp_max(count, capacity_out),
        source_index=torch.where(out_valid, loc, 0),
        overflow=count > capacity_out,
    )


def extract_indices(cloud: Cloud, keep: torch.Tensor, negative: bool = False) -> Cloud:
    """pcl::ExtractIndices as a mask op (setNegative -> ``negative=True``)."""
    return Cloud(points=cloud.points, valid=cloud.valid & (keep ^ negative))
