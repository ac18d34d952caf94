"""Integer histograms and block compaction.

Counterpart of the two pieces of ``pointcloud_obstacle_processing_tpu/ops/
mxu_histogram.py`` that the slice runs.  The reference computes histograms
as bf16 one-hot matmuls only to dodge serialized TPU scatters; on a GPU an
int32 scatter-add is exact, so ``histogram2d`` counts directly.
"""

from __future__ import annotations

import torch

__all__ = ["histogram2d", "compact_occupied_blocks"]


def histogram2d(
    row_ids: torch.Tensor, col_ids: torch.Tensor, valid: torch.Tensor, h: int, w: int
) -> torch.Tensor:
    """Exact [..., h, w] int32 histogram of the (row, col) pairs of each
    scan (``row_ids`` [..., N]).

    A pair counts only when ``valid`` and both ids lie in range (the
    reference's one-hot rows are zero for an out-of-range row OR column).
    Counted with one int32 scatter-add on the flat index, scan b's bins at
    ``b * h * w``, rather than ``torch.bincount``, which reads its input's
    maximum back to the host on CUDA to size its output.
    """
    lead = row_ids.shape[:-1]
    scans = row_ids[..., 0].numel()
    ok = valid & (row_ids >= 0) & (row_ids < h) & (col_ids >= 0) & (col_ids < w)
    offset = torch.arange(scans, device=row_ids.device).reshape(*lead, 1) * (h * w)
    # scans * h * w: the drop bin
    flat = torch.where(ok, offset + row_ids.long() * w + col_ids.long(), scans * h * w)
    counts = torch.zeros(scans * h * w + 1, dtype=torch.int32, device=row_ids.device)
    counts.scatter_add_(0, flat.reshape(-1), torch.ones(flat.numel(), dtype=torch.int32,
                                                       device=row_ids.device))
    return counts[: scans * h * w].reshape(*lead, h, w)


def compact_occupied_blocks(occupied: torch.Tensor, capacity: int, scan_dims: int = 0):
    """Indices of the first ``capacity`` True entries of an [A, B] grid, or
    of each scan's grid where the first ``scan_dims`` axes index scans.

    Returns (flat_idx [*scans, capacity] int32 ascending, num [*scans]
    int32).  Slots at or past ``num`` hold 0.  The plain twin of kernels
    K1's and K2's slot assignment: a rank scatter, with no host sync.
    """
    occ = occupied.reshape(*occupied.shape[:scan_dims], -1)
    rank = torch.cumsum(occ.to(torch.int32), dim=-1) - 1
    num = occ.sum(dim=-1, dtype=torch.int32)
    slot = torch.where(occ & (rank < capacity), rank.long(), capacity)  # capacity: the drop slot
    src = torch.arange(occ.shape[-1], dtype=torch.int32, device=occ.device).expand(occ.shape)
    loc = torch.zeros(*occ.shape[:-1], capacity + 1, dtype=torch.int32, device=occ.device)
    loc.scatter_(-1, slot, src)
    return loc[..., :capacity], num
