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
    """Exact [h, w] int32 histogram of (row, col) pairs.

    A pair counts only when ``valid`` and both ids lie in range (the
    reference's one-hot rows are zero for an out-of-range row OR column).
    Counted with an int32 scatter-add on the flat index rather than
    ``torch.bincount``, which reads its input's maximum back to the host on
    CUDA to size its output.
    """
    ok = valid & (row_ids >= 0) & (row_ids < h) & (col_ids >= 0) & (col_ids < w)
    flat = torch.where(ok, row_ids.long() * w + col_ids.long(), h * w)  # h*w: the drop bin
    counts = torch.zeros(h * w + 1, dtype=torch.int32, device=row_ids.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[: h * w].reshape(h, w)


def compact_occupied_blocks(occupied: torch.Tensor, capacity: int):
    """Indices of the first ``capacity`` True entries of an [A, B] grid.

    Returns (flat_idx [capacity] int32 ascending, num [] int32).  Slots at or
    past ``num`` hold 0.  The plain twin of kernels K1's and K2's slot
    assignment: a rank scatter, with no host sync.
    """
    occ = occupied.reshape(-1)
    rank = torch.cumsum(occ.to(torch.int32), dim=0) - 1
    num = occ.sum(dtype=torch.int32)
    slot = torch.where(occ & (rank < capacity), rank.long(), capacity)  # capacity: the drop slot
    src = torch.arange(occ.numel(), dtype=torch.int32, device=occ.device)
    loc = torch.zeros(capacity + 1, dtype=torch.int32, device=occ.device)
    loc.scatter_(0, slot, src)
    return loc[:capacity], num
