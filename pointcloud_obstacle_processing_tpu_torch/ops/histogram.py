"""Histograms, weighted bin sums and block compaction.

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/mxu_histogram.py``.
The reference computes histograms as bf16 one-hot matmuls only to dodge
serialized TPU scatters.  On a GPU an int32 scatter-add is exact, so
``histogram2d`` (the reference's ``histogram2d_mxu``) counts directly.  The
weighted sums (``weighted_histogram_blocks``, the ``mxu`` voxel engine's)
take the reference's bf16 split terms and add each bin's terms in order
through ``ops.segfold.segment_fold``: XLA:CPU upcasts the one-hot operands
to float32 and sums each bin's terms, at most 8 significant bits each,
exactly unless a term lies below about 2^-16 of its bin's sum, so the
in-order fold is the same function with O(N) work instead of N * K
(``tests/test_torch_voxel_engines.py`` holds the two bitwise).
"""

from __future__ import annotations

import math

import torch

from .segfold import segment_fold

__all__ = ["histogram2d", "histogram2d_mxu", "compact_occupied_blocks",
           "weighted_histogram_mxu", "weighted_histogram_blocks", "weighted_bin_sums",
           "compact_and_gather_blocks", "MXU_HISTOGRAM_MAX_BINS"]

# the reference's bin limit of its one-hot engine (mxu_histogram.py:45): the
# ``mxu`` voxel engine refuses larger lattices
MXU_HISTOGRAM_MAX_BINS = 1 << 19

# above this many block rows the reference's compact_and_gather_blocks
# gathers the values directly (mxu_histogram.py:158)
_COMPACT_MXU_MAX_BLOCKS = 8192


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


histogram2d_mxu = histogram2d  # the reference's name (mxu_histogram.py:54)


def _traffic_optimal_hi(k: int) -> int:
    """The reference's hi-factor width A of a K-bin histogram (its TPU
    traffic optimum, A ~ sqrt(K/2) in multiples of 64 within [128, 512]);
    it fixes the [C, A, B] layout of ``weighted_histogram_blocks``."""
    a = int(math.sqrt(k / 2) / 64 + 0.5) * 64
    return max(128, min(512, a))


def weighted_bin_sums(ids: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor, k: int,
                      hi_size: int | None = None, exact_f32: bool = True, align: int = 1):
    """``(sums [..., C, width], a, b)``: the per-bin sums of
    ``weighted_histogram_blocks`` with bin id ``hi * b + lo`` at that
    position, ``a * b`` rounded up to a multiple of ``align`` (the bins past
    ``a * b`` are +0.0).  One stable sort of the ids and one
    ``segment_fold`` launch on the card, which gathers the raw weights by
    the sort's permutation and folds their split terms."""
    a = hi_size or _traffic_optimal_hi(k)
    b = -(-k // a)
    ids = torch.where(valid, ids, a * b).to(torch.int32)  # a * b: dropped
    skey, order = torch.sort(ids, dim=-1, stable=True)
    sums = segment_fold(skey, weights.transpose(-1, -2), a * b, order=order,
                        bf16_terms=2 if exact_f32 else 1, width=-(-(a * b) // align) * align)
    return sums, a, b


def weighted_histogram_blocks(ids: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor,
                              k: int, hi_size: int | None = None, exact_f32: bool = True):
    """Per-bin sums of the weights' bf16 split terms in the block form
    ``([..., C, A, B], a, b)``: position ``hi * b + lo`` is bin id.

    ``ids`` [..., N] int32, ``weights`` [..., N, C] float32, ``valid``
    [..., N]; a valid row whose id lies outside ``[0, a * b)`` adds nothing
    (the reference's one-hot rows are zero there).  Each weight enters as
    ``t0 = bf16(w)`` and, with ``exact_f32``, ``t1 = bf16(w - t0)``; each
    term's bin sums are folded in row order after a stable sort of the ids
    and the terms' sums added, ``part_t0 + part_t1``, as the reference adds
    its matmuls (mxu_histogram.py:130-140): ``weighted_bin_sums``, one
    ``segment_fold`` launch on the card."""
    sums, a, b = weighted_bin_sums(ids, weights, valid, k, hi_size, exact_f32)
    return sums.reshape(*sums.shape[:-1], a, b), a, b


def weighted_histogram_mxu(ids: torch.Tensor, weights: torch.Tensor, valid: torch.Tensor, k: int,
                           hi_size: int | None = None, exact_f32: bool = True) -> torch.Tensor:
    """``sums[..., j, c]``: the bin sums of ``weighted_histogram_blocks`` as
    [..., k, C]."""
    out, a, b = weighted_histogram_blocks(ids, weights, valid, k, hi_size, exact_f32)
    return out.reshape(*out.shape[:-2], a * b).transpose(-1, -2)[..., :k, :]


def compact_and_gather_blocks(bins: torch.Tensor, occ2d: torch.Tensor, capacity: int,
                              value_terms=2):
    """The reference's one-hot compaction with its values (mxu_histogram.py:
    243-345), off every path (the pipeline compacts with kernel K2):
    ``(loc [..., capacity] int32, num, values [..., capacity, C])`` for the
    channel-leading ``bins`` [..., C, A*B] and their [..., A, B] occupancy.

    Slots below ``num`` hold the occupied bins in ascending order, slots at
    or past it bin ``(A - 1) * B``.  Up to 8,192 block rows the reference
    gathers each value as ``value_terms`` bf16 split terms (an int, or one a
    channel) through a one-hot product, which is exact: a slot's value is
    its terms added in order from +0.0, 0 past ``num``.  Above that it
    gathers the raw values of every slot."""
    a, b = occ2d.shape[-2:]
    c = bins.shape[-2]
    per_channel = [value_terms] * c if isinstance(value_terms, int) else list(value_terms)
    loc, num = compact_occupied_blocks(occ2d, capacity, scan_dims=occ2d.dim() - 2)
    real = torch.arange(capacity, device=bins.device) < num[..., None]
    loc = torch.where(real, loc, (a - 1) * b)
    v = bins.gather(-1, loc.long()[..., None, :].expand(*loc.shape[:-1], c, capacity))
    if a > _COMPACT_MXU_MAX_BLOCKS:
        return loc, num, v.transpose(-1, -2)
    values = []
    for ci in range(c):
        resid, seg = v[..., ci, :], torch.zeros_like(v[..., ci, :])
        for _ in range(per_channel[ci]):
            t = resid.to(torch.bfloat16).to(torch.float32)
            seg = seg + t
            resid = resid - t
        # the one live lane's sum among zeros: +0.0 for a -0.0 value
        values.append(torch.where(real, seg + 0.0, 0.0))
    return loc, num, torch.stack(values, dim=-1)
