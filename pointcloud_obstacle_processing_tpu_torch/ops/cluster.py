"""Euclidean cluster extraction (pcl::EuclideanClusterExtraction).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/cluster.py``:
connected components of the "distance <= tolerance" graph by min-label
propagation over the compacted non-plane buffer.

* the cloud is centered; consecutive-rank points within a margin of the
  tolerance seed each run with its head index;
* each sweep computes ``min(label[i], label[label[i]], neighbour labels)``,
  then hooks each point's minimum onto its root;
* the full sweep's loop runs on the card as one launch: K4's loop kernel
  (``loop_kernel``, ``csrc/cluster_loop.cu``, one thread-block cluster a
  scan) up to ``LOOP_MAX_CAPACITY`` points, the grid-wide loop kernel
  (``grid_loop``, ``csrc/cluster_grid_loop.cu``, one cooperative grid over
  every SM) above it; CPU tensors take ``cluster_loop_plain``.  The
  per-sweep form (``per_sweep_loop``: one launch of ``sweep_jump``,
  ``csrc/cluster_sweep.cu``, a sweep, the hook in PyTorch) is off every
  path, kept as the yardstick ``chip_smoke.py`` times beside them;
* the points and |p|^2 do not change within a clustering: they are laid
  out once for the sweeps, as the [C, 4] rows the loop kernels and K5 read
  (``pack_points``), or the [4, C] channel rows the per-sweep K4 reads
  (``point_channels``);
* with ``band_window`` the sweep is banded: query tile t (128 rows) scores
  only the ``band_window`` columns at ``starts[t]`` (``band_starts``, from
  the x envelopes of the lattice-ordered cloud), tiles whose window saw no
  label change in the previous sweep write their labels through, and each
  sweep ends with one full-array pointer jump (kernel K5,
  ``csrc/cluster_sweep_banded.cu``; ``sweep_jump_banded_plain`` for CPU
  tensors);
* sweeps repeat until no label changes, at most ``max_iters`` times.  The
  loop kernels test that on the card; the banded loop (and the per-sweep
  form) read ``changed.any()`` back to the host once per sweep after the
  first, and ``ClusterOutput.host_syncs`` counts those reads.

The reference tracks the frontier only on its TPU path; the port tracks it
on every device, which is output-identical (see ``sweep_jump_banded``).

A batch of clouds (``[B, C]``) clusters each scan on its own: the loop
kernels take the scan as a grid coordinate in one launch, each scan
stopping at its own convergence, and every other step takes the scan axis
as it comes.  The per-sweep K4 and the banded K5 take one scan at a time;
the banded loop refuses a batch of more than one.

Slots are assigned by size descending, ties by smaller root.  The reference
relies on ``lax.top_k`` being stable; ``torch.topk`` is not, so the order
comes from a stable sort.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import add_sq3, dot3, f32, fma, sqrt32, sum_like_xla, sum_sq3
from .. import _build
from ..types import Cloud, ClusterSet, PointIndicesArray, PointWithRad, batch_of, scan_of

__all__ = [
    "euclidean_cluster",
    "point_channels",
    "pack_points",
    "cluster_centroids",
    "sweep_jump",
    "sweep_jump_plain",
    "band_starts",
    "sweep_jump_banded",
    "sweep_jump_banded_plain",
    "cluster_loop",
    "cluster_loop_plain",
    "loop_kernel",
    "per_sweep_loop",
    "grid_loop",
    "ClusterOutput",
    "LoopOutput",
    "LOOP_MAX_CAPACITY",
    "LOOP_BATCH_BLOCKS",
]

BAND_TILE = 128  # query rows per tile of the banded sweep
# The loop kernel keeps every point in each block's shared memory and
# splits the rows over one thread-block cluster of 16 blocks (8 where 16
# does not fit); it fits up to 11,136 points on an H100.  Above this
# capacity the grid-wide loop kernel takes the loop.  Timed on the same
# buffers (chip_smoke.py's "loop crossover:" lines, H100 80GB HBM3, 700 W),
# the loop kernel was faster at 1,024 and 2,048 points with 5/8 or all of
# the rows valid, at 3,072 only with 5/8 (0.128 against 0.149 ms; all
# valid 0.275 against 0.150), and slower from 4,096 up: one thread-block
# cluster stays on 16 SMs, the grid-wide loop spreads over all of them.
LOOP_MAX_CAPACITY = 2048
# Blocks a scan of the loop kernel's launch for a batch (a cluster of 16
# blocks a scan fits about 8 scans on the card at once; fewer blocks a scan
# run more scans at once, each slower).  Timed at 1-16 blocks on the
# flagship batch of 32 (chip_smoke.py's "loop blocks" lines).
LOOP_BATCH_BLOCKS = 4


def _norms(p, p_sq):
    """|p|^2 as the reference's sweeps compute it, unless given (it does
    not change across the sweeps of one clustering)."""
    return sum_sq3(p[..., 0], p[..., 1], p[..., 2]) if p_sq is None else p_sq


def point_channels(p, p_sq=None) -> torch.Tensor:
    """[4, C] float32 rows x, y, z, |p|^2 (``sum_sq3`` unless given): the
    sweep points as kernel K4 reads them, laid out once per clustering."""
    return torch.stack([p[:, 0], p[:, 1], p[:, 2], _norms(p, p_sq)])


def pack_points(p, p_sq=None) -> torch.Tensor:
    """[C, 4] float32 rows (x, y, z, |p|^2) (``sum_sq3`` unless given): the
    sweep points as the loop kernel and K5 read them, laid out once per
    clustering ([B, C, 4] for a batch)."""
    return torch.cat([p, _norms(p, p_sq)[..., None]], dim=-1)


def sweep_jump_plain(pch, valid, labels, tol2: float) -> torch.Tensor:
    """Plain PyTorch version of kernel K4 (the reference's ``_xla_sweep_jump``
    contract): min over {label[i]} ∪ {label_col[label[i]]} ∪ neighbours.
    ``pch``: ``point_channels``' [4, C] rows."""
    n = labels.shape[0]
    x, y, z, p_sq = pch
    t2 = f32(tol2)
    labels_col = torch.where(valid, labels, n)
    # the pointer jump (column labels[i]) and the own label, then the
    # neighbours; rows and columns past the last valid one have none
    out = torch.minimum(labels_col[labels.long()], labels)
    hi = int(valid.nonzero().max()) + 1 if bool(valid.any()) else 0
    for r0 in range(0, hi, 256):  # 256-row tiles bound the [T, C] temporaries
        r = slice(r0, min(r0 + 256, hi))
        cross = dot3(x[r, None], y[r, None], z[r, None], x[None, :hi], y[None, :hi], z[None, :hi])
        d2 = (p_sq[r, None] + p_sq[None, :hi]) - 2.0 * cross
        adj = (d2 <= t2) & valid[None, :hi] & valid[r, None]
        cand = torch.where(adj, labels_col[None, :hi], n)
        out[r] = torch.minimum(cand.min(dim=1).values, out[r])
    return out


def sweep_jump(pch, valid, labels, tol2: float) -> torch.Tensor:
    """One fused neighbour-min + pointer-jump sweep: kernel K4 for CUDA
    tensors, the plain version for CPU tensors.  ``pch``:
    ``point_channels``' [4, C] rows, which the kernel reads as they are."""
    if pch.device.type == "cpu":
        return sweep_jump_plain(pch, valid, labels, tol2)
    n = labels.shape[0]
    if pch.shape != (4, n) or valid.shape != (n,) or labels.shape != (n,):
        raise ValueError("sweep_jump: point channels [4, C], valid [C] and labels [C]")
    _build.require_cuda("sweep_jump", pch, valid, labels,
                        dtypes=[torch.float32, torch.bool, torch.int32])
    x, y, z, p_sq = pch
    lib = _build.kernels()
    out = torch.empty(n, dtype=torch.int32, device=pch.device)
    err = lib.pcp_cluster_sweep(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), p_sq.data_ptr(), valid.data_ptr(),
        labels.data_ptr(), n, float(np.float32(tol2)), out.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_sweep")
    _build.LAUNCHES["cluster_sweep"] += 1
    return out


def band_starts(p, valid, tile: int, window: int, tolerance: float):
    """Column-window start of each ``tile``-row query tile of the banded
    sweep, and whether some tile's edges reach past its window (the
    reference's ``_band_starts``).

    With the masked prefix max of x (``runmax``) and suffix min
    (``runmin_r``): ``lo(t)`` counts the columns with ``runmax < min_x(t) -
    tol``, ``hi(t)`` is n less the columns with ``runmin_r > max_x(t) +
    tol``; ``start = clamp(lo, 0, n - window)`` aligned down to 128 and
    ``overflow = any(hi - start > window)``.  Max and min are exact, so the
    starts equal the reference's.  Returns (starts [n // tile] int32,
    overflow [] bool).
    """
    n = p.shape[0]
    tiles = n // tile
    tol = f32(tolerance)
    x = p[:, 0]
    runmax = torch.cummax(torch.where(valid, x, -torch.inf), dim=0).values
    runmin_r = torch.cummin(torch.where(valid, x, torch.inf).flip(0), dim=0).values.flip(0)
    xt = x.reshape(tiles, tile)
    vt = valid.reshape(tiles, tile)
    tmin = torch.where(vt, xt, torch.inf).min(dim=1).values
    tmax = torch.where(vt, xt, -torch.inf).max(dim=1).values
    lo = (runmax[None, :] < (tmin - tol)[:, None]).sum(dim=1)
    hi = n - (runmin_r[None, :] > (tmax + tol)[:, None]).sum(dim=1)
    start = torch.clamp(lo, 0, n - window) // 128 * 128
    return start.to(torch.int32), ((hi - start) > window).any()


def sweep_jump_banded_plain(pk, valid, labels, tol2: float, tile: int, window: int, starts,
                            tile_live=None) -> torch.Tensor:
    """Plain PyTorch version of kernel K5 (the reference's
    ``_xla_sweep_jump_banded`` contract): for row i of tile t,
    ``min(labels[i], labels_col[j])`` over the window columns j in
    ``[starts[t], starts[t] + window)`` that are neighbours of i or equal
    ``labels[i]``.  Tiles with ``tile_live[t]`` False write ``labels``
    through, as the kernel skips them.  ``pk``: ``pack_points``' [C, 4]
    rows."""
    n = labels.shape[0]
    tiles = n // tile
    dev = pk.device
    x, y, z, p_sq = pk.unbind(1)
    t2 = f32(tol2)
    labels_col = torch.where(valid, labels, n)
    w_ids = torch.arange(window, device=dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for t0 in range(0, tiles, 8):  # 8 tiles per [t, T, W] block bound the temporaries
        t1 = min(t0 + 8, tiles)
        cols = starts[t0:t1].long()[:, None] + w_ids  # [t, W]
        rows = slice(t0 * tile, t1 * tile)
        q = [v[rows].reshape(t1 - t0, tile, 1) for v in (x, y, z, p_sq, labels, valid)]
        cs = [v[cols][:, None, :] for v in (x, y, z)]  # [t, 1, W]
        cross = dot3(q[0], q[1], q[2], *cs)
        d2 = (q[3] + p_sq[cols][:, None, :]) - 2.0 * cross
        adj = (d2 <= t2) & valid[cols][:, None, :] & q[5]
        hit = adj | (q[4] == cols[:, None, :])
        cand = torch.where(hit, labels_col[cols][:, None, :], n)
        out[rows] = torch.minimum(cand.min(dim=2).values, q[4][:, :, 0]).reshape(-1)
    if tile_live is not None:
        out = torch.where(tile_live[:, None].expand(tiles, tile).reshape(n), out, labels)
    return out


def sweep_jump_banded(pk, valid, labels, tol2: float, tile: int, window: int, starts,
                      tile_live=None) -> torch.Tensor:
    """One banded neighbour-min + in-window pointer-jump sweep: kernel K5 for
    CUDA tensors, the plain version for CPU tensors.  ``pk``:
    ``pack_points``' [C, 4] rows, which the kernel reads as they are.

    A tile is skipped (its labels written through) where ``tile_live`` is
    False or it holds no valid row.  Both skips leave the cluster loop's
    result unchanged: a padding row's sweep value is its own label anyway,
    and for a tile whose window saw no label change the hook that follows
    reads the same minima (the reference's skip note,
    ``_pallas_sweep_jump_banded``)."""
    if pk.device.type == "cpu":
        return sweep_jump_banded_plain(pk, valid, labels, tol2, tile, window, starts, tile_live)
    n = labels.shape[0]
    if tile != BAND_TILE or n % tile or window % 128 or not tile <= window < n:
        raise ValueError(
            f"sweep_jump_banded: needs tile {BAND_TILE}, a capacity divisible by it and "
            f"a window that is a multiple of 128 below the capacity (got tile={tile}, "
            f"window={window}, capacity={n})"
        )
    tiles = n // tile
    if pk.shape != (n, 4) or valid.shape != (n,) or labels.shape != (n,) or \
            starts.shape != (tiles,) or (tile_live is not None and tile_live.shape != (tiles,)):
        raise ValueError("sweep_jump_banded: packed points [C, 4], valid and labels [C], "
                         "starts and tile_live [C / 128]")
    if pk.data_ptr() % 16:
        raise ValueError("sweep_jump_banded: the packed points must be 16-byte aligned")
    ops = [pk, valid, labels, starts]
    dtypes = [torch.float32, torch.bool, torch.int32, torch.int32]
    if tile_live is not None:
        ops.append(tile_live)
        dtypes.append(torch.bool)
    _build.require_cuda("sweep_jump_banded", *ops, dtypes=dtypes)
    lib = _build.kernels()
    out = torch.empty(n, dtype=torch.int32, device=pk.device)
    err = lib.pcp_cluster_sweep_banded(
        pk.data_ptr(), valid.data_ptr(), labels.data_ptr(), starts.data_ptr(),
        None if tile_live is None else tile_live.data_ptr(), n, window,
        float(np.float32(tol2)), out.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_sweep_banded")
    _build.LAUNCHES["cluster_sweep_banded"] += 1
    return out


def _hook(labels, nbr_min):
    """Each point's neighbourhood minimum onto its root (scatter-min; the
    same int32 minima as the reference's one-hot form), then the new
    labels ``min(labels, upd, nbr_min)``."""
    n = labels.shape[0]
    upd = torch.full((n,), n, dtype=torch.int32, device=labels.device)
    upd.scatter_reduce_(0, labels.long(), nbr_min, reduce="amin", include_self=True)
    return torch.minimum(torch.minimum(labels, upd), nbr_min)


class LoopOutput(NamedTuple):  # a leading [B] on the tensors for a batch
    labels: torch.Tensor  # [C] int32 after the last sweep
    unconverged: torch.Tensor  # [] bool: the last sweep changed a label
    sweeps: int | torch.Tensor  # sweeps run (a 0-d int32 tensor from the kernel)
    host_syncs: int  # device-to-host reads the loop made


def _sweep_loop(sweep, labels, max_iters: int) -> LoopOutput:
    """Sweep and hook until no label changes, at most ``max_iters`` times;
    the change test is read on the host after each sweep but the last (the
    first sweep always runs: the reference's loop state starts with every
    point "changed").  One scan."""
    host_syncs = 0
    changed = torch.ones(labels.shape[0], dtype=torch.bool, device=labels.device)
    sweeps = 0
    for it in range(max_iters):
        new = _hook(labels, sweep(labels))
        changed = new != labels
        labels = new
        sweeps += 1
        if it + 1 < max_iters:
            host_syncs += 1
            if not bool(changed.any()):
                break
    return LoopOutput(labels, changed.any(), sweeps, host_syncs)


def _stack(outs: list[LoopOutput]) -> LoopOutput:
    """The loops of a batch's scans as one batched output."""
    return LoopOutput(
        torch.stack([o.labels for o in outs]), torch.stack([o.unconverged for o in outs]),
        torch.tensor([int(o.sweeps) for o in outs], dtype=torch.int32),
        sum(o.host_syncs for o in outs),
    )


def cluster_loop_plain(pk, valid, labels, tol2: float, max_iters: int) -> LoopOutput:
    """Plain PyTorch version of the loop kernel: ``sweep_jump_plain`` and
    the hook, sweep after sweep, scan by scan for a batch.  ``pk``:
    ``pack_points``' [C, 4] rows ([B, C, 4] for a batch)."""
    if pk.dim() > 2:
        return _stack([cluster_loop_plain(pk[b], valid[b], labels[b], tol2, max_iters)
                       for b in range(pk.shape[0])])
    pch = pk.T
    return _sweep_loop(lambda lab: sweep_jump_plain(pch, valid, lab, tol2), labels, max_iters)


@functools.cache
def _loop_blocks(n: int, nb: int = 0) -> int:
    """Blocks a scan of the loop kernel's thread-block cluster at capacity
    ``n``: with ``nb`` 0 the one-scan choice (16 or 8), else ``nb``; 0
    where no such cluster fits this card."""
    return max(0, _build.kernels().pcp_cluster_loop_blocks(n, nb))


def cluster_loop(pk, valid, labels, tol2: float, max_iters: int) -> LoopOutput:
    """The full-sweep cluster loop from the seeded ``labels``, in one launch
    with no host read (a batch included): for CUDA tensors the loop kernel
    up to ``LOOP_MAX_CAPACITY`` points, the grid-wide loop kernel above it;
    the plain version for CPU tensors.  ``pk``: ``pack_points``' [C, 4]
    rows, or [B, C, 4] for a batch."""
    if pk.device.type == "cpu":
        return cluster_loop_plain(pk, valid, labels, tol2, max_iters)
    if pk.shape[-1] != 4 or pk.dim() > 3 or valid.shape != pk.shape[:-1] or \
            labels.shape != valid.shape:
        raise ValueError("cluster_loop: packed points [C, 4], valid [C] and labels [C] "
                         "(a leading [B] on each for a batch)")
    if pk.shape[-2] > LOOP_MAX_CAPACITY:
        return grid_loop(pk, valid, labels, tol2, max_iters)
    return loop_kernel(pk, valid, labels, tol2, max_iters)


def per_sweep_loop(pk, valid, labels, tol2: float, max_iters: int) -> LoopOutput:
    """The loop as one K4 launch a sweep, the hook in PyTorch and a host
    read of the change test after each sweep but the last (CUDA tensors,
    one scan).  Off every path: ``chip_smoke.py`` times it beside the two
    loop kernels."""
    pch = pk.T.contiguous()
    return _sweep_loop(lambda lab: sweep_jump(pch, valid, lab, tol2), labels, max_iters)


def grid_loop(pk, valid, labels, tol2: float, max_iters: int) -> LoopOutput:
    """The whole loop in one cooperative launch of the grid-wide loop kernel
    (``csrc/cluster_grid_loop.cu``; CUDA tensors, any capacity, a batch
    included): the points stay in global memory, the sweep is split over
    (scan, query tile, column chunk) work items on every SM, and two
    grid-wide barriers a sweep end the sweep and the hook (with the change
    test).  Raises if the card cannot hold the grid co-resident."""
    n = pk.shape[-2]
    lead = pk.shape[:-2]
    batch = pk[..., 0, 0].numel()
    _build.require_cuda("cluster_grid_loop", pk, valid, labels,
                        dtypes=[torch.float32, torch.bool, torch.int32])
    if pk.data_ptr() % 16:
        raise ValueError("cluster_grid_loop: the packed points must be 16-byte aligned")
    lib = _build.kernels()
    out = torch.empty(*lead, n, dtype=torch.int32, device=pk.device)
    unconverged = torch.empty(lead, dtype=torch.bool, device=pk.device)
    sweeps = torch.empty(lead, dtype=torch.int32, device=pk.device)
    scratch = torch.empty(5 * batch * n + 4 * batch, dtype=torch.int32, device=pk.device)
    err = lib.pcp_cluster_grid_loop(
        pk.data_ptr(), valid.data_ptr(), labels.data_ptr(), batch, n, float(np.float32(tol2)),
        int(max_iters), out.data_ptr(), unconverged.data_ptr(),
        sweeps.data_ptr(), scratch.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_grid_loop")
    _build.LAUNCHES["cluster_grid_loop"] += 1
    return LoopOutput(out, unconverged, sweeps, 0)


def loop_kernel(pk, valid, labels, tol2: float, max_iters: int,
                blocks: int | None = None) -> LoopOutput:
    """The whole loop in one launch of the loop kernel (CUDA tensors, at any
    capacity whose points fit a block's shared memory): one thread-block
    cluster of ``blocks`` blocks a scan (by default 16 or 8 for one scan,
    ``LOOP_BATCH_BLOCKS`` for a batch where it fits)."""
    n = pk.shape[-2]
    lead = pk.shape[:-2]
    batch = pk[..., 0, 0].numel()
    _build.require_cuda("cluster_loop", pk, valid, labels,
                        dtypes=[torch.float32, torch.bool, torch.int32])
    if pk.data_ptr() % 16:
        raise ValueError("cluster_loop: the packed points must be 16-byte aligned")
    if blocks is None:
        blocks = (batch > 1 and _loop_blocks(n, LOOP_BATCH_BLOCKS)) or _loop_blocks(n)
    elif blocks not in (1, 2, 4, 8, 16) or not _loop_blocks(n, blocks):
        blocks = 0
    if not blocks:
        raise RuntimeError(f"cluster_loop: no thread-block cluster of the requested blocks "
                           f"with {n} points in shared memory fits this card")
    lib = _build.kernels()
    out = torch.empty(*lead, n, dtype=torch.int32, device=pk.device)
    unconverged = torch.empty(lead, dtype=torch.bool, device=pk.device)
    sweeps = torch.empty(lead, dtype=torch.int32, device=pk.device)
    err = lib.pcp_cluster_loop(
        pk.data_ptr(), valid.data_ptr(), labels.data_ptr(), batch, n, float(np.float32(tol2)),
        int(max_iters), blocks, out.data_ptr(), unconverged.data_ptr(),
        sweeps.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "cluster_loop")
    _build.LAUNCHES["cluster_loop"] += 1
    return LoopOutput(out, unconverged, sweeps, 0)


class ClusterOutput(NamedTuple):  # a leading [B] on the tensors for a batch
    clusters: ClusterSet
    labels: torch.Tensor  # [C] int32 component roots (min index), self for invalid
    root_slot: torch.Tensor  # [C] int32 root index -> slot id or -1
    overflow: torch.Tensor  # [] bool: more gated clusters than max_clusters
    band_overflow: torch.Tensor  # [] bool: a tile's edges reach past its band window
    unconverged: torch.Tensor  # [] bool: max_iters hit with changes pending
    host_syncs: int = 0  # device-to-host reads made by the sweep loop


def _banded_loop(pk, valid, labels, tol2: float, band_window: int, starts, max_iters: int):
    """The banded sweep's loop: frontier-gated K5 sweeps, the hook and one
    full-array pointer jump a sweep; one host read a sweep after the first.
    Returns (labels, unconverged, host_syncs)."""
    n = labels.shape[0]
    win_hi = (starts + (band_window - 1)).long()
    win_lo = (starts - 1).clamp_min(0).long()
    host_syncs = 0
    changed = torch.ones(n, dtype=torch.bool, device=labels.device)
    for it in range(max_iters):
        # frontier: a tile is live when a label in its window changed in
        # the previous sweep (a prefix-sum difference per window)
        cs = torch.cumsum(changed, dim=0, dtype=torch.int32)
        tile_live = (cs[win_hi] - torch.where(starts > 0, cs[win_lo], 0)) > 0
        nbr_min = sweep_jump_banded(pk, valid, labels, tol2, BAND_TILE, band_window, starts,
                                    tile_live)
        new = _hook(labels, nbr_min)
        # window-unlimited pointer jump: a root outside a tile's window is
        # out of the sweep's reach; one full-array jump per sweep keeps the
        # doubling (labels[i] names an in-component point <= i)
        new = torch.minimum(new, new[new.long()])
        changed = new != labels
        labels = new
        if it + 1 < max_iters:
            host_syncs += 1
            if not bool(changed.any()):
                break
    return labels, changed.any(), host_syncs


def _seed_labels(pts, valid, tolerance: float):
    """The loop's start: the centered points, their |p|^2 (``sum_sq3``,
    fixed for the whole loop) and the chain-seeded labels (one cloud
    [C, 3], or each scan of a batch [B, C, 3])."""
    n = pts.shape[-2]
    dev = pts.device
    denom = torch.clamp_min(valid.sum(dim=-1, dtype=torch.float32), 1.0)[..., None]
    # the centre's sums in XLA:CPU's order (bitwise the reference's)
    sums = sum_like_xla(torch.where(valid[..., None], pts, 0.0).transpose(-1, -2))
    center = sums / denom  # [..., 3]
    p = torch.where(valid[..., None], pts - center[..., None, :], 0.0)
    tol2 = float(tolerance) ** 2
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    # chain seeding: consecutive-rank points within tolerance (with an
    # absolute margin for the expanded-form error of the sweep's d2) are
    # real edges; seed each run with its head index
    prev = torch.cat([p[..., :1, :], p[..., :-1, :]], dim=-2)
    dp = p - prev
    gap2 = sum_sq3(dp[..., 0], dp[..., 1], dp[..., 2])
    prev_valid = torch.nn.functional.pad(valid[..., :-1], (1, 0), value=False)
    p_sq = sum_sq3(p[..., 0], p[..., 1], p[..., 2])  # the sweeps' |p|^2, fixed for the loop
    maxsq = torch.where(valid, p_sq, 0.0).max(dim=-1).values
    seed_thresh = f32(tol2 * (1.0 - 1e-6)) - maxsq * (2.0**-20)
    chain = valid & prev_valid & (gap2 <= seed_thresh[..., None])
    head = valid & ~chain
    run_head = torch.cummax(torch.where(head, idx, -1), dim=-1).values
    labels = torch.where(valid, run_head, idx).to(torch.int32)
    return p, p_sq, labels


def euclidean_cluster(cloud: Cloud, tolerance: float, min_size: int, max_size: int,
                      max_clusters: int, max_iters: int = 64,
                      band_window: int = 0) -> ClusterOutput:
    """Connected components + size gate + size-descending slot assignment,
    of one cloud or of each scan of a batch.

    ``band_window`` takes the banded sweep where the reference does: a
    window of 128 columns or more, below the capacity, and a capacity
    divisible by 128; otherwise the full sweep runs."""
    cloud, single = batch_of(cloud)
    res = _euclidean_cluster(cloud, tolerance, min_size, max_size, max_clusters, max_iters,
                             band_window)
    return scan_of(res) if single else res


def _euclidean_cluster(cloud: Cloud, tolerance: float, min_size: int, max_size: int,
                       max_clusters: int, max_iters: int, band_window: int) -> ClusterOutput:
    pts = cloud.points
    valid = cloud.valid.contiguous()
    b, n = valid.shape
    dev = pts.device
    if max_clusters > n:
        raise ValueError(f"max_clusters={max_clusters} exceeds the cluster capacity {n}")

    p, p_sq, labels = _seed_labels(pts, valid, tolerance)
    tol2 = float(tolerance) ** 2
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    banded = bool(band_window) and BAND_TILE <= band_window < n and n % BAND_TILE == 0
    sweep_pts = pack_points(p, p_sq)  # the sweeps' operand, laid out once for the whole loop
    if banded:
        if b != 1:
            raise ValueError(f"euclidean_cluster: the banded sweep takes one scan at a time "
                             f"(got a batch of {b})")
        starts, band_overflow = band_starts(p[0], valid[0], BAND_TILE, band_window, tolerance)
        lab, unconverged, host_syncs = _banded_loop(sweep_pts[0], valid[0], labels[0], tol2,
                                                    band_window, starts, max_iters)
        labels, unconverged, band_overflow = lab[None], unconverged[None], band_overflow[None]
    else:
        band_overflow = torch.zeros(b, dtype=torch.bool, device=dev)
        labels, unconverged, _, host_syncs = cluster_loop(sweep_pts, valid, labels, tol2,
                                                          max_iters)

    # sizes and the size gate
    sizes_by_root = torch.zeros(b, n + 1, dtype=torch.int32, device=dev)
    sizes_by_root.scatter_add_(
        -1, torch.where(valid, labels, n).long(), torch.ones(b, n, dtype=torch.int32, device=dev)
    )
    sizes_by_root = sizes_by_root[:, :n]
    is_root = valid & (labels == idx)
    gate = is_root & (sizes_by_root >= min_size) & (sizes_by_root <= max_size)
    num_total = gate.sum(dim=-1, dtype=torch.int32)

    # slots: size descending, root ascending (stable sort on -size)
    gated_size = torch.where(gate, sizes_by_root, -1)
    top_roots = torch.sort(-gated_size, dim=-1, stable=True).indices[:, :max_clusters]
    slot_ids = torch.arange(max_clusters, dtype=torch.int32, device=dev)
    slot_valid = slot_ids < torch.clamp_max(num_total, max_clusters)[:, None]
    root_slot = torch.full((b, n + 1), -1, dtype=torch.int32, device=dev)
    root_slot.scatter_(-1, torch.where(slot_valid, top_roots, n), slot_ids.expand(b, -1))
    root_slot = root_slot[:, :n]

    point_cluster = torch.where(valid, root_slot.gather(-1, labels.long()), -1)
    slot_sizes = torch.where(slot_valid, sizes_by_root.gather(-1, top_roots), 0)
    clusters = ClusterSet(
        point_cluster=point_cluster,
        sizes=slot_sizes,
        valid=slot_valid,
        num_clusters=torch.clamp_max(num_total, max_clusters),
    )
    return ClusterOutput(
        clusters=clusters,
        labels=labels,
        root_slot=root_slot,
        overflow=num_total > max_clusters,
        band_overflow=band_overflow,
        unconverged=unconverged,
        host_syncs=host_syncs,
    )


def cluster_centroids(cloud: Cloud, clusters: ClusterSet) -> PointIndicesArray:
    """Per-cluster centroid + bounding radius as PointWithRad rows (one
    cloud, or each scan of a batch)."""
    m = clusters.sizes.shape[-1]
    pc = clusters.point_cluster
    slot = torch.arange(m, device=pc.device)
    member = (pc[..., :, None] == slot) & (pc >= 0)[..., None]  # [..., n, m]
    wm = member.to(torch.float32)
    pts = cloud.points
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    inv = 1.0 / torch.clamp_min(clusters.sizes.to(torch.float32), 1.0)  # [..., m]
    sums = [(wm * c[..., None]).sum(dim=-2) for c in (x, y, z)]
    cx, cy, cz = (s * inv for s in sums)
    # the reference fuses the centroid's product into the offset,
    # x - sum * inv with one rounding, and the squares as a written-out sum
    dx, dy, dz = (fma(-s[..., None, :], inv[..., None, :], c[..., None])
                  for s, c in zip(sums, (x, y, z)))
    d_all = sqrt32(add_sq3(dx, dy, dz))
    radii = torch.where(member, d_all, 0.0).max(dim=-2).values
    xyzr = torch.stack([cx, cy, cz, radii], dim=-1)
    xyzr = torch.where(clusters.valid[..., None], xyzr, 0.0)
    return PointIndicesArray(points=PointWithRad(xyzr=xyzr), valid=clusters.valid)
