"""Multi-scan batching and multi-device sharding.

Counterpart of the reference's ``parallel/sharding.py``:

* **Scan batching** (``batched_pipeline``, reference :69): the reference
  ``jax.vmap``s ``process_scan`` over a leading scan axis; here the scan
  axis is written out and every kernel takes the scan as a grid dimension,
  one launch a call for the whole batch.
* **Data parallel** (``data_parallel_pipeline``, :82): the batch split
  over a mesh's ``data`` axis, each rank running ``process_scan`` on its
  slice; scans are independent, so no collective runs.
* **Point sharding** (``process_scan_point_sharded``, :252, and
  ``dp_sp_pipeline``, :430): one scan's points split over a ``points``
  axis.  Each rank crops, histograms and voxelizes its shard; the counts
  are summed over the axis, the per-shard voxel tables merged (gathered
  and merged on every rank, or by key range, ``_distributed_merge``,
  :104), and stages 3-8 run on the merged cloud replicated on every rank,
  the kNN's query tiles and the cluster sweeps' query rows split over the
  axis (``shard_post_voxel``; bit for bit the replicated form).
  ``dp_sp_pipeline`` composes both over a 2-D (data, points) mesh.

The mesh is ``parallel.collectives``' (a row-major layout of
``torch.distributed`` ranks with one process group per axis line); what
the reference's ``shard_map`` hands each device, the caller's rank here
takes from the whole input itself (``dp_sp_pipeline`` and
``data_parallel_pipeline`` take the whole batch and return this rank's
scans).  Every rank must draw the same RANSAC hypotheses: a ``draw`` is
passed in, or made from ``generator`` on rank 0 and broadcast.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..ops.occupancy import cell_counts, holes
from ..ops.ransac import Draw, draw_from_uniform
from ..ops.runreduce import sorted_run_reduce
from ..ops.transforms import RigidTransform
from ..ops.voxel import (
    _SORT_MERGE_MIN_ROWS,
    VoxelPartials,
    _channelled_vals_to_partials,
    _pack_keys,
    _pack_spec,
    _packable,
    finalize_voxels,
    merge_voxel_partials,
    merge_voxel_partials_packed,
    voxel_partials,
)
from ..pipeline import _post_voxel, process_scan
from ..types import Cloud, PipelineResult
from .collectives import Axis, Mesh

__all__ = ["batched_pipeline", "data_parallel_pipeline", "process_scan_point_sharded",
           "dp_sp_pipeline"]


def batched_pipeline(config: PipelineConfig):
    """``Cloud[B, N]`` -> ``PipelineResult`` with a leading ``B`` on every
    field.  The callable takes the RANSAC draws (``draw``, [B, K, 3]
    indices a round) or a ``generator`` to make them, and the sensor pose
    (one for all scans, or ``[B]`` poses)."""
    config.validate()

    def fn(clouds: Cloud, draw: Draw | None = None, generator: torch.Generator | None = None,
           sensor_pose: RigidTransform | None = None) -> PipelineResult:
        if clouds.points.dim() != 3:
            raise ValueError(f"batched_pipeline: clouds must be [B, N, 3] (got "
                             f"{tuple(clouds.points.shape)})")
        return process_scan(clouds, config, sensor_pose, draw=draw, generator=generator)

    return fn


def _block(size: int, parts: int, index: int, what: str) -> slice:
    """Block ``index`` of ``size`` split into ``parts`` equal blocks."""
    if size % parts:
        raise ValueError(f"{what}: {size} does not split over {parts} ranks")
    per = size // parts
    return slice(index * per, (index + 1) * per)


def _shared_draw(config: PipelineConfig, generator, device, batch: int, mesh: Mesh) -> Draw:
    """Draws for a batch of ``batch`` scans made from ``generator`` on the
    mesh's first rank and broadcast to every rank of the mesh."""
    shape = (batch, config.max_planes, config.ransac_hypotheses, 3)
    u = torch.rand(shape, generator=generator, device=device)
    for axis in reversed(list(mesh.axes.values())):  # the leaders' rows, then every row
        u = axis.broadcast(u)
    return draw_from_uniform(u)


def _local_draw(draw: Draw, scans: slice, batch: int) -> Draw:
    """The draws of ``scans`` from a draw for the whole batch of ``batch``
    (every draw treats each scan on its own: the other scans' counts are
    placeholders)."""

    def local(r: int, n_valid: torch.Tensor) -> torch.Tensor:
        full = torch.zeros(batch, dtype=n_valid.dtype, device=n_valid.device)
        full[scans] = n_valid
        return draw(r, full)[scans]

    return local


def data_parallel_pipeline(config: PipelineConfig, mesh: Mesh, data_axis: str = "data"):
    """The batch split over the mesh's ``data`` axis: ``fn(clouds [B, N],
    draw=..., generator=...)`` runs ``process_scan`` on this rank's ``B /
    n_data`` scans (their draws from ``draw``, which covers the whole
    batch) and returns their results.  No collective runs but the draws'
    broadcast when they come from ``generator``."""
    config.validate()

    def fn(clouds: Cloud, draw: Draw | None = None,
           generator: torch.Generator | None = None) -> PipelineResult:
        axis = mesh[data_axis]
        batch = clouds.valid.shape[0]
        scans = _block(batch, axis.size, axis.rank, "data_parallel_pipeline")
        if draw is None:
            draw = _shared_draw(config, generator, clouds.device, batch, mesh)
        local = Cloud(points=clouds.points[scans], valid=clouds.valid[scans])
        return process_scan(local, config, draw=_local_draw(draw, scans, batch))

    return fn


def _distributed_merge(parts: VoxelPartials, config: PipelineConfig, axis: Axis,
                       spec=None) -> VoxelPartials:
    """Key-range distributed merge of the per-shard voxel tables (the
    reference's ``_distributed_merge``, sharding.py:104-249), each scan of
    a batch ([b, cap] tables) on its own.

    Rank s owns packed-key range [s*K/S, (s+1)*K/S).  Each shard's table is
    already ascending in lattice key, so the range splits are
    ``searchsorted`` boundaries (clamped to K, so that the last range does
    not swallow the sentinel rows); one all_to_all routes every range's
    chunk of ``chunk_cap`` rows (starting at ``min(b[r], cap -
    chunk_cap)``, rows outside the range masked) to its owner, which sorts
    its ``S * chunk_cap`` rows stably on the key (duplicates in source
    order) and reduces them with K1 in counts mode; one all_gather brings
    every range's ``[5, range_cap]`` table to every rank, written back in
    ascending range order at exclusive offsets, each start clamped to
    ``cap`` (range r's tail past its runs is overwritten by range r+1).  A
    chunk or range past its capacity raises ``overflow`` (ORed over the
    ranks); ``num_voxels`` is then the count of rows present, clamped per
    range, not the raw run count.

    Keys, counts and ``num_voxels`` equal the replicated merge's where
    nothing overflows; the float32 sums re-associate.  The exchange is
    destination-leading, [S, b, 5, chunk_cap] (``all_to_all_single`` splits
    the leading axis; the reference's channel-leading layout only avoided
    TPU lane padding), float32 with the keys exact (K <= 2^23)."""
    S = axis.size
    cap = config.max_voxels
    leaf = config.downsample_leaf_size
    if spec is None:
        spec = _pack_spec(((config.x_min, config.y_min, config.z_min),
                           (config.x_max, config.y_max, config.z_max)), leaf)
    dims = spec[1]
    K = dims[0] * dims[1] * dims[2]
    kstep = -(-K // S)
    chunk_cap = max(128, (2 * cap // S) // 128 * 128)
    range_cap = chunk_cap
    dev = parts.counts.device
    b = parts.counts.shape[0]

    packed = _pack_keys(parts.keys, parts.counts, spec)  # [b, cap] ascending
    bkeys = [min(r * kstep, K) for r in range(S + 1)]
    bounds = torch.searchsorted(
        packed, torch.tensor(bkeys, dtype=torch.int32, device=dev).expand(b, S + 1).contiguous())
    chunk_overflow = ((bounds[:, 1:] - bounds[:, :-1]) > chunk_cap).any(dim=-1)  # [b]

    payloads = torch.stack([packed.to(torch.float32), parts.sums[..., 0], parts.sums[..., 1],
                            parts.sums[..., 2], parts.counts], dim=1)  # [b, 5, cap]
    span = torch.arange(chunk_cap, device=dev)
    send = []
    for r in range(S):
        start = torch.clamp_max(bounds[:, r], cap - chunk_cap)  # [b]
        rows = payloads.gather(-1, (start[:, None] + span).expand(5, b, chunk_cap)
                               .transpose(0, 1))  # [b, 5, chunk_cap]
        key = rows[:, 0]
        in_range = (key >= bkeys[r]) & (key < bkeys[r + 1])
        send.append(torch.cat([torch.where(in_range, key, float(K))[:, None],
                               torch.where(in_range[:, None], rows[:, 1:], 0.0)], dim=1))
    # [S, b, 5, chunk_cap]: every shard's chunk of this rank's range
    recv = axis.all_to_all(torch.stack(send))
    flat = recv.permute(1, 2, 0, 3).reshape(b, 5, S * chunk_cap)  # source order
    sk, order = torch.sort(flat[:, 0].to(torch.int32), dim=-1, stable=True)
    pay = [flat[:, c].gather(-1, order) for c in range(1, 5)]
    vals_r, num_r = sorted_run_reduce(sk, pay, K, range_cap)  # counts mode
    range_overflow = num_r > range_cap

    vals_all = axis.all_gather(vals_r.transpose(-1, -2).contiguous()[None])  # [S, b, 5, range_cap]
    num_all = torch.clamp_max(axis.all_gather(num_r[None]), range_cap)  # [S, b]
    offs = torch.cumsum(num_all, dim=0) - num_all  # exclusive, in range order
    buf = torch.zeros(b, 5, cap + range_cap, dtype=torch.float32, device=dev)
    win = torch.arange(range_cap, device=dev)
    for r in range(S):  # ascending: range r+1 overwrites range r's tail
        at = (torch.clamp_max(offs[r], cap)[:, None] + win).expand(5, b, range_cap).transpose(0, 1)
        buf.scatter_(-1, at, vals_all[r])
    num = num_all.sum(dim=0, dtype=torch.int32)  # rows present (range-clamped)

    merged = _channelled_vals_to_partials(buf[..., :cap], num, K, spec, cap)
    overflow = merged.overflow | axis.any(chunk_overflow) | axis.any(range_overflow)
    return merged._replace(num_voxels=torch.clamp_max(num, cap), overflow=overflow)


def process_scan_point_sharded(cloud_shard: Cloud, config: PipelineConfig,
                               world_from_sensor: RigidTransform | None, axis: Axis,
                               draw: Draw, shard_post_voxel: bool = True,
                               distribute_merge: bool | None = None) -> PipelineResult:
    """The pipeline over this rank's shard of each scan of a batch (``[b, N /
    S]`` points; ``draw`` for the b scans), the shards spread over
    ``axis``; the result is replicated over the axis.

    ``shard_post_voxel`` splits the kNN's query tiles and the cluster
    sweeps' query rows over the axis (bit for bit the replicated form).
    ``distribute_merge`` merges the voxel tables by key range
    (``_distributed_merge``); None turns it on where the reference does,
    more than two shards and a gathered table of at least
    ``_SORT_MERGE_MIN_ROWS`` rows, and it falls back to the replicated
    merge where the key ranges cannot be laid out (``max_voxels`` not a
    multiple of 128, chunks under 128 rows).  A lattice that does not pack
    into one key gathers the (ix, iy, iz) tables and merges them by the
    3-key sort (the reference's unpackable branch).  RANSAC
    takes the reference's vmapped form (``dp_sp_pipeline`` vmaps the body
    even at a local batch of one)."""
    if config.voxel_order != "lattice":
        raise ValueError(
            "the point-sharded path only supports voxel_order='lattice' "
            f"(got {config.voxel_order!r}: the shard merge emits lattice order)"
        )
    config.validate()
    if cloud_shard.points.dim() != 3:
        raise ValueError("process_scan_point_sharded: a batch of shards, [b, N / S, 3]")
    dev = cloud_shard.device
    if world_from_sensor is None:
        world_from_sensor = RigidTransform.identity(dev)
    S = axis.size
    n_in = axis.psum(cloud_shard.count())

    # stage 1: the shard's histogram, summed over the axis
    in_box, counts_local = cell_counts(cloud_shard, config)
    counts = axis.psum(counts_local)
    _, hole_grid = holes(counts, config)
    n_cropped = axis.psum(in_box.sum(dim=-1, dtype=torch.int32))

    # stage 2: the shard's voxel table, merged over the axis
    bounds = ((config.x_min, config.y_min, config.z_min),
              (config.x_max, config.y_max, config.z_max))
    leaf = config.downsample_leaf_size
    parts = voxel_partials(Cloud(points=cloud_shard.points, valid=in_box), leaf,
                           config.max_voxels, bounds, config.voxel_sum_precision,
                           config.voxel_binning, config.voxel_order,
                           config.voxel_payload_packing)
    spec = _pack_spec(bounds, leaf)
    packable = _packable(spec)
    if distribute_merge is None:
        distribute_merge = S > 2 and S * config.max_voxels >= _SORT_MERGE_MIN_ROWS
    if (distribute_merge and S > 1 and packable and config.max_voxels % 128 == 0
            and 2 * config.max_voxels // S >= 128):
        merged = _distributed_merge(parts, config, axis, spec)
    elif packable:  # keys packed on each rank before the gather: 20 bytes a row
        merged = merge_voxel_partials_packed(
            axis.all_gather(_pack_keys(parts.keys, parts.counts, spec), dim=-1),
            axis.all_gather(parts.sums, dim=-2), axis.all_gather(parts.counts, dim=-1),
            config.max_voxels, spec, leaf, tables=S)
    else:  # the (ix, iy, iz) tables gathered, merged by the 3-key sort
        merged = merge_voxel_partials(
            VoxelPartials(keys=axis.all_gather(parts.keys, dim=-2),
                          sums=axis.all_gather(parts.sums, dim=-2),
                          counts=axis.all_gather(parts.counts, dim=-1),
                          num_voxels=parts.num_voxels, overflow=parts.overflow),
            config.max_voxels, bounds, leaf)
    vox = finalize_voxels(merged)

    # stages 3-8 on the merged cloud; a shard's own table overflow drops
    # voxels before the merge sees them, so its flag is ORed in too
    return _post_voxel(
        vox.cloud, vox.num_voxels, hole_grid, n_in, n_cropped, config, world_from_sensor, draw,
        vox.overflow | axis.any(parts.overflow), vmapped=True,
        shard=axis if shard_post_voxel and S > 1 else None,
    )


def dp_sp_pipeline(config: PipelineConfig, mesh: Mesh, data_axis: str = "data",
                   points_axis: str = "points", shard_post_voxel: bool = True,
                   distribute_merge: bool | None = None):
    """Scans over ``data``, each scan's points over ``points`` (a 2-D mesh):
    ``fn(clouds [B, N], draw=..., generator=..., sensor_pose=...)`` takes
    this rank's block ``[B / n_data, N / n_points]`` and returns its scans'
    results, replicated over ``points``.  The local batch runs as the
    kernels' batch dimension, RANSAC in its vmapped form (the reference
    vmaps the per-shard body even at a local batch of one); one sensor
    pose serves the batch (identity by default)."""
    config.validate()

    def fn(clouds: Cloud, draw: Draw | None = None, generator: torch.Generator | None = None,
           sensor_pose: RigidTransform | None = None) -> PipelineResult:
        d_ax, p_ax = mesh[data_axis], mesh[points_axis]
        batch, n = clouds.valid.shape
        scans = _block(batch, d_ax.size, d_ax.rank, "dp_sp_pipeline scans")
        points = _block(n, p_ax.size, p_ax.rank, "dp_sp_pipeline points")
        if draw is None:
            draw = _shared_draw(config, generator, clouds.device, batch, mesh)
        shard = Cloud(points=clouds.points[scans, points], valid=clouds.valid[scans, points])
        return process_scan_point_sharded(
            shard, config, sensor_pose, p_ax, _local_draw(draw, scans, batch),
            shard_post_voxel=shard_post_voxel, distribute_merge=distribute_merge)

    return fn
