"""The scan -> obstacles pipeline in PyTorch.

Counterpart of ``pointcloud_obstacle_processing_tpu/pipeline.py``
(``process_scan`` and ``_post_voxel``), in the reference node's stage order
(obstacle_detection.cpp:699-927):

1. crop + occupancy histogram + crater/hole detection
2. VoxelGrid downsample (``voxel_binning``/``voxel_order``: the sort engine
   and kernel K1, the dense engines and kernel K2, or the 3-key fallback),
   or with ``downsample_input_data`` off the cropped cloud compacted into
   the ``max_voxels`` slots (kernel K2)
3. statistical outlier removal (``knn_backend``; the banded sorting network
   is kernel K3)
4. iterative RANSAC plane removal
5. compaction (kernel K2) + euclidean clustering (full sweep, kernel K4;
   banded sweep when ``cluster_band_window`` is set, kernel K5) + centroids
6. shadow casting, 7. obstacle marking

Every stage runs on the device of the input cloud.  The only host reads are
the cluster loop's per-sweep convergence checks (``PipelineResult.
host_syncs``).  While the program's tracing is on (``utils.timing``), a
call is a ``pcp.call`` span holding one ``pcp.stage.<stage>`` span a stage,
named as the stage's entry point (the voxel stage's compaction, with
``downsample_input_data`` off, included).

``process_scan`` takes one cloud ``[N]`` or a batch ``[B, N]`` (the
reference's ``jax.vmap``, written out): every stage runs on the batch, each
kernel once a call with the scan as a grid dimension, and one scan runs as
a batch of one.
"""

from __future__ import annotations

from functools import partial

import torch

from .config import PipelineConfig
from .ops.cluster import cluster_centroids, euclidean_cluster
from .ops.compaction import compact
from .ops.occupancy import crop_and_seed, mark_obstacles
from .ops.outliers import remove_statistical_outliers
from .ops.ransac import Draw, draw_from_uniform, segment_planes
from .ops.shadow import cast_shadows
from .ops.transforms import RigidTransform
from .ops.voxel import voxel_downsample
from .types import Cloud, OccupancyGrid, PipelineResult, StageStats, batch_of, scan_of
from .utils import timing

__all__ = ["process_scan", "process_frames", "jit_pipeline", "default_draw"]


def default_draw(config: PipelineConfig, generator: torch.Generator, device,
                 batch: int | None = None) -> Draw:
    """RANSAC draws from ``generator``: uniform numbers for every round (of
    each of ``batch`` scans) made up front, so the plane loop needs no host
    sync."""
    shape = (config.max_planes, config.ransac_hypotheses, 3)
    u = torch.rand(shape if batch is None else (batch, *shape), generator=generator,
                   device=device)
    return draw_from_uniform(u)


def process_scan(cloud: Cloud, config: PipelineConfig,
                 world_from_sensor: RigidTransform | None = None,
                 draw: Draw | None = None,
                 generator: torch.Generator | None = None) -> PipelineResult:
    """Full pipeline over one accumulated, world-frame cloud, or over each
    scan of a batch (every result field then has a leading ``B``).

    ``draw`` supplies the RANSAC hypotheses (see ``ops.ransac``: [K, 3]
    indices a round for one cloud, [B, K, 3] for a batch); without it they
    come from ``generator`` (or torch's default generator).
    ``world_from_sensor`` is the sensor pose for the shadow geometry,
    identity by default; a batch takes one pose for all or one a scan.
    """
    with timing.span("pcp.call"):
        dev = cloud.device
        cloud, single = batch_of(cloud)
        if world_from_sensor is None:
            world_from_sensor = RigidTransform.identity(dev)
        if draw is None:
            draw = default_draw(config, generator, dev, None if single else cloud.valid.shape[0])
        if single:
            one_draw = draw
            draw = lambda r, n_valid: one_draw(r, n_valid[0])[None]  # noqa: E731

        n_in = cloud.count()
        with timing.span("pcp.stage.crop_and_seed"):
            seed = crop_and_seed(cloud, config)
        cropped = seed.cloud
        # the voxel stage: the VoxelGrid, or the cropped cloud compacted
        # straight into the voxel slots
        with timing.span("pcp.stage.voxel_downsample"):
            if config.downsample_input_data:
                bounds = (
                    (config.x_min, config.y_min, config.z_min),
                    (config.x_max, config.y_max, config.z_max),
                )  # cropped points are in the box: the lattice key packs
                vox = voxel_downsample(
                    cropped, config.downsample_leaf_size, config.max_voxels, bounds,
                    config.voxel_sum_precision, config.voxel_binning, config.voxel_order,
                    config.voxel_payload_packing,
                )
                voxel_cloud, n_voxels, voxel_overflow = vox.cloud, vox.num_voxels, vox.overflow
            else:
                comp0 = compact(cropped, config.max_voxels)
                voxel_cloud, n_voxels, voxel_overflow = comp0.cloud, comp0.count, comp0.overflow
        res = _post_voxel(
            voxel_cloud, n_voxels, seed.hole_grid, n_in, cropped.count(), config,
            world_from_sensor, draw, voxel_overflow, vmapped=not single,
        )
        return scan_of(res) if single else res


def process_frames(frames: torch.Tensor, frame_valid: torch.Tensor, config: PipelineConfig,
                   world_from_sensor_per_frame: RigidTransform,
                   shadow_sensor_pose: RigidTransform | None = None,
                   draw: Draw | None = None,
                   generator: torch.Generator | None = None) -> PipelineResult:
    """Accumulate sensor-frame scans into a world cloud, then process
    (reference ``pipeline.process_frames``; the reference node's
    accumulation, obstacle_detection.cpp:691-698, on the device).

    ``frames`` [A, F, 3] and ``frame_valid`` [A, F] hold A frames of F
    slots; ``world_from_sensor_per_frame`` holds one pose a frame
    (``[A, 4]``, ``[A, 3]``).  Each frame is transformed by its own pose
    (the broadcasting ``apply``, bitwise the reference's ``jax.vmap`` of
    it), the frames are flattened in order, and the cloud goes through
    ``process_scan``.  A*F must equal ``config.max_points``.  The shadow
    geometry takes ``shadow_sensor_pose``, by default the last frame's pose
    (the reference node's latest tf lookup)."""
    A, F, _ = frames.shape
    if A * F != config.max_points:
        raise ValueError(f"A*F={A * F} != config.max_points={config.max_points}")
    world = world_from_sensor_per_frame.apply(frames)
    cloud = Cloud(points=world.reshape(A * F, 3), valid=frame_valid.reshape(A * F))
    if shadow_sensor_pose is None:
        shadow_sensor_pose = RigidTransform(world_from_sensor_per_frame.quat_xyzw[-1],
                                            world_from_sensor_per_frame.translation[-1])
    return process_scan(cloud, config, shadow_sensor_pose, draw=draw, generator=generator)


def jit_pipeline(config: PipelineConfig):
    """One callable per config, the reference's ``jit_pipeline``:
    ``process_scan`` with ``config`` bound, after ``config.validate()``.

    The reference compiles the scan once per config with ``jax.jit``.
    PyTorch runs eagerly and the port's kernels are built once a process
    at first use, so there is no compile step to take here: the callable
    runs the same launches as ``process_scan``, and captures nothing."""
    config.validate()
    return partial(process_scan, config=config)


def _post_voxel(voxel_cloud: Cloud, n_voxels: torch.Tensor, hole_grid: torch.Tensor,
                n_in: torch.Tensor, n_cropped: torch.Tensor, config: PipelineConfig,
                world_from_sensor: RigidTransform, draw: Draw,
                voxel_overflow: torch.Tensor, vmapped: bool, shard=None) -> PipelineResult:
    """Stages 3-8, on a batch (``vmapped``: RANSAC's refinement as the
    reference's ``batched_pipeline`` evaluates it, else as its single
    scan does; see ``ops.ransac._sum3``).  Shared with the point-sharded
    path (``parallel.sharding``), which enters with the merged voxel cloud
    replicated on every rank; its ``shard`` (a ``parallel.collectives.
    Axis``) splits the two O(N*W) stages, the kNN's query tiles and the
    cluster sweeps' query rows, over the axis and gathers their results,
    bit for bit the replicated form (the reference's ``shard_axis`` and
    ``num_shards``, pipeline.py:110-182); the O(N) stages stay replicated.
    The reference's ``point_sharded`` only turns its dead-tile skip off;
    the port has no such skip (below)."""
    # knn_skip_dead_tiles needs no code here: every kNN engine gives query
    # tiles with no valid point outputs that the final mask sets to 0, the
    # output the reference's per-tile skip gives.  The banded engines need
    # the voxel stage's lattice order: without it the kNN takes the
    # full-width 'approx' engine, as the reference's does.
    backend = config.knn_backend
    if backend in ("banded", "banded_approx") and not config.downsample_input_data:
        backend = "approx"
    with timing.span("pcp.stage.remove_statistical_outliers"):
        outl = remove_statistical_outliers(
            voxel_cloud,
            config.statistical_outlier_mean_k,
            config.statistical_outlier_std_dev_thresh,
            row_tile=config.knn_row_tile,
            backend=backend,
            band=config.knn_band,
            shard=shard,
        )
    with timing.span("pcp.stage.segment_planes"):
        seg = segment_planes(outl.cloud, config, draw, vmapped=vmapped)
    with timing.span("pcp.stage.compact"):
        comp = compact(seg.nonplane_cloud, config.cluster_capacity)
    with timing.span("pcp.stage.euclidean_cluster"):
        clus = euclidean_cluster(
            comp.cloud,
            config.euc_cluster_tolerance,
            config.euc_min_cluster_size,
            config.euc_max_cluster_size,
            config.max_clusters,
            config.cluster_max_iters,
            band_window=config.cluster_band_window,
            shard=shard,
        )
    with timing.span("pcp.stage.cluster_centroids"):
        centroids = cluster_centroids(comp.cloud, clus.clusters)
    with timing.span("pcp.stage.cast_shadows"):
        shadows = cast_shadows(hole_grid, comp.cloud, clus.clusters, world_from_sensor, config)
    with timing.span("pcp.stage.mark_obstacles"):
        grid_data = mark_obstacles(shadows.grid, seg.nonplane_cloud, config)
    grid = OccupancyGrid(
        data=grid_data,
        resolution=config.block_size,
        origin_position=(config.x_max, 0.0, 0.0),
        origin_orientation_xyzw=(0.0, 0.0, 0.707, 0.707),
    )
    stats = StageStats(
        accumulated_points=n_in,
        cropped_points=n_cropped,
        voxel_points=torch.clamp_max(n_voxels, config.max_voxels),
        inlier_points=outl.cloud.count(),
        nonplane_points=seg.nonplane_cloud.count(),
        num_planes=seg.planes.num_planes,
        num_clusters=clus.clusters.num_clusters,
        voxel_overflow=voxel_overflow,
        cluster_overflow=comp.overflow,
        cluster_band_overflow=clus.band_overflow,
        planes_truncated=seg.truncated,
        cluster_unconverged=clus.unconverged,
    )
    debug = {}
    if config.publish_point_clouds:
        debug = dict(
            voxel_cloud=voxel_cloud,
            outlier_filtered_cloud=outl.cloud,
            plane_cloud=Cloud(points=outl.cloud.points, valid=seg.plane_union),
            last_plane_cloud=Cloud(points=outl.cloud.points, valid=seg.last_plane),
            nonplane_cloud=seg.nonplane_cloud,
        )
    return PipelineResult(
        grid=grid,
        centroids=centroids,
        clusters=clus.clusters,
        obstacle_cloud=comp.cloud,
        planes=seg.planes,
        stats=stats,
        host_syncs=clus.host_syncs,
        **debug,
    )
