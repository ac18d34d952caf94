"""The scan -> obstacles pipeline in PyTorch.

Counterpart of ``pointcloud_obstacle_processing_tpu/pipeline.py``
(``process_scan`` and ``_post_voxel``), in the reference node's stage order
(obstacle_detection.cpp:699-927):

1. crop + occupancy histogram + crater/hole detection
2. VoxelGrid downsample (sort engine, kernel K1)
3. statistical outlier removal (banded kNN, kernel K3)
4. iterative RANSAC plane removal
5. compaction (kernel K2) + euclidean clustering (full sweep, kernel K4;
   banded sweep when ``cluster_band_window`` is set, kernel K5) + centroids
6. shadow casting, 7. obstacle marking

Every stage runs on the device of the input cloud.  The only host reads are
the cluster loop's per-sweep convergence checks (``PipelineResult.
host_syncs``).
"""

from __future__ import annotations

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
from .types import Cloud, OccupancyGrid, PipelineResult, StageStats

__all__ = ["process_scan", "default_draw"]


def default_draw(config: PipelineConfig, generator: torch.Generator, device) -> Draw:
    """RANSAC draws from ``generator``: uniform numbers for every round made
    up front, so the plane loop needs no host sync."""
    u = torch.rand(config.max_planes, config.ransac_hypotheses, 3,
                   generator=generator, device=device)
    return draw_from_uniform(u)


def process_scan(cloud: Cloud, config: PipelineConfig,
                 world_from_sensor: RigidTransform | None = None,
                 draw: Draw | None = None,
                 generator: torch.Generator | None = None) -> PipelineResult:
    """Full pipeline over one accumulated, world-frame cloud.

    ``draw`` supplies the RANSAC hypotheses (see ``ops.ransac``); without it
    they come from ``generator`` (or torch's default generator).
    ``world_from_sensor`` is the sensor pose for the shadow geometry,
    identity by default.
    """
    dev = cloud.device
    if world_from_sensor is None:
        world_from_sensor = RigidTransform.identity(dev)
    if draw is None:
        draw = default_draw(config, generator, dev)

    n_in = cloud.count()
    seed = crop_and_seed(cloud, config)
    cropped = seed.cloud
    bounds = (
        (config.x_min, config.y_min, config.z_min),
        (config.x_max, config.y_max, config.z_max),
    )  # cropped points are in the box: the packed single-key sort applies
    vox = voxel_downsample(
        cropped, config.downsample_leaf_size, config.max_voxels, bounds,
        config.voxel_payload_packing,
    )
    return _post_voxel(
        vox.cloud, vox.num_voxels, seed.hole_grid, n_in, cropped.count(), config,
        world_from_sensor, draw, vox.overflow,
    )


def _post_voxel(voxel_cloud: Cloud, n_voxels: torch.Tensor, hole_grid: torch.Tensor,
                n_in: torch.Tensor, n_cropped: torch.Tensor, config: PipelineConfig,
                world_from_sensor: RigidTransform, draw: Draw,
                voxel_overflow: torch.Tensor) -> PipelineResult:
    """Stages 3-8."""
    # knn_skip_dead_tiles needs no code here: K3 and its plain version
    # always write `big` for query tiles with no valid point, the output the
    # reference's per-tile skip gives (those rows are masked downstream)
    outl = remove_statistical_outliers(
        voxel_cloud,
        config.statistical_outlier_mean_k,
        config.statistical_outlier_std_dev_thresh,
        row_tile=config.knn_row_tile,
        band=config.knn_band,
    )
    seg = segment_planes(outl.cloud, config, draw)
    comp = compact(seg.nonplane_cloud, config.cluster_capacity)
    clus = euclidean_cluster(
        comp.cloud,
        config.euc_cluster_tolerance,
        config.euc_min_cluster_size,
        config.euc_max_cluster_size,
        config.max_clusters,
        config.cluster_max_iters,
        band_window=config.cluster_band_window,
    )
    centroids = cluster_centroids(comp.cloud, clus.clusters)
    shadows = cast_shadows(hole_grid, comp.cloud, clus.clusters, world_from_sensor, config)
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
