"""Core data types: dataclasses of torch tensors.

Counterpart of ``pointcloud_obstacle_processing_tpu/types.py``.  Every
container keeps the reference's fixed-capacity layout (padded buffers plus a
validity mask or count) and its field names, so results compare field by
field.  Every tensor field may carry a leading scan axis ``[B, ...]``: a
batch of scans is the same containers with that axis written out, as the
reference's ``jax.vmap`` leaves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Cloud",
    "OccupancyGrid",
    "PointWithRad",
    "PointIndicesArray",
    "ClusterSet",
    "PlaneModel",
    "StageStats",
    "PipelineResult",
    "batch_of",
    "scan_of",
]


@dataclasses.dataclass
class Cloud:
    """Fixed-capacity point cloud: padded points + validity mask."""

    points: torch.Tensor  # [N, 3] or [B, N, 3] float32
    valid: torch.Tensor  # [N] or [B, N] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> torch.Tensor:
        """Number of valid points of each scan (int32, ``[]`` or ``[B]``, no
        host sync)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    def to(self, device) -> "Cloud":
        return Cloud(points=self.points.to(device), valid=self.valid.to(device))

    @classmethod
    def from_points(cls, points, valid=None, device=None) -> "Cloud":
        points = torch.tensor(np.asarray(points, np.float32), device=device)
        if valid is None:
            valid = torch.ones(points.shape[:-1], dtype=torch.bool, device=device)
        else:
            valid = torch.tensor(np.asarray(valid, bool), device=device)
        return cls(points=points, valid=valid)

    @classmethod
    def pad_to(cls, points, capacity: int, device=None) -> "Cloud":
        """Pad a concrete [n, 3] array, or a [B, n, 3] batch of them, with
        zeros up to ``capacity``."""
        points = np.asarray(points, np.float32)
        n = points.shape[-2]
        if n > capacity:
            raise ValueError(f"cloud of {n} points exceeds capacity {capacity}")
        buf = np.zeros((*points.shape[:-2], capacity, 3), np.float32)
        buf[..., :n, :] = points
        valid = np.broadcast_to(np.arange(capacity) < n, buf.shape[:-1])
        return cls.from_points(buf, valid, device=device)

    def masked_points(self, fill: float = float("nan")) -> torch.Tensor:
        """The points with padding lanes replaced by ``fill`` (host and
        debug use), any leading batch axis included."""
        return torch.where(self.valid[..., None], self.points, fill)


@dataclasses.dataclass
class OccupancyGrid:
    """``nav_msgs::OccupancyGrid``: row-major [H, W] int8 cells (0 free, 100
    occupied, ``grid_opacity`` for shadow) plus static metadata."""

    data: torch.Tensor  # [H, W] int8
    resolution: float = 0.0
    origin_position: tuple = (0.0, 0.0, 0.0)
    origin_orientation_xyzw: tuple = (0.0, 0.0, 0.707, 0.707)

    @property
    def height(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> int:
        return self.data.shape[-1]


@dataclasses.dataclass
class PointWithRad:
    """Cluster centroid plus bounding radius, stored as [..., 4] (x, y, z, r)."""

    xyzr: torch.Tensor

    @property
    def xyz(self) -> torch.Tensor:
        return self.xyzr[..., :3]

    @property
    def r(self) -> torch.Tensor:
        return self.xyzr[..., 3]


@dataclasses.dataclass
class PointIndicesArray:
    """Fixed-capacity [M, 4] PointWithRad rows + per-slot validity."""

    points: PointWithRad
    valid: torch.Tensor  # [M] bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)

    @property
    def capacity(self) -> int:
        return self.points.xyzr.shape[-2]


@dataclasses.dataclass
class ClusterSet:
    """Per-point cluster slot (-1 = none) plus size-descending slot metadata."""

    point_cluster: torch.Tensor  # [N] int32
    sizes: torch.Tensor  # [M] int32
    valid: torch.Tensor  # [M] bool
    num_clusters: torch.Tensor  # [] int32


@dataclasses.dataclass
class PlaneModel:
    """Up to ``max_planes`` planes ``(nx, ny, nz, d)`` with n·p + d = 0."""

    coeffs: torch.Tensor  # [K, 4] float32
    valid: torch.Tensor  # [K] bool
    num_planes: torch.Tensor  # [] int32


@dataclasses.dataclass
class StageStats:
    """Per-stage counts and every capacity-truncation flag (0-d tensors)."""

    accumulated_points: torch.Tensor
    cropped_points: torch.Tensor
    voxel_points: torch.Tensor
    inlier_points: torch.Tensor
    nonplane_points: torch.Tensor
    num_planes: torch.Tensor
    num_clusters: torch.Tensor
    voxel_overflow: torch.Tensor
    cluster_overflow: torch.Tensor
    cluster_band_overflow: torch.Tensor
    planes_truncated: torch.Tensor
    cluster_unconverged: torch.Tensor


@dataclasses.dataclass
class PipelineResult:
    """Everything the pipeline publishes (see the reference's PipelineResult).

    ``host_syncs`` counts the device-to-host reads the run made (the cluster
    loop's per-sweep convergence check); it has no counterpart in the JAX
    package, whose loops run on the device.
    """

    grid: OccupancyGrid
    centroids: PointIndicesArray
    clusters: ClusterSet
    obstacle_cloud: Cloud
    planes: PlaneModel
    stats: StageStats
    voxel_cloud: Cloud | None = None
    outlier_filtered_cloud: Cloud | None = None
    plane_cloud: Cloud | None = None
    last_plane_cloud: Cloud | None = None
    nonplane_cloud: Cloud | None = None
    host_syncs: int = 0


def batch_of(cloud: Cloud) -> tuple[Cloud, bool]:
    """``cloud`` with a leading scan axis, and whether it came without one
    (a single scan runs as a batch of one)."""
    if cloud.points.dim() == 2:
        return Cloud(points=cloud.points[None], valid=cloud.valid[None]), True
    return cloud, False


def scan_of(obj, b: int = 0):
    """Scan ``b`` of a batched result: every tensor in ``obj`` (nested
    NamedTuples, dataclasses, tuples, lists and dicts) indexed at ``b`` on
    its leading axis; other values as they are."""
    if isinstance(obj, torch.Tensor):
        return obj[b]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(scan_of(v, b) for v in obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj, **{f.name: scan_of(getattr(obj, f.name), b) for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(scan_of(v, b) for v in obj)
    if isinstance(obj, dict):
        return {k: scan_of(v, b) for k, v in obj.items()}
    return obj
