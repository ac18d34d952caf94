"""Model registry: the pipeline presets and an ``nn.Module`` facade.

Counterpart of ``pointcloud_obstacle_processing_tpu/models/__init__.py``.
The presets are copied from it (``tests/test_torch_config_scene.py`` holds
them equal).  Both run on the card: ``FLAGSHIP_CONFIG`` through kernels
K1-K4, ``REFERENCE_FULLSCALE_CONFIG`` through K1-K3 and the banded cluster
sweep K5.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import REFERENCE_YAML_CONFIG, PipelineConfig
from ..pipeline import jit_pipeline, process_frames, process_scan

__all__ = [
    "ObstacleDetectionModel",
    "process_scan",
    "process_frames",
    "jit_pipeline",
    "FLAGSHIP_CONFIG",
    "REFERENCE_FULLSCALE_CONFIG",
]

# The flagship configuration: 100 352-point scans, leaf 0.04 and 24 576
# voxel slots, banded kNN (row tile 384, band 512, mean_k 15), a 1 024-point
# cluster buffer with the full sweep, and voxel payload packing.  The
# reasons for each value, measured on the reference's TPU, are in the
# reference module.
FLAGSHIP_CONFIG = REFERENCE_YAML_CONFIG.replace(
    max_points=100352,
    max_voxels=24576,
    cluster_capacity=1024,
    max_clusters=64,
    downsample_leaf_size=0.04,
    knn_backend="banded",
    knn_row_tile=384,
    voxel_payload_packing=True,
)

# The full-scale reference workload: a 200-frame window at the shipped
# 0.015 leaf: 2M points into 262 144 voxel slots, banded kNN (row tile 1024,
# band 1280), a 16 384-point cluster buffer with the banded sweep (window
# 4096, kernel K5).
REFERENCE_FULLSCALE_CONFIG = REFERENCE_YAML_CONFIG.replace(
    max_points=2 * 1024 * 1024,
    max_voxels=262144,
    cluster_capacity=16384,
    cluster_band_window=4096,
    max_clusters=64,
    knn_backend="banded",
    knn_band=1280,
    knn_row_tile=1024,
    knn_skip_dead_tiles=True,
    voxel_payload_packing=True,
)


class ObstacleDetectionModel(torch.nn.Module):
    """Stateful facade over ``process_scan``: a validated config, a device,
    and a seeded generator for the RANSAC draws.  The pipeline has no
    weights; the module holds no parameters.  It runs on the card unless
    ``device`` says otherwise, and raises where there is no card."""

    def __init__(self, config: PipelineConfig | None = None, device="cuda", seed: int = 0):
        super().__init__()
        self.config = config or FLAGSHIP_CONFIG
        self.config.validate()
        self.device = _build.resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def forward(self, cloud, world_from_sensor=None, draw=None):
        """One cloud ``[N]`` or a batch ``[B, N]``; without ``draw`` the
        RANSAC draws ([B, rounds, K, 3] uniforms for a batch) come from the
        module's generator."""
        return process_scan(
            cloud.to(self.device), self.config,
            None if world_from_sensor is None else world_from_sensor.to(self.device),
            draw=draw, generator=self.generator,
        )
