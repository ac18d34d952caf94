"""pointcloud_obstacle_processing_tpu_torch: the scan -> obstacles pipeline
in PyTorch, with hand-written CUDA kernels for an NVIDIA H100.

A port of ``pointcloud_obstacle_processing_tpu`` (JAX), which stays the
reference.  Module names mirror the reference package.  The package imports
no JAX; the CUDA kernels are built on first use (see ``_build.py``).
"""

from .config import PipelineConfig, REFERENCE_YAML_CONFIG, config_from_dict, config_from_yaml
from .interop import from_reference
from .types import (
    Cloud,
    ClusterSet,
    OccupancyGrid,
    PipelineResult,
    PlaneModel,
    PointIndicesArray,
    PointWithRad,
    StageStats,
)

__version__ = "0.1.0"
