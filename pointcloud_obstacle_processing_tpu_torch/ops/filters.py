"""Mask-based point filters (counterpart of the reference's ``ops/filters.py``).

Filters update the validity mask over the same fixed-capacity buffer
instead of producing a shorter cloud.  ``passthrough_mask`` and
``euclidean_distance`` are the reference node's dead code
(``passthrough_filter`` and ``calculate_distance``, never called), kept as
part of its declared capability surface.
"""

from __future__ import annotations

import torch

from . import sqrt32
from ..config import PipelineConfig

__all__ = ["passthrough_mask", "crop_box_mask", "euclidean_distance"]

_AXES = {"x": 0, "y": 1, "z": 2}


def passthrough_mask(points: torch.Tensor, axis: str, lower: float, upper: float) -> torch.Tensor:
    """Keep-mask for ``lower <= p[axis] <= upper`` (pcl::PassThrough's
    inclusive limits; obstacle_detection.cpp:307-311)."""
    v = points[..., _AXES[axis]]
    return (v >= lower) & (v <= upper)


def crop_box_mask(points: torch.Tensor, config: PipelineConfig) -> torch.Tensor:
    """Non-finite + crop-box rejection (obstacle_detection.cpp:197-200)."""
    finite = torch.isfinite(points).all(dim=-1)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return (
        finite
        & (x >= config.x_min)
        & (x <= config.x_max)
        & (y >= config.y_min)
        & (y <= config.y_max)
        & (z >= config.z_min)
        & (z <= config.z_max)
    )



def euclidean_distance(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """3D distance (calculate_distance, obstacle_detection.cpp:457-464): the
    reference's ``sqrt(sum((p2 - p1) ** 2, -1))`` as jitted XLA:CPU
    evaluates it, each square rounded (its ``integer_pow`` is not fused into
    the sum's adds), the adds in order and the root correctly rounded."""
    d = p2 - p1
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return sqrt32(x * x + y * y + z * z)
