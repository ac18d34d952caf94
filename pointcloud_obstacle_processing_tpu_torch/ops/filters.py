"""Mask-based point filters (counterpart of the reference's ``ops/filters.py``).

Filters update the validity mask over the same fixed-capacity buffer
instead of producing a shorter cloud.  Only the crop the pipeline runs is
ported; the reference's ``passthrough_mask`` and ``euclidean_distance``
serve dead code of the ROS node.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig

__all__ = ["crop_box_mask"]


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

