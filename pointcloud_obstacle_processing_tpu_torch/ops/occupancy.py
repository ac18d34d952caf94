"""Occupancy grid seeding, hole (crater) detection and obstacle marking.

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/occupancy.py``
(the reference node's ``build_initial_occupancy_grid_dataset``,
obstacle_detection.cpp:175-269, and its marking loop, cpp:823-832).  The
behaviours kept: out-of-grid points leave the histogram but stay in the
cloud, row averages are floor-divided, and ``mark_obstacles`` wraps a flat
index across rows like the C++ ``grid[idx]`` write.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import f32
from ..config import PipelineConfig
from ..types import Cloud
from .filters import crop_box_mask
from .histogram import histogram2d

__all__ = ["grid_cell_xy", "grid_cell_index", "crop_and_seed", "mark_obstacles", "CropSeedResult"]


def grid_cell_xy(points: torch.Tensor, config: PipelineConfig):
    """World (x, y) -> (col, row) cells, bit-exact to the C++ loop search
    (cpp:134-150): a closed form plus fix-up steps that re-evaluate the
    loop's own float32 conditions."""
    y = points[..., 1]
    x = points[..., 0]
    b = f32(config.block_size)
    y_min = f32(config.y_min)
    x_max = f32(config.x_max)

    col = torch.clamp_min(torch.ceil((y - y_min) / b) - 1, 0).to(torch.int32)
    row = torch.clamp_min(torch.ceil((x_max - x) / b) - 1, 0).to(torch.int32)

    for _ in range(2):  # advance while the loop condition still holds
        cf = col.to(torch.float32)
        col = torch.where(y_min + (cf + 1.0) * b < y, col + 1, col)
        rf = row.to(torch.float32)
        row = torch.where(x_max - (rf + 1.0) * b > x, row + 1, row)
    for _ in range(2):  # retreat while the previous step's condition fails
        cf = col.to(torch.float32)
        col = torch.where((col > 0) & ~(y_min + cf * b < y), col - 1, col)
        rf = row.to(torch.float32)
        row = torch.where((row > 0) & ~(x_max - rf * b > x), row - 1, row)
    return col, row


def grid_cell_index(points: torch.Tensor, config: PipelineConfig) -> torch.Tensor:
    """Flat row-major cell index (cpp:153-157)."""
    col, row = grid_cell_xy(points, config)
    return row * config.grid_width + col


class CropSeedResult(NamedTuple):
    cloud: Cloud  # same buffer, mask restricted to in-crop finite points
    counts: torch.Tensor  # [H, W] int32 per-cell point histogram
    row_averages: torch.Tensor  # [H] int32
    hole_grid: torch.Tensor  # [H, W] int8: 100 where a crater is detected


def crop_and_seed(cloud: Cloud, config: PipelineConfig) -> CropSeedResult:
    """Crop + histogram + row average + hole detection (cpp:175-269)."""
    H, W = config.grid_height, config.grid_width
    in_box = cloud.valid & crop_box_mask(cloud.points, config)
    col, row = grid_cell_xy(cloud.points, config)
    counts = histogram2d(row, col, in_box, H, W)
    row_averages = torch.div(counts.sum(dim=1), W, rounding_mode="floor").to(torch.int32)
    threshold = row_averages.to(torch.float32) * f32(1.0 - config.dev_percent)
    hole = counts.to(torch.float32) < threshold[:, None]
    hole_grid = torch.where(hole, 100, 0).to(torch.int8)
    return CropSeedResult(
        cloud=Cloud(points=cloud.points, valid=in_box),
        counts=counts,
        row_averages=row_averages,
        hole_grid=hole_grid,
    )


def mark_obstacles(grid: torch.Tensor, cloud: Cloud, config: PipelineConfig) -> torch.Tensor:
    """Mark every remaining point's cell occupied (100), cpp:823-832.  Out-of-
    grid flat indices are dropped; a column past the row end wraps into the
    next row, as the C++ flat write does."""
    index = grid_cell_index(cloud.points, config)
    finite = torch.isfinite(cloud.points).all(dim=-1)
    ok = cloud.valid & finite & (index >= 0) & (index < config.grid_size)
    row = torch.div(index, config.grid_width, rounding_mode="floor")
    col = index - row * config.grid_width
    hit = histogram2d(row, col, ok, config.grid_height, config.grid_width) > 0
    return torch.where(hit, torch.full_like(grid, 100), grid)
