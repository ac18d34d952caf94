"""Sensor-shadow casting onto the occupancy grid.

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/shadow.py``
(handle_shadow_casting, calculate_shadow_cast and traceShadow,
obstacle_detection.cpp:467-672).  Per cluster slot: the extremes of its
points in the sensor frame, the shadow's start and end cells, and the
``ceil(width/block) + 3``-line sweep rasterized in closed form per cell
(see the reference module's docstring for the derivation).  The reference
vmaps over slots; here the slot axis is a batch dimension, and a batch of
scans adds a leading scan axis (``[B, M, H, W]`` for the raster).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import f32, fma, sqrt32, sum_sq3
from ..config import PipelineConfig
from ..types import Cloud, ClusterSet
from .occupancy import grid_cell_xy
from .transforms import RigidTransform

__all__ = ["cast_shadows", "ShadowResult"]


class ShadowResult(NamedTuple):
    grid: torch.Tensor  # [..., H, W] int8 with shadow cells painted


def _cell(world: torch.Tensor, config: PipelineConfig):
    pts = torch.stack([world[..., 0], world[..., 1], torch.zeros_like(world[..., 0])], dim=-1)
    return grid_cell_xy(pts, config)


def _lengths(vmin: torch.Tensor):
    """The shadow's two lengths from each slot's nearest point ``vmin``
    [..., M, 3]: ``c = sqrt(z*z + x*x)`` and ``|vmin|``, as XLA:CPU
    evaluates the reference's ``jnp.sqrt(a*a + bb*bb)`` (the first product
    fused into the add) and ``jnp.linalg.norm`` (the reduction's fused
    chain), with correctly rounded roots."""
    a, bb = vmin[..., 2], torch.abs(vmin[..., 0])
    return sqrt32(fma(a, a, bb * bb)), sqrt32(sum_sq3(vmin[..., 0], vmin[..., 1], vmin[..., 2]))


def cast_shadows(grid: torch.Tensor, cloud: Cloud, clusters: ClusterSet,
                 world_from_sensor: RigidTransform, config: PipelineConfig) -> ShadowResult:
    """Paint every cluster's shadow onto ``grid`` (int8 [H, W]; [B, H, W]
    with a batch of clouds and cluster sets, the pose shared or one a
    scan)."""
    H, W = config.grid_height, config.grid_width
    M = clusters.sizes.shape[-1]
    lead = clusters.sizes.shape[:-1]
    dev = grid.device
    inf = float("inf")

    spts = world_from_sensor.inverse().apply(cloud.points)  # [..., C, 3]
    slot_ids = torch.arange(M, device=dev)
    mask = (clusters.point_cluster[..., None, :] == slot_ids[:, None]) & \
        cloud.valid[..., None, :]  # [..., M, C]
    sx, sy = spts[..., None, :, 0], spts[..., None, :, 1]
    mx = torch.where(mask, sx, inf)
    i_min = torch.argmin(mx, dim=-1)  # [..., M]
    vmin = spts.gather(-2, i_min[..., None].expand(*lead, M, 3))  # [..., M, 3]
    vmax = torch.where(mask, sx, -inf).max(dim=-1).values
    hmin = torch.where(mask, sy, inf).min(dim=-1).values
    hmax = torch.where(mask, sy, -inf).max(dim=-1).values
    width = torch.abs(hmax - hmin)

    a = vmin[..., 2]
    c, v_len = _lengths(vmin)
    e = torch.abs(vmax) - torch.abs(vmin[..., 0]) + f32(0.04)
    # XLA:CPU's float32 asin and tan are its own approximations: these two
    # steps are not bitwise the reference's (ROADMAP C)
    D = torch.arcsin(a / torch.clamp_min(c, 1e-20))
    d = torch.tan(D) * e + f32(0.25)
    end_sensor = vmin + vmin / torch.clamp_min(v_len, 1e-20)[..., None] * d[..., None]
    end_world, start_world = world_from_sensor.apply(
        torch.cat([end_sensor, vmin], dim=-2)).split(M, dim=-2)
    e_col, e_row = _cell(end_world, config)
    s_col, s_row = _cell(start_world, config)

    b = f32(config.block_size)
    shift = torch.ceil((width / b) / 2.0).to(torch.int32)
    n_lines = torch.ceil(width / b).to(torch.int32) + 3
    active = clusters.valid & (mask.sum(dim=-1) >= 2)

    # traceShadow sweep union, closed form per cluster
    x0, y0, x1, y1 = s_col + shift, s_row, e_col + shift, e_row
    steep = torch.abs(y1 - y0) > torch.abs(x1 - x0)
    x0, y0 = torch.where(steep, y0, x0), torch.where(steep, x0, y0)
    x1, y1 = torch.where(steep, y1, x1), torch.where(steep, x1, y1)
    back = x0 > x1
    x0, x1 = torch.where(back, x1, x0), torch.where(back, x0, x1)
    y0, y1 = torch.where(back, y1, y0), torch.where(back, y0, y1)

    dx = (x1 - x0).to(torch.float32)
    dy = (y1 - y0).to(torch.float32)
    one = 1.0
    gradient = torch.where(dx == 0.0, one, dy / torch.where(dx == 0.0, one, dx))

    def per_slot(v):  # [..., M] -> [..., M, 1, 1], against [H, 1] rows and [1, W] columns
        return v[..., None, None]

    fx0 = per_slot(x0.to(torch.float32))
    y0f = per_slot(y0.to(torch.float32))
    ix0, ix1 = per_slot(x0), per_slot(x1)
    g = per_slot(gradient)
    stp = per_slot(steep)
    n = per_slot(n_lines)
    on = per_slot(active)
    rows = torch.arange(H, dtype=torch.int32, device=dev).reshape(H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).reshape(1, W)

    fy_r = torch.floor(y0f + g * (rows.to(torch.float32) - fx0)).to(torch.int32)
    steep_hit = (rows >= ix0) & (rows <= ix1) & (cols >= fy_r - (n - 1)) & (cols <= fy_r + 1)

    u_lo = torch.maximum(ix0, cols - 1)
    u_hi = torch.minimum(ix1, cols + (n - 1))
    fy_lo = torch.floor(y0f + g * (u_lo.to(torch.float32) - fx0)).to(torch.int32)
    fy_hi = torch.floor(y0f + g * (u_hi.to(torch.float32) - fx0)).to(torch.int32)
    shallow_hit = (
        (u_lo <= u_hi)
        & (rows >= torch.minimum(fy_lo, fy_hi))
        & (rows <= torch.maximum(fy_lo, fy_hi))
    )
    hit = (on & torch.where(stp, steep_hit, shallow_hit)).any(dim=-3)
    return ShadowResult(grid=torch.where(hit, torch.full_like(grid, config.grid_opacity), grid))
