"""Sensor-shadow casting onto the occupancy grid.

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/shadow.py``
(handle_shadow_casting, calculate_shadow_cast and traceShadow,
obstacle_detection.cpp:467-672).  Per cluster slot: the extremes of its
points in the sensor frame, the shadow's start and end cells, and the
``ceil(width/block) + 3``-line sweep rasterized in closed form per cell
(see the reference module's docstring for the derivation).  The reference
vmaps over slots; here the slot axis is a batch dimension, and a batch of
scans adds a leading scan axis.

The stage is two steps, each a kernel on the card (``csrc/shadow.cu``) with
its plain PyTorch twin here, bitwise alike:

* ``shadow_slots``: per (scan, slot), the slot's points reduced (first
  index of the least sensor x, the greatest x, the least and greatest y,
  the count), then the slot's geometry on one value: the two lengths, the
  reference's ``tan(asin(a / c))`` through ``ops.libm`` (XLA:CPU's
  ``asin`` and glibc's ``tanf``, bit for bit), the end point, both points
  through the pose into cells, the sweep's line count, and the line's
  steep/back normal form.  Out: ``[..., M, 7]`` int32 (``LINE_FIELDS``).
* ``shadow_raster``: per (scan, cell), the OR over the active slots of the
  closed-form steep or shallow hit; each cell written once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import f32, fma, int32_like_xla, recip32, sqrt32, sum_sq3
from .. import _build
from ..config import PipelineConfig
from ..types import Cloud, ClusterSet
from .libm import asin_like_xla, tanf
from .occupancy import grid_cell_xy
from .transforms import RigidTransform

__all__ = ["cast_shadows", "ShadowResult", "shadow_slots", "shadow_slots_plain", "shadow_raster",
           "shadow_raster_plain", "LINE_FIELDS"]

# a slot's line, after the steep swap and the back swap: columns of the
# [..., M, 7] int32 lines
LINE_FIELDS = ("x0", "y0", "x1", "y1", "n_lines", "steep", "active")


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


def sweep_lines(width: torch.Tensor, block_size: float):
    """The shadow sweep's shift ``ceil((width / block) / 2)`` and line count
    ``ceil(width / block) + 3`` (cpp:586-600) as XLA:CPU evaluates the
    reference's: the division by the constant block as a product with its
    float32 reciprocal (``ops.recip32``), the halving exact, the conversion
    saturating (an empty slot's width is inf).  Returns int32 (shift,
    n_lines)."""
    per_block = width * recip32(block_size)
    return int32_like_xla(torch.ceil(per_block * 0.5)), int32_like_xla(torch.ceil(per_block)) + 3


def slot_extremes(spts: torch.Tensor, point_cluster: torch.Tensor, valid: torch.Tensor, m: int):
    """Each slot's points reduced over the cloud: ``vmin`` [..., M, 3], the
    sensor-frame point of least x (the first on ties; an empty slot takes
    point 0, as ``argmin`` of an all-inf row does), the greatest x, the
    least and greatest y (+-inf for an empty slot) and the count."""
    slot_ids = torch.arange(m, device=spts.device)
    mask = (point_cluster[..., None, :] == slot_ids[:, None]) & valid[..., None, :]  # [..., M, C]
    sx, sy = spts[..., None, :, 0], spts[..., None, :, 1]
    inf = float("inf")
    i_min = torch.argmin(torch.where(mask, sx, inf), dim=-1)  # [..., M]
    vmin = spts.gather(-2, i_min[..., None].expand(*i_min.shape, 3))
    vmax = torch.where(mask, sx, -inf).max(dim=-1).values
    hmin = torch.where(mask, sy, inf).min(dim=-1).values
    hmax = torch.where(mask, sy, -inf).max(dim=-1).values
    return vmin, vmax, hmin, hmax, mask.sum(dim=-1)


def shadow_end(vmin: torch.Tensor, vmax: torch.Tensor):
    """calculate_shadow_cast (cpp:540-582): the shadow's length ``d`` [..., M]
    and its end point in the sensor frame [..., M, 3], as XLA:CPU evaluates
    the reference's ``tan(asin(a / c)) * e + 0.25`` and ``vmin + vmin / |vmin|
    * d``: both products fused into their adds, the trig XLA:CPU's
    (``ops.libm``)."""
    a = vmin[..., 2]
    c, v_len = _lengths(vmin)
    e = torch.abs(vmax) - torch.abs(vmin[..., 0]) + f32(0.04)
    d = fma(tanf(asin_like_xla(a / torch.clamp_min(c, 1e-20))), e, f32(0.25))
    ray = vmin / torch.clamp_min(v_len, 1e-20)[..., None]
    return d, fma(ray, d[..., None], vmin)


def slot_lines(start_world: torch.Tensor, end_world: torch.Tensor, width: torch.Tensor,
               active: torch.Tensor, config: PipelineConfig) -> torch.Tensor:
    """The sweep's line 0 from the shadow's start and end points (world
    frame, [..., M, 3]) in the rasterizer's normal form: the steep swap
    (x and y exchanged where |dy| > |dx|), then the back swap (x0 <= x1).
    Returns the [..., M, 7] int32 lines (``LINE_FIELDS``)."""
    e_col, e_row = _cell(end_world, config)
    s_col, s_row = _cell(start_world, config)
    shift, n_lines = sweep_lines(width, config.block_size)
    x0, y0, x1, y1 = s_col + shift, s_row, e_col + shift, e_row
    steep = torch.abs(y1 - y0) > torch.abs(x1 - x0)
    x0, y0 = torch.where(steep, y0, x0), torch.where(steep, x0, y0)
    x1, y1 = torch.where(steep, y1, x1), torch.where(steep, x1, y1)
    back = x0 > x1
    x0, x1 = torch.where(back, x1, x0), torch.where(back, x0, x1)
    y0, y1 = torch.where(back, y1, y0), torch.where(back, y0, y1)
    return torch.stack([x0, y0, x1, y1, n_lines, steep.to(torch.int32), active.to(torch.int32)],
                       dim=-1)


def shadow_slots_plain(points: torch.Tensor, valid: torch.Tensor, point_cluster: torch.Tensor,
                       slot_valid: torch.Tensor, world_from_sensor: RigidTransform,
                       config: PipelineConfig) -> torch.Tensor:
    """Plain PyTorch version of ``shadow_slots``."""
    spts = world_from_sensor.inverse().apply(points)  # [..., C, 3]
    m = slot_valid.shape[-1]
    vmin, vmax, hmin, hmax, count = slot_extremes(spts, point_cluster, valid, m)
    _, end_sensor = shadow_end(vmin, vmax)
    end_world, start_world = world_from_sensor.apply(
        torch.cat([end_sensor, vmin], dim=-2)).split(m, dim=-2)
    return slot_lines(start_world, end_world, torch.abs(hmax - hmin), slot_valid & (count >= 2),
                      config)


def _pose(world_from_sensor: RigidTransform, scans: int):
    """The pose's quaternion [P, 4] and translation [P, 3], contiguous
    float32, and the scan stride (0: one pose for every scan)."""
    q = world_from_sensor.quat_xyzw.reshape(-1, 4).contiguous()
    t = world_from_sensor.translation.reshape(-1, 3).contiguous()
    if q.shape[0] not in (1, scans) or t.shape[0] != q.shape[0]:
        raise ValueError(f"shadow_slots: {q.shape[0]} poses for {scans} scans")
    return q, t, int(q.shape[0] > 1)


def shadow_slots(points: torch.Tensor, valid: torch.Tensor, point_cluster: torch.Tensor,
                 slot_valid: torch.Tensor, world_from_sensor: RigidTransform,
                 config: PipelineConfig) -> torch.Tensor:
    """Each cluster slot's shadow line: ``points`` [..., C, 3] float32 (world
    frame), ``valid`` [..., C] bool, ``point_cluster`` [..., C] int32 (slot
    or -1), ``slot_valid`` [..., M] bool, the sensor pose (one, or one a
    scan).  Returns [..., M, 7] int32 (``LINE_FIELDS``): the line's ends
    (cells, steep and back swaps applied), the sweep's line count, the
    steep flag and whether the slot casts (valid, two points or more).

    CPU tensors take ``shadow_slots_plain``; CUDA tensors one launch of
    ``csrc/shadow.cu``'s slot kernel for the batch: a thread-block cluster
    a scan (up to 8 blocks, one for each 2,048 points) that reads each
    point once, folds it into its slot's record in shared memory with the
    world -> sensor transform inside, and runs the slots' geometry on block
    0, a thread a slot."""
    if points.device.type == "cpu":
        return shadow_slots_plain(points, valid, point_cluster, slot_valid, world_from_sensor,
                                  config)
    with _build.launch("shadow_slots") as launch:
        lead, (c, m) = points.shape[:-2], (points.shape[-2], slot_valid.shape[-1])
        if points.shape[-1] != 3 or valid.shape != (*lead, c) or point_cluster.shape != (*lead, c) \
                or slot_valid.shape != (*lead, m):
            raise ValueError("shadow_slots: points [..., C, 3], valid and point_cluster [..., C], "
                             "slot_valid [..., M]")
        scans = 1
        for s in lead:
            scans *= s
        pts, ok = points.contiguous(), valid.contiguous()
        pc, sv = point_cluster.contiguous(), slot_valid.contiguous()
        q, t, pose_stride = _pose(world_from_sensor, scans)
        _build.require_cuda("shadow_slots", pts, ok, pc, sv, q, t,
                            dtypes=(torch.float32, torch.bool, torch.int32, torch.bool,
                                    torch.float32, torch.float32))
        out = torch.empty(*lead, m, len(LINE_FIELDS), dtype=torch.int32, device=pts.device)
        if out.numel():
            err = _build.kernels().pcp_shadow_slots(
                pts.data_ptr(), ok.data_ptr(), pc.data_ptr(), sv.data_ptr(), q.data_ptr(),
                t.data_ptr(), pose_stride, scans, c, m, float(f32(config.block_size)),
                float(recip32(config.block_size)), float(f32(config.y_min)),
                float(f32(config.x_max)), out.data_ptr(), _build.stream_handle())
            _build.check(err, "shadow_slots")
        else:
            launch.skip()
    return out


def shadow_raster_plain(grid: torch.Tensor, lines: torch.Tensor, opacity: int) -> torch.Tensor:
    """Plain PyTorch version of ``shadow_raster``: the slots' hits over a
    [..., M, H, W] broadcast, OR-ed over M."""
    H, W = grid.shape[-2:]
    dev = grid.device

    def per_slot(k):  # field k: [..., M] -> [..., M, 1, 1], against [H, 1] rows and [1, W] columns
        return lines[..., k][..., None, None]

    ix0, iy0, ix1, iy1, n = (per_slot(k) for k in range(5))
    stp, on = per_slot(5) != 0, per_slot(6) != 0
    dx = (ix1 - ix0).to(torch.float32)
    dy = (iy1 - iy0).to(torch.float32)
    one = 1.0
    g = torch.where(dx == 0.0, one, dy / torch.where(dx == 0.0, one, dx))
    fx0 = ix0.to(torch.float32)
    y0f = iy0.to(torch.float32)
    rows = torch.arange(H, dtype=torch.int32, device=dev).reshape(H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).reshape(1, W)

    def fy(u):  # the line's y at integer x = u
        return int32_like_xla(torch.floor(y0f + g * (u.to(torch.float32) - fx0)))

    # steep: the column band [fy(r) - (n - 1), fy(r) + 1] of rows x0..x1
    fy_r = fy(rows)
    steep_hit = (rows >= ix0) & (rows <= ix1) & (cols >= fy_r - (n - 1)) & (cols <= fy_r + 1)
    # shallow: fy over u in [max(x0, c - 1), min(x1, c + n - 1)] spans the rows between its ends
    u_lo = torch.maximum(ix0, cols - 1)
    u_hi = torch.minimum(ix1, cols + (n - 1))
    fy_lo, fy_hi = fy(u_lo), fy(u_hi)
    shallow_hit = (
        (u_lo <= u_hi)
        & (rows >= torch.minimum(fy_lo, fy_hi))
        & (rows <= torch.maximum(fy_lo, fy_hi))
    )
    hit = (on & torch.where(stp, steep_hit, shallow_hit)).any(dim=-3)
    return torch.where(hit, torch.full_like(grid, opacity), grid)


def shadow_raster(grid: torch.Tensor, lines: torch.Tensor, opacity: int) -> torch.Tensor:
    """``grid`` [..., H, W] int8 with every active slot's sweep painted
    ``opacity``: the traceShadow sweep union (cpp:467-538) in closed form
    per cell, from ``shadow_slots``' [..., M, 7] lines.

    CPU tensors take ``shadow_raster_plain``; CUDA tensors one launch of
    ``csrc/shadow.cu``'s raster kernel for the batch (a block a tile of 8
    x 16 cells, a thread a cell, testing only the lines whose box of
    reachable cells meets the tile), which writes every cell once."""
    if grid.device.type == "cpu":
        return shadow_raster_plain(grid, lines, opacity)
    with _build.launch("shadow_raster") as launch:
        lead, (H, W) = grid.shape[:-2], grid.shape[-2:]
        if lines.shape[:-2] != lead or lines.shape[-1] != len(LINE_FIELDS):
            raise ValueError("shadow_raster: grid [..., H, W] and lines [..., M, 7]")
        g, ln = grid.contiguous(), lines.contiguous()
        _build.require_cuda("shadow_raster", g, ln, dtypes=(torch.int8, torch.int32))
        scans = 1
        for s in lead:
            scans *= s
        out = torch.empty_like(g)
        if out.numel():
            err = _build.kernels().pcp_shadow_raster(g.data_ptr(), ln.data_ptr(), scans,
                                                     lines.shape[-2], H, W, int(opacity),
                                                     out.data_ptr(), _build.stream_handle())
            _build.check(err, "shadow_raster")
        else:
            launch.skip()
    return out


def cast_shadows(grid: torch.Tensor, cloud: Cloud, clusters: ClusterSet,
                 world_from_sensor: RigidTransform, config: PipelineConfig) -> ShadowResult:
    """Paint every cluster's shadow onto ``grid`` (int8 [H, W]; [B, H, W]
    with a batch of clouds and cluster sets, the pose shared or one a
    scan): ``shadow_slots`` then ``shadow_raster``, one launch each on the
    card."""
    lines = shadow_slots(cloud.points, cloud.valid, clusters.point_cluster, clusters.valid,
                         world_from_sensor, config)
    return ShadowResult(grid=shadow_raster(grid, lines, config.grid_opacity))
