"""Occupancy seeding, obstacle marking, shadow casting and transforms of the
PyTorch port against the JAX package.  Bar: int8 grids exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import occupancy as ref_occ
from pointcloud_obstacle_processing_tpu.ops.shadow import cast_shadows as ref_cast_shadows
from pointcloud_obstacle_processing_tpu.ops.transforms import RigidTransform as RefTF
from pointcloud_obstacle_processing_tpu.types import ClusterSet as RefClusterSet

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud, ClusterSet
from pointcloud_obstacle_processing_tpu_torch.ops import occupancy
from pointcloud_obstacle_processing_tpu_torch.ops.shadow import cast_shadows
from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform


def _points(seed, n):
    """Points around and beyond the crop box, with NaNs and cell-boundary
    coordinates (multiples of the block size)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-0.5, -0.5, -0.7], [5.0, 4.3, 0.5], (n, 3)).astype(np.float32)
    k = n // 8
    pts[:k, 0] = (rng.integers(0, 121, k) * np.float32(CFG.block_size)).astype(np.float32)
    pts[k:2 * k, 1] = (rng.integers(0, 101, k) * np.float32(CFG.block_size)).astype(np.float32)
    pts[2 * k:2 * k + 20] = np.nan
    valid = rng.random(n) < 0.95
    return pts, valid


@pytest.mark.parametrize("seed,dev_percent", [(0, 0.9), (1, 0.5)])
def test_crop_and_seed_matches_reference(seed, dev_percent):
    ref_cfg = REF_CFG.replace(dev_percent=dev_percent)
    cfg = CFG.replace(dev_percent=dev_percent)
    pts, valid = _points(seed, 20000)
    r = jax.jit(lambda c: ref_occ.crop_and_seed(c, ref_cfg))(RefCloud.from_points(pts, valid))
    p = occupancy.crop_and_seed(Cloud.from_points(pts, valid), cfg)
    np.testing.assert_array_equal(np.asarray(r.cloud.valid), p.cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
    np.testing.assert_array_equal(np.asarray(r.row_averages), p.row_averages.numpy())
    np.testing.assert_array_equal(np.asarray(r.hole_grid), p.hole_grid.numpy())


def test_grid_cells_and_marking_match_reference():
    pts, valid = _points(2, 20000)
    col_r, row_r = jax.jit(lambda p: ref_occ.grid_cell_xy(p, REF_CFG))(jnp.asarray(pts))
    col_p, row_p = occupancy.grid_cell_xy(torch.tensor(pts), CFG)
    finite = np.isfinite(pts).all(axis=1)
    np.testing.assert_array_equal(np.asarray(col_r)[finite], col_p.numpy()[finite])
    np.testing.assert_array_equal(np.asarray(row_r)[finite], row_p.numpy()[finite])
    grid = np.random.default_rng(3).choice([0, 100], (CFG.grid_height, CFG.grid_width)).astype(np.int8)
    r = jax.jit(lambda g, c: ref_occ.mark_obstacles(g, c, REF_CFG))(
        jnp.asarray(grid), RefCloud.from_points(pts, valid))
    p = occupancy.mark_obstacles(torch.tensor(grid), Cloud.from_points(pts, valid), CFG)
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


def _cluster_case(seed):
    rng = np.random.default_rng(seed)
    n, m = 512, 8
    centers = rng.uniform([0.5, 0.5, 0.0], [4.0, 3.3, 0.2], (5, 3))
    pc = np.full(n, -1, np.int32)
    pts = np.zeros((n, 3), np.float32)
    for j, c in enumerate(centers):
        sl = slice(j * 60, (j + 1) * 60)
        pts[sl] = rng.normal(c, [0.08, 0.25 if j == 2 else 0.08, 0.05], (60, 3))
        pc[sl] = j
    valid = pc >= 0
    sizes = np.zeros(m, np.int32)
    sizes[:5] = 60
    slot_valid = np.arange(m) < 5
    slot_valid[4] = False  # a slot that fails the size gate casts nothing
    return pts, valid, pc, sizes, slot_valid


@pytest.mark.parametrize(
    "quat,trans",
    [
        ((0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
        ((0.0, 0.2588190, 0.0, 0.9659258), (-0.6, 1.9, 0.8)),  # camera tilted, behind the arena
    ],
)
def test_cast_shadows_matches_reference(quat, trans):
    pts, valid, pc, sizes, slot_valid = _cluster_case(4)
    grid = np.zeros((CFG.grid_height, CFG.grid_width), np.int8)
    ref_cfg = REF_CFG.replace(grid_opacity=50)
    cfg = CFG.replace(grid_opacity=50)
    ref_clusters = RefClusterSet(point_cluster=jnp.asarray(pc), sizes=jnp.asarray(sizes),
                                 valid=jnp.asarray(slot_valid), num_clusters=jnp.int32(4))
    r = jax.jit(lambda g, c, cl, tf: ref_cast_shadows(g, c, cl, tf, ref_cfg).grid)(
        jnp.asarray(grid), RefCloud.from_points(pts, valid), ref_clusters,
        RefTF.from_quat_trans(quat, trans))
    clusters = ClusterSet(point_cluster=torch.tensor(pc), sizes=torch.tensor(sizes),
                          valid=torch.tensor(slot_valid), num_clusters=torch.tensor(4))
    p = cast_shadows(torch.tensor(grid), Cloud.from_points(pts, valid), clusters,
                     RigidTransform.from_quat_trans(quat, trans), cfg).grid
    assert (np.asarray(r) == 50).sum() > 0
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


def test_transform_apply_and_inverse_match_reference():
    rng = np.random.default_rng(6)
    q = rng.standard_normal(4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.standard_normal(3).astype(np.float32)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    ref_tf = RefTF.from_quat_trans(q, t)
    tf = RigidTransform.from_quat_trans(q, t)
    np.testing.assert_allclose(tf.apply(torch.tensor(pts)).numpy(),
                               np.asarray(ref_tf.apply(jnp.asarray(pts))), atol=1e-6)
    inv = tf.inverse()
    np.testing.assert_allclose(inv.apply(tf.apply(torch.tensor(pts))).numpy(), pts, atol=1e-5)
    np.testing.assert_allclose(inv.translation.numpy(), np.asarray(ref_tf.inverse().translation),
                               atol=1e-6)
