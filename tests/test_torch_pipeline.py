"""The whole slice: ``process_scan`` of the PyTorch port against the JAX
package, held to the crosscheck bar of scripts/crosscheck_tpu_cpu.py
(grid bit-identical, stage counts and every StageStats flag exact,
centroids within 1e-5), with the reference's RANSAC key chain replayed."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from test_torch_ransac import jax_key_chain_draw

import pointcloud_obstacle_processing_tpu as ref
import pointcloud_obstacle_processing_tpu.models as ref_models
from pointcloud_obstacle_processing_tpu.pipeline import jit_pipeline
from pointcloud_obstacle_processing_tpu.utils.scene import SceneSpec, make_scene

import pointcloud_obstacle_processing_tpu_torch as port
from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel
from pointcloud_obstacle_processing_tpu_torch.ops import cluster as port_cluster
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan

# the small config of tests/test_pipeline.py
CFG = ref.REFERENCE_YAML_CONFIG.replace(
    max_points=32768, max_voxels=8192, cluster_capacity=2048, max_clusters=16,
    downsample_leaf_size=0.06,
)
SPEC = SceneSpec(n_ground=24000, n_rocks=3, points_per_rock=1500, n_noise=150)

COUNTS = ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
          "nonplane_points", "num_planes", "num_clusters")
FLAGS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow", "planes_truncated",
         "cluster_unconverged")


def _crosscheck(ref_cfg, scene_pts, key_seed):
    n = ref_cfg.max_points
    pts = scene_pts[:n]
    buf = np.zeros((n, 3), np.float32)
    buf[: len(pts)] = pts
    valid = np.arange(n) < len(pts)
    key = jax.random.PRNGKey(key_seed)
    r = jit_pipeline(ref_cfg)(ref.Cloud.from_points(buf, valid), key)
    st = port.from_reference(dataclasses.asdict(ref_cfg), buf, valid, device="cpu")
    st.config.validate()
    p = process_scan(st.cloud, st.config,
                     draw=jax_key_chain_draw(key, ref_cfg.ransac_hypotheses))
    np.testing.assert_array_equal(np.asarray(r.grid.data), p.grid.data.numpy())
    for k in COUNTS + FLAGS:
        assert int(getattr(r.stats, k)) == int(getattr(p.stats, k)), k
    ca = np.asarray(r.centroids.points.xyzr)[np.asarray(r.centroids.valid)]
    cb = p.centroids.points.xyzr.numpy()[p.centroids.valid.numpy()]
    assert ca.shape == cb.shape
    if len(ca):
        assert np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max() < 1e-5
    return r, p


@pytest.mark.parametrize("packing", [False, True])
def test_slice_meets_crosscheck_bar(packing):
    scene = make_scene(seed=11, spec=SPEC, nan_frac=0.01)
    r, p = _crosscheck(CFG.replace(voxel_payload_packing=packing), scene.points, 0)
    assert int(p.stats.num_planes) >= 1 and int(p.stats.num_clusters) >= 3
    # the debug clouds the reference publishes
    for name in ("voxel_cloud", "outlier_filtered_cloud", "plane_cloud", "last_plane_cloud",
                 "nonplane_cloud"):
        np.testing.assert_array_equal(np.asarray(getattr(r, name).valid),
                                      getattr(p, name).valid.numpy())
    k = int(p.stats.voxel_points)
    np.testing.assert_array_equal(np.asarray(r.voxel_cloud.points)[:k],
                                  p.voxel_cloud.points.numpy()[:k])
    np.testing.assert_array_equal(np.asarray(r.clusters.point_cluster),
                                  p.clusters.point_cluster.numpy())
    np.testing.assert_array_equal(p.planes.coeffs.numpy(), np.asarray(r.planes.coeffs))


def test_model_facade_runs_the_slice_with_its_generator():
    cfg = port.REFERENCE_YAML_CONFIG.replace(
        max_points=8192, max_voxels=2048, cluster_capacity=512, max_clusters=8,
        downsample_leaf_size=0.06, knn_band=256, knn_row_tile=256,
    )
    scene = make_scene(seed=3, spec=SceneSpec(n_ground=6000, n_rocks=2, points_per_rock=600,
                                              n_noise=40))
    cloud = port.Cloud.pad_to(scene.points[: cfg.max_points], cfg.max_points)
    a = ObstacleDetectionModel(cfg, device="cpu", seed=1)(cloud)
    b = ObstacleDetectionModel(cfg, device="cpu", seed=1)(cloud)
    np.testing.assert_array_equal(a.grid.data.numpy(), b.grid.data.numpy())
    assert a.grid.data.shape == (cfg.grid_height, cfg.grid_width)
    assert int(a.stats.num_planes) >= 1 and int(a.stats.num_clusters) >= 1
    assert np.isfinite(a.centroids.points.xyzr.numpy()).all()
    assert 0 <= a.host_syncs < cfg.cluster_max_iters
    with pytest.raises(ValueError):  # an engine the port does not carry yet
        ObstacleDetectionModel(cfg.replace(voxel_binning="mxu"), device="cpu")


def test_slice_with_banded_cluster_sweep_meets_crosscheck_bar():
    """The small config with a 512-column band over its 2048-point cluster
    buffer: the banded sweep, its frontier gating and its overflow flag."""
    scene = make_scene(seed=11, spec=SPEC, nan_frac=0.01)
    r, p = _crosscheck(CFG.replace(cluster_band_window=512, voxel_payload_packing=True),
                       scene.points, 0)
    assert int(p.stats.num_clusters) >= 3
    np.testing.assert_array_equal(np.asarray(r.clusters.point_cluster),
                                  p.clusters.point_cluster.numpy())


@pytest.mark.slow
def test_fullscale_knobs_crosscheck_case(monkeypatch):
    """The fullscale preset's knobs (0.015 leaf, kNN row tile 1024 and band
    1280, a 16384-point cluster buffer with the 4096-column band) on a
    quarter of the arena's x extent at authentic density (the window of
    tests/test_outliers.py: 524,288 points into 49,152 voxel slots),
    through both packages."""
    from pointcloud_obstacle_processing_tpu.models import REFERENCE_FULLSCALE_CONFIG as f

    cfg = f.replace(x_max=f.x_max / 4, max_points=524288, max_voxels=49152)
    spec = SceneSpec(x_max=cfg.x_max, n_ground=230_000 // 4, n_rocks=2, points_per_rock=3_000,
                     n_noise=500, n_craters=1)
    base = make_scene(seed=11, spec=spec).points
    jit_rng = np.random.default_rng(3)
    pts = np.concatenate([base + jit_rng.normal(0, 0.003, base.shape).astype(np.float32)
                          for _ in range(8)])
    banded_sweeps = []
    sweep = port_cluster.sweep_jump_banded
    monkeypatch.setattr(port_cluster, "sweep_jump_banded",
                        lambda *a: banded_sweeps.append(1) or sweep(*a))
    r, p = _crosscheck(cfg, pts, 42)
    assert banded_sweeps and int(p.stats.nonplane_points) > 500
    for k in ("voxel_overflow", "cluster_overflow", "cluster_band_overflow"):
        assert not bool(getattr(p.stats, k)), k
    np.testing.assert_array_equal(np.asarray(r.clusters.point_cluster),
                                  p.clusters.point_cluster.numpy())


@pytest.mark.slow
def test_flagship_crosscheck_case():
    """The crosscheck script's "flagship" case through both packages."""
    scene = make_scene(seed=0, spec=SceneSpec(n_ground=90_000, n_rocks=4, points_per_rock=2_000,
                                              n_noise=500))
    _crosscheck(ref_models.FLAGSHIP_CONFIG, scene.points, 5)
