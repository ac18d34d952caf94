"""The PyTorch port's copies of pure-Python state, held equal to the JAX
package, and the port's import and configuration contracts."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pointcloud_obstacle_processing_tpu as ref
import pointcloud_obstacle_processing_tpu.models as ref_models
from pointcloud_obstacle_processing_tpu.utils.scene import SceneSpec as RefSpec
from pointcloud_obstacle_processing_tpu.utils.scene import make_scene as ref_make_scene

import pointcloud_obstacle_processing_tpu_torch as port
import pointcloud_obstacle_processing_tpu_torch.models as port_models
from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "name",
    ["default", "REFERENCE_YAML_CONFIG", "FLAGSHIP_CONFIG", "REFERENCE_FULLSCALE_CONFIG"],
)
def test_config_copy_equals_reference(name):
    if name == "default":
        a, b = ref.PipelineConfig(), port.PipelineConfig()
    elif name == "REFERENCE_YAML_CONFIG":
        a, b = ref.REFERENCE_YAML_CONFIG, port.REFERENCE_YAML_CONFIG
    else:
        a, b = getattr(ref_models, name), getattr(port_models, name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for prop in ("grid_width", "grid_height", "grid_size", "eps_angle_radians"):
        assert getattr(a, prop) == getattr(b, prop)


def test_config_from_dict_copy_matches_reference():
    d = {
        "x_min": 0.5,
        "obstacle_detection": {"x_min": 9.0, "downsame_input_data": False, "block_size": 0.05,
                               "statistical_outlier_meanK": 12},
    }
    a = ref.config_from_dict(d)
    b = port.config_from_dict(d)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.x_min == 0.5 and b.downsample_input_data is False


@pytest.mark.parametrize(
    "override",
    [
        dict(cluster_band_window=4096, cluster_capacity=4104),  # band needs 128-multiple capacity
    ],
)
def test_validate_refuses_unported_engines(override):
    base = port_models.FLAGSHIP_CONFIG
    with pytest.raises(ValueError):
        base.replace(**override).validate()


@pytest.mark.parametrize(
    "override",
    [
        dict(knn_backend="exact"),
        dict(knn_backend="approx"),
        dict(knn_backend="banded_approx"),
        dict(downsample_input_data=False),
    ],
)
def test_validate_accepts_the_ported_knn_engines(override):
    """The kNN engines and the undownsampled path, once refused, validate
    and run a small scan to a finite result."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan

    cfg = port.REFERENCE_YAML_CONFIG.replace(
        max_points=8192, max_voxels=2048, cluster_capacity=512, max_clusters=8,
        downsample_leaf_size=0.06, knn_band=256, knn_row_tile=256, **override)
    cfg.validate()
    scene = make_scene(seed=3, spec=SceneSpec(n_ground=6000, n_rocks=2, points_per_rock=600,
                                              n_noise=40))
    res = process_scan(port.Cloud.pad_to(scene.points[: cfg.max_points], cfg.max_points), cfg,
                       generator=torch.Generator().manual_seed(0))
    assert res.grid.data.shape == (cfg.grid_height, cfg.grid_width)
    assert int(res.stats.inlier_points) > 0
    assert np.isfinite(res.centroids.points.xyzr.numpy()).all()


def test_validate_accepts_the_ported_slice():
    port_models.FLAGSHIP_CONFIG.validate()
    port_models.FLAGSHIP_CONFIG.replace(voxel_payload_packing=False).validate()
    port_models.REFERENCE_FULLSCALE_CONFIG.validate()  # the fullscale preset validates


def test_fullscale_lattice_fits_the_sort_engine():
    """The fullscale crop box at the 0.015 leaf packs into 302 x 254 x 52 =
    3,988,816 bins: at most 2^23, so the sort engine applies, and below
    2^24, so K1's float32 key channel is exact.  A larger lattice does not
    pack: the dense engines refuse it, as the reference's do (``auto`` takes
    the 3-key fallback, ``tests/test_torch_voxel_engines.py``)."""
    from pointcloud_obstacle_processing_tpu.ops.voxel import _pack_spec as ref_pack_spec

    from pointcloud_obstacle_processing_tpu_torch.ops import voxel

    cfg = port_models.REFERENCE_FULLSCALE_CONFIG
    bounds = ((cfg.x_min, cfg.y_min, cfg.z_min), (cfg.x_max, cfg.y_max, cfg.z_max))
    imin, dims = voxel._pack_spec(bounds, cfg.downsample_leaf_size)
    assert (imin, dims) == ref_pack_spec(bounds, cfg.downsample_leaf_size)
    assert dims == [302, 254, 52]
    bins = dims[0] * dims[1] * dims[2]
    assert bins == 3_988_816 and bins <= 2**23 and bins < 2**24
    cloud = port.Cloud.from_points(np.zeros((128, 3), np.float32), device="cpu")
    big = ((0.0, 0.0, -0.5), (9.0, 7.56, 0.25))  # 4x the bins: past 2^23
    with pytest.raises(ValueError, match="2\\^23"):
        voxel.voxel_partials(cloud, cfg.downsample_leaf_size, 1024, big, binning="scatter")


def test_entry_points_default_to_the_card(monkeypatch):
    """The model and ``from_reference`` run on the card unless told
    otherwise; with no card they raise rather than run on the CPU."""
    import inspect

    import torch

    assert inspect.signature(port_models.ObstacleDetectionModel).parameters["device"].default == "cuda"
    assert inspect.signature(port.from_reference).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.ObstacleDetectionModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.from_reference(points=np.zeros((4, 3), np.float32))
    assert port_models.ObstacleDetectionModel(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("seed,nan_frac", [(0, 0.0), (11, 0.01)])
def test_scene_copy_equals_reference(seed, nan_frac):
    spec_kw = dict(n_ground=3000, n_rocks=2, points_per_rock=200, n_noise=50)
    a = ref_make_scene(seed=seed, spec=RefSpec(**spec_kw), nan_frac=nan_frac)
    b = make_scene(seed=seed, spec=SceneSpec(**spec_kw), nan_frac=nan_frac)
    for field in ("points", "labels", "rock_centers", "rock_radii", "crater_centers",
                  "crater_radii"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("fill", [float("nan"), 0.0, -7.5])
def test_masked_points_equals_reference(fill):
    """``Cloud.masked_points`` against the reference's on a seeded scene
    with NaN points, padded, one cloud and a batch of two."""
    scene = make_scene(seed=11, spec=SceneSpec(n_ground=3000, n_rocks=2, points_per_rock=200,
                                               n_noise=50), nan_frac=0.01)
    pts = np.zeros((2, 4096, 3), np.float32)
    pts[:, : len(scene.points)] = scene.points
    valid = np.random.default_rng(0).random((2, 4096)) < 0.8
    valid[:, len(scene.points):] = False
    for p, v in ((pts[0], valid[0]), (pts, valid)):
        want = np.asarray(ref.Cloud(points=p, valid=v).masked_points(fill))
        got = port.Cloud(points=torch.tensor(p), valid=torch.tensor(v)).masked_points(fill)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(scene.points).any()


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import pointcloud_obstacle_processing_tpu_torch as p\n"
        "import pointcloud_obstacle_processing_tpu_torch.pipeline\n"
        "import pointcloud_obstacle_processing_tpu_torch.models\n"
        "import pointcloud_obstacle_processing_tpu_torch.utils.scene\n"
        "import pointcloud_obstacle_processing_tpu_torch.utils.bounds\n"
        "import pointcloud_obstacle_processing_tpu_torch.ops.segscan\n"
        "import pointcloud_obstacle_processing_tpu_torch.ops.binning\n"
        "import pointcloud_obstacle_processing_tpu_torch.native\n"
        "import pointcloud_obstacle_processing_tpu_torch.runtime\n"
        "import pointcloud_obstacle_processing_tpu_torch.runtime.launch\n"
        "import pointcloud_obstacle_processing_tpu_torch.runtime.calibration\n"
        "import pointcloud_obstacle_processing_tpu_torch.runtime.recording\n"
        "import pointcloud_obstacle_processing_tpu_torch.runtime.transport\n"
        "import pointcloud_obstacle_processing_tpu_torch.utils.timing\n"
        "import pointcloud_obstacle_processing_tpu_torch.parallel.collectives\n"
        "import pointcloud_obstacle_processing_tpu_torch.parallel.ranks\n"
        "import pointcloud_obstacle_processing_tpu_torch.parallel.sharding\n"
        "from pointcloud_obstacle_processing_tpu_torch.native import ScanAccumulator\n"
        "assert ScanAccumulator(8).backend in ('native', 'numpy')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pointcloud_obstacle_processing_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "pointcloud_obstacle_processing_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for word in ("import jax", "from jax", "import flax", "from flax",
                             "import pointcloud_obstacle_processing_tpu\n",
                             "from pointcloud_obstacle_processing_tpu ",
                             "from pointcloud_obstacle_processing_tpu."):
                    assert word not in text, (f, word)


def test_from_reference_carries_config_cloud_and_pose():
    cfg = ref.REFERENCE_YAML_CONFIG.replace(max_points=256, max_voxels=128)
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((256, 3)).astype(np.float32)
    valid = rng.random(256) < 0.7
    q = np.array([0.0, 0.0, 0.38268343, 0.92387953], np.float32)
    t = np.array([1.0, -2.0, 0.5], np.float32)
    st = port.from_reference(dataclasses.asdict(cfg), pts, valid, q, t, device="cpu")
    assert dataclasses.asdict(st.config) == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(st.cloud.points.numpy(), pts)
    np.testing.assert_array_equal(st.cloud.valid.numpy(), valid)
    np.testing.assert_array_equal(st.pose.quat_xyzw.numpy(), q)
    np.testing.assert_array_equal(st.pose.translation.numpy(), t)
    assert port.from_reference(device="cpu").cloud is None
    with pytest.raises(ValueError):
        port.from_reference(quat_xyzw=q, device="cpu")
