"""``process_scan`` of the PyTorch port under each voxel engine the
reference runs besides the sort engine's lattice order (``scatter``,
``mxu`` with ``voxel_sum_precision`` "fast" and "exact", the Morton order),
against the JAX package's, held to the crosscheck bar of
scripts/crosscheck_tpu_cpu.py (grid bit-identical, stage counts and every
flag exact, centroids within 1e-5) and more: the voxel cloud and the plane
coefficients bitwise.  One reference compile a case (~11 s)."""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_pipeline import _crosscheck
from test_torch_voxel_engines import fold_spy  # noqa: F401  (a fixture)

import pointcloud_obstacle_processing_tpu as ref
from pointcloud_obstacle_processing_tpu.utils.scene import SceneSpec, make_scene

# the small config of tests/test_torch_pipeline.py's facade test
SMALL = ref.REFERENCE_YAML_CONFIG.replace(
    max_points=8192, max_voxels=2048, cluster_capacity=512, max_clusters=8,
    downsample_leaf_size=0.06, knn_band=256, knn_row_tile=256)
SCAN_CASES = {
    "scatter": dict(voxel_binning="scatter"),
    "mxu_fast": dict(voxel_binning="mxu"),
    "mxu_exact": dict(voxel_binning="mxu", voxel_sum_precision="exact"),
    "morton": dict(voxel_order="morton", voxel_payload_packing=True),
}


def crosscheck_case(override: dict):
    """The small config with ``override`` on a seeded scene through both
    packages: the crosscheck bar, the voxel cloud and the planes bitwise."""
    cfg = SMALL.replace(**override)
    scene = make_scene(seed=3, spec=SceneSpec(n_ground=6000, n_rocks=2, points_per_rock=600,
                                              n_noise=40))
    r, p = _crosscheck(cfg, scene.points, 1)
    assert int(p.stats.num_clusters) >= 1
    k = int(p.stats.voxel_points)
    np.testing.assert_array_equal(np.asarray(r.voxel_cloud.valid), p.voxel_cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.voxel_cloud.points)[:k],
                                  p.voxel_cloud.points.numpy()[:k])
    np.testing.assert_array_equal(p.planes.coeffs.numpy(), np.asarray(r.planes.coeffs))
    return r, p


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_process_scan_under_each_engine_meets_crosscheck_bar(case, fold_spy):
    """Each engine's scan, its segment fold calls within the kernel's
    contract: one a scan for the dense engines, whatever the split terms."""
    crosscheck_case(SCAN_CASES[case])
    assert len(fold_spy) == (0 if case == "morton" else 1)
