"""``process_scan`` of the PyTorch port where the voxel stage leaves the
sort engine on its own, against the JAX package's: a leaf whose lattice
does not pack into one key (the 3-key fallback), ``max_voxels`` off the 128
grid (the rank-scatter ``compact`` of the non-plane cloud) and
``max_points`` off it (``auto`` takes the dense ``mxu`` engine); then the
point-sharded body on two gloo ranks with the ``scatter`` engine (the dense
merge) and with an unpackable leaf (the 3-key merge), against the
reference's ``dp_sp_pipeline`` on a 1x2 mesh of the 8-virtual-device CPU
mesh.  Bar: the crosscheck bar of scripts/crosscheck_tpu_cpu.py and more
(the voxel cloud, planes and every point's cluster bitwise)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from test_sharding import SHARD_CFG, _batch
from test_torch_sharding import jax_draw_bits
from test_torch_sharding_pipeline import _assert_crosscheck
from test_torch_voxel_engine_scans import crosscheck_case
from test_torch_voxel_engines import fold_spy  # noqa: F401  (a fixture)

from pointcloud_obstacle_processing_tpu.parallel.sharding import dp_sp_pipeline as ref_dp_sp
from pointcloud_obstacle_processing_tpu.parallel.sharding import make_mesh

from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.parallel import ranks
from pointcloud_obstacle_processing_tpu_torch.types import scan_of

SCAN_CASES = {
    # 452 x 380 x 77 bins: the 3-key fallback, nearly a voxel a point
    "fine_leaf": dict(downsample_leaf_size=0.01, max_voxels=8192, cluster_capacity=1024),
    "max_voxels_2040": dict(max_voxels=2040),
    "max_points_8000": dict(max_points=8000),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_process_scan_off_the_sort_engine_meets_crosscheck_bar(case, fold_spy):
    """Each case's scan; its segment fold calls (the fine leaf's 3-key
    fallback, the buffer off the 128 grid's dense engine) within the
    kernel's contract."""
    crosscheck_case(SCAN_CASES[case])
    assert len(fold_spy) == {"fine_leaf": 1, "max_voxels_2040": 0, "max_points_8000": 1}[case]


# the scatter engine's tables merged densely; a leaf whose lattice does not
# pack (902 x 758 x 152 bins), every shard's table merged by the 3-key sort
SP_CASES = {
    "scatter": SHARD_CFG.replace(voxel_binning="scatter"),
    "unpackable": SHARD_CFG.replace(downsample_leaf_size=0.005),
}
SP_MESH = {"data": 1, "points": 2}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Both jobs on 2 gloo ranks in one spawn, with timeouts."""
    clouds = _batch(1, seed0=3)
    keys = jax.random.split(jax.random.PRNGKey(4), 1)
    jobs = []
    for cfg in SP_CASES.values():
        hi, lo = jax_draw_bits(keys, cfg.max_planes, cfg.ransac_hypotheses)
        jobs.append(dict(kind="dp_sp", config=PipelineConfig(**dataclasses.asdict(cfg)),
                         mesh=SP_MESH, points=np.asarray(clouds.points),
                         valid=np.asarray(clouds.valid), draw=("bits", hi, lo)))
    out = ranks.spawn(ranks.run_jobs, 2, jobs, timeout_s=240.0,
                      tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return clouds, keys, {name: [r[j] for r in out] for j, name in enumerate(SP_CASES)}


@pytest.mark.parametrize("case", list(SP_CASES))
def test_point_sharded_body_meets_crosscheck_bar(sharded_runs, case):
    """Each rank's result against the reference's batched result."""
    clouds, keys, runs = sharded_runs
    want = ref_dp_sp(SP_CASES[case], make_mesh(SP_MESH, devices=jax.devices()[:2]))(clouds, keys)
    for rank in runs[case]:
        _assert_crosscheck(want, 0, scan_of(rank["out"], 0))
