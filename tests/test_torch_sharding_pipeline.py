"""The point-sharded and data-parallel pipelines of the PyTorch port on
spawned gloo ranks against the JAX package's ``dp_sp_pipeline`` on the
8-virtual-device CPU mesh of ``tests/conftest.py``, on the same mesh
shapes (1x2, 1x4, 2x2) and the same inputs, each scan held to the
crosscheck bar of scripts/crosscheck_tpu_cpu.py (grid bit-identical, stage
counts and every flag exact, centroids within 1e-5) and more: every
point's cluster, the plane coefficients and the merged voxel cloud
bitwise, with the reference's RANSAC key chain replayed from its random
words.  Then ``shard_post_voxel`` on and off bitwise equal, every rank of a
``points`` row equal, the point-sharded scan against the single-scan run by
the reference's own bar (tests/test_sharding.py:61-84), and
``data_parallel_pipeline`` against ``batched_pipeline``.

The reference's ``test_sharding.py`` config (8,192 points, 2,048 voxels)
with its ``SHARD_CFG`` kNN tile and band and cluster band (its plain
``CFG`` also takes the banded kNN: 512 + 2*512 = 1,536 columns < 2,048;
``SHARD_CFG``'s tiles of 128 split over the ranks), and once with
``knn_backend="exact"``: the full-width kNN, its query tiles split over
the ranks.  The ranks are spawned once for the module (4 ranks, every job
in one group), with timeouts."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_sharding import SHARD_CFG, _batch
from test_torch_pipeline import COUNTS, FLAGS
from test_torch_sharding import jax_draw_bits

from pointcloud_obstacle_processing_tpu.parallel.sharding import dp_sp_pipeline as ref_dp_sp
from pointcloud_obstacle_processing_tpu.parallel.sharding import make_mesh

from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_bits
from pointcloud_obstacle_processing_tpu_torch.parallel import ranks
from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
from pointcloud_obstacle_processing_tpu_torch.types import Cloud, scan_of

WORLD = 4
TIMEOUT_S = 300.0

# name -> (mesh, config, batch seed, key seed, reference options): the
# banded sweep and the dense merge; the full sweep with the key-range
# merge forced on; the 2-D mesh
SP_CASES = {
    "1x2": ({"data": 1, "points": 2}, SHARD_CFG, 3, 4, {}),
    "1x4": ({"data": 1, "points": 4}, SHARD_CFG.replace(cluster_band_window=0), 7, 9,
            {"distribute_merge": True}),
    "2x2": ({"data": 2, "points": 2}, SHARD_CFG, 11, 5, {}),
    "1x2_exact": ({"data": 1, "points": 2}, SHARD_CFG.replace(knn_backend="exact"), 3, 4, {}),
}
DP_BATCH, DP_SEED, DP_KEY = 4, 20, 6
# the batch with the full sweep, and with the banded sweep (SHARD_CFG)
DP_CFG = SHARD_CFG.replace(cluster_band_window=0)


def _port_cfg(cfg) -> PipelineConfig:
    return PipelineConfig(**dataclasses.asdict(cfg))


def _inputs(case):
    mesh, cfg, seed, key_seed, _ = SP_CASES[case]
    clouds = _batch(mesh["data"], seed0=seed)
    keys = jax.random.split(jax.random.PRNGKey(key_seed), mesh["data"])
    return cfg, clouds, keys


def _jobs():
    jobs = []
    for case, (mesh, cfg, _, _, opts) in SP_CASES.items():
        cfg, clouds, keys = _inputs(case)
        hi, lo = jax_draw_bits(keys, cfg.max_planes, cfg.ransac_hypotheses)
        for shard_post_voxel in (True, False):
            jobs.append(dict(kind="dp_sp", config=_port_cfg(cfg), mesh=mesh,
                             points=np.asarray(clouds.points), valid=np.asarray(clouds.valid),
                             draw=("bits", hi, lo),
                             options=dict(opts, shard_post_voxel=shard_post_voxel)))
    clouds = _batch(DP_BATCH, seed0=DP_SEED)
    keys = jax.random.split(jax.random.PRNGKey(DP_KEY), DP_BATCH)
    hi, lo = jax_draw_bits(keys, DP_CFG.max_planes, DP_CFG.ransac_hypotheses)
    for cfg in (DP_CFG, SHARD_CFG):
        jobs.append(dict(kind="data_parallel", config=_port_cfg(cfg), mesh={"data": 2},
                         points=np.asarray(clouds.points), valid=np.asarray(clouds.valid),
                         draw=("bits", hi, lo)))
    # draws from a generator seeded differently on each rank: the first
    # rank's are broadcast
    jobs.append(dict(kind="dp_sp", config=_port_cfg(SHARD_CFG), mesh={"data": 2, "points": 2},
                     points=np.asarray(clouds.points[:2]), valid=np.asarray(clouds.valid[:2]),
                     draw=("generator", 3)))
    return jobs


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every job on the port's gloo ranks in one spawn: {(case, shard_post_voxel)
    or "dp": the jobs' per-rank results (None off the mesh)}."""
    out = ranks.spawn(ranks.run_jobs, WORLD, _jobs(), timeout_s=TIMEOUT_S,
                      tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    keys = [(c, s) for c in SP_CASES for s in (True, False)] + ["dp", "dp_banded", "generator"]
    return {k: [r[j] for r in out] for j, k in enumerate(keys)}


def _scans(results, mesh):
    """The whole batch's results, from the ranks of the first ``points``
    column, scan by scan."""
    p = mesh["points"]
    return [scan_of(results[d * p]["out"], i)
            for d in range(mesh["data"]) for i in range(results[d * p]["out"].grid.data.shape[0])]


def _assert_crosscheck(ref, b, got):
    """Scan ``b`` of the reference's batched result against the port's scan."""
    r = jax.tree_util.tree_map(lambda x: np.asarray(x)[b], ref)
    np.testing.assert_array_equal(r.grid.data, got.grid.data.numpy())
    for k in COUNTS + FLAGS:
        assert int(getattr(r.stats, k)) == int(getattr(got.stats, k)), k
    ca = r.centroids.points.xyzr[r.centroids.valid]
    cb = got.centroids.points.xyzr.numpy()[got.centroids.valid.numpy()]
    assert ca.shape == cb.shape
    if len(ca):
        assert np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max() < 1e-5
    np.testing.assert_array_equal(r.clusters.point_cluster, got.clusters.point_cluster.numpy())
    np.testing.assert_array_equal(r.planes.coeffs, got.planes.coeffs.numpy())
    k = int(got.stats.voxel_points)
    np.testing.assert_array_equal(r.voxel_cloud.valid, got.voxel_cloud.valid.numpy())
    np.testing.assert_array_equal(r.voxel_cloud.points[:k], got.voxel_cloud.points.numpy()[:k])


@pytest.mark.parametrize("case", list(SP_CASES))
def test_dp_sp_meets_crosscheck_bar_against_reference(port_runs, case):
    mesh, _, _, _, opts = SP_CASES[case]
    cfg, clouds, keys = _inputs(case)
    jmesh = make_mesh(mesh, devices=jax.devices()[: mesh["data"] * mesh["points"]])
    want = ref_dp_sp(cfg, jmesh, **opts)(clouds, keys)
    scans = _scans(port_runs[(case, True)], mesh)
    assert len(scans) == mesh["data"]
    for b, got in enumerate(scans):
        _assert_crosscheck(want, b, got)
        assert int(got.stats.num_clusters) >= 1  # the scene has rocks


@pytest.mark.parametrize("case", list(SP_CASES))
def test_shard_post_voxel_is_bitwise_the_replicated_form(port_runs, case):
    """The kNN's query tiles and the sweeps' rows split over ``points`` give
    every output of the replicated form bit for bit, on every rank, and
    every rank of a ``points`` row holds the same result."""
    sh, rep = port_runs[(case, True)], port_runs[(case, False)]
    p = SP_CASES[case][0]["points"]
    for rank, (a, b) in enumerate(zip(sh, rep)):
        if a is None:
            continue
        lead = sh[rank - rank % p]["out"]  # the row's first rank
        for x, y, z in zip(_leaves(a["out"]), _leaves(b["out"]), _leaves(lead)):
            assert torch.equal(x, y) and torch.equal(x, z)
        assert a["launches"]["knn_mean_rows"] == 0  # the CPU takes the plain versions
        assert a["collectives"]["calls"] > b["collectives"]["calls"]  # the gathers ran


def _leaves(res):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))

    walk(res)
    return out


def test_point_sharded_scan_keeps_the_single_scan_structure(port_runs):
    """The reference's SP-against-single bar (tests/test_sharding.py:61-84):
    crop and voxel counts exact, the cluster count equal, under 1% of the
    grid's cells different and centroids within 5e-2; the voxel sums
    re-associate across shards, so no more is promised."""
    case = "1x4"
    cfg, clouds, keys = _inputs(case)
    hi, lo = jax_draw_bits(keys, cfg.max_planes, cfg.ransac_hypotheses)
    single = process_scan(Cloud(points=torch.tensor(np.asarray(clouds.points[0])),
                                valid=torch.tensor(np.asarray(clouds.valid[0]))),
                          _port_cfg(cfg), draw=draw_from_bits(torch.tensor(hi[0]),
                                                              torch.tensor(lo[0])))
    got = _scans(port_runs[(case, True)], SP_CASES[case][0])[0]
    assert int(got.stats.cropped_points) == int(single.stats.cropped_points)
    assert int(got.stats.voxel_points) == int(single.stats.voxel_points)
    assert int(got.clusters.num_clusters) == int(single.clusters.num_clusters)
    assert (got.grid.data != single.grid.data).float().mean() < 0.01
    np.testing.assert_allclose(got.centroids.points.xyzr.numpy(),
                               single.centroids.points.xyzr.numpy(), atol=5e-2)


def test_data_parallel_is_the_batched_pipeline(port_runs):
    """Each rank's two scans of ``data_parallel_pipeline`` equal
    ``batched_pipeline`` on the whole batch, bit for bit, with no
    collective."""
    _assert_data_parallel(port_runs["dp"], DP_CFG)


def test_data_parallel_banded_is_the_batched_pipeline(port_runs):
    """The same with the banded cluster sweep (``SHARD_CFG``): each rank's
    two scans run one batched banded loop."""
    _assert_data_parallel(port_runs["dp_banded"], SHARD_CFG)
    assert (port_runs["dp_banded"][0]["out"].stats.num_clusters >= 1).all()


def _assert_data_parallel(runs, cfg):
    clouds = _batch(DP_BATCH, seed0=DP_SEED)
    keys = jax.random.split(jax.random.PRNGKey(DP_KEY), DP_BATCH)
    hi, lo = jax_draw_bits(keys, cfg.max_planes, cfg.ransac_hypotheses)
    whole = batched_pipeline(_port_cfg(cfg))(
        Cloud(points=torch.tensor(np.asarray(clouds.points)),
              valid=torch.tensor(np.asarray(clouds.valid))),
        draw=draw_from_bits(torch.tensor(hi), torch.tensor(lo)))
    assert runs[2] is None and runs[3] is None  # a mesh of the first two ranks
    for rank in (0, 1):
        assert runs[rank]["collectives"]["calls"] == 0
        for i in range(2):
            for x, y in zip(_leaves(scan_of(runs[rank]["out"], i)),
                            _leaves(scan_of(whole, 2 * rank + i))):
                assert torch.equal(x, y)


def test_draws_from_a_generator_are_the_first_ranks(port_runs):
    """With a generator (seeded differently on each rank) and no draw, every
    rank takes the draws made on the mesh's first rank: both ranks of a
    ``points`` row hold the same result, and the two scans of the batch,
    whose draws come from one broadcast tensor, found their planes."""
    runs = port_runs["generator"]
    for row in ((0, 1), (2, 3)):
        a, b = (runs[r]["out"] for r in row)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert torch.equal(x, y)
        assert (a.stats.num_planes >= 1).all()
    assert runs[0]["collectives"]["calls"] > 0
