"""The batched path: ``process_scan`` of the PyTorch port on a batch of
scans against the JAX package's ``batched_pipeline`` (``jax.vmap`` of
``process_scan``), each scan held to the crosscheck bar of
scripts/crosscheck_tpu_cpu.py with its RANSAC key chain replayed; each scan
of the port's batch against the port's own single-scan run; the batched
plain versions of kernels K1-K4 against their per-scan calls; and the
facade and ``from_reference`` on a batch.  Three distinct seeded scenes at
``tests/test_torch_pipeline.py``'s small config, each with its own count
of valid points."""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_pipeline import CFG, COUNTS, FLAGS, SPEC
from test_torch_ransac import jax_key_chain_draw

import pointcloud_obstacle_processing_tpu as ref
from pointcloud_obstacle_processing_tpu.parallel.sharding import batched_pipeline as ref_batched
from pointcloud_obstacle_processing_tpu.utils.scene import make_scene

import pointcloud_obstacle_processing_tpu_torch as port
from pointcloud_obstacle_processing_tpu_torch.models import ObstacleDetectionModel
from pointcloud_obstacle_processing_tpu_torch.ops import cluster, compaction, outliers, runreduce
from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
from pointcloud_obstacle_processing_tpu_torch.types import Cloud, scan_of

B = 3
SCENE_SEEDS = (11, 12, 13)
KEY_SEED = 7


@functools.cache
def _inputs():
    """[B, N, 3] points and [B, N] masks: the scenes' first points, each
    scan a different count (every fifth point dropped from the second)."""
    n = CFG.max_points
    buf = np.zeros((B, n, 3), np.float32)
    valid = np.zeros((B, n), bool)
    for b, seed in enumerate(SCENE_SEEDS):
        pts = make_scene(seed=seed, spec=SPEC, nan_frac=0.01).points
        if b == 1:
            pts = pts[np.arange(len(pts)) % 5 != 0]
        pts = pts[:n]
        buf[b, : len(pts)] = pts
        valid[b, : len(pts)] = True
    return buf, valid


def _batched_draw(keys, hypotheses):
    """Each scan's draws from its own key, as the reference's vmapped
    ``process_scan`` draws them."""
    draws = [jax_key_chain_draw(k, hypotheses) for k in keys]

    def draw(r, n_valid):
        return torch.stack([d(r, n_valid[b]) for b, d in enumerate(draws)])

    return draw


@functools.cache
def _runs(packing: bool):
    """The reference's batched run, the port's batched run and the port's
    single-scan runs of the same scans with the same draws."""
    cfg = CFG.replace(voxel_payload_packing=packing)
    buf, valid = _inputs()
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), B)
    r = ref_batched(cfg)(ref.Cloud.from_points(buf, valid), keys)
    st = port.from_reference(dataclasses.asdict(cfg), buf, valid, device="cpu")
    p = process_scan(st.cloud, st.config, draw=_batched_draw(keys, cfg.ransac_hypotheses))
    singles = [process_scan(scan_of(st.cloud, b), st.config,
                            draw=jax_key_chain_draw(keys[b], cfg.ransac_hypotheses))
               for b in range(B)]
    return r, p, singles


def _ref_scan(r, b):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[b], r)


@pytest.mark.parametrize("packing", [False, True])
def test_batch_meets_crosscheck_bar_against_reference_batched_pipeline(packing):
    r, p, _ = _runs(packing)
    assert p.grid.data.shape == (B, CFG.grid_height, CFG.grid_width)
    for b in range(B):
        rb, pb = _ref_scan(r, b), scan_of(p, b)
        np.testing.assert_array_equal(rb.grid.data, pb.grid.data.numpy())
        for k in COUNTS + FLAGS:
            assert int(getattr(rb.stats, k)) == int(getattr(pb.stats, k)), (b, k)
        ca = rb.centroids.points.xyzr[rb.centroids.valid]
        cb = pb.centroids.points.xyzr.numpy()[pb.centroids.valid.numpy()]
        assert ca.shape == cb.shape
        if len(ca):
            assert np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max() < 1e-5
        np.testing.assert_array_equal(rb.clusters.point_cluster, pb.clusters.point_cluster.numpy())
        np.testing.assert_array_equal(rb.planes.coeffs, pb.planes.coeffs.numpy())
        k = int(pb.stats.voxel_points)
        np.testing.assert_array_equal(rb.voxel_cloud.valid, pb.voxel_cloud.valid.numpy())
        np.testing.assert_array_equal(rb.voxel_cloud.points[:k], pb.voxel_cloud.points.numpy()[:k])
    counts = p.stats.accumulated_points.tolist()
    assert len(set(counts)) == B, counts  # every scan has its own count
    assert (p.stats.num_clusters >= 1).all()


@pytest.mark.parametrize("packing", [False, True])
def test_each_scan_of_the_batch_is_its_single_scan_run(packing):
    """Stronger than the bar: every field of each scan's result equals the
    single-scan run bit for bit (the stages take the scan axis as it comes;
    no sum or sort mixes two scans)."""
    _, p, singles = _runs(packing)
    for b, s in enumerate(singles):
        pb = scan_of(p, b)
        for name in ("grid", "centroids", "clusters", "obstacle_cloud", "planes", "stats",
                     "voxel_cloud", "outlier_filtered_cloud", "plane_cloud",
                     "last_plane_cloud", "nonplane_cloud"):
            got, want = getattr(pb, name), getattr(s, name)
            for f in dataclasses.fields(want):
                a, w = getattr(got, f.name), getattr(want, f.name)
                if isinstance(w, torch.Tensor):
                    assert torch.equal(a, w), (b, name, f.name)
                elif dataclasses.is_dataclass(w):
                    assert torch.equal(a.xyzr, w.xyzr), (b, name, f.name)


def _k1_case(rng, b):
    n, sentinel = 4096, 5000
    skey = np.full(n, sentinel, np.int32)
    n_valid = 3000 + 300 * b
    skey[:n_valid] = np.sort(rng.integers(0, 900, n_valid))
    pxy = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    pz = rng.integers(0, 65536, n).astype(np.int32)
    return skey, pxy, pz


@pytest.mark.parametrize("kernel", ["runreduce", "compact_gather", "knn_mean", "cluster_loop"])
def test_batched_plain_versions_equal_per_scan_calls(kernel):
    """K1-K4's batched plain versions (the wrappers on CPU tensors) equal
    their per-scan single calls bitwise, on scans that differ."""
    rng = np.random.default_rng(["runreduce", "compact_gather", "knn_mean",
                                 "cluster_loop"].index(kernel))
    if kernel == "runreduce":
        cases = [_k1_case(rng, b) for b in range(B)]
        skey, pxy, pz = (torch.tensor(np.stack(c)) for c in zip(*cases))
        got = runreduce.sorted_run_reduce(skey, (pxy, pz), 5000, 1024, quantum=0.04 / 65536)
        want = [runreduce.sorted_run_reduce(skey[b], (pxy[b], pz[b]), 5000, 1024,
                                            quantum=0.04 / 65536) for b in range(B)]
        outs = [(got[0][b], got[1][b]) for b in range(B)]
    elif kernel == "compact_gather":
        occ = torch.tensor(rng.random((B, 32, 128)) < np.array([0.05, 0.2, 0.6])[:, None, None])
        bins = torch.tensor(rng.standard_normal((B, 4, 4096)).astype(np.float32))
        got = compaction.compact_and_gather_exact(bins, occ, 512)
        want = [compaction.compact_and_gather_exact(bins[b], occ[b], 512) for b in range(B)]
        outs = [tuple(x[b] for x in got) for b in range(B)]
    elif kernel == "knn_mean":
        n, rt, band = 2048, 256, 256
        p = torch.tensor(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32))
        p = torch.sort(p, dim=1).values  # x-sorted, as a lattice-ordered cloud
        valid = torch.tensor(np.arange(n) < np.array([1500, 1800, 2048])[:, None])
        pch = [p[..., c].contiguous() for c in range(3)]
        p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
        tiles = n // rt
        starts = outliers.band_starts(n, rt, band, tiles, "cpu")
        got = outliers.knn_mean(pch, p_sq, valid, starts, rt, rt + 2 * band, 15)
        want = [outliers.knn_mean([c[b] for c in pch], p_sq[b], valid[b], starts, rt,
                                  rt + 2 * band, 15) for b in range(B)]
        outs = [(got[b],) for b in range(B)]
        want = [(w,) for w in want]
    else:
        c = 512
        pts = torch.tensor(rng.uniform(0, 2.0, (B, c, 3)).astype(np.float32))
        valid = torch.tensor(np.arange(c) < np.array([300, 450, 512])[:, None])
        p, p_sq, labels = cluster._seed_labels(pts, valid, 0.08)
        pk = cluster.pack_points(p, p_sq)
        got = cluster.cluster_loop(pk, valid, labels, 0.08 ** 2, 64)
        want = [cluster.cluster_loop(pk[b], valid[b], labels[b], 0.08 ** 2, 64)
                for b in range(B)]
        for b in range(B):  # each scan's own seeding and its own sweep count
            pb, psb, lb = cluster._seed_labels(pts[b], valid[b], 0.08)
            assert torch.equal(pb, p[b]) and torch.equal(psb, p_sq[b]) and torch.equal(lb, labels[b])
        assert len(set(got.sweeps.tolist())) > 1, got.sweeps
        outs = [(got.labels[b], got.unconverged[b], got.sweeps[b]) for b in range(B)]
        want = [(w.labels, w.unconverged, torch.tensor(w.sweeps, dtype=torch.int32))
                for w in want]
    for o, w in zip(outs, want):
        for a, e in zip(o, w):
            assert torch.equal(a, e)


def test_facade_and_from_reference_take_a_batch():
    """``from_reference`` carries [B, N, 3] points, [B, N] masks and [B]
    poses across; ``ObstacleDetectionModel`` and ``batched_pipeline`` run
    the batch with the model's generator ([B, rounds, K, 3] draws), the
    same seed giving the same results; the banded sweep refuses a batch."""
    buf, valid = _inputs()
    quat = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (B, 1))
    trans = np.arange(B * 3, dtype=np.float32).reshape(B, 3) * 0.01
    st = port.from_reference(dataclasses.asdict(CFG), buf, valid, quat, trans, device="cpu")
    assert st.cloud.points.shape == (B, CFG.max_points, 3) and st.cloud.count().shape == (B,)
    assert st.pose.quat_xyzw.shape == (B, 4) and st.pose.translation.shape == (B, 3)
    a = ObstacleDetectionModel(st.config, device="cpu", seed=2)(st.cloud, st.pose)
    g = torch.Generator().manual_seed(2)
    b = batched_pipeline(st.config)(st.cloud, generator=g, sensor_pose=st.pose)
    assert a.grid.data.shape == (B, CFG.grid_height, CFG.grid_width)
    assert a.centroids.points.xyzr.shape == (B, CFG.max_clusters, 4)
    assert torch.equal(a.grid.data, b.grid.data)
    assert (a.stats.num_planes >= 1).all() and (a.stats.num_clusters >= 1).all()
    with pytest.raises(ValueError):
        batched_pipeline(st.config)(scan_of(st.cloud, 0))
    with pytest.raises(ValueError):
        cluster.euclidean_cluster(Cloud(points=st.cloud.points[:2, :2048],
                                        valid=st.cloud.valid[:2, :2048]),
                                  0.08, 3, 1000, 8, band_window=512)
