"""The banded cluster sweep on a batch of scans (kernel K5 with the scan as
a grid dimension, the reference's ``jax.vmap`` of ``process_scan``): the
batched plain version of K5 and the batched ``band_starts`` against their
per-scan calls, ``euclidean_cluster`` on a batch with the band on against
its single-scan runs (one host read a sweep for the whole batch), and the
port's ``batched_pipeline`` on the reference's ``SHARD_CFG`` (band on)
against the reference's ``batched_pipeline``.

Bar: labels, starts and sweep outputs bitwise; whole scans by the
crosscheck bar of scripts/crosscheck_tpu_cpu.py, with every point's
cluster bitwise, as ``tests/test_torch_batch.py`` holds its batch."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sharding import SHARD_CFG, _batch
from test_torch_batch import _batched_draw
from test_torch_ransac import jax_key_chain_draw
from test_torch_sharding_pipeline import _assert_crosscheck

import pointcloud_obstacle_processing_tpu.ops.cluster as ref_cluster
from pointcloud_obstacle_processing_tpu.parallel.sharding import batched_pipeline as ref_batched

from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.ops import cluster
from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
from pointcloud_obstacle_processing_tpu_torch.types import Cloud, scan_of

B = 3
TOL = 0.4
WINDOW = 384  # the cluster band: 3 of the 8 tiles of a 1,024-point buffer


def _buffers(seed, c=1024):
    """B lattice-ordered (x-sorted) cluster buffers of differing fill and
    extent (60, 40 and 20 m in x: the sparsest converges a sweep sooner),
    with chain-seeded labels: ``_seed_labels``' centered points and
    labels."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, c, 3), np.float32)
    valid = np.zeros((B, c), bool)
    for b, (n_valid, extent) in enumerate(((900, 60.0), (900, 40.0), (700, 20.0))):
        p = rng.uniform([0, 0, 0], [extent, 3.0, 0.5], (n_valid, 3)).astype(np.float32)
        pts[b, :n_valid] = p[np.argsort(p[:, 0], kind="stable")]
        valid[b, :n_valid] = True
    p, p_sq, labels = cluster._seed_labels(torch.tensor(pts), torch.tensor(valid), TOL)
    return pts, valid, p, p_sq, labels


def test_band_starts_of_a_batch_are_each_scans():
    pts, valid, p, _, _ = _buffers(0)
    starts, over = cluster.band_starts(p, torch.tensor(valid), 128, WINDOW, TOL)
    assert starts.shape == (B, 1024 // 128) and over.shape == (B,)
    for b in range(B):
        s1, o1 = cluster.band_starts(p[b], torch.tensor(valid[b]), 128, WINDOW, TOL)
        ws, wo = ref_cluster._band_starts(jnp.asarray(p[b].numpy()), jnp.asarray(valid[b]), 128,
                                          WINDOW, TOL)
        assert torch.equal(starts[b], s1) and bool(over[b]) == bool(o1)
        np.testing.assert_array_equal(starts[b].numpy(), np.asarray(ws))
        assert bool(o1) == bool(wo)


@pytest.mark.parametrize("tile_range", [None, (2, 4)])
def test_batched_k5_plain_is_each_scans_sweep(tile_range):
    """The batched plain version of K5 (the wrapper on CPU tensors) equals
    its per-scan calls, with every tile live and with a mixed ``tile_live``
    (one scan with no live tile: its labels written through)."""
    _, valid, p, p_sq, labels = _buffers(1)
    valid = torch.tensor(valid)
    pk = cluster.pack_points(p, p_sq)
    starts, _ = cluster.band_starts(p, valid, 128, WINDOW, TOL)
    rng = np.random.default_rng(2)
    live = torch.tensor(rng.random((B, 8)) < 0.5)
    live[1] = False
    for tl in (None, live):
        got = cluster.sweep_jump_banded(pk, valid, labels, TOL ** 2, 128, WINDOW, starts, tl,
                                        tile_range)
        first, count = tile_range or (0, 8)
        assert got.shape == (B, count * 128)
        for b in range(B):
            want = cluster.sweep_jump_banded(pk[b], valid[b], labels[b], TOL ** 2, 128, WINDOW,
                                             starts[b], None if tl is None else tl[b],
                                             tile_range)
            assert torch.equal(got[b], want)
        if tl is not None:  # no live tile: the labels come through
            assert torch.equal(got[1], labels[1, first * 128:(first + count) * 128])


def test_banded_clustering_of_a_batch_is_each_scans(monkeypatch):
    """``euclidean_cluster`` on a [3, C] batch with the band on: each scan's
    labels, flags and clusters bitwise its single run; one K5 call a sweep
    for the whole batch, as many sweeps as its slowest scan, and one host
    read a sweep from the second (the reads are the sweeps less one).
    Every scan's band covers its edges."""
    pts, valid, *_ = _buffers(3)
    calls = []
    sweep = cluster.sweep_jump_banded
    monkeypatch.setattr(cluster, "sweep_jump_banded",
                        lambda *a: calls.append(a[2].shape) or sweep(*a))
    both = cluster.euclidean_cluster(Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)),
                                     TOL, 3, 20000, 16, band_window=WINDOW)
    batch_calls = list(calls)
    assert all(s == (B, 1024) for s in batch_calls)
    assert not both.band_overflow.any()
    singles = []
    for b in range(B):
        calls.clear()
        one = cluster.euclidean_cluster(Cloud.from_points(pts[b], valid[b]), TOL, 3, 20000, 16,
                                        band_window=WINDOW)
        singles.append(len(calls))
        assert one.host_syncs == len(calls) - 1
        for name in ("labels", "root_slot", "overflow", "band_overflow", "unconverged"):
            assert torch.equal(getattr(both, name)[b], getattr(one, name)), (b, name)
        for f in dataclasses.fields(one.clusters):
            assert torch.equal(getattr(both.clusters, f.name)[b], getattr(one.clusters, f.name))
    assert len(batch_calls) == max(singles) and len(set(singles)) > 1, singles
    assert both.host_syncs == len(batch_calls) - 1


def _port_cfg(cfg) -> PipelineConfig:
    return PipelineConfig(**dataclasses.asdict(cfg))


def test_batched_pipeline_banded_meets_crosscheck_bar():
    """The port's ``batched_pipeline`` on ``SHARD_CFG`` (kNN band 192, a
    256-column cluster band over 1,024 slots) on a batch of three scans
    against the reference's ``batched_pipeline``, with the reference's
    RANSAC key chains; and each scan's clustering bitwise its single-scan
    run."""
    clouds = _batch(B, seed0=30)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    want = ref_batched(SHARD_CFG)(clouds, keys)
    cfg = _port_cfg(SHARD_CFG)
    cloud = Cloud(points=torch.tensor(np.asarray(clouds.points)),
                  valid=torch.tensor(np.asarray(clouds.valid)))
    got = batched_pipeline(cfg)(cloud, draw=_batched_draw(keys, cfg.ransac_hypotheses))
    for b in range(B):
        _assert_crosscheck(want, b, scan_of(got, b))
        one = process_scan(scan_of(cloud, b), cfg,
                           draw=jax_key_chain_draw(keys[b], cfg.ransac_hypotheses))
        assert torch.equal(scan_of(got, b).clusters.point_cluster, one.clusters.point_cluster)
        assert torch.equal(scan_of(got, b).obstacle_cloud.valid, one.obstacle_cloud.valid)
    assert (got.stats.num_clusters >= 1).all()
    assert not got.stats.cluster_band_overflow.any()
