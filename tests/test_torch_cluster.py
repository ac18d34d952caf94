"""Kernel K4 (cluster sweep) and euclidean clustering of the PyTorch port
against the JAX package.

Bar: labels, sizes, slots and flags exact given identical centered inputs.
The scenes use coordinates on a 2^-10 grid, so the centering sums are exact
in any order and both packages center identically; centroids within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import cluster as ref_cluster

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import cluster


def _dyadic_blobs(seed, centers, n_per, sigma, n_noise, capacity, shuffle=True):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(c, sigma, size=(n_per, 3)) for c in centers]
    parts.append(rng.uniform(-1.0, 4.0, size=(n_noise, 3)))
    pts = np.concatenate(parts)
    if shuffle:
        pts = pts[rng.permutation(len(pts))]
    else:  # lattice-like order: runs seed the labels
        pts = pts[np.argsort(pts[:, 0], kind="stable")]
    pts = (np.round(pts * 1024) / 1024).astype(np.float32)
    buf = np.zeros((capacity, 3), np.float32)
    buf[: len(pts)] = pts
    return buf, np.arange(capacity) < len(pts)


CENTERS = [(0, 0, 0), (3, 0, 0), (0, 3, 0), (3, 3, 1)]


@pytest.mark.parametrize(
    "seed,n_per,n_noise,capacity,shuffle,max_clusters,max_iters",
    [
        (0, 100, 40, 512, True, 16, 64),
        (1, 150, 200, 1024, False, 16, 64),  # the flagship cluster capacity
        (2, 60, 30, 2048, True, 3, 64),  # more clusters than slots
        (3, 120, 100, 1024, True, 16, 2),  # iteration cap binds: unconverged
    ],
)
def test_clusters_match_reference(seed, n_per, n_noise, capacity, shuffle, max_clusters,
                                  max_iters):
    pts, valid = _dyadic_blobs(seed, CENTERS, n_per, 0.08, n_noise, capacity, shuffle)
    r = jax.jit(lambda c: ref_cluster.euclidean_cluster(
        c, 0.4, 5, 20000, max_clusters, max_iters))(RefCloud.from_points(pts, valid))
    p = cluster.euclidean_cluster(Cloud.from_points(pts, valid), 0.4, 5, 20000, max_clusters,
                                  max_iters)
    np.testing.assert_array_equal(np.asarray(r.labels), p.labels.numpy())
    np.testing.assert_array_equal(np.asarray(r.root_slot), p.root_slot.numpy())
    for f in ("point_cluster", "sizes", "valid", "num_clusters"):
        np.testing.assert_array_equal(np.asarray(getattr(r.clusters, f)),
                                      getattr(p.clusters, f).numpy())
    for f in ("overflow", "band_overflow", "unconverged"):
        assert bool(getattr(r, f)) == bool(getattr(p, f)), f
    assert p.host_syncs <= max_iters - 1

    cr = jax.jit(ref_cluster.cluster_centroids)(RefCloud.from_points(pts, valid), r.clusters)
    cp = cluster.cluster_centroids(Cloud.from_points(pts, valid), p.clusters)
    np.testing.assert_array_equal(np.asarray(cr.valid), cp.valid.numpy())
    np.testing.assert_allclose(cp.points.xyzr.numpy(), np.asarray(cr.points.xyzr), atol=1e-5)


@pytest.mark.parametrize("capacity", [256, 1000])
def test_sweep_plain_matches_reference_xla_sweep(capacity):
    """One sweep on identical centered inputs: the XLA twin's contract."""
    rng = np.random.default_rng(capacity)
    p = rng.uniform(-1.5, 1.5, (capacity, 3)).astype(np.float32)
    valid = rng.random(capacity) < 0.7
    labels = np.minimum(np.arange(capacity), rng.integers(0, capacity, capacity)).astype(np.int32)
    labels[~valid] = np.arange(capacity)[~valid]
    p[~valid] = 0.0
    tol2 = 0.4 ** 2
    want = jax.jit(lambda a, b, c: ref_cluster._xla_sweep_jump(a, b, c, tol2, 128))(
        jnp.asarray(p), jnp.asarray(valid), jnp.asarray(labels))
    got = cluster.sweep_jump(torch.tensor(p), torch.tensor(valid), torch.tensor(labels), tol2)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_slot_ties_keep_root_order():
    """Equal-size clusters take slots by ascending root (PCL's stable order;
    ``torch.topk`` alone would not keep it)."""
    centers = [(0, 0, 0), (2, 0, 0), (4, 0, 0), (6, 0, 0)]
    pts, valid = _dyadic_blobs(4, centers, 20, 0.02, 0, 128, shuffle=True)
    out = cluster.euclidean_cluster(Cloud.from_points(pts, valid), 0.4, 5, 20000, 8)
    sizes = out.clusters.sizes.numpy()[:4]
    assert (sizes == 20).all()
    roots = [int(out.labels[out.clusters.point_cluster == s][0]) for s in range(4)]
    assert roots == sorted(roots)
