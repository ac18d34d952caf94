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
    got = cluster.sweep_jump(cluster.point_channels(torch.tensor(p)), torch.tensor(valid),
                             torch.tensor(labels), tol2)
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


@pytest.mark.parametrize("form", ["sum", "written_out"])
def test_squared_norms_equal_reference_bitwise(form):
    """|p|^2 of 1,048,576 seeded points, half of them with coordinates of
    widely different magnitudes, is bitwise the reference's on XLA:CPU: the
    reduction ``jnp.sum(p * p, axis=-1)`` (the sweeps, the chain seeding)
    against ``ops.sum_sq3``, and the written-out ``x*x + y*y + z*z`` (the
    kNN centering, the centroid radius) against ``ops.add_sq3``.  The port
    evaluates each fused multiply-add in float64 and rounds once, which can
    differ from a true fused multiply-add only in rare double-rounding ties;
    this pins that none occurs here."""
    from pointcloud_obstacle_processing_tpu_torch.ops import add_sq3, sum_sq3

    rng = np.random.default_rng(2024)
    n = 1 << 20
    p = rng.uniform(-30.0, 30.0, (n, 3))
    p[n // 2:] *= 2.0 ** rng.integers(-12, 13, (n // 2, 3))
    p = p.astype(np.float32)
    if form == "sum":
        want = jax.jit(lambda a: jnp.sum(a * a, axis=-1))(p)
        got = sum_sq3(*torch.tensor(p).T)
    else:
        want = jax.jit(lambda a: a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2])(p)
        got = add_sq3(*torch.tensor(p).T)
    np.testing.assert_array_equal(np.asarray(want).view(np.int32), got.numpy().view(np.int32))


@pytest.mark.parametrize(
    "seed,capacity,shuffle,max_iters,unconverged",
    [
        (0, 512, True, 64, False),
        (1, 1024, False, 64, False),  # the flagship cluster capacity, lattice order
        (3, 1024, True, 2, True),  # the iteration cap binds
        (3, 1024, True, 1, True),
        (5, 1000, True, 64, False),  # not a multiple of the loop kernel's block rows
    ],
)
def test_cluster_loop_plain_matches_reference(seed, capacity, shuffle, max_iters, unconverged):
    """The loop kernel's plain version from the port's seeding, against the
    reference's ``euclidean_cluster``: labels and ``unconverged`` exact; it
    stops after the first sweep that changes nothing, and reads the change
    test once a sweep but the last."""
    pts, valid = _dyadic_blobs(seed, CENTERS, 90, 0.08, 60, capacity, shuffle)
    r = jax.jit(lambda c: ref_cluster.euclidean_cluster(c, 0.4, 5, 20000, 16, max_iters))(
        RefCloud.from_points(pts, valid))
    v = torch.tensor(valid)
    p, p_sq, labels = cluster._seed_labels(torch.tensor(pts), v, 0.4)
    out = cluster.cluster_loop_plain(cluster.pack_points(p, p_sq), v, labels, 0.4 ** 2, max_iters)
    np.testing.assert_array_equal(np.asarray(r.labels), out.labels.numpy())
    assert bool(out.unconverged) == bool(r.unconverged) == unconverged
    assert 1 <= out.sweeps <= max_iters
    assert out.sweeps == max_iters or not unconverged
    assert out.host_syncs == min(out.sweeps, max_iters - 1)


def test_cluster_loop_takes_plain_version_on_cpu():
    """CPU tensors take the plain loop: no kernel build, no launch count."""
    from pointcloud_obstacle_processing_tpu_torch import _build

    pts, valid = _dyadic_blobs(2, CENTERS, 40, 0.08, 20, 256, True)
    v = torch.tensor(valid)
    p, p_sq, labels = cluster._seed_labels(torch.tensor(pts), v, 0.4)
    before = dict(_build.LAUNCHES)
    out = cluster.cluster_loop(cluster.pack_points(p, p_sq), v, labels, 0.16, 64)
    assert _build.LAUNCHES == before
    ref = cluster.cluster_loop_plain(cluster.pack_points(p, p_sq), v, labels, 0.16, 64)
    assert torch.equal(out.labels, ref.labels) and out.sweeps == ref.sweeps


def test_full_sweep_above_the_loop_kernel_capacity_matches_reference():
    """The band-off full sweep at a capacity just above
    ``LOOP_MAX_CAPACITY`` (the grid-wide loop kernel's range on the card,
    the plain loop here) with few valid points, against the reference's
    ``euclidean_cluster``; and a batch of two such clouds (which the
    per-sweep path refused) equal to their single-cloud runs."""
    c = cluster.LOOP_MAX_CAPACITY + 128
    args = (0.4, 5, 20000, 16, 64)
    clouds = [_dyadic_blobs(seed, CENTERS, 110, 0.08, 90, c, shuffle=False)
              for seed in (6, 7)]
    pts, valid = clouds[0]
    r = jax.jit(lambda cl: ref_cluster.euclidean_cluster(cl, *args))(
        RefCloud.from_points(pts, valid))
    p = cluster.euclidean_cluster(Cloud.from_points(pts, valid), *args)
    np.testing.assert_array_equal(np.asarray(r.labels), p.labels.numpy())
    np.testing.assert_array_equal(np.asarray(r.root_slot), p.root_slot.numpy())
    for f in ("point_cluster", "sizes", "valid", "num_clusters"):
        np.testing.assert_array_equal(np.asarray(getattr(r.clusters, f)),
                                      getattr(p.clusters, f).numpy())
    for f in ("overflow", "unconverged"):
        assert bool(getattr(r, f)) == bool(getattr(p, f)), f
    assert int(p.clusters.num_clusters) >= 4

    both = cluster.euclidean_cluster(
        Cloud.from_points(np.stack([x for x, _ in clouds]), np.stack([v for _, v in clouds])),
        *args)
    for b, (x, v) in enumerate(clouds):
        one = p if b == 0 else cluster.euclidean_cluster(Cloud.from_points(x, v), *args)
        for f in ("labels", "root_slot", "unconverged", "overflow"):
            assert torch.equal(getattr(both, f)[b], getattr(one, f)), (b, f)
        for f in ("point_cluster", "sizes", "valid", "num_clusters"):
            assert torch.equal(getattr(both.clusters, f)[b], getattr(one.clusters, f)), (b, f)
