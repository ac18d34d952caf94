"""Kernel K3 (banded k-select) and statistical outlier removal of the
PyTorch port against the JAX package.

Bar: mean distances within 5e-5 relative, keep masks identical, on
random clouds.  The port evaluates the distance as XLA:CPU evaluates the
reference's (|p|^2 and the cross term as its fused multiply-add chains, the
mean in its order with correctly rounded roots), so on a cloud whose
centering sums are exact in any order the mean distances are bitwise the
reference's (``test_knn_probe_is_bitwise_the_reference``).  On random
clouds the centering sums reduce in another order in torch, and the
expanded d2 turns one ulp of the center into up to about |p|^2 * 2^-23 of
absolute error: 4.13e-5 relative at most over the cases below, hence the
bar (it was 1e-4 while the cross term was unfused).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_torch_cuda import fma32

import pointcloud_obstacle_processing_tpu.ops.outliers as ref_outliers
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import outliers

RTOL = 5e-5


def _lattice_cloud(seed, n_valid, n):
    """Points in voxel-lattice-like order (sorted by x), front-compacted."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0, -0.1], [2.0, 1.5, 0.3], (n_valid, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    buf = np.zeros((n, 3), np.float32)
    buf[:n_valid] = pts
    return buf, np.arange(n) < n_valid


def _ref(pts, valid, k, mult, row_tile, band):
    return jax.jit(lambda c: ref_outliers.remove_statistical_outliers(
        c, k, mult, row_tile=row_tile, backend="banded", band=band))(
        RefCloud.from_points(pts, valid))


@pytest.mark.parametrize(
    "n_valid,n,row_tile,band,k,mult",
    [
        (3000, 4096, 512, 512, 15, 1.0),
        (6000, 8192, 384, 512, 15, 4.0),  # the flagship tile and band; padded query tail
        (2500, 4096, 256, 256, 8, 1.0),  # k < 16
        (1000, 2048, 384, 256, 15, 1.0),
    ],
)
def test_outliers_match_reference_xla(n_valid, n, row_tile, band, k, mult):
    pts, valid = _lattice_cloud(n_valid, n_valid, n)
    r = _ref(pts, valid, k, mult, row_tile, band)
    p = outliers.remove_statistical_outliers(Cloud.from_points(pts, valid), k, mult,
                                             row_tile=row_tile, band=band)
    np.testing.assert_allclose(p.mean_distances.numpy(), np.asarray(r.mean_distances),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(p.cloud.valid.numpy(), np.asarray(r.cloud.valid))
    np.testing.assert_allclose(float(p.threshold), float(r.threshold), rtol=RTOL)


def test_outliers_match_reference_pallas_interpret(monkeypatch):
    pts, valid = _lattice_cloud(5, 700, 1024)
    monkeypatch.setattr(ref_outliers, "_FORCE_PALLAS_INTERPRET", True)
    r = _ref(pts, valid, 15, 1.0, 128, 192)
    p = outliers.remove_statistical_outliers(Cloud.from_points(pts, valid), 15, 1.0,
                                             row_tile=128, band=192)
    np.testing.assert_allclose(p.mean_distances.numpy(), np.asarray(r.mean_distances),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(p.cloud.valid.numpy(), np.asarray(r.cloud.valid))


def _dyadic_cloud(seed, n_valid, n):
    """Points on the 2^-12 grid with |x|, |y| <= 2 and |z| <= 0.2, sorted by
    x: every partial sum of fewer than 2,048 of them is a multiple of 2^-12
    below 2^12, exact in float32, so both packages center alike.  The
    products of the cross term are not exact (up to 26 significant bits),
    so their rounding shows."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-2**13, 2**13 + 1, (n_valid, 3)).astype(np.float32) / np.float32(2**12)
    pts[:, 2] = np.round(pts[:, 2] * np.float32(0.1) * 2**12) / np.float32(2**12)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    buf = np.zeros((n, 3), np.float32)
    buf[:n_valid] = pts
    return buf, np.arange(n) < n_valid


@pytest.mark.parametrize("n_valid,n,row_tile,band,k", [(1500, 2048, 256, 256, 15),
                                                       (1000, 2048, 128, 192, 8)])
def test_knn_probe_is_bitwise_the_reference(monkeypatch, n_valid, n, row_tile, band, k):
    """On a cloud whose centering is exact, the port's mean distances equal
    the reference's bit for bit; with the cross term's products rounded
    one by one, hundreds of them would differ."""
    pts, valid = _dyadic_cloud(n_valid, n_valid, n)
    want = np.asarray(_ref(pts, valid, k, 1.0, row_tile, band).mean_distances)
    cloud = Cloud.from_points(pts, valid)
    got = outliers.knn_mean_distances(cloud, k, row_tile, band).numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(outliers, "dot3",
                        lambda ax, ay, az, bx, by, bz: (ax * bx + ay * by) + az * bz)
    unfused = outliers.knn_mean_distances(cloud, k, row_tile, band).numpy()
    assert (unfused != want).sum() > 100


def test_knn_select_plain_is_the_exact_sorted_16():
    """The plain version against a NumPy brute force over each tile's window
    (same float32 expression, the cross term as the reference's fused
    chain), including the dead-tile sentinel."""
    pts, valid = _lattice_cloud(9, 700, 1024)
    n, rt, band = 1024, 128, 64
    width = rt + 2 * band
    tiles = n // rt
    v = torch.tensor(valid)
    p = torch.tensor(pts)
    pch = [torch.where(v, p[:, c], 0.0) for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    starts = outliers.band_starts(n, rt, band, tiles, "cpu")
    got = outliers.knn_select(pch, p_sq, v, starts, rt, width).numpy()
    x, y, z, sq = (t.numpy() for t in (*pch, p_sq))
    big = np.float32(outliers.BIG)
    for q in (0, 5, 300, 699, 700, 1023):
        t = q // rt
        if not valid[t * rt:(t + 1) * rt].any():
            assert (got[:, q] == big).all()
            continue
        cols = np.arange(int(starts[t]), int(starts[t]) + width)
        cross = fma32(z[q], z[cols], fma32(x[q], x[cols], y[q] * y[cols]))
        d2 = np.maximum((sq[q] + sq[cols]) - np.float32(2.0) * cross, np.float32(0))
        d2 = np.where(valid[cols] & (cols != q), d2, big).astype(np.float32)
        np.testing.assert_array_equal(got[:, q], np.sort(d2)[:16])


def test_knn_refuses_unported_widths():
    pts, valid = _lattice_cloud(1, 100, 256)
    with pytest.raises(ValueError):  # the band covers the buffer: full-width engine
        outliers.knn_mean_distances(Cloud.from_points(pts, valid), 15, row_tile=128, band=128)
    with pytest.raises(ValueError):  # k > 16
        outliers.knn_mean_distances(Cloud.from_points(pts, valid), 20, row_tile=32, band=32)
