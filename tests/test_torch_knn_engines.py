"""The kNN engines of the PyTorch port that the sorting network (kernel K3)
does not serve, against the JAX package: the in-window exact k-min
(``kmin_mean``), the two-level exact selection (``k_smallest``), the tail
of ``_score_tile`` (``score_tile``) and ``knn_mean_distances``' whole
dispatch (full width, banded windows, an odd capacity), then
``process_scan`` with each ``knn_backend`` and with
``downsample_input_data`` off against the reference's ``process_scan``, and
the engines the port still refuses, refused by ``process_scan`` itself.

Bar: mean distances bitwise (the clouds are dyadic, so both packages
center them alike; the engines are exact selections); whole scans by the
crosscheck bar of scripts/crosscheck_tpu_cpu.py.  ``approx`` is
``lax.approx_min_k`` in the reference, which XLA lowers off the TPU to an
exact sort (``ApproxTopK``'s fallback): held bitwise to ``lax.top_k``
below, and bitwise the port's exact selection."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_outliers import _dyadic_cloud
from test_torch_pipeline import _crosscheck

import pointcloud_obstacle_processing_tpu as ref
import pointcloud_obstacle_processing_tpu.ops.outliers as ref_outliers
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.utils.scene import SceneSpec, make_scene

import pointcloud_obstacle_processing_tpu_torch as port
from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import outliers
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan

BIG = np.float32(3.0e38)


def _d2(seed, rows=192, cols=256):
    """Squared distances with many duplicates (50 distinct values, so a
    pass of the k-min takes 3 or more equal values at once), sentinel
    columns, fully sentinel rows and rows with fewer than k real values."""
    rng = np.random.default_rng(seed)
    vals = (rng.random(50) * 3).astype(np.float32)
    d2 = vals[rng.integers(0, 50, (rows, cols))]
    d2[rng.random(d2.shape) < 0.3] = BIG
    d2[:4] = BIG
    d2[4:8, 5:] = BIG
    return d2


@pytest.mark.parametrize("k", [1, 15, 20, 40])
def test_kmin_mean_is_bitwise_the_reference(k):
    d2 = _d2(k)
    want = np.asarray(jax.jit(lambda d: ref_outliers._kmin_mean(d, k, 3.0e38))(d2))
    np.testing.assert_array_equal(outliers.kmin_mean(torch.tensor(d2), k).numpy(), want)


def _ref_k_smallest(d2, k):
    """The reference's ``_k_smallest`` (a closure of its
    ``knn_mean_distances``), written out: two-level ``lax.top_k``."""
    t, n = d2.shape
    if n % 128 or n // 128 < 2 or k > 128:
        return -lax.top_k(-d2, k)[0]
    neg, _ = lax.top_k(-d2.reshape(t, n // 128, 128), k)
    return -lax.top_k(neg.reshape(t, (n // 128) * k), k)[0]


@pytest.mark.parametrize("k,cols", [(1, 256), (15, 256), (40, 1000), (130, 256)])
def test_k_smallest_is_the_reference_selection(k, cols):
    """Two-level where the width splits into 128-column chunks, flat for a
    width that does not (1000) and for k above a chunk (130); the values
    equal the reference's two-level ``lax.top_k`` and, for k <= 40, the
    CPU's ``lax.approx_min_k`` (the ``approx`` engine)."""
    d2 = _d2(k, cols=cols)
    got = outliers.k_smallest(torch.tensor(d2), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda d: _ref_k_smallest(d, k))(d2)))
    if k <= 40:
        approx = jax.jit(lambda d: lax.approx_min_k(d, k, recall_target=0.98)[0])(d2)
        np.testing.assert_array_equal(got, np.asarray(approx))


def _ref_tail(d2, k, backend):
    """The tail of the reference's ``_score_tile`` after the masked d2."""
    if backend == "banded":
        return ref_outliers._kmin_mean(d2, k, 3.0e38)
    if backend == "exact":
        dk2 = _ref_k_smallest(d2, k)
    else:
        dk2, _ = lax.approx_min_k(d2, k, recall_target=0.98)
    real = dk2 < 3.0e38 * 0.5
    dk = jnp.sqrt(jnp.maximum(dk2, 0.0))
    s = jnp.sum(jnp.where(real, dk, 0.0), axis=-1)
    cnt = jnp.sum(real.astype(jnp.float32), axis=-1)
    return s / jnp.maximum(cnt, 1.0)


@pytest.mark.parametrize("backend", ["banded", "exact", "approx", "banded_approx"])
@pytest.mark.parametrize("k", [15, 40])
def test_score_tile_is_bitwise_the_reference(backend, k):
    """k = 40 sums more than 32 values: XLA:CPU's windowed order."""
    d2 = _d2(100 + k)
    want = np.asarray(jax.jit(lambda d: _ref_tail(d, k, backend))(d2))
    np.testing.assert_array_equal(outliers.score_tile(torch.tensor(d2), k, backend).numpy(), want)


# (backend, n_valid, capacity, row_tile, band, k): the branch each takes
KNN_CASES = {
    "exact_full": ("exact", 700, 1024, 128, 64, 15),
    "approx_full": ("approx", 700, 1024, 128, 64, 15),
    "banded_covers_buffer": ("banded", 700, 1024, 128, 512, 15),  # full-width kmin_mean
    "banded_k20_window": ("banded", 700, 1024, 128, 64, 20),  # in-window kmin_mean
    "banded_width_not_16": ("banded", 700, 1024, 128, 60, 15),  # width 248
    "banded_approx_window": ("banded_approx", 700, 1024, 128, 64, 15),
    "banded_approx_full": ("banded_approx", 700, 1024, 128, 512, 15),
    "exact_odd_capacity": ("exact", 900, 1000, 128, 64, 15),  # queries padded to 1,024
    "approx_odd_capacity_k40": ("approx", 900, 1000, 128, 64, 40),
    "banded_odd_capacity_k40": ("banded", 500, 1000, 128, 64, 40),
}


@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_mean_distances_is_bitwise_the_reference(monkeypatch, case):
    backend, n_valid, n, row_tile, band, k = KNN_CASES[case]
    pts, valid = _dyadic_cloud(n_valid, n_valid, n)
    want = np.asarray(jax.jit(lambda p, v: ref_outliers.knn_mean_distances(
        RefCloud(points=p, valid=v), k, row_tile, backend, band))(pts, valid))
    k3 = []
    monkeypatch.setattr(outliers, "knn_mean", lambda *a, **kw: k3.append(1))
    got = outliers.knn_mean_distances(Cloud.from_points(pts, valid), k, row_tile, band,
                                      backend=backend).numpy()
    np.testing.assert_array_equal(got, want)
    assert not k3  # none of these takes the sorting network
    # a batch of two scans: each scan as its single call
    pts2, valid2 = _dyadic_cloud(n_valid + 1, n_valid // 2, n)
    both = outliers.knn_mean_distances(
        Cloud(points=torch.tensor(np.stack([pts, pts2])), valid=torch.tensor(
            np.stack([valid, valid2]))), k, row_tile, band, backend=backend).numpy()
    np.testing.assert_array_equal(both[0], want)
    one = outliers.knn_mean_distances(Cloud.from_points(pts2, valid2), k, row_tile, band,
                                      backend=backend).numpy()
    np.testing.assert_array_equal(both[1], one)


def test_sorting_network_keeps_its_route(monkeypatch):
    """``banded`` with k <= 16 and a width divisible by 16 stays on K3."""
    pts, valid = _dyadic_cloud(5, 700, 1024)
    k3 = []
    knn_mean = outliers.knn_mean
    monkeypatch.setattr(outliers, "knn_mean", lambda *a, **kw: k3.append(1) or knn_mean(*a, **kw))
    outliers.knn_mean_distances(Cloud.from_points(pts, valid), 15, 128, 64)
    assert k3 == [1]


# the small config of tests/test_torch_pipeline.py's facade test: kNN tile
# and band 256 (a 768-column window over 2,048 voxel slots)
SMALL = ref.REFERENCE_YAML_CONFIG.replace(
    max_points=8192, max_voxels=2048, cluster_capacity=512, max_clusters=8,
    downsample_leaf_size=0.06, knn_band=256, knn_row_tile=256,
)
SCAN_CASES = {
    "exact": dict(knn_backend="exact"),
    "approx": dict(knn_backend="approx"),
    "banded_approx": dict(knn_backend="banded_approx"),
    "banded_k20": dict(statistical_outlier_mean_k=20),
    # the cropped scan overflows the 2,048 slots, as in the reference
    "no_downsampling": dict(downsample_input_data=False),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_process_scan_engines_meet_crosscheck_bar(monkeypatch, case):
    """``process_scan`` takes the engine the config names (before the
    repair ``knn_backend`` was never read: every case ran the banded
    engine), each held to the reference's ``process_scan``; with
    downsampling off the kNN is the full-width ``approx``."""
    scene = make_scene(seed=3, spec=SceneSpec(n_ground=6000, n_rocks=2, points_per_rock=600,
                                              n_noise=40))
    engines = []
    windows = outliers.knn_mean_windows
    monkeypatch.setattr(outliers, "knn_mean_windows", lambda *a: engines.append((a[7], a[5]))
                        or windows(*a))
    monkeypatch.setattr(outliers, "knn_mean", lambda *a, **kw: pytest.fail("K3 was taken"))
    _, p = _crosscheck(SMALL.replace(**SCAN_CASES[case]), scene.points, 1)
    backend = SCAN_CASES[case].get("knn_backend", "banded")
    width = SMALL.knn_row_tile + 2 * SMALL.knn_band
    if case == "no_downsampling":
        assert bool(p.stats.voxel_overflow)
        assert engines == [("approx", SMALL.max_voxels)]
    elif backend in ("exact", "approx"):
        assert engines == [(backend, SMALL.max_voxels)]
    else:
        assert engines == [(backend, width)]
    assert int(p.stats.num_clusters) >= 1


@pytest.mark.parametrize("override", [dict(voxel_binning="mxu"), dict(voxel_binning="scatter"),
                                      dict(voxel_order="morton")])
def test_process_scan_refuses_unported_engines(override):
    """The engines still to be ported raise from ``process_scan`` itself,
    before any work, not only from ``validate``."""
    cfg = port.PipelineConfig(**{**dataclasses.asdict(SMALL), **override})
    cloud = Cloud.from_points(np.zeros((cfg.max_points, 3), np.float32),
                              np.zeros(cfg.max_points, bool))
    with pytest.raises(ValueError, match="not ported"):
        process_scan(cloud, cfg, generator=torch.Generator().manual_seed(0))
