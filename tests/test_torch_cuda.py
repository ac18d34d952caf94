"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG
from pointcloud_obstacle_processing_tpu_torch.ops import cluster, compaction, outliers, runreduce
from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eq(a, b):
    assert torch.equal(a.cpu(), b.cpu())


# offsets of the probe's d2 from tol2, in float32 ulps
TOL2_PROBE_OFFSETS = (-8, -2, -1, 0, 1, 2, 8)


def _d2_unfused(q, c):
    """The sweeps' expanded d2 in float32, each product and sum rounded
    (numpy does not contract); ``c`` may be a stack of candidates."""
    q_sq = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
    c_sq = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]
    cross = (q[0] * c[..., 0] + q[1] * c[..., 1]) + q[2] * c[..., 2]
    return (q_sq + c_sq) - np.float32(2.0) * cross


def near_threshold_pairs(tol2: float, capacity: int = 256, bases: int = 6, seed: int = 0):
    """Point pairs whose expanded d2 lies exactly ``TOL2_PROBE_OFFSETS`` ulps
    from float32(tol2).

    Each pair is its own buffer: a point q near the origin in row 0 (small
    |p| keeps the d2 grid fine) and a point c about the tolerance away in
    row 1, found by stepping c's x and y by single ulps; every other row is
    invalid at 0.  Returns (points [P, capacity, 3], valid [capacity],
    labels [capacity] (each row its own), offsets [P])."""
    rng = np.random.default_rng(seed)
    t2 = np.float32(tol2)
    targets = {}
    for k in TOL2_PROBE_OFFSETS:
        v = t2
        for _ in range(abs(k)):
            v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf))
        targets[v.item()] = k
    steps = np.arange(-64, 65, dtype=np.int32)
    bufs, offsets = [], []
    for _ in range(bases):
        q = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        u = rng.normal(size=3)
        c0 = (q + np.sqrt(tol2) * u / np.linalg.norm(u)).astype(np.float32)
        cand = np.repeat(c0[None, None, :], len(steps), axis=0).repeat(len(steps), axis=1)
        cand[..., 0] = (c0[0:1].view(np.int32) + steps[:, None]).view(np.float32)
        cand[..., 1] = (c0[1:2].view(np.int32) + steps[None, :]).view(np.float32)
        d2 = _d2_unfused(q, cand)
        for v, k in targets.items():
            hit = np.argwhere(d2 == np.float32(v))
            if len(hit):
                buf = np.zeros((capacity, 3), np.float32)
                buf[0], buf[1] = q, cand[tuple(hit[0])]
                bufs.append(buf)
                offsets.append(k)
    valid = np.arange(capacity) < 2
    return np.stack(bufs), valid, np.arange(capacity, dtype=np.int32), np.array(offsets)


@pytest.mark.parametrize(
    "n,n_runs,n_valid,cap,packed,group",
    [
        (4096, 300, 3500, 512, True, None),
        (8192, 5000, 8192, 1024, False, None),  # more runs than slots
        (3072, 1, 3000, 16, False, None),  # one run over every window
        (8192, 700, 6000, 1024, True, 32),  # a 4096-row window
    ],
)
def test_runreduce_kernel_equals_plain(dev, n, n_runs, n_valid, cap, packed, group):
    rng = np.random.default_rng(n + n_runs)
    sentinel = n_runs + 3
    skey = np.full(n, sentinel, np.int32)
    skey[:n_valid] = np.sort(rng.integers(0, n_runs, n_valid))
    if packed:
        offs = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
                rng.integers(0, 65536, n).astype(np.int32))
    else:
        offs = tuple(rng.standard_normal((3, n)).astype(np.float32))
    k = torch.tensor(skey, device=dev)
    o = tuple(torch.tensor(x, device=dev) for x in offs)
    q = 0.04 / 65536.0 if packed else None
    before = _build.LAUNCHES["runreduce"]
    vk, nk = runreduce.sorted_run_reduce(k, o, sentinel, cap, group=group, quantum=q)
    assert _build.LAUNCHES["runreduce"] == before + 1
    vp, np_ = runreduce.sorted_run_reduce_plain(k, o, sentinel, cap, group=group, quantum=q)
    assert int(nk) == int(np_)
    m = min(int(nk), cap)
    _eq(vk[:m], vp[:m])


@pytest.mark.parametrize("k,density,cap", [(24576, 0.025, 1024), (4096, 0.6, 1024), (1024, 0.0, 128)])
def test_compaction_kernel_equals_plain(dev, k, density, cap):
    rng = np.random.default_rng(k)
    occ = torch.tensor(rng.random(k) < density, device=dev)
    bins = torch.tensor(rng.standard_normal((4, k)).astype(np.float32), device=dev)
    occ2d = occ.reshape(k // 128, 128)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, cap)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ2d, cap)
    assert int(nk) == int(np_)
    m = min(int(nk), cap)
    _eq(lk[:m], lp[:m])
    _eq(vk[:m], vp[:m])


@pytest.mark.parametrize("n,n_valid,rt,band", [(24576, 21500, 384, 512), (5000, 3000, 256, 128),
                                               (4096, 4096, 512, 1536)])
def test_knn_select_kernel_equals_plain(dev, n, n_valid, rt, band):
    rng = np.random.default_rng(n)
    pts = rng.uniform([0, 0, -0.1], [4.5, 3.78, 0.3], (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(n) < n_valid, device=dev)
    p = torch.tensor(pts, device=dev)
    pch = [torch.where(valid, p[:, c] - 2.0, 0.0).contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // rt)
    starts = outliers.band_starts(n, rt, band, tiles, dev)
    width = rt + 2 * band
    _eq(outliers.knn_select(pch, p_sq, valid, starts, rt, width),
        outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width))


@pytest.mark.parametrize("c,n_valid", [(1024, 600), (2048, 2000), (700, 500)])
def test_cluster_sweep_kernel_equals_plain(dev, c, n_valid):
    rng = np.random.default_rng(c)
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p = torch.where(valid[:, None], torch.tensor(
        rng.uniform(-1.5, 1.5, (c, 3)).astype(np.float32), device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    labels = torch.tensor(lab, device=dev)
    _eq(cluster.sweep_jump(p, valid, labels, 0.16), cluster.sweep_jump_plain(p, valid, labels, 0.16))


@pytest.mark.parametrize(
    "c,n_valid,window,gated",
    [
        (16384, 7000, 4096, False),  # the fullscale shape, every tile live
        (16384, 7000, 4096, True),  # the same with a random tile_live
        (1024, 1024, 128, True),  # no padding tile; the smallest window
        (640, 500, 512, False),
    ],
)
def test_cluster_sweep_banded_kernel_equals_plain(dev, c, n_valid, window, gated):
    rng = np.random.default_rng(c + window)
    pts = rng.uniform([-2.2, -1.9, -0.3], [2.2, 1.9, 0.3], (c, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p = torch.where(valid[:, None], torch.tensor(pts, device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    labels = torch.tensor(lab, device=dev)
    starts, _ = cluster.band_starts(p, valid, 128, window, 0.4)
    live = torch.tensor(rng.random(c // 128) < 0.5, device=dev) if gated else None
    before = _build.LAUNCHES["cluster_sweep_banded"]
    got = cluster.sweep_jump_banded(p, valid, labels, 0.16, 128, window, starts, live)
    assert _build.LAUNCHES["cluster_sweep_banded"] == before + 1
    _eq(got, cluster.sweep_jump_banded_plain(p, valid, labels, 0.16, 128, window, starts, live))


def test_sweep_kernels_on_near_threshold_pairs(dev):
    """K4 and K5 make the plain versions' adjacency decision on pairs whose
    d2 lies within 8 ulps of tol2."""
    tol2 = 0.4 ** 2
    pts, valid, labels, offsets = near_threshold_pairs(tol2)
    v = torch.tensor(valid, device=dev)
    lab = torch.tensor(labels, device=dev)
    starts = torch.zeros(pts.shape[1] // 128, dtype=torch.int32, device=dev)
    for k in range(pts.shape[0]):
        p = torch.tensor(pts[k], device=dev)
        full = cluster.sweep_jump(p, v, lab, tol2)
        _eq(full, cluster.sweep_jump_plain(p, v, lab, tol2))
        band = cluster.sweep_jump_banded(p, v, lab, tol2, 128, 128, starts)
        _eq(band, cluster.sweep_jump_banded_plain(p, v, lab, tol2, 128, 128, starts))
        assert int(band[1]) == (0 if offsets[k] <= 0 else 1)


def test_wrappers_refuse_bad_operands(dev):
    k = torch.zeros(1024, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        runreduce.sorted_run_reduce(k, (k, k, k), 5, 64)
    bins = torch.zeros(4, 1024, device=dev)
    occ = torch.zeros(8, 128, dtype=torch.bool)  # on the CPU
    with pytest.raises(ValueError):
        compaction.compact_and_gather_exact(bins, occ, 64)
    p = torch.zeros(512, 3, device=dev)
    v = torch.ones(512, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # labels of the wrong length
        cluster.sweep_jump(p, v, torch.zeros(256, dtype=torch.int32, device=dev), 0.16)
    ch = [torch.zeros(512, device=dev) for _ in range(3)]
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # validity mask of the wrong length
        outliers.knn_select(ch, ch[0], v[:256], starts, 128, 256)
    lab = torch.zeros(512, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # a window that is not a multiple of 128
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 192, starts)
    with pytest.raises(ValueError):  # a window as wide as the buffer
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 512, starts)
    with pytest.raises(TypeError):  # int64 starts
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 256, starts.long())


@pytest.mark.parametrize("band_window", [0, 512])
def test_slice_on_the_card_equals_cpu(dev, band_window):
    cfg = REFERENCE_YAML_CONFIG.replace(
        max_points=32768, max_voxels=8192, cluster_capacity=2048, max_clusters=16,
        downsample_leaf_size=0.06, voxel_payload_packing=True, cluster_band_window=band_window,
    )
    scene = make_scene(seed=11, spec=SceneSpec(n_ground=24000, n_rocks=3, points_per_rock=1500,
                                               n_noise=150))
    cloud = Cloud.pad_to(scene.points, cfg.max_points)
    u = np.random.default_rng(0).random((cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    _build.reset_launch_counts()
    a = process_scan(cloud.to(dev), cfg, draw=draw_from_uniform(torch.tensor(u, device=dev)))
    sweep = "cluster_sweep_banded" if band_window else "cluster_sweep"
    path = ("runreduce", "compact_gather", "knn_select", sweep)
    assert all(_build.LAUNCHES[k] > 0 for k in path), _build.LAUNCHES
    b = process_scan(cloud, cfg, draw=draw_from_uniform(torch.tensor(u)))
    _eq(a.grid.data, b.grid.data)
    for f in ("voxel_points", "inlier_points", "nonplane_points", "num_planes", "num_clusters",
              "voxel_overflow", "cluster_overflow", "cluster_band_overflow", "planes_truncated",
              "cluster_unconverged"):
        assert getattr(a.stats, f).item() == getattr(b.stats, f).item(), f
    np.testing.assert_allclose(a.centroids.points.xyzr.cpu().numpy(),
                               b.centroids.points.xyzr.numpy(), atol=1e-5)
