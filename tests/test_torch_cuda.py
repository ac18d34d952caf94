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
from pointcloud_obstacle_processing_tpu_torch.ops import (
    binning,
    cluster,
    compaction,
    outliers,
    runreduce,
    segscan,
)
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


def fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding, in numpy (the float64
    product is exact; the float64 sum rounds, then the float32 cast)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _sq(p):
    """|p|^2 as the reference's sweeps compute it: ``fma(z, z, fma(y, y, x * x))``."""
    return fma32(p[..., 2], p[..., 2], fma32(p[..., 1], p[..., 1], p[..., 0] * p[..., 0]))


def d2_port(q, c):
    """The sweeps' expanded d2 in float32 as the port evaluates it: |p|^2 and
    the cross term as the reference's fused chains, ``fma(z, z, fma(y, y,
    x * x))`` and ``fma(qz, cz, fma(qx, cx, qy * cy))``, the rest with each
    product and sum rounded; ``c`` may be a stack of candidates."""
    cross = fma32(q[2], c[..., 2], fma32(q[0], c[..., 0], q[1] * c[..., 1]))
    return (_sq(q) + _sq(c)) - np.float32(2.0) * cross


def d2_unfused_cross(q, c):
    """``d2_port`` with each product of the cross term rounded (numpy does
    not contract): ``(qx*cx + qy*cy) + qz*cz``."""
    cross = (q[0] * c[..., 0] + q[1] * c[..., 1]) + q[2] * c[..., 2]
    return (_sq(q) + _sq(c)) - np.float32(2.0) * cross


def cross_term_pairs(tol2: float, n_pairs: int = 128, seed: int = 11):
    """Point pairs near tol2 that the two cross-term forms decide apart.

    q is drawn in [-1.5, 1.5]^3 (away from the origin the cross term's
    rounding reaches the decision) and c about the tolerance away; c's x is
    stepped by single ulps and the first step whose fused decision (``d2 <=
    tol2`` by ``d2_port``) differs from the unfused one is kept.  Returns a
    list of (q [3], c [3], fused_adjacent)."""
    rng = np.random.default_rng(seed)
    t2 = np.float32(tol2)
    steps = np.arange(-40, 41, dtype=np.int32)
    pairs = []
    while len(pairs) < n_pairs:
        q = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
        u = rng.normal(size=3)
        c0 = (q + np.sqrt(tol2) * u / np.linalg.norm(u)).astype(np.float32)
        cand = np.repeat(c0[None], len(steps), 0)
        cand[:, 0] = (c0[0:1].view(np.int32) + steps).view(np.float32)
        fused = d2_port(q, cand) <= t2
        for i in np.flatnonzero((d2_unfused_cross(q, cand) <= t2) != fused)[:1]:
            pairs.append((q, cand[i], bool(fused[i])))
    return pairs


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
        d2 = d2_port(q, cand)
        for v, k in targets.items():
            hit = np.argwhere(d2 == np.float32(v))
            if len(hit):
                buf = np.zeros((capacity, 3), np.float32)
                buf[0], buf[1] = q, cand[tuple(hit[0])]
                bufs.append(buf)
                offsets.append(k)
    valid = np.arange(capacity) < 2
    return np.stack(bufs), valid, np.arange(capacity, dtype=np.int32), np.array(offsets)


def look_back_keys(kind: str, n: int, sentinel: int, rng) -> np.ndarray:
    """Key buffers that stress kernel K1's look-back over windows (shared
    with the card tests): runs longer than a window and several windows in
    a row without a head, one key over the whole buffer, no valid row, more
    runs than slots, and a last run that ends inside a window followed by
    sentinel windows."""
    skey = np.full(n, sentinel, np.int32)
    if kind == "long_runs":
        bounds = np.sort(rng.choice(np.arange(1, n - n // 8), 3, replace=False))
        bounds[0] = max(bounds[0], 1)
        skey[: n - n // 8] = np.searchsorted(bounds, np.arange(n - n // 8), side="right")
    elif kind == "one_key":
        skey[:] = 5
    elif kind == "many_runs":
        skey[:] = np.sort(rng.integers(0, sentinel, n))
    elif kind == "sentinel_tail":
        m = n // 3 + 77
        skey[:m] = np.sort(rng.integers(0, 40, m))
    elif kind != "all_sentinel":
        raise ValueError(kind)
    return skey


LOOK_BACK_CASES = ["long_runs", "one_key", "all_sentinel", "many_runs", "sentinel_tail"]


@pytest.mark.parametrize(
    "n,n_runs,n_valid,cap,packed,group",
    [
        (4096, 300, 3500, 512, True, None),
        (8192, 5000, 8192, 1024, False, None),  # more runs than slots
        (3072, 1, 3000, 16, False, None),  # one run over every window
        (8192, 700, 6000, 1024, True, 32),  # a 4096-row window
        (100_352, 21_500, 90_000, 24_576, True, None),  # the flagship shape
        (2_097_152, 166_000, 2_000_000, 262_144, True, None),  # the fullscale shape
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


@pytest.mark.parametrize("kind", LOOK_BACK_CASES)
@pytest.mark.parametrize("n,group", [(8192, None), (16384, 32), (4096, 2), (1024, 1)])
def test_runreduce_kernel_look_back_cases(dev, kind, n, group):
    """K1's look-back over windows on the card: runs longer than a window,
    windows without a head in a row, one key, no valid row, more runs than
    slots, a sentinel tail; 1,024-, 4,096- and 128-row windows.  Bitwise
    the plain version on the slots below num; num exact."""
    rng = np.random.default_rng(n + len(kind))
    sentinel, cap = 1 << 20, 64
    skey = torch.tensor(look_back_keys(kind, n, sentinel, rng), device=dev)
    offs = tuple(torch.tensor(rng.standard_normal(n).astype(np.float32), device=dev)
                 for _ in range(3))
    vk, nk = runreduce.sorted_run_reduce(skey, offs, sentinel, cap, group=group)
    vp, np_ = runreduce.sorted_run_reduce_plain(skey, offs, sentinel, cap, group=group)
    assert int(nk) == int(np_)
    m = min(int(nk), cap)
    _eq(vk[:m], vp[:m])


@pytest.mark.parametrize("k,occupied,cap", [
    (24576, 600, 563), (24576, 600, 600), (24576, 600, 1024),  # the flagship buffers
    (262144, 7000, 4096), (262144, 7000, 7000), (262144, 7000, 16384),  # the fullscale buffers
    (1152, 1, 8),  # a ragged last block of 128 columns
])
def test_compaction_kernel_capacities(dev, k, occupied, cap):
    """K2 with a capacity below, at and above the occupied count: ``num`` is
    the whole count, a 0-d int32 tensor left on the device; the slots below
    min(num, capacity) equal the plain version's."""
    rng = np.random.default_rng(k + occupied + cap)
    occ_np = np.zeros(k, bool)
    occ_np[rng.choice(k, occupied, replace=False)] = True
    occ2d = torch.tensor(occ_np, device=dev).reshape(k // 128, 128)
    bins = torch.tensor(rng.standard_normal((4, k)).astype(np.float32), device=dev)
    before = _build.LAUNCHES["compact_gather"]
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, cap)
    assert _build.LAUNCHES["compact_gather"] == before + 1
    assert nk.device == bins.device and nk.shape == () and nk.dtype == torch.int32
    assert int(nk) == occupied
    lp, _, vp = compaction.compact_and_gather_plain(bins, occ2d, cap)
    m = min(occupied, cap)
    _eq(lk[:m], lp[:m])
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


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_compaction_kernel_unaligned_mask(dev, offset):
    """K2 on a mask view that does not start 4-byte aligned (the kernel
    then reads its bytes one at a time) equals the plain version."""
    k, cap = 24576, 1024
    rng = np.random.default_rng(offset)
    buf = torch.tensor(rng.random(k + 4) < 0.05, device=dev)
    occ2d = buf[offset:offset + k].reshape(k // 128, 128)
    assert occ2d.data_ptr() % 4
    bins = torch.tensor(rng.standard_normal((4, k)).astype(np.float32), device=dev)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, cap)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ2d, cap)
    assert int(nk) == int(np_) == int(occ2d.sum())
    m = min(int(nk), cap)
    _eq(lk[:m], lp[:m])
    _eq(vk[:m], vp[:m])


@pytest.mark.parametrize("n,n_valid,rt,band,k,sparse", [
    (24576, 21500, 384, 512, 15, False),  # the flagship shape
    (262144, 166000, 1024, 1280, 15, False),  # the fullscale shape
    (5000, 3000, 256, 128, 15, False),  # a padded query tail
    (4096, 4096, 512, 1536, 15, False),
    (24576, 21500, 384, 512, 8, False),  # k < 16
    (24576, 21500, 384, 512, 1, False),
    (8192, 8192, 1024, 256, 15, True),  # tiles with fewer than k valid neighbours
])
def test_knn_select_kernel_equals_plain(dev, n, n_valid, rt, band, k, sparse):
    """K3's mean bitwise equal to the plain version's (the sorted 16, then
    ``mean_from_sorted``)."""
    rng = np.random.default_rng(n + k)
    pts = rng.uniform([0, 0, -0.1], [4.5, 3.78, 0.3], (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    live = np.arange(n) < n_valid
    if sparse:
        live &= rng.random(n) < 0.004
    valid = torch.tensor(live, device=dev)
    p = torch.tensor(pts, device=dev)
    pch = [torch.where(valid, p[:, c] - 2.0, 0.0).contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // rt)
    starts = outliers.band_starts(n, rt, band, tiles, dev)
    width = rt + 2 * band
    before = _build.LAUNCHES["knn_mean"]
    got = outliers.knn_mean(pch, p_sq, valid, starts, rt, width, k)
    assert _build.LAUNCHES["knn_mean"] == before + 1
    _eq(got, outliers.knn_mean_plain(pch, p_sq, valid, starts, rt, width, k))
    if sparse:  # some live query has fewer than k valid neighbours in its window
        vals = outliers.knn_select_plain(pch, p_sq, valid, starts, rt, width)
        assert ((vals[k - 1] == np.float32(outliers.BIG)) & valid).any()


@pytest.mark.parametrize("c,n_valid", [(1024, 600), (2048, 2000), (700, 500)])
def test_cluster_sweep_kernel_equals_plain(dev, c, n_valid):
    """K4 on ``point_channels``' [4, C] rows (the clustering's form, made
    once for all its sweeps)."""
    rng = np.random.default_rng(c)
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p = torch.where(valid[:, None], torch.tensor(
        rng.uniform(-1.5, 1.5, (c, 3)).astype(np.float32), device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    labels = torch.tensor(lab, device=dev)
    pch = cluster.point_channels(p)
    _eq(cluster.sweep_jump(pch, valid, labels, 0.16),
        cluster.sweep_jump_plain(pch, valid, labels, 0.16))


def _loop_case(dev, c, n_valid, seed):
    """A cluster buffer as the clustering starts its loop: eight blobs and
    some clutter in random order, centered and chain-seeded
    (``ops.cluster._seed_labels``), packed once."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-2.0, -1.8, -0.2], [2.0, 1.8, 0.2], (8, 3))
    pts = np.concatenate([rng.normal(centers[rng.integers(0, 8, n_valid - n_valid // 8)], 0.15),
                          rng.uniform([-2.2, -1.9, -0.3], [2.2, 1.9, 0.3], (n_valid // 8, 3))])
    buf = np.zeros((c, 3), np.float32)
    buf[:n_valid] = pts[rng.permutation(n_valid)]
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p, p_sq, labels = cluster._seed_labels(torch.tensor(buf, device=dev), valid, 0.4)
    return cluster.pack_points(p, p_sq), valid, labels


@pytest.mark.parametrize("c,n_valid,max_iters", [
    (1024, 600, 64),  # the flagship capacity
    (4096, 3500, 64),  # the default capacity
    (1000, 700, 64),  # rows not a multiple of the cluster's blocks
    (200, 150, 64),  # fewer rows than blocks x 32
    (1024, 600, 2),  # the iteration cap binds
    (cluster.LOOP_MAX_CAPACITY, cluster.LOOP_MAX_CAPACITY * 5 // 8, 64),  # the limit
    (cluster.LOOP_MAX_CAPACITY + 2048, (cluster.LOOP_MAX_CAPACITY + 2048) * 5 // 8, 64),  # above
    (10240, 6400, 64),
    (10240, 10240, 64),  # every row valid
    (16384, 10240, 64),  # the fullscale capacity
    (16384, 16384, 64),
    (16384, 10240, 2),  # the iteration cap binds
])
def test_cluster_loop_kernel_equals_plain(dev, c, n_valid, max_iters):
    """The cluster loop on the card against its plain version on the same
    inputs: labels, ``unconverged`` and the sweeps run, exact; each form
    (the loop kernel up to ``LOOP_MAX_CAPACITY``, the grid-wide loop
    kernel above it) makes one launch and no host read."""
    kernel = "cluster_loop" if c <= cluster.LOOP_MAX_CAPACITY else "cluster_grid_loop"
    pk, valid, labels = _loop_case(dev, c, n_valid, c + max_iters)
    _build.reset_launch_counts()
    got = cluster.cluster_loop(pk, valid, labels, 0.16, max_iters)
    launches = dict(_build.LAUNCHES)
    want = cluster.cluster_loop_plain(pk, valid, labels, 0.16, max_iters)
    _eq(got.labels, want.labels)
    assert bool(got.unconverged) == bool(want.unconverged)
    assert int(got.sweeps) == int(want.sweeps) >= 2
    assert launches[kernel] == 1 and got.host_syncs == 0
    assert sum(launches.values()) == 1
    assert bool(want.unconverged) == (max_iters == 2)


def test_grid_loop_takes_a_batch(dev):
    """The grid-wide loop kernel on a batch of two differing scans at 10,240
    points (one launch; the per-sweep path refused a batch), each scan equal
    to the plain loop; and the per-sweep path, kept as the crossover's
    yardstick, equal to it on the first scan."""
    cases = [_loop_case(dev, 10240, n_valid, seed) for n_valid, seed in ((6400, 1), (9000, 2))]
    pk, valid, labels = (torch.stack([c[i] for c in cases]) for i in range(3))
    _build.reset_launch_counts()
    got = cluster.cluster_loop(pk, valid, labels, 0.16, 64)
    assert _build.LAUNCHES["cluster_grid_loop"] == 1
    want = cluster.cluster_loop_plain(pk, valid, labels, 0.16, 64)
    _eq(got.labels, want.labels)
    _eq(got.sweeps, want.sweeps)
    _eq(got.unconverged, want.unconverged)
    per = cluster.per_sweep_loop(pk[0], valid[0], labels[0], 0.16, 64)
    _eq(per.labels, want.labels[0])
    assert int(per.sweeps) == int(want.sweeps[0])


@pytest.mark.parametrize("shape,prod", [
    ((2, 24_576), False),  # the outlier gate's s1 and s2 at the flagship shape
    ((2, 262_144), False),  # and at fullscale
    ((3, 4, 100), False),
    ((1, 7), False),  # a short row: the plain reduce alone
    ((32, 3, 24_576), True),  # RANSAC's covariance, a batch of 32
    ((2, 3, 20), True),  # a short product: fused into the plain reduce
    ((1, 3, 16_384), True),
    ((1, 3, 262_144), True),  # the covariance at fullscale
    ((2, 100_003), False),  # a long row of odd length: both levels padded
    ((24_576,), False),  # one row, [N] -> []
    ((100_003,), False),
    ((1, 4, 24_576), False),  # the refinement's masked sums
    ((9, 1024), False),  # more rows than a cluster's tile
    ((2, 5, 4096), True),  # more rows of a and b than a tile
    ((2, 2, 3, 1000), True),  # two leading dims: [L, S, N] rows by reshape
    *[((1, 3, n), True) for n in (1, 31, 32, 33, 1023, 1024, 1025, 32_768, 32_769, 2**20 + 7)],
    *[((2, n), False) for n in (1, 31, 32, 33, 1023, 1024, 1025, 32_768, 32_769, 2**20 + 7)],
])
def test_sum_kernel_equals_plain(dev, shape, prod):
    """The sum kernel (``ops.sum_like_xla``) against its plain version in
    bit patterns, one launch a call at every length, contiguous and strided
    (a transposed view, read in place), at every cluster size the plan
    takes."""
    from pointcloud_obstacle_processing_tpu_torch.ops import (
        _xla_sum_kernel,
        sum_like_xla,
        sum_like_xla_plain,
    )

    rng = np.random.default_rng(shape[-1])
    a = torch.tensor((rng.standard_normal(shape) * 10).astype(np.float32), device=dev)
    a[..., ::97] = -0.0
    b = torch.tensor(rng.standard_normal(shape).astype(np.float32), device=dev) if prod else None
    _build.reset_launch_counts()
    got = sum_like_xla(a, b)
    assert _build.LAUNCHES["xla_sum"] == 1
    assert got.shape == sum_like_xla_plain(a.cpu(), None if b is None else b.cpu()).shape
    want = sum_like_xla_plain(a, b)
    _eq(got.view(torch.int32), want.view(torch.int32))
    for blocks in (1, 2, 8, 16):
        _eq(_xla_sum_kernel(a, b, blocks).view(torch.int32), want.view(torch.int32))
    if a.dim() == 1:
        return
    at = a.transpose(-1, -2).contiguous().transpose(-1, -2)  # the same values, strided
    bt = None if b is None else b.transpose(-1, -2).contiguous().transpose(-1, -2)
    _eq(sum_like_xla(at, bt).view(torch.int32), got.view(torch.int32))


def test_sum_kernel_transposed_and_broadcast_operands(dev):
    """Operands read in place: the clustering's centre (a transposed [C, 3]
    buffer, value stride 3), a broadcast row (stride 0), an offset view
    that is not 16-byte aligned, and a batch of such rows."""
    from pointcloud_obstacle_processing_tpu_torch.ops import sum_like_xla, sum_like_xla_plain

    rng = np.random.default_rng(5)
    pts = torch.tensor(rng.standard_normal((4, 16_384, 3)).astype(np.float32), device=dev)
    row = torch.tensor(rng.standard_normal(24_576).astype(np.float32), device=dev)
    flat = torch.tensor(rng.standard_normal(3 * 24_576 + 4).astype(np.float32), device=dev)
    cases = [
        (pts[0].transpose(0, 1), None),  # [3, C], value stride 3
        (pts.transpose(1, 2), None),  # [4, 3, C]
        (pts[:1, :1024].transpose(1, 2), pts[:1, :1024].transpose(1, 2)),
        (row.expand(3, -1), None),  # three rows of one buffer (row stride 0)
        (flat[1:-3].reshape(3, 24_576), None),  # 4 bytes past alignment
        (flat[1:-3].reshape(1, 3, 24_576), flat[:-4].reshape(1, 3, 24_576)),
    ]
    for a, b in cases:
        _build.reset_launch_counts()
        got = sum_like_xla(a, b)
        assert _build.LAUNCHES["xla_sum"] == 1
        _eq(got.view(torch.int32), sum_like_xla_plain(a, b).view(torch.int32))


def test_sum_kernel_on_two_streams(dev):
    """Two streams summing different rows at once (the node launches on
    several): each result equals the plain version."""
    from pointcloud_obstacle_processing_tpu_torch.ops import sum_like_xla, sum_like_xla_plain

    rng = np.random.default_rng(9)
    ins = [tuple(torch.tensor(rng.standard_normal((1, 3, 262_144)).astype(np.float32),
                              device=dev) for _ in range(2)) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in ins]
    torch.cuda.synchronize()
    outs = [[] for _ in ins]
    for _ in range(20):
        for (a, b), st, out in zip(ins, streams, outs):
            with torch.cuda.stream(st):
                out.append(sum_like_xla(a, b))
    torch.cuda.synchronize()
    for (a, b), out in zip(ins, outs):
        want = sum_like_xla_plain(a, b).view(torch.int32)
        for got in out:
            _eq(got.view(torch.int32), want)


def _tail_inputs(dev, b, n, seed):
    """``covariance_tail``'s operands for ``b`` scans of plane-like clouds
    of 20 to ``n`` points (padded with zeros), each with its inlier mask and
    a plane near z; some scans have fewer than 3 inliers (the plane stays)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(20, n + 1, b)
    live = np.arange(n)[None, :] < m[:, None]
    pts = np.stack([rng.uniform(0, 4, (b, n)), rng.uniform(0, 3, (b, n)),
                    rng.normal(0, 0.02, (b, n))], 1)
    pts[:, 2] += rng.normal(0, 0.1, (b, 1)) * pts[:, 0]
    pts = np.where(live[:, None], pts, 0.0).astype(np.float32)
    inl = live & (rng.random((b, n)) < 0.8)
    inl[rng.random(b) < 0.05, 2:] = False
    pts1 = torch.tensor(np.concatenate([pts, live[:, None].astype(np.float32)], 1), device=dev)
    r_in = torch.tensor(inl, device=dev)
    s4 = torch.where(r_in[:, None], pts1, 0.0).sum(-1)
    n_inl = s4[:, 3]
    cen = s4[:, :3] / torch.clamp_min(n_inl, 3.0)[:, None]
    off = pts1[:, :3] - cen[..., None]
    normal = rng.normal(0, 0.1, (b, 3)) + [0, 0, 1]
    normal = torch.tensor((normal / np.linalg.norm(normal, axis=1, keepdims=True))
                          .astype(np.float32), device=dev)
    d = torch.tensor(rng.standard_normal(b).astype(np.float32), device=dev)
    return torch.where(r_in[:, None], off, 0.0), off, cen, n_inl, normal, d


@pytest.mark.parametrize("b,n", [(512, 2048), (1, 24_576), (32, 24_576), (1, 262_144), (3, 20)])
@pytest.mark.parametrize("vmapped", [False, True])
def test_covariance_tail_equals_plain(dev, b, n, vmapped):
    """The covariance launch with the 3x3 tail as its epilogue against
    ``sum_like_xla_plain`` then ``plane_tail_plain``, in bit patterns: 512
    plane-like clouds (some of fewer than 3 inliers; clusters of one
    block), the flagship and fullscale rows (16 blocks), the batch of 32 (4
    blocks) and a short row; one launch a call."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac, sum_like_xla_plain

    args = _tail_inputs(dev, b, n, b + n + int(vmapped))
    _build.reset_launch_counts()
    got = ransac.covariance_tail(*args, vmapped)
    assert _build.LAUNCHES["covariance_tail"] == 1 and _build.LAUNCHES["xla_sum"] == 0
    masked, off, *rest = args
    want = ransac.plane_tail_plain(sum_like_xla_plain(masked, off), *rest, vmapped)
    for g, w in zip(got, want):
        _eq(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize(
    "c,n_valid,window,gated",
    [
        (16384, 7000, 4096, False),  # the fullscale shape, every tile live
        (16384, 7000, 4096, True),  # the same with a random tile_live
        (16384, 16384, 4096, False),  # every row valid
        (1024, 1024, 128, True),  # no padding tile; the smallest window
        (640, 500, 512, False),
    ],
)
def test_cluster_sweep_banded_kernel_equals_plain(dev, c, n_valid, window, gated):
    """K5 over its thread-block cluster against the plain version, on
    ``pack_points``' [C, 4] rows (the clustering's form)."""
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
    pk = cluster.pack_points(p)
    before = _build.LAUNCHES["cluster_sweep_banded"]
    got = cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, window, starts, live)
    assert _build.LAUNCHES["cluster_sweep_banded"] == before + 1
    _eq(got, cluster.sweep_jump_banded_plain(pk, valid, labels, 0.16, 128, window, starts, live))


def test_sweep_kernels_on_near_threshold_pairs(dev):
    """K4 and K5 make the plain versions' adjacency decision on pairs whose
    d2 lies within 8 ulps of tol2, with |p|^2 and the cross term as the
    reference's fused chains (the decision the reference's XLA sweeps
    make)."""
    tol2 = 0.4 ** 2
    pts, valid, labels, offsets = near_threshold_pairs(tol2)
    v = torch.tensor(valid, device=dev)
    lab = torch.tensor(labels, device=dev)
    starts = torch.zeros(pts.shape[1] // 128, dtype=torch.int32, device=dev)
    for k in range(pts.shape[0]):
        p = torch.tensor(pts[k], device=dev)
        pch, pk = cluster.point_channels(p), cluster.pack_points(p)
        full = cluster.sweep_jump(pch, v, lab, tol2)
        _eq(full, cluster.sweep_jump_plain(pch, v, lab, tol2))
        band = cluster.sweep_jump_banded(pk, v, lab, tol2, 128, 128, starts)
        _eq(band, cluster.sweep_jump_banded_plain(pk, v, lab, tol2, 128, 128, starts))
        assert int(band[1]) == (0 if offsets[k] <= 0 else 1)


def test_distance_kernels_on_cross_term_pairs(dev):
    """K3, K4 and K5 bitwise equal to their plain versions on the 128 pairs
    near tol2 that the fused and the unfused cross term decide apart; the
    sweeps decide as the fused chain, and K3's squared distance of the pair
    is the fused d2 (the plain version's smallest value; the kernel's mean
    over the one neighbour is its correctly rounded root)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import sum_sq3

    tol2 = 0.4 ** 2
    valid = torch.tensor(np.arange(256) < 2, device=dev)
    labels = torch.arange(256, dtype=torch.int32, device=dev)
    starts = torch.zeros(2, dtype=torch.int32, device=dev)
    kstarts = outliers.band_starts(256, 128, 64, 2, dev)
    for q, c, fused_adjacent in cross_term_pairs(tol2):
        buf = np.zeros((256, 3), np.float32)
        buf[0], buf[1] = q, c
        p = torch.tensor(buf, device=dev)
        pc, pk = cluster.point_channels(p), cluster.pack_points(p)
        full = cluster.sweep_jump(pc, valid, labels, tol2)
        _eq(full, cluster.sweep_jump_plain(pc, valid, labels, tol2))
        band = cluster.sweep_jump_banded(pk, valid, labels, tol2, 128, 128, starts)
        _eq(band, cluster.sweep_jump_banded_plain(pk, valid, labels, tol2, 128, 128, starts))
        assert (int(full[1]) == 0) == fused_adjacent and (int(band[1]) == 0) == fused_adjacent
        pch = [p[:, i].contiguous() for i in range(3)]
        p_sq = sum_sq3(*pch)
        mean = outliers.knn_mean(pch, p_sq, valid, kstarts, 128, 256, 15)
        _eq(mean, outliers.knn_mean_plain(pch, p_sq, valid, kstarts, 128, 256, 15))
        d2 = max(float(d2_port(q, c)), 0.0)
        assert outliers.knn_select_plain(pch, p_sq, valid, kstarts, 128, 256)[0, 0].item() == d2
        assert mean[0].item() == float(np.float32(np.sqrt(np.float64(d2))))


@pytest.mark.parametrize("c,n,heads_kind", [
    (4, 131_072, "runs"), (4, 2_097_152, "runs"), (3, 1000, "runs"), (5, 1025, "runs"),
    (1, 1, "runs"),
    (4, 131_072, "none"), (4, 2_097_152, "none"),  # one segment: every element live
    (4, 131_072, "all"), (2, 20_000, "sparse"),  # every element a head; long segments
    (2, 20_000, "sparse_zeros"),  # -0.0 everywhere: the signs of zero that live steps read
    # past 2^24 values a row: the later steps one launch each in global memory
    (1, 2**24 + 4096, "runs"), (1, 2**24 + 4096, "none"), (2, 2**24 + 4096, "sparse_zeros"),
])
def test_segscan_kernel_equals_plain(dev, c, n, heads_kind):
    """K6 against its plain version in bit patterns, with heads from a
    sorted key buffer (runs of ~8), none, all, or a few (segments of
    thousands: live elements past the local steps), -0.0 values and
    non-finite values."""
    rng = np.random.default_rng(c + n)
    if heads_kind == "runs":
        keys = np.sort(rng.integers(0, max(n // 8, 1), n))
        heads = np.concatenate([[True], keys[1:] != keys[:-1]])
    elif heads_kind.startswith("sparse"):
        heads = rng.random(n) < 3e-4
    else:
        heads = np.full(n, heads_kind == "all")
    v = rng.standard_normal((c, n)).astype(np.float32)
    v[:, rng.random(n) < (0.999 if heads_kind == "sparse_zeros" else 0.05)] = -0.0
    if n > 100:
        v[0, 50], v[-1, 70] = np.inf, np.nan
    vt, ht = torch.tensor(v, device=dev), torch.tensor(heads, device=dev)
    before = _build.LAUNCHES["segscan"]
    got = segscan.segmented_inclusive_scan(vt, ht)
    assert _build.LAUNCHES["segscan"] == before + 1
    want = segscan.segmented_inclusive_scan_plain(vt, ht)
    _eq(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,k,c,exact_f32,unit", [(131_072, 214_000, 4, True, False),
                                                  (131_072, 214_000, 4, False, False),
                                                  (131_072, 3000, 4, True, True),
                                                  (8192, 1, 2, True, False)])
def test_binned_sum_kernel_equals_plain(dev, n, k, c, exact_f32, unit):
    """K7 against its plain version: counts exact, sums within the float32
    reordering bound (both add with atomics in run-dependent orders)."""
    rng = np.random.default_rng(n + k)
    ids = rng.integers(-50, k + 50, n).astype(np.int32)
    ids[:64] = 2**30
    w = (np.ones((n, c)) if unit else rng.standard_normal((n, c)) * 100).astype(np.float32)
    valid = rng.random(n) < 0.9
    args = [torch.tensor(a, device=dev) for a in (ids, w, valid)]
    before = _build.LAUNCHES["binned_sum"]
    got = binning.binned_weighted_sum(*args, k, exact_f32=exact_f32).cpu().numpy()
    assert _build.LAUNCHES["binned_sum"] == before + 1
    want = binning.binned_weighted_sum_plain(*args, k, exact_f32=exact_f32).cpu().numpy()
    if unit:
        np.testing.assert_array_equal(got, want)
    else:
        bound = binning.reordering_bound(*args, k, exact_f32).cpu().numpy()
        assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("c,aligned,strided_ids",
                         [(4, True, False), (3, True, False), (4, False, False), (4, True, True)])
def test_binned_sum_vector_and_scalar_paths(dev, c, aligned, strided_ids):
    """K7's float4 path (C = 4, 16-byte aligned weights) and its scalar path
    (C = 3, and C = 4 with weights one float off alignment): the unit count
    channel exact and equal to the member counts, sums within the reordering
    bound, and rows with ids outside [0, k) dropped (their weights of 1e30
    would show in any sum).  ``strided_ids``: int32 ids as a view of every
    other element of a buffer, which the wrapper copies."""
    n, k = 131_072, 214_000
    rng = np.random.default_rng(c + aligned)
    ids = rng.integers(0, k, n).astype(np.int32)
    out_of_range = rng.random(n) < 0.05
    ids[out_of_range] = rng.choice([-1, -7, k, k + 3, 2**30], out_of_range.sum())
    w = rng.uniform(-4.5, 4.5, (n, c)).astype(np.float32)
    w[:, -1] = 1.0
    w[out_of_range, :-1] = 1e30
    valid = rng.random(n) < 0.9
    if aligned:
        wt = torch.tensor(w, device=dev)
    else:  # a view one float past a 16-byte boundary
        flat = torch.empty(n * c + 1, device=dev)
        flat[1:] = torch.tensor(w.reshape(-1), device=dev)
        wt = flat[1:].view(n, c)
        assert wt.data_ptr() % 16
    it, vt = torch.tensor(ids, device=dev), torch.tensor(valid, device=dev)
    if strided_ids:
        it = torch.stack([it, torch.zeros_like(it)], dim=1)[:, 0]
        assert not it.is_contiguous()
    got = binning.binned_weighted_sum(it, wt, vt, k)
    want = binning.binned_weighted_sum_plain(it, wt, vt, k)
    keep = valid & ~out_of_range
    np.testing.assert_array_equal(got[:, -1].cpu().numpy(),
                                  np.bincount(ids[keep], minlength=k).astype(np.float32))
    bound = binning.reordering_bound(it, wt, vt, k).cpu().numpy()
    assert (np.abs(got.cpu().numpy().astype(np.float64) - want.cpu().numpy()) <= bound).all()


def test_card_sqrt_is_the_float64_root(dev):
    """``torch.sqrt`` in float32 on the card is correctly rounded: bitwise
    the float64 root rounded once, on 2^22 random non-negative float32 bit
    patterns (subnormals, zeros, infinity included), so ``ops.sqrt32``
    takes it as it is there."""
    from pointcloud_obstacle_processing_tpu_torch.ops import sqrt32

    rng = np.random.default_rng(7)
    bits = rng.integers(0, 0x7F800001, 1 << 22, dtype=np.int64).astype(np.int32)
    bits[:4] = [0, 1, 0x007FFFFF, 0x7F800000]
    x = torch.tensor(bits, device=dev).view(torch.float32)
    want = torch.sqrt(x.double()).to(torch.float32)
    _eq(torch.sqrt(x).view(torch.int32), want.view(torch.int32))
    _eq(sqrt32(x).view(torch.int32), want.view(torch.int32))
    _eq(want.cpu().view(torch.int32), sqrt32(x.cpu()).view(torch.int32))


def test_stream_handle_is_the_current_stream(dev):
    """The wrappers launch on PyTorch's current stream, inside a stream
    context too."""
    assert _build.stream_handle() == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_handle() == side.cuda_stream != 0
        ids = torch.zeros(1024, dtype=torch.int32, device=dev)
        w = torch.ones(1024, 4, device=dev)
        got = binning.binned_weighted_sum(ids, w, torch.ones(1024, dtype=torch.bool, device=dev), 4)
    side.synchronize()
    assert got[0].tolist() == [1024.0] * 4 and got[1:].abs().sum().item() == 0


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
        cluster.sweep_jump(cluster.point_channels(p), v,
                           torch.zeros(256, dtype=torch.int32, device=dev), 0.16)
    with pytest.raises(ValueError):  # labels of the wrong length
        cluster.cluster_loop(cluster.pack_points(p), v,
                             torch.zeros(256, dtype=torch.int32, device=dev), 0.16, 64)
    with pytest.raises(TypeError):  # int64 labels
        cluster.cluster_loop(cluster.pack_points(p), v,
                             torch.zeros(512, dtype=torch.int64, device=dev), 0.16, 64)
    ch = [torch.zeros(512, device=dev) for _ in range(3)]
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # validity mask of the wrong length
        outliers.knn_mean(ch, ch[0], v[:256], starts, 128, 256, 15)
    with pytest.raises(ValueError):  # k > 16
        outliers.knn_mean(ch, ch[0], v, starts, 128, 256, 17)
    lab = torch.zeros(512, dtype=torch.int32, device=dev)
    p = cluster.pack_points(p)
    with pytest.raises(ValueError):  # a window that is not a multiple of 128
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 192, starts)
    with pytest.raises(ValueError):  # a window as wide as the buffer
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 512, starts)
    with pytest.raises(TypeError):  # int64 starts
        cluster.sweep_jump_banded(p, v, lab, 0.16, 128, 256, starts.long())
    with pytest.raises(ValueError):  # heads of the wrong length
        segscan.segmented_inclusive_scan(torch.zeros(2, 512, device=dev), v[:256])
    with pytest.raises(ValueError):  # heads on the CPU
        segscan.segmented_inclusive_scan(torch.zeros(2, 512, device=dev), v.cpu())
    with pytest.raises(TypeError):  # float64 weights
        binning.binned_weighted_sum(lab, torch.zeros(512, 4, dtype=torch.float64, device=dev), v, 10,
                                    chunk=512)


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
    sweep = "cluster_sweep_banded" if band_window else "cluster_loop"
    path = ("runreduce", "compact_gather", "knn_mean", sweep)
    assert all(_build.LAUNCHES[k] > 0 for k in path), _build.LAUNCHES
    assert band_window or a.host_syncs == 0  # the loop kernel reads nothing back
    b = process_scan(cloud, cfg, draw=draw_from_uniform(torch.tensor(u)))
    _eq(a.grid.data, b.grid.data)
    for f in ("voxel_points", "inlier_points", "nonplane_points", "num_planes", "num_clusters",
              "voxel_overflow", "cluster_overflow", "cluster_band_overflow", "planes_truncated",
              "cluster_unconverged"):
        assert getattr(a.stats, f).item() == getattr(b.stats, f).item(), f
    np.testing.assert_allclose(a.centroids.points.xyzr.cpu().numpy(),
                               b.centroids.points.xyzr.numpy(), atol=1e-5)


def test_batched_kernels_equal_plain(dev):
    """K1, K2, K3 and the loop kernel on a batch of three differing scans,
    the scan a grid dimension: each scan's output equals the plain version
    (the loop kernel with 1, 2, 4, 8 and 16 blocks a scan)."""
    rng = np.random.default_rng(5)
    b, n = 3, 8192
    skey = np.full((b, n), 9000, np.int32)
    for i in range(b):
        skey[i, : 5000 + 1000 * i] = np.sort(rng.integers(0, 3000 + 1000 * i, 5000 + 1000 * i))
    pxy = rng.integers(0, 2**32, (b, n), dtype=np.uint64).astype(np.uint32).view(np.int32)
    pz = rng.integers(0, 65536, (b, n)).astype(np.int32)
    args = [torch.tensor(skey, device=dev), (torch.tensor(pxy, device=dev),
                                             torch.tensor(pz, device=dev)), 9000, 2048]
    vk, nk = runreduce.sorted_run_reduce(*args, quantum=0.04 / 65536)
    vp, np_ = runreduce.sorted_run_reduce_plain(*args, quantum=0.04 / 65536)
    _eq(nk, np_)
    for i, m in enumerate(np_.tolist()):
        _eq(vk[i, : min(m, 2048)], vp[i, : min(m, 2048)])

    occ = torch.tensor(rng.random((b, 64, 128)) < np.array([0.02, 0.3, 0.9])[:, None, None],
                       device=dev)
    bins = torch.tensor(rng.standard_normal((b, 4, 8192)).astype(np.float32), device=dev)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ, 1024)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ, 1024)
    _eq(nk, np_)
    for i, m in enumerate(np_.tolist()):
        _eq(lk[i, : min(m, 1024)], lp[i, : min(m, 1024)])
        _eq(vk[i, : min(m, 1024)], vp[i, : min(m, 1024)])

    rt, band = 384, 512
    p = torch.sort(torch.tensor(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32), device=dev),
                   dim=1).values
    valid = torch.tensor(np.arange(n) < np.array([3000, 6000, 8192])[:, None], device=dev)
    pch = [p[..., c].contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // rt)
    starts = outliers.band_starts(n, rt, band, tiles, dev)
    knn = (pch, p_sq, valid, starts, rt, rt + 2 * band, 15)
    _eq(outliers.knn_mean(*knn), outliers.knn_mean_plain(*knn))

    c = 1024
    pts = torch.tensor(rng.uniform(0, 3.0, (b, c, 3)).astype(np.float32), device=dev)
    cvalid = torch.tensor(np.arange(c) < np.array([400, 800, 1024])[:, None], device=dev)
    q, q_sq, labels = cluster._seed_labels(pts, cvalid, 0.08)
    loop = (cluster.pack_points(q, q_sq), cvalid, labels, 0.08 ** 2, 64)
    want = cluster.cluster_loop_plain(*loop)
    for nb in (1, 2, 4, 8, 16):
        got = cluster.loop_kernel(*loop, blocks=nb)
        _eq(got.labels, want.labels)
        _eq(got.sweeps, want.sweeps)
        _eq(got.unconverged, want.unconverged)


def test_batched_slice_on_the_card_equals_cpu(dev):
    """A batch of three scans of the small config on the card, one launch of
    each kernel, against the same batch through the plain versions."""
    cfg = REFERENCE_YAML_CONFIG.replace(
        max_points=32768, max_voxels=8192, cluster_capacity=2048, max_clusters=16,
        downsample_leaf_size=0.06, voxel_payload_packing=True,
    )
    spec = SceneSpec(n_ground=24000, n_rocks=3, points_per_rock=1500, n_noise=150)
    pts = np.stack([make_scene(seed=s, spec=spec).points[:27000] for s in (11, 12, 13)])
    cloud = Cloud.pad_to(pts, cfg.max_points)
    u = np.random.default_rng(0).random((3, cfg.max_planes, cfg.ransac_hypotheses, 3))
    u = u.astype(np.float32)
    _build.reset_launch_counts()
    a = process_scan(cloud.to(dev), cfg, draw=draw_from_uniform(torch.tensor(u, device=dev)))
    for k in ("runreduce", "compact_gather", "knn_mean", "cluster_loop"):
        assert _build.LAUNCHES[k] == 1, _build.LAUNCHES
    assert a.host_syncs == 0
    b = process_scan(cloud, cfg, draw=draw_from_uniform(torch.tensor(u)))
    _eq(a.grid.data, b.grid.data)
    _eq(a.clusters.point_cluster, b.clusters.point_cluster)
    for f in ("voxel_points", "inlier_points", "nonplane_points", "num_planes", "num_clusters",
              "voxel_overflow", "cluster_overflow", "planes_truncated", "cluster_unconverged"):
        _eq(getattr(a.stats, f), getattr(b.stats, f))
    np.testing.assert_allclose(a.centroids.points.xyzr.cpu().numpy(),
                               b.centroids.points.xyzr.numpy(), atol=1e-5)


@pytest.mark.parametrize("b,n,n_runs,cap", [
    (1, 4 * 131_072, 60_000, 131_072),  # the fullscale distributed merge's range at S = 4
    (1, 4 * 262_144, 180_000, 262_144),  # the fullscale replicated sort merge at S = 4
    (2, 8192, 700, 1024),  # a batch: the scan a grid dimension
])
def test_runreduce_counts_mode_equals_plain(dev, b, n, n_runs, cap):
    """K1's counts mode (a fourth buffer of per-row counts, the merges'):
    bitwise the plain version, counted apart from the three-buffer form;
    with all-ones counts bitwise the three-buffer kernel."""
    rng = np.random.default_rng(n + b)
    sentinel = 1 << 22
    skey = np.full((b, n), sentinel, np.int32)
    for i in range(b):
        n_valid = n - 5000 * (i + 1) if n > 10_000 else n - 300 * (i + 1)
        skey[i, :n_valid] = np.sort(rng.integers(0, n_runs, n_valid) * 7)
    k = torch.tensor(skey, device=dev)
    offs = [torch.tensor(rng.standard_normal((b, n)).astype(np.float32), device=dev)
            for _ in range(3)]
    cnt = torch.tensor(rng.integers(1, 30, (b, n)).astype(np.float32), device=dev)
    before = dict(_build.LAUNCHES)
    vk, nk = runreduce.sorted_run_reduce(k, offs + [cnt], sentinel, cap)
    assert _build.LAUNCHES["runreduce_counts"] == before["runreduce_counts"] + 1
    assert _build.LAUNCHES["runreduce"] == before["runreduce"]
    vp, np_ = runreduce.sorted_run_reduce_plain(k, offs + [cnt], sentinel, cap)
    _eq(nk, np_)
    for i in range(b):
        m = min(int(nk[i]), cap)
        _eq(vk[i, :m], vp[i, :m])
    v4, n4 = runreduce.sorted_run_reduce(k, offs + [torch.ones_like(cnt)], sentinel, cap)
    v3, n3 = runreduce.sorted_run_reduce(k, offs, sentinel, cap)
    _eq(n4, n3)
    for i in range(b):
        m = min(int(n3[i]), cap)
        _eq(v4[i, :m], v3[i, :m])


@pytest.mark.parametrize("n,n_valid,rt,band,shards", [
    (24576, 21500, 384, 512, 4),  # the flagship voxel cloud over 4 shards
    (262144, 166000, 1024, 1280, 4),  # the fullscale voxel cloud over 4 shards
    (4096, 3000, 128, 192, 8),
])
def test_knn_select_row_range_equals_plain(dev, n, n_valid, rt, band, shards):
    """K3 over each shard's range of the query tiles: bitwise its plain
    version and the same rows of the whole call."""
    rng = np.random.default_rng(n + shards)
    pts = rng.uniform([0, 0, -0.1], [4.5, 3.78, 0.3], (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(n) < n_valid, device=dev)
    p = torch.tensor(pts, device=dev)
    pch = [torch.where(valid, p[:, c] - 2.0, 0.0).contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // rt)
    starts = outliers.band_starts(n, rt, band, tiles, dev)
    width = rt + 2 * band
    whole = outliers.knn_mean(pch, p_sq, valid, starts, rt, width, 15)
    per = tiles // shards
    for s in range(shards):
        before = _build.LAUNCHES["knn_mean_rows"]
        got = outliers.knn_mean(pch, p_sq, valid, starts, rt, width, 15, tile_range=(s * per, per))
        assert _build.LAUNCHES["knn_mean_rows"] == before + 1
        _eq(got, outliers.knn_mean_plain(pch, p_sq, valid, starts, rt, width, 15,
                                         tile_range=(s * per, per)))
        _eq(got, whole[s * per * rt:(s + 1) * per * rt])


@pytest.mark.parametrize("c,n_valid,shards", [(1024, 600, 4), (16384, 7000, 4), (2048, 2000, 8)])
def test_cluster_sweep_row_range_equals_plain(dev, c, n_valid, shards):
    """K4's per-sweep kernel over each shard's range of the query rows
    (the point-sharded full sweep): bitwise its plain version and the same
    rows of the whole sweep."""
    rng = np.random.default_rng(c + shards)
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p = torch.where(valid[:, None], torch.tensor(
        rng.uniform(-1.5, 1.5, (c, 3)).astype(np.float32), device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    labels = torch.tensor(lab, device=dev)
    pch = cluster.point_channels(p)
    whole = cluster.sweep_jump(pch, valid, labels, 0.16)
    per = c // shards
    for s in range(shards):
        rows = (s * per, per)
        before = _build.LAUNCHES["cluster_sweep_rows"]
        got = cluster.sweep_jump(pch, valid, labels, 0.16, rows)
        assert _build.LAUNCHES["cluster_sweep_rows"] == before + 1
        _eq(got, cluster.sweep_jump_plain(pch, valid, labels, 0.16, rows))
        _eq(got, whole[s * per:(s + 1) * per])


@pytest.mark.parametrize("c,n_valid,window,gated,shards", [
    (16384, 7000, 4096, True, 4),  # the fullscale shape over 4 shards
    (16384, 16384, 4096, False, 4),
    (1024, 1000, 256, True, 8),
])
def test_cluster_sweep_banded_row_range_equals_plain(dev, c, n_valid, window, gated, shards):
    """K5 over each shard's range of the query tiles: bitwise its plain
    version and the same rows of the whole sweep."""
    rng = np.random.default_rng(c + window + shards)
    pts = rng.uniform([-2.2, -1.9, -0.3], [2.2, 1.9, 0.3], (c, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(c) < n_valid, device=dev)
    p = torch.where(valid[:, None], torch.tensor(pts, device=dev), 0.0)
    lab = np.arange(c, dtype=np.int32)
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    labels = torch.tensor(lab, device=dev)
    starts, _ = cluster.band_starts(p, valid, 128, window, 0.4)
    live = torch.tensor(rng.random(c // 128) < 0.5, device=dev) if gated else None
    pk = cluster.pack_points(p)
    whole = cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, window, starts, live)
    per = c // 128 // shards
    for s in range(shards):
        tr = (s * per, per)
        before = _build.LAUNCHES["cluster_sweep_banded_rows"]
        got = cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, window, starts, live, tr)
        assert _build.LAUNCHES["cluster_sweep_banded_rows"] == before + 1
        _eq(got, cluster.sweep_jump_banded_plain(pk, valid, labels, 0.16, 128, window, starts,
                                                 live, tr))
        _eq(got, whole[s * per * 128:(s + 1) * per * 128])


def _banded_batch(dev, c, n_valids, window, seed):
    """A batch of lattice-ordered (x-sorted) cluster buffers with seeded
    labels: packed points, valid, labels and each scan's band starts."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((len(n_valids), c, 3), np.float32)
    valid = np.zeros((len(n_valids), c), bool)
    for b, n_valid in enumerate(n_valids):
        q = rng.uniform([-2.2, -1.9, -0.3], [2.2, 1.9, 0.3], (n_valid, 3)).astype(np.float32)
        pts[b, :n_valid] = q[np.argsort(q[:, 0], kind="stable")]
        valid[b, :n_valid] = True
    p, p_sq, labels = cluster._seed_labels(torch.tensor(pts, device=dev),
                                           torch.tensor(valid, device=dev), 0.4)
    starts, _ = cluster.band_starts(p, torch.tensor(valid, device=dev), 128, window, 0.4)
    return cluster.pack_points(p, p_sq), torch.tensor(valid, device=dev), labels, starts


@pytest.mark.parametrize("c,n_valids,window,tile_range", [
    (1024, (1000, 600, 0), 256, None),  # a scan with no valid point
    (16384, (7000, 16384, 12000), 4096, None),  # the fullscale shape
    (16384, (7000, 16384, 12000), 4096, (32, 32)),  # one rank's tiles of four
])
def test_cluster_sweep_banded_batch_equals_plain(dev, c, n_valids, window, tile_range):
    """K5 at B = 3, one launch for the batch, with every tile live and with
    a mixed ``tile_live`` (one scan with no live tile), against the plain
    version and against each scan's own launch."""
    pk, valid, labels, starts = _banded_batch(dev, c, n_valids, window, c + window)
    rng = np.random.default_rng(c)
    live = torch.tensor(rng.random(starts.shape) < 0.5, device=dev)
    live[1] = False
    for tl in (None, live):
        before = _build.LAUNCHES["cluster_sweep_banded" if tile_range is None
                                 else "cluster_sweep_banded_rows"]
        got = cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, window, starts, tl,
                                        tile_range)
        assert _build.LAUNCHES["cluster_sweep_banded" if tile_range is None
                               else "cluster_sweep_banded_rows"] == before + 1
        _eq(got, cluster.sweep_jump_banded_plain(pk, valid, labels, 0.16, 128, window, starts,
                                                 tl, tile_range))
        for b in range(3):
            _eq(got[b], cluster.sweep_jump_banded(pk[b], valid[b], labels[b], 0.16, 128, window,
                                                  starts[b], None if tl is None else tl[b],
                                                  tile_range))


def test_banded_loop_batch_equals_per_scan_loops(dev):
    """The batched banded loop on the card (one K5 launch a sweep for the
    batch) against each scan's own loop and against the CPU's loop: labels
    and ``unconverged`` bitwise."""
    pk, valid, labels, starts = _banded_batch(dev, 16384, (7000, 16384, 12000), 4096, 5)
    before = _build.LAUNCHES["cluster_sweep_banded"]
    lab, unc, syncs = cluster._banded_loop(pk, valid, labels, 0.16, 4096, starts, 64)
    sweeps = _build.LAUNCHES["cluster_sweep_banded"] - before
    assert syncs == sweeps - 1
    for b in range(3):
        one = cluster._banded_loop(pk[b:b + 1], valid[b:b + 1], labels[b:b + 1], 0.16, 4096,
                                   starts[b:b + 1], 64)
        _eq(lab[b], one[0][0])
        _eq(unc[b], one[1][0])
    cpu = cluster._banded_loop(pk.cpu(), valid.cpu(), labels.cpu(), 0.16, 4096, starts.cpu(), 64)
    _eq(lab, cpu[0])
    _eq(unc, cpu[1])


def test_cluster_sweep_banded_refuses_mismatched_batches(dev):
    """The batched K5 wrapper refuses operands whose scan counts or tile
    counts do not match."""
    pk, valid, labels, starts = _banded_batch(dev, 1024, (1000, 600, 300), 256, 1)
    live = torch.ones_like(starts, dtype=torch.bool)
    with pytest.raises(ValueError):  # starts of two scans for three
        cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, 256, starts[:2])
    with pytest.raises(ValueError):  # one scan's starts for the batch
        cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, 256, starts[0])
    with pytest.raises(ValueError):  # tile_live of the wrong tile count
        cluster.sweep_jump_banded(pk, valid, labels, 0.16, 128, 256, starts, live[:, :4])
    with pytest.raises(ValueError):  # labels of two scans
        cluster.sweep_jump_banded(pk, valid, labels[:2], 0.16, 128, 256, starts)
    with pytest.raises(ValueError):  # packed points of two scans
        cluster.sweep_jump_banded(pk[:2], valid, labels, 0.16, 128, 256, starts)


def _fold_case(name: str):
    """(dest [S, N] int32, vals [S, C, N] float32 or a [S, N, C] buffer's
    transpose, bins, keyword arguments) of a named segment fold case; each
    dest meets the kernel's contract (sorted, out-of-range rows at both
    ends)."""
    rng = np.random.default_rng(len(name))

    def values(scans, c, n):
        v = rng.standard_normal((scans, c, n)) * 10.0 ** rng.uniform(-6, 3, (scans, c, n))
        v = v.astype(np.float32)
        v[..., : n // 50] = -0.0
        return v

    def sorted_dest(scans, n, bins):
        return np.sort(rng.integers(-3, bins + 3, (scans, n)), axis=-1).astype(np.int32)

    shapes = {"flagship_shape": (1, 100_352, 4, 230_144), "batch_c8": (3, 20_000, 8, 4_000),
              "c1_seven_bins": (2, 50_000, 1, 7), "one_row": (1, 1, 3, 5),
              "bins_below_tile": (2, 30_000, 4, 300), "bins_off_tile": (1, 40_000, 3, 5_000)}
    if name in shapes:
        scans, n, c, bins = shapes[name]
        kw = {"width": 5_003} if name == "bins_off_tile" else {}  # scalar stores
        return sorted_dest(scans, n, bins), values(scans, c, n), bins, kw
    if name == "one_run_50k":
        dest = np.full((1, 50_000), 123, np.int32)
        return dest, values(1, 4, 50_000), 1_000, {}
    if name == "occupancy_4pct_4m":  # ~12 rows a voxel, as the fullscale window
        bins, n = 4_000_000, 2_097_152
        occupied = np.sort(rng.choice(bins, bins // 25, replace=False))
        dest = np.sort(rng.choice(occupied, n))[None].astype(np.int32)
        return dest, values(1, 4, n), bins, {}
    if name == "all_dropped":
        dest = np.concatenate([np.full(3_000, -5), np.full(5_000, 2_000)])[None]
        return dest.astype(np.int32), values(1, 4, 8_000), 2_000, {}
    if name == "batch_uneven":  # empty, dense, sparse, one long run
        n, bins = 30_000, 3_000
        dest = np.stack([np.full(n, bins + 1), sorted_dest(1, n, bins)[0],
                         np.sort(np.where(rng.random(n) < 0.01, rng.integers(0, bins, n), -1)),
                         np.full(n, 7)]).astype(np.int32)
        return dest, values(4, 4, n), bins, {}
    # the callers' forms: the sort's permutation over a [S, N, 4] buffer read
    # through its transpose, split terms, bins padded to 128
    terms = int(name[-1])
    scans, n, bins = 2, 100_352, 230_080
    keys = np.where(rng.random((scans, n)) < 0.9,
                    rng.integers(0, bins // 10, (scans, n)) * 10, bins)
    order = np.argsort(keys, axis=-1, kind="stable")
    dest = np.take_along_axis(keys, order, -1).astype(np.int32)
    buf = rng.uniform(-0.04, 0.04, (scans, n, 4)).astype(np.float32)
    buf[..., 3] = 1.0
    return dest, buf, bins, dict(order=order, bf16_terms=terms, width=230_144)


FOLD_CASES = ("flagship_shape", "batch_c8", "c1_seven_bins", "one_row", "one_run_50k",
              "occupancy_4pct_4m", "all_dropped", "bins_below_tile", "bins_off_tile",
              "batch_uneven", "order_terms0", "order_terms1", "order_terms2")


@pytest.mark.parametrize("case", FOLD_CASES)
def test_segment_fold_kernel_equals_plain(dev, case):
    """The segment fold kernel bitwise against its plain version on a CPU
    copy (the gather, the split terms, ``index_add_`` in row order): runs
    from one row to 50,000, 4% occupancy over 4M bins, every row dropped,
    bins below and off the kernel's 1,024-bin tile, a batch whose scans
    fill differently, the sort's permutation and the split terms; rows out
    of range at both ends dropped, -0.0 values folded to +0.0.  Each
    output element is written: the call gets back a freed block the same
    size filled with NaN.  One launch and one device operation a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pointcloud_obstacle_processing_tpu_torch.ops.segfold import (
        meets_contract,
        segment_fold,
        segment_fold_plain,
    )

    dest, vals, bins, kw = _fold_case(case)
    d = torch.tensor(dest)
    v = torch.tensor(vals)
    if v.shape[-1] != d.shape[-1]:
        v = v.transpose(-1, -2)  # a [S, N, C] buffer read as it lies
    kw = {k: torch.tensor(x) if isinstance(x, np.ndarray) else x for k, x in kw.items()}
    assert meets_contract(d, bins)
    want = segment_fold_plain(d, v, bins, **kw)
    dd, vd = d.to(dev), v.to(dev)
    kd = {k: x.to(dev) if torch.is_tensor(x) else x for k, x in kw.items()}
    junk = torch.full(want.shape, float("nan"), device=dev)
    del junk  # the allocator hands this block back to the call
    before = _build.LAUNCHES["segment_fold"]
    got = segment_fold(dd, vd, bins, **kd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["segment_fold"] == before + 1
    assert not torch.isnan(got).any()
    _eq(got.view(torch.int32), want.view(torch.int32))
    for _ in range(5):  # a profiling session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            segment_fold(dd, vd, bins, **kd)
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == 1 and "segment_fold" in ops[0], ops


@pytest.mark.parametrize("engine", ["scatter", "mxu_fast", "mxu_exact", "fallback", "morton"])
def test_voxel_engines_on_the_card_equal_cpu(dev, engine):
    """Each voxel engine's partials on the card equal the CPU run bitwise,
    a batch of two scans included, through the kernels it names."""
    from pointcloud_obstacle_processing_tpu_torch.ops import voxel

    kw, bounds, kernel = {
        "scatter": (dict(binning="scatter"), "box", "segment_fold"),
        "mxu_fast": (dict(binning="mxu", sum_precision="fast"), "box", "segment_fold"),
        "mxu_exact": (dict(binning="mxu", sum_precision="exact"), "box", "segment_fold"),
        "fallback": ({}, None, "segment_fold"),
        "morton": (dict(order="morton"), "box", "runreduce"),
    }[engine]
    box = ((0.0, 0.0, -0.5), (4.5, 3.78, 0.25))
    rng = np.random.default_rng(len(engine))
    pts = rng.uniform(box[0], box[1], (2, 16_384, 3)).astype(np.float32)
    pts[:, :8000] = pts[:, rng.integers(0, 100, 8000)] + rng.normal(0, 0.01, (2, 8000, 3))
    pts = np.clip(pts, box[0], box[1]).astype(np.float32)
    valid = rng.random((2, 16_384)) < 0.9
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid))
    bounds = box if bounds else None
    want = voxel.voxel_partials(cloud, 0.04, 4096, bounds, **kw)
    _build.reset_launch_counts()
    got = voxel.voxel_partials(cloud.to(dev), 0.04, 4096, bounds, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] >= 1
    for f in ("keys", "sums", "counts", "num_voxels", "overflow"):
        _eq(getattr(got, f), getattr(want, f))


def _shadow_case(kind: str):
    """Shadow-stage inputs as CPU tensors and the pose: ``kind`` names a
    shape (flagship: 1 scan of 1,024 cluster points, fullscale: 16,384,
    batch: 32 scans of 1,024 with a pose a scan; 64 slots each) or the edge
    scan (``utils.shadow_cases.edge_slots``, 64 slots)."""
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

    case = {"flagship": lambda: shadow_cases.random_slots(0, 1, 1024, 64),
            "fullscale": lambda: shadow_cases.random_slots(1, 1, 16_384, 64),
            "batch": lambda: shadow_cases.random_slots(2, 32, 1024, 64, pose_per_scan=True),
            "edges": lambda: shadow_cases.edge_slots(64)}[kind]()
    args = [torch.tensor(case[k]) for k in ("points", "valid", "point_cluster", "slot_valid")]
    return args, RigidTransform.from_quat_trans(case["quat"], case["trans"])


@pytest.mark.parametrize("kind", ["flagship", "fullscale", "batch", "edges"])
def test_shadow_kernels_equal_plain(dev, kind):
    """``shadow_slots`` and ``shadow_raster`` on the card bitwise their plain
    twins on the CPU, one launch each, at the flagship, fullscale and
    batch-of-32 shapes and on the edge scan (a / c = +-1, a slot at the
    sensor, subnormal and tiny z, ties, empty slots, ...)."""
    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    args, tf = _shadow_case(kind)
    want = shadow.shadow_slots_plain(*args, tf, cfg)
    before = dict(_build.LAUNCHES)
    got = shadow.shadow_slots(*[a.to(dev) for a in args], tf.to(dev), cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["shadow_slots"] == before["shadow_slots"] + 1
    _eq(got, want)
    grid = torch.tensor(np.random.default_rng(3).choice(
        [0, 100], (*want.shape[:-2], cfg.grid_height, cfg.grid_width)).astype(np.int8))
    want_grid = shadow.shadow_raster_plain(grid, want, 50)
    got_grid = shadow.shadow_raster(grid.to(dev), got, 50)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["shadow_raster"] == before["shadow_raster"] + 1
    _eq(got_grid, want_grid)
    assert (want_grid == 50).any()


@pytest.mark.parametrize("m", [1, 64, 300])
def test_shadow_raster_on_extreme_lines(dev, m):
    """The raster kernel on random lines with ends up to +-2^31 (int32
    arithmetic wrapping, float conversions saturating), line counts up to
    2^31 - 1, steep and active flags at random, more slots than a block
    stages at once (300), against its plain twin."""
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    rng = np.random.default_rng(m)
    scale = 2.0 ** rng.integers(1, 32, (4, m, 4))
    ends = np.clip(rng.uniform(-1, 1, (4, m, 4)) * scale, -2**31, 2**31 - 1).astype(np.int32)
    ends[..., :4][rng.random((4, m, 4)) < 0.5] %= 128
    n = np.where(rng.random((4, m)) < 0.9, rng.integers(1, 40, (4, m)),
                 rng.integers(-2**31, 2**31 - 1, (4, m))).astype(np.int32)
    flags = rng.integers(0, 2, (4, m, 2)).astype(np.int32)
    lines = torch.tensor(np.concatenate([ends, n[..., None], flags], -1))
    grid = torch.tensor(rng.choice([0, 100], (4, 120, 101)).astype(np.int8))
    _eq(shadow.shadow_raster(grid.to(dev), lines.to(dev), 7),
        shadow.shadow_raster_plain(grid, lines, 7))


def test_libm32_equals_plain(dev):
    """The card's ``asin_like_xla``, ``tanf`` and ``atan2f``
    (``csrc/libm32.cuh``) bitwise the plain forms on the CPU: every 1,021st
    float32 of [-1, 1] and of [-pi/2, pi/2] rounded up, subnormals, and
    ``atan2f`` on 100,000 seeded pairs over 80 decades with every special
    pair."""
    from pointcloud_obstacle_processing_tpu_torch.ops import libm

    def span(top, step):  # every step-th float32 of [-top, top], by bits
        bits = np.arange(0, np.float32(top).view(np.int32) + 1, step, dtype=np.int32)
        return np.concatenate([bits, bits | np.int32(-2**31)]).view(np.float32)

    for name, top in (("asin_like_xla", 1.0), ("tanf", np.nextafter(np.float32(np.pi / 2), 9))):
        x = torch.tensor(span(top, 1021))
        _eq(libm.on_card(name, x.to(dev)).view(torch.int32), libm.ROUTINES[name](x).view(torch.int32))
    rng = np.random.default_rng(4)
    y = (rng.standard_normal(100_000) * 10.0 ** rng.uniform(-40, 38, 100_000)).astype(np.float32)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.uniform(-40, 38, 100_000)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-40, 3.0], np.float32)
    sy, sx = np.meshgrid(special, special)
    y, x = torch.tensor(np.concatenate([y, sy.ravel()])), torch.tensor(np.concatenate([x, sx.ravel()]))
    _eq(libm.on_card("atan2f", y.to(dev), x.to(dev)).view(torch.int32),
        libm.atan2f(y, x).view(torch.int32))


def test_cast_shadows_launches_the_two_kernels_and_no_torch_trig(dev, monkeypatch):
    """``cast_shadows`` on CUDA tensors launches ``shadow_slots`` and
    ``shadow_raster`` once each for a batch, and calls neither
    ``torch.arcsin`` nor ``torch.tan``; its grid is the CPU's."""
    from pointcloud_obstacle_processing_tpu_torch import ClusterSet
    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    (pts, ok, pc, sv), tf = _shadow_case("batch")
    cloud = Cloud(points=pts, valid=ok)
    clusters = ClusterSet(point_cluster=pc, sizes=torch.ones_like(pc[:, :64]), valid=sv,
                          num_clusters=torch.full((32,), 64))
    grid = torch.zeros(32, cfg.grid_height, cfg.grid_width, dtype=torch.int8)
    want = shadow.cast_shadows(grid, cloud, clusters, tf, cfg).grid
    for name in ("arcsin", "tan", "asin"):
        monkeypatch.setattr(torch, name, lambda *a, **k: pytest.fail("torch trig on the card"))
    _build.reset_launch_counts()
    got = shadow.cast_shadows(grid.to(dev), cloud.to(dev),
                              ClusterSet(*(getattr(clusters, f).to(dev) for f in
                                           ("point_cluster", "sizes", "valid", "num_clusters"))),
                              tf.to(dev), cfg).grid
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"shadow_slots": 1,
                                                                "shadow_raster": 1}
    _eq(got, want)


@pytest.mark.parametrize("kind", ["flagship", "fullscale", "batch_1024", "batch_16384", "wide",
                                  "tiny", "one_slot", "runs", "nan"])
def test_shadow_slots_cluster_equals_plain(dev, kind):
    """The slot kernel (a thread-block cluster a scan, up to 8 blocks) on
    every cluster size it takes: C = 1,024 and 16,384 for one scan and a
    batch of 32, C = 10,240 (5 blocks, uneven shares), C = 100; every
    point in one slot, and each slot's points in one run of the buffer
    (warps that reduce one slot's points first, and warps at a run's
    edge); NaN points.
    Bitwise its plain twin on the CPU, one launch."""
    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

    scans, c = {"flagship": (1, 1024), "fullscale": (1, 16_384), "batch_1024": (32, 1024),
                "batch_16384": (32, 16_384), "wide": (3, 10_240), "tiny": (2, 100),
                "one_slot": (2, 16_384), "runs": (3, 16_384), "nan": (4, 4096)}[kind]
    case = shadow_cases.random_slots(7, scans, c, 64, pose_per_scan=scans > 1)
    if kind == "one_slot":
        case["point_cluster"][:] = 0
    if kind == "runs":
        case["point_cluster"].sort(axis=-1)
    if kind == "nan":
        rng = np.random.default_rng(8)
        case["points"][rng.random(case["points"].shape) < 0.002] = np.nan
    args = [torch.tensor(case[k]) for k in ("points", "valid", "point_cluster", "slot_valid")]
    tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
    want = shadow.shadow_slots_plain(*args, tf, cfg)
    before = _build.LAUNCHES["shadow_slots"]
    got = shadow.shadow_slots(*[a.to(dev) for a in args], tf.to(dev), cfg)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["shadow_slots"] == before + 1
    _eq(got, want)


def _fma_sets():
    from pointcloud_obstacle_processing_tpu_torch.utils import fma_cases

    return {"near_ties": fma_cases.near_ties(0, 100_000),
            "subnormal_ties": fma_cases.subnormal_ties(1, 20_000)}


@pytest.mark.parametrize("name", ["near_ties", "subnormal_ties"])
def test_fma_chain_kernel_equals_plain_on_near_ties(dev, name):
    """``ops.fma`` on the card (one launch of ``csrc/fma_chain.cu``) bitwise
    the plain form on the CPU on the near-tie triples."""
    from pointcloud_obstacle_processing_tpu_torch import ops

    a, b, c = (torch.tensor(v) for v in _fma_sets()[name])
    want = ops.fma_plain(a, b, c)
    before = _build.LAUNCHES["fma_chain"]
    got = ops.fma(a.to(dev), b.to(dev), c.to(dev))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fma_chain"] == before + 1
    _eq(got.view(torch.int32), want.view(torch.int32))
    _eq(ops.fma_plain(a.to(dev), b.to(dev), c.to(dev)).view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", ["dot3", "sum_sq3", "add_sq3"])
def test_chain_helpers_take_one_launch_and_equal_plain(dev, kind, monkeypatch):
    """Each helper on CUDA tensors: one ``fma_chain`` launch, no float64
    tensor made, bitwise its plain form on the CPU on near-tie operands."""
    from pointcloud_obstacle_processing_tpu_torch import ops
    from pointcloud_obstacle_processing_tpu_torch.utils import fma_cases

    operands = [torch.tensor(v) for v in fma_cases.chain_ties(2, 100_000, kind)]
    want = getattr(ops, kind)(*operands)
    on_card = [t.to(dev) for t in operands]
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.Tensor, "double",
                        lambda *a, **k: pytest.fail("a float64 tensor on the card"))
    _build.reset_launch_counts()
    got = getattr(ops, kind)(*on_card)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"fma_chain": 1}
    assert got.dtype == torch.float32 and got.is_contiguous()
    _eq(got.view(torch.int32), want.view(torch.int32))


def test_fma_chain_broadcast_strided_operands_and_constants(dev):
    """The chain kernel reads broadcast operands ([B, N, 1] points against
    [B, 1, K] planes, RANSAC's scoring), transposed, sliced and unaligned
    views, 0-d CPU constants (by value) and a 0-d card tensor in place:
    each call one launch, bitwise the plain form."""
    from pointcloud_obstacle_processing_tpu_torch import ops

    g = torch.Generator().manual_seed(9)

    def r(*s):
        return torch.randn(*s, generator=g)

    card0 = r(())  # a 0-d operand on the card: read in place, not by value
    cases = [
        ("dot3", (r(3, 2000, 1), r(3, 2000, 1), r(3, 2000, 1), r(3, 1, 128), r(3, 1, 128),
                  r(3, 1, 128))),
        ("fma", (r(64, 48).T, r(48, 1), r(1, 64))),
        ("fma", (r(10, 20, 3)[..., 0], r(10, 20, 3)[..., 2], r(40)[::2])),
        ("fma", (r(1000, 3), ops.f32(0.04), ops.f32(0.25))),
        ("fma", (r(1001)[1:], r(1002)[2:], r(1000))),  # contiguous, not 16-byte aligned
        ("fma", (r(1000, 3), ops.recip32(0.08), card0)),
        ("sum_sq3", (r(5, 7, 9, 2, 3, 4, 1)[..., 0], r(1, 7, 1, 2, 1, 4), r(9, 1, 3, 1))),
        ("add_sq3", (r(300), r(300), ops.f32(3.0))),
    ]
    for kind, operands in cases:
        want = getattr(ops, kind)(*operands)
        on_card = [t.to(dev) if t.dim() or t is card0 else t for t in operands]
        before = _build.LAUNCHES["fma_chain"]
        got = getattr(ops, kind)(*on_card)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fma_chain"] == before + 1, kind
        assert got.shape == want.shape and got.is_contiguous()
        _eq(got.view(torch.int32), want.view(torch.int32))


def test_fma_chain_refuses_bad_operands(dev):
    from pointcloud_obstacle_processing_tpu_torch import ops

    x = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        ops.fma(x, x.double(), x)
    with pytest.raises(TypeError):
        ops.fma(x, x.int(), x)
    with pytest.raises(TypeError):
        ops.fma(x, 2.0, x)
    with pytest.raises(ValueError):  # a CPU operand of rank 1 with CUDA operands
        ops.fma(x, torch.ones(8), x)
    with pytest.raises(ValueError):  # a form the port does not write
        ops.fma_chain(((x, x),) * 2)


# RANSAC's round kernels (csrc/ransac_score.cu): (scans, rows, hypotheses),
# rows off the 256-row tile, hypotheses from 1 to past the 1,024 planes a
# block stages at once
RANSAC_SHAPES = [(1, 1000, 1), (3, 2000, 64), (1, 24_576, 128), (32, 1500, 128), (3, 777, 200),
                 (1, 3001, 1000), (2, 300, 1100)]


def _score_args(seed, scans, n, k, kind):
    from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases

    c = ransac_cases.score_case(seed, scans, n, k, kind)
    return [torch.tensor(c[f]) for f in ("points", "valid", "nx", "ny", "nz", "ds", "gate")], \
        c["thresh"]


def _case_args(seed, scans, n, k, kind, tail=False):
    """``ransac_cases.round_case`` as tensors: (points, valid, tri, n_valid),
    thresh; with ``tail``, the back half of every scan invalid (a
    compacted cloud's tail) and the draws taken again from the front."""
    from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases

    c = ransac_cases.round_case(seed, scans, n, k, kind)
    points, valid, tri, n_valid = (torch.tensor(c[f]) for f in ("points", "valid", "tri",
                                                                 "n_valid"))
    if tail:
        valid[:, n // 2:] = False
        n_valid = valid.sum(-1, dtype=torch.int32)
        rng = np.random.default_rng(seed)
        for b in range(scans):
            rows = torch.nonzero(valid[b])[:, 0]
            tri[b] = rows[torch.tensor(rng.integers(0, len(rows), (k, 3)))]
    return [points, valid, tri, n_valid], c["thresh"]


def _bitwise(a, b):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    _eq(a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def _score_detail(on_card, thresh, cos_min, form=None):
    """One launch of the score kernel that also writes the gated counts and
    the winner's index: (RoundScore, counts, best)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    return ransac._score_launch(on_card, (float(thresh), float(cos_min), (0.0, 0.0, 1.0)),
                                form, detail=True)


def _score_plain(args, thresh, cos_min):
    """The score kernel's reference on CPU tensors: ``hypotheses_plain``,
    then ``ransac_score_plain`` (counts, best, found, normal, d, mask)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    points, valid, tri, n_valid = args
    planes = ransac.hypotheses_plain(points, tri, n_valid, cos_min, (0.0, 0.0, 1.0))
    return ransac.ransac_score_plain(points, valid, *planes, thresh)


def _same_score(got, want):
    """A ``_score_detail`` result bitwise the plain reference's counts,
    best, found, normal and d."""
    res, counts, best = got
    for g, w in zip((counts, best, *res), want[:5], strict=True):
        _bitwise(g, w)


@pytest.mark.parametrize("kind", ["probes", "ties", "gated", "random"])
@pytest.mark.parametrize("scans,n,k", RANSAC_SHAPES)
def test_ransac_score_kernel_equals_plain(dev, kind, scans, n, k):
    """``ransac_hypotheses_score`` on the card (one launch) bitwise its
    plain version on the CPU, on points a few ulps either side of the
    threshold of a drawn plane, tied counts, degenerate draws and NaN
    coordinates on invalid rows; twice in a row, so the cached scratch and
    tickets are seen to reset themselves; and once more with the gated
    counts and the winner's index written.  Then ``plane_inliers`` with and
    without the refinement's select."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    args, thresh = _case_args(scans * 7 + k, scans, n, k, kind)
    cos_min = ransac.axis_cos_min(REFERENCE_YAML_CONFIG.eps_angle_radians)
    want = _score_plain(args, thresh, cos_min)
    on_card = [a.to(dev) for a in args]
    for _ in range(2):
        _build.reset_launch_counts()
        got = ransac.ransac_hypotheses_score(*on_card, thresh, cos_min)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"ransac_hypotheses_score": 1}
        for g, w in zip(got, want[2:5], strict=True):
            _bitwise(g, w)
    _same_score(_score_detail(on_card, thresh, cos_min), want)
    points, valid = args[:2]
    prev = torch.tensor(np.random.default_rng(k).random((scans, n)) < 0.5)
    n_inl = torch.tensor(np.random.default_rng(n).choice([0.0, 2.0, 3.0, 50.0], scans),
                         dtype=torch.float32)
    for kw in ({}, {"prev": prev, "n_inl": n_inl}):
        mask = ransac.plane_inliers(points.to(dev), valid.to(dev), want.normal.to(dev),
                                    want.d.to(dev), thresh,
                                    **{key: v.to(dev) for key, v in kw.items()})
        _bitwise(mask, ransac.plane_inliers_plain(points, valid, want.normal, want.d, thresh,
                                                  **kw))


@pytest.mark.parametrize("scans,n,k", [(1, 24_576, 128), (1, 200_000, 64), (2, 200_000, 40),
                                      (3, 200_000, 40)])
def test_ransac_score_forms_on_a_compacted_tail_equal_plain(dev, scans, n, k):
    """Each form of the score kernel, chosen by the call's rows (2 rows a
    thread at the first three shapes, 8 at the last), on a compacted
    cloud's invalid tail, whose warps skip the tests: bitwise the plain
    version."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    args, thresh = _case_args(n + k, scans, n, k, "probes", tail=True)
    cos_min = ransac.axis_cos_min(REFERENCE_YAML_CONFIG.eps_angle_radians)
    _same_score(_score_detail([a.to(dev) for a in args], thresh, cos_min),
                _score_plain(args, thresh, cos_min))


@pytest.mark.parametrize("scans", [1, 3, 32])
def test_ransac_round_launches_reads_and_memory(dev, scans):
    """One ``ransac_plane_once`` round on the card at the flagship's 24,576
    rows and K = 128: one score launch and 1 + ransac_refine_iters mask
    launches, no host read (sync debug mode "error"), a peak of new memory
    below one [B, N, K] float32 table, and the CPU's result bitwise."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    cfg = REFERENCE_YAML_CONFIG
    n = 24_576
    args, _ = _score_args(5, scans, n, 8, "probes")
    points, valid = args[0], args[1]
    points = torch.where(valid[..., None], points, 0.0)
    draws = torch.tensor(np.random.default_rng(1).integers(
        0, int(valid.sum(-1).min()), (scans, cfg.ransac_hypotheses, 3)))
    cloud = Cloud(points=points, valid=valid)
    want = ransac.ransac_plane_once(cloud, draws, cfg, vmapped=True)
    cloud_c, draws_c = cloud.to(dev), draws.to(dev)
    ransac.ransac_plane_once(cloud_c, draws_c, cfg, vmapped=True)  # the scratch, the allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ransac.ransac_plane_once(cloud_c, draws_c, cfg, vmapped=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ransac_hypotheses_score"] == 1
    assert _build.LAUNCHES["plane_inliers"] == 1 + cfg.ransac_refine_iters
    assert _build.LAUNCHES["fma_chain"] == 0
    assert torch.cuda.max_memory_allocated() - base < scans * n * cfg.ransac_hypotheses * 4
    for g, w in zip(got, want):
        _bitwise(g, w)


def _tensors(obj):
    """Every tensor of a result (NamedTuples and dataclasses), in order."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _tensors(v)


def _bitwise_nan(a, b):
    """``_bitwise``, but a NaN is any NaN (its payload is the device's own:
    a hypothesis through a NaN coordinate)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != torch.float32:
        return _bitwise(a, b)
    assert a.shape == b.shape
    nan = torch.isnan(b)
    _eq(torch.isnan(a), nan)
    _eq(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


# the round's shapes: flagship, fullscale (and band off), the batch of 32, the
# fullscale batch of 2; then rows off the tile, K past a warp, past a chunk
ROUND_SHAPES = [(1, 24_576, 128), (1, 262_144, 128), (32, 24_576, 128), (2, 262_144, 128),
                (3, 777, 200), (2, 1000, 1), (2, 300, 1100)]


def _round_args(seed, scans, n, k):
    """Seeded ``score_case`` clouds (NaN coordinates on invalid rows) with
    draws through the valid-first permutation; scan 1 (of two or more) has
    2 valid points, scan 2 none."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac
    from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases

    c = ransac_cases.score_case(seed, scans, n, k, "random")
    points, valid = torch.tensor(c["points"]), torch.tensor(c["valid"])
    if scans > 1:
        valid[1] = False
        valid[1, [5, n // 2]] = True
    if scans > 2:
        valid[2] = False
    n_valid = valid.sum(-1, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    u = torch.tensor((rng.random((scans, k, 3)) * np.maximum(n_valid.numpy(), 1)[:, None, None])
                     .astype(np.int64))
    perm = torch.sort(valid.to(torch.int8), dim=-1, descending=True, stable=True).indices
    return points, valid, ransac._gather(perm, u), n_valid


@pytest.mark.parametrize("eps", [REFERENCE_YAML_CONFIG.eps_angle_radians,
                                 REFERENCE_YAML_CONFIG.replace(
                                     pcl_compat_eps_angle_bug=False).eps_angle_radians],
                         ids=["radians", "degrees"])
@pytest.mark.parametrize("scans,n,k", ROUND_SHAPES)
def test_ransac_hypotheses_score_kernel_equals_plain(dev, scans, n, k, eps):
    """``ransac_hypotheses_score`` on the card (one launch: the hypotheses
    built, gated, scored and selected) bitwise its plain version on the CPU
    at the paths' shapes and off them, with scans of 0 and 2 valid points
    and both gate settings; twice, so the scratch is seen to reset; and
    each of its forms (rows a thread, slices) alike."""
    from pointcloud_obstacle_processing_tpu_torch.ops import f32, ransac

    points, valid, tri, n_valid = _round_args(n + k, scans, n, k)
    thresh, cos_min = f32(0.04), ransac.axis_cos_min(eps)
    want = _score_plain((points, valid, tri, n_valid), thresh, cos_min)
    on_card = [t.to(dev) for t in (points, valid, tri, n_valid)]
    forms = [None, None] + ([(2, 32), (2, 64), (2, 128), (8, 32), (8, 128)] if k == 128 else [])
    for form in forms:
        _build.reset_launch_counts()
        if form is None:
            got = ransac.ransac_hypotheses_score(*on_card, thresh, cos_min)
        else:
            res, counts, best = _score_detail(on_card, thresh, cos_min, form)
            _bitwise(counts, want.counts)
            _bitwise(best, want.best)
            got = res
        torch.cuda.synchronize()
        assert {key: v for key, v in _build.LAUNCHES.items() if v} == \
            {"ransac_hypotheses_score": 1}
        for g, w in zip(got, want[2:5], strict=True):
            _bitwise_nan(g, w)
    if scans > 2:
        assert not want.found[1:3].any()


def test_ransac_score_split_forms_agree_at_the_flagship_shape(dev):
    """The score kernel split over 1, 2 and 4 slices of hypotheses at the
    flagship's 24,576 rows (and 8 rows a thread in one slice of 32): one
    launch each, every form bitwise the plain version, counts and winner
    included (the probes' points a few ulps either side of the threshold
    of a drawn plane); the wrapper's own form alike."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    args, thresh = _case_args(24_576, 1, 24_576, 128, "probes")
    cos_min = ransac.axis_cos_min(REFERENCE_YAML_CONFIG.eps_angle_radians)
    want = _score_plain(args, thresh, cos_min)
    on_card = [a.to(dev) for a in args]
    for form in ((2, 128), (2, 64), (2, 32), (8, 32)):
        _build.reset_launch_counts()
        _same_score(_score_detail(on_card, thresh, cos_min, form), want)
        assert _build.LAUNCHES["ransac_hypotheses_score"] == 1
    for g, w in zip(ransac.ransac_hypotheses_score(*on_card, thresh, cos_min), want[2:5],
                    strict=True):
        _bitwise(g, w)


@pytest.mark.parametrize("scans,n", [(1, 24_576), (1, 262_144), (32, 24_576), (6, 3000)])
def test_plane_inliers_close_kernel_equals_plain(dev, scans, n):
    """The closing mask on the card (one launch, the state updated in place)
    bitwise its plain version on the CPU, on seeded round states: scans
    active or not, found or not, at plane slots 0 to ``max_planes`` (none
    free); the returned state is the one given."""
    from pointcloud_obstacle_processing_tpu_torch.ops import f32, ransac
    from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases

    rng = np.random.default_rng(n + scans)
    c = ransac_cases.score_case(n, scans, n, 8, "probes")
    points = torch.tensor(c["points"])
    mp = 4
    normal = torch.stack([torch.tensor(c[f][:, 0]) for f in ("nx", "ny", "nz")], -1)
    d = torch.tensor(c["ds"][:, 0])
    found = torch.tensor(rng.random(scans) < 0.8)
    active = torch.tensor(rng.random(scans) < 0.8)
    found[0] = active[0] = True
    state = ransac.RoundState(
        valid=torch.tensor(c["valid"]), union=torch.tensor(rng.random((scans, n)) < 0.3),
        last=torch.tensor(rng.random((scans, n)) < 0.3),
        coeffs=torch.tensor(rng.standard_normal((scans, mp, 4)).astype(np.float32)),
        pvalid=torch.tensor(rng.random((scans, mp)) < 0.5),
        i=torch.tensor(rng.integers(0, mp + 1, scans), dtype=torch.int32),
        found=torch.tensor(rng.random(scans) < 0.5))
    thresh = f32(0.04)
    want = ransac.plane_inliers_close_plain(points, normal, d, found, active, thresh, state)
    on_card = ransac.RoundState(*[t.to(dev) for t in state])
    _build.reset_launch_counts()
    got = ransac.plane_inliers_close(points.to(dev), normal.to(dev), d.to(dev), found.to(dev),
                                     active.to(dev), thresh, on_card)
    torch.cuda.synchronize()
    assert {key: v for key, v in _build.LAUNCHES.items() if v} == {"plane_inliers_close": 1}
    assert all(g is t for g, t in zip(got, on_card))
    for g, w in zip(got, want):
        _bitwise(g, w)
    assert want.last[0].any()


@pytest.mark.parametrize("scans", [1, 3])
def test_segment_planes_launches_a_round_on_the_card(dev, scans):
    """``segment_planes`` on the card at the flagship's 24,576 rows: each of
    the ``max_planes`` rounds one ``ransac_hypotheses_score`` launch,
    ``ransac_refine_iters`` masks (the winner's, then every refinement pass
    but the last) and one closing mask, the refinement's sums and tails,
    and no ``fma_chain``: the counts fixed from the known rounds; no host
    read; the CPU's result bitwise."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    cfg = REFERENCE_YAML_CONFIG
    args, _ = _score_args(9, scans, 24_576, 8, "random")
    valid = args[1]
    cloud = Cloud(points=torch.where(valid[..., None], args[0], 0.0), valid=valid)
    u = np.random.default_rng(2).random((scans, cfg.max_planes, cfg.ransac_hypotheses, 3))
    u = torch.tensor(u.astype(np.float32))
    want = ransac.segment_planes(cloud, cfg, draw_from_uniform(u))
    cloud_c, draw_c = cloud.to(dev), draw_from_uniform(u.to(dev))
    ransac.segment_planes(cloud_c, cfg, draw_c)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ransac.segment_planes(cloud_c, cfg, draw_c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rounds, iters = cfg.max_planes, cfg.ransac_refine_iters
    assert {key: v for key, v in _build.LAUNCHES.items() if v} == {
        "ransac_hypotheses_score": rounds, "plane_inliers": rounds * iters,
        "plane_inliers_close": rounds, "xla_sum": rounds * iters,
        "covariance_tail": rounds * iters}
    for g, w in zip(_tensors(got), _tensors(want), strict=True):
        _bitwise(g, w)
    assert int(want.planes.num_planes.sum()) >= 1


def test_fma_chain_plan_cache_strides_pointers_and_constants(dev):
    """The chain wrapper's cached plans: two calls with the same shapes and
    other strides (a plan each), the same layout on new tensors (new
    pointers) and with another constant (new bits); every call one launch,
    bitwise the plain form."""
    from pointcloud_obstacle_processing_tpu_torch import ops

    g = torch.Generator().manual_seed(12)

    def r(*s):
        return torch.randn(*s, generator=g)

    a = r(48, 64)
    calls = [(a, r(64, 64)[:48], r(48, 64)), (a, r(64, 48).T, r(48, 64)),
             (r(48, 64), r(64, 48).T, r(48, 64)), (r(48, 64), r(64, 48).T, r(48, 64)),
             (r(48, 64), ops.f32(0.5), ops.f32(0.25)), (r(48, 64), ops.f32(-3.0), ops.f32(7.5)),
             (r(48, 64)[:, 1:], ops.f32(-3.0), r(48, 63))]
    for operands in calls:
        want = ops.fma(*operands)
        before = _build.LAUNCHES["fma_chain"]
        got = ops.fma(*[t.to(dev) if t.dim() else t for t in operands])
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fma_chain"] == before + 1
        _eq(got.view(torch.int32), want.view(torch.int32))
    for kind, args in (("dot3", [r(2, 300, 1)] * 3 + [r(2, 1, 128)] * 3),
                       ("dot3", [r(2, 300, 1)] * 3 + [r(128, 2).T[:, None, :]] * 3)):
        _eq(getattr(ops, kind)(*[t.to(dev) for t in args]).view(torch.int32),
            getattr(ops, kind)(*args).view(torch.int32))


def _raster_lines(kind: str, seed: int = 0):
    """[scans, M, 7] lines for the raster kernel: ``edges`` lines of every
    slope whose ends lie in and around the 120 x 101 grid, crossing many
    16 x 16 tiles; ``crowded`` 300 lines through one tile; ``slots`` the
    seeded batch's own slot lines."""
    rng = np.random.default_rng(seed)
    if kind == "slots":
        from pointcloud_obstacle_processing_tpu_torch.ops import shadow

        args, tf = _shadow_case("batch")
        return shadow.shadow_slots_plain(*args, tf, REFERENCE_YAML_CONFIG)
    m = 300 if kind == "crowded" else 64
    lo, hi = ((-20, 140) if kind == "edges" else (40, 60))
    ends = rng.integers(lo, hi, (4, m, 4)).astype(np.int32)
    if kind == "crowded":
        ends[..., 2:] = ends[..., :2] + rng.integers(-3, 4, (4, m, 2))
    n = rng.integers(1, 12, (4, m, 1)).astype(np.int32)
    flags = np.concatenate([rng.integers(0, 2, (4, m, 1)), rng.random((4, m, 1)) < 0.9], -1)
    lines = np.concatenate([ends, n, flags.astype(np.int32)], -1)
    return torch.tensor(lines)


@pytest.mark.parametrize("kind", ["edges", "crowded", "slots"])
def test_shadow_raster_tiles_equal_plain(dev, kind):
    """The raster kernel's per-tile cull (each 8 x 16 tile tests only the
    lines whose box meets it) on lines that cross tile edges, 300 lines in
    one tile and the seeded batch's slot lines: one launch, bitwise its
    plain twin."""
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    lines = _raster_lines(kind)
    h, w = REFERENCE_YAML_CONFIG.grid_height, REFERENCE_YAML_CONFIG.grid_width
    grid = torch.tensor(np.random.default_rng(5).choice([0, 100], (lines.shape[0], h, w))
                        .astype(np.int8))
    want = shadow.shadow_raster_plain(grid, lines, 9)
    before = _build.LAUNCHES["shadow_raster"]
    got = shadow.shadow_raster(grid.to(dev), lines.to(dev), 9)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["shadow_raster"] == before + 1
    _eq(got, want)
    assert (want == 9).any()
