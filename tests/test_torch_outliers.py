"""Kernel K3 (banded k-select) and statistical outlier removal of the
PyTorch port against the JAX package.

Bar: mean distances within 5e-5 relative, keep masks identical, on
random clouds.  The port evaluates the distance as XLA:CPU evaluates the
reference's (|p|^2 and the cross term as its fused multiply-add chains, the
mean in its order with correctly rounded roots), so on a cloud whose
centering sums are exact in any order the mean distances are bitwise the
reference's (``test_knn_probe_is_bitwise_the_reference``).  The bar dates
from when the centering sums reduced in another order in torch (the
expanded d2 turns one ulp of the center into up to about |p|^2 * 2^-23 of
absolute error: 4.13e-5 relative at most over the cases below); the
centering and the gate's sums now run in XLA:CPU's order
(``ops.sum_like_xla``, held to ``jnp.sum`` below).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_torch_cuda import fma32

import jax.numpy as jnp

import pointcloud_obstacle_processing_tpu.ops.outliers as ref_outliers
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import f32, outliers, sum_like_xla

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
    got = outliers.knn_select_plain(pch, p_sq, v, starts, rt, width).numpy()
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
    """The two shapes the banded kNN once refused now run as the reference
    runs them, bitwise: a band that covers the buffer (the full-width
    branch, ``kmin_mean`` over every column) and k > 16 (the in-window
    ``kmin_mean`` in place of the sorting network)."""
    pts, valid = _lattice_cloud(1, 100, 256)
    for k, row_tile, band in ((15, 128, 128), (20, 32, 32)):
        want = np.asarray(_ref(pts, valid, k, 1.0, row_tile, band).mean_distances)
        got = outliers.knn_mean_distances(Cloud.from_points(pts, valid), k, row_tile=row_tile,
                                          band=band).numpy()
        np.testing.assert_array_equal(got, want)


# --- kernel K3's selection schedule, modelled in numpy ----------------------


def _window_d2(pch, p_sq, valid, starts, rt, width):
    """[n_q, W] squared distances of every query to its tile's window
    columns (the plain version's float32 tree), +inf for invalid columns,
    and the [n_q, W] self-column mask."""
    x, y, z, sq = (t.numpy() for t in (*pch, p_sq))
    n = len(sq)
    tiles = len(starts)
    n_q = tiles * rt
    pad = lambda a: np.pad(a, (0, n_q - n))  # noqa: E731
    qx, qy, qz, qsq = (pad(a)[:, None] for a in (x, y, z, sq))
    cols = (starts.numpy().astype(np.int64)[:, None] + np.arange(width)).repeat(rt, 0)
    cross = fma32(qz, z[cols], fma32(qx, x[cols], qy * y[cols]))
    d2 = np.maximum((qsq + sq[cols]) - np.float32(2.0) * cross, np.float32(0))
    d2 = np.where(valid.numpy()[cols], d2, np.float32(np.inf)).astype(np.float32)
    return d2, cols == np.arange(n_q)[:, None]


def _insert(top, rows, v, limit):
    """Insert v[i] into the sorted list top[rows[i]] where v[i] < limit[i]."""
    hit = v < limit
    r = rows[hit]
    top[r] = np.sort(np.concatenate([top[r, :15], v[hit, None]], 1), 1)


def _kernel_order_select(d2, is_self, starts, rt, width, chunk, local, skip=True, groups=1):
    """The 16 smallest of each row of ``d2`` as kernel K3 selects them: the
    ``local`` rank-neighbour columns first, then each chunk of the window,
    centre-out; column j of either goes to group j mod ``groups``, whose
    list takes a value only below its own 16th and below the bound the
    kernel derives (the largest of the groups' 4th values, published after
    the rank neighbours and at each chunk); the groups' lists merge at the
    end (vectorized over queries).  ``skip``:
    invalid and self columns are never inserted (the kernel); otherwise
    they enter as ``BIG`` (the plain version's values)."""
    big = np.float32(outliers.BIG)
    n_q = d2.shape[0]
    d2 = d2.copy()
    if not skip:
        d2[~np.isfinite(d2) | is_self] = big
    else:
        d2[is_self] = np.inf
    own_col = np.arange(n_q) - starts.numpy().repeat(rt)
    lo = np.clip(own_col - local // 2, 0, width - local)
    top = np.full((groups, n_q, 16), big, np.float32)
    seen = np.zeros_like(d2, dtype=bool)
    every = np.arange(n_q)
    for j in range(local):
        seen[every, lo + j] = True
        _insert(top[j % groups], every, d2[every, lo + j], top[j % groups][:, 15])
    up = lambda b: np.nextafter(b, np.float32(np.inf))  # noqa: E731
    cap = np.full((groups, n_q), np.inf, np.float32)
    if groups > 1:
        cap[:] = up(top[:, :, 3].max(axis=0))
    for t in range(len(starts)):
        rows = np.arange(t * rt, (t + 1) * rt)
        for c, (b, e) in enumerate(outliers.centre_out_chunks(t * rt - int(starts[t]), width, rt, chunk)):
            if c and groups > 1:
                cap[:, rows] = np.minimum(cap[:, rows], up(top[:, rows, 3].max(axis=0)))
            for g in range(groups):
                for j in range(b + g, e, groups):
                    v = np.where(seen[rows, j], np.inf, d2[rows, j])
                    _insert(top[g], rows, v, np.minimum(top[g][rows, 15], cap[g, rows]))
    return np.sort(top.transpose(1, 0, 2).reshape(n_q, -1), 1)[:, :16].T


def _tie_cloud(seed, n_valid, n):
    """Lattice-ordered points on a coarse grid with every point doubled:
    many equal distances, and an exact duplicate (d2 = 0) for each."""
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 6, (n_valid // 2, 3)) * np.float32(0.25)).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts = pts[np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))]
    buf = np.zeros((n, 3), np.float32)
    buf[:len(pts)] = pts
    return buf, np.arange(n) < len(pts)


def _k3_inputs(kind, seed, n_valid, n, rt, band):
    pts, valid = (_tie_cloud if kind == "ties" else _lattice_cloud)(seed, n_valid, n)
    if kind == "sparse":  # few valid columns: fewer than k neighbours, BIG left over
        valid = valid & (np.random.default_rng(seed).random(n) < 0.02)
    v = torch.tensor(valid)
    p = torch.tensor(pts)
    pch = [torch.where(v, p[:, c], 0.0) for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // rt)
    width = rt + 2 * band
    return pch, p_sq, v, outliers.band_starts(n, rt, band, tiles, "cpu"), width


K3_ORDER_CASES = [
    ("random", 21, 900, 1024, 128, 64, 32, 32, 1),
    ("random", 21, 900, 1024, 128, 64, 32, 32, 4),
    ("ties", 22, 600, 1024, 128, 96, 32, 16, 4),
    ("sparse", 23, 1024, 1024, 128, 64, 64, 32, 1),
    ("sparse", 23, 1024, 1024, 128, 64, 64, 32, 4),
    ("random", 24, 700, 1000, 96, 80, 48, 8, 4),  # a padded query tail; ragged chunks
]


@pytest.mark.parametrize("kind,seed,n_valid,n,rt,band,chunk,local,groups", K3_ORDER_CASES)
def test_kernel_order_selection_is_the_plain_sorted_16(kind, seed, n_valid, n, rt, band, chunk,
                                                       local, groups):
    """Selecting in kernel K3's order and with its bounds (rank neighbours
    first, then the window centre-out over one or four column groups,
    inserting only below the 16th and the bounds, the groups' lists merged
    at the end) gives the plain version's sorted 16, with ties, fewer than
    k valid columns and BIG left over; the tiles with no valid query aside
    (the kernel skips them)."""
    pch, p_sq, v, starts, width = _k3_inputs(kind, seed, n_valid, n, rt, band)
    want = outliers.knn_select_plain(pch, p_sq, v, starts, rt, width).numpy()
    d2, is_self = _window_d2(pch, p_sq, v, starts, rt, width)
    got = _kernel_order_select(d2, is_self, starts, rt, width, chunk, local, groups=groups)
    live = np.repeat(outliers._tile_live(v, len(starts), rt).numpy(), rt)
    np.testing.assert_array_equal(got[:, live], want[:, live])
    big = np.float32(outliers.BIG)
    assert (want[:, ~live] == big).all()
    if kind == "sparse":
        assert ((want[14] == big) & live).any()  # fewer than 15 valid neighbours
    if kind == "ties":
        assert ((np.diff(want[:, :600], axis=0) == 0) & (want[1:, :600] < big)).sum() > 1000


@pytest.mark.parametrize("kind,seed,n_valid,n,rt,band,chunk,local,groups", K3_ORDER_CASES)
def test_skipping_invalid_and_self_columns_changes_nothing(kind, seed, n_valid, n, rt, band,
                                                           chunk, local, groups):
    """Never inserting invalid and self columns (the kernel) gives the same
    sorted 16 and the same mean as entering them as BIG (the plain version):
    BIG is never below the 16th value, which starts at BIG."""
    pch, p_sq, v, starts, width = _k3_inputs(kind, seed, n_valid, n, rt, band)
    d2, is_self = _window_d2(pch, p_sq, v, starts, rt, width)
    skipped = _kernel_order_select(d2, is_self, starts, rt, width, chunk, local, True, groups)
    as_big = _kernel_order_select(d2, is_self, starts, rt, width, chunk, local, False, groups)
    np.testing.assert_array_equal(skipped, as_big)
    for k in (15, 8):
        np.testing.assert_array_equal(
            outliers.mean_from_sorted(torch.tensor(skipped), k).numpy(),
            outliers.mean_from_sorted(torch.tensor(as_big), k).numpy())


def _fused_mean(vals, k):
    """Kernel K3's fused mean in numpy: the roots of the rows below half,
    ascending, summed one at a time in float32; the count as float32; one
    division by max(count, 1)."""
    half = np.float32(outliers.BIG * 0.5)
    s = np.zeros(vals.shape[1], np.float32)
    cnt = np.zeros_like(s)
    for i in range(min(k, 16)):
        take = vals[i] < half
        root = np.sqrt(vals[i].astype(np.float64)).astype(np.float32)
        s = np.where(take, s + root, s).astype(np.float32)
        cnt = np.where(take, cnt + np.float32(1), cnt).astype(np.float32)
    return s / np.maximum(cnt, np.float32(1))


@pytest.mark.parametrize(
    "n_valid,n,row_tile,band,k",
    [(3000, 4096, 512, 512, 15), (6000, 8192, 384, 512, 15), (2500, 4096, 256, 256, 8),
     (1000, 2048, 384, 256, 15), (700, 1024, 128, 192, 15)],
)
def test_fused_plain_mean_is_the_reference_mean(n_valid, n, row_tile, band, k):
    """The plain mean (``knn_mean_plain``) and the kernel's fused form of
    it are bitwise the reference's ``_sortnet_mean_from_sorted`` on the
    same sorted 16, on the clouds of the cases above."""
    pts, valid = _lattice_cloud(n_valid, n_valid, n)
    v = torch.tensor(valid)
    p = torch.tensor(pts)
    pch = [torch.where(v, p[:, c], 0.0) for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-n // row_tile)
    starts = outliers.band_starts(n, row_tile, band, tiles, "cpu")
    width = row_tile + 2 * band
    vals = outliers.knn_select_plain(pch, p_sq, v, starts, row_tile, width)
    got = outliers.knn_mean_plain(pch, p_sq, v, starts, row_tile, width, k).numpy()
    want = np.asarray(jax.jit(lambda a: ref_outliers._sortnet_mean_from_sorted(
        a, k, float(np.float32(outliers.BIG))))(jnp.asarray(vals.numpy())))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_fused_mean(vals.numpy(), k), want)


def _distances_as_x(monkeypatch, module):
    """Make ``module.remove_statistical_outliers`` read its kNN mean
    distances from the cloud's x column, so a test feeds the gate its
    distances directly."""
    monkeypatch.setattr(module, "knn_mean_distances", lambda cloud, *a, **kw: cloud.points[:, 0])


@jax.jit
def _ref_gate_inputs(d, valid):
    """The reference gate's n, s2 and mu (``ops/outliers.py``
    ``remove_statistical_outliers``), jitted apart from its tail."""
    valid_f = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(valid_f), 2.0)
    return n, jnp.sum(d * d * valid_f), jnp.sum(d * valid_f) / n


# offsets of the probe distances from the threshold, in float32 ulps
GATE_PROBE_OFFSETS = (-8, -2, -1, 0, 1, 2, 8)


def test_gate_threshold_tail_is_bitwise_the_reference(monkeypatch):
    """The gate's tail on the reference's own n, s2 and mu, over 48 clouds of
    24,576 gamma-distributed distances (90% valid; the flagship's voxel
    slots) and four multipliers: ``gate_threshold`` equals the threshold
    of the reference's jitted ``remove_statistical_outliers`` bit for bit,
    so distances at the threshold and 1, 2 and 8 ulps either side are kept
    exactly where the reference keeps them.  The unfused tail (each product
    rounded, torch's root) gives another threshold in some clouds and
    decides some of those probes the other way."""
    _distances_as_x(monkeypatch, ref_outliers)
    rng = np.random.default_rng(31)
    n_pts = 24_576
    unfused_apart = unfused_miss = 0
    for i in range(48):
        mult = (1.0, 4.0, 1.7, 2.3)[i % 4]
        d = rng.gamma(2.0, 0.01, n_pts).astype(np.float32)
        valid = rng.random(n_pts) < 0.9
        pts = np.zeros((n_pts, 3), np.float32)
        pts[:, 0] = d
        ref = jax.jit(lambda c, m=mult: ref_outliers.remove_statistical_outliers(c, 15, m))(
            RefCloud.from_points(pts, valid))
        n, s2, mu = (torch.tensor(np.asarray(x)) for x in _ref_gate_inputs(d, valid))
        got = outliers.gate_threshold(n, s2, mu, mult)
        want = np.asarray(ref.threshold)
        assert got.numpy().view(np.int32) == want.view(np.int32)
        probes = (want.view(np.int32) + np.array(GATE_PROBE_OFFSETS, np.int32)).view(np.float32)
        np.testing.assert_array_equal((torch.tensor(probes) <= got).numpy(),
                                      np.asarray(jnp.asarray(probes) <= ref.threshold))
        var = torch.clamp_min((s2 - n * mu * mu) / (n - 1.0), 0.0)
        unfused = mu + f32(mult) * torch.sqrt(var)
        unfused_apart += int(((torch.tensor(probes) <= unfused).numpy() != (probes <= want)).any())
        unfused_miss += int(unfused.numpy().view(np.int32) != want.view(np.int32))
    print(f"unfused gate tail: another threshold in {unfused_miss} of 48 clouds, "
          f"a probe decided the other way in {unfused_apart}")
    assert unfused_apart > 0


@pytest.mark.parametrize("mult", [1.0, 4.0, 1.7, 2.3])
def test_outlier_gate_is_bitwise_the_reference_on_exact_sums(monkeypatch, mult):
    """The whole gate, both packages' ``remove_statistical_outliers`` fed
    the same distances: multiples of 1/64 below 1 on 1,024 slots (95%
    valid), whose sums are exact in any order, so the threshold depends on
    the tail alone.  Thresholds and keep masks are bitwise equal on 50
    clouds; the unfused tail misses the threshold on some."""
    _distances_as_x(monkeypatch, ref_outliers)
    _distances_as_x(monkeypatch, outliers)
    ref_gate = jax.jit(lambda c: ref_outliers.remove_statistical_outliers(c, 15, mult))
    rng = np.random.default_rng(int(mult * 10))
    n_pts = 1024
    unfused_apart = 0
    for _ in range(50):
        d = (np.minimum(rng.gamma(2.0, 6.0, n_pts), 63).astype(np.int32) / 64).astype(np.float32)
        valid = rng.random(n_pts) < 0.95
        pts = np.zeros((n_pts, 3), np.float32)
        pts[:, 0] = d
        r = ref_gate(RefCloud.from_points(pts, valid))
        p = outliers.remove_statistical_outliers(Cloud.from_points(pts, valid), 15, mult)
        want = np.asarray(r.threshold)
        assert p.threshold.numpy().view(np.int32) == want.view(np.int32)
        np.testing.assert_array_equal(p.cloud.valid.numpy(), np.asarray(r.cloud.valid))
        vf, dt = torch.tensor(valid, dtype=torch.float32), torch.tensor(d)
        n = torch.clamp_min(vf.sum(), 2.0)
        s2, mu = (dt * dt * vf).sum(), (dt * vf).sum() / n
        var = torch.clamp_min((s2 - n * mu * mu) / (n - 1.0), 0.0)
        unfused = mu + f32(mult) * torch.sqrt(var)
        unfused_apart += int(unfused.numpy().view(np.int32) != want.view(np.int32))
    print(f"unfused gate tail, multiplier {mult}: another threshold in {unfused_apart} of 50")
    assert unfused_apart > 0


@pytest.mark.parametrize("shape", [(5,), (32,), (33,), (1000,), (24_576,), (100_352,),
                                   (262_144,), (3, 8192)])
def test_sum_like_xla_is_jnp_sum(shape):
    """``ops.sum_like_xla`` against XLA:CPU's jitted ``jnp.sum`` over the
    last axis, bitwise, on 10 seeded vectors a shape at three scales
    (lengths around and far from multiples of the 32-wide window; a batch
    of rows as ``jax.vmap`` reduces them); torch's own ``sum`` takes
    another order and misses on some (printed under ``-s``)."""
    rng = np.random.default_rng(len(shape) * 7 + shape[-1] % 97)
    ref_sum = jax.jit(lambda x: jnp.sum(x, axis=-1))
    torch_miss = 0
    for i in range(10):
        x = (rng.random(shape) * (1.0, 100.0, 1e-3)[i % 3]).astype(np.float32)
        want = np.asarray(ref_sum(x))
        got = sum_like_xla(torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        torch_miss += int((torch.tensor(x).sum(-1).numpy() != want).any())
    print(f"torch sum over {shape}: another value in {torch_miss} of 10")


@pytest.mark.parametrize("shape", [(5,), (32,), (33,), (1000,), (24_576,), (100_352,),
                                   (262_144,), (3, 8192)])
def test_sum_like_xla_of_products_is_jnp_sum(shape):
    """The two-operand form, ``sum_like_xla(a, b)``, against XLA:CPU's
    jitted ``jnp.sum(a * b)`` over the last axis, bitwise, on 10 seeded
    pairs a shape (as RANSAC's covariance sums them): above 32 values the
    product is rounded before the windows add it, up to 32 it is fused into
    the plain reduce's adds.  The rounded product in the short form misses
    on some (printed under ``-s``)."""
    rng = np.random.default_rng(shape[-1] % 89 + 3)
    ref_sum = jax.jit(lambda a, b: jnp.sum(a * b, axis=-1))
    short_miss = 0
    for i in range(10):
        a = (rng.random(shape) * (1.0, 100.0, 1e-3)[i % 3] - 0.3).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(ref_sum(a, b))
        got = sum_like_xla(torch.tensor(a)[..., None, :], torch.tensor(b)[..., None, :])
        np.testing.assert_array_equal(got[..., 0, 0].numpy().view(np.int32), want.view(np.int32))
        unfused = sum_like_xla(torch.tensor(a * b)).numpy()
        short_miss += int((unfused != want).any())
    print(f"rounded products summed over {shape}: another value in {short_miss} of 10")


def test_gate_sums_are_bitwise_the_reference(monkeypatch):
    """The whole gate on the reference's flagship-sized input: 48 clouds of
    24,576 gamma-distributed distances (90% valid), both packages'
    ``remove_statistical_outliers`` fed the same distances.  ``s1``,
    ``s2``, the threshold and the kept mask are bitwise the reference's
    jitted function's (C4: the sums in XLA:CPU's order); torch's own
    ``sum`` gives another ``s1`` or ``s2`` in some clouds (printed)."""
    _distances_as_x(monkeypatch, ref_outliers)
    _distances_as_x(monkeypatch, outliers)
    rng = np.random.default_rng(47)
    n_pts = 24_576
    ref_sums = jax.jit(lambda d, v: (jnp.sum(d * v.astype(jnp.float32)),
                                     jnp.sum(d * d * v.astype(jnp.float32))))
    torch_miss = 0
    for i in range(48):
        mult = (1.0, 4.0, 1.7, 2.3)[i % 4]
        d = rng.gamma(2.0, 0.01, n_pts).astype(np.float32)
        valid = rng.random(n_pts) < 0.9
        pts = np.zeros((n_pts, 3), np.float32)
        pts[:, 0] = d
        ref = jax.jit(lambda c, m=mult: ref_outliers.remove_statistical_outliers(c, 15, m))(
            RefCloud.from_points(pts, valid))
        got = outliers.remove_statistical_outliers(Cloud.from_points(pts, valid), 15, mult)
        _, s1, s2 = outliers.gate_sums(torch.tensor(d), torch.tensor(valid))
        w1, w2 = (np.asarray(x) for x in ref_sums(d, valid))
        assert s1.numpy().view(np.int32) == w1.view(np.int32)
        assert s2.numpy().view(np.int32) == w2.view(np.int32)
        assert got.threshold.numpy().view(np.int32) == np.asarray(ref.threshold).view(np.int32)
        np.testing.assert_array_equal(got.cloud.valid.numpy(), np.asarray(ref.cloud.valid))
        vf, dt = torch.tensor(valid, dtype=torch.float32), torch.tensor(d)
        torch_miss += int((dt * vf).sum().item() != w1 or (dt * dt * vf).sum().item() != w2)
    print(f"torch sum: another s1 or s2 in {torch_miss} of 48 clouds")


def test_gate_and_ransac_decisions_match_the_reference_on_20_scenes():
    """C4's decision count: 20 seeded flagship-shaped scenes (the crosscheck
    scene of ``tests/test_torch_pipeline.py`` at its small config, scene
    and key seeds 0-19) through both packages' whole pipeline, the
    reference's RANSAC key chain replayed.  The scans whose outlier gate
    keeps another set, or whose RANSAC rounds take other inliers (every
    plane, the last plane, what remains), are counted: none.  The plane
    coefficients are bitwise the reference's in every scene (the
    refinement's sums in XLA:CPU's order, its 3x3 tail as XLA:CPU fuses
    it, and the voxel keys as XLA:CPU divides by the leaf)."""
    import dataclasses

    from test_torch_pipeline import CFG, SPEC
    from test_torch_ransac import jax_key_chain_draw

    import pointcloud_obstacle_processing_tpu as ref
    from pointcloud_obstacle_processing_tpu.pipeline import jit_pipeline
    from pointcloud_obstacle_processing_tpu.utils.scene import make_scene

    import pointcloud_obstacle_processing_tpu_torch as port
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan

    run_ref = jit_pipeline(CFG)
    sets = {"outlier_filtered_cloud": 0, "plane_cloud": 0, "last_plane_cloud": 0,
            "nonplane_cloud": 0}
    other_coeffs = 0
    n = CFG.max_points
    for seed in range(20):
        pts = make_scene(seed=seed, spec=SPEC, nan_frac=0.01).points[:n]
        buf = np.zeros((n, 3), np.float32)
        buf[: len(pts)] = pts
        valid = np.arange(n) < len(pts)
        key = jax.random.PRNGKey(seed)
        r = run_ref(ref.Cloud.from_points(buf, valid), key)
        st = port.from_reference(dataclasses.asdict(CFG), buf, valid, device="cpu")
        p = process_scan(st.cloud, st.config,
                         draw=jax_key_chain_draw(key, CFG.ransac_hypotheses))
        for name in sets:
            sets[name] += int((np.asarray(getattr(r, name).valid)
                               != getattr(p, name).valid.numpy()).any())
        other_coeffs += int((np.asarray(r.planes.coeffs) != p.planes.coeffs.numpy()).any())
    print(f"scans of 20 with another kept or inlier set: {sets}; with other plane "
          f"coefficients: {other_coeffs}")
    assert sets == dict.fromkeys(sets, 0)
    assert other_coeffs == 0
