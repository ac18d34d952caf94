"""The banded cluster sweep of the PyTorch port (kernel K5's plain version,
``band_starts``, frontier gating, the window-unlimited jump) against the JAX
package on the CPU.

Bar: window starts, the overflow flag, sweep outputs, labels, slots, sizes
and every flag exact.  The scenes are those of tests/test_cluster.py, with
coordinates rounded to a dyadic grid fine enough to keep every centering
sum exact in any order, so both packages center identically.  The JAX
package runs its XLA sweep here, which ignores frontier gating; the port
gates on every device, so these cases also hold the gated loop against
ungated labels.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import (
    TOL2_PROBE_OFFSETS,
    cross_term_pairs,
    d2_unfused_cross,
    near_threshold_pairs,
)

from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import cluster as ref_cluster

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import cluster


def _dyadic(pts):
    """Round to the finest 2^-b grid (b <= 10) on which a sum over all
    points is exact in float32."""
    mag = float(np.abs(pts).max()) * len(pts) + 1.0
    bits = min(10, 23 - math.ceil(math.log2(mag)))
    return (np.round(pts * 2.0**bits) / 2.0**bits).astype(np.float32)


def _blob_scene(rng, centers, n_per=100, sigma=0.05):
    pts = np.concatenate(
        [rng.normal(c, sigma, size=(n_per, 3)) for c in centers]
    ).astype(np.float32)
    return pts[rng.permutation(len(pts))]


def _lattice_sorted(pts, leaf=0.05):
    q = np.floor(pts / leaf).astype(np.int64)
    return pts[np.lexsort((q[:, 2], q[:, 1], q[:, 0]))]


def _scene(name):
    """(points, [(capacity, band_window), ...]) of tests/test_cluster.py's
    banded cases, drawn as its ``rng`` fixture draws them."""
    rng = np.random.default_rng(1234)
    if name == "band_matches_full":
        centers = [(0, 0, 0), (1.5, 0.2, 0), (3, 0.5, 0), (3.2, 3, 1), (0.5, 3, 0)]
        return _lattice_sorted(_blob_scene(rng, centers, n_per=120)), [(640, 512)]
    if name == "wide_component":
        n_chain = 560
        xs = np.cumsum(rng.uniform(0.05, 0.12, n_chain)).astype(np.float32)
        chain = np.stack([xs, np.zeros(n_chain), np.zeros(n_chain)], 1)
        blob = rng.normal(0, 0.1, (80, 3)).astype(np.float32) + np.array(
            [xs.max() + 5.0, 0, 0], np.float32)
        pts = np.concatenate([chain, blob]).astype(np.float32)
        return pts[np.argsort(pts[:, 0], kind="stable")], [(640, 384)]
    if name == "overflow":
        xs = np.linspace(0, 0.5, 256)
        return np.stack([xs, np.zeros(256), np.zeros(256)], axis=1).astype(np.float32), [(256, 128)]
    assert name == "padding"
    pts = _blob_scene(rng, [(0, 0, 0), (1.5, 0.2, 0), (3.2, 1.0, 0)], n_per=120)
    return pts[np.argsort(pts[:, 0], kind="stable")], [(512, 128), (2048, 128)]


def _run_both(pts, capacity, band_window, max_clusters=16):
    ref_cloud = RefCloud.pad_to(pts, capacity)
    r = jax.jit(lambda c: ref_cluster.euclidean_cluster(
        c, 0.4, 5, 20000, max_clusters, band_window=band_window))(ref_cloud)
    p = cluster.euclidean_cluster(Cloud.pad_to(pts, capacity), 0.4, 5, 20000, max_clusters,
                                  band_window=band_window)
    return r, p


def _assert_same(r, p):
    np.testing.assert_array_equal(np.asarray(r.labels), p.labels.numpy())
    np.testing.assert_array_equal(np.asarray(r.root_slot), p.root_slot.numpy())
    for f in ("point_cluster", "sizes", "valid", "num_clusters"):
        np.testing.assert_array_equal(np.asarray(getattr(r.clusters, f)),
                                      getattr(p.clusters, f).numpy())
    for f in ("overflow", "band_overflow", "unconverged"):
        assert bool(getattr(r, f)) == bool(getattr(p, f)), f


@pytest.mark.parametrize("name", ["band_matches_full", "wide_component", "overflow", "padding"])
def test_banded_clusters_match_reference(name):
    pts, cases = _scene(name)
    pts = _dyadic(pts)
    outs = []
    for capacity, band_window in cases:
        r, p = _run_both(pts, capacity, band_window)
        _assert_same(r, p)
        outs.append(p)
    if name == "overflow":
        assert bool(outs[0].band_overflow)
    elif name == "padding":  # snug and padded capacities give the same clusters
        snug, padded = outs
        np.testing.assert_array_equal(snug.clusters.sizes.numpy(), padded.clusters.sizes.numpy())
        n = len(pts)
        np.testing.assert_array_equal(snug.clusters.point_cluster.numpy()[:n],
                                      padded.clusters.point_cluster.numpy()[:n])
        assert (padded.clusters.point_cluster.numpy()[n:] == -1).all()
    else:  # the band covers every edge: the full sweep's components
        assert not bool(outs[0].band_overflow)
        capacity = cases[0][0]
        full = cluster.euclidean_cluster(Cloud.pad_to(pts, capacity), 0.4, 5, 20000, 16)
        np.testing.assert_array_equal(full.labels.numpy(), outs[0].labels.numpy())


def test_frontier_gating_leaves_labels_unchanged(monkeypatch):
    """The gated loop (converged tiles write their labels through) ends in
    the labels of the loop that computes every tile, and does skip tiles."""
    pts, [(capacity, band_window)] = _scene("wide_component")
    cloud = Cloud.pad_to(_dyadic(pts), capacity)
    gated = cluster.euclidean_cluster(cloud, 0.4, 5, 20000, 8, band_window=band_window)

    plain = cluster.sweep_jump_banded
    skipped = []

    def ungated(p, valid, labels, tol2, tile, window, starts, tile_live=None):
        skipped.append(int((~tile_live).sum()))
        return plain(p, valid, labels, tol2, tile, window, starts, None)

    monkeypatch.setattr(cluster, "sweep_jump_banded", ungated)
    full = cluster.euclidean_cluster(cloud, 0.4, 5, 20000, 8, band_window=band_window)
    np.testing.assert_array_equal(gated.labels.numpy(), full.labels.numpy())
    np.testing.assert_array_equal(gated.clusters.sizes.numpy(), full.clusters.sizes.numpy())
    assert skipped[0] == 0 and sum(skipped) > 0, skipped


def _lattice_cloud(seed, n, n_valid, spread=4.0):
    """Centered, x-sorted points with an invalid tail parked at 0, plus
    labels that name an earlier point (as the sweep loop keeps them)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-spread / 2, -1.5, -0.3], [spread / 2, 1.5, 0.3], (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = np.arange(n) < n_valid
    pts[~valid] = 0.0
    labels = np.arange(n, dtype=np.int32)
    labels[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    return pts, valid, labels


@pytest.mark.parametrize(
    "seed,n,n_valid,window,spread,overflow",
    [
        (0, 640, 600, 512, 4.0, False),
        (1, 1024, 700, 256, 8.0, True),  # three all-padding tiles; a dense middle
        (2, 256, 256, 128, 0.5, True),  # every tile's edges span the buffer
        (3, 2048, 1900, 384, 20.0, False),
    ],
)
def test_band_starts_match_reference(seed, n, n_valid, window, spread, overflow):
    pts, valid, _ = _lattice_cloud(seed, n, n_valid, spread)
    ws, wo = ref_cluster._band_starts(jnp.asarray(pts), jnp.asarray(valid), 128, window, 0.4)
    gs, go = cluster.band_starts(torch.tensor(pts), torch.tensor(valid), 128, window, 0.4)
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    assert gs.dtype == torch.int32
    assert bool(wo) == bool(go)
    assert bool(go) == overflow


@pytest.mark.parametrize("seed,n,n_valid,window", [(4, 640, 600, 256), (5, 1024, 900, 384)])
def test_banded_sweep_plain_matches_reference_xla_sweep(seed, n, n_valid, window):
    """One banded sweep on identical inputs: the XLA twin's contract; with
    a tile_live mask, the skipped tiles carry their labels through."""
    pts, valid, labels = _lattice_cloud(seed, n, n_valid)
    starts, _ = cluster.band_starts(torch.tensor(pts), torch.tensor(valid), 128, window, 0.4)
    want = np.asarray(jax.jit(
        lambda a, b, c, s: ref_cluster._xla_sweep_jump_banded(a, b, c, 0.16, 128, window, s)
    )(jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(labels), jnp.asarray(starts.numpy())))
    args = (cluster.pack_points(torch.tensor(pts)), torch.tensor(valid), torch.tensor(labels),
            0.16, 128, window, starts)
    np.testing.assert_array_equal(want, cluster.sweep_jump_banded(*args).numpy())
    live = np.random.default_rng(seed).random(n // 128) < 0.5
    got = cluster.sweep_jump_banded(*args, torch.tensor(live)).numpy()
    np.testing.assert_array_equal(np.where(np.repeat(live, 128), want, labels), got)


TOL2 = 0.4 ** 2


def _probe_decisions(which):
    """Row 1's sweep output (0: adjacent to row 0, 1: not) for every probe
    pair, through the port's or the reference's full and banded sweeps."""
    p, valid, labels, offsets = near_threshold_pairs(TOL2)
    starts = np.zeros(p.shape[1] // 128, np.int32)  # each pair sits in rows 0 and 1
    if which == "port":
        def full(a, b, c):
            return cluster.sweep_jump(cluster.point_channels(a), b, c, TOL2)

        def band(a, b, c):
            return cluster.sweep_jump_banded(cluster.pack_points(a), b, c, TOL2, 128, 128,
                                             torch.tensor(starts))

        wrap = torch.tensor
    else:
        full = jax.jit(lambda a, b, c: ref_cluster._xla_sweep_jump(a, b, c, TOL2, 128))
        band = jax.jit(lambda a, b, c: ref_cluster._xla_sweep_jump_banded(
            a, b, c, TOL2, 128, 128, jnp.asarray(starts)))
        wrap = jnp.asarray
    out = {"full": [], "banded": []}
    for k in range(p.shape[0]):
        args = (wrap(p[k]), wrap(valid), wrap(labels))
        out["full"].append(int(np.asarray(full(*args))[1]))
        out["banded"].append(int(np.asarray(band(*args))[1]))
    return offsets, out


def test_near_threshold_pairs_follow_the_fused_tree():
    """Pairs whose expanded-form d2 lies at tol2 and 1, 2 and 8 ulps on
    either side: the port's full and banded sweeps call a pair adjacent
    exactly when its d2 is <= tol2, with |p|^2 and the cross term taken as
    the reference's fused chains and the rest of the expanded tree
    rounded at each step."""
    offsets, out = _probe_decisions("port")
    assert sorted(set(offsets.tolist())) == sorted(TOL2_PROBE_OFFSETS)
    want = [0 if k <= 0 else 1 for k in offsets]
    assert out["full"] == want
    assert out["banded"] == want


def test_near_threshold_pairs_agree_with_reference():
    """The reference's XLA sweeps make the port's decision on every probe
    pair (they compute |p|^2 and the cross term as the fused chains the
    port writes out)."""
    offsets, port = _probe_decisions("port")
    _, ref = _probe_decisions("reference")
    flips = [int(k) for k, a, b in zip(offsets, port["full"], ref["full"]) if a != b]
    flips += [int(k) for k, a, b in zip(offsets, port["banded"], ref["banded"]) if a != b]
    assert not flips, flips


def test_reference_sweeps_fuse_the_cross_term():
    """Where the pair sits away from the origin, the cross term's rounding
    reaches the decision: on 128 pairs near tol2 whose decision differs
    between the fused chain fma(qz, cz, fma(qx, cx, qy * cy)) and the
    rounded products, the reference's full and banded XLA sweeps decide as
    the fused chain on every pair, and so do the port's (K4's and K5's
    plain versions here; the kernels on the card in tests/test_torch_cuda.py)."""
    pairs = cross_term_pairs(TOL2)
    full = jax.jit(lambda a, b, c: ref_cluster._xla_sweep_jump(a, b, c, TOL2, 128))
    band = jax.jit(lambda a, b, c: ref_cluster._xla_sweep_jump_banded(
        a, b, c, TOL2, 128, 128, jnp.zeros(2, jnp.int32)))
    valid = np.arange(256) < 2
    labels = np.arange(256, dtype=np.int32)
    starts = torch.zeros(2, dtype=torch.int32)
    for q, c, fused_adjacent in pairs:
        # the unfused form would have decided the other way
        assert (d2_unfused_cross(q, c) <= np.float32(TOL2)) != fused_adjacent
        buf = np.zeros((256, 3), np.float32)
        buf[0], buf[1] = q, c
        for sweep in (full, band):
            ref = sweep(jnp.asarray(buf), jnp.asarray(valid), jnp.asarray(labels))
            assert (int(np.asarray(ref)[1]) == 0) == fused_adjacent
        p, v, lab = torch.tensor(buf), torch.tensor(valid), torch.tensor(labels)
        got_full = cluster.sweep_jump(cluster.point_channels(p), v, lab, TOL2)
        got_band = cluster.sweep_jump_banded(cluster.pack_points(p), v, lab, TOL2, 128, 128,
                                             starts)
        assert (int(got_full[1]) == 0) == fused_adjacent
        assert (int(got_band[1]) == 0) == fused_adjacent


@pytest.mark.parametrize("seed,n,n_valid,window,gated",
                         [(6, 1024, 900, 512, False), (6, 1024, 900, 512, True),
                          (7, 2048, 1700, 1024, False), (8, 640, 600, 512, True)])
def test_banded_sweep_over_window_quarters(seed, n, n_valid, window, gated):
    """Kernel K5 splits each tile's window over four blocks: the plain
    sweep over each quarter window (starts + b * W/4, width W/4), with the
    minimum of the four partials, is the sweep over the whole window, with
    every tile live and with a random tile_live (the in-window jump column
    falls in exactly one quarter)."""
    pts, valid, labels = _lattice_cloud(seed, n, n_valid)
    p = cluster.pack_points(torch.tensor(pts))
    v, lab = torch.tensor(valid), torch.tensor(labels)
    starts, _ = cluster.band_starts(torch.tensor(pts), v, 128, window, 0.4)
    live = torch.tensor(np.random.default_rng(seed).random(n // 128) < 0.5) if gated else None
    whole = cluster.sweep_jump_banded_plain(p, v, lab, 0.16, 128, window, starts, live)
    q = window // 4
    parts = [cluster.sweep_jump_banded_plain(p, v, lab, 0.16, 128, q, starts + b * q, live)
             for b in range(4)]
    np.testing.assert_array_equal(torch.stack(parts).min(dim=0).values.numpy(), whole.numpy())
    assert (whole != lab).any()  # the sweep moves some labels
