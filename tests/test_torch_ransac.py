"""RANSAC plane segmentation of the PyTorch port against the JAX package.

The port takes its hypotheses from an injected ``draw``; here the draw
replays the reference's key chain (``key, sub = split(key)`` then
``randint(sub, (K, 3), 0, max(n_valid, 1))`` per round), so both sides score
the same hypotheses.  Bar: planes and masks exact, coefficients within 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import fma32

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops.ransac import segment_planes as ref_segment_planes

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform, segment_planes


def jax_key_chain_draw(key, hypotheses: int):
    """A ``draw`` that replays the reference's per-round JAX key chain."""

    def draw(r: int, n_valid: torch.Tensor) -> torch.Tensor:
        k = key
        for _ in range(r + 1):
            k, sub = jax.random.split(k)
        u = jax.random.randint(sub, (hypotheses, 3), 0, jnp.maximum(jnp.int32(int(n_valid)), 1))
        return torch.tensor(np.asarray(u), dtype=torch.int64)

    return draw


def _planes_scene(seed, n, n_fill):
    """A ground plane, a tilted ramp and clutter."""
    rng = np.random.default_rng(seed)
    m = n_fill // 3
    ground = np.stack([rng.uniform(0, 4, m), rng.uniform(0, 3, m), rng.normal(0, 0.01, m)], -1)
    rx, ry = rng.uniform(0, 2, m), rng.uniform(0, 3, m)
    ramp = np.stack([rx, ry, 0.3 + 0.2 * rx + rng.normal(0, 0.01, m)], -1)
    clutter = rng.uniform([0, 0, -0.3], [4, 3, 0.8], (n_fill - 2 * m, 3))
    pts = np.concatenate([ground, ramp, clutter]).astype(np.float32)
    pts = pts[rng.permutation(len(pts))]
    buf = np.zeros((n, 3), np.float32)
    buf[:n_fill] = pts
    return buf, np.arange(n) < n_fill


@pytest.mark.parametrize(
    "seed,n,n_fill,overrides",
    [
        (0, 4096, 3000, {}),
        (1, 8192, 6000, dict(max_planes=1)),  # the static bound binds: truncated
        (2, 2048, 1500, dict(plane_min_remaining_frac=0.6, ransac_hypotheses=64)),
        (3, 1024, 2, {}),  # fewer than three points: no plane
    ],
)
def test_segment_planes_match_reference(seed, n, n_fill, overrides):
    ref_cfg = REF_CFG.replace(**overrides)
    cfg = CFG.replace(**overrides)
    pts, valid = _planes_scene(seed, n, n_fill)
    key = jax.random.PRNGKey(seed + 10)
    r = jax.jit(lambda c, k: ref_segment_planes(c, k, ref_cfg))(RefCloud.from_points(pts, valid), key)
    p = segment_planes(Cloud.from_points(pts, valid), cfg,
                       jax_key_chain_draw(key, cfg.ransac_hypotheses))
    assert int(r.planes.num_planes) == int(p.planes.num_planes)
    np.testing.assert_array_equal(np.asarray(r.planes.valid), p.planes.valid.numpy())
    # the hypotheses are bitwise the reference's (test_hypothesis_arithmetic_
    # is_bitwise_the_reference); the refinement's centroid and covariance are
    # sums over every inlier, which torch reduces in another order than
    # XLA:CPU, and the power iteration carries that rounding into the
    # coefficients: within 1e-6, not bitwise
    np.testing.assert_allclose(p.planes.coeffs.numpy(), np.asarray(r.planes.coeffs), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(r.nonplane_cloud.valid), p.nonplane_cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.plane_union), p.plane_union.numpy())
    np.testing.assert_array_equal(np.asarray(r.last_plane), p.last_plane.numpy())
    assert bool(r.truncated) == bool(p.truncated)


def test_uniform_draws_stay_in_range():
    u = torch.tensor(np.array([[[0.0, 0.5, 0.99999994]]], np.float32))
    draw = draw_from_uniform(u)
    np.testing.assert_array_equal(draw(0, torch.tensor(10, dtype=torch.int32)).numpy(), [[0, 5, 9]])
    np.testing.assert_array_equal(draw(0, torch.tensor(0, dtype=torch.int32)).numpy(), [[0, 0, 0]])


def test_hypothesis_arithmetic_is_bitwise_the_reference(monkeypatch):
    """Each hypothesis' normal and offset, refinement off, on 300 random
    triples: the port's cross product ``fma(uy, vz, -(uz * vy))`` (and its
    turns), norm ``sqrt(fma(nz, nz, fma(nx, nx, ny * ny)))`` and offset
    ``-fma(nz, p0z, fma(nx, p0x, ny * p0y))`` equal the reference's bit for
    bit; the unfused expressions would differ on most triples."""
    from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    k, cap = 8, 128
    rng = np.random.default_rng(21)
    tris = rng.uniform([-3, -3, -0.3], [3, 3, 0.5], (300, 3, 3)).astype(np.float32)
    valid = np.arange(cap) < 3
    bufs = np.zeros((len(tris), cap, 3), np.float32)
    bufs[:, :3] = tris
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **kw:
                        jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32), shape))
    ref_cfg = REF_CFG.replace(ransac_refine_iters=0, ransac_hypotheses=k)
    once = jax.jit(lambda c: ref_ransac.ransac_plane_once(c, jax.random.PRNGKey(0), ref_cfg))
    ref = [once(RefCloud.from_points(b, valid)) for b in bufs]  # traced once, with the patch
    monkeypatch.undo()
    cfg = CFG.replace(ransac_refine_iters=0, ransac_hypotheses=k)
    got = [ransac.ransac_plane_once(Cloud.from_points(b, valid), torch.arange(3).repeat(k, 1), cfg)
           for b in bufs]
    want_n = np.stack([np.asarray(r.normal) for r in ref])
    want_d = np.array([np.asarray(r.d) for r in ref])
    np.testing.assert_array_equal(np.stack([g.normal.numpy() for g in got]), want_n)
    np.testing.assert_array_equal(np.array([g.d.numpy() for g in got]), want_d)
    u, v = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    n = np.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1], u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                  u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], 1)
    norm = np.sqrt((n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]) + n[:, 2] * n[:, 2])
    n = n * (np.float32(1.0) / norm)[:, None]
    assert (n != want_n).any(1).sum() > len(tris) // 4


# offsets of the probe's distance from the threshold, in float32 ulps
DIST_PROBE_OFFSETS = (-8, -2, -1, 0, 1, 2, 8)


def _dist_fused(x, y, z, n, d):
    """The reference's point-plane distance on XLA:CPU (float32, numpy)."""
    return fma32(z, n[2], fma32(x, n[0], y * n[1])) + d


def _dist_unfused(x, y, z, n, d):
    return ((x * n[0] + y * n[1]) + z * n[2]) + d


def _near_plane_points(n, d, rng, bases, far_from=None):
    """Points whose fused distance to the plane (n, d) is exactly
    ``DIST_PROBE_OFFSETS`` ulps from the threshold, found by stepping z of
    random points at that distance one ulp at a time; with ``far_from``,
    only points more than 0.045 from that other plane.  Returns (points
    [P, 3], offsets [P])."""
    t = np.float32(REF_CFG.plane_segment_dist_thresh)
    targets = {}
    for k in DIST_PROBE_OFFSETS:
        v = t
        for _ in range(abs(k)):
            v = np.nextafter(v, np.float32(np.inf if k > 0 else -np.inf))
        targets[v.item()] = k
    steps = np.arange(-48, 49, dtype=np.int32)
    pts, offs = [], []
    for _ in range(bases):
        x, y = rng.uniform(-3.0, 3.0, 2).astype(np.float32)
        side = 1.0 if far_from is not None else rng.choice([-1.0, 1.0])
        z0 = np.float32((side * t - d - n[0] * x - n[1] * y) / n[2])
        z = (z0.view(np.int32) + steps).view(np.float32)
        dist = np.abs(_dist_fused(x, y, z, n, d))
        if far_from is not None:
            keep = np.abs(_dist_unfused(x, y, z, *far_from)) > 0.045
            dist = np.where(keep, dist, np.float32(0))
        for v, k in targets.items():
            hit = np.flatnonzero(dist == np.float32(v))
            if len(hit):
                pts.append((x, y, z[hit[0]]))
                offs.append(k)
    return np.array(pts, np.float32), np.array(offs)


def _plane_once_fixed_draws(monkeypatch, pts, valid, refine_iters):
    """The reference's and the port's ``ransac_plane_once`` with every
    hypothesis drawn as the first three valid points."""
    from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    k = 8
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, *a, **kw:
                        jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32), shape))
    ref_cfg = REF_CFG.replace(ransac_refine_iters=refine_iters, ransac_hypotheses=k)
    r = jax.jit(lambda c: ref_ransac.ransac_plane_once(c, jax.random.PRNGKey(0), ref_cfg))(
        RefCloud.from_points(pts, valid))
    monkeypatch.undo()
    cfg = CFG.replace(ransac_refine_iters=refine_iters, ransac_hypotheses=k)
    p = ransac.ransac_plane_once(Cloud.from_points(pts, valid),
                                 torch.arange(3).repeat(k, 1), cfg)
    return r, p


# the plane through (0, 0, 0), (1, 0, A) and (0, 1, B): normal (-A, -B, 1)
# up to its norm, each step of which rounds alike in both packages
_A, _B = 0.25, 0.375


def test_plane_distance_probe_scoring(monkeypatch):
    """Hypothesis scoring (refinement off) on points at the threshold and 1,
    2 and 8 ulps either side of one fixed plane: the reference calls a point
    an inlier exactly when its fused distance is below the threshold, some
    of those decisions differ from the unfused tree, and the port makes the
    reference's decision on every point."""
    rng = np.random.default_rng(7)
    nrm = np.array([-_A, -_B, 1.0], np.float32)
    n = nrm * (np.float32(1.0) / np.sqrt(np.float32(_A * _A + _B * _B + 1.0)))
    probes, offs = _near_plane_points(n, np.float32(0.0), rng, bases=96)
    assert sorted(set(offs.tolist())) == sorted(DIST_PROBE_OFFSETS)
    cap = 1024
    pts = np.zeros((cap, 3), np.float32)
    pts[:3] = [[0, 0, 0], [1, 0, _A], [0, 1, _B]]
    pts[3:3 + len(probes)] = probes
    valid = np.arange(cap) < 3 + len(probes)
    r, p = _plane_once_fixed_draws(monkeypatch, pts, valid, 0)
    np.testing.assert_array_equal(np.asarray(r.normal), n)
    ref_in = np.asarray(r.inliers)[3:3 + len(probes)]
    np.testing.assert_array_equal(ref_in, offs < 0)
    unfused = np.abs(_dist_unfused(*probes.T, n, np.float32(0.0))) < np.float32(0.04)
    assert (unfused != ref_in).any()
    np.testing.assert_array_equal(p.inliers.numpy(), np.asarray(r.inliers))


def test_plane_distance_probe_refinement(monkeypatch):
    """The refinement's distance, probed where it sits: a bulk of 1,021
    points on a plane 1/64 above the hypothesis' plane pulls the refined
    plane R away from it; points at the threshold and 1, 2 and 8 ulps
    either side of R, and beyond the threshold of the hypothesis' plane (so
    R does not depend on them), are inliers of the reference's refinement
    exactly when their fused distance to R is below the threshold, and the
    port's distance makes the same decisions against R."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    rng = np.random.default_rng(8)
    cap, nb = 8192, 1021
    bx = (rng.integers(-24, 25, nb) / 8).astype(np.float32)
    by = (rng.integers(-24, 25, nb) / 8).astype(np.float32)
    base = np.zeros((cap, 3), np.float32)
    base[:3] = [[0, 0, 0], [1, 0, _A], [0, 1, _B]]
    base[3:3 + nb] = np.stack([bx, by, _A * bx + _B * by + 0.015625], 1)
    r0, _ = _plane_once_fixed_draws(monkeypatch, base, np.arange(cap) < 3 + nb, 1)
    rn, rd = np.asarray(r0.normal), np.asarray(r0.d)
    hyp = np.array([-_A, -_B, 1.0], np.float32) / np.sqrt(np.float32(_A * _A + _B * _B + 1.0))
    probes, offs = _near_plane_points(rn, rd, rng, bases=256, far_from=(hyp, np.float32(0.0)))
    assert sorted(set(offs.tolist())) == sorted(DIST_PROBE_OFFSETS)
    pts = base.copy()
    s = 3 + nb
    pts[s:s + len(probes)] = probes
    r, _ = _plane_once_fixed_draws(monkeypatch, pts, np.arange(cap) < s + len(probes), 1)
    np.testing.assert_array_equal(np.asarray(r.normal), rn)  # the probes left R alone
    assert np.asarray(r.d) == rd
    ref_in = np.asarray(r.inliers)[s:s + len(probes)]
    np.testing.assert_array_equal(ref_in, offs < 0)
    unfused = np.abs(_dist_unfused(*probes.T, rn, rd)) < np.float32(0.04)
    assert (unfused != ref_in).any()
    x, y, z = torch.tensor(probes).T
    got = torch.abs(ransac._plane_dist(x, y, z, *torch.tensor(rn), torch.tensor(rd))) < 0.04
    np.testing.assert_array_equal(got.numpy(), ref_in)
