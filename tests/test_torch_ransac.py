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
