"""The sum kernel's partition (``ops.xla_sum_plan``) and RANSAC's
refinement step (``ops.ransac.covariance_tail``) on the CPU.

The card's sum kernel splits a row over a thread-block cluster by the
host's plan: block ``b`` sums the windows ``ranges[b]`` of one level of
XLA:CPU's tree, and the first block then the levels above and the plain
reduce.  ``replay`` does the same in torch, block by block, and must give
``sum_like_xla_plain`` (and so ``jnp.sum``) bit for bit at every length and
block count: the plan may cut a row only where XLA:CPU's order allows.
``covariance_tail`` on the CPU is ``sum_like_xla_plain`` then
``plane_tail_plain``, and the two together are the reference's refinement
step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu_torch.ops import (
    XLA_REDUCE_WINDOW,
    fma,
    sum_like_xla_plain,
    xla_sum_levels,
    xla_sum_plan,
)

W = XLA_REDUCE_WINDOW
LENGTHS = (1, 31, 32, 33, 1023, 1024, 1025, 24_576, 32_768, 32_769, 100_003, 262_144,
           2**20 + 7)
BLOCKS = (1, 2, 8, 16)


@functools.lru_cache(maxsize=None)
def _operands(n: int, prod: bool):
    """Seeded rows at three scales with -0.0 sprinkled in: [2, n] for one
    operand, [1, 3, n] x [1, 3, n] (the covariance's shape) for two."""
    rng = np.random.default_rng(n % 1009 + 7 * prod)
    shape = (1, 3, n) if prod else (2, n)
    a = (rng.standard_normal(shape) * np.array([1.0, 100.0, 1e-3])[:shape[-2], None]
         ).astype(np.float32)
    a[..., ::97] = -0.0
    b = rng.standard_normal(shape).astype(np.float32) if prod else None
    return torch.tensor(a), None if b is None else torch.tensor(b)


@functools.lru_cache(maxsize=None)
def _plain(n: int, prod: bool) -> torch.Tensor:
    return sum_like_xla_plain(*_operands(n, prod))


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """The in-order sum of the last axis from +0.0."""
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _first_slot(level: int, window: int, lo: list[int]) -> int:
    """The first value slot of a window of ``level``: 32^level * window less
    the padding in front at every level below."""
    slot = window
    for i in range(level - 1, -1, -1):
        slot = slot * W - lo[i]
    return slot


def replay(a: torch.Tensor, b: torch.Tensor | None, blocks: int) -> torch.Tensor:
    """The sum kernel's arithmetic, block by block, as its plan splits the
    row: each block's windows from its own value slots (zero outside [0,
    n)), then the first block's levels above and the plain reduce."""
    n = a.shape[-1]
    level, ranges = xla_sum_plan(n, blocks)
    assert 1 <= len(ranges) <= blocks
    if level == 0:  # the plain reduce alone
        assert ranges == ((0, n),)
        if b is None:
            return _in_order(a)
        acc = torch.zeros(*a.shape[:-1], b.shape[-2])
        for k in range(n):
            acc = fma(a[..., :, None, k], b[..., None, :, k], acc)
        return acc
    x = a if b is None else a[..., :, None, :] * b[..., None, :, :]  # products rounded
    sizes = xla_sum_levels(n)
    top = len(sizes) - 1
    lo = [(-c % W) // 2 for c in sizes]
    assert level == top or level >= 2
    owned = []
    for w0, w1 in ranges:  # each block: its windows, a level at a time
        assert w1 > w0
        first = _first_slot(level, w0, lo)
        idx = torch.arange(first, first + (w1 - w0) * W ** level)
        inside = (idx >= 0) & (idx < n)
        seg = torch.where(inside, x[..., idx.clamp(0, max(n - 1, 0))], 0.0)
        for _ in range(level):
            seg = _in_order(seg.reshape(*seg.shape[:-1], -1, W))
        owned.append(seg)
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    g = torch.cat(owned, dim=-1)  # the first block's copy of every block's sums
    assert g.shape[-1] == sizes[level]
    for i in range(level, top):  # the levels above, then the plain reduce
        pad = -g.shape[-1] % W
        g = torch.nn.functional.pad(g, (lo[i], pad - lo[i]))
        g = _in_order(g.reshape(*g.shape[:-1], -1, W))
    return _in_order(g)


@pytest.mark.parametrize("prod", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("n", LENGTHS)
def test_plan_replay_is_the_plain_sum(n, blocks, prod):
    """Every block's share of the row, summed on its own, then the first
    block's levels: bitwise ``sum_like_xla_plain`` (compared as int32)."""
    a, b = _operands(n, prod)
    got = replay(a, b, blocks)
    want = _plain(n, prod)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("n", [33, 24_576, 100_003, 2**20 + 7])
def test_plan_replay_is_jnp_sum(n):
    """A subset against XLA:CPU's jitted ``jnp.sum`` itself, both forms, at
    16 blocks (the kernel's cluster for one scan)."""
    a, b = _operands(n, False)
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=-1))(a.numpy()))
    np.testing.assert_array_equal(replay(a, None, 16).numpy().view(np.int32),
                                  want.view(np.int32))
    a, b = _operands(n, True)
    pair = jax.jit(lambda p, q: jnp.sum(p * q, axis=-1))
    want = np.stack([np.asarray(pair(a[0, s].numpy(), b[0, t].numpy()))
                     for s in range(3) for t in range(3)]).reshape(1, 3, 3)
    np.testing.assert_array_equal(replay(a, b, 16).numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("n,blocks,level,owned", [
    (24_576, 16, 2, (1, 2)),  # flagship: 24 level-2 windows over 16 blocks
    (262_144, 16, 2, (16, 16)),  # fullscale: 256 level-2 windows; 8 at level 3 < 16
    (2**20 + 7, 16, 3, (2, 3)),  # 33 level-3 windows
    (16_384, 16, 2, (1, 1)),
    (2_048, 16, 2, (1, 1)),  # 2 level-2 windows: 2 blocks
    (1_024, 16, 1, (32, 32)),  # one block, its 32 level-1 windows
    (32, 16, 0, (32, 32)),  # the plain reduce
])
def test_plan_shape(n, blocks, level, owned):
    """The level is the highest with at least one window a block (never
    below 2 for a row of more than 1,024 values); a block owns 1 to 32
    windows of it, and the blocks cover them in order."""
    lv, ranges = xla_sum_plan(n, blocks)
    sizes = [r[1] - r[0] for r in ranges]
    assert lv == level
    assert (min(sizes), max(sizes)) == owned
    assert ranges[0][0] == 0 and ranges[-1][1] == xla_sum_levels(n)[lv] or lv == 0
    assert max(sizes) <= 32 or lv == 0


# ---- covariance_tail ---------------------------------------------------------

def _refine_inputs(seed: int, scans: int, n: int):
    """Scans of plane-like clouds with a seeded inlier mask (one scan with
    fewer than 3 inliers), as the refinement sees them: points [B, n, 3],
    the mask [B, n], and each scan's current plane (normal, d)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0, 4, (scans, n)), rng.uniform(0, 3, (scans, n)),
                    rng.normal(0, 0.02, (scans, n))], -1)
    pts[..., 2] += rng.normal(0, 0.1, (scans, 1)) * pts[..., 0]
    inl = rng.random((scans, n)) < 0.7
    inl[0, 2:] = False  # fewer than three inliers: the plane stays
    normal = rng.normal(0, 0.1, (scans, 3)) + [0.0, 0.0, 1.0]
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = rng.standard_normal(scans)
    return pts.astype(np.float32), inl, normal.astype(np.float32), d.astype(np.float32)


def _port_step(pts, inl, normal, d, vmapped):
    """The port's refinement step as ``_plane_once`` runs it: the masked sums,
    the centroid, then ``covariance_tail``."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac, sum_like_xla

    pts1 = ransac._with_ones(torch.tensor(pts))
    r_in = torch.tensor(inl)
    s4 = sum_like_xla(torch.where(r_in[:, None, :], pts1, 0.0))
    n_inl = s4[:, 3]
    cen = s4[:, :3] / torch.clamp_min(n_inl, 3.0)[:, None]
    off = pts1[:, :3] - cen[..., None]
    masked = torch.where(r_in[:, None, :], off, 0.0)
    args = (masked, off, cen, n_inl, torch.tensor(normal), torch.tensor(d))
    return ransac.covariance_tail(*args, vmapped), args


@pytest.mark.parametrize("vmapped", [False, True])
@pytest.mark.parametrize("n", [20, 1000, 4096])
def test_covariance_tail_is_sum_then_tail(n, vmapped):
    """On the CPU, ``covariance_tail`` is the covariance's plain sums then
    the tail's plain version, bitwise (also where fewer than 3 inliers keep
    the plane)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    pts, inl, normal, d = _refine_inputs(n + int(vmapped), 4, n)
    (got_n, got_d), (masked, off, cen, n_inl, nrm0, d0) = _port_step(pts, inl, normal, d, vmapped)
    want_n, want_d = ransac.plane_tail_plain(sum_like_xla_plain(masked, off), cen, n_inl, nrm0,
                                             d0, vmapped)
    np.testing.assert_array_equal(got_n.numpy().view(np.int32), want_n.numpy().view(np.int32))
    np.testing.assert_array_equal(got_d.numpy().view(np.int32), want_d.numpy().view(np.int32))
    np.testing.assert_array_equal(got_n[0].numpy(), normal[0])  # < 3 inliers: kept
    assert got_d[0].item() == d[0]


def _ref_step(x, y, z, w, normal, d):
    """The reference's refinement step (``ransac_plane_once``'s ``refine``,
    pointcloud_obstacle_processing_tpu/ops/ransac.py:171-205) for one scan,
    up to the plane it keeps, with the reference's own eigenvector."""
    from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac

    n_inl = jnp.sum(w)
    cnt = jnp.maximum(n_inl, 3.0)
    cx, cy, cz = jnp.sum(x * w) / cnt, jnp.sum(y * w) / cnt, jnp.sum(z * w) / cnt
    dx, dy, dz = x - cx, y - cy, z - cz
    qx, qy, qz = dx * w, dy * w, dz * w
    cov = jnp.array([[jnp.sum(qx * dx), jnp.sum(qx * dy), jnp.sum(qx * dz)],
                     [jnp.sum(qy * dx), jnp.sum(qy * dy), jnp.sum(qy * dz)],
                     [jnp.sum(qz * dx), jnp.sum(qz * dy), jnp.sum(qz * dz)]])
    nrm = ref_ransac._smallest_eigvec_3x3(cov, normal)
    nrm = nrm * jnp.sign(jnp.sum(nrm * normal) + 1e-30)
    nd = -(nrm[0] * cx + nrm[1] * cy + nrm[2] * cz)
    ok = n_inl >= 3.0
    return jnp.where(ok, nrm, normal), jnp.where(ok, nd, d)


@pytest.mark.parametrize("vmapped", [False, True])
@pytest.mark.parametrize("n", [1000, 4096])
def test_covariance_tail_is_the_reference_step(n, vmapped):
    """The port's step (masked sums, centroid, ``covariance_tail``) against
    the reference's, jitted for one scan at a time or under ``jax.vmap``
    over four: the refined normal and offset bitwise."""
    pts, inl, normal, d = _refine_inputs(2 * n + int(vmapped), 4, n)
    (got_n, got_d), _ = _port_step(pts, inl, normal, d, vmapped)
    w = inl.astype(np.float32)
    args = (pts[..., 0], pts[..., 1], pts[..., 2], w, normal, d)
    if vmapped:
        want_n, want_d = (np.asarray(v) for v in jax.jit(jax.vmap(_ref_step))(*args))
    else:
        one = jax.jit(_ref_step)
        outs = [one(*(x[s] for x in args)) for s in range(len(d))]
        want_n = np.stack([np.asarray(o[0]) for o in outs])
        want_d = np.stack([np.asarray(o[1]) for o in outs])
    np.testing.assert_array_equal(got_n.numpy().view(np.int32), want_n.view(np.int32))
    np.testing.assert_array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
