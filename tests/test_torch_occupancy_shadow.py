"""Occupancy seeding, obstacle marking, shadow casting and transforms of the
PyTorch port against the JAX package.  Bar: int8 grids exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import occupancy as ref_occ
from pointcloud_obstacle_processing_tpu.ops.shadow import cast_shadows as ref_cast_shadows
from pointcloud_obstacle_processing_tpu.ops.transforms import RigidTransform as RefTF
from pointcloud_obstacle_processing_tpu.types import ClusterSet as RefClusterSet

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud, ClusterSet
from pointcloud_obstacle_processing_tpu_torch.ops import occupancy
from pointcloud_obstacle_processing_tpu_torch.ops.shadow import cast_shadows, sweep_lines
from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform


def _points(seed, n):
    """Points around and beyond the crop box, with NaNs and cell-boundary
    coordinates (multiples of the block size)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-0.5, -0.5, -0.7], [5.0, 4.3, 0.5], (n, 3)).astype(np.float32)
    k = n // 8
    pts[:k, 0] = (rng.integers(0, 121, k) * np.float32(CFG.block_size)).astype(np.float32)
    pts[k:2 * k, 1] = (rng.integers(0, 101, k) * np.float32(CFG.block_size)).astype(np.float32)
    pts[2 * k:2 * k + 20] = np.nan
    valid = rng.random(n) < 0.95
    return pts, valid


@pytest.mark.parametrize("seed,dev_percent", [(0, 0.9), (1, 0.5)])
def test_crop_and_seed_matches_reference(seed, dev_percent):
    ref_cfg = REF_CFG.replace(dev_percent=dev_percent)
    cfg = CFG.replace(dev_percent=dev_percent)
    pts, valid = _points(seed, 20000)
    r = jax.jit(lambda c: ref_occ.crop_and_seed(c, ref_cfg))(RefCloud.from_points(pts, valid))
    p = occupancy.crop_and_seed(Cloud.from_points(pts, valid), cfg)
    np.testing.assert_array_equal(np.asarray(r.cloud.valid), p.cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
    np.testing.assert_array_equal(np.asarray(r.row_averages), p.row_averages.numpy())
    np.testing.assert_array_equal(np.asarray(r.hole_grid), p.hole_grid.numpy())


def test_grid_cells_and_marking_match_reference():
    pts, valid = _points(2, 20000)
    col_r, row_r = jax.jit(lambda p: ref_occ.grid_cell_xy(p, REF_CFG))(jnp.asarray(pts))
    col_p, row_p = occupancy.grid_cell_xy(torch.tensor(pts), CFG)
    finite = np.isfinite(pts).all(axis=1)
    np.testing.assert_array_equal(np.asarray(col_r)[finite], col_p.numpy()[finite])
    np.testing.assert_array_equal(np.asarray(row_r)[finite], row_p.numpy()[finite])
    grid = np.random.default_rng(3).choice([0, 100], (CFG.grid_height, CFG.grid_width)).astype(np.int8)
    r = jax.jit(lambda g, c: ref_occ.mark_obstacles(g, c, REF_CFG))(
        jnp.asarray(grid), RefCloud.from_points(pts, valid))
    p = occupancy.mark_obstacles(torch.tensor(grid), Cloud.from_points(pts, valid), CFG)
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


def _cluster_case(seed):
    rng = np.random.default_rng(seed)
    n, m = 512, 8
    centers = rng.uniform([0.5, 0.5, 0.0], [4.0, 3.3, 0.2], (5, 3))
    pc = np.full(n, -1, np.int32)
    pts = np.zeros((n, 3), np.float32)
    for j, c in enumerate(centers):
        sl = slice(j * 60, (j + 1) * 60)
        pts[sl] = rng.normal(c, [0.08, 0.25 if j == 2 else 0.08, 0.05], (60, 3))
        pc[sl] = j
    valid = pc >= 0
    sizes = np.zeros(m, np.int32)
    sizes[:5] = 60
    slot_valid = np.arange(m) < 5
    slot_valid[4] = False  # a slot that fails the size gate casts nothing
    return pts, valid, pc, sizes, slot_valid


@pytest.mark.parametrize(
    "quat,trans",
    [
        ((0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
        ((0.0, 0.2588190, 0.0, 0.9659258), (-0.6, 1.9, 0.8)),  # camera tilted, behind the arena
    ],
)
def test_cast_shadows_matches_reference(quat, trans):
    pts, valid, pc, sizes, slot_valid = _cluster_case(4)
    grid = np.zeros((CFG.grid_height, CFG.grid_width), np.int8)
    ref_cfg = REF_CFG.replace(grid_opacity=50)
    cfg = CFG.replace(grid_opacity=50)
    ref_clusters = RefClusterSet(point_cluster=jnp.asarray(pc), sizes=jnp.asarray(sizes),
                                 valid=jnp.asarray(slot_valid), num_clusters=jnp.int32(4))
    r = jax.jit(lambda g, c, cl, tf: ref_cast_shadows(g, c, cl, tf, ref_cfg).grid)(
        jnp.asarray(grid), RefCloud.from_points(pts, valid), ref_clusters,
        RefTF.from_quat_trans(quat, trans))
    clusters = ClusterSet(point_cluster=torch.tensor(pc), sizes=torch.tensor(sizes),
                          valid=torch.tensor(slot_valid), num_clusters=torch.tensor(4))
    p = cast_shadows(torch.tensor(grid), Cloud.from_points(pts, valid), clusters,
                     RigidTransform.from_quat_trans(quat, trans), cfg).grid
    assert (np.asarray(r) == 50).sum() > 0
    np.testing.assert_array_equal(np.asarray(r), p.numpy())


def _bits_apart(a, b) -> int:
    """Rows (or elements, for 1-D arrays) of two float32 arrays whose bits
    differ."""
    bad = np.asarray(a, np.float32).view(np.int32) != np.asarray(b, np.float32).view(np.int32)
    return int(bad.any(axis=-1).sum() if bad.ndim > 1 else bad.sum())


def _unfused_rotate(q, v):
    """The rotation with every product rounded, as the port wrote it before
    it took XLA:CPU's fused chain."""
    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    u, w = q[:3].expand_as(v), q[3:]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def test_transform_apply_and_inverse_match_reference():
    """``apply``, ``inverse().apply`` and the inverse's translation are
    bitwise the reference's jitted functions (pose passed as an argument,
    as the pipeline passes it) over 40 random poses of 5,000 points each:
    the port writes the rotation as XLA:CPU fuses it; the unfused rotation
    differs on most points (counts printed under ``-s``).  The round trip
    returns the points within 1e-5."""
    rng = np.random.default_rng(6)
    unfused = [0, 0]
    ref_apply = jax.jit(lambda q, t, p: RefTF(quat_xyzw=q, translation=t).apply(p))
    ref_inv = jax.jit(lambda q, t, p: RefTF(quat_xyzw=q, translation=t).inverse().apply(p))
    ref_inv_t = jax.jit(lambda q, t: RefTF(quat_xyzw=q, translation=t).inverse().translation)
    for _ in range(40):
        q = rng.standard_normal(4).astype(np.float32)
        q /= np.linalg.norm(q)
        t = (rng.standard_normal(3) * 3.0).astype(np.float32)
        pts = rng.uniform(-5.0, 5.0, (5000, 3)).astype(np.float32)
        tf = RigidTransform.from_quat_trans(q, t)
        inv = tf.inverse()
        for got, want in ((tf.apply(torch.tensor(pts)), ref_apply(q, t, pts)),
                          (inv.apply(torch.tensor(pts)), ref_inv(q, t, pts)),
                          (inv.translation, ref_inv_t(q, t))):
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          np.asarray(want).view(np.int32))
        np.testing.assert_allclose(inv.apply(tf.apply(torch.tensor(pts))).numpy(), pts, atol=1e-5)
        qt, tt, pt = torch.tensor(q), torch.tensor(t), torch.tensor(pts)
        qinv = torch.cat([-qt[:3], qt[3:]])
        unfused[0] += _bits_apart(_unfused_rotate(qt, pt) + tt, ref_apply(q, t, pts))
        unfused[1] += _bits_apart(_unfused_rotate(qinv, pt) - _unfused_rotate(qinv, tt[None])[0],
                                  ref_inv(q, t, pts))
    print(f"unfused rotation: apply differs on {unfused[0]}, inverse().apply on {unfused[1]} "
          f"of 200,000 points")
    assert min(unfused) > 50_000


def test_shadow_lengths_are_bitwise_the_reference():
    """The shadow's ``c = sqrt(a*a + bb*bb)`` and ``|vmin|`` on 200,000
    seeded points of widely varying magnitude, against the reference's
    expressions (``ops/shadow.py`` ``per_cluster``) jitted over the points
    as the reference vmaps them: bitwise.  The unfused sum with torch's
    root differs on thousands of them (counts printed under ``-s``, with
    ``torch.linalg.vector_norm``'s for ``|vmin|``)."""
    from pointcloud_obstacle_processing_tpu_torch.ops.shadow import _lengths

    rng = np.random.default_rng(12)
    n = 200_000
    v = rng.uniform(-3.0, 3.0, (n, 3)) * 2.0 ** rng.integers(-4, 4, (n, 3))
    v = v.astype(np.float32)

    def ref(vmin):
        a, bb = vmin[2], jnp.abs(vmin[0])
        return jnp.sqrt(a * a + bb * bb), jnp.linalg.norm(vmin)

    want_c, want_len = jax.jit(jax.vmap(ref))(v)
    got_c, got_len = _lengths(torch.tensor(v))
    for got, want in ((got_c, want_c), (got_len, want_len)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    a, bb = torch.tensor(v[:, 2]), torch.tensor(np.abs(v[:, 0]))
    unfused = _bits_apart(torch.sqrt(a * a + bb * bb), want_c)
    norm = _bits_apart(torch.linalg.vector_norm(torch.tensor(v), dim=-1), want_len)
    print(f"shadow lengths of {n}: unfused c differs on {unfused}, "
          f"torch.linalg.vector_norm on {norm}")
    assert unfused > 1000


def test_shadow_asin_tan_stay_within_ulps_of_the_reference():
    """The shadow's ``tan(asin(x))`` is the one step of its geometry that is
    not bitwise: XLA:CPU's float32 ``asin`` and ``tan`` are approximations
    of its own.  On 200,000 seeded x in [-1, 1), torch's ``arcsin`` is
    within 2 ulps of the reference's jitted ``jnp.arcsin`` and ``tan``, on
    the reference's angles, within 1 ulp of ``jnp.tan``; the count of
    ``tan(asin(x))`` results whose bits differ is printed under ``-s``."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, 200_000).astype(np.float32)

    def ulps(a, b):
        a, b = (np.asarray(v, np.float32).view(np.int32).astype(np.int64) for v in (a, b))
        a, b = (np.where(v < 0, -(v & 0x7FFFFFFF), v) for v in (a, b))
        return np.abs(a - b)

    want_asin = np.asarray(jax.jit(jnp.arcsin)(x))
    assert ulps(torch.arcsin(torch.tensor(x)), want_asin).max() <= 2
    assert ulps(torch.tan(torch.tensor(want_asin)), jax.jit(jnp.tan)(want_asin)).max() <= 1
    apart = _bits_apart(torch.tan(torch.arcsin(torch.tensor(x))),
                        jax.jit(lambda v: jnp.tan(jnp.arcsin(v)))(x))
    print(f"tan(asin(x)) differs from the reference's on {apart} of 200,000")


def test_shadow_lengths_match_the_reference_in_place(monkeypatch):
    """The same two lengths read out of the reference's own jitted
    ``cast_shadows``: its ``jnp.maximum(c, 1e-20)`` and ``jnp.maximum(|vmin|,
    1e-20)`` report their first operand through a host callback (in no
    fixed order), over 20 random poses of 8 clusters.  Every ``c`` and
    ``|vmin|`` of the port, from its own ``vmin`` (its transform is bitwise
    the reference's), is among them; the unfused ``c`` misses some."""
    import pointcloud_obstacle_processing_tpu.ops.shadow as ref_shadow

    from pointcloud_obstacle_processing_tpu_torch.ops.shadow import _lengths

    seen = []

    class _Tap:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def maximum(self, x, y):
            if isinstance(y, float) and y == 1e-20:
                jax.debug.callback(lambda v: seen.append(np.float32(v)), x)
            return jnp.maximum(x, y)

    monkeypatch.setattr(ref_shadow, "jnp", _Tap())
    run = jax.jit(lambda g, c, cl, tf: ref_shadow.cast_shadows(g, c, cl, tf, REF_CFG).grid)
    rng = np.random.default_rng(9)
    n, m = 512, 8
    unfused_misses = 0
    for _ in range(20):
        centers = rng.uniform([0.5, 0.5, 0.0], [4.0, 3.3, 0.2], (m, 3))
        pts = np.zeros((n, 3), np.float32)
        pc = np.full(n, -1, np.int32)
        for j, c in enumerate(centers):
            pts[j * 60:(j + 1) * 60] = rng.normal(c, 0.1, (60, 3))
            pc[j * 60:(j + 1) * 60] = j
        valid = pc >= 0
        q = rng.standard_normal(4).astype(np.float32)
        q /= np.linalg.norm(q)
        t = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
        seen.clear()
        clusters = RefClusterSet(point_cluster=jnp.asarray(pc), sizes=jnp.full(m, 60, jnp.int32),
                                 valid=jnp.ones(m, bool), num_clusters=jnp.int32(m))
        jax.block_until_ready(run(jnp.zeros((REF_CFG.grid_height, REF_CFG.grid_width), jnp.int8),
                                  RefCloud.from_points(pts, valid), clusters,
                                  RefTF.from_quat_trans(q, t)))
        jax.effects_barrier()
        bits = set(np.array(seen, np.float32).view(np.int32).tolist())
        spts = RigidTransform.from_quat_trans(q, t).inverse().apply(torch.tensor(pts))
        vmin = torch.stack([spts[int(torch.argmin(torch.where(torch.tensor(pc == j), spts[:, 0],
                                                              float("inf"))))]
                            for j in range(m)])
        for got in _lengths(vmin):
            assert set(got.numpy().view(np.int32).tolist()) <= bits
        a, bb = vmin[:, 2], vmin[:, 0].abs()
        unfused = torch.sqrt(a * a + bb * bb).numpy().view(np.int32).tolist()
        unfused_misses += sum(b not in bits for b in unfused)
    assert unfused_misses > 0


@pytest.mark.parametrize("vmapped", [False, True])
def test_shadow_sweep_lines_are_bitwise_the_reference(vmapped):
    """The shadow sweep's shift and line count (reference ``ops/shadow.py``
    ``ceil((width / block) / 2)`` and ``ceil(width / block) + 3``) on
    20,000 widths within 3 ulps of a multiple of the block, jitted alone and
    under ``jax.vmap`` as ``cast_shadows`` runs it: XLA:CPU divides by the
    constant block as a product with its reciprocal, and ``sweep_lines``
    equals it; the quotient would give another count on some widths."""
    b = CFG.block_size
    rng = np.random.default_rng(int(vmapped))
    base = (rng.integers(1, 120, 20_000) * np.float32(b)).astype(np.float32)
    width = (base.view(np.int32) + rng.integers(-3, 4, 20_000).astype(np.int32)).view(np.float32)

    def ref(w):
        shift = jnp.ceil((w / jnp.float32(b)) / 2.0).astype(jnp.int32)
        return shift, jnp.ceil(w / jnp.float32(b)).astype(jnp.int32) + 3

    if vmapped:
        want = jax.jit(jax.vmap(ref))(width)
    else:
        one = jax.jit(ref)
        want = [np.array(x) for x in zip(*(one(w) for w in width[:2000]))]
        width = width[:2000]
    shift, n_lines = sweep_lines(torch.tensor(width), b)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(n_lines.numpy(), np.asarray(want[1]))
    quotient = np.ceil(width / np.float32(b)).astype(np.int32) + 3
    assert (quotient != np.asarray(want[1])).any()
