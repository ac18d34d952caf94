"""RANSAC's round as the card runs it, on the CPU: the hypotheses built,
gated and scored in one call (``ops.ransac.ransac_hypotheses_score``) and
the mask that closes the round (``plane_inliers_close``).

Their plain versions are held bitwise to the composition ``_plane_once``
and ``_segment_planes`` wrote before them (written out here as it stood):
the hypotheses' arithmetic, the axis gate as ``torch.arccos(c) <= eps``, the
scoring, and the where chain that kept the loop's state.  The closing form
rests on an invariant of the refinement, held pass by pass: the running
mask is the mask of the running plane.  The axis gate's threshold form
(``axis_cos_min``) is held to the JAX package's own decision,
``jnp.arccos(c) <= eps``, around its threshold; then ``segment_planes`` and
``process_scan`` against the JAX package, planes bitwise.  On the CPU no
kernel is launched; ``tests/test_torch_cuda.py`` holds the kernels to these
plain versions on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_pipeline import CFG as PIPE_CFG
from test_torch_pipeline import _crosscheck
from test_torch_ransac import _planes_scene, jax_key_chain_draw
from test_torch_ransac_score import _composition_before

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac
from pointcloud_obstacle_processing_tpu.utils.scene import SceneSpec as RefSceneSpec
from pointcloud_obstacle_processing_tpu.utils.scene import make_scene as ref_make_scene

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud, _build, pipeline
from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG
from pointcloud_obstacle_processing_tpu_torch.ops import (add_sq3, dot3, f32, fma, ransac, sqrt32,
                                                          sum_like_xla)
from pointcloud_obstacle_processing_tpu_torch.types import scan_of
from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases
from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

ONE = 0x3F800000  # the bits of 1.0f
GATES = {"bug": CFG.eps_angle_radians,  # 20 "radians": every axis passes
         "degrees": CFG.replace(pcl_compat_eps_angle_bug=False).eps_angle_radians}


def _hypotheses_before(points, tri, n_valid, eps_angle, axis=(0.0, 0.0, 1.0)):
    """The hypotheses as ``_plane_once`` wrote them inline before
    ``ransac_hypotheses_score``, the axis gate through ``torch.arccos``."""
    ax = [f32(a) for a in axis]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def g(v, idx):
        return v.gather(-1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)

    i0, i1, i2 = tri[..., 0], tri[..., 1], tri[..., 2]
    p0x, p0y, p0z = g(x, i0), g(y, i0), g(z, i0)
    p1x, p1y, p1z = g(x, i1), g(y, i1), g(z, i1)
    p2x, p2y, p2z = g(x, i2), g(y, i2), g(z, i2)
    ux, uy, uz = p1x - p0x, p1y - p0y, p1z - p0z
    vx, vy, vz = p2x - p0x, p2y - p0y, p2z - p0z
    nx = fma(uy, vz, -(uz * vy))
    ny = fma(uz, vx, -(ux * vz))
    nz = fma(ux, vy, -(uy * vx))
    norms = sqrt32(add_sq3(nx, ny, nz))
    degenerate = norms < f32(1e-12)
    inv = 1.0 / torch.clamp_min(norms, 1e-20)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    ds = -dot3(nx, ny, nz, p0x, p0y, p0z)
    cosang = torch.clamp(torch.abs(nx * ax[0] + ny * ax[1] + nz * ax[2]), 0.0, 1.0)
    axis_ok = torch.arccos(cosang) <= f32(eps_angle)
    gate = axis_ok & ~degenerate & (n_valid >= 3)[:, None]
    return nx, ny, nz, ds, gate


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _round_inputs(seed, fills, n=1536, k=128, degenerate=False):
    """A batch of ``_planes_scene`` clouds with ``fills`` valid points each
    (0-2 among them), drawn as ``_plane_once`` draws: uniform indices into
    the valid points through the valid-first permutation.  With
    ``degenerate``, each scan's first points are three collinear points and
    hypotheses 0-15 draw them, repeat a point, or draw one point thrice."""
    rng = np.random.default_rng(seed)
    pts, valid = zip(*[_planes_scene(seed * 10 + i, n, f) for i, f in enumerate(fills)])
    pts, valid = np.stack(pts), np.stack(valid)
    if degenerate:
        t = rng.uniform(0, 1, (len(fills), 3, 1)).astype(np.float32)
        pts[:, :3] = np.float32([1.0, 2.0, 0.1]) + t * np.float32([0.5, -0.25, 0.0])
    points, valid = torch.tensor(pts), torch.tensor(valid)
    n_valid = valid.sum(-1, dtype=torch.int32)
    hi = np.maximum(n_valid.numpy(), 1)[:, None, None]
    u = (rng.random((len(fills), k, 3)) * hi).astype(np.int64)
    if degenerate:
        u[:, 0:4] = [0, 1, 2]  # collinear
        u[:, 4:8] = [0, 0, 1]  # a repeated point
        u[:, 8:12] = [2, 1, 2]
        u[:, 12:16] = [1, 1, 1]  # one point thrice
        u = np.minimum(u, hi - 1)
    perm = torch.sort(valid.to(torch.int8), dim=-1, descending=True, stable=True).indices
    tri = ransac._gather(perm, torch.tensor(u))
    return points, valid, tri, n_valid


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("case", ["seeded", "degenerate", "few_valid"])
def test_hypotheses_score_plain_is_the_composition_it_replaces(case, gate):
    """``ransac_hypotheses_score_plain`` (and the wrapper on CPU tensors,
    which launches nothing) bitwise the composition it replaces: found,
    normal and offset, and through ``hypotheses_plain`` and
    ``ransac_score_plain`` the counts and the winner, on seeded clouds, on collinear and
    repeated points, and on scans with 0, 1 and 2 valid points beside ones
    that find a plane; the gate with the shipped radians misreading (every
    axis passes) and with 20 degrees."""
    fills = {"seeded": [1400, 900, 1536], "degenerate": [1200, 700],
             "few_valid": [0, 1, 2, 1100]}[case]
    points, valid, tri, n_valid = _round_inputs(len(fills) + len(case), fills,
                                                degenerate=case == "degenerate")
    eps = GATES[gate]
    thresh = f32(CFG.plane_segment_dist_thresh)
    want = _composition_before(points, valid, *_hypotheses_before(points, tri, n_valid, eps),
                               thresh)[:5]
    cos_min = ransac.axis_cos_min(eps)
    _build.reset_launch_counts()
    got = ransac.ransac_hypotheses_score(points, valid, tri, n_valid, thresh, cos_min)
    assert not any(_build.LAUNCHES.values())
    for g, w in zip(got, want[2:], strict=True):
        _bits_equal(g, w)
    for g, w in zip(ransac.ransac_hypotheses_score_plain(points, valid, tri, n_valid, thresh,
                                                         cos_min, (0.0, 0.0, 1.0)), want[2:],
                    strict=True):
        _bits_equal(g, w)
    planes = ransac.hypotheses_plain(points, tri, n_valid, cos_min, (0.0, 0.0, 1.0))
    for g, w in zip(planes, _hypotheses_before(points, tri, n_valid, eps)):
        _bits_equal(g, w)
    counts = ransac.ransac_score_plain(points, valid, *planes, thresh).counts
    for g, w in zip(ransac.ransac_score_plain(points, valid, *planes, thresh)[:5], want,
                    strict=True):
        _bits_equal(g, w)
    if case == "few_valid":
        assert not got.found[:3].any() and (counts[:3] == -1).all() and got.found[3]
    if case == "degenerate":  # a repeated point: no plane (collinear float32 points still make one)
        assert not planes[4][:, 4:16].any()
    unit = planes[0] ** 2 + planes[1] ** 2 + planes[2] ** 2 > 0.5  # a normalised normal
    allowed = (n_valid >= 3)[:, None] & unit
    if gate == "degrees":  # the gate binds: planes steeper than 20 degrees are off
        assert torch.equal(planes[4], allowed & (torch.abs(planes[2]) >= cos_min))
        assert (allowed & ~planes[4]).any()
    else:  # every axis passes
        assert torch.equal(planes[4], allowed)


def _jnp_cos_min(eps):
    """The least float32 c in [0, 1] with ``jnp.arccos(c) <= eps`` (jitted,
    on XLA:CPU), by bisection over the bit patterns; None where none."""
    passes = jax.jit(lambda c: jnp.arccos(c) <= jnp.float32(eps))

    def ok(bits):
        return bool(passes(np.int32(bits).view(np.float32)))

    lo, hi = 0, ONE
    if not ok(hi):
        return None
    if ok(lo):
        return 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if ok(mid) else (mid, hi)
    return hi


EPS = [GATES["bug"], GATES["degrees"], *np.random.default_rng(19).uniform(0.0, np.pi / 2, 6),
       1.2774819135665894, 0.0, -0.5]


@pytest.mark.parametrize("eps", EPS, ids=[f"{e:.6g}" for e in EPS])
def test_axis_cos_min_is_the_reference_decision(eps):
    """``axis_cos_min`` against the JAX package's ``jnp.arccos(c) <= eps``:
    the same threshold, and the same decision on every float32 within
    65,536 ulps of it and on NaN, for both presets' eps, six seeded ones in
    (0, pi/2), one where torch's own ``arccos`` decides a float32 apart
    from the reference's, 0, and a negative eps, which no c passes."""
    e = np.float32(eps)
    got = ransac.axis_cos_min(eps)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = _jnp_cos_min(e)
    if want is None:
        assert float(got) == np.inf
        return
    assert int(got.view(torch.int32)) == want
    bits = np.arange(max(want - 65_536, 0), min(want + 65_536, ONE) + 1, dtype=np.int32)
    c = bits.view(np.float32)
    ref = np.asarray(jax.jit(lambda v: jnp.arccos(v) <= jnp.float32(e))(c))
    np.testing.assert_array_equal(ref, c >= np.float32(got))
    nan = np.float32(np.nan)
    assert not bool(jnp.arccos(nan) <= e) and not bool(torch.tensor(nan) >= got)
    # torch's own arccos, which the gate took before: its threshold (printed
    # under -s; an ulp apart from the reference's at some eps)
    lo, hi = 0, ONE
    while hi - lo > 1:
        mid = (lo + hi) // 2
        t = torch.arccos(torch.tensor(np.int32([mid] * 64).view(np.float32)))[0] <= torch.tensor(e)
        lo, hi = (lo, mid) if bool(t) else (mid, hi)
    print(f"eps {e!r}: cos_min bits {want}; torch.arccos's {hi if want else 0}")


def _plane_once_before(cloud, u, config, axis, vmapped, pts1, n_valid):
    """``_plane_once`` as it stood before the round closed in place: the
    winner and its mask, every refinement pass followed by its mask with
    the ``n_inl < 3`` select, then the selects on ``found`` (the
    reference's form), from the plain versions.  Asserts the invariant the
    closing form rests on at every step: the running mask is the plain mask
    of the running plane.  Returns the ``PlaneOnceResult`` and the passes
    whose select kept the scan's mask (n_inl < 3)."""
    pts, valid = cloud.points, cloud.valid
    thresh = f32(config.plane_segment_dist_thresh)
    perm = torch.sort(valid.to(torch.int8), dim=-1, descending=True, stable=True).indices
    planes = ransac.hypotheses_plain(pts, ransac._gather(perm, u), n_valid,
                                     ransac.axis_cos_min(config.eps_angle_radians), axis)
    _, _, found, normal, d, inliers = ransac.ransac_score_plain(pts, valid, *planes, thresh)
    assert torch.equal(inliers, ransac.plane_inliers_plain(pts, valid, normal, d, thresh))
    r_normal, r_d, r_in, kept = normal, d, inliers, 0
    for _ in range(config.ransac_refine_iters):
        s4 = sum_like_xla(torch.where(r_in[:, None, :], pts1, 0.0))
        n_inl = s4[:, 3]
        cen = s4[:, :3] / torch.clamp_min(n_inl, 3.0)[:, None]
        off = pts1[:, :3] - cen[..., None]
        r_normal, r_d = ransac.covariance_tail(torch.where(r_in[:, None, :], off, 0.0), off, cen,
                                               n_inl, r_normal, r_d, vmapped)
        r_in = ransac.plane_inliers_plain(pts, valid, r_normal, r_d, thresh, r_in, n_inl)
        assert torch.equal(r_in, ransac.plane_inliers_plain(pts, valid, r_normal, r_d, thresh))
        kept += int((n_inl < 3.0).sum())
    res = ransac.PlaneOnceResult(
        normal=torch.where(found[:, None], r_normal, normal), d=torch.where(found, r_d, d),
        inliers=torch.where(found[:, None], r_in, inliers) & found[:, None], found=found)
    return res, kept


def _chain_before(res, active, state):
    """The loop's state update as ``_segment_planes`` wrote it before
    ``plane_inliers_close``, from the round's ``PlaneOnceResult`` (the
    refinement's last mask and its selects, ``where(found, ...)``)."""
    valid, union, last, coeffs, pvalid, i, found = state
    slots = torch.arange(coeffs.shape[1])
    at_i = slots == i[:, None]
    row = torch.cat([res.normal, res.d[:, None]], dim=-1)
    coeffs = torch.where((active & res.found)[:, None, None] & at_i[..., None], row[:, None, :],
                         coeffs)
    pvalid = torch.where(active[:, None] & at_i, res.found[:, None], pvalid)
    a = active[:, None]
    return ransac.RoundState(
        valid=torch.where(a, valid & ~res.inliers, valid),
        union=torch.where(a, union | res.inliers, union),
        last=torch.where(a, res.inliers, last),
        coeffs=coeffs, pvalid=pvalid,
        i=i + (active & res.found).to(torch.int32),
        found=torch.where(active, res.found, found))


@pytest.mark.parametrize("refine_iters", [0, 1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_close_plain_is_the_where_chain_it_replaces(seed, refine_iters):
    """``plane_inliers_close_plain`` (and the wrapper on CPU tensors) on
    seeded round states, bitwise the where chain it replaces: a batch of 6
    scans (two with 0 and 2 valid points, whose round finds no plane),
    each active or not, at plane slots 0 to ``max_planes`` (none free),
    with random union, last, coeffs, pvalid and found."""
    cfg = CFG.replace(ransac_refine_iters=refine_iters)
    rng = np.random.default_rng(seed)
    fills = [1400, 0, 1000, 2, 1536, 800]
    points, valid, tri, _ = _round_inputs(40 + seed, fills)
    b, n = valid.shape
    draws = torch.tensor(rng.integers(0, np.maximum(valid.sum(-1).numpy(), 1)[:, None, None],
                                      (b, cfg.ransac_hypotheses, 3)))
    cloud = Cloud(points=points, valid=valid)
    pts1 = ransac._with_ones(points)
    res, _ = _plane_once_before(cloud, draws, cfg, (0.0, 0.0, 1.0), True, pts1,
                                valid.sum(-1, dtype=torch.int32))
    r = ransac._round_plane(cloud, draws, cfg, (0.0, 0.0, 1.0), True, pts1)
    plane = (r.refined_normal, r.refined_d, r.found)
    mp = cfg.max_planes
    state = ransac.RoundState(
        valid=valid, union=torch.tensor(rng.random((b, n)) < 0.3),
        last=torch.tensor(rng.random((b, n)) < 0.3),
        coeffs=torch.tensor(rng.standard_normal((b, mp, 4)).astype(np.float32)),
        pvalid=torch.tensor(rng.random((b, mp)) < 0.5),
        i=torch.tensor([0, 1, mp - 1, mp, 2, 0], dtype=torch.int32),
        found=torch.tensor(rng.random(b) < 0.5))
    active = torch.tensor([True, True, False, True, True, False])
    thresh = f32(cfg.plane_segment_dist_thresh)
    want = _chain_before(res, active, state)
    _build.reset_launch_counts()
    for fn in (ransac.plane_inliers_close, ransac.plane_inliers_close_plain):
        got = fn(points, *plane, active, thresh, state)
        for f, g, w in zip(want._fields, got, want):
            assert g.dtype == w.dtype, f
            _bits_equal(g, w)
    assert not any(_build.LAUNCHES.values())
    assert not res.found[1] and not res.found[3] and res.found[[0, 2, 4, 5]].all()


def _crosscheck_clouds():
    """The clouds that enter ``segment_planes`` in the port's CPU scans of
    ``scripts/crosscheck_tpu_cpu.py``'s scenes: the reduced case (seed 77)
    and the flagship's bench scan 0; then a batch with a scan of 2 valid
    points, whose refinement keeps its plane (n_inl < 3)."""
    reduced = CFG.replace(max_points=32768, max_voxels=16384, cluster_capacity=2048,
                          max_clusters=16, downsample_leaf_size=0.06, knn_backend="banded")
    cases = [(reduced, SceneSpec(n_ground=20000, n_rocks=3, points_per_rock=1000, n_noise=100),
              77),
             (FLAGSHIP_CONFIG, SceneSpec(n_ground=90_000, n_rocks=4, points_per_rock=2_000,
                                         n_noise=500), 0)]
    out = []
    for cfg, spec, seed in cases:
        pts = make_scene(seed=seed, spec=spec).points[: cfg.max_points]
        seen = []
        fn = pipeline.segment_planes
        pipeline.segment_planes = lambda cloud, *a, **kw: seen.append(cloud) or fn(cloud, *a, **kw)
        try:
            u = np.random.default_rng(seed).random((cfg.max_planes, cfg.ransac_hypotheses, 3))
            pipeline.process_scan(Cloud.pad_to(pts, cfg.max_points), cfg,
                                  draw=ransac.draw_from_uniform(torch.tensor(u, dtype=torch.float32)))
        finally:
            pipeline.segment_planes = fn
        out.append((f"crosscheck seed {seed}", cfg, seen[0]))
    bufs, valids = zip(*[_planes_scene(90 + s, 2048, f) for s, f in enumerate([1600, 2, 1200])])
    out.append(("planes batch", CFG, Cloud.from_points(np.stack(bufs), np.stack(valids))))
    return out


def test_running_mask_is_the_running_planes_mask(monkeypatch):
    """The invariant the closing form rests on, pass by pass, on the
    crosscheck's scenes with 4 refinement passes: in every round of
    ``segment_planes``, the round as it ran before (``_plane_once_before``:
    each refinement mask with its n_inl < 3 select) keeps a running mask
    equal to the plain mask of its running plane, and its final mask,
    plane and found (found's selects) are those the round now gives
    (``_round_plane``), with the final mask the plain mask of its last
    plane where found, which is what the closing form applies; then
    ``ransac_plane_once`` on the round's input is the old form bitwise."""
    rounds, kept, inside = [0], [0], [False]
    real_round = ransac._round_plane

    def round_plane(cloud, u, config, axis, vmapped, pts1, n_valid=None):
        r = real_round(cloud, u, config, axis, vmapped, pts1, n_valid)
        if inside[0]:  # ransac_plane_once's own round, below
            return r
        before, k = _plane_once_before(cloud, u, config, axis, vmapped, pts1, n_valid)
        final = ransac.plane_inliers_plain(cloud.points, cloud.valid, r.refined_normal,
                                           r.refined_d, f32(config.plane_segment_dist_thresh))
        assert torch.equal(before.inliers, final & r.found[:, None])
        assert torch.equal(before.found, r.found)
        _bits_equal(before.normal, torch.where(r.found[:, None], r.refined_normal, r.normal))
        _bits_equal(before.d, torch.where(r.found, r.refined_d, r.d))
        inside[0] = True
        try:
            once = ransac.ransac_plane_once(cloud, u, config, axis, vmapped)
        finally:
            inside[0] = False
        for f, g, w in zip(before._fields, once, before):
            assert g.dtype == w.dtype, f
            _bits_equal(g, w)
        rounds[0] += 1
        kept[0] += k
        return r

    clouds = _crosscheck_clouds()
    monkeypatch.setattr(ransac, "_round_plane", round_plane)
    for label, cfg, cloud in clouds:
        cfg = cfg.replace(ransac_refine_iters=4)
        draw = ransac.draw_from_uniform(torch.tensor(np.random.default_rng(3).random(
            (*cloud.valid.shape[:-1], cfg.max_planes, cfg.ransac_hypotheses, 3)),
            dtype=torch.float32))
        seg = ransac.segment_planes(cloud, cfg, draw)
        assert int(seg.planes.num_planes.sum()) >= 1, label
    assert rounds[0] >= 3 * 3 and kept[0] >= 3  # the 2-point scan keeps its plane


@pytest.mark.parametrize("batch", [False, True])
def test_segment_planes_with_the_axis_gate_is_bitwise_the_reference(batch):
    """``segment_planes`` with the gate in degrees (cos_min = cos 20 deg;
    the ramp of ``_planes_scene`` passes, steeper planes do not) against
    the jitted reference, alone or under ``jax.vmap`` over 3 scans: planes,
    masks and the truncation flag bitwise."""
    ref_cfg, cfg = (c.replace(pcl_compat_eps_angle_bug=False) for c in (REF_CFG, CFG))
    scenes = [_planes_scene(80 + s, 2048, 1500 + 100 * s) for s in range(3 if batch else 1)]
    keys = jax.random.split(jax.random.PRNGKey(8), len(scenes))
    seg = lambda c, k: ref_ransac.segment_planes(c, k, ref_cfg)  # noqa: E731
    chains = [jax_key_chain_draw(k, cfg.ransac_hypotheses) for k in keys]
    pts, valid = (np.stack(v) for v in zip(*scenes))
    if batch:
        r = jax.jit(jax.vmap(seg))(RefCloud.from_points(pts, valid), keys)
        p = ransac.segment_planes(
            Cloud.from_points(pts, valid), cfg,
            lambda rnd, n_valid: torch.stack([c(rnd, n_valid[b]) for b, c in enumerate(chains)]))
    else:
        r = jax.jit(seg)(RefCloud.from_points(pts[0], valid[0]), keys[0])
        p = ransac.segment_planes(Cloud.from_points(pts[0], valid[0]), cfg, chains[0])
    np.testing.assert_array_equal(np.asarray(r.planes.num_planes), p.planes.num_planes.numpy())
    np.testing.assert_array_equal(np.asarray(r.planes.valid), p.planes.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.planes.coeffs).view(np.int32),
                                  p.planes.coeffs.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(r.nonplane_cloud.valid), p.nonplane_cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.plane_union), p.plane_union.numpy())
    np.testing.assert_array_equal(np.asarray(r.last_plane), p.last_plane.numpy())
    np.testing.assert_array_equal(np.asarray(r.truncated), p.truncated.numpy())
    assert int(np.asarray(r.planes.num_planes).sum()) >= 1


def test_hypotheses_under_vmap_are_the_single_scans():
    """The reference's hypotheses (refinement off, 8 hypotheses on fixed
    draws) alone and under ``jax.vmap`` over 3 scans give the same planes,
    and the port's one form equals both, bit for bit."""
    k = 8
    ref_cfg = REF_CFG.replace(ransac_refine_iters=0, ransac_hypotheses=k)
    cfg = CFG.replace(ransac_refine_iters=0, ransac_hypotheses=k)
    bufs, valids = zip(*[_planes_scene(30 + s, 256, 200) for s in range(3)])
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    once = lambda c, key: ref_ransac.ransac_plane_once(c, key, ref_cfg)  # noqa: E731
    vm = jax.jit(jax.vmap(once))(RefCloud.from_points(np.stack(bufs), np.stack(valids)), keys)
    single = [jax.jit(once)(RefCloud.from_points(b, v), key)
              for b, v, key in zip(bufs, valids, keys)]
    draws = [np.asarray(jax.random.randint(key, (k, 3), 0, 200)) for key in keys]
    port = ransac.ransac_plane_once(Cloud.from_points(np.stack(bufs), np.stack(valids)),
                                    torch.tensor(np.stack(draws)), cfg)
    for s in range(3):
        for name in ("normal", "d"):
            a = np.asarray(getattr(vm, name))[s].view(np.int32)
            np.testing.assert_array_equal(a, np.asarray(getattr(single[s], name)).view(np.int32))
            np.testing.assert_array_equal(a, getattr(scan_of(port, s), name).numpy().view(np.int32))


@pytest.mark.parametrize("scans,n,k", [(2, 4000, 64), (3, 1500, 200)])
def test_round_case_probes_sit_on_both_sides_of_the_threshold(scans, n, k):
    """``ransac_cases.round_case``'s probes, which the card tests and
    ``chip_smoke.py`` hand the score kernel: hypothesis 0 of each scan
    draws three points whose plane (``hypotheses_plain``) has valid rows at
    the threshold and at its immediate float32 neighbours on both sides,
    and the plain mask follows ``|dist| < thresh`` at each."""
    c = ransac_cases.round_case(5, scans, n, k, "probes")
    points, valid, tri, n_valid = (torch.tensor(c[f]) for f in ("points", "valid", "tri",
                                                                 "n_valid"))
    nx, ny, nz, ds, gate = ransac.hypotheses_plain(points, tri, n_valid, f32(0.0),
                                                   (0.0, 0.0, 1.0))
    assert gate[:, 0].all()
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    t = np.float32(ransac_cases.THRESH)
    near = [np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))]
    for b in range(scans):
        dist = torch.abs(dot3(x[b], y[b], z[b], nx[b, 0], ny[b, 0], nz[b, 0]) + ds[b, 0])
        seen = set(dist[valid[b]].numpy().tolist())
        assert all(float(v) in seen for v in near), b
    normal = torch.stack([nx[:, 0], ny[:, 0], nz[:, 0]], -1)
    mask = ransac.plane_inliers_plain(points, valid, normal, ds[:, 0], c["thresh"])
    dist = torch.abs(dot3(x, y, z, normal[:, :1], normal[:, 1:2], normal[:, 2:]) + ds[:, :1])
    assert torch.equal(mask, (dist < c["thresh"]) & valid)


@pytest.mark.parametrize("scans,n,k", [(1, 900, 300), (3, 2000, 128)])
def test_round_case_ties_go_to_the_first_k(scans, n, k):
    """``round_case``'s ties: each scan's best triple drawn again at other
    k ties the largest count, and the round's winner is the least of the
    tied k, its plane theirs bitwise."""
    c = ransac_cases.round_case(2, scans, n, k, "ties")
    args = [torch.tensor(c[f]) for f in ("points", "valid", "tri", "n_valid")]
    cos_min = ransac.axis_cos_min(GATES["bug"])
    planes = ransac.hypotheses_plain(args[0], args[2], args[3], cos_min, (0.0, 0.0, 1.0))
    full = ransac.ransac_score_plain(args[0], args[1], *planes, c["thresh"])
    got = ransac.ransac_hypotheses_score_plain(*args, c["thresh"], cos_min, (0.0, 0.0, 1.0))
    for b in range(scans):
        tied = torch.nonzero(full.counts[b] == full.counts[b].max())[:, 0]
        assert len(tied) >= 2 and int(full.best[b]) == int(tied[0]), b
        _bits_equal(got.normal[b], torch.stack([p[b, tied[-1]] for p in planes[:3]]))
        _bits_equal(got.d[b], planes[3][b, tied[-1]])


def test_round_case_gated_finds_nothing_where_every_draw_repeats_a_point():
    """``round_case``'s gated draws: a repeated point makes a degenerate
    plane, gated off; scan 0, all such, finds no plane (winner k = 0),
    the others keep about half their hypotheses."""
    c = ransac_cases.round_case(4, 3, 700, 64, "gated")
    args = [torch.tensor(c[f]) for f in ("points", "valid", "tri", "n_valid")]
    cos_min = ransac.axis_cos_min(GATES["bug"])
    planes = ransac.hypotheses_plain(args[0], args[2], args[3], cos_min, (0.0, 0.0, 1.0))
    full = ransac.ransac_score_plain(args[0], args[1], *planes, c["thresh"])
    assert not planes[4][0].any() and (full.counts[0] == -1).all() and int(full.best[0]) == 0
    assert not bool(full.found[0]) and full.found[1:].all()
    assert (planes[4][1:].sum(-1) < 64).all() and (planes[4][1:].sum(-1) > 10).all()


def test_score_forms_fill_the_card():
    """``score_form`` on the H100's 132 SMs: the flagship's 48 row blocks
    split into 4 slices of 32 hypotheses; fullscale, the batch of 32 and
    the fullscale batch of 2 fill the card unsplit (8 rows a thread for the
    batch of 32); past one staged chunk no split."""
    assert ransac.score_form(1, 24_576, 128, 132) == (2, 32)
    assert ransac.score_form(1, 262_144, 128, 132) == (2, 128)
    assert ransac.score_form(32, 24_576, 128, 132) == (8, 128)
    assert ransac.score_form(2, 262_144, 128, 132) == (2, 128)
    assert ransac.score_form(1, 24_576, 200, 132) == (2, 64)  # 7 groups in 4 slices
    assert ransac.score_form(2, 300, 1100, 132) == (2, 1120)
    assert ransac.score_form(3, 1000, 1, 132) == (2, 32)


def test_process_scan_on_the_reduced_crosscheck_case_meets_the_bar():
    """``process_scan`` of ``scripts/crosscheck_tpu_cpu.py``'s reduced case
    (seed 77, banded kNN) against the JAX package on the reference's key
    chain: the crosscheck bar, planes bitwise; then the pipeline's small
    config with the gate in degrees."""
    spec = RefSceneSpec(n_ground=20000, n_rocks=3, points_per_rock=1000, n_noise=100)
    ref_cfg = REF_CFG.replace(max_points=32768, max_voxels=16384, cluster_capacity=2048,
                              max_clusters=16, downsample_leaf_size=0.06, knn_backend="banded")
    for cfg, seed in ((ref_cfg, 77), (PIPE_CFG.replace(pcl_compat_eps_angle_bug=False), 11)):
        r, p = _crosscheck(cfg, ref_make_scene(seed=seed, spec=spec).points, seed)
        np.testing.assert_array_equal(np.asarray(r.planes.coeffs).view(np.int32),
                                      p.planes.coeffs.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(r.planes.valid), p.planes.valid.numpy())
        assert int(p.stats.num_planes) >= 1
