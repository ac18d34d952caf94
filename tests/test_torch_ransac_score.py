"""RANSAC's scoring and selection on given planes (``ops.ransac.
ransac_score_plain``, the score kernel's reference with ``hypotheses_plain``)
and its inlier mask (``plane_inliers``) on the CPU.

The plain versions are the composition ``_plane_once`` ran before the
round's kernels (the ``[B, N, K]`` distance table, its mask and count, the
gate, ``argmax`` and the gathers; the refinement's distance, threshold and
select), written out here as it stood and held bitwise to them on seeded
clouds and on points a few ulps either side of the threshold.  Then the
round as a whole against the JAX package: ``ransac_plane_once`` and
``segment_planes`` bitwise the reference's for K in {64, 128, 200}, one
scan and a batch of 3.  On the CPU no kernel is launched;
``tests/test_torch_cuda.py`` holds the kernels to these plain versions on
the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ransac import _planes_scene, jax_key_chain_draw

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
from pointcloud_obstacle_processing_tpu_torch.ops import dot3, ransac
from pointcloud_obstacle_processing_tpu_torch.types import scan_of
from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases


def _case(seed, scans, n, k, kind):
    c = ransac_cases.score_case(seed, scans, n, k, kind)
    args = [torch.tensor(c[f]) for f in ("points", "valid", "nx", "ny", "nz", "ds", "gate")]
    return args, c["thresh"]


def _composition_before(points, valid, nx, ny, nz, ds, gate, thresh):
    """The scoring and selection as ``_plane_once`` wrote them inline before
    the score kernel."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dists = torch.abs(dot3(x[..., None], y[..., None], z[..., None], nx[:, None, :],
                           ny[:, None, :], nz[:, None, :]) + ds[:, None, :])
    inl = (dists < thresh) & valid[..., None]
    counts = inl.sum(dim=-2, dtype=torch.int32)
    counts = torch.where(gate, counts, -1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    found = counts.gather(-1, best)[:, 0] > 0
    normal = torch.stack([nx, ny, nz], dim=-1).gather(1, best[..., None].expand(-1, 1, 3))[:, 0]
    d = ds.gather(-1, best)[:, 0]
    inliers = inl.gather(-1, best[:, None, :].expand(-1, inl.shape[1], 1))[..., 0]
    return counts, best[:, 0], found, normal, d, inliers


def _mask_before(points, valid, normal, d, thresh, prev, n_inl):
    """The refinement's mask and select as ``_plane_once`` wrote them."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    new_in = (torch.abs(dot3(x, y, z, normal[:, 0, None], normal[:, 1, None], normal[:, 2, None])
                        + d[:, None]) < thresh) & valid
    return new_in if prev is None else torch.where((n_inl >= 3.0)[:, None], new_in, prev)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["probes", "ties", "gated", "random"])
@pytest.mark.parametrize("scans,n,k", [(1, 700, 64), (3, 2000, 128), (2, 333, 200)])
def test_score_plain_is_the_composition_it_replaces(kind, scans, n, k):
    args, thresh = _case(11, scans, n, k, kind)
    want = _composition_before(*args, thresh)
    _build.reset_launch_counts()
    got = ransac.ransac_score_plain(*args, thresh)
    assert not any(_build.LAUNCHES.values())
    for g, w in zip(got, want, strict=True):
        _bits_equal(g, w)
    assert got.counts.shape == (scans, k) and got.inliers.shape == (scans, n)


def test_probes_sit_on_both_sides_of_the_threshold():
    """The probe set decides points a few ulps apart: hypothesis 0's
    distances reach the threshold's immediate neighbours on both sides,
    and the mask follows ``|dist| < thresh`` at each."""
    args, thresh = _case(3, 2, 4000, 64, "probes")
    points, valid, nx, ny, nz, ds, _ = args
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dist = torch.abs(dot3(x, y, z, nx[:, :1], ny[:, :1], nz[:, :1]) + ds[:, :1])
    t = np.float32(ransac_cases.THRESH)
    near = np.array([np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))])
    seen = set(dist[valid].numpy().tolist())
    assert all(float(v) in seen for v in near)
    normal = torch.stack([nx[:, 0], ny[:, 0], nz[:, 0]], -1)
    mask = ransac.plane_inliers(points, valid, normal, ds[:, 0], thresh)
    np.testing.assert_array_equal(mask.numpy(), (dist < thresh).numpy() & valid.numpy())


@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("kind", ["probes", "random"])
def test_plane_inliers_plain_is_the_refinement_mask(kind, select):
    args, thresh = _case(5, 3, 1500, 16, kind)
    points, valid, nx, ny, nz, ds, _ = args
    normal, d = torch.stack([nx[:, 3], ny[:, 3], nz[:, 3]], -1), ds[:, 3]
    if kind == "probes":
        normal, d = torch.stack([nx[:, 0], ny[:, 0], nz[:, 0]], -1), ds[:, 0]
    prev = n_inl = None
    if select:
        prev = torch.tensor(np.random.default_rng(1).random((3, 1500)) < 0.5)
        n_inl = torch.tensor([2.0, 3.0, 2.9990234], dtype=torch.float32)
    want = _mask_before(points, valid, normal, d, thresh, prev, n_inl)
    got = ransac.plane_inliers(points, valid, normal, d, thresh, prev=prev, n_inl=n_inl)
    assert torch.equal(got, want) and got.dtype == torch.bool
    assert torch.equal(ransac.plane_inliers_plain(points, valid, normal, d, thresh, prev, n_inl),
                       want)
    if select:  # scans 0 and 2 keep prev
        assert torch.equal(got[0], prev[0]) and torch.equal(got[2], prev[2])


def test_ties_go_to_the_first_k():
    """Equal counts at several k, in different warps of the selection: the
    least k wins, and a copy gated off does not."""
    args, thresh = _case(2, 1, 900, 300, "random")
    points, valid, nx, ny, nz, ds, gate = args
    gate[:] = True
    top = int(ransac.ransac_score_plain(*args, thresh).best[0])
    planes = (nx, ny, nz, ds)
    for k in (7, 40, 299):  # copies of the winner, in three warps
        for t in planes:
            t[0, k] = t[0, top]
    if top not in (7, 40, 299):  # the winner itself now holds no inlier
        for t, v in zip(planes, (0.0, 0.0, 1.0, -100.0)):
            t[0, top] = v
    got = ransac.ransac_score_plain(*args, thresh)
    order = [k for k in range(300) if int(got.counts[0, k]) == int(got.counts[0].max())]
    assert {7, 40, 299} <= set(order) and int(got.best[0]) == order[0]
    gate[0, order[0]] = False
    got = ransac.ransac_score_plain(*args, thresh)
    assert int(got.best[0]) == order[1] and int(got.counts[0, order[0]]) == -1


def test_all_gated_off_is_k0_and_not_found():
    args, thresh = _case(4, 2, 500, 64, "gated")
    got = ransac.ransac_score_plain(*args, thresh)
    assert (got.counts[0] == -1).all() and int(got.best[0]) == 0 and not bool(got.found[0])
    nx, ny, nz, ds = args[2:6]
    _bits_equal(got.normal[0], torch.stack([nx[0, 0], ny[0, 0], nz[0, 0]]))
    _bits_equal(got.d[0], ds[0, 0])


def test_fewer_than_three_valid_points_find_no_plane():
    """``n_valid < 3`` gates every hypothesis off: the winner is k = 0 and
    no plane is found, in a batch beside a scan that finds one."""
    pts, valid = _planes_scene(6, 1024, 900)
    pts2, valid2 = _planes_scene(6, 1024, 2)
    cloud = Cloud.from_points(np.stack([pts, pts2]), np.stack([valid, valid2]))
    draws = torch.tensor(np.random.default_rng(0).integers(0, [[[900]], [[2]]], (2, 64, 3)))
    got = ransac.ransac_plane_once(cloud, draws, CFG.replace(ransac_hypotheses=64))
    assert bool(got.found[0]) and not bool(got.found[1]) and not got.inliers[1].any()


def _ref_draws(keys, hypotheses, valids):
    return [np.asarray(jax.random.randint(key, (hypotheses, 3), 0,
                                          jnp.maximum(jnp.sum(jnp.asarray(v).astype(jnp.int32)),
                                                      1)))
            for key, v in zip(keys, valids)]


@pytest.mark.parametrize("hypotheses", [64, 128, 200])
@pytest.mark.parametrize("batch", [False, True])
def test_plane_once_is_bitwise_the_reference(hypotheses, batch):
    """``ransac_plane_once`` (two refinement passes) against the jitted
    reference, alone or under ``jax.vmap`` over 3 scans: normal, offset,
    inliers and found bitwise."""
    ref_cfg, cfg = (c.replace(ransac_hypotheses=hypotheses) for c in (REF_CFG, CFG))
    bufs, valids = zip(*[_planes_scene(60 + s, 2048, 1300 + 200 * s) for s in range(3)])
    keys = jax.random.split(jax.random.PRNGKey(hypotheses), 3)
    draws = _ref_draws(keys, hypotheses, valids)
    once = lambda c, k: ref_ransac.ransac_plane_once(c, k, ref_cfg)  # noqa: E731
    if batch:
        r = jax.jit(jax.vmap(once))(RefCloud.from_points(np.stack(bufs), np.stack(valids)), keys)
        want = [jax.tree_util.tree_map(lambda x, b=b: np.asarray(x)[b], r) for b in range(3)]
        p = ransac.ransac_plane_once(Cloud.from_points(np.stack(bufs), np.stack(valids)),
                                     torch.tensor(np.stack(draws)), cfg)
        got = [scan_of(p, b) for b in range(3)]
    else:
        jitted = jax.jit(once)
        want = [jitted(RefCloud.from_points(bufs[0], valids[0]), keys[0])]
        got = [ransac.ransac_plane_once(Cloud.from_points(bufs[0], valids[0]),
                                        torch.tensor(draws[0]), cfg)]
    for w, g in zip(want, got):
        assert bool(w.found) == bool(g.found)
        np.testing.assert_array_equal(np.asarray(w.normal).view(np.int32),
                                      g.normal.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(w.d).view(np.int32), g.d.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(w.inliers), g.inliers.numpy())


@pytest.mark.parametrize("hypotheses", [64, 128, 200])
@pytest.mark.parametrize("batch", [False, True])
def test_segment_planes_is_bitwise_the_reference(hypotheses, batch):
    """``segment_planes`` (every round through ``ransac_hypotheses_score``,
    ``plane_inliers`` and ``plane_inliers_close``) against the jitted reference, its key chain replayed
    a scan (``jax_key_chain_draw``), alone or under ``jax.vmap`` over 3
    scans: planes, masks and the truncation flag bitwise."""
    ref_cfg, cfg = (c.replace(ransac_hypotheses=hypotheses) for c in (REF_CFG, CFG))
    scenes = [_planes_scene(70 + s, 2048, 1500 + 150 * s) for s in range(3 if batch else 1)]
    keys = jax.random.split(jax.random.PRNGKey(hypotheses + 1), len(scenes))
    seg = lambda c, k: ref_ransac.segment_planes(c, k, ref_cfg)  # noqa: E731
    chains = [jax_key_chain_draw(k, hypotheses) for k in keys]
    if batch:
        pts, valid = (np.stack(v) for v in zip(*scenes))
        r = jax.jit(jax.vmap(seg))(RefCloud.from_points(pts, valid), keys)
        p = ransac.segment_planes(
            Cloud.from_points(pts, valid), cfg,
            lambda rnd, n_valid: torch.stack([c(rnd, n_valid[b]) for b, c in enumerate(chains)]))
    else:
        r = jax.jit(seg)(RefCloud.from_points(*scenes[0]), keys[0])
        p = ransac.segment_planes(Cloud.from_points(*scenes[0]), cfg, chains[0])
    np.testing.assert_array_equal(np.asarray(r.planes.num_planes), p.planes.num_planes.numpy())
    np.testing.assert_array_equal(np.asarray(r.planes.valid), p.planes.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.planes.coeffs).view(np.int32),
                                  p.planes.coeffs.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(r.nonplane_cloud.valid), p.nonplane_cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.plane_union), p.plane_union.numpy())
    np.testing.assert_array_equal(np.asarray(r.last_plane), p.last_plane.numpy())
    np.testing.assert_array_equal(np.asarray(r.truncated), p.truncated.numpy())

