"""The shadow stage's trigonometry and slot geometry, bit for bit.

``ops.libm`` replays the reference's float32 ``arcsin`` (XLA:CPU's
``2 * atan2f(x, 1 + sqrt((1 - x) * (1 + x)))`` under flush-to-zero) and
``tan`` (the C library's ``tanf``); ``ops.shadow.shadow_slots_plain``
builds each slot's shadow line with them.  Bar: every bit, against the
jitted JAX functions, the C library itself (``ctypes``), and the
intermediates read out of the reference's own jitted ``cast_shadows``.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointcloud_obstacle_processing_tpu.ops.shadow as ref_shadow
from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG as REF_CFG
from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import occupancy as ref_occ
from pointcloud_obstacle_processing_tpu.ops.transforms import RigidTransform as RefTF
from pointcloud_obstacle_processing_tpu.types import ClusterSet as RefClusterSet

from pointcloud_obstacle_processing_tpu_torch import REFERENCE_YAML_CONFIG as CFG
from pointcloud_obstacle_processing_tpu_torch import Cloud, ClusterSet
from pointcloud_obstacle_processing_tpu_torch.ops import f32, fma, int32_like_xla, libm
from pointcloud_obstacle_processing_tpu_torch.ops import occupancy, shadow
from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

F32 = np.float32


def _apart(a, b) -> int:
    """Elements of two float32 arrays whose bits differ."""
    return int((np.asarray(a, F32).view(np.int32) != np.asarray(b, F32).view(np.int32)).sum())


def _neighbours(values, ulps: int = 4) -> np.ndarray:
    """Each float32 value and its ``ulps`` neighbours on either side (by
    bits: a value's magnitude steps)."""
    bits = np.asarray(values, F32).view(np.int32)[:, None] + np.arange(-ulps, ulps + 1)
    return bits.astype(np.int32).ravel().view(F32)


SUBNORMALS = np.concatenate([np.arange(1, 1 << 23, 4099, dtype=np.int32),
                             [0x7FFFFF, 0x800000, 0x800001, 0xFFFFFF, 0x1000000]]).view(F32)
ASIN_EDGES = np.concatenate([
    [0.0, -0.0, 1.0, -1.0, 0.5, -0.5],
    _neighbours([1.0, -1.0, 0.7071068, -0.7071068, 0.4375, 11 / 16, 2.0 ** -125, -2.0 ** -125]),
    SUBNORMALS, -SUBNORMALS,
    (10.0 ** np.linspace(-38, -30, 200)).astype(F32),
]).astype(F32)
TAN_EDGES = np.concatenate([
    [0.0, -0.0], SUBNORMALS, -SUBNORMALS,
    _neighbours([np.pi / 4, -np.pi / 4, np.pi / 2, -np.pi / 2, 0.6744, -0.6744, 2.0 ** -13,
                 3 * np.pi / 4, np.pi, 120.0, -120.0], 8),
    [1e3, -1e3, 12345.678, 1e10, -1e10, 3.4e38, -3.4e38],
]).astype(F32)


def test_asin_like_xla_is_jitted_arcsin():
    """``asin_like_xla`` on 200,000 seeded x in [-1, 1) and the edge set
    (+-0, +-1 and their neighbours, NaN past them; the reduction's
    interval ends, subnormals, tiny normals) against
    ``jax.jit(jnp.arcsin)``: 0 apart.  XLA:CPU flushes subnormals, so a
    subnormal x, or one below 2^-125 whose quotient in ``atan2f`` is below
    the least normal before rounding, gives a zero."""
    x = np.concatenate([np.random.default_rng(0).uniform(-1.0, 1.0, 200_000).astype(F32),
                        ASIN_EDGES])
    want = np.asarray(jax.jit(jnp.arcsin)(x))
    got = libm.asin_like_xla(torch.tensor(x)).numpy()
    outside = np.abs(x) > 1  # NaN, whose bits are no part of the bar
    assert np.isnan(got[outside]).all() and np.isnan(want[outside]).all()
    assert _apart(got[~outside], want[~outside]) == 0
    assert (want[np.abs(x) < 2.0 ** -125] == 0).all()


def test_tanf_is_jitted_tan():
    """``tanf`` on 200,000 seeded x in [-pi/2, pi/2] rounded up, 20,000
    spread over +-1e6 (both reductions), and the edge set (subnormals,
    around +-pi/4, +-pi/2, 0.6744, 2^-13, 120, huge) against
    ``jax.jit(jnp.tan)``: 0 apart."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-np.pi / 2, np.pi / 2, 200_000).astype(F32),
                        (rng.uniform(-1.0, 1.0, 20_000) * 10.0 ** rng.uniform(-3, 6, 20_000)),
                        TAN_EDGES]).astype(F32)
    assert _apart(libm.tanf(torch.tensor(x)), jax.jit(jnp.tan)(x)) == 0


def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, args in (("atan2f", 2), ("tanf", 1), ("atanf", 1)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_float] * args
        fn.restype = ctypes.c_float
    return lib


def test_atan2f_atanf_tanf_are_the_c_library():
    """``atan2f`` over 20,000 seeded pairs spread over 80 decades, and
    every pair of +-0, +-1, +-inf, NaN, a subnormal and 3, each against the
    C library's own ``atan2f`` through ``ctypes`` (the same bits, NaN for
    NaN); ``atanf`` and ``tanf`` on 5,000 seeded values likewise."""
    lib = _libm()
    rng = np.random.default_rng(2)

    def spread(n):
        return (rng.standard_normal(n) * 10.0 ** rng.uniform(-40, 38, n)).astype(F32)

    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-40, 3.0], F32)
    y, x = np.meshgrid(special, special)
    y = np.concatenate([spread(20_000), y.ravel(), spread(500)])
    x = np.concatenate([spread(20_000), x.ravel(), np.ones(500, F32)])
    want = np.array([lib.atan2f(a, b) for a, b in zip(y.tolist(), x.tolist())], F32)
    got = libm.atan2f(torch.tensor(y), torch.tensor(x)).numpy()
    both_nan = np.isnan(got) & np.isnan(want)
    assert _apart(got[~both_nan], want[~both_nan]) == 0 and np.isnan(want).sum() == both_nan.sum()
    v = spread(5_000)
    for fn in ("atanf", "tanf"):
        want = np.array([getattr(lib, fn)(a) for a in v.tolist()], F32)
        assert _apart(getattr(libm, fn)(torch.tensor(v)), want) == 0, fn


def test_grid_cells_are_the_references_far_and_near_edges():
    """``grid_cell_xy`` against the jitted reference on every cell edge
    (+-4 ulps of each multiple of the block) and on 100,000 points up to
    1e9 m away, where the conversion saturates: XLA:CPU's reciprocal
    product, fused fix-ups and saturating conversion, bit for bit; the
    division, unfused steps and x86's conversion miss hundreds."""
    b = F32(CFG.block_size)
    k = np.arange(-3, 130)
    xs = _neighbours(F32(CFG.x_max) - (k * b).astype(F32))
    ys = _neighbours(F32(CFG.y_min) + (k * b).astype(F32))
    n = min(len(xs), len(ys))
    rng = np.random.default_rng(3)
    far = (rng.standard_normal((100_000, 3)) * 10.0 ** rng.uniform(0, 9, (100_000, 1))).astype(F32)
    pts = np.concatenate([np.stack([xs[:n], ys[:n], np.zeros(n, F32)], 1), far])
    want = jax.jit(lambda p: ref_occ.grid_cell_xy(p, REF_CFG))(pts)
    got = occupancy.grid_cell_xy(torch.tensor(pts), CFG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    old = _old_grid_cells(torch.tensor(pts))
    edge_misses = int(sum((o[:n].numpy() != np.asarray(w)[:n]).sum() for o, w in zip(old, want)))
    far_misses = int(sum((o[n:].numpy() != np.asarray(w)[n:]).sum() for o, w in zip(old, want)))
    print(f"the division, unfused fix-ups and x86 conversion miss {edge_misses} cells of {n} "
          f"edge points and {far_misses} of 100,000 far points")
    assert edge_misses > 100 and far_misses > 1000
    v = torch.tensor([3e9, -3e9, float("nan"), float("inf"), 2147483520.0, -2.5], dtype=torch.float32)
    assert int32_like_xla(v).tolist() == [2**31 - 1, -2**31, 0, 2**31 - 1, 2147483520, -2]


def _old_grid_cells(pts):
    """``grid_cell_xy`` with a true division, unfused fix-up steps and x86's
    conversion (INT32_MIN out of range), the form before XLA:CPU's."""
    y, x = pts[..., 1], pts[..., 0]
    b, y_min, x_max = f32(CFG.block_size), f32(CFG.y_min), f32(CFG.x_max)
    col = torch.clamp_min(torch.ceil((y - y_min) / b) - 1, 0).to(torch.int32)
    row = torch.clamp_min(torch.ceil((x_max - x) / b) - 1, 0).to(torch.int32)
    for step in (1, 1, -1, -1):
        cf, rf = col.to(torch.float32), row.to(torch.float32)
        if step > 0:
            col = torch.where(y_min + (cf + 1.0) * b < y, col + 1, col)
            row = torch.where(x_max - (rf + 1.0) * b > x, row + 1, row)
        else:
            col = torch.where((col > 0) & ~(y_min + cf * b < y), col - 1, col)
            row = torch.where((row > 0) & ~(x_max - rf * b > x), row - 1, row)
    return col, row


class _Tap:
    """The reference's ``jnp`` inside ``ops/shadow.py``, reporting ``tan``'s
    argument and result (per slot, under its vmap) and the int32 slot
    arrays the raster's first ``jnp.where`` calls take (the lines before
    the swaps: (steep, y0, x0), (steep, x0, y0), (steep, y1, x1), ...)."""

    def __init__(self, seen, m):
        self.seen, self.m = seen, m

    def __getattr__(self, name):
        return getattr(jnp, name)

    def tan(self, x):
        out = jnp.tan(x)
        jax.debug.callback(lambda a, b: self.seen["tan"].append((np.float32(a), np.float32(b))),
                           x, out)
        return out

    def where(self, c, a=None, b=None):
        if getattr(a, "dtype", None) == jnp.int32 and getattr(a, "shape", None) == (self.m,):
            jax.debug.callback(lambda x, y: self.seen["where"].append((np.array(x), np.array(y))),
                               a, b, ordered=True)
        return jnp.where(c, a, b)


def _reference_run(monkeypatch, case, opacity=50):
    """The reference's jitted ``cast_shadows`` on one scan of ``case``, with
    its taps: the grid, the set of (D, tan D) bit pairs, the set of the end
    points' bits (``RigidTransform.apply``'s [3] arguments: each slot's
    end point, then its start point), and the lines before the swaps
    [M, 4]."""
    m = case["slot_valid"].shape[-1]
    seen = {"tan": [], "where": [], "apply": []}
    monkeypatch.setattr(ref_shadow, "jnp", _Tap(seen, m))
    apply = RefTF.apply

    def tapped(self, p):
        out = apply(self, p)
        if p.shape == (3,):
            jax.debug.callback(lambda a: seen["apply"].append(np.array(a, F32)), p)
        return out

    monkeypatch.setattr(RefTF, "apply", tapped)
    cfg = REF_CFG.replace(grid_opacity=opacity)
    grid = jax.jit(lambda g, c, cl, tf: ref_shadow.cast_shadows(g, c, cl, tf, cfg).grid)(
        jnp.zeros((REF_CFG.grid_height, REF_CFG.grid_width), jnp.int8),
        RefCloud.from_points(case["points"][0], case["valid"][0]),
        RefClusterSet(point_cluster=jnp.asarray(case["point_cluster"][0]),
                      sizes=jnp.ones(m, jnp.int32), valid=jnp.asarray(case["slot_valid"][0]),
                      num_clusters=jnp.int32(m)),
        RefTF.from_quat_trans(case["quat"], case["trans"]))
    jax.effects_barrier()
    tans = {(a.view(np.int32).item(), b.view(np.int32).item()) for a, b in seen["tan"]}
    points = {tuple(p.view(np.int32).tolist()) for p in seen["apply"]}
    (y0, x0), _, (y1, x1) = seen["where"][:3]
    return np.asarray(grid), tans, points, np.stack([x0, y0, x1, y1], -1)


def _normal_form(raw):
    """The raster's steep and back swaps of raw [M, 4] (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = raw.T
    steep = np.abs(y1 - y0) > np.abs(x1 - x0)
    x0, y0, x1, y1 = np.where(steep, y0, x0), np.where(steep, x0, y0), \
        np.where(steep, y1, x1), np.where(steep, x1, y1)
    back = x0 > x1
    return np.stack([np.where(back, x1, x0), np.where(back, y1, y0), np.where(back, x0, x1),
                     np.where(back, y0, y1), steep], -1)


def _port_slots(case):
    """The port's slot intermediates on scan 0 of ``case``: (D, tan D) bits
    a slot, end points a slot, the lines [M, 7], the grid."""
    tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
    pts, ok = torch.tensor(case["points"][0]), torch.tensor(case["valid"][0])
    pc, sv = torch.tensor(case["point_cluster"][0]), torch.tensor(case["slot_valid"][0])
    m = sv.shape[-1]
    vmin, vmax, *_ = shadow.slot_extremes(tf.inverse().apply(pts), pc, ok, m)
    c, _ = shadow._lengths(vmin)
    d_angle = libm.asin_like_xla(vmin[:, 2] / torch.clamp_min(c, 1e-20))
    t = libm.tanf(d_angle)
    _, end = shadow.shadow_end(vmin, vmax)
    lines = shadow.shadow_slots_plain(pts, ok, pc, sv, tf, CFG)
    grid = shadow.shadow_raster_plain(torch.zeros(CFG.grid_height, CFG.grid_width,
                                                  dtype=torch.int8), lines, 50)
    pairs = list(zip(d_angle.numpy().view(np.int32).tolist(), t.numpy().view(np.int32).tolist()))
    return pairs, [tuple(r) for r in end.numpy().view(np.int32).tolist()], lines.numpy(), \
        grid.numpy(), (vmin, vmax, d_angle)


CASES = [("random", s) for s in range(3)] + [("edges", 0)]
# Edge slots whose end point's z takes a subnormal step: XLA:CPU flushes it
# (its flush-to-zero mode), the port, as in every stage, keeps it; the end
# point's x and y, so its cells, agree.  Only ``asin_like_xla`` replays the
# flush, where it decides the angle.
SUBNORMAL_SLOTS = ("subnormal z", "tiny z")


@pytest.mark.parametrize("kind,seed", CASES, ids=[f"{k}-{s}" for k, s in CASES])
def test_shadow_slots_plain_is_the_references_in_place(monkeypatch, kind, seed):
    """Each slot's (D, tan D), end point and line (cells after the steep
    and back swaps) of ``shadow_slots_plain`` among the reference's own
    intermediates, read out of its jitted ``cast_shadows``, and the grid
    equal: three seeded scans of 16 slots over 512 points (a tilted pose)
    and the edge scan (``utils.shadow_cases.EDGE_SLOTS``: a / c = +-1, a
    slot at the sensor, subnormal and tiny z, z = x, ties, one point,
    empty and not-valid slots, wide, steep and shallow sweeps).  With
    torch's ``arcsin`` and ``tan`` some (D, tan D) of the seeded scans
    miss."""
    case = shadow_cases.edge_slots() if kind == "edges" else \
        shadow_cases.random_slots(seed, 1, 512, 16)
    want_grid, tans, ends, raw = _reference_run(monkeypatch, case)
    pairs, port_ends, lines, grid, (vmin, vmax, _) = _port_slots(case)
    assert set(pairs) <= tans
    names = list(shadow_cases.EDGE_SLOTS) if kind == "edges" else []
    ref_xy = {e[:2] for e in ends}
    for k, end in enumerate(port_ends):
        if k < len(names) and names[k] in SUBNORMAL_SLOTS:
            assert end[:2] in ref_xy, names[k]
        else:
            assert end in ends, k
    np.testing.assert_array_equal(lines[:, [0, 1, 2, 3, 5]], _normal_form(raw))
    np.testing.assert_array_equal(grid, want_grid)
    if kind == "random":
        c, _ = shadow._lengths(vmin)
        old = torch.tan(torch.arcsin(vmin[:, 2] / torch.clamp_min(c, 1e-20)))
        ref_tans = {t for _, t in tans}
        misses = sum(b not in ref_tans for b in old.numpy().view(np.int32).tolist())
        print(f"seed {seed}: torch's tan(asin) misses {misses} of {len(pairs)} slots")
    else:
        d, _ = shadow.shadow_end(vmin, vmax)  # the a / c = +-1 slots' shadows are ~1e7 m long
        assert (d[:2].abs() > 1e6).all() and (lines[1, :4] > 10**6).any()


def _old_end_cells(vmin, vmax):
    """The end cells with torch's ``arcsin`` and ``tan`` in place of
    ``ops.libm`` (the form before the port replayed XLA:CPU's), the rest of
    the arithmetic as ``shadow_end``."""
    c, v_len = shadow._lengths(vmin)
    e = torch.abs(vmax) - torch.abs(vmin[..., 0]) + f32(0.04)
    d = fma(torch.tan(torch.arcsin(vmin[..., 2] / torch.clamp_min(c, 1e-20))), e, f32(0.25))
    end = fma(vmin / torch.clamp_min(v_len, 1e-20)[..., None], d[..., None], vmin)
    return shadow._cell(end, CFG)


def _near_edge_case():
    """A one-slot scan (identity pose) whose end point the old form puts in
    another cell than the new: nearest points whose tan(asin) torch misses,
    then the farthest point's x stepped by ulps about the value that puts
    the end point on a row edge, until the two forms' end rows differ."""
    rng = np.random.default_rng(7)
    vmin = torch.tensor(rng.uniform([0.4, 0.5, 0.05], [1.5, 3.0, 0.6], (400, 3)).astype(F32))
    c, v_len = shadow._lengths(vmin)
    ratio = vmin[:, 2] / c
    misses = torch.tan(torch.arcsin(ratio)) != libm.tanf(libm.asin_like_xla(ratio))
    b = F32(CFG.block_size)
    for i in torch.nonzero(misses)[:, 0].tolist():
        p = vmin[i]
        t = float(libm.tanf(libm.asin_like_xla(ratio[i:i + 1]))[0])
        ray_x = float(p[0] / v_len[i])
        for k in range(1, 100):  # the row edges beyond the nearest point
            edge = F32(CFG.x_max) - F32(k * b)
            e = ((float(edge) - float(p[0])) / ray_x - 0.25) / t
            vmax_x = F32(e - 0.04 + abs(float(p[0])))
            if not (e > 0 and vmax_x > p[0]):
                continue
            steps = (np.array([vmax_x], F32).view(np.int32) + np.arange(-40, 41)).view(F32)
            vmax = torch.tensor(steps)
            vm = p.expand(len(steps), 3)
            old = _old_end_cells(vm, vmax)[1]
            new = shadow._cell(shadow.shadow_end(vm, vmax)[1], CFG)[1]
            hit = torch.nonzero(old != new)[:, 0]
            if len(hit):
                far = steps[int(hit[0])]
                pts = np.array([p.numpy(), [far, p[1], p[2] * 0.5]], F32)
                return dict(points=pts[None], valid=np.ones((1, 2), bool),
                            point_cluster=np.zeros((1, 2), np.int32),
                            slot_valid=np.ones((1, 1), bool),
                            quat=np.array([0, 0, 0, 1], F32), trans=np.zeros(3, F32))
    return None


def test_old_trig_puts_an_end_point_in_another_cell(monkeypatch):
    """The fault the libm replay repairs: a constructed slot whose shadow
    end point the old form (torch's ``arcsin`` and ``tan``) puts in
    another row than the reference does, while the port's line and grid
    are the reference's."""
    case = _near_edge_case()
    assert case is not None
    want_grid, _, _, raw = _reference_run(monkeypatch, case)
    _, _, lines, grid, (vmin, vmax, _) = _port_slots(case)
    np.testing.assert_array_equal(lines[:, :4], _normal_form(raw)[:, :4])
    np.testing.assert_array_equal(grid, want_grid)
    ref_end_row = raw[0, 3]
    assert int(_old_end_cells(vmin, vmax)[1][0]) != ref_end_row
    assert int(shadow._cell(shadow.shadow_end(vmin, vmax)[1], CFG)[1][0]) == ref_end_row


@pytest.mark.parametrize("scans,pose_per_scan", [(3, False), (2, True)])
def test_batched_shadow_stage_is_per_scan(scans, pose_per_scan):
    """The plain twins on a batch (one pose, or one a scan) equal each
    scan's own run, and ``cast_shadows`` on CPU tensors is the twins."""
    case = shadow_cases.random_slots(11, scans, 512, 16, pose_per_scan=pose_per_scan)
    tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
    cloud = Cloud(points=torch.tensor(case["points"]), valid=torch.tensor(case["valid"]))
    clusters = ClusterSet(point_cluster=torch.tensor(case["point_cluster"]),
                          sizes=torch.ones(scans, 16, dtype=torch.int32),
                          valid=torch.tensor(case["slot_valid"]),
                          num_clusters=torch.full((scans,), 16))
    grid = torch.zeros(scans, CFG.grid_height, CFG.grid_width, dtype=torch.int8)
    cfg = CFG.replace(grid_opacity=50)
    out = shadow.cast_shadows(grid, cloud, clusters, tf, cfg).grid
    for s in range(scans):
        tf_s = tf if not pose_per_scan else RigidTransform(tf.quat_xyzw[s], tf.translation[s])
        lines = shadow.shadow_slots_plain(cloud.points[s], cloud.valid[s],
                                          clusters.point_cluster[s], clusters.valid[s], tf_s, cfg)
        one = shadow.shadow_raster_plain(grid[s], lines, 50)
        assert torch.equal(out[s], one)
    assert (out == 50).any()
