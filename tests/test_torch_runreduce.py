"""Kernel K1 (sorted-run reduce) and the voxel stage of the PyTorch port
against the JAX package.

The reference's kernel runs as its own tests run it here: the XLA fallback,
and at one small shape the Pallas kernel in interpret mode.  The port's
wrapper takes its plain version for CPU tensors.  Bar: bitwise on slots <
num, num exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops import voxel as ref_voxel
from pointcloud_obstacle_processing_tpu.ops.pallas_runreduce import sorted_run_reduce as ref_rr

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import voxel
from pointcloud_obstacle_processing_tpu_torch.ops.runreduce import (
    default_group,
    sorted_run_reduce,
    unpack_offsets,
)
from test_torch_cuda import LOOK_BACK_CASES, look_back_keys


def _case(seed, n, n_runs, n_valid, packed):
    rng = np.random.default_rng(seed)
    sentinel = n_runs + 7
    skey = np.full(n, sentinel, np.int32)
    skey[:n_valid] = np.sort(rng.integers(0, n_runs, n_valid))
    if packed:
        pxy = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
        pz = rng.integers(0, 65536, n).astype(np.int32)
        offs = (pxy, pz)
    else:
        offs = tuple(rng.standard_normal((3, n)).astype(np.float32))
    return skey, offs, sentinel


def _compare(vals_a, num_a, vals_b, num_b, cap):
    assert int(num_a) == int(num_b)
    k = min(int(num_a), cap)
    np.testing.assert_array_equal(np.asarray(vals_a)[:k], vals_b.numpy()[:k])


@pytest.mark.parametrize(
    "n,n_runs,n_valid,cap,packed",
    [
        (1024, 50, 700, 128, False),
        (3072, 1, 2000, 16, False),  # one run spanning several windows
        (8192, 900, 8192, 512, False),  # more runs than slots, no invalid tail
        (32768, 6000, 30000, 8192, True),  # the small config's shape
    ],
)
def test_runreduce_matches_reference_fallback(n, n_runs, n_valid, cap, packed):
    skey, offs, sentinel = _case(n + n_runs, n, n_runs, n_valid, packed)
    quantum = 0.06 / 65536.0 if packed else None
    vals_r, num_r = ref_rr(jnp.asarray(skey), tuple(jnp.asarray(o) for o in offs), sentinel,
                           cap, use_pallas=False, quantum=quantum)
    vals_p, num_p = sorted_run_reduce(torch.tensor(skey), tuple(torch.tensor(o) for o in offs),
                                      sentinel, cap, quantum=quantum)
    _compare(vals_r, num_r, vals_p, num_p, cap)


@pytest.mark.parametrize("packed", [False, True])
def test_runreduce_matches_reference_pallas_interpret(packed):
    n, cap = 2048, 256
    skey, offs, sentinel = _case(7, n, 400, 1800, packed)
    quantum = 0.04 / 65536.0 if packed else None
    vals_r, num_r = ref_rr(jnp.asarray(skey), tuple(jnp.asarray(o) for o in offs), sentinel,
                           cap, group=8, use_pallas=True, interpret=True, quantum=quantum)
    vals_p, num_p = sorted_run_reduce(torch.tensor(skey), tuple(torch.tensor(o) for o in offs),
                                      sentinel, cap, group=8, quantum=quantum)
    _compare(vals_r, num_r, vals_p, num_p, cap)


def test_unpack_offsets_is_a_logical_shift():
    pxy = torch.tensor(np.array([0xFFFF0001, 0x80000000, 0x00010002], np.uint32).view(np.int32))
    pz = torch.tensor([3, 0, 65535], dtype=torch.int32)
    ox, oy, oz = unpack_offsets(pxy, pz, 1.0)
    np.testing.assert_array_equal(ox.numpy(), [65535.0, 32768.0, 1.0])
    np.testing.assert_array_equal(oy.numpy(), [1.0, 0.0, 2.0])
    np.testing.assert_array_equal(oz.numpy(), [3.0, 0.0, 65535.0])


@pytest.mark.parametrize("n,group", [(100352, 8), (32768, 8), (1024, 8), (384, 1), (2**21, 32)])
def test_default_group_is_the_reference_window(n, group):
    assert default_group(n) == group


BOUNDS = ((0.0, 0.0, -0.5), (4.5, 3.78, 0.25))


@pytest.mark.parametrize("packing,leaf", [(False, 0.06), (True, 0.06), (True, 0.04)])
def test_voxel_stage_bitwise_equals_reference(packing, leaf):
    rng = np.random.default_rng(21)
    n, cap = 16384, 4096
    pts = rng.uniform([0, 0, -0.5], [4.5, 3.78, 0.25], (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    pts[~valid] = np.nan
    r = jax.jit(lambda c: ref_voxel.voxel_downsample(
        c, leaf, cap, BOUNDS, binning="sort", payload_packing=packing))(
        RefCloud.from_points(pts, valid))
    p = voxel.voxel_downsample(Cloud.from_points(pts, valid), leaf, cap, BOUNDS,
                               payload_packing=packing)
    assert int(r.num_voxels) == int(p.num_voxels)
    assert bool(r.overflow) == bool(p.overflow)
    np.testing.assert_array_equal(np.asarray(r.cloud.valid), p.cloud.valid.numpy())
    k = min(int(p.num_voxels), cap)
    np.testing.assert_array_equal(np.asarray(r.cloud.points)[:k], p.cloud.points.numpy()[:k])


@pytest.mark.parametrize("leaf", [0.06, 0.04, 0.015])
def test_voxel_keys_take_the_leaf_as_xla_does(leaf):
    """Points within 2 ulps of voxel faces (multiples of the leaf in every
    coordinate): XLA:CPU evaluates the reference's ``floor(p / leaf)`` as
    ``floor(p * (1 / leaf))``, and the voxel stage equals the reference's
    bit for bit; the quotient would key some of these points into the
    neighbouring voxel."""
    rng = np.random.default_rng(int(leaf * 1000))
    n, cap = 16384, 16384
    lf = np.float32(leaf)
    lo, hi = np.array(BOUNDS[0]), np.array(BOUNDS[1])
    cells = rng.integers(np.ceil(lo / leaf) + 1, np.floor(hi / leaf) - 1, (n, 3))
    pts = (cells * lf).astype(np.float32)
    pts = (pts.view(np.int32) + rng.integers(-2, 3, (n, 3)).astype(np.int32)).view(np.float32)
    valid = np.ones(n, bool)
    r = jax.jit(lambda c: ref_voxel.voxel_downsample(
        c, leaf, cap, BOUNDS, binning="sort", payload_packing=True))(
        RefCloud.from_points(pts, valid))
    p = voxel.voxel_downsample(Cloud.from_points(pts, valid), leaf, cap, BOUNDS,
                               payload_packing=True)
    assert int(r.num_voxels) == int(p.num_voxels)
    k = min(int(p.num_voxels), cap)
    np.testing.assert_array_equal(np.asarray(r.cloud.points)[:k], p.cloud.points.numpy()[:k])
    assert (np.floor(pts / lf) != np.floor(pts * (np.float32(1) / lf))).any()


def test_voxel_stage_refuses_unpackable_bounds():
    """Without bounds an explicit ``binning="sort"`` raises, as the
    reference's does; ``auto`` takes the 3-key fallback, equal to the
    reference's."""
    cloud = Cloud.pad_to(np.zeros((10, 3), np.float32), 128)
    with pytest.raises(ValueError, match="binning='sort' requires packable bounds"):
        voxel.voxel_downsample(cloud, 0.04, 64, None, binning="sort")
    pts = np.random.default_rng(5).uniform(-3, 3, (128, 3)).astype(np.float32)
    r = jax.jit(lambda c: ref_voxel.voxel_downsample(c, 0.5, 64, None))(
        RefCloud.from_points(pts, np.ones(128, bool)))
    p = voxel.voxel_downsample(Cloud.from_points(pts, np.ones(128, bool)), 0.5, 64, None)
    assert int(r.num_voxels) == int(p.num_voxels) > 0
    np.testing.assert_array_equal(np.asarray(r.cloud.points), p.cloud.points.numpy())


def test_runreduce_wrapper_takes_plain_version_on_cpu():
    # CPU tensors take the plain version: no kernel build, no launch count
    from pointcloud_obstacle_processing_tpu_torch import _build

    before = dict(_build.LAUNCHES)
    skey, offs, sentinel = _case(3, 1024, 40, 900, False)
    sorted_run_reduce(torch.tensor(skey), tuple(torch.tensor(o) for o in offs), sentinel, 64)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        sorted_run_reduce(torch.tensor(skey[:1000]), tuple(torch.tensor(o[:1000]) for o in offs),
                          sentinel, 64)


def _kernel_schedule_scan(vals, heads, rows_per_thread):
    """Kernel K1's scan of one window as ``csrc/runreduce.cu`` schedules it,
    in numpy float32 (every add rounded, none fused): each thread holds R
    consecutive rows; the steps d < R run over its rows and the R-1 rows
    before them, with the last-head positions of those rows counted from
    the first of them only; the wider steps read row i - d of the step
    before.  The mask of row i at step d is "last head at or before i lies
    past i - d".  ``vals``: [w, 4] float32, ``heads``: [w] bool."""
    w, r = vals.shape[0], rows_per_thread
    idx = np.arange(w)
    lh_all = np.maximum.accumulate(np.where(heads, idx, -1))
    zero = np.zeros(4, np.float32)
    own = np.empty_like(vals)
    for i0 in range(0, w, r):
        locs = list(range(i0 - (r - 1), i0 + r))
        v = [vals[j].copy() if j >= 0 else zero.copy() for j in locs]
        lh, last = [], -1
        for m, j in enumerate(locs):
            if m < r - 1:
                if j >= 0 and heads[j]:
                    last = j
                lh.append(last)
            else:
                lh.append(lh_all[j])
        d = 1
        while d < r:
            for m in range(2 * r - 2, d - 1, -1):
                v[m] = v[m] + (zero if lh[m] > locs[m] - d else v[m - d])
            d *= 2
        own[i0:i0 + r] = v[r - 1:]
    d = r
    while d < w:
        prev = own.copy()
        shifted = np.concatenate([np.zeros((d, 4), np.float32), prev[:-d]])
        own = prev + np.where((lh_all > idx - d)[:, None], zero, shifted)
        d *= 2
    return own


@pytest.mark.parametrize("w,rows_per_thread,head_rate", [
    (1024, 4, 0.2), (1024, 4, 0.002), (4096, 4, 0.05), (256, 2, 0.1), (128, 1, 0.3),
    (512, 4, 0.0),  # no head: the whole window is one run
])
def test_kernel_scan_schedule_is_the_reference_scan(w, rows_per_thread, head_rate):
    """The kernel's register-and-halo schedule of the Hillis-Steele scan
    gives the reference's scan (``_scan_channels``, the plain version's
    steps) bit for bit, with -0.0 values, a head on row 0 or not, and runs
    longer than a thread's rows."""
    from pointcloud_obstacle_processing_tpu_torch.ops.runreduce import _scan_channels

    rng = np.random.default_rng(w + rows_per_thread)
    vals = rng.standard_normal((w, 4)).astype(np.float32) * 2.0 ** rng.integers(-8, 8, (w, 4))
    vals = vals.astype(np.float32)
    vals[rng.random((w, 4)) < 0.05] = -0.0
    for first_head in (False, True):
        heads = rng.random(w) < head_rate
        heads[0] = first_head
        got = _kernel_schedule_scan(vals, heads, rows_per_thread)
        want = _scan_channels(torch.tensor(vals.T), torch.tensor(heads, dtype=torch.int32), w)
        np.testing.assert_array_equal(got.view(np.int32), want.numpy().T.view(np.int32))


@pytest.mark.parametrize("kind", LOOK_BACK_CASES)
@pytest.mark.parametrize("packed", [False, True])
def test_runreduce_look_back_cases_match_reference(kind, packed):
    n, cap, sentinel = 8192, 64, 1 << 20
    rng = np.random.default_rng(len(kind))
    skey = look_back_keys(kind, n, sentinel, rng)
    if packed:
        offs = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32),
                rng.integers(0, 65536, n).astype(np.int32))
    else:
        offs = tuple(rng.standard_normal((3, n)).astype(np.float32))
        offs[0][rng.random(n) < 0.05] = -0.0
    quantum = 0.04 / 65536.0 if packed else None
    vals_r, num_r = ref_rr(jnp.asarray(skey), tuple(jnp.asarray(o) for o in offs), sentinel,
                           cap, use_pallas=False, quantum=quantum)
    vals_p, num_p = sorted_run_reduce(torch.tensor(skey), tuple(torch.tensor(o) for o in offs),
                                      sentinel, cap, quantum=quantum)
    _compare(vals_r, num_r, vals_p, num_p, cap)
    if kind == "many_runs":
        assert int(num_p) > cap


def _look_back_carries(lastcol, has_head):
    """The carry into each window as kernel K1's look-back finds it: walk
    back to the nearest window that published its carry out (one with a
    head, whose carry out is ``lastcol + 0``, or the first), then add the
    last columns of the head-less windows after it, oldest first."""
    steps = len(lastcol)
    zero = np.zeros(4, np.float32)
    carries = [zero]
    for t in range(1, steps):
        q = t - 1
        while q > 0 and not has_head[q]:
            q -= 1
        c = lastcol[q] + zero
        for j in range(q + 1, t):
            c = lastcol[j] + c
        carries.append(c)
    return np.stack(carries)


@pytest.mark.parametrize("head_rate", [0.0, 0.2, 0.7])
def test_look_back_carries_are_the_reference_chain(head_rate):
    """The look-back's carries equal the reference's sequential chain
    ``c_{t+1} = lastcol_t + (window t has no head ? c_t : 0)`` bit for bit,
    over 300 windows with runs of head-less windows and -0.0 values."""
    rng = np.random.default_rng(int(head_rate * 10))
    steps = 300
    lastcol = (rng.standard_normal((steps, 4)) * 2.0 ** rng.integers(-10, 10, (steps, 4)))
    lastcol = lastcol.astype(np.float32)
    lastcol[rng.random((steps, 4)) < 0.05] = -0.0
    has_head = rng.random(steps) < head_rate
    want, c = [], np.zeros(4, np.float32)
    for t in range(steps):
        want.append(c)
        c = lastcol[t] + (np.zeros(4, np.float32) if has_head[t] else c)
    got = _look_back_carries(lastcol, has_head)
    np.testing.assert_array_equal(got.view(np.int32), np.stack(want).view(np.int32))
