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
    p = voxel.voxel_downsample(Cloud.from_points(pts, valid), leaf, cap, BOUNDS, packing)
    assert int(r.num_voxels) == int(p.num_voxels)
    assert bool(r.overflow) == bool(p.overflow)
    np.testing.assert_array_equal(np.asarray(r.cloud.valid), p.cloud.valid.numpy())
    k = min(int(p.num_voxels), cap)
    np.testing.assert_array_equal(np.asarray(r.cloud.points)[:k], p.cloud.points.numpy()[:k])


def test_voxel_stage_refuses_unpackable_bounds():
    cloud = Cloud.pad_to(np.zeros((10, 3), np.float32), 128)
    with pytest.raises(ValueError):
        voxel.voxel_downsample(cloud, 0.04, 64, None)


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
