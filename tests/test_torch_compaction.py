"""Kernel K2 (compaction with exact gather) and ``compact`` of the PyTorch
port against the JAX package: bitwise on slots < num, num exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import Cloud as RefCloud
from pointcloud_obstacle_processing_tpu.ops.compaction import compact as ref_compact
from pointcloud_obstacle_processing_tpu.ops.pallas_compaction import compact_and_gather_exact as ref_cg

from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops.compaction import (
    compact,
    compact_and_gather_exact,
    extract_indices,
)
from pointcloud_obstacle_processing_tpu_torch.ops.histogram import compact_occupied_blocks


def _bins(seed, k, density, c=4):
    rng = np.random.default_rng(seed)
    occ = rng.random(k) < density
    bins = rng.standard_normal((c, k)).astype(np.float32)
    bins[-1] = occ.astype(np.float32)
    return bins, occ.reshape(k // 128, 128)


@pytest.mark.parametrize(
    "k,density,cap,pallas",
    [
        (24576, 0.025, 1024, False),  # the flagship cluster-buffer shape
        (8192, 0.5, 1024, False),  # more occupied than slots
        (2048, 0.3, 512, True),  # the reference kernel in interpret mode
        (1024, 0.0, 128, False),  # nothing occupied
    ],
)
def test_compact_and_gather_matches_reference(k, density, cap, pallas):
    bins, occ2d = _bins(k, k, density)
    kw = dict(use_pallas=True, interpret=True) if pallas else dict(use_pallas=False)
    loc_r, num_r, vals_r = ref_cg(jnp.asarray(bins), jnp.asarray(occ2d), cap, **kw)
    loc_p, num_p, vals_p = compact_and_gather_exact(torch.tensor(bins), torch.tensor(occ2d), cap)
    assert int(num_r) == int(num_p) == int(occ2d.sum())
    n = min(int(num_p), cap)
    np.testing.assert_array_equal(np.asarray(loc_r)[:n], loc_p.numpy()[:n])
    np.testing.assert_array_equal(np.asarray(vals_r)[:n], vals_p.numpy()[:n])
    np.testing.assert_array_equal(vals_p.numpy()[:n], bins.T[loc_p.numpy()[:n]])


@pytest.mark.parametrize("n_valid,cap", [(500, 1024), (3000, 1024), (0, 256)])
def test_compact_matches_reference(n_valid, cap):
    rng = np.random.default_rng(n_valid)
    n = 4096
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, n_valid, replace=False)] = True
    r = jax.jit(lambda c: ref_compact(c, cap))(RefCloud.from_points(pts, valid))
    p = compact(Cloud.from_points(pts, valid), cap)
    assert int(r.count) == int(p.count)
    assert bool(r.overflow) == bool(p.overflow)
    np.testing.assert_array_equal(np.asarray(r.cloud.valid), p.cloud.valid.numpy())
    np.testing.assert_array_equal(np.asarray(r.cloud.points), p.cloud.points.numpy())
    np.testing.assert_array_equal(np.asarray(r.source_index), p.source_index.numpy())


def test_compact_occupied_blocks_is_ascending_rank_order():
    occ = torch.tensor(np.random.default_rng(2).random((16, 128)) < 0.1)
    loc, num = compact_occupied_blocks(occ, 64)
    want = np.flatnonzero(occ.numpy().reshape(-1))
    assert int(num) == len(want)
    np.testing.assert_array_equal(loc.numpy()[: min(64, len(want))], want[:64])


def test_compact_refuses_unaligned_capacity_and_extract_indices_masks():
    """A capacity off the 128 grid takes the reference's rank scatter (it
    was refused before that form was ported); ``extract_indices`` masks."""
    cloud = Cloud.pad_to(np.ones((5, 3), np.float32), 100)
    got = compact(cloud, 64)
    want = ref_compact(RefCloud.from_points(np.asarray(cloud.points), np.asarray(cloud.valid)), 64)
    assert int(got.count) == int(want.count) == 5
    np.testing.assert_array_equal(np.asarray(want.cloud.points), got.cloud.points.numpy())
    np.testing.assert_array_equal(np.asarray(want.source_index), got.source_index.numpy())
    keep = torch.zeros(100, dtype=torch.bool)
    keep[:2] = True
    assert int(extract_indices(cloud, keep).count()) == 2
    assert int(extract_indices(cloud, keep, negative=True).count()) == 3
