"""Weighted binning of the PyTorch port (kernel K7's plain version) against
the JAX package's ``binned_weighted_sum``, its Pallas kernel run in TPU
interpret mode on the CPU.

Bar: counts (unit weights) bitwise; sums within the float32 reordering
bound.  Both packages add the same float32 terms (hi = bf16(w) and, with
``exact_f32``, lo = bf16(w - hi)) into each bin, in orders neither fixes:
the reference's one-hot products accumulate per chunk, the port's
``index_add_`` and the kernel's atomics in their own orders.  Two such sums
of a bin's n_j terms lie within 2 * n_j * 2^-24 * S_j of each other, S_j
the sum of their magnitudes (``ops.binning.reordering_bound`` gives the
reason).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointcloud_obstacle_processing_tpu.ops import pallas_binning as ref_binning

from pointcloud_obstacle_processing_tpu_torch.ops import binning


def _inputs(seed, n, k, c, frac_valid=0.9, unit=False):
    """Ids mostly in [0, k), some negative, some in the reference's padding
    bins [k, a*b) and some past a*b; about 10% invalid rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int32)
    odd = rng.random(n)
    ids[odd < 0.03] = -rng.integers(1, 1000, (odd < 0.03).sum())
    ids[(odd >= 0.03) & (odd < 0.06)] = k + rng.integers(0, 64, ((odd >= 0.03) & (odd < 0.06)).sum())
    ids[(odd >= 0.06) & (odd < 0.08)] = 2**30 + 7
    if unit:
        w = np.ones((n, c), np.float32)
    else:
        w = (rng.standard_normal((n, c)) * 10.0 ** rng.integers(-3, 4, (n, 1))).astype(np.float32)
    return ids, w, rng.random(n) < frac_valid


def _reference(ids, w, valid, k, exact_f32):
    with pltpu.force_tpu_interpret_mode():
        out = ref_binning.binned_weighted_sum(jnp.asarray(ids), jnp.asarray(w),
                                              jnp.asarray(valid), k, exact_f32=exact_f32)
    return np.asarray(out)


@pytest.mark.parametrize("exact_f32", [True, False])
@pytest.mark.parametrize("n,k,c", [(8192, 20000, 4), (4096, 300, 4), (2048, 1, 2)])
def test_binning_sums_within_bound_of_reference(n, k, c, exact_f32):
    ids, w, valid = _inputs(n + k, n, k, c)
    want = _reference(ids, w, valid, k, exact_f32)
    got = binning.binned_weighted_sum(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), k,
                                      exact_f32=exact_f32).numpy()
    assert got.shape == want.shape == (k, c) and got.dtype == np.float32
    bound = binning.reordering_bound(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), k,
                                     exact_f32).numpy()
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    if exact_f32:  # the two bf16 terms carry w to about 2^-16 relative
        keep = valid & (ids >= 0) & (ids < k)
        exact = np.zeros((k, c))
        np.add.at(exact, ids[keep], w[keep].astype(np.float64))
        np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("exact_f32", [True, False])
def test_binning_counts_are_exact(exact_f32):
    n, k = 8192, 3000
    ids, w, valid = _inputs(5, n, k, 4, unit=True)
    want = _reference(ids, w, valid, k, exact_f32)
    got = binning.binned_weighted_sum(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), k,
                                      exact_f32=exact_f32).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    keep = valid & (ids >= 0) & (ids < k)
    np.testing.assert_array_equal(got[:, 0], np.bincount(ids[keep], minlength=k))


def test_binning_out_of_range_ids_add_nothing():
    """Valid rows with ids below 0, in the padding bins or past them."""
    k, c = 300, 3
    ids = np.array([-1, -129, k, k + 5, 2**30, 299, 0] + [10] * 1017, np.int32)
    w = np.ones((1024, c), np.float32)
    valid = np.ones(1024, bool)
    want = _reference(ids, w, valid, k, True)
    got = binning.binned_weighted_sum(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == 3 * (1024 - 5)


def test_binning_terms_are_the_reference_split():
    w = np.array([[1.0 + 2.0**-10, -3.14159274, 1e-30, 65504.5, -0.0, 3.0e38]], np.float32)
    hi_ref = jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)
    lo_ref = (jnp.asarray(w) - hi_ref).astype(jnp.bfloat16).astype(jnp.float32)
    hi, lo = binning.weight_terms(torch.tensor(w), True)
    np.testing.assert_array_equal(hi.numpy().view(np.int32), np.asarray(hi_ref).view(np.int32))
    np.testing.assert_array_equal(lo.numpy().view(np.int32), np.asarray(lo_ref).view(np.int32))
    assert len(binning.weight_terms(torch.tensor(w), False)) == 1


def test_binning_refuses_what_the_reference_refuses():
    ids, w, valid = _inputs(1, 1000, 50, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ref_binning.binned_weighted_sum(jnp.asarray(ids), jnp.asarray(w), jnp.asarray(valid), 50)
    with pytest.raises(ValueError, match="not divisible"):
        binning.binned_weighted_sum(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), 50)
    assert binning.binned_weighted_sum(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), 50,
                                       chunk=500).shape == (50, 4)
