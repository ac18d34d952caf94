"""The segmented inclusive scan of the PyTorch port (kernel K6's plain
version) against the JAX package's ``segmented_inclusive_scan``.

Bar: bit patterns equal (compared as int32, so -0.0 and +0.0 differ), on
the reference's XLA form and on its Pallas kernel run in TPU interpret mode
on the CPU.  Both packages add in the same explicit step order, and the
steps hold only adds and selects, so nothing may differ.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointcloud_obstacle_processing_tpu.ops import segscan as ref_segscan

from pointcloud_obstacle_processing_tpu_torch.ops import segscan


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _both(v, h):
    want = ref_segscan.segmented_inclusive_scan(jnp.asarray(v), jnp.asarray(h))
    got = segscan.segmented_inclusive_scan(torch.tensor(v), torch.tensor(h))
    assert got.dtype == torch.float32 and tuple(got.shape) == v.shape
    return _bits(want), _bits(got.numpy())


@pytest.mark.parametrize("n,c,density", [(128, 1, 0.1), (384, 3, 0.3), (1000, 4, 0.02)])
def test_segscan_equals_reference_bitwise(n, c, density):
    """The shapes of tests/test_segscan.py."""
    rng = np.random.default_rng(n + c)
    v = rng.standard_normal((c, n)).astype(np.float32)
    h = rng.random(n) < density
    want, got = _both(v, h)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("shape", [(2, 3, 257), (700,), (2, 1, 2, 64), (5, 1)])
def test_segscan_leading_dims_are_channels(shape):
    rng = np.random.default_rng(len(shape))
    v = rng.standard_normal(shape).astype(np.float32)
    h = rng.random(shape[-1]) < 0.05
    want, got = _both(v, h)
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("heads", ["all", "none", "first"])
def test_segscan_all_heads_and_no_heads(heads):
    n = 1031
    v = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    v[:, 5] = -0.0
    h = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
         "first": np.arange(n) == 0}[heads]
    want, got = _both(v, h)
    np.testing.assert_array_equal(want, got)
    if heads == "all":  # each row alone, plus +0.0: -0.0 comes out +0.0
        exp = v.copy()
        exp[:, 5] = 0.0
        np.testing.assert_array_equal(got, _bits(exp))


def test_segscan_signed_zeros_and_non_finite_values():
    rng = np.random.default_rng(3)
    n = 2000
    v = rng.standard_normal((3, n)).astype(np.float32)
    v[:, rng.random(n) < 0.2] = -0.0
    v[0, 17], v[1, 400], v[2, 1500] = np.inf, -np.inf, np.nan
    v[0, 900] = -np.inf  # meets +inf inside a segment unless a head lies between
    h = rng.random(n) < 0.03
    h[[18, 401, 1501]] = True  # the non-finite values end their segments
    want, got = _both(v, h)
    np.testing.assert_array_equal(want, got)
    assert (got == _bits(np.float32(-0.0))).sum() == (want == _bits(np.float32(-0.0))).sum()


@pytest.mark.parametrize("c,n", [(3, 8192), (4, 1024), (1, 128)])
def test_segscan_equals_reference_pallas_kernel_interpreted(c, n):
    """The reference's Pallas kernel (its TPU path, N % 128 == 0), run in
    TPU interpret mode on the CPU."""
    rng = np.random.default_rng(c * n)
    v = rng.standard_normal((c, n)).astype(np.float32)
    v[:, rng.random(n) < 0.05] = -0.0
    h = rng.random(n) < 0.02
    with pltpu.force_tpu_interpret_mode():
        want = ref_segscan._segscan_pallas(jnp.asarray(v), jnp.asarray(h))
    got = segscan.segmented_inclusive_scan(torch.tensor(v), torch.tensor(h))
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))


def test_segscan_matches_running_sum_and_step_count():
    rng = np.random.default_rng(9)
    n = 3000
    v = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.random(n) < 0.01
    got = segscan.segmented_inclusive_scan(torch.tensor(v), torch.tensor(h)).numpy()
    exp = np.zeros_like(v)
    acc = np.zeros(2)
    for i in range(n):
        acc = np.zeros(2) if h[i] else acc
        acc = acc + v[:, i]
        exp[:, i] = acc
    np.testing.assert_allclose(got, exp, atol=1e-4)
    assert segscan.scan_steps(131_072)[-1] == 65_536 and len(segscan.scan_steps(131_072)) == 17
    assert len(segscan.scan_steps(2_097_152)) == 21 and segscan.scan_steps(1) == []


def test_segscan_refuses_bad_operands():
    v = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        segscan.segmented_inclusive_scan(v, torch.zeros(63, dtype=torch.bool))
    with pytest.raises(TypeError):
        segscan.segmented_inclusive_scan(v.double(), torch.zeros(64, dtype=torch.bool))
