"""``ops.fma`` is XLA:CPU's fused multiply-add, bit for bit.

XLA:CPU contracts the reference's float32 ``a * b + c`` into one fused
multiply-add: one rounding.  The float64 sum of the exact product rounded
to float32 rounds twice and misses it where the float64 sum lands on a
float32 midpoint that the exact value lies just off; random operands
almost never do that, so ``utils.fma_cases`` builds such near ties.  Bar:
every bit against the jitted expressions (and, where the result is
float32-subnormal, which XLA:CPU flushes, against the exact rational sum
rounded to nearest even), on sets where the double-rounded form is shown
to differ at least 100 times.  On the CPU no kernel is launched.
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu_torch import _build, ops
from pointcloud_obstacle_processing_tpu_torch.utils import fma_cases

F32 = np.float32
N_TIES = 100_000


def _apart(a, b) -> int:
    return int((np.asarray(a, F32).view(np.int32) != np.asarray(b, F32).view(np.int32)).sum())


def _t(*arrays):
    return [torch.tensor(np.asarray(a, F32)) for a in arrays]


def _double_rounded(a, b, c):
    """The form ``ops.fma`` had before: the float64 sum rounded to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(F32)


def _rne_subnormal(x: Fraction) -> F32:
    """``x`` (|x| < 2^-125) rounded to the nearest multiple of 2^-149, ties
    to even: float32's rounding there, its quantum the same in the
    subnormal range and the lowest normal binade."""
    q = x * 2**149
    k = q.numerator // q.denominator
    rest = q - k
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and k % 2):
        k += 1
    return F32(k * 2.0**-149)


JIT_FMA = jax.jit(lambda a, b, c: a * b + c)
CHAINS = {
    "dot3": jax.jit(lambda ax, ay, az, bx, by, bz: ax * bx + ay * by + az * bz),
    "sum_sq3": jax.jit(lambda x, y, z: jnp.sum(jnp.stack([x, y, z], -1) ** 2, axis=-1)),
    "add_sq3": jax.jit(lambda x, y, z: x * x + y * y + z * z),
}


def test_fma_is_xla_cpu_on_the_constructed_triple():
    """a = 2^-24 (1 + 2^-12), b = 1 - 4095 * 2^-24, c = 1: a*b = 2^-24
    (1 + 2^-36), just above half an ulp of 1.  XLA:CPU gives 0x3f800001;
    the double-rounded form rounds the float64 tie to even, 0x3f800000."""
    a, b, c = F32(2.0**-24 * (1 + 2.0**-12)), F32(1 - 4095 * 2.0**-24), F32(1.0)
    want = np.asarray(JIT_FMA(a, b, c))
    assert want.view(np.int32) == 0x3F800001
    assert _double_rounded(a, b, c).view(np.int32) == 0x3F800000
    got = ops.fma(*_t(a, b, c)).numpy()
    assert got.dtype == F32 and got.view(np.int32) == 0x3F800001


def test_fma_is_bitwise_xla_cpu_on_near_ties():
    before = _build.LAUNCHES["fma_chain"]
    a, b, c = fma_cases.near_ties(0, N_TIES)
    want = np.asarray(JIT_FMA(a, b, c))
    assert _apart(_double_rounded(a, b, c), want) >= 100  # the set reaches the ties
    assert _apart(ops.fma(*_t(a, b, c)).numpy(), want) == 0
    assert _apart(ops.fma_plain(*_t(a, b, c)).numpy(), want) == 0
    assert _build.LAUNCHES["fma_chain"] == before  # the CPU takes the plain form


def test_fma_rounds_subnormal_results_to_nearest_even():
    """XLA:CPU flushes a float32-subnormal result to zero; the port keeps
    it, correctly rounded: the exact rational ``a*b + c`` rounded to
    nearest even."""
    a, b, c = fma_cases.subnormal_ties(1, 20_000)
    want = np.array([_rne_subnormal(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], F32)
    assert (np.abs(want) < F32(2.0**-126)).mean() > 0.99
    assert _apart(_double_rounded(a, b, c), want) >= 100
    assert _apart(ops.fma(*_t(a, b, c)).numpy(), want) == 0


@pytest.mark.parametrize("kind", list(CHAINS))
def test_chain_helpers_are_bitwise_xla_cpu_on_near_ties(kind):
    """``dot3``, ``sum_sq3`` and ``add_sq3`` against their jitted
    expressions, on operands whose chain's second step is a near tie; the
    double-rounded chain (its second step a float64 sum rounded once)
    differs on at least 100."""
    operands = fma_cases.chain_ties(2, N_TIES, kind)
    want = np.asarray(CHAINS[kind](*operands))
    got = getattr(ops, kind)(*_t(*operands)).numpy()
    assert _apart(got, want) == 0
    if kind == "dot3":
        ax, ay, _, bx, by, _ = operands
        old = _double_rounded(ax, bx, ay * by)
    else:  # the near square is the second step's product, the other the first
        first, second = operands[:2] if kind == "sum_sq3" else operands[1::-1]
        old = _double_rounded(second, second, first * first)
    assert _apart(old, want) >= 100


def test_fma_broadcasts_and_takes_constants():
    """Operands that broadcast ([N, 1] against [1, K], as RANSAC scores its
    hypotheses), non-contiguous views and 0-d constants (``ops.f32``), each
    element as the jitted expression gives it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((257, 1)).astype(F32)
    n = rng.standard_normal((1, 128)).astype(F32)
    acc = rng.standard_normal((128, 257)).astype(F32).T  # non-contiguous
    want = np.asarray(JIT_FMA(x, n, acc))
    got = ops.fma(torch.tensor(x), torch.tensor(n), torch.tensor(acc.T).T)
    assert got.is_contiguous() and got.shape == (257, 128)
    assert _apart(got.numpy(), want) == 0
    want = np.asarray(JIT_FMA(x, F32(0.04), F32(0.25)))
    assert _apart(ops.fma(torch.tensor(x), ops.f32(0.04), ops.f32(0.25)).numpy(), want) == 0


@pytest.mark.parametrize("bad", ["float64", "int32", "python float"])
def test_fma_refuses_operands_that_are_not_float32_tensors(bad):
    x = torch.ones(4)
    other = {"float64": torch.ones(4, dtype=torch.float64),
             "int32": torch.ones(4, dtype=torch.int32), "python float": 1.0}[bad]
    with pytest.raises(TypeError):
        ops.fma(x, other, x)
    with pytest.raises(TypeError):
        ops.dot3(x, x, x, x, x, other)


@pytest.mark.parametrize("case", ["ransac", "transposed", "sliced", "constants", "merged"])
def test_chain_layout_reads_each_operand_as_it_broadcasts(case):
    """The kernel's view of a call (``ops._layout``: merged sizes and
    each operand's strides over them, a broadcast dim's stride 0) reads
    every operand's elements exactly as ``expand`` lays them out, here
    replayed with ``as_strided`` on the CPU."""
    g = torch.Generator().manual_seed(5)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    operands = {
        "ransac": [r(2, 300, 1), r(2, 1, 128), r(2, 300, 128)],
        "transposed": [r(64, 48).T, r(48, 1), r(1, 64)],
        "sliced": [r(10, 20, 3)[..., 0], r(10, 20, 3)[..., 2], r(40)[::2]],
        "constants": [r(7, 5), ops.f32(2.0), r(1, 5)],
        "merged": [r(4, 6, 8), r(4, 6, 8), r(4, 6, 8)],
    }[case]
    shape, sizes, strides = ops._layout([t.shape for t in operands],
                                        [t.stride() for t in operands])
    assert len(sizes) <= ops.FMA_MAX_DIMS
    if case == "merged":
        assert sizes == [4 * 6 * 8]
    for t, st in zip(operands, strides):
        want = t.expand(shape).reshape(-1)
        got = torch.as_strided(t, sizes, st, t.storage_offset()).reshape(-1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["ransac", "transposed", "constants", "merged"])
def test_chain_plan_packs_the_layout(case):
    """The chain wrapper's cached launch plan (``ops._chain_plan``, keyed on
    each operand's shape, strides, device and dtype): its packed ``ChainArgs``
    hold ``_layout``'s merged sizes and strides, with every pointer,
    constant, out and stream field zero for the call to fill in at the
    offsets the plan names; operands that differ from a planned call only
    in a stride get a plan of their own."""
    g = torch.Generator().manual_seed(6)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    pairs, operands = {
        "ransac": (3, [r(2, 300, 1), r(2, 1, 128)] * 3),
        "transposed": (1, [r(64, 48).T, r(48, 1), r(1, 64)]),
        "constants": (1, [r(7, 5), ops.f32(2.0), ops.f32(0.5)]),
        "merged": (1, [r(4, 6, 8), r(4, 6, 8), r(4, 6, 8)]),
    }[case]
    # the card's operands stand in as device 0 (the plan reads no memory)
    layout = tuple((t.shape, t.stride(), 0 if t.dim() else -1, t.dtype) for t in operands)
    shape, n, packed, slots, out_at = ops._chain_plan(pairs, layout)
    want_shape, sizes, strides = ops._layout([t.shape for t in operands],
                                             [t.stride() for t in operands])
    assert shape == want_shape and n == want_shape.numel()
    fields = ops._FMA_ARGS.unpack(packed)
    dims = len(sizes)
    assert fields[:4 + dims] == (n, dims, pairs, int(len(operands) == 2 * pairs + 1), *sizes)
    per = 2 + ops.FMA_MAX_DIMS
    for i, (t, st, (at, on_card)) in enumerate(zip(operands, strides, slots)):
        base = 4 + ops.FMA_MAX_DIMS + i * per
        assert at == 8 * base and on_card == bool(t.dim())
        assert fields[base:base + 2] == (0, 0)  # pointer and constant: filled in a call
        assert list(fields[base + 2:base + 2 + dims]) == (st if t.dim() else [0] * dims)
    assert out_at == 8 * (len(fields) - 2) and fields[-2:] == (0, 0)
    if case == "transposed":  # the same shapes, one operand's strides changed
        other = (layout[0][0], (64, 1), 0, torch.float32), *layout[1:]
        assert ops._chain_plan(pairs, other)[2] != packed
        assert ops._chain_plan(pairs, other) is ops._chain_plan(pairs, other)
