"""Seeded near-tie inputs of the fused multiply-add (``ops.fma``,
``ops.fma_chain`` and the chain helpers) for checks.

A float32 ``a*b + c`` rounded twice, first to float64 and then to float32,
misses the fused result only where the float64 sum lands exactly on a
float32 rounding boundary (a midpoint) that the exact value lies just off.
Random operands almost never do that, so these cases are built to: the
exact value lies within a few float64 ulps of a float32 midpoint, off it.

* ``near_ties``: triples ``(a, b, c)``.  Half have ``c`` dominant, over a
  range of exponents and both signs, with ``a*b`` = +-(half a float32 ulp
  of ``c``) * (1 + delta), 2^-47 <= |delta| < 2^-29 (two 24-bit mantissas
  whose product lies next to 2^47); half have the product dominant, its
  low bits next to a float32 midpoint, and ``c`` small, placing the sum
  a few float64 ulps off that midpoint.
* ``subnormal_ties``: the same with a float32-subnormal ``c`` and result
  (XLA:CPU flushes such a result; an exact rational oracle decides there).
* ``chain_ties``: operands of ``dot3``, ``sum_sq3`` and ``add_sq3`` whose
  second step is such a near tie (the third pair 0).

NumPy only, so the CPU tests (against the JAX package), the card tests and
``chip_smoke.py`` build the same inputs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["near_ties", "subnormal_ties", "chain_ties"]


def _float32(mantissa, exponent) -> np.ndarray:
    """``mantissa * 2**exponent`` (an integer below 2^24 or a float64 of at
    most 24 significant bits) as float32, exactly."""
    return np.ldexp(np.asarray(mantissa, np.float64), np.asarray(exponent)).astype(np.float32)


def _pairs_next_to_power(rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` 24-bit mantissa pairs with ``ma * mb = 2^47 + r``, 0 < |r| < 2^18."""
    ma_all, mb_all = [], []
    while sum(len(m) for m in ma_all) < n:
        ma = rng.integers(2**23 + 1, 2**24, 32 * n, dtype=np.int64)
        mb = np.rint(2.0**47 / ma).astype(np.int64)
        r = ma * mb - 2**47
        keep = (r != 0) & (np.abs(r) < 2**18) & (mb >= 2**23) & (mb < 2**24)
        ma_all.append(ma[keep])
        mb_all.append(mb[keep])
    return np.concatenate(ma_all)[:n], np.concatenate(mb_all)[:n]


def _products_next_to_midpoint(rng, n: int, square: bool):
    """``n`` 24-bit mantissa pairs (``mb = ma`` with ``square``) whose
    product P, of L = 47 or 48 bits, lies d from a float32 midpoint of its
    binade, |d| < 2^(L - 32).  Returns (ma, mb, d, L)."""
    out = [[], [], [], []]
    while sum(len(m) for m in out[0]) < n:
        ma = rng.integers(2**23, 2**24, 1 << 20, dtype=np.int64)
        mb = ma if square else rng.integers(2**23, 2**24, 1 << 20, dtype=np.int64)
        p = ma * mb
        bits = np.where(p >= 2**47, 48, 47)
        d = (p & ((np.int64(1) << (bits - 24)) - 1)) - (np.int64(1) << (bits - 25))
        keep = np.abs(d) < (np.int64(1) << (bits - 32))
        for o, v in zip(out, (ma, mb, d, bits)):
            o.append(v[keep])
    return tuple(np.concatenate(o)[:n] for o in out)


def _off_midpoint(rng, d: np.ndarray, bits: np.ndarray, positive: bool = False) -> np.ndarray:
    """The addend, in units of the product's lowest bit, that puts ``P + c``
    at the midpoint plus ``j * 2^(L - 56)``, 0 < |j| <= 3: below half a
    float64 ulp of the sum (2^(L - 54)), and 24 significant bits at most.
    ``positive``: j > 0 (with d <= 0, a positive addend)."""
    j = rng.integers(1, 4, len(d))
    if not positive:
        j = j * rng.choice([-1, 1], len(d))
    return -d.astype(np.float64) + np.ldexp(j.astype(np.float64), bits - 56)


def _c_dominant(rng, n: int, exponents=(-60, 100)) -> tuple:
    """Triples with ``c`` in [2^E, 2^(E+1)) (E over ``exponents``, either
    sign, not a power of two) and ``a*b`` = +-2^(E - 24) (1 + delta)."""
    ma, mb = _pairs_next_to_power(rng, n)
    e = rng.integers(*exponents, n)
    c = _float32(rng.integers(2**23 + 1, 2**24, n) * rng.choice([-1, 1], n), e - 23)
    ea = (e - 71) // 2 + rng.integers(-8, 9, n)
    a = _float32(ma * rng.choice([-1, 1], n), ea)
    b = _float32(mb, e - 71 - ea)
    return a, b, c


def _product_dominant(rng, n: int) -> tuple:
    """Triples with ``a*b`` next to a float32 midpoint and ``c`` putting the
    sum a few float64 ulps off it; either sign."""
    ma, mb, d, bits = _products_next_to_midpoint(rng, n, square=False)
    sign = rng.choice([-1, 1], n)
    ea = rng.integers(-70, 30, n)
    eb = rng.integers(-40, 40, n)
    a = _float32(ma * sign, ea)
    b = _float32(mb, eb)
    c = _float32(_off_midpoint(rng, d, bits) * sign, ea + eb)
    return a, b, c


def near_ties(seed: int, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` float32 triples ``(a, b, c)`` whose exact ``a*b + c`` lies a
    few float64 ulps off a float32 midpoint: half with ``c`` dominant, half
    with the product dominant, shuffled together."""
    rng = np.random.default_rng(seed)
    parts = [_c_dominant(rng, n // 2), _product_dominant(rng, n - n // 2)]
    order = rng.permutation(n)
    return tuple(np.concatenate([p[k] for p in parts])[order] for k in range(3))


def subnormal_ties(seed: int, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` triples with a float32-subnormal ``c`` = k * 2^-149 (either
    sign) and ``a*b`` = +-2^-150 (1 + delta): the exact sum lies just off
    a midpoint of the subnormal grid."""
    rng = np.random.default_rng(seed)
    ma, mb = _pairs_next_to_power(rng, n)
    c = _float32(rng.integers(1, 2**23, n) * rng.choice([-1, 1], n), -149)
    ea = rng.integers(-140, -57, n)  # a and b both normal: 47 + ea + eb = -150
    a = _float32(ma * rng.choice([-1, 1], n), ea)
    b = _float32(mb, -197 - ea)
    return a, b, c


def chain_ties(seed: int, n: int, kind: str) -> tuple[np.ndarray, ...]:
    """Operands of ``kind`` ("dot3": (ax, ay, az, bx, by, bz); "sum_sq3" and
    "add_sq3": (x, y, z)) whose chain's second step, ``fma(a1, b1, a0 *
    b0)``, is a near tie; the third pair is 0.  For the squares the first
    product is the rounded square that puts the sum off the midpoint."""
    rng = np.random.default_rng(seed)
    zero = np.zeros(n, np.float32)
    if kind == "dot3":  # fma(az, bz, fma(ax, bx, ay * by)); ay * by = c exactly
        ax, bx, c = _product_dominant(rng, n)
        return ax, c, zero, bx, np.ones(n, np.float32), zero
    # fma(z, z, fma(y, y, x * x)) (sum_sq3) or fma(z, z, fma(x, x, y * y))
    # (add_sq3): the square near the midpoint, the other square off it
    m, _, d, bits = _products_next_to_midpoint(rng, 8 * n, square=True)
    keep = d <= 0
    m, d, bits = m[keep], d[keep], bits[keep]
    e = rng.integers(-50, 30, len(m))
    near = _float32(m, e)
    target = np.ldexp(_off_midpoint(rng, d, bits, positive=True), 2 * e)
    # the float32 whose rounded square lies between the midpoint and the
    # target (a step on either side of sqrt(target) tried)
    best = np.full(len(m), np.nan, np.float32)
    mid = np.ldexp(-d.astype(np.float64), 2 * e)
    limit = np.ldexp(np.ones(len(m)), bits - 54 + 2 * e)
    root = np.sqrt(target).astype(np.float32)
    for k in (0, -1, 1, -2, 2):
        r = (root.view(np.int32) + k).view(np.float32)
        sq = (r * r).astype(np.float64)
        ok = np.isnan(best) & (sq != mid) & (np.abs(sq - mid) < limit)
        best = np.where(ok, r, best)
    found = ~np.isnan(best)
    near, other = near[found][:n], best[found][:n]
    if len(near) < n:
        raise RuntimeError(f"chain_ties: {len(near)} of {n} cases found")
    return (other, near, zero[:n]) if kind == "sum_sq3" else (near, other, zero[:n])
