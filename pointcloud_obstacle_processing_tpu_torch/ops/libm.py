"""The reference's float32 ``arcsin`` and ``tan``, bit for bit, as plain
PyTorch.

The reference runs on XLA:CPU, which lowers ``jnp.arcsin(x)`` to
``2 * atan2(x, 1 + sqrt((1 - x) * (1 + x)))`` and calls the C library's
``atan2f`` and ``tanf`` for the two transcendental steps.  On the x86-64
Linux hosts the reference is tested on (glibc 2.36), those are:

* ``atan2f``: ``__atan2f_finite``, fdlibm's ``e_atan2f.c`` on top of its
  float ``atanf`` (``s_atanf.c``: a reduction to one of five intervals and
  an odd/even split 11-term polynomial), single-precision steps only;
* ``tanf``: glibc's own ``s_tanf.c``: the argument reduced in float64 by
  ``reduce_fast`` (|x| < 120) or the integer ``reduce_large`` of
  ``s_sincosf.h``, then fdlibm's float ``__kernel_tanf`` (``k_tanf.c``,
  with glibc's near-pi/4 short cut).

Each function below replays that arithmetic one IEEE operation at a time:
every float32 and float64 step is one PyTorch operation, rounded once, in
the library's operand order; the library contracts nothing into fused
multiply-adds, and neither does eager PyTorch.  The constants are the
library's bit patterns (read off its ``.rodata``), and every branch of the
library becomes a ``torch.where`` over all of them.  ``csrc/libm32.cuh``
holds the same routines for the card, one thread a value.

``scripts/torch_libm_exhaustive.py`` holds ``asin_like_xla`` and ``tanf``
against the C library on every float32 of their domains.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import sqrt32
from .. import _build

__all__ = ["atan2f", "atanf", "tanf", "asin_like_xla", "acos_like_xla", "on_card", "ROUTINES"]


def _f(bits: int) -> float:
    """The float32 of a bit pattern, as an exact Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _d(bits: int) -> float:
    """The float64 of a bit pattern."""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# s_atanf.c: atan(0.5), atan(1), atan(1.5), atan(inf) split hi + lo
_ATANHI = (_f(0x3EED6338), _f(0x3F490FDA), _f(0x3F7B985E), _f(0x3FC90FDA))
_ATANLO = (_f(0x31AC3769), _f(0x33222168), _f(0x33140FB4), _f(0x33A22168))
# its polynomial aT[0..10]; the odd terms are negative, and the library
# subtracts their magnitudes
_AT_EVEN = (_f(0x3EAAAAAB), _f(0x3E124925), _f(0x3DBA2E6E), _f(0x3D886B35), _f(0x3D4BDA59),
            _f(0x3C8569D7))
_AT_ODD = (_f(0x3E4CCCCD), _f(0x3DE38E38), _f(0x3D9D8795), _f(0x3D6EF16B), _f(0xBD15A221))

# e_atan2f.c
_PI = _f(0x40490FDB)
_PI_O_2 = _f(0x3FC90FDB)
_PI_O_4 = _f(0x3F490FDB)
_NEG_PI_LO = _f(0x33BBBD2E)  # -pi_lo: the library adds it where the source subtracts pi_lo
_HALF_PI_LO = _f(0x333BBD2E)  # -0.5 * pi_lo
_TINY = _f(0x0DA24260)  # 1e-30
_FLT_MIN = _f(0x00800000)  # the least normal float32

# __kernel_tanf: T[0..12], split as the library evaluates them
_T0 = _f(0x3EAAAAAB)
_T_ODD = (_f(0x3E088889), _f(0x3CB327A4), _f(0x3B6B6916), _f(0x3A1A26C8), _f(0x38A3F445),
          _f(0xB79BAE5F))  # T[1], T[3], ... T[11]
_T_EVEN = (_f(0x3D5D0DD1), _f(0x3C11371F), _f(0x3ABEDE48), _f(0x398137B9), _f(0x3895C07A),
           _f(0x37D95384))  # T[2], T[4], ... T[12]
_PIO4 = _f(0x3F490FDA)
_PIO4LO = _f(0x33222168)
_TWO_M13 = _f(0x39000000)  # 0x1p-13

# s_sincosf.h: 2/pi scaled by 2^24, pi/2, pi/2 * 2^-62, and __inv_pio4
_HPI_INV = _d(0x41645F306DC9C883)
_HPI = _d(0x3FF921FB54442D18)
_PI63 = _d(0x3C1921FB54442D18)
_INV_PIO4 = (0x000000A2, 0x0000A2F9, 0x00A2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415,
             0x4E441529, 0x441529FC, 0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534,
             0xD1F534DD, 0xF534DDC0, 0x34DDC0DB, 0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C,
             0x95993C43, 0x993C4390, 0x3C439041)


def _c32(*ops) -> float:
    """A constant the library folds from float32 operands, e.g. ``pi +
    tiny``: evaluated in numpy float32, one rounding an operation, left to
    right (``op`` is ``+`` or ``-`` between the operands)."""
    acc = np.float32(ops[0])
    for i in range(1, len(ops), 2):
        v = np.float32(ops[i + 1])
        acc = np.float32(acc + v) if ops[i] == "+" else np.float32(acc - v)
    return float(acc)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _over(value: float, t: torch.Tensor) -> torch.Tensor:
    """``value / t`` as one division (a Python scalar over a tensor would
    take PyTorch's reciprocal and a product)."""
    return torch.full_like(t, value) / t


def _pick(ident: torch.Tensor, table) -> torch.Tensor:
    """``table[ident]`` for ``ident`` in 0-3 as float32 (other values take
    entry 3)."""
    out = torch.where(ident == 2, table[2], table[3])
    return torch.where(ident == 1, table[1], torch.where(ident == 0, table[0], out))


def atanf(x: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``atanf`` (fdlibm ``s_atanf.c``)."""
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    # the reduction: id -1 (|x| < 7/16), 0 (< 11/16), 1 (< 19/16), 2 (< 39/16), 3
    ident = torch.where(ix < 0x3EE00000, -1,
                        torch.where(ix < 0x3F300000, 0,
                                    torch.where(ix < 0x3F980000, 1,
                                                torch.where(ix < 0x401C0000, 2, 3))))
    red = torch.where(
        ident == 0, ((ax + ax) - 1.0) / (ax + 2.0),
        torch.where(ident == 1, (ax - 1.0) / (ax + 1.0),
                    torch.where(ident == 2, (ax - 1.5) / (ax * 1.5 + 1.0), _over(-1.0, ax))))
    xr = torch.where(ident < 0, x, red)
    z = xr * xr
    w = z * z
    s1 = torch.full_like(w, _AT_EVEN[5])
    for c in reversed(_AT_EVEN[:5]):
        s1 = s1 * w + c
    s1 = s1 * z
    s2 = w * _AT_ODD[4]
    for c in reversed(_AT_ODD[:4]):
        s2 = (s2 - c) * w
    s = (s1 + s2) * xr
    far = _pick(ident, _ATANHI) - ((s - _pick(ident, _ATANLO)) - xr)
    out = torch.where(ident < 0, xr - s, torch.where(hx < 0, -far, far))
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29: x itself
    big = torch.where(hx > 0, _c32(_ATANHI[3], "+", _ATANLO[3]),
                      _c32(-_ATANHI[3], "-", _ATANLO[3]))
    out = torch.where(ix >= 0x4C000000, big, out)  # |x| >= 2^25
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``atan2f(y, x)`` (fdlibm ``e_atan2f.c``)."""
    return _atan2f(y, x, flush=False)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """``v`` with subnormals replaced by zeros of their sign."""
    return torch.where(v.abs() < _FLT_MIN, v * 0.0, v)


def _atan2f(y: torch.Tensor, x: torch.Tensor, flush: bool) -> torch.Tensor:
    """``atan2f``; with ``flush``, as it runs under XLA:CPU's flush-to-zero
    mode, where a quotient ``y / x`` below the least normal float32 is
    zero."""
    y, x = torch.broadcast_tensors(y, x)
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2 * sign(x) + sign(y)
    inf = 0x7F800000

    def by_m(v0, v1, v2, v3):
        return torch.where(m == 0, v0, torch.where(m == 1, v1, torch.where(m == 2, v2, v3)))

    k = (iy - ix) >> 23
    q = y / x
    if flush:  # x86 detects the underflow before rounding: a quotient that rounds up to
        # the least normal is flushed too (the float64 quotient of two float32s decides)
        q = torch.where((y.double() / x.double()).abs() < _FLT_MIN, q * 0.0, q)
    z = atanf(q.abs())
    z = torch.where(k > 60, _c32(_PI_O_2, "-", _HALF_PI_LO),
                    torch.where((hx < 0) & (k < -60), 0.0, z))
    out = by_m(z, -z, _PI - (z + _NEG_PI_LO), (z + _NEG_PI_LO) - _PI)
    up_down = torch.where(hy < 0, _c32(-_PI_O_2, "-", _TINY), _c32(_TINY, "+", _PI_O_2))
    out = torch.where(iy == inf, up_down, out)  # y infinite
    pi_t, neg_pi_t = _c32(_TINY, "+", _PI), _c32(-_PI, "-", _TINY)
    x_inf = torch.where(
        iy == inf,
        by_m(torch.full_like(x, _c32(_TINY, "+", _PI_O_4)), torch.full_like(x, _c32(-_PI_O_4, "-", _TINY)),
             torch.full_like(x, _c32(float(np.float32(3.0) * np.float32(_PI_O_4)), "+", _TINY)),
             torch.full_like(x, _c32(float(np.float32(-3.0) * np.float32(_PI_O_4)), "-", _TINY))),
        by_m(torch.full_like(x, 0.0), torch.full_like(x, -0.0), torch.full_like(x, pi_t), torch.full_like(x, neg_pi_t)))
    out = torch.where(ix == inf, x_inf, out)
    out = torch.where(ix == 0, up_down, out)  # x zero
    y_zero = by_m(y, y, torch.full_like(x, pi_t), torch.full_like(x, neg_pi_t))
    out = torch.where(iy == 0, y_zero, out)
    out = torch.where(hx == 0x3F800000, atanf(y), out)  # x = 1
    return torch.where((ix > inf) | (iy > inf), x + y, out)


def _trunc12(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its 12 lowest mantissa bits cleared."""
    return (_bits(v) & -4096).view(torch.float32)


def _kernel_tanf(x: torch.Tensor, y: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """fdlibm's ``__kernel_tanf(x, y, iy)`` as glibc 2.36 builds it: tan(x +
    y) for iy = 1, -1/tan(x + y) for iy = -1, |x + y| <= pi/4."""
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    big = ix >= 0x3F2CA140  # |x| >= 0.6744
    flip = big & (hx < 0)
    xs, ys = torch.where(flip, -x, x), torch.where(flip, -y, y)
    xb = (_PIO4LO - ys) + (_PIO4 - xs)
    xx = torch.where(big, xb, x)
    yy = torch.where(big, torch.zeros_like(y), y)
    sign = (1 - ((hx >> 30) & 2)).to(torch.float32)
    iyf = iy.to(torch.float32)
    # glibc's short cut near pi/4: (1 - ((hx>>30)&2)) * iy * (1 - 2*iy*x)
    near = (sign * iyf) * (1.0 - (2 * iy).to(torch.float32) * xb)

    z = xx * xx
    w = z * z
    s = xx * z
    r = torch.full_like(w, _T_ODD[5])
    for c in reversed(_T_ODD[:5]):
        r = r * w + c
    v = torch.full_like(w, _T_EVEN[5])
    for c in reversed(_T_EVEN[:5]):
        v = v * w + c
    r = yy + ((v * z + r) * s + yy) * z
    r = s * _T0 + r
    w = xx + r
    far = sign * (iyf - 2.0 * (xx - ((w * w) / (w + iyf) - r)))
    # iy = -1: -1/w to full precision through the 12-bit-cleared parts
    zt = _trunc12(w)
    vv = r - (zt - xx)
    a = _over(-1.0, w)
    t = _trunc12(a)
    inv = t + ((vv * t) + (zt * t + 1.0)) * a
    out = torch.where(big, far, torch.where(iy == 1, w, inv))
    out = torch.where(big & (xb.abs() < _TWO_M13), near, out)
    # |x| < 2^-13
    tiny = torch.where((ix | (iy + 1)) == 0, _over(1.0, x.abs()),
                       torch.where(iy == 1, x, _over(-1.0, x)))
    return torch.where(ix < 0x39000000, tiny, out)


def _reduce_large(x: torch.Tensor):
    """``reduce_large`` of glibc's ``s_sincosf.h``: x - n*pi/2 for |x| >=
    120, from the bits of 2/pi (``__inv_pio4``), in 64-bit integers; the
    unsigned steps are written with masks over torch's signed int64."""
    xi = _bits(x).long() & 0xFFFFFFFF
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=x.device)
    j = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift  # < 2^31
    res0 = (m * table[j]) & 0xFFFFFFFF  # a 32-bit product
    res1 = m * table[j + 4]  # < 2^63: no wrap
    res2 = m * table[j + 8]
    res0 = (res2 >> 32) | (res0 << 32)
    res0 = res0 + res1  # wraps mod 2^64 as the library's uint64_t does
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    dx = res0.double() * _PI63
    return torch.where(x < 0, -dx, dx), n.to(torch.int32)


def tanf(x: torch.Tensor) -> torch.Tensor:
    """The C library's float32 ``tanf`` (glibc 2.36 ``s_tanf.c``)."""
    hx = _bits(x)
    ix = hx & 0x7FFFFFFF
    dx = x.double()
    # reduce_fast: the quadrant from 2/pi * 2^24, rounded by the +2^23 carry
    n = ((dx * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    red = dx - n.double() * _HPI
    large, n_large = _reduce_large(x)
    top12 = (hx >> 20) & 0x7FF
    red = torch.where(top12 > 0x42E, large, red)
    n = torch.where(top12 > 0x42E, n_large, n)
    y0 = red.to(torch.float32)
    y1 = (red - y0.double()).to(torch.float32)
    iy = 1 - ((n & 1) << 1)
    small = ix <= 0x3F490FDA  # |x| <~ pi/4: no reduction
    out = _kernel_tanf(torch.where(small, x, y0), torch.where(small, 0.0, y1),
                       torch.where(small, 1, iy))
    return torch.where(ix >= 0x7F800000, x - x, out)


def asin_like_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``arcsin`` as XLA:CPU evaluates the reference's ``jnp.arcsin``:
    ``2 * atan2f(x, 1 + sqrt((1 - x) * (1 + x)))``, the root correctly
    rounded (``ops.sqrt32``).  XLA:CPU runs it with subnormals flushed to
    zero, in and out: a subnormal ``x`` counts as zero, and so does a
    quotient inside ``atan2f`` below the least normal before rounding (x
    below 2^-125 in magnitude), so either gives a zero of x's sign; ``tanf``, whose subnormal results
    are its argument returned untouched, needs no such care."""
    x = _flush(x)
    return 2.0 * _atan2f(x, 1.0 + sqrt32((1.0 - x) * (1.0 + x)), flush=True)


def acos_like_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``arccos`` as XLA:CPU evaluates the reference's ``jnp.arccos``:
    ``atan2f(sqrt((1 - x) * (1 + x)), x)``, the root correctly rounded, under
    the flush-to-zero of ``asin_like_xla`` (read off the optimized HLO of
    the jitted ``jnp.arccos``).  RANSAC's axis gate decides by it
    (``ops.ransac.axis_cos_min``); torch's own ``arccos`` differs from it by
    an ulp on about 2% of [0, 1]."""
    x = _flush(x)
    return _atan2f(sqrt32((1.0 - x) * (1.0 + x)), x, flush=True)


ROUTINES = {"asin_like_xla": asin_like_xla, "tanf": tanf, "atan2f": atan2f}


def on_card(routine: str, a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """``ROUTINES[routine](a)`` (``atan2f``: ``(a, b)``) as ``csrc/libm32.cuh``
    evaluates it: one launch over a contiguous float32 CUDA tensor, a thread
    a value.  The shadow kernel calls these routines inline; this entry lets
    a check hold them to the plain forms above."""
    with _build.launch("libm32") as launch:
        names = list(ROUTINES)
        if routine not in names or (b is None) != (routine != "atan2f"):
            raise ValueError(f"on_card: a routine of {names}, with b for atan2f only")
        ops = (a, b) if b is not None else (a,)
        _build.require_cuda("libm32", *ops, dtypes=(torch.float32,) * len(ops))
        if b is not None and b.shape != a.shape:
            raise ValueError("on_card: a and b of one shape")
        out = torch.empty_like(a)
        if out.numel():
            err = _build.kernels().pcp_libm32(a.data_ptr(), 0 if b is None else b.data_ptr(),
                                              a.numel(), names.index(routine), out.data_ptr(),
                                              _build.stream_handle())
            _build.check(err, "libm32")
        else:
            launch.skip()
    return out
