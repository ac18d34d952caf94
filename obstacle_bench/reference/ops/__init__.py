"""Device-side compute stages of the port (mirrors the reference's ``ops``)."""

import numpy as np
import torch


def query_range(n: int, span) -> tuple[int, int]:
    """(first, count) of the query rows or tiles a call computes: all ``n``,
    or ``span`` = (first, count) inside them (a rank's share on the
    point-sharded path)."""
    first, count = (0, n) if span is None else span
    if not (0 <= first and count >= 1 and first + count <= n):
        raise ValueError(f"query range {span} outside the {n} rows or tiles")
    return first, count


def f32(value: float) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d CPU tensor.

    The reference's Python constants enter float32 arithmetic rounded to
    float32; this makes that rounding explicit.  PyTorch takes a 0-d CPU
    tensor as an operand of a CUDA operation without copying it to the
    device, so, unlike ``torch.tensor(v, device="cuda")``, it never waits
    for the stream.
    """
    return torch.tensor(np.float32(value))


def recip32(value: float) -> torch.Tensor:
    """``1 / value`` rounded to float32 from the float32 ``value``, as a 0-d
    CPU tensor.  XLA:CPU evaluates a division by a constant, ``x /
    jnp.float32(c)``, as the product ``x * (1 / c)`` with this reciprocal;
    the port multiplies by it wherever a floor or ceil of such a quotient
    decides a cell or a voxel."""
    return torch.tensor(np.float32(1.0) / np.float32(value))


def fma_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors, correctly rounded to float32 once:
    the port's single definition of the fused multiply-add.

    The float64 product of two float32 values is exact, so their float64
    sum with ``c``, ``s``, rounds once.  Rounding ``s`` to float32 gives
    the fused result wherever ``s`` is not a float32 rounding boundary: a
    float32 midpoint (its low 29 mantissa bits 0x10000000) or a value of
    the float32-subnormal range, where the boundaries lie elsewhere in the
    bits.  Where ``s`` is one (rare; ``_round_to_odd``), the sum is taken
    again rounded to odd, whose one rounding to float32 is correct, ties
    included.  (XLA:CPU flushes a subnormal result to zero; the port keeps
    it.)"""
    _check_float32("fma", (a, b, c))
    # float64 in c, and in a or b where c is 0-d (a 0-d operand alone does
    # not set the result's type): the sum is taken in float64, the product
    # exact
    c = c.double()
    if not c.dim():
        if a.numel() >= b.numel():
            a = a.double()
        else:
            b = b.double()
    s = torch.addcmul(c, a, b).contiguous()  # (the sum takes the layout of c)
    r = s.to(torch.float32)
    flat_s, flat_r = s.view(-1), r.view(-1)
    # the low 29 mantissa bits 0x10000000 (1 or 0, as int64)
    edge = torch.bitwise_and(flat_s.view(torch.int64), 0x1FFFFFFF).eq_(0x10000000)
    small = flat_r.abs()
    if small.numel() and small.min() <= _FLT_MIN:
        edge |= (small <= _FLT_MIN) & (flat_s != 0)  # an exact zero is no boundary
    if edge.any():
        at = edge.nonzero()[:, 0]
        where = torch.unravel_index(at, r.shape)
        p, q, e = (t.expand(r.shape)[where] if t.dim() else t for t in (a, b, c))
        flat_r[at] = _round_to_odd(p.double() * q.double(), e.double()).to(torch.float32)
    return r


_FLT_MIN = float(np.finfo(np.float32).tiny)


def _round_to_odd(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` of float64 ``p`` and ``c`` rounded to odd: the float64 sum
    ``s`` and its TwoSum error ``e`` (``s + e == p + c`` exactly); where
    ``e != 0`` and ``s`` is finite with its last mantissa bit 0, ``s`` steps
    one ulp toward ``e`` (the integer form of ``torch.nextafter``).  53 >=
    24 + 2 bits, so its one rounding to float32 is the correctly rounded
    ``p + c``."""
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)
    # an inexact s (e nonzero; NaN where s is not finite) whose last bit is
    # even: one ulp down in magnitude where e and s differ in sign (bits - 1
    # is then odd), up where they agree (bits | 1 = bits + 1); an odd s is
    # left as it is by both steps
    bits = s.view(torch.int64)
    bits = (bits - (e * s < 0).long()) | (e.abs() > 0).long()
    return bits.view(torch.float64)


def _check_float32(name: str, operands) -> None:
    for t in operands:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 tensor operands, got "
                            f"{getattr(t, 'dtype', type(t).__name__)}")


def fma_chain(pairs, c: torch.Tensor | None = None) -> torch.Tensor:
    """XLA:CPU's contracted chain of products: ``acc = c`` (or, with no
    addend, ``acc = a0 * b0`` rounded), then ``acc = fma(a_i, b_i, acc)``
    for each later pair ``(a_i, b_i)`` of ``pairs`` in order.  The forms
    the port writes: one pair and an addend (``fma``), or three pairs and
    none (``sum_sq3``, ``dot3``, ``add_sq3``).  Operands are float32
    tensors that broadcast together."""
    if (len(pairs), c is None) not in ((1, False), (3, True)):
        raise ValueError("fma_chain: one pair and an addend, or three pairs and none")
    return fma_chain_plain(pairs, c)


def fma_chain_plain(pairs, c: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``fma_chain``: ``fma_plain`` a step (on any
    device)."""
    if c is None:
        (a0, b0), *pairs = pairs
        _check_float32("fma_chain", (a0, b0))
        c = a0 * b0
    for a, b in pairs:
        c = fma_plain(a, b, c)
    return c


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as XLA:CPU evaluates a
    multiply that feeds an add: it contracts the two into a fused
    multiply-add, so the reference evaluates many of its float32 sums of
    products this way; the port writes out each such chain where a decision
    or a bitwise result depends on it."""
    return fma_chain(((a, b),), c)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA:CPU's ``sqrt``
    gives it: the root taken in float64 and rounded once (53 >= 2 * 24 + 2
    bits, so the double rounding is innocuous); torch's vectorized float32
    ``sqrt`` on an AVX-512 CPU misses it on about 0.6% of inputs."""
    return torch.sqrt(x.double()).to(torch.float32)


INT32_MAX = 2**31 - 1


def int32_like_xla(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA's ``convert`` gives it, on every device:
    truncated toward zero, saturated at the int32 range, NaN to 0.  (x86's
    conversion, which PyTorch's CPU kernels use, gives INT32_MIN for every
    value out of range and for NaN; the card's saturates as XLA does.)"""
    out = torch.clamp(v, -(2.0**31), 2147483520.0).to(torch.int32)  # the float32 below 2^31
    out = torch.where(v >= 2.0**31, INT32_MAX, out)
    return torch.where(torch.isnan(v), 0, out)


def sum_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(p * p, axis=-1)`` over (x, y, z) as XLA:CPU evaluates it:
    the reduction's chain ``fma(z, z, fma(y, y, x * x))``."""
    return fma_chain(((x, x), (y, y), (z, z)))


def dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """The written-out ``ax*bx + ay*by + az*bz`` as XLA:CPU evaluates it: the
    first product fused into the first add, the third into the second,
    ``fma(az, bz, fma(ax, bx, ay * by))`` (the distance kernels' cross term
    and RANSAC's plane distance)."""
    return fma_chain(((ay, by), (ax, bx), (az, bz)))


def add_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The written-out ``x*x + y*y + z*z`` as XLA:CPU evaluates it,
    ``fma(z, z, fma(x, x, y * y))``."""
    return dot3(x, y, z, x, y, z)


XLA_REDUCE_WINDOW = 32  # XLA:CPU's TreeReductionRewriter window


def sum_like_xla_plain(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of ``sum_like_xla``: one PyTorch add a step."""
    w = XLA_REDUCE_WINDOW
    if b is not None and a.shape[-1] <= w:  # the product fused into the plain reduce's adds
        a, b = a[..., :, None, :], b[..., None, :, :]
        acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1], dtype=a.dtype,
                          device=a.device)
        for k in range(a.shape[-1]):
            acc = fma(a[..., k], b[..., k], acc)
        return acc
    x = a if b is None else a[..., :, None, :] * b[..., None, :, :]
    while x.shape[-1] > w:
        pad = -x.shape[-1] % w
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, w)
        acc = torch.zeros_like(x[..., 0])
        for k in range(w):
            acc = acc + x[..., k]
        x = acc
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def sum_like_xla(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Float32 sum over the last axis in XLA:CPU's order for ``jnp.sum``.

    XLA:CPU's tree-reduction rewrite turns a reduction longer than 32 into
    a reduce-window of 32 (stride 32, the input padded with zeros, half
    the padding in front: ``pad // 2`` low, the rest high), repeated until
    32 or fewer values remain, then a plain reduce; each window and the
    last reduce add their values one after another from 0.  This replays
    that order (``tests/test_torch_outliers.py`` holds it bitwise to
    ``jnp.sum``).

    ``a`` [..., S, N] gives [..., S] (and [N] a 0-d sum).  With ``b``
    [..., T, N] it sums the
    products ``a[..., s, :] * b[..., t, :]`` into [..., S, T], as XLA:CPU
    evaluates ``jnp.sum(p * q)``: above 32 values the product is a fusion
    of its own, rounded before the windows add it (RANSAC's covariance);
    up to 32 it is fused into the plain reduce's adds, ``acc = fma(p_k,
    q_k, acc)``."""
    return sum_like_xla_plain(a, b)
