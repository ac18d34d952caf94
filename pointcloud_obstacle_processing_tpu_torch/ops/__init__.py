"""Device-side compute stages of the port (mirrors the reference's ``ops``)."""

import numpy as np
import torch


def f32(value: float) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d CPU tensor.

    The reference's Python constants enter float32 arithmetic rounded to
    float32; this makes that rounding explicit.  PyTorch takes a 0-d CPU
    tensor as an operand of a CUDA operation without copying it to the
    device, so, unlike ``torch.tensor(v, device="cuda")``, it never waits
    for the stream.
    """
    return torch.tensor(np.float32(value))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding.

    XLA:CPU contracts a multiply that feeds an add into a fused
    multiply-add, so the reference evaluates many of its float32 sums of
    products this way; the port writes out each such chain where a decision
    or a bitwise result depends on it.  The float64 product of two float32
    values is exact and the float64 sum rounds only when the addends lie
    far apart in magnitude, so rounding the sum to float32 once gives the
    fused result except in rare double-rounding ties.  The same float64
    operations run on every device, so the CPU and the card agree bit for
    bit."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device, as
    XLA:CPU's ``sqrt`` gives it.  On the card that is ``torch.sqrt`` itself
    (IEEE round-to-nearest; ``tests/test_torch_cuda.py::
    test_card_sqrt_is_the_float64_root`` holds it bitwise to the float64
    form).  On the CPU the root is taken in float64 and rounded
    once (53 >= 2 * 24 + 2 bits, so the double rounding is innocuous):
    torch's vectorized float32 ``sqrt`` on an AVX-512 CPU misses it on about
    0.6% of inputs."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(torch.float32)


def sum_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(p * p, axis=-1)`` over (x, y, z) as XLA:CPU evaluates it:
    the reduction's chain ``fma(z, z, fma(y, y, x * x))``."""
    return fma(z, z, fma(y, y, x * x))


def dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """The written-out ``ax*bx + ay*by + az*bz`` as XLA:CPU evaluates it: the
    first product fused into the first add, the third into the second,
    ``fma(az, bz, fma(ax, bx, ay * by))`` (the distance kernels' cross term
    and RANSAC's plane distance)."""
    return fma(az, bz, fma(ax, bx, ay * by))


def add_sq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The written-out ``x*x + y*y + z*z`` as XLA:CPU evaluates it,
    ``fma(z, z, fma(x, x, y * y))``."""
    return dot3(x, y, z, x, y, z)


XLA_REDUCE_WINDOW = 32  # XLA:CPU's TreeReductionRewriter window


def sum_like_xla(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in XLA:CPU's order for ``jnp.sum``.

    XLA:CPU's tree-reduction rewrite turns a reduction longer than 32 into
    a reduce-window of 32 (stride 32, the input padded with zeros, half
    the padding in front: ``pad // 2`` low, the rest high), repeated until
    32 or fewer values remain, then a plain reduce; each window and the
    last reduce add their values one after another from 0.  This replays
    that order (``tests/test_torch_outliers.py`` holds it bitwise to
    ``jnp.sum``), with one PyTorch add a step on every device."""
    w = XLA_REDUCE_WINDOW
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
