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
