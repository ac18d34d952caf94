"""Segmented inclusive sum-scan in a fixed step order (kernel K6).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/segscan.py``: an
inclusive sum-scan along the last axis that restarts at segment heads,
summed in the explicit Hillis-Steele step order of the reference's
``_scan_steps``, so the result is bitwise the same on every device.  Step d
(d = 1, 2, 4, ... < N) computes

    v'[i] = v[i] + (f[i] ? 0.0 : v[i - d])      f'[i] = f[i] | f[i - d]

where a source before the start contributes 0.0 and flag 1.  Only adds and
selects: nothing to contract.  Where the flag is set the step still adds
+0.0, so an input -0.0 comes out +0.0, as in the reference.

``segmented_inclusive_scan`` launches kernel K6 (``csrc/segscan.cu``) for
CUDA tensors and takes ``segmented_inclusive_scan_plain`` only for CPU
tensors.  K6 runs the steps d < ``HALO`` in one launch, a block per
``TILE`` outputs of a channel, and the later steps, which join only
elements of one residue modulo ``HALO``, in a second launch that returns at
once where no segment reaches further back than ``HALO``.  Past 2^24
values a row, where one residue's sequence no longer fits a block's shared
memory, the later steps run one launch a step in global memory.  The
reference's kernel runs only on the TPU, for N % 128 == 0 and a block that
fits its VMEM; those are limits of the TPU.  This function takes any N >= 1
on the CPU and on the card.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["segmented_inclusive_scan", "segmented_inclusive_scan_plain", "scan_steps"]

HALO = 1024  # K6's in-block steps are d < HALO (kHalo in csrc/segscan.cu)
TILE = 4096  # outputs a block of K6's in-block steps (kTile)


def scan_steps(n: int) -> list[int]:
    """The shift of each step for a row of ``n`` values: 1, 2, 4, ... < n."""
    out, d = [], 1
    while d < n:
        out.append(d)
        d *= 2
    return out


def _as_channels(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1] if values.dim() else 0
    if values.dim() == 0 or heads.shape != (n,):
        raise ValueError(f"segmented_inclusive_scan: values [..., N] and heads [N] "
                         f"(got {tuple(values.shape)} and {tuple(heads.shape)})")
    if values.dtype != torch.float32:
        raise TypeError(f"segmented_inclusive_scan: values must be float32, got {values.dtype}")
    return values.reshape(-1, n)


def segmented_inclusive_scan_plain(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K6: the reference's step sequence,
    each step computed from the previous step's tensors."""
    v = _as_channels(values, heads)
    f = heads.to(torch.bool)
    for d in scan_steps(v.shape[1]):
        v_shift = torch.nn.functional.pad(v[:, :-d], (d, 0))
        f_shift = torch.nn.functional.pad(f[:-d], (d, 0), value=True)
        v = v + torch.where(f, 0.0, v_shift)
        f = f | f_shift
    return v.reshape(values.shape)


def segmented_inclusive_scan(values: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Inclusive sum-scan along the last axis, restarting at segment heads.

    ``values``: [C, N] or [..., N] float32 (leading dims are channels);
    ``heads``: [N] bool, True where a segment begins, shared by every
    channel.  Rows before the first head form an implicit leading segment.
    Returns a tensor of ``values``' shape; bitwise equal to the reference's
    ``segmented_inclusive_scan`` on the same inputs."""
    if values.device.type == "cpu":
        return segmented_inclusive_scan_plain(values, heads)
    v = _as_channels(values, heads).contiguous()
    c, n = v.shape
    _build.require_cuda("segmented_inclusive_scan", v, heads, dtypes=[torch.float32, torch.bool])
    if v.numel() == 0:
        return values.clone()
    lib = _build.kernels()
    out = torch.empty_like(v)
    # the values and flags of tiles with a live element (flags twice, for
    # the steps in global memory of rows past 2^24 values), the tiles' live
    # flags and the -0.0 bits of the flagged values
    scratch = torch.empty_like(v) if n > HALO else out
    flags = torch.empty(2 * n, dtype=torch.uint8, device=v.device)
    ints = torch.empty(-(-n // TILE) + c * -(-n // 32), dtype=torch.int32, device=v.device)
    err = lib.pcp_segscan(v.data_ptr(), heads.data_ptr(), c, n, out.data_ptr(),
                          scratch.data_ptr(), flags.data_ptr(), ints.data_ptr(),
                          _build.stream_handle())
    _build.check(err, "segscan")
    _build.LAUNCHES["segscan"] += 1
    return out.reshape(values.shape)
