"""In-order segment fold (``csrc/segment_fold.cu`` and its plain version).

No TPU kernel stands behind it: it replays the order in which XLA:CPU
evaluates the reference's float32 scatter-adds, a sequential fold in input
order, for the dense-bin voxel engines (``scatter``, and ``mxu``, whose
one-hot products XLA:CPU sums exactly) and the 3-key fallback's segment
sums.  The callers sort their rows stably by destination first, so every
bin's rows form one run in input order.

``segment_fold`` launches the kernel for CUDA tensors and takes
``segment_fold_plain`` only for CPU tensors.  The plain version is
``index_add_``, which on the CPU adds its rows one after another in input
order (``tests/test_torch_voxel_engines.py`` holds it to a sequential
fold); CUDA's ``index_add_`` adds with atomics in an order that changes
from run to run, so the card never takes it.
"""

from __future__ import annotations

import math

import torch

from .. import _build

__all__ = ["segment_fold", "segment_fold_plain", "MAX_CHANNELS"]

MAX_CHANNELS = 8  # the kernel's instantiations: 1 to 8 value rows
_DTYPES = (torch.int32, torch.float32)  # dest, vals


def _check(dest: torch.Tensor, vals: torch.Tensor, bins: int) -> None:
    if vals.dim() < 2 or dest.shape != vals.shape[:-2] + vals.shape[-1:]:
        raise ValueError("segment_fold: dest [..., N] and vals [..., C, N] with the same "
                         "leading dims and N")
    if not 1 <= vals.shape[-2] <= MAX_CHANNELS:
        raise ValueError(f"segment_fold: 1 to {MAX_CHANNELS} value rows (got {vals.shape[-2]})")
    if bins < 1:
        raise ValueError(f"segment_fold: bins must be positive, got {bins}")


def segment_fold_plain(dest: torch.Tensor, vals: torch.Tensor, bins: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of each scan's rows in input
    order into ``bins`` zeroed bins, rows with a dest outside ``[0, bins)``
    dropped."""
    _check(dest, vals, bins)
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    scans = math.prod(lead)
    keep = (dest >= 0) & (dest < bins)
    # bin d of scan b at b * (bins + 1) + d; bins: the drop bin
    base = torch.arange(scans, device=dest.device).reshape(*lead, 1) * (bins + 1)
    idx = torch.where(keep, dest.long(), bins) + base
    flat = torch.zeros(scans * (bins + 1), c, dtype=torch.float32, device=vals.device)
    flat.index_add_(0, idx.reshape(-1), vals.transpose(-1, -2).reshape(-1, c))
    return flat.reshape(*lead, bins + 1, c)[..., :bins, :].transpose(-1, -2).contiguous()


def segment_fold(dest: torch.Tensor, vals: torch.Tensor, bins: int) -> torch.Tensor:
    """``out[..., c, d]``: the float32 fold, from +0.0 and in row order, of
    ``vals[..., c, i]`` over each scan's rows i with ``dest[..., i] == d``.

    ``dest``: [..., N] int32, each destination's rows contiguous within a
    scan (a stable sort by destination gives that); rows with a dest
    outside ``[0, bins)`` are dropped.  ``vals``: [..., C, N] float32, 1
    <= C <= 8.  Returns [..., C, bins] float32.  On the card: one
    allocation and one C call (a memset of the output, then one launch for
    every scan of the batch)."""
    if vals.device.type == "cpu":
        return segment_fold_plain(dest, vals, bins)
    _check(dest, vals, bins)
    dest = dest.contiguous()
    vals = vals.contiguous()
    _build.require_cuda("segment_fold", dest, vals, dtypes=_DTYPES)
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    out = torch.empty(*lead, c, bins, dtype=torch.float32, device=vals.device)
    scans = math.prod(lead)
    err = _build.kernels().pcp_segment_fold(dest.data_ptr(), vals.data_ptr(), scans, n, c, bins,
                                            out.data_ptr(), _build.stream_handle())
    _build.check(err, "segment_fold")
    _build.LAUNCHES["segment_fold"] += 1
    return out
