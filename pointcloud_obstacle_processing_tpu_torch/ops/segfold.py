"""In-order segment fold (``csrc/segment_fold.cu`` and its plain version).

No TPU kernel stands behind it: it replays the order in which XLA:CPU
evaluates the reference's float32 scatter-adds, a sequential fold in input
order, for the dense-bin voxel engines (``scatter``, and ``mxu``, whose
one-hot products XLA:CPU sums exactly) and the 3-key fallback's segment
sums.  The callers sort their rows stably by destination first, so every
bin's rows form one run in input order; the kernel takes the sort's
permutation (``order``) and gathers the values itself, and takes the ``mxu``
engine's bf16 split terms (``bf16_terms``) into the same launch.

``segment_fold`` launches the kernel for CUDA tensors and takes
``segment_fold_plain`` only for CPU tensors.  The plain version is the
composition the callers made before the kernel took those steps in: the
gather, the split terms, ``index_add_`` a term, which on the CPU adds its
rows one after another in input order (``tests/test_torch_voxel_engines.py``
holds it to a sequential fold), and the terms' add.  CUDA's ``index_add_``
adds with atomics in an order that changes from run to run, so the card
never takes it.
"""

from __future__ import annotations

import math

import torch

from .. import _build

__all__ = ["segment_fold", "segment_fold_plain", "meets_contract", "MAX_CHANNELS"]

MAX_CHANNELS = 8  # the kernel's instantiations: 1 to 8 value rows


def _check(dest, vals, bins, order, bf16_terms, width) -> int:
    if vals.dim() < 2 or dest.shape != vals.shape[:-2] + vals.shape[-1:]:
        raise ValueError("segment_fold: dest [..., N] and vals [..., C, N] with the same "
                         "leading dims and N")
    if not 1 <= vals.shape[-2] <= MAX_CHANNELS:
        raise ValueError(f"segment_fold: 1 to {MAX_CHANNELS} value rows (got {vals.shape[-2]})")
    if bins < 1:
        raise ValueError(f"segment_fold: bins must be positive, got {bins}")
    if order is not None and order.shape != dest.shape:
        raise ValueError("segment_fold: order must have dest's shape [..., N]")
    if bf16_terms not in (0, 1, 2):
        raise ValueError(f"segment_fold: bf16_terms is 0, 1 or 2, got {bf16_terms}")
    width = bins if width is None else width
    if width < bins:
        raise ValueError(f"segment_fold: width {width} below bins {bins}")
    return width


def _split_terms(vals: torch.Tensor, bf16_terms: int) -> list[torch.Tensor]:
    """The values, or their bf16 split terms t0 = bf16(v), t1 = bf16(v - t0)."""
    if bf16_terms == 0:
        return [vals]
    terms = [vals.to(torch.bfloat16).to(torch.float32)]
    if bf16_terms == 2:
        terms.append((vals - terms[0]).to(torch.bfloat16).to(torch.float32))
    return terms


def meets_contract(dest: torch.Tensor, bins: int) -> bool:
    """Whether ``dest`` meets the kernel's contract: within each scan,
    mapped as d < 0 -> -1 and d >= bins -> bins, it is non-decreasing."""
    m = torch.clamp(dest.long(), -1, bins)
    return bool((m[..., 1:] >= m[..., :-1]).all())


def segment_fold_plain(dest: torch.Tensor, vals: torch.Tensor, bins: int,
                       order: torch.Tensor | None = None, bf16_terms: int = 0,
                       width: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: the values gathered by ``order``, split into
    ``bf16_terms`` terms, each term's rows ``index_add_``-ed in row order
    into zeroed bins (rows with a dest outside ``[0, bins)`` dropped), and
    the terms' sums added.  It refuses a ``dest`` that breaks the kernel's
    contract, as the kernel cannot fold it, so that a CPU run of any caller
    checks the contract."""
    width = _check(dest, vals, bins, order, bf16_terms, width)
    if not meets_contract(dest, bins):
        raise ValueError("segment_fold: dest must be non-decreasing within each scan once "
                         "mapped as d < 0 -> -1, d >= bins -> bins (a stably sorted key)")
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    if order is not None:
        vals = vals.gather(-1, order[..., None, :].expand(*lead, c, n))
    scans = math.prod(lead)
    keep = (dest >= 0) & (dest < bins)
    # bin d of scan b at b * (width + 1) + d; width: the drop bin
    base = torch.arange(scans, device=dest.device).reshape(*lead, 1) * (width + 1)
    idx = (torch.where(keep, dest.long(), width) + base).reshape(-1)
    acc = None
    for t in _split_terms(vals, bf16_terms):
        flat = torch.zeros(scans * (width + 1), c, dtype=torch.float32, device=vals.device)
        flat.index_add_(0, idx, t.transpose(-1, -2).reshape(-1, c))
        part = flat.reshape(*lead, width + 1, c)[..., :width, :].transpose(-1, -2)
        acc = part if acc is None else acc + part
    return acc.contiguous()


def segment_fold(dest: torch.Tensor, vals: torch.Tensor, bins: int,
                 order: torch.Tensor | None = None, bf16_terms: int = 0,
                 width: int | None = None) -> torch.Tensor:
    """``out[..., c, d]``: the float32 fold, from +0.0 and in row order, of
    row i's value over each scan's rows i with ``dest[..., i] == d``.

    ``dest``: [..., N] int32 that meets the contract (``meets_contract``):
    within each scan, mapped as d < 0 -> -1 and d >= ``bins`` -> ``bins``, it
    is non-decreasing, as a stably sorted key is; rows mapped to -1 or
    ``bins`` are dropped.  The plain version (CPU tensors) raises where
    ``dest`` breaks it; the kernel does not check, since that would wait
    for the card, and folds such a ``dest`` wrongly.  ``vals``: [..., C, N] float32, 1 <= C <= 8, any
    strides (a [..., N, C] buffer's transpose is read as it lies).
    ``order``: None, or [..., N] int64, the stable sort's permutation: row i
    then takes ``vals[..., c, order[..., i]]``.  ``bf16_terms``: 0 folds the
    values; 1 folds t0 = bf16(v); 2 folds t0 and t1 = bf16(v - t0) apart and
    adds the two folds, the ``mxu`` engine's ``part_t0 + part_t1``.
    ``width`` (default ``bins``): the output's bins, those at or past
    ``bins`` +0.0.  Returns [..., C, width] float32.  On the card: one
    allocation and one launch for every scan of the batch, which writes
    every output element once."""
    if vals.device.type == "cpu":
        return segment_fold_plain(dest, vals, bins, order, bf16_terms, width)
    width = _check(dest, vals, bins, order, bf16_terms, width)
    dest = dest.contiguous()
    ops = [dest] if order is None else [dest, order.contiguous()]
    _build.require_cuda("segment_fold", *ops, dtypes=(torch.int32, torch.int64))
    if vals.dtype != torch.float32 or vals.get_device() != dest.get_device():
        raise TypeError("segment_fold: vals must be float32 on dest's CUDA device")
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    scans = math.prod(lead)
    v = vals.reshape(scans, c, n)  # a view where the strides allow it
    out = torch.empty(*lead, c, width, dtype=torch.float32, device=vals.device)
    err = _build.kernels().pcp_segment_fold(
        dest.data_ptr(), v.data_ptr(), 0 if order is None else ops[1].data_ptr(), scans, n, c,
        bins, width, v.stride(0), v.stride(1), v.stride(2), bf16_terms, out.data_ptr(),
        _build.stream_handle())
    _build.check(err, "segment_fold")
    _build.LAUNCHES["segment_fold"] += 1
    return out
