"""Weighted point binning (kernel K7).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/pallas_binning.py``,
the reference's parked experiment: ``sums[j, c]`` is the sum of
``weights[i, c]`` over the valid rows i with ``ids[i] == j``, each weight
taken as the reference's MXU product takes it: ``hi = bf16(w)`` and, with
``exact_f32``, ``lo = bf16(w - hi)``, each widened to float32 and summed in
float32.  A valid row whose id lies outside ``[0, k)`` adds nothing.

``binned_weighted_sum`` launches kernel K7 (``csrc/binning.cu``) for CUDA
tensors and takes ``binned_weighted_sum_plain`` only for CPU tensors.  Both
add in an unspecified order (atomics, and ``index_add_``), as the
reference's MXU does: counts (unit weights) are exact up to 2^24 members a
bin, sums equal any other order's within the float32 reordering bound.
Weights are finite: the reference's one-hot product spreads a non-finite
weight over other bins, which is not part of this function.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["binned_weighted_sum", "binned_weighted_sum_plain", "weight_terms", "reordering_bound"]

_DTYPES = (torch.int32, torch.float32, torch.bool)  # ids, weights, valid for kernel K7


def weight_terms(weights: torch.Tensor, exact_f32: bool) -> list[torch.Tensor]:
    """The float32 terms each weight contributes: [hi] or [hi, lo]."""
    hi = weights.to(torch.bfloat16).to(torch.float32)
    if not exact_f32:
        return [hi]
    return [hi, (weights - hi).to(torch.bfloat16).to(torch.float32)]


def _kept(ids, valid, k: int):
    """Rows that add to a bin (valid, id in [0, k)) and their bins."""
    ids = ids.to(torch.int32)  # as the reference casts them
    keep = valid & (ids >= 0) & (ids < k)
    return keep, ids[keep].long()


def reordering_bound(ids, weights, valid, k: int, exact_f32: bool = True) -> torch.Tensor:
    """[k, C] float64: how far two float32 sums of each bin's terms, added in
    different orders, may lie apart.  Summed in any order, n float32 terms
    land within (n - 1) * 2^-24 * S of their exact sum, S the sum of their
    magnitudes (recursive summation, first order), so two orders of a
    bin's n_j terms agree within 2 * n_j * 2^-24 * S_j."""
    keep, rows = _kept(ids, valid, k)
    mag = torch.zeros(k, weights.shape[1], dtype=torch.float64, device=weights.device)
    cnt = torch.zeros(k, dtype=torch.float64, device=weights.device)
    for term in weight_terms(weights.to(torch.float32), exact_f32):
        mag.index_add_(0, rows, term[keep].abs().double())
        cnt.index_add_(0, rows, torch.ones(len(rows), dtype=torch.float64, device=weights.device))
    return 2.0 * cnt[:, None] * 2.0**-24 * mag


def _check(ids, weights, valid, k: int, chunk: int):
    n = weights.shape[0]
    if weights.dim() != 2 or ids.shape != (n,) or valid.shape != (n,):
        raise ValueError("binned_weighted_sum: ids [N], weights [N, C] and valid [N]")
    if n % chunk:
        raise ValueError(f"N={n} not divisible by chunk={chunk}")
    if k < 1:
        raise ValueError(f"binned_weighted_sum: k must be positive, got {k}")


def binned_weighted_sum_plain(ids, weights, valid, k: int, hi_size: int = 128,
                              chunk: int = 1024, exact_f32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel K7: ``index_add_`` of the same terms."""
    _check(ids, weights, valid, k, chunk)
    keep, rows = _kept(ids, valid, k)
    out = torch.zeros(k, weights.shape[1], dtype=torch.float32, device=weights.device)
    for term in weight_terms(weights.to(torch.float32), exact_f32):
        out.index_add_(0, rows, term[keep])
    return out


def binned_weighted_sum(ids, weights, valid, k: int, hi_size: int = 128, chunk: int = 1024,
                        exact_f32: bool = True) -> torch.Tensor:
    """``sums[j, c] = sum over valid i with ids[i] == j of weights[i, c]``, as
    [k, C] float32 (the reference's signature).

    ``ids``: [N] integer bin ids, cast to int32 as the reference does;
    ``weights``: [N, C] float32; ``valid``: [N] bool.  N must divide by
    ``chunk`` (the reference's ValueError).  ``hi_size`` and ``chunk`` fix
    only the reference's TPU layout and change nothing here."""
    if weights.device.type == "cpu":
        return binned_weighted_sum_plain(ids, weights, valid, k, hi_size, chunk, exact_f32)
    with _build.launch("binned_sum") as launch:
        _check(ids, weights, valid, k, chunk)
        n, c = weights.shape
        if ids.dtype != torch.int32 or not ids.is_contiguous():
            ids = ids.to(torch.int32).contiguous()  # as the reference casts them
        _build.require_cuda("binned_weighted_sum", ids, weights, valid, dtypes=_DTYPES)
        if n * c == 0:
            launch.skip()
            return torch.zeros(k, c, dtype=torch.float32, device=weights.device)
        # the C call zeroes ``out`` and launches on the same stream
        out = torch.empty(k, c, dtype=torch.float32, device=weights.device)
        err = _build.kernels().pcp_binned_sum(ids.data_ptr(), weights.data_ptr(), valid.data_ptr(),
                                              n, c, k, int(exact_f32), out.data_ptr(),
                                              _build.stream_handle())
        _build.check(err, "binned_sum")
    return out
