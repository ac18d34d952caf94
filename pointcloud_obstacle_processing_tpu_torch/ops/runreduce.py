"""Sorted-run segmented reduce + compaction (kernel K1 and its plain version).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/pallas_runreduce.py``.
For each run of equal keys in a key-sorted buffer it returns (key as f32,
sum_x, sum_y, sum_z, count) compacted to the first ``capacity`` slots in key
order, plus the run count.  The bits are the reference's ``_xla_fallback``:
windows of ``group * 128`` rows (``group`` depends on N only), a
Hillis-Steele shift+add scan in each window, then one carry add for each
row before the window's first head, the carries chained window after window.

``sorted_run_reduce`` launches the CUDA kernel (``csrc/runreduce.cu``) for
CUDA tensors and takes ``sorted_run_reduce_plain`` only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import f32
from .. import _build
from .histogram import compact_occupied_blocks

__all__ = ["sorted_run_reduce", "sorted_run_reduce_plain", "default_group", "unpack_offsets"]


def default_group(n: int) -> int:
    """Window width in 128-row blocks: a function of N only (as the
    reference's ``sorted_run_reduce`` derives it)."""
    if n % 128:
        raise ValueError(f"N={n} must be a multiple of 128")
    pref = 8 if n // 128 <= 4096 else 32
    return next(g for g in (pref, 8, 4, 2, 1) if n % (g * 128) == 0)


def unpack_offsets(pxy: torch.Tensor, pz: torch.Tensor, quantum: float):
    """16-bit fixed-point payload decode.  ``>>`` on int32 is arithmetic in
    torch, so the high half is masked after the shift (a logical shift)."""
    q = f32(quantum)
    ox = ((pxy >> 16) & 0xFFFF).to(torch.float32) * q
    oy = (pxy & 0xFFFF).to(torch.float32) * q
    oz = pz.to(torch.float32) * q
    return ox, oy, oz


def _scan_channels(vals: torch.Tensor, flags: torch.Tensor, w: int) -> torch.Tensor:
    """Window-local segmented inclusive scan over the last axis: the
    reference's exact shift+add steps (``_scan_channels``)."""
    v, f = vals, flags
    d = 1
    while d < w:
        v_shift = torch.nn.functional.pad(v[..., :-d], (d, 0), value=0.0)
        f_shift = torch.nn.functional.pad(f[..., :-d], (d, 0), value=1)
        v = v + torch.where(f != 0, torch.zeros_like(v), v_shift)
        f = f | f_shift
        d *= 2
    return v


def _flags(skey: torch.Tensor, sentinel: int):
    valid = skey < sentinel
    prev = torch.nn.functional.pad(skey[:-1], (1, 0), value=-1)
    nxt = torch.nn.functional.pad(skey[1:], (0, 1), value=-2)
    return valid, valid & (skey != prev), valid & (skey != nxt)


def _decode(offs, quantum):
    if quantum is not None:
        if len(offs) != 2:
            raise ValueError("quantum set: offs must be the (pxy, pz) int32 pair")
        return unpack_offsets(offs[0], offs[1], quantum)
    if len(offs) != 3:
        raise ValueError("offs must be three float32 offset buffers")
    return tuple(offs)


def sorted_run_reduce_plain(skey, offs, sentinel: int, capacity: int, group: int | None = None,
                            quantum: float | None = None):
    """Plain PyTorch version of kernel K1, bitwise equal to the reference's
    ``_xla_fallback``."""
    n = skey.shape[0]
    group = group or default_group(n)
    w = group * 128
    steps = n // w
    ox, oy, oz = _decode(offs, quantum)
    valid, heads, is_end = _flags(skey, sentinel)
    hw = heads.to(torch.int32).reshape(steps, w)
    ch = torch.stack(
        [ox.reshape(steps, w), oy.reshape(steps, w), oz.reshape(steps, w),
         valid.to(torch.float32).reshape(steps, w)]
    )  # [4, steps, w]
    local = _scan_channels(ch, hw, w)
    no_head_yet = torch.cumsum(hw, dim=1) == 0  # [steps, w]

    lastcol = local[:, :, -1]  # [4, steps]
    gate = no_head_yet[:, -1]
    carries = torch.empty(4, steps, dtype=torch.float32, device=skey.device)
    c = torch.zeros(4, dtype=torch.float32, device=skey.device)
    for t in range(steps):  # the sequential carry chain
        carries[:, t] = c
        c = lastcol[:, t] + torch.where(gate[t], c, torch.zeros_like(c))
    adj = (local + torch.where(no_head_yet, carries[:, :, None], torch.zeros_like(local)))
    adj = adj.reshape(4, n)

    loc, num = compact_occupied_blocks(is_end, capacity)
    loc = loc.long()
    cnt_end = torch.where(is_end, adj[3], torch.zeros_like(adj[3]))
    vals = torch.stack(
        [skey.to(torch.float32)[loc], adj[0][loc], adj[1][loc], adj[2][loc], cnt_end[loc]], dim=-1
    )
    return vals, num


def sorted_run_reduce(skey, offs, sentinel: int, capacity: int, group: int | None = None,
                      quantum: float | None = None):
    """Per-run (key, sum_x, sum_y, sum_z, count) of a key-sorted buffer,
    compacted to the first ``capacity`` runs in ascending key order.

    ``skey``: [N] int32 ascending, ``sentinel`` for invalid rows.  ``offs``:
    three [N] float32 offsets, or with ``quantum`` the (pxy, pz) int32 pair
    of 16-bit fixed-point offsets.  Returns (vals [capacity, 5] f32, num []
    int32); slots at or past ``num`` are unspecified.
    """
    n = skey.shape[0]
    group = group or default_group(n)
    w = group * 128
    if n % w:
        raise ValueError(f"N={n} must be a multiple of group*128={w}")
    if skey.device.type == "cpu":
        return sorted_run_reduce_plain(skey, offs, sentinel, capacity, group, quantum)

    offs = tuple(offs)
    pay_dtype = torch.int32 if quantum is not None else torch.float32
    if len(offs) != (2 if quantum is not None else 3):
        raise ValueError("offs must be (pxy, pz) with quantum, else three float32 buffers")
    _build.require_cuda("sorted_run_reduce", skey, *offs,
                        dtypes=[torch.int32] + [pay_dtype] * len(offs))
    if any(o.shape != skey.shape for o in offs):
        raise ValueError("sorted_run_reduce: payloads must match the key shape")
    if w > 4096:
        raise ValueError(f"sorted_run_reduce: window {w} exceeds the kernel's 4096 rows")
    lib = _build.kernels()
    steps = n // w
    dev = skey.device
    _, _, is_end = _flags(skey, sentinel)
    per_block = is_end.reshape(n // 128, 128).sum(dim=1, dtype=torch.int32)
    offsets = torch.cumsum(per_block, dim=0, dtype=torch.int32)
    num = offsets[-1]
    excl = (offsets - per_block).contiguous()
    local = torch.empty(4, n, dtype=torch.float32, device=dev)
    lastcol = torch.empty(steps, 4, dtype=torch.float32, device=dev)
    first_head = torch.empty(steps, dtype=torch.int32, device=dev)
    carry = torch.empty(steps, 4, dtype=torch.float32, device=dev)
    vals = torch.zeros(capacity, 5, dtype=torch.float32, device=dev)
    packed = quantum is not None
    err = lib.pcp_runreduce(
        skey.data_ptr(), offs[0].data_ptr(), offs[1].data_ptr(),
        None if packed else offs[2].data_ptr(), int(packed),
        float(np.float32(quantum)) if packed else 0.0, n, w, sentinel, excl.data_ptr(),
        capacity, local.data_ptr(), lastcol.data_ptr(), first_head.data_ptr(),
        carry.data_ptr(), vals.data_ptr(), _build.stream_handle(),
    )
    _build.check(err, "runreduce")
    _build.LAUNCHES["runreduce"] += 1
    return vals, num
