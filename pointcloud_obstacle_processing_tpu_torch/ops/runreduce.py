"""Sorted-run segmented reduce + compaction (kernel K1 and its plain version).

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/pallas_runreduce.py``.
For each run of equal keys in a key-sorted buffer it returns (key as f32,
sum_x, sum_y, sum_z, count) compacted to the first ``capacity`` slots in key
order, plus the run count.  The bits are the reference's ``_xla_fallback``:
windows of ``group * 128`` rows (``group`` depends on N only), a
Hillis-Steele shift+add scan in each window, then one carry add for each
row before the window's first head, the carries chained window after window.

Both take one buffer ``[N]`` or a batch ``[B, N]`` of them, each reduced on
its own (the kernel takes the scan as a grid dimension).  In counts mode (a
fourth float32 buffer of per-row counts, the voxel-table merges' input) the
count channel sums those counts in place of an implicit 1 a row, in the
same order as the other channels.
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
    prev = torch.nn.functional.pad(skey[..., :-1], (1, 0), value=-1)
    nxt = torch.nn.functional.pad(skey[..., 1:], (0, 1), value=-2)
    return valid, valid & (skey != prev), valid & (skey != nxt)


def _decode(offs, quantum):
    """(x, y, z, counts or None): the payloads as float32 channels."""
    if quantum is not None:
        if len(offs) != 2:
            raise ValueError("quantum set: offs must be the (pxy, pz) int32 pair")
        return (*unpack_offsets(offs[0], offs[1], quantum), None)
    if len(offs) not in (3, 4):
        raise ValueError("offs must be three float32 offset buffers, or four (the fourth "
                         "the per-row counts)")
    return (*offs[:3], offs[3] if len(offs) == 4 else None)


def sorted_run_reduce_plain(skey, offs, sentinel: int, capacity: int, group: int | None = None,
                            quantum: float | None = None):
    """Plain PyTorch version of kernel K1, bitwise equal to the reference's
    ``_xla_fallback``, each scan of a batch on its own."""
    n = skey.shape[-1]
    lead = skey.shape[:-1]
    group = group or default_group(n)
    w = group * 128
    steps = n // w
    ox, oy, oz, counts = _decode(offs, quantum)
    valid, heads, is_end = _flags(skey, sentinel)
    hw = heads.to(torch.int32).reshape(*lead, steps, w)
    cnt = valid.to(torch.float32) if counts is None else torch.where(valid, counts, 0.0)
    ch = torch.stack(
        [c.reshape(*lead, steps, w) for c in (ox, oy, oz, cnt)]
    )  # [4, *lead, steps, w]
    local = _scan_channels(ch, hw, w)
    no_head_yet = torch.cumsum(hw, dim=-1) == 0  # [*lead, steps, w]

    lastcol = local[..., -1]  # [4, *lead, steps]
    gate = no_head_yet[..., -1]
    carries = torch.empty_like(lastcol)
    c = torch.zeros_like(lastcol[..., 0])
    for t in range(steps):  # the sequential carry chain
        carries[..., t] = c
        c = lastcol[..., t] + torch.where(gate[..., t], c, torch.zeros_like(c))
    adj = (local + torch.where(no_head_yet, carries[..., None], torch.zeros_like(local)))
    adj = adj.reshape(4, *lead, n)

    loc, num = compact_occupied_blocks(is_end, capacity, scan_dims=len(lead))
    loc = loc.long()
    cnt_end = torch.where(is_end, adj[3], torch.zeros_like(adj[3]))
    cols = (skey.to(torch.float32), adj[0], adj[1], adj[2], cnt_end)
    vals = torch.stack([c.gather(-1, loc) for c in cols], dim=-1)
    return vals, num


def sorted_run_reduce(skey, offs, sentinel: int, capacity: int, group: int | None = None,
                      quantum: float | None = None):
    """Per-run (key, sum_x, sum_y, sum_z, count) of a key-sorted buffer,
    compacted to the first ``capacity`` runs in ascending key order.

    ``skey``: [N] (or [B, N], one buffer a scan) int32 ascending,
    ``sentinel`` for invalid rows.  ``offs``: three float32 offset buffers
    of ``skey``'s shape, or with ``quantum`` the (pxy, pz) int32 pair of
    16-bit fixed-point offsets; or (without ``quantum``) four float32
    buffers, the fourth the per-row counts the count channel sums (counts
    mode; all-ones counts give the three-buffer result bit for bit).
    Returns (vals [..., capacity, 5] f32, num [...] int32); slots at or
    past ``num`` are unspecified.  One launch a call, the batch included.
    """
    n = skey.shape[-1]
    lead = skey.shape[:-1]
    group = group or default_group(n)
    w = group * 128
    if n % w:
        raise ValueError(f"N={n} must be a multiple of group*128={w}")
    if skey.device.type == "cpu":
        return sorted_run_reduce_plain(skey, offs, sentinel, capacity, group, quantum)

    offs = tuple(offs)
    with _build.launch("runreduce_counts" if len(offs) == 4 else "runreduce"):
        pay_dtype = torch.int32 if quantum is not None else torch.float32
        if len(offs) not in ((2,) if quantum is not None else (3, 4)):
            raise ValueError("offs must be (pxy, pz) with quantum, else three float32 buffers "
                             "(or four: the fourth the per-row counts)")
        _build.require_cuda("sorted_run_reduce", skey, *offs,
                            dtypes=[torch.int32] + [pay_dtype] * len(offs))
        if any(o.shape != skey.shape for o in offs):
            raise ValueError("sorted_run_reduce: payloads must match the key shape")
        if w > 4096:
            raise ValueError(f"sorted_run_reduce: window {w} exceeds the kernel's 4096 rows")
        lib = _build.kernels()
        dev = skey.device
        batch = skey[..., 0].numel()
        vals = torch.empty(*lead, capacity, 5, dtype=torch.float32, device=dev)
        num = torch.empty(lead, dtype=torch.int32, device=dev)
        # the kernel's look-back workspace (csrc/runreduce.cu), cleared by the call
        workspace = torch.empty(batch * (n // w) * 44 + 16, dtype=torch.uint8, device=dev)
        packed = quantum is not None
        counts = len(offs) == 4
        err = lib.pcp_runreduce(
            skey.data_ptr(), offs[0].data_ptr(), offs[1].data_ptr(),
            None if packed else offs[2].data_ptr(), offs[3].data_ptr() if counts else None,
            int(packed), float(np.float32(quantum)) if packed else 0.0, batch, n, w, sentinel,
            capacity, workspace.data_ptr(), vals.data_ptr(), num.data_ptr(), _build.stream_handle(),
        )
        _build.check(err, "runreduce")
    return vals, num
