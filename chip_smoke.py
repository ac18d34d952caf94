#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship scan, the
fullscale 2M-point window (banded, and with the band off), the flagship
batch of 32, and the segmented scan and weighted binning entry points.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):

1. Names the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s name
   and power limit) and builds the CUDA kernels from ``csrc/`` with nvcc.
2. Calls each kernel on seeded tensors on the card and holds it bitwise
   against its plain PyTorch version on the same inputs, then times both
   with CUDA events, and the wrapper and the library call also by device
   time alone (``torch.profiler``) and by host time alone (200 calls issued
   back to back on the host's clock): K1 run-reduce, K2 compaction, K3
   banded kNN mean (on x-sorted random points) and the cluster loop (K4's
   loop kernel: labels, ``unconverged`` and the sweeps run) at the flagship
   shapes; K1 (once more on runs that span windows), K2 and K3 at the
   fullscale shapes; K5 banded cluster sweep at the fullscale shape, once
   with every tile live and once with a seeded random ``tile_live``.  The
   cluster kernels take the points as the clustering lays them out once
   for all its sweeps (``pack_points``).
3. Flagship path: counts from 0, ``ObstacleDetectionModel(FLAGSHIP_CONFIG)``
   on the card over three seeded scenes; checks that K1-K3, the loop
   kernel, the sum kernel and RANSAC's 3x3 tail kernel were launched, that
   no overflow flag is set and that each rock of the scene is matched by a
   cluster, and compares each scan with the same scan through the plain
   versions on the CPU (same RANSAC draws): grid, stage counts and flags
   exact, centroids within 1e-5.  Times ``process_scan`` per scan (p50),
   counts its host syncs, which must be none, and its device operations
   (kernels, memsets, copies; ``torch.profiler``).  Then K3, the loop
   kernel, the sum kernel (every call of a scan) and the 3x3 tail (every
   call) again, checked and timed as in phase 2, on the inputs the scan of
   scene 0 gives them.
4. Fullscale path: counts from 0, one scan of the canonical fullscale
   window (``make_fullscale_window(2_097_152)``) through
   ``ObstacleDetectionModel(REFERENCE_FULLSCALE_CONFIG)`` on the card;
   checks that K1, K2, K3, K5 and the two refinement kernels were launched
   and that no overflow flag is set, and compares it with the same window
   through the plain versions on the CPU by the same bar.  Times a few
   scans (p50) and counts host syncs (all the banded loop's reads) and
   device operations; then K3 and the refinement kernels on the scan's
   own inputs, as in phase 3.
5. Fullscale with the band off (``cluster_band_window=0``): counts from 0,
   one scan of the same window; its 16,384-point cluster buffer takes the
   grid-wide loop kernel (one launch); it must equal phase 4's banded card
   run (whose band does not overflow): grid, counts, flags, centroids and
   every point's cluster; 0 host syncs for the whole scan; p50 over 5
   scans and device operations; then the grid-wide loop kernel on the
   scan's own clustering inputs against ``cluster_loop_plain``, and its
   device time a sweep beside the bound.
6. The full sweep above the loop kernel's capacity: counts from 0, one
   ``euclidean_cluster`` of a 10,240-point buffer with the band off on the
   card (one grid-wide loop launch) against the same call on the CPU, then
   the grid-wide loop kernel checked and timed at that capacity, and K4's
   per-sweep kernel (off every path) against ``sweep_jump_plain``.  Then
   the forms of the loop (the grid-wide loop kernel, the loop kernel where
   it fits, the per-sweep path above ``LOOP_MAX_CAPACITY``) on the same
   buffers from 1,024 to 16,384 points, each checked against
   ``cluster_loop_plain`` and timed (``loop crossover:`` lines).
7. The two entry points off the pipeline, each driven with the counts from
   0: ``segmented_inclusive_scan`` (K6) at [4, 131,072] (the reference's
   Pallas shape) and [4, 2,097,152] (the fullscale buffer) with heads from a
   sorted key buffer, and at [4, 2,097,152] with no head (one segment, the
   worst case), held against the plain version in bit patterns, with the
   launches a call; and ``binned_weighted_sum`` (K7) at N =
   131,072, k = 214,000, C = 4 (x, y, z weights and a unit count channel),
   90% valid, held against the plain version with counts exact and sums
   within the float32 reordering bound.  Times each with CUDA events beside
   its bound and, for K7, the library's ``index_add_``.  K6 also on one
   row past 2^24 values (its later steps in global memory), bitwise.
8. Batched flagship: counts from 0, one call of
   ``parallel.sharding.batched_pipeline(FLAGSHIP_CONFIG)`` on 32 scans (8
   scenes, seeds 0-7, tiled as ``bench.py`` tiles them) with a RANSAC draw
   of its own for each scan; checks that K1, K2, K3 and the loop kernel
   were each launched once for the batch, that no overflow flag is set,
   that each scan's rocks are matched and that each scan equals the
   single-scan card run of its scene with its draws (the crosscheck bar,
   and the cluster of every point exact); counts host syncs (none).  Times
   the batch call (p50, min and max over 10 batches after one warm-up;
   scans per second = 32 / p50) and prints its device operations, device
   time and busy share (``torch.profiler``) and peak device memory.  Then
   K1, K2, K3, the loop kernel and the two refinement kernels at B = 32 on
   the inputs the batch gives them, checked and timed as in phase 2 (path
   ``flagship_batch``), and the loop kernel with 1, 2, 4, 8 and 16 blocks
   a scan (``loop blocks:`` lines).

Each phase prints its seconds.
Its last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON list of kernels, one entry per kernel and path, with launches on
that path, errors, times and the bound.  There is no CPU fallback: without
a CUDA card the script raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "pointcloud_obstacle_processing_tpu_torch"
TPU = "pointcloud_obstacle_processing_tpu"
RANSAC_SEED = 5
SCENE_SEEDS = (0, 1, 2)
TIMED_SCANS = 20
FULLSCALE_POINTS = 2_097_152
FULLSCALE_TIMED_SCANS = 5
SEGSCAN_N = 131_072  # the reference's Pallas shape for the segmented scan
BINNING_N, BINNING_K = 131_072, 214_000  # the binning kernel's documented shape
CLUSTER_WIDE = 10240  # a full-sweep capacity above the loop kernel's (ops.cluster.LOOP_MAX_CAPACITY)
# capacities at which the forms of the loop are timed (with the largest the loop kernel fits)
LOOP_CROSSOVER = (1024, 2048, 3072, 4096, 6144, 8192, 10240, 16384)
BATCH = 32  # the flagship batch: bench.py's B, 8 distinct scenes tiled
BATCH_SCENES = 8
BATCH_TIMED = 10
LOOP_BLOCKS = (1, 2, 4, 8, 16)  # blocks a scan of the loop kernel timed on the batch

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes per second and float32 operations per second outside the tensor
# cores; bound_ms is the larger of bytes / HBM rate and operations / fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
D2_OPS = 9  # flops per scored pair: cross 1 mul + 2 fma; d2 add, mul, sub; the compare


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


PROFILER_SESSIONS = 5  # torch.profiler sessions tried before a device time is "not measured"


def _profiled_device_events(fn) -> list:
    """The device's kernels, memsets and copies (``torch.profiler``) while
    ``fn`` runs, ending in a synchronize.  A profiling session now and then
    records no device event at all; such a session is taken again, up to
    PROFILER_SESSIONS times, and then the list is empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events
    print(f"torch.profiler recorded no device event in {PROFILER_SESSIONS} sessions: "
          "device time not measured")
    return []


def _device_ms(fn, reps: int = 20) -> float | None:
    """Device time per call: ``torch.profiler`` over ``reps`` calls after a
    warm-up, the summed durations of the device's kernels, memsets and
    copies over ``reps`` (None where the profiler recorded nothing).
    Unlike ``_time_ms`` it leaves out the host's gaps between launches."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    events = _profiled_device_events(run)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps if events else None


def _kernel_us(fn, reps: int = 20) -> dict:
    """Launches and device time (us) a call of each kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls (empty where it recorded
    nothing)."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    out: dict = {}
    for e in _profiled_device_events(run):
        names = re.findall(r"::(\w+)", e.name)
        key = names[0] if names else e.name[:40]
        n, us = out.get(key, (0.0, 0.0))
        out[key] = (n + 1 / reps, us + e.time_range.elapsed_us() / reps)
    # a session now and then drops one event: launches a call are whole
    return {k: (round(n), round(us, 2)) for k, (n, us) in out.items()}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _host_ms(fn, reps: int = 200) -> float:
    """Host time per call: ``reps`` calls issued back to back after a
    warm-up, timed on the host's clock up to the last call's return (not
    to the device's end); a call that waits for the device (a host sync)
    includes that wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _times(r: dict) -> str:
    lib = "none" if r["library_ms"] is None else \
        f"{r['library_ms']:.4f} ms (device {_ms(r['library_device_ms'])}, " \
        f"host {r['library_host_ms']:.4f} ms)"
    return (f"{r['ms']:.4f} ms (device {_ms(r['device_ms'])}, host {r['host_ms']:.4f} ms) "
            f"vs plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}")


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _assert_equal(name: str, a, b) -> float:
    """Bitwise equality of two tensors (NaN-free); returns max |a - b|."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
    diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: kernel differs from its plain version (max |d| {diff})")
    return diff


def _row(name, path, shape, source, replaces, err, fn, plain_fn, bound, library_fn=None,
         plain_reps=20):
    """One kernel's line: ``fn`` calls its wrapper, ``plain_fn`` the plain
    version and ``library_fn`` one PyTorch call of the same function (or
    None), each timed with CUDA events; the wrapper and the library call
    also by device time alone and by host time alone."""
    return dict(
        name=name, path=path, shape=shape, route="cuda", source=f"{PKG}/csrc/{source}",
        replaces=f"{TPU}/ops/{replaces}", max_abs_err=err, ms=_time_ms(fn),
        device_ms=_device_ms(fn), host_ms=_host_ms(fn), plain_ms=_time_ms(plain_fn, plain_reps),
        bound_ms=bound[0], bound_by=bound[1],
        library_ms=None if library_fn is None else _time_ms(library_fn),
        library_device_ms=None if library_fn is None else _device_ms(library_fn),
        library_host_ms=None if library_fn is None else _host_ms(library_fn),
    )


def check_k1(dev, rng, path, n, cap, n_valid, n_keys, sentinel, leaf, run_len=None):
    """K1 on a key-sorted point buffer with 16-bit packed payloads: keys
    drawn from ``n_keys`` lattice cells, or with ``run_len`` runs of about
    that many rows each (runs that span windows)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import runreduce

    skey = np.full(n, sentinel, np.int32)
    if run_len is None:
        keys = np.sort(rng.choice(sentinel, n_keys, replace=False))
        skey[:n_valid] = np.sort(rng.choice(keys, n_valid))
        what = f"{n_keys} lattice cells"
    else:
        cuts = np.sort(rng.choice(np.arange(1, n_valid), n_valid // run_len, replace=False))
        skey[:n_valid] = np.searchsorted(cuts, np.arange(n_valid), side="right")
        what = f"runs of ~{run_len} rows spanning windows"
    pxy = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    pz = rng.integers(0, 65536, n).astype(np.int32)
    quantum = leaf / 65536.0
    args = [torch.tensor(skey, device=dev), (torch.tensor(pxy, device=dev), torch.tensor(pz, device=dev))]
    vk, nk = runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum)
    vp, np_ = runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum)
    if int(nk) != int(np_):
        raise AssertionError(f"K1 {path}: run count {int(nk)} != plain {int(np_)}")
    k = min(int(nk), cap)
    err = _assert_equal(f"K1 runreduce {path} ({what})", vk[:k], vp[:k])
    w = runreduce.default_group(n) * 128
    # keys + two payloads in, the filled slots and num out; 4 channels x
    # log2(w) Hillis-Steele adds a row
    bound = _bound(n * 12 + k * 20 + 4, 4 * n * int(np.log2(w)))
    return _row(
        "runreduce", path, f"{n} rows, {what}, {w}-row windows, {int(nk)} runs, cap {cap}",
        "runreduce.cu", "pallas_runreduce.py:462", err,
        lambda: runreduce.sorted_run_reduce(*args, sentinel, cap, quantum=quantum),
        lambda: runreduce.sorted_run_reduce_plain(*args, sentinel, cap, quantum=quantum),
        bound, plain_reps=3,
    )


def check_k2(dev, rng, path, nv, ccap, density):
    """K2: the non-plane cloud of a voxel buffer into the cluster buffer."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import compaction

    occ = torch.tensor(rng.random(nv) < density, device=dev)
    bins = torch.tensor(rng.standard_normal((4, nv)).astype(np.float32), device=dev)
    bins[3] = occ.to(torch.float32)
    c = bins.shape[0]
    occ2d = occ.reshape(nv // 128, 128)
    lk, nk, vk = compaction.compact_and_gather_exact(bins, occ2d, ccap)
    lp, np_, vp = compaction.compact_and_gather_plain(bins, occ2d, ccap)
    if int(nk) != int(np_):
        raise AssertionError(f"K2 {path}: occupied count differs")
    k = min(int(nk), ccap)
    _assert_equal(f"K2 compaction loc {path}", lk[:k], lp[:k])
    err = _assert_equal(f"K2 compaction vals {path}", vk[:k], vp[:k])
    return _row(
        "compact_gather", path, f"{nv} -> {ccap} slots, {int(nk)} occupied",
        "compaction.cu", "pallas_compaction.py:59", err,
        lambda: compaction.compact_and_gather_exact(bins, occ2d, ccap),
        lambda: compaction.compact_and_gather_plain(bins, occ2d, ccap),
        # the mask once; each filled slot's channels read, loc and vals written; num
        _bound(nv + min(int(nk), ccap) * (4 * c + 4 + 4 * c) + 4, 0),
        library_fn=lambda: bins.T[occ],  # boolean-mask gather
    )


def _lattice_buffer(dev, rng, n, n_valid, lo, hi):
    """A lattice-ordered (x-sorted), front-compacted, centered point buffer."""
    import torch

    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    valid = torch.tensor(np.arange(n) < n_valid, device=dev)
    p = torch.tensor(pts, device=dev)
    p = torch.where(valid[:, None], p - torch.where(valid[:, None], p, 0.0).sum(0) / n_valid, 0.0)
    return p, valid


def check_k3(dev, rng, path, nv, n_valid, rt, band, k):
    """K3 on front-compacted random points sorted by x (the voxel cloud's
    shape, not its lattice order: a query's rank neighbours are not its
    nearest, so the selection inserts more than on a scan's cloud)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    p, valid = _lattice_buffer(dev, rng, nv, n_valid, [0, 0, -0.1], [4.5, 3.78, 0.3])
    pch = [p[:, c].contiguous() for c in range(3)]
    p_sq = pch[0] * pch[0] + pch[1] * pch[1] + pch[2] * pch[2]
    tiles = -(-nv // rt)
    starts = outliers.band_starts(nv, rt, band, tiles, dev)
    width = rt + 2 * band
    return _k3_row(path, f"{nv} x-sorted random queries", (pch, p_sq, valid, starts, rt, width, k))


def _k3_row(path, what, args):
    """K3's line: the kernel's mean against the plain version's, bitwise
    (one cloud's channels [N], or a batch's [B, N])."""
    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    pch, p_sq, valid, starts, rt, width, k = args
    nv, tiles, scans = p_sq.shape[-1], starts.shape[0], p_sq[..., 0].numel()
    err = _assert_equal(f"K3 knn_mean {path} ({what})", outliers.knn_mean(*args),
                        outliers.knn_mean_plain(*args))
    live_tiles = int(outliers._tile_live(valid, tiles, rt).sum())
    return _row(
        "knn_mean", path, f"{what}, row tile {rt}, window {width}, k {k}",
        "knn_select.cu", "outliers.py:142", err,
        lambda: outliers.knn_mean(*args),
        lambda: outliers.knn_mean_plain(*args),
        # channels, |p|^2 and the mask read once, the starts, the [n_q] means written
        _bound(scans * nv * 17 + tiles * 4 + scans * tiles * rt * 4,
               live_tiles * rt * width * D2_OPS),
        plain_reps=3,
    )


def _capture(module, name: str, call) -> list:
    """The arguments of every call ``call()`` makes to ``module.<name>``
    (looked up at call time by its caller)."""
    seen, fn = [], getattr(module, name)
    setattr(module, name, lambda *a, **kw: seen.append((a, kw)) or fn(*a, **kw))
    try:
        call()
    finally:
        setattr(module, name, fn)
    return seen


def capture_k3_args(model, cloud, draw, name: str = "knn_mean") -> tuple:
    """The arguments of the one call a scan makes to ``ops.outliers.<name>``
    (K3's wrapper, which ``knn_mean_distances`` looks up at call time)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    ((args, _),) = _capture(outliers, name, lambda: model(cloud, draw=draw))
    return args


def check_k3_scan(path, model, cloud, draw):
    """K3 on the inputs one main-path scan gives it: the centered,
    lattice-ordered voxel cloud, taken from the scan's own call."""
    args = capture_k3_args(model, cloud, draw)
    nv = int(args[2].sum())
    return _k3_row(path, f"the scan's voxel cloud ({nv} valid of {args[1].shape[-1]})", args)


def _cluster_buffer(dev, rng, c, n_valid, spread):
    import torch

    p, valid = _lattice_buffer(dev, rng, c, n_valid, [0, 0, -0.3], [spread, 3.78, 0.3])
    lab = np.arange(c, dtype=np.int32)  # labels[i] <= i, as the sweep loop keeps them
    lab[:n_valid] = rng.integers(0, np.arange(n_valid) + 1)
    return p, valid, torch.tensor(lab, device=dev)


def check_k4(dev, rng, c, n_valid, tol2, card: str) -> None:
    """K4's per-sweep kernel (``csrc/cluster_sweep.cu``, off every path: the
    ``loop crossover:`` yardstick) on a centered cluster buffer with chained
    labels, held bitwise against ``sweep_jump_plain`` and timed; printed,
    not listed with the kernels of the paths."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    p, valid, labels = _cluster_buffer(dev, rng, c, n_valid, 3.0)
    chans = cluster.point_channels(p)  # as the per-sweep loop lays them out, once
    err = _assert_equal("K4 cluster_sweep", cluster.sweep_jump(chans, valid, labels, tol2),
                        cluster.sweep_jump_plain(chans, valid, labels, tol2))
    row = _row(
        "cluster_sweep", "off every path", f"C {c}, {n_valid} valid",
        "cluster_sweep.cu", "cluster.py:86", err,
        lambda: cluster.sweep_jump(chans, valid, labels, tol2),
        lambda: cluster.sweep_jump_plain(chans, valid, labels, tol2),
        _bound(c * 21 + c * 4, n_valid * n_valid * D2_OPS),  # pairs of valid points
    )
    print(f"kernel {row['name']} [{row['path']}: {row['shape']}]: equal to plain; {_times(row)} "
          f"[{card}]")


def _loop_row(path, what, args, timed=True):
    """The loop kernel's line: labels, unconverged and sweeps against the
    plain loop's on the same inputs, exact (one buffer, or a batch)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    pk, valid, labels, tol2, max_iters = args
    got = cluster.cluster_loop(*args)
    want = cluster.cluster_loop_plain(*args)
    err = _assert_equal(f"K4 cluster_loop {path} labels ({what})", got.labels, want.labels)
    for f in ("unconverged", "sweeps"):
        a, b = (torch.as_tensor(getattr(o, f)).cpu().to(torch.int32) for o in (got, want))
        if not torch.equal(a, b):
            raise AssertionError(f"K4 cluster_loop {path}: {f} {a.tolist()} != plain {b.tolist()}")
    c = labels.shape[-1]
    scans = labels[..., 0].numel()
    n_valid = valid.reshape(scans, c).sum(dim=1).cpu().double()
    sweeps = torch.as_tensor(want.sweeps).reshape(scans).double()
    shape = (f"{what}: C {c}, {int(n_valid.sum())} valid, {int(sweeps.sum())} sweeps"
             + (f", {scans} scans" if scans > 1 else ""))
    return _row(
        "cluster_loop", path, shape, "cluster_loop.cu", "cluster.py:86", err,
        lambda: cluster.cluster_loop(*args),
        lambda: cluster.cluster_loop_plain(*args),
        # packed points, valid and labels in; labels, the flag and the count out;
        # each sweep scores the pairs of valid points
        _bound(scans * (c * 21 + c * 4 + 5), float((sweeps * n_valid ** 2).sum()) * D2_OPS),
        plain_reps=5,
    )


def _grid_row(path, what, args):
    """The grid-wide loop kernel's line: labels, unconverged and sweeps
    against the plain loop's on the same inputs, exact."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    pk, valid, labels, tol2, max_iters = args
    got = cluster.grid_loop(*args)
    want = cluster.cluster_loop_plain(*args)
    err = _assert_equal(f"K4 cluster_grid_loop {path} labels ({what})", got.labels, want.labels)
    for f in ("unconverged", "sweeps"):
        a, b = (torch.as_tensor(getattr(o, f)).cpu().to(torch.int32) for o in (got, want))
        if not torch.equal(a, b):
            raise AssertionError(f"K4 cluster_grid_loop {path}: {f} {a.tolist()} != plain "
                                 f"{b.tolist()}")
    c = labels.shape[-1]
    scans = labels[..., 0].numel()
    n_valid = valid.reshape(scans, c).sum(dim=1).cpu().double()
    sweeps = torch.as_tensor(want.sweeps).reshape(scans).double()
    row = _row(
        "cluster_grid_loop", path,
        f"{what}: C {c}, {int(n_valid.sum())} valid, {int(sweeps.sum())} sweeps"
        + (f", {scans} scans" if scans > 1 else ""),
        "cluster_grid_loop.cu", "cluster.py:86", err,
        lambda: cluster.grid_loop(*args),
        lambda: cluster.cluster_loop_plain(*args),
        # packed points, valid and labels in; labels, the flag and the count out;
        # each sweep scores the pairs of valid points
        _bound(scans * (c * 21 + c * 4 + 5), float((sweeps * n_valid ** 2).sum()) * D2_OPS),
        plain_reps=2,
    )
    row["sweeps"] = int(sweeps.sum())
    return row


def _sum_row(path, calls):
    """The sum kernel on every call a scan (or batch) made to it, each held
    bitwise against the plain version; timed on the refinement's covariance
    call (the two-operand form; its launches are the most of a scan)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import ops

    err = 0.0
    for i, ((a, b), _) in enumerate(calls):
        err = max(err, _assert_equal(f"sum kernel {path} call {i} ({tuple(a.shape)})",
                                     ops._xla_sum_kernel(a, b).view(torch.int32),
                                     ops.sum_like_xla_plain(a, b).view(torch.int32)))
    (a, b), _ = next(c for c in calls if c[0][1] is not None)
    lead, sa, n = a[..., 0, 0].numel(), a.shape[-2], a.shape[-1]
    sb = b.shape[-2]
    return _row(
        "xla_sum", path, f"{len(calls)} calls a run, all equal; timed: covariance "
        f"{tuple(a.shape)} x {tuple(b.shape)}", "xla_sum.cu", "ransac.py:174 (plain XLA, no TPU kernel)", err,
        lambda: ops._xla_sum_kernel(a, b), lambda: ops.sum_like_xla_plain(a, b),
        # both operands read once, the sums written; a product and an add a term
        _bound(lead * (sa + sb) * n * 4 + lead * sa * sb * 4, 2 * lead * sa * sb * n),
        library_fn=lambda: (a[..., :, None, :] * b[..., None, :, :]).sum(-1), plain_reps=3,
    )


def _tail_row(path, calls):
    """The refinement's 3x3 tail on every call a run made to it, each held
    bitwise against the plain version; one timed."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    err = 0.0
    for i, (args, _) in enumerate(calls):
        for g, w in zip(ransac.plane_tail(*args), ransac.plane_tail_plain(*args)):
            err = max(err, _assert_equal(f"plane_refine {path} call {i}", g.view(torch.int32),
                                         w.view(torch.int32)))
    args = calls[0][0]
    b = args[0].shape[0]
    return _row(
        "plane_refine", path, f"{len(calls)} calls a run, all equal; {b} scans a call",
        "plane_refine.cu", "ransac.py:70 (plain XLA, no TPU kernel)", err,
        lambda: ransac.plane_tail(*args), lambda: ransac.plane_tail_plain(*args),
        # 17 floats in and 4 out a scan; 24 steps of 9 fma, 3 mul, the norm,
        # 3 divides a scan (~50 operations a step)
        _bound(b * 21 * 4, b * 24 * 50), plain_reps=3,
    )


def capture_refine(run) -> tuple[list, list]:
    """The calls one run makes to the sum kernel and to the 3x3 tail."""
    from pointcloud_obstacle_processing_tpu_torch import ops
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    sums = []
    tails = _capture(ransac, "plane_tail", lambda: sums.extend(_capture(ops, "_xla_sum_kernel", run)))
    return sums, tails


def check_loop(dev, rng, path, c, n_valid, tol2, max_iters):
    """The loop kernel on a centered cluster buffer with chained labels."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    p, valid, labels = _cluster_buffer(dev, rng, c, n_valid, 3.0)
    return _loop_row(path, "x-sorted random points, random chained labels",
                     (cluster.pack_points(p), valid, labels, tol2, max_iters))


def capture_loop_args(model, cloud, draw) -> tuple:
    """The arguments of the one ``ops.cluster.cluster_loop`` call a scan
    makes (``euclidean_cluster`` looks it up at call time)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    ((args, _),) = _capture(cluster, "cluster_loop", lambda: model(cloud, draw=draw))
    return args


def check_k5(dev, rng, path, c, n_valid, window, tolerance):
    """K5 on a lattice-ordered, centered cluster buffer, every tile live and
    with a seeded random tile_live; starts from ``band_starts``."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    p, valid, labels = _cluster_buffer(dev, rng, c, n_valid, 4.5)
    packed = cluster.pack_points(p)  # as the cluster loop lays them out, once
    tol2 = tolerance ** 2
    starts, _ = cluster.band_starts(p, valid, 128, window, tolerance)
    has_valid = valid.reshape(c // 128, 128).any(dim=1)
    rows = []
    for gated in (False, True):
        live = torch.tensor(rng.random(c // 128) < 0.5, device=dev) if gated else None
        args = (packed, valid, labels, tol2, 128, window, starts, live)
        err = _assert_equal(f"K5 cluster_sweep_banded {path} gated={gated}",
                            cluster.sweep_jump_banded(*args), cluster.sweep_jump_banded_plain(*args))
        computed = int((has_valid & live).sum()) if gated else int(has_valid.sum())
        rows.append(_row(
            "cluster_sweep_banded", path,
            f"C {c}, {n_valid} valid, window {window}, "
            f"{'random tile_live' if gated else 'every tile live'}, {computed} tiles computed",
            "cluster_sweep_banded.cu", "cluster.py:329", err,
            lambda: cluster.sweep_jump_banded(*args),
            lambda: cluster.sweep_jump_banded_plain(*args),
            # packed points, valid and labels; starts and tile_live; out
            _bound(c * 21 + (c // 128) * 5 + c * 4, computed * 128 * window * D2_OPS),
        ))
    return rows


def _sorted_key_heads(rng, n: int, n_keys: int) -> np.ndarray:
    keys = np.sort(rng.integers(0, n_keys, n))
    return np.concatenate([[True], keys[1:] != keys[:-1]])


def binning_inputs(dev, rng):
    """K7's inputs at the reference kernel's documented shape: ids in [0, k),
    x, y, z weights and a unit count channel, 90% valid."""
    import torch

    n, k = BINNING_N, BINNING_K
    ids = torch.tensor(rng.integers(0, k, n).astype(np.int32), device=dev)
    weights = torch.tensor(np.concatenate(
        [rng.uniform(-4.5, 4.5, (n, 3)), np.ones((n, 1))], axis=1).astype(np.float32), device=dev)
    valid = torch.tensor(rng.random(n) < 0.9, device=dev)
    return ids, weights, valid, k


def check_k7(dev, ids, weights, valid, k, binned=None) -> dict:
    """K7 against its plain version: counts exact (and equal to the member
    counts), sums within the float32 reordering bound.  ``binned``: the
    path run's output, computed here when not given."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import binning

    if binned is None:
        binned = binning.binned_weighted_sum(ids, weights, valid, k)
    n, c = weights.shape
    plain = binning.binned_weighted_sum_plain(ids, weights, valid, k)
    if not torch.equal(binned[:, 3], plain[:, 3]):
        raise AssertionError("K7: counts differ from the plain version")
    keep = valid & (ids < k)
    if not torch.equal(binned[:, 3], torch.bincount(ids[keep].long(), minlength=k).float()):
        raise AssertionError("K7: counts differ from the member counts")
    bound = binning.reordering_bound(ids, weights, valid, k)
    diff = (binned.double() - plain.double()).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"K7: sums differ from the plain version beyond the bound "
                             f"(max |d| {diff.max().item()})")
    rows_k = ids[keep].long()
    terms = binning.weight_terms(weights[keep], True)
    rows_k2, terms2 = torch.cat([rows_k, rows_k]), torch.cat(terms)
    n_terms = int(sum((t != 0).sum() for t in terms))  # the adds of the plain version's terms
    return _row(
        "binned_sum", "binning", f"N {n}, k {k}, C {c}, {int(keep.sum())} valid rows, exact_f32",
        "binning.cu", "pallas_binning.py:52", diff.max().item(),
        lambda: binning.binned_weighted_sum(ids, weights, valid, k),
        lambda: binning.binned_weighted_sum_plain(ids, weights, valid, k),
        _bound(n * (4 + 4 * c + 1) + k * c * 4, n_terms),
        library_fn=lambda: torch.zeros(k, c, device=dev).index_add_(0, rows_k2, terms2),
    )


def run_segscan_binning(dev, card: str) -> tuple[list[dict], dict]:
    """Phase 6: K6 and K7 through their entry points.  Returns the kernel
    rows and the launches of each path."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build
    from pointcloud_obstacle_processing_tpu_torch.ops import binning, segscan

    rng = np.random.default_rng(3)
    scans = []
    for n, no_heads in ((SEGSCAN_N, False), (FULLSCALE_POINTS, False), (FULLSCALE_POINTS, True)):
        v = rng.standard_normal((4, n)).astype(np.float32)
        v[:, rng.random(n) < 0.01] = -0.0
        # run heads of a sorted key buffer (mean run 12), or none: one
        # segment over the row, every element live past the local steps
        heads = np.zeros(n, bool) if no_heads else _sorted_key_heads(rng, n, n // 12)
        scans.append((torch.tensor(v, device=dev), torch.tensor(heads, device=dev)))
    ids, weights, valid, k = binning_inputs(dev, rng)

    # the two paths: counts from 0, then read
    launches = {}
    _build.reset_launch_counts()
    scanned = [segscan.segmented_inclusive_scan(v, h) for v, h in scans]
    torch.cuda.synchronize()
    launches["segscan"] = dict(_build.LAUNCHES)
    _build.reset_launch_counts()
    binned = binning.binned_weighted_sum(ids, weights, valid, k)
    torch.cuda.synchronize()
    launches["binning"] = dict(_build.LAUNCHES)
    for path, name in (("segscan", "segscan"), ("binning", "binned_sum")):
        if launches[path][name] <= 0:
            raise AssertionError(f"kernel {name} not launched on the {path} path")

    rows = []
    for (v, h), out in zip(scans, scanned):
        c_, n_ = v.shape
        plain = segscan.segmented_inclusive_scan_plain(v, h)
        if not torch.isfinite(out).all():
            raise AssertionError("K6: non-finite output on finite input")
        err = _assert_equal(f"K6 segscan [{c_}, {n_}] (bit patterns)",
                            out.view(torch.int32), plain.view(torch.int32))
        steps = len(segscan.scan_steps(n_))
        by_kernel = _kernel_us(lambda: segscan.segmented_inclusive_scan(v, h))
        ops = sum(n for n, _ in by_kernel.values()) if by_kernel else None
        rows.append(_row(
            "segscan", "segscan", f"[{c_}, {n_}] float32, {steps} steps, "
            f"{int(h.sum())} segments ({'no head' if not bool(h.any()) else 'run heads'}), "
            f"{'not measured' if ops is None else f'{ops:g}'} launches a call",
            "segscan.cu", "segscan.py:59", err,
            lambda: segscan.segmented_inclusive_scan(v, h),
            lambda: segscan.segmented_inclusive_scan_plain(v, h),
            _bound(c_ * n_ * 8 + n_, steps * c_ * n_),
        ))
        rows[-1]["by_kernel"] = f"; launches and device us a call by kernel {by_kernel}"
    long_row_check(dev, rng, card)
    rows.append(check_k7(dev, ids, weights, valid, k, binned))
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: "
              f"{'bit patterns equal' if r['name'] == 'segscan' else 'counts exact, sums within bound'}"
              f" to plain (max |d| {r['max_abs_err']:.3g}); {_times(r)}; launches on the path "
              f"{launches[r['path']][r['name']]}{r.get('by_kernel', '')} [{card}]")
    return rows, launches


def long_row_check(dev, rng, card: str) -> None:
    """K6 on one row past 2^24 values (sparse heads, segments of thousands;
    -0.0 at 1%), where its later steps run one launch each in global
    memory, held against the plain version in bit patterns (printed: no
    path gives K6 such rows)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import segscan

    n = 2**24 + 4096
    v = rng.standard_normal((1, n)).astype(np.float32)
    v[:, rng.random(n) < 0.01] = -0.0
    v, h = torch.tensor(v, device=dev), torch.tensor(rng.random(n) < 3e-4, device=dev)
    _assert_equal(f"K6 segscan [1, {n}] (bit patterns)",
                  segscan.segmented_inclusive_scan(v, h).view(torch.int32),
                  segscan.segmented_inclusive_scan_plain(v, h).view(torch.int32))
    by_kernel = _kernel_us(lambda: segscan.segmented_inclusive_scan(v, h))
    print(f"kernel segscan [long row: [1, {n}] float32, {int(h.sum())} heads]: bit patterns "
          f"equal to plain; launches and device us a call by kernel {by_kernel} [{card}]")


def check_kernels(dev, card: str) -> list[dict]:
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs

    rng = np.random.default_rng(0)
    rows = [
        check_k1(dev, rng, "flagship", fl.max_points, fl.max_voxels, 90_000, 21_500, 230_000,
                 fl.downsample_leaf_size),
        check_k2(dev, rng, "flagship", fl.max_voxels, fl.cluster_capacity, 0.025),
        check_k3(dev, rng, "flagship", fl.max_voxels, 21_500, fl.knn_row_tile, fl.knn_band,
                 fl.statistical_outlier_mean_k),
        check_loop(dev, rng, "flagship", fl.cluster_capacity, 600, fl.euc_cluster_tolerance ** 2,
                   fl.cluster_max_iters),
        # the fullscale window: ~2.0 M points, ~166 k voxels of a 302 x 254 x
        # 52 lattice, ~7 k non-plane points
        check_k1(dev, rng, "fullscale", fs.max_points, fs.max_voxels, 2_000_000, 166_000,
                 3_988_816, fs.downsample_leaf_size),
        check_k1(dev, rng, "fullscale", fs.max_points, fs.max_voxels, 2_000_000, None,
                 3_988_816, fs.downsample_leaf_size, run_len=6_000),
        check_k2(dev, rng, "fullscale", fs.max_voxels, fs.cluster_capacity, 7_000 / fs.max_voxels),
        check_k3(dev, rng, "fullscale", fs.max_voxels, 166_000, fs.knn_row_tile, fs.knn_band,
                 fs.statistical_outlier_mean_k),
        *check_k5(dev, rng, "fullscale", fs.cluster_capacity, 7_000, fs.cluster_band_window,
                  fs.euc_cluster_tolerance),
    ]
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} [{card}]")
    return rows


def _scene(seed: int):
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene

    return make_scene(seed=seed, spec=SceneSpec(
        n_ground=90_000, n_rocks=4, points_per_rock=2_000, n_noise=500))


def _check_rocks(scene, res) -> None:
    """Every rock of the scene is reported as a cluster: a centroid within
    0.15 m of the rock's centre in x-y with a radius of at least r - 0.12
    (the check of tests/test_pipeline.py), or, where clutter has chained
    onto the rock's cluster, a cluster whose x-y circle holds the whole
    rock.  That test's upper radius bound is not applied: with the flagship
    scenes' 500 clutter points, clutter chains onto rock clusters and
    widens them (in the JAX package as well), as the comment on that
    test's scene explains."""
    got = res.centroids.points.xyzr.cpu().numpy()[res.centroids.valid.cpu().numpy()]
    if len(got) < len(scene.rock_centers):
        raise AssertionError(f"{len(got)} clusters for {len(scene.rock_centers)} rocks")
    for c, r in zip(scene.rock_centers, scene.rock_radii):
        d = np.linalg.norm(got[:, :2] - c[None, :2], axis=1)
        j = int(np.argmin(d))
        near = d[j] < 0.15 and got[j, 3] >= r - 0.12
        if not (near or d[j] + r <= got[j, 3]):
            raise AssertionError(
                f"rock at {c} (r {r:.3f}) unmatched: nearest {d[j]:.3f}, r {got[j, 3]:.3f}")


_COUNTS = ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
           "nonplane_points", "num_planes", "num_clusters")
_FLAGS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow",
          "planes_truncated", "cluster_unconverged")
_OVERFLOWS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow")


def _compare(label: str, a, b) -> float:
    """CUDA run ``a`` against CPU run ``b``: the crosscheck bar."""
    import torch

    if not torch.equal(a.grid.data.cpu(), b.grid.data.cpu()):
        raise AssertionError(f"{label}: grids differ")
    for k in _COUNTS + _FLAGS:
        va, vb = getattr(a.stats, k).item(), getattr(b.stats, k).item()
        if va != vb:
            raise AssertionError(f"{label}: {k} cuda={va} cpu={vb}")
    ca = a.centroids.points.xyzr.cpu().numpy()[a.centroids.valid.cpu().numpy()]
    cb = b.centroids.points.xyzr.cpu().numpy()[b.centroids.valid.cpu().numpy()]
    if ca.shape != cb.shape:
        raise AssertionError(f"{label}: cluster counts differ")
    if not np.isfinite(ca).all():
        raise AssertionError(f"{label}: non-finite centroids")
    err = float(np.abs(np.sort(ca, axis=0) - np.sort(cb, axis=0)).max()) if len(ca) else 0.0
    if err >= 1e-5:
        raise AssertionError(f"{label}: centroids differ by {err}")
    return err


def _check_overflows(label: str, res) -> None:
    flags = {k: bool(getattr(res.stats, k).item()) for k in _OVERFLOWS}
    if any(flags.values()):
        raise AssertionError(f"{label}: overflow flag set: {flags}")


def _drive(model, cloud, draw, path: list[str]) -> tuple[object, dict]:
    """One main-path scan with the launch counts from 0; fails if a kernel
    of ``path`` was not launched.  Returns the result and the counts."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build

    _build.reset_launch_counts()
    res = model(cloud, draw=draw)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return res, counts


def _time_scans(model, clouds, draw, n: int) -> list[float]:
    import torch

    times = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(clouds[i % len(clouds)], draw=draw)
        torch.cuda.synchronize()
        if i:  # the first run warms the allocator
            times.append((time.perf_counter() - t) * 1e3)
    return times


def scan_device_ops(model, cloud, draw) -> tuple[int, float] | tuple[None, None]:
    """Device operations (kernels, memsets, copies) of one scan and their
    summed device time in ms, from ``torch.profiler``, after a warm-up scan
    (None, None where the profiler recorded nothing)."""
    import torch

    model(cloud, draw=draw)
    torch.cuda.synchronize()
    events = _profiled_device_events(lambda: model(cloud, draw=draw))
    if not events:
        return None, None
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def _count_syncs(model, cloud, draw) -> tuple[int, object]:
    """Host syncs of one scan, as torch's sync debug mode reports them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = model(cloud, draw=draw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught), res


def _check_syncs(label: str, n_sync: int, res, expected: int | None = None) -> None:
    """Every host sync of the scan is one of the cluster loop's reads, and
    there are ``expected`` of them where that is given."""
    if n_sync != res.host_syncs:
        raise AssertionError(f"{label}: {n_sync} host syncs, the cluster loop makes {res.host_syncs}")
    if expected is not None and n_sync != expected:
        raise AssertionError(f"{label}: {n_sync} host syncs a scan, expected {expected}")


def _draws(cfg, dev):
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform

    u = np.random.default_rng(RANSAC_SEED).random(
        (cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    return draw_from_uniform(torch.tensor(u, device=dev)), draw_from_uniform(torch.tensor(u))


def run_flagship(dev, card: str) -> tuple[dict, list[dict]]:
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG, ObstacleDetectionModel

    cfg = FLAGSHIP_CONFIG
    model = ObstacleDetectionModel(cfg, device=dev)
    model_cpu = ObstacleDetectionModel(cfg, device="cpu")
    draw_cuda, draw_cpu = _draws(cfg, dev)
    scenes = {s: _scene(s) for s in SCENE_SEEDS}
    clouds = {s: Cloud.pad_to(scenes[s].points[: cfg.max_points], cfg.max_points) for s in SCENE_SEEDS}
    gpu_clouds = [clouds[s].to(dev) for s in SCENE_SEEDS]

    # main path: counts from 0, one scan of each scene on the card
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_loop", "xla_sum", "plane_refine"]
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    results = {}
    for s, gc in zip(SCENE_SEEDS, gpu_clouds):
        results[s], counts = _drive(model, gc, draw_cuda, path)
        launches = {k: launches[k] + counts[k] for k in launches}

    for s in SCENE_SEEDS:
        res = results[s]
        _check_overflows(f"scene {s}", res)
        _check_rocks(scenes[s], res)
        err = _compare(f"scene {s}", res, model_cpu(clouds[s], draw=draw_cpu))
        counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
        print(f"flagship scene {s}: cuda == cpu plain (grid, counts, flags exact; centroid max "
              f"|d| {err:.2e}); {counts}; host syncs {res.host_syncs}")

    times = _time_scans(model, gpu_clouds, draw_cuda, TIMED_SCANS)
    n_sync, res = _count_syncs(model, gpu_clouds[0], draw_cuda)
    _check_syncs("flagship", n_sync, res, expected=0)
    n_ops, dev_ms = scan_device_ops(model, gpu_clouds[0], draw_cuda)
    print(f"flagship process_scan p50 {statistics.median(times):.3f} ms per scan over "
          f"{len(times)} scans (min {min(times):.3f}, max {max(times):.3f}); host syncs per scan "
          f"{n_sync} (sync debug mode; cluster loop counts {res.host_syncs}); device operations "
          f"per scan {n_ops} ({_ms(dev_ms)} of device time, scene {SCENE_SEEDS[0]}); kernel "
          f"launches over the {len(SCENE_SEEDS)} main-path scans {launches} [{card}]")
    loop_args = capture_loop_args(model, gpu_clouds[0], draw_cuda)
    sums, tails = capture_refine(lambda: model(gpu_clouds[0], draw=draw_cuda))
    return launches, [check_k3_scan("flagship", model, gpu_clouds[0], draw_cuda),
                      _loop_row("flagship", "the scan's non-plane cloud", loop_args),
                      _sum_row("flagship", sums), _tail_row("flagship", tails)]


def run_fullscale(dev, card: str) -> tuple[dict, list[dict]]:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.models import (
        REFERENCE_FULLSCALE_CONFIG,
        ObstacleDetectionModel,
    )
    from pointcloud_obstacle_processing_tpu_torch.types import Cloud
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cfg = REFERENCE_FULLSCALE_CONFIG
    model = ObstacleDetectionModel(cfg, device=dev)
    model_cpu = ObstacleDetectionModel(cfg, device="cpu")
    draw_cuda, draw_cpu = _draws(cfg, dev)
    pts, valid = make_fullscale_window(FULLSCALE_POINTS)
    cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid))
    gpu_cloud = cloud.to(dev)

    path = ["runreduce", "compact_gather", "knn_mean", "cluster_sweep_banded", "xla_sum",
            "plane_refine"]
    res, launches = _drive(model, gpu_cloud, draw_cuda, path)
    _check_overflows("fullscale", res)
    if int(res.stats.num_clusters) < 1:
        raise AssertionError("fullscale: no cluster found")
    t = time.perf_counter()
    ref = model_cpu(cloud, draw=draw_cpu)
    cpu_s = time.perf_counter() - t
    err = _compare("fullscale", res, ref)
    counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
    print(f"fullscale window: cuda == cpu plain (grid, counts, flags exact; centroid max |d| "
          f"{err:.2e}); {counts}; host syncs {res.host_syncs}; cpu plain run {cpu_s:.1f} s")

    times = _time_scans(model, [gpu_cloud], draw_cuda, FULLSCALE_TIMED_SCANS)
    n_sync, res = _count_syncs(model, gpu_cloud, draw_cuda)
    _check_syncs("fullscale", n_sync, res)
    n_ops, dev_ms = scan_device_ops(model, gpu_cloud, draw_cuda)
    print(f"fullscale process_scan p50 {statistics.median(times):.3f} ms per scan over "
          f"{len(times)} scans (min {min(times):.3f}, max {max(times):.3f}); host syncs per scan "
          f"{n_sync} (sync debug mode; cluster loop counts {res.host_syncs}); device operations "
          f"per scan {n_ops} ({_ms(dev_ms)} of device time); kernel launches on the main-path "
          f"scan {launches} [{card}]")
    sums, tails = capture_refine(lambda: model(gpu_cloud, draw=draw_cuda))
    return launches, [check_k3_scan("fullscale", model, gpu_cloud, draw_cuda),
                      _sum_row("fullscale", sums), _tail_row("fullscale", tails)], res


def run_fullscale_bandoff(dev, card: str, banded) -> tuple[dict, list[dict]]:
    """The fullscale window with the band off (``REFERENCE_FULLSCALE_CONFIG
    .replace(cluster_band_window=0)``, the configuration a deployment takes
    when its windows outgrow the band): counts from 0, one scan on the card
    whose 16,384-point cluster buffer takes the grid-wide loop kernel
    (above the loop kernel's capacity), held to ``banded``, the banded card
    run of the same window with the same draws (the band does not overflow
    on this window, so the two agree: grid, counts, flags, centroids and
    every point's cluster); 0 host syncs for the whole scan; p50 over 5
    scans and device operations; then the grid-wide loop kernel on the
    scan's own clustering inputs against ``cluster_loop_plain``."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.models import (
        REFERENCE_FULLSCALE_CONFIG,
        ObstacleDetectionModel,
    )
    from pointcloud_obstacle_processing_tpu_torch.types import Cloud
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    cfg = REFERENCE_FULLSCALE_CONFIG.replace(cluster_band_window=0)
    model = ObstacleDetectionModel(cfg, device=dev)
    draw_cuda, _ = _draws(cfg, dev)
    pts, valid = make_fullscale_window(FULLSCALE_POINTS)
    gpu_cloud = Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)).to(dev)

    path = ["runreduce", "compact_gather", "knn_mean", "cluster_grid_loop", "xla_sum",
            "plane_refine"]
    res, launches = _drive(model, gpu_cloud, draw_cuda, path)
    others = {k: launches[k] for k in ("cluster_loop", "cluster_sweep", "cluster_sweep_banded")}
    if launches["cluster_grid_loop"] != 1 or any(others.values()):
        raise AssertionError(f"fullscale band off: one grid-wide loop launch and no other "
                             f"cluster kernel expected, got {launches}")
    _check_overflows("fullscale band off", res)
    if bool(banded.stats.cluster_band_overflow.item()):
        raise AssertionError("fullscale: the banded run's band overflowed; the band-off run "
                             "need not agree with it")
    err = _compare("fullscale band off vs banded", res, banded)
    _assert_equal("fullscale band off point_cluster", res.clusters.point_cluster,
                  banded.clusters.point_cluster)
    times = _time_scans(model, [gpu_cloud], draw_cuda, FULLSCALE_TIMED_SCANS)
    n_sync, res = _count_syncs(model, gpu_cloud, draw_cuda)
    _check_syncs("fullscale band off", n_sync, res, expected=0)
    n_ops, dev_ms = scan_device_ops(model, gpu_cloud, draw_cuda)
    counts = {k: getattr(res.stats, k).item() for k in _COUNTS}
    print(f"fullscale band off: cuda == banded cuda run (grid, counts, flags, point clusters "
          f"exact; centroid max |d| {err:.2e}); {counts}; process_scan p50 "
          f"{statistics.median(times):.3f} ms per scan over {len(times)} scans (min "
          f"{min(times):.3f}, max {max(times):.3f}); host syncs per scan {n_sync} (sync debug "
          f"mode); device operations per scan {n_ops} ({_ms(dev_ms)} of device time); kernel "
          f"launches on the main-path scan {launches} [{card}]")
    args = capture_loop_args(model, gpu_cloud, draw_cuda)
    row = _grid_row("fullscale_bandoff", "the scan's non-plane cloud", args)
    sweeps = row["sweeps"]
    per_sweep = None if row["device_ms"] is None else row["device_ms"] / sweeps
    print(f"grid-wide loop a sweep (fullscale band off): device {_ms(per_sweep)}, bound "
          f"{row['bound_ms'] / sweeps:.4f} ms ({sweeps} sweeps) [{card}]")
    return launches, [row]


def run_cluster_wide(dev, card: str) -> tuple[list[dict], dict]:
    """The full sweep above the loop kernel's capacity: counts from 0, one
    ``euclidean_cluster`` of a CLUSTER_WIDE-point buffer with the band off
    on the card (one launch of the grid-wide loop kernel), against the same
    call on the CPU (labels, slots and flags exact); then the grid-wide
    loop kernel checked and timed at that capacity, and the forms of the
    loop side by side (``loop_crossover``).  Returns the kernel rows and
    the path's launches."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    rng = np.random.default_rng(4)
    c, n_valid = CLUSTER_WIDE, CLUSTER_WIDE * 5 // 8
    cloud = _blob_cloud(rng, c, n_valid)
    args = (fl.euc_cluster_tolerance, fl.euc_min_cluster_size, fl.euc_max_cluster_size,
            fl.max_clusters, fl.cluster_max_iters)
    _build.reset_launch_counts()
    got = cluster.euclidean_cluster(cloud.to(dev), *args)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches["cluster_grid_loop"] != 1 or launches["cluster_sweep"] or launches["cluster_loop"]:
        raise AssertionError(f"cluster_wide: expected one grid-wide loop launch, got {launches}")
    want = cluster.euclidean_cluster(cloud, *args)
    for f in ("labels", "root_slot", "unconverged", "overflow"):
        _assert_equal(f"cluster_wide {f}", getattr(got, f), getattr(want, f))
    for f in ("point_cluster", "sizes", "valid", "num_clusters"):
        _assert_equal(f"cluster_wide {f}", getattr(got.clusters, f), getattr(want.clusters, f))
    print(f"cluster_wide: euclidean_cluster at C {c} ({n_valid} valid): cuda == cpu plain "
          f"(labels, slots, flags exact); {int(got.clusters.num_clusters)} clusters; "
          f"host syncs {got.host_syncs} [{card}]")
    d = cloud.to(dev)
    p, p_sq, labels = cluster._seed_labels(d.points, d.valid, fl.euc_cluster_tolerance)
    row = _grid_row("cluster_wide", "24 seeded blobs",
                    (cluster.pack_points(p, p_sq), d.valid, labels,
                     fl.euc_cluster_tolerance ** 2, fl.cluster_max_iters))
    print(f"kernel {row['name']} [{row['path']}: {row['shape']}]: equal to plain; {_times(row)} "
          f"[{card}]")
    check_k4(dev, rng, c, n_valid, fl.euc_cluster_tolerance ** 2, card)
    loop_crossover(dev, card)
    return [row], launches


def _blob_cloud(rng, c: int, n_valid: int):
    """A front-compacted cluster buffer of ``n_valid`` points in 24 seeded
    blobs (sigma 0.1 m) over the arena's 4.5 x 3.78 m, x-sorted as a
    lattice-ordered cloud arrives, on the CPU."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud

    centers = rng.uniform([0.0, 0.0, -0.2], [4.5, 3.78, 0.2], (24, 3))
    pts = np.zeros((c, 3), np.float32)
    pts[:n_valid] = rng.normal(centers[rng.integers(0, 24, n_valid)], 0.1)
    pts[:n_valid] = pts[:n_valid][np.argsort(pts[:n_valid, 0], kind="stable")]
    return Cloud(points=torch.tensor(pts), valid=torch.tensor(np.arange(c) < n_valid))


def loop_fit(lib) -> int:
    """The largest capacity (a multiple of 128, up to 16,384) at which the
    loop kernel's thread-block cluster, every block holding all points,
    fits this card."""
    return max((c for c in range(128, 16_385, 128) if lib.pcp_cluster_loop_blocks(c, 0) > 0),
               default=0)


def loop_crossover(dev, card: str) -> None:
    """The forms of the full-sweep loop on the same seeded buffers at the
    LOOP_CROSSOVER capacities and the largest the loop kernel fits, 5/8 and
    all of the rows valid: the grid-wide loop kernel everywhere, the loop
    kernel (one thread-block cluster) where it fits, and the per-sweep path
    (one K4 launch, the hook in PyTorch and a host read a sweep) above
    ``ops.cluster.LOOP_MAX_CAPACITY``.  Each form's labels, ``unconverged``
    and sweeps must equal ``cluster_loop_plain``'s on the same inputs
    exactly; each is timed with CUDA events over 10 calls (``loop
    crossover:`` lines, from which ``LOOP_MAX_CAPACITY`` is read)."""
    from pointcloud_obstacle_processing_tpu_torch import _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    lib = _build.kernels()
    fit = loop_fit(lib)
    tol, iters = fl.euc_cluster_tolerance, fl.cluster_max_iters
    rng = np.random.default_rng(8)
    for c in sorted({*LOOP_CROSSOVER, fit}):
        for n_valid in (c * 5 // 8, c):
            cloud = _blob_cloud(rng, c, n_valid).to(dev)
            p, p_sq, labels = cluster._seed_labels(cloud.points, cloud.valid, tol)
            args = (cluster.pack_points(p, p_sq), cloud.valid, labels, tol ** 2, iters)
            forms = {"grid-wide loop": cluster.grid_loop}
            if c <= fit:
                forms["loop kernel"] = cluster.loop_kernel
            if c > cluster.LOOP_MAX_CAPACITY:
                forms["per-sweep K4"] = cluster.per_sweep_loop
            g = cluster.cluster_loop_plain(*args)
            for k, f in forms.items():
                o = f(*args)
                _assert_equal(f"loop crossover C {c} {k} labels", o.labels, g.labels)
                if (bool(o.unconverged), int(o.sweeps)) != (bool(g.unconverged), int(g.sweeps)):
                    raise AssertionError(f"loop crossover C {c} {k}: unconverged/sweeps differ "
                                         "from the plain loop's")
            times = ", ".join(f"{k} {_time_ms(lambda f=f: f(*args), 10):.4f} ms"
                              for k, f in forms.items())
            print(f"loop crossover: C {c} ({n_valid} valid, {int(g.sweeps)} sweeps, every form "
                  f"equal to the plain loop; loop "
                  f"kernel blocks {lib.pcp_cluster_loop_blocks(c, 0)}; limit "
                  f"{cluster.LOOP_MAX_CAPACITY}, fit {fit}): {times} [{card}]")



def _k1_batch_row(path, a, kw):
    """K1 on the batch's own sorted keys and packed payloads."""
    from pointcloud_obstacle_processing_tpu_torch.ops import runreduce

    skey, offs, sentinel, cap = a
    vk, nk = runreduce.sorted_run_reduce(*a, **kw)
    vp, np_ = runreduce.sorted_run_reduce_plain(*a, **kw)
    _assert_equal(f"K1 runreduce {path} run counts", nk, np_)
    err, kept = 0.0, 0
    for b, n_runs in enumerate(np_.tolist()):
        k = min(n_runs, cap)
        kept += k
        err = max(err, _assert_equal(f"K1 runreduce {path} scan {b}", vk[b, :k], vp[b, :k]))
    scans, n = skey.shape
    w = runreduce.default_group(n) * 128
    return _row(
        "runreduce", path, f"{scans} x {n} rows, {w}-row windows, {kept} runs, cap {cap}",
        "runreduce.cu", "pallas_runreduce.py:301", err,
        lambda: runreduce.sorted_run_reduce(*a, **kw),
        lambda: runreduce.sorted_run_reduce_plain(*a, **kw),
        # keys + two payloads in, the filled slots and num out; 4 channels x
        # log2(w) Hillis-Steele adds a row
        _bound(scans * n * 12 + kept * 20 + scans * 4, 4 * scans * n * int(np.log2(w))),
        plain_reps=3,
    )


def _k2_batch_row(path, a):
    """K2 on the batch's own non-plane clouds."""
    from pointcloud_obstacle_processing_tpu_torch.ops import compaction

    bins, occ2d, cap = a
    lk, nk, vk = compaction.compact_and_gather_exact(*a)
    lp, np_, vp = compaction.compact_and_gather_plain(*a)
    _assert_equal(f"K2 compaction {path} counts", nk, np_)
    err, kept = 0.0, 0
    for b, num in enumerate(np_.tolist()):
        k = min(num, cap)
        kept += k
        _assert_equal(f"K2 compaction loc {path} scan {b}", lk[b, :k], lp[b, :k])
        err = max(err, _assert_equal(f"K2 compaction vals {path} scan {b}", vk[b, :k], vp[b, :k]))
    scans, c, nv = bins.shape
    occ = occ2d.reshape(scans, nv)
    return _row(
        "compact_gather", path, f"{scans} x {nv} -> {cap} slots, {kept} occupied",
        "compaction.cu", "pallas_compaction.py:185", err,
        lambda: compaction.compact_and_gather_exact(*a),
        lambda: compaction.compact_and_gather_plain(*a),
        # the masks once; each filled slot's channels read, loc and vals written; num
        _bound(scans * nv + kept * (4 * c + 4 + 4 * c) + scans * 4, 0),
        library_fn=lambda: bins.transpose(1, 2)[occ],  # boolean-mask gather
    )


def loop_blocks(args, card: str) -> None:
    """The loop kernel on the batch's own cluster buffers, and on its first
    scan alone, with 1, 2, 4, 8 and 16 blocks a scan (each equal to the
    plain loop): call time over 10 calls and device time.  The blocks a
    scan the loop kernel launches (``ops.cluster.loop_kernel``) are read
    off these lines."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    c = args[0].shape[-2]
    first = tuple(a[:1] if isinstance(a, torch.Tensor) else a for a in args)
    for what, a in ((f"{args[0].shape[0]} scans", args), ("its first scan", first)):
        want = cluster.cluster_loop_plain(*a)
        for nb in LOOP_BLOCKS:
            if not cluster._loop_blocks(c, nb):
                print(f"loop blocks: {nb} a scan does not fit at C {c} [{card}]")
                continue
            got = cluster.loop_kernel(*a, blocks=nb)
            _assert_equal(f"loop blocks {nb} labels ({what})", got.labels, want.labels)
            if not torch.equal(got.sweeps.cpu(), want.sweeps):
                raise AssertionError(f"loop blocks {nb} ({what}): sweeps differ")
            ms = _time_ms(lambda: cluster.loop_kernel(*a, blocks=nb), 10)
            dev_ms = _device_ms(lambda: cluster.loop_kernel(*a, blocks=nb), 10)
            print(f"loop blocks: {nb} a scan, the batch's non-plane clouds, {what}, C {c}: "
                  f"call {ms:.4f} ms, device {_ms(dev_ms)} [{card}]")


def run_batch(dev, card: str) -> tuple[dict, list[dict]]:
    """Phase 7: the batched flagship.  Returns the path's launches and the
    kernel rows at B = 32."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster, compaction, outliers, voxel
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
    from pointcloud_obstacle_processing_tpu_torch.types import scan_of

    n = cfg.max_points
    scenes = [_scene(s) for s in range(BATCH_SCENES)]
    pts = np.zeros((BATCH, n, 3), np.float32)
    valid = np.zeros((BATCH, n), bool)
    for b in range(BATCH):
        p = scenes[b % BATCH_SCENES].points[:n]
        pts[b, : len(p)] = p
        valid[b, : len(p)] = True
    clouds = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))
    u = np.random.default_rng(RANSAC_SEED).random(
        (BATCH, cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    u = torch.tensor(u, device=dev)
    draw = draw_from_uniform(u)
    pipe = batched_pipeline(cfg)

    def run(c, draw):
        return pipe(c, draw=draw)

    # main path: counts from 0, one batch
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_loop"]
    _build.reset_launch_counts()
    res = run(clouds, draw)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches[k] != 1 for k in path) or not launches["xla_sum"] or \
            not launches["plane_refine"]:
        raise AssertionError(f"batched flagship: each of {path} must launch once a batch, "
                             f"the sum kernel and the 3x3 tail at least once, got {launches}")
    worst = 0.0
    for b in range(BATCH):
        rb = scan_of(res, b)
        _check_overflows(f"batch scan {b}", rb)
        _check_rocks(scenes[b % BATCH_SCENES], rb)
        one = process_scan(scan_of(clouds, b), cfg, draw=draw_from_uniform(u[b]))
        worst = max(worst, _compare(f"batch scan {b}", rb, one))
        _assert_equal(f"batch scan {b} point_cluster", rb.clusters.point_cluster,
                      one.clusters.point_cluster)
    counts = {k: getattr(res.stats, k).sum().item() for k in _COUNTS}
    print(f"flagship batch of {BATCH}: each scan == its single-scan card run (grid, counts, "
          f"flags, point clusters exact; centroid max |d| {worst:.2e}); summed counts {counts}; "
          f"launches {launches} [{card}]")

    n_sync, res = _count_syncs(run, clouds, draw)
    _check_syncs("flagship batch", n_sync, res, expected=0)
    times = _time_scans(run, [clouds], draw, BATCH_TIMED)
    p50 = statistics.median(times)
    n_ops, dev_ms = scan_device_ops(run, clouds, draw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run(clouds, draw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"flagship batch p50 {p50:.3f} ms per batch of {BATCH} over {len(times)} batches "
          f"(min {min(times):.3f}, max {max(times):.3f}); {BATCH / p50 * 1e3:.1f} scans per "
          f"second; host syncs per batch {n_sync}; device operations per batch {n_ops} "
          f"({_ms(dev_ms)} of device time, busy "
          f"{'not measured' if dev_ms is None else f'{100 * dev_ms / p50:.1f}%'} of the p50); peak "
          f"device memory {peak / 2**20:.1f} MiB [{card}]")

    # the four kernels at B = 32 on the inputs the batch gives them
    def once():
        run(clouds, draw)

    (k1,) = _capture(voxel, "sorted_run_reduce", once)
    (k2,) = _capture(compaction, "compact_and_gather_exact", once)
    (k3,) = _capture(outliers, "knn_mean", once)
    (lp,) = _capture(cluster, "cluster_loop", once)
    sums, tails = capture_refine(once)
    rows = [
        _k1_batch_row("flagship_batch", *k1),
        _k2_batch_row("flagship_batch", k2[0]),
        _k3_row("flagship_batch", f"the batch's voxel clouds ({BATCH} scans)", k3[0]),
        _loop_row("flagship_batch", "the batch's non-plane clouds", lp[0]),
        _sum_row("flagship_batch", sums),
        _tail_row("flagship_batch", tails),
    ]
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    loop_blocks(lp[0], card)
    return launches, rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    if not (ROOT / PKG).is_dir():
        raise SystemExit(f"chip_smoke: {PKG}/ not found beside the script")
    sys.path.insert(0, str(ROOT))
    from pointcloud_obstacle_processing_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    card = f"{name}; nvidia-smi: {smi}"
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(smi)
    t0 = time.perf_counter()
    _build.kernels()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {sum(_build.BUILD_SECONDS):.1f} s)")

    t = time.perf_counter()
    rows = check_kernels(dev, card)
    print(f"phase 2 (kernel checks): {time.perf_counter() - t:.1f} s")
    launches = {}
    banded = None

    def fullscale(dev, card):
        nonlocal banded
        out, scan_rows, banded = run_fullscale(dev, card)
        return out, scan_rows

    for phase, path, run in ((3, "flagship", run_flagship), (4, "fullscale", fullscale),
                             (5, "fullscale_bandoff",
                              lambda dev, card: run_fullscale_bandoff(dev, card, banded))):
        t = time.perf_counter()
        launches[path], scan_rows = run(dev, card)
        for r in scan_rows:
            print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
                  f"[{card}]")
        rows += scan_rows
        print(f"phase {phase} ({path}): {time.perf_counter() - t:.1f} s")
    banded = None
    t = time.perf_counter()
    wide_rows, launches["cluster_wide"] = run_cluster_wide(dev, card)
    rows += wide_rows
    print(f"phase 6 (cluster_wide): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    more_rows, more_launches = run_segscan_binning(dev, card)
    rows += more_rows
    launches.update(more_launches)
    print(f"phase 7 (segscan, binning): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches["flagship_batch"], batch_rows = run_batch(dev, card)
    rows += batch_rows
    print(f"phase 8 (flagship batch): {time.perf_counter() - t:.1f} s")

    for r in rows:
        r["launches"] = launches[r["path"]][r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on the {r['path']} path")
    keys = ("name", "path", "shape", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "library_host_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
