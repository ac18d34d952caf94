#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the flagship scan, the
fullscale 2M-point window (banded, and with the band off), the flagship
batch of 32, the segmented scan and weighted binning entry points, the
node (sensor frames to a published grid) at the flagship and fullscale
widths, the multi-device paths (point-sharded scans, the voxel-table
merges, data parallel) on 4 ranks sharing the card, a batch of two
fullscale windows, the flagship scan with each kNN engine, and the voxel
engines off the sort engine's lattice order (``mxu``, ``scatter``, Morton,
the 3-key fallback), the shadow stage's two kernels with the
reference's trigonometry, the fused multiply-add chain kernel on
near ties, and RANSAC's round kernels.

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
   kernel, the sum kernel (once a call of ``sum_like_xla``) and RANSAC's
   refinement step (``covariance_tail``: the covariance sums with the 3x3
   tail as their epilogue, once a call) were launched, that
   no overflow flag is set and that each rock of the scene is matched by a
   cluster, and compares each scan with the same scan through the plain
   versions on the CPU (same RANSAC draws): grid, stage counts and flags
   exact, centroids within 1e-5.  Times ``process_scan`` per scan (p50),
   counts its host syncs, which must be none, and its device operations
   (kernels, memsets, copies; ``torch.profiler``).  Then K3, the loop
   kernel, the sum kernel (every call of a scan held bitwise, each call
   shape timed beside ``.sum(-1)``) and ``covariance_tail`` (every call)
   again, checked and timed as in phase 2, on the inputs the scan of scene
   0 gives them.
4. Fullscale path: counts from 0, one scan of the canonical fullscale
   window (``make_fullscale_window(2_097_152)``) through
   ``ObstacleDetectionModel(REFERENCE_FULLSCALE_CONFIG)`` on the card;
   checks that K1, K2, K3, K5, the sum kernel and ``covariance_tail`` were
   launched (once a call each)
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
   K1, K2, K3, the loop kernel, the sum kernel and ``covariance_tail`` at B = 32 on
   the inputs the batch gives them, checked and timed as in phase 2 (path
   ``flagship_batch``), and the loop kernel with 1, 2, 4, 8 and 16 blocks
   a scan (``loop blocks:`` lines).

9. The node (``runtime.driver.ObstacleDetectionNode``), fed by the
   launch's ``SyntheticKinect`` over the in-process bus.  The flagship node
   (``FLAGSHIP_CONFIG.replace(accumulate_count=16)``, 6,272-point frames,
   ``publish_point_clouds`` off) in the four modes (sync or async, host or
   device accumulation): 2 warm-up and 10 measured windows of frames back
   to back (windows and frames per second, window p50 from the trigger
   frame to the publish, trigger-callback p50, upload and fetch bytes a
   window), the host syncs that sync debug mode flags in one trigger
   callback and its dispatch (none in async + device mode), the kernels'
   launches in one window (counts from 0 around its trigger), and 5
   windows at a sensor cadence (a sleep after each frame of 1.5 x the sync
   trigger p50 / 16): ``t_async / t_sync`` from their trigger p50s.  The
   sync and async grids are equal window by window; every sync device-mode
   window equals a direct ``process_frames`` of its frames; one card
   window equals the port's CPU node on the same frames (the crosscheck
   bar); one window with ``publish_point_clouds`` publishes the five debug
   clouds.  Every node's host accumulator is the native one.  Then the
   fullscale node through ``launch(config=REFERENCE_FULLSCALE_CONFIG,
   points_per_frame=10_000)`` (200 frames a window, host accumulation;
   device accumulation is refused, 2,097,152 % 200 != 0), sync and async,
   1 warm-up and 3 measured windows: each window equals a direct
   ``process_scan`` of the accumulator's snapshot with the node's draw,
   sync and async grids are equal, and the rates, p50s and bytes as
   above.  The node paths' kernels (K1-K3 and the loop kernel, or K5; the
   sum kernel and ``covariance_tail``) are checked and timed on one window's
   inputs (paths ``node_flagship`` and ``node_fullscale``, launches a
   window), and a ``node:`` line holds the phase's numbers as JSON.

10. The multi-device paths on 4 gloo ranks sharing the one card
   (``parallel.ranks.spawn``; the kernels are built before the spawn,
   every process group and the join have a timeout; NCCL refuses two ranks
   on one card, so these times are no multi-GPU speed).  Each job runs 4
   windows, counts from 0 on each rank around the first: the flagship
   scan over 4 x 25,088-point shards (the dense merge, K3 and K4's
   per-sweep kernel over each rank's rows), the fullscale window over 4 x
   524,288-point shards with the key-range distributed merge (the default
   at 4 shards) and again with ``distribute_merge=False`` (both run K1's
   counts mode; K5 over each rank's tiles), ``dp_sp_pipeline`` on a 2x2
   mesh of 4 flagship scans, ``data_parallel_pipeline`` on 2 ranks x 16
   flagship scans, and the window's voxel tables merged both ways (one
   warm-up window, checked, then 3 timed).  Checks:
   the path's kernels launched on every rank; every rank of a ``points``
   row holds the same result; each card run equals the same run on 4 gloo
   CPU ranks (the crosscheck bar and every point's cluster); the two
   merges agree (keys, counts and ``num`` exact, sums within 1e-5); the
   sharded flagship and fullscale scans keep the single-scan card run's
   structure (tests/test_sharding.py:61-84's bar); ``data_parallel_pipeline``
   equals ``batched_pipeline`` bitwise.  Then K1's counts mode (both merge
   shapes), K2 on the dense merge's bins, K3, K4 and K5 over rank 0's
   rows, and the sum kernel and ``covariance_tail`` (every call of the two
   sharded scans' first window) on rank 0's own inputs, held bitwise against their plain versions
   and timed as in phase 2 (paths ``sp_flagship``, ``sp_fullscale``,
   ``sp_fullscale_replicated``).  A ``sharded:`` line a path gives the
   backend and staging, windows per second, the p50, collective bytes and
   calls a window and the host reads; a ``sharded:`` JSON line holds them.

11. The fullscale batch and the kNN engines.  Counts from 0, one call of
   ``batched_pipeline(REFERENCE_FULLSCALE_CONFIG)`` on two fullscale
   windows (``make_fullscale_window`` arenas 100 and 101, a RANSAC draw of
   its own for each): the banded cluster loop launches K5 once a sweep for
   the whole batch, the scan a grid dimension, as many times as the slower
   window's single run sweeps (not their sum), with at most the sweeps
   less one host reads; each window equals its single-window card run by
   phase 8's bar (the crosscheck bar, every point's cluster exact; arena
   101 overflows the band in both runs, and no window overflows a
   capacity).  The
   batch p50 over 5 batches, windows per second against the single
   window's (timed in the same call) and peak device memory; then batched
   K5 on every sweep of the batch held bitwise against its plain version
   and timed (path ``fullscale_batch``).  Then the flagship scan of scene
   0 with each kNN engine off the sorting network (``knn_backend``
   ``exact``, ``approx``, ``banded_approx``; ``banded`` with
   ``statistical_outlier_mean_k=20``; ``downsample_input_data=False``,
   whose cropped cloud overflows the 24,576 voxel slots as in the
   reference): none launches K3, each card run equals the port's CPU run
   (grid, counts and flags exact, the kNN mean distances bitwise), and
   each engine's kNN stage p50 (CUDA events) on a ``knn engines:`` line.

12. The voxel engines, each path with the counts from 0 and held against the
   same run through the plain versions on the CPU (the crosscheck bar,
   every point's cluster, the voxel cloud and the voxel partials exact):
   the flagship scan of scene 0 under ``voxel_binning="mxu"`` (payload
   packing off, ``voxel_sum_precision`` "fast" and "exact") and
   ``"scatter"`` and under ``voxel_order="morton"``; the fullscale window
   under ``scatter`` and Morton (``mxu`` must raise there, its lattice
   past 2^19 bins; under Morton the band may overflow, as on the CPU);
   the flagship scan at a 0.01 leaf (452 x 380 x 77 bins, past 2^23: the
   3-key fallback; 98,304 voxel slots, a 16,384-point cluster buffer);
   and a ``batched_pipeline`` of 4 flagship scans under ``scatter``, each
   equal to its single card run.  Checks the segment fold kernel's
   launches (one a scan or batch: ``mxu`` fast and exact, ``scatter``, the
   fallback and the batch), K2 on the dense bins and K1 for Morton; prints
   the scan p50 (5 scans, 3 at fullscale), the voxel stage's p50 beside the
   sort engine's, the host syncs and the peak device memory of each path
   (``voxel engine`` lines, a ``voxel engines:`` JSON line).  Then the
   segment fold on every call of each path held bitwise against its plain
   version on a CPU copy, one device operation a call, and timed in three
   forms beside its bound, the plain version (CPU) and CUDA's
   ``index_add_``: the fused call (the sort's permutation and the split
   terms inside), the unfused form (the gather, the split passes, a fold
   launch a term, the add) and that form's fold launches alone (a
   ``segment fold forms:`` JSON line); K2 on the dense bins and K1 on the
   Morton keys, checked and timed as in phase 2.
13. The shadow stage's kernels (``csrc/shadow.cu``): ``shadow_slots`` and
   ``shadow_raster`` bitwise their plain twins on a CPU copy of seeded
   inputs at the flagship, fullscale and batch-of-32 shapes and of the
   edge scan (``utils/shadow_cases.py``), the raster timed there by device
   time beside its bound (``raster seeded`` lines); the card's ``asin_like_xla`` and
   ``tanf`` (``csrc/libm32.cuh``) bitwise the plain forms on every 509th
   float32 of their domains; the stage's device operations and times on
   the flagship scan's own inputs before (the stage's earlier eager form,
   with CUDA's ``asinf``/``tanf``) and after; and the active slots of the
   flagship and fullscale scans whose ``d`` or line CUDA's own trig would
   change.  Every scan path of phases 3-10 counts both kernels among its
   launches, and phases 3, 4, 8 and 9 hold them against their plain twins
   on the path's own inputs and time them as in phase 2.  Every scan path
   also counts ``fma_chain`` (``csrc/fma_chain.cu``: ``ops.fma`` and the
   chain helpers, one launch a call) among its launches; the scan paths
   of phases 3-5, 8, 9 and 11 hold each of their run's ``fma_chain`` calls bitwise
   against the plain form on a CPU copy (``capture_ransac``), and phases
   3, 4 and 8 time the largest of them (the voxel key) as in phase 2,
   beside ``torch.addcmul``.
14. ``fma_chain`` on the card bitwise its plain form on ``utils/fma_cases.py``'s
   seeded near ties (triples, triples with a float32-subnormal result, and
   ``dot3``/``sum_sq3``/``add_sq3`` operands whose second step is a near
   tie), one launch a call, with how many of them the double-rounded form
   (the float64 sum rounded to float32) misses; then the wrapper's host
   time a call (``_host_ms``) at two of a flagship scan's call shapes (the
   voxel key's ``fma`` with a constant; a [1, 128] ``dot3``, the shape of
   RANSAC's hypothesis offset where the round computes it eagerly), with
   its cached launch plan, with the cache cleared before every call, and
   part by part (``_fma_host_parts``; ``fma_chain host`` lines).
15. RANSAC's kernels (``csrc/ransac_score.cu``): ``ransac_hypotheses_score``
   (a round's hypotheses built from the draws, gated, scored and selected
   in one launch), ``plane_inliers`` (the winner's and the refinement's
   masks) and ``plane_inliers_close`` (the round's last mask, applied to
   the loop's state in place) bitwise their plain versions on a CPU copy
   of ``utils/ransac_cases.py``'s seeded rounds (``round_case``: points
   within 8 ulps of the threshold of a drawn plane, tied counts,
   degenerate draws, NaN coordinates on invalid rows; K from 1 to 1,100;
   the axis gate in radians and in degrees; twice a case, and once more
   with the gated counts and the winner's index written) and seeded loop
   states; then on every call of each scan path's own run (flagship,
   fullscale, band off, the batch of 32, the nodes, the fullscale batch of
   2; every call against the plain version on the card, the first also on
   a CPU copy; the calls' arguments cloned as they are made), with the
   launches of the path's counted run checked against its known runs
   (``ransac_hypotheses_score`` and ``plane_inliers_close`` once a round,
   ``plane_inliers`` ``ransac_refine_iters`` times, ``max_planes`` rounds
   a run; ``fma_chain`` 29 times a scan or batch), each timed as in phase
   2 beside the plain version on the card (the closing mask on a fresh
   copy of its state each call, so each timed call is the path's own
   first); the score kernel's forms (rows a thread, hypotheses a z-slice)
   on each path's first round, each bitwise the wrapper's, by device time
   (``score forms`` lines), and the score wrapper's host time part by part
   (``score host`` lines); then ``segment_planes`` on each path's own
   input with the kernels (no ``fma_chain`` launch) and with the plain
   versions: device operations, device time and peak device memory
   (``ransac stage`` lines; the parent commit's round is timed against
   this one by ``scripts/torch_shadow_fma_ab.py --measures stage``).

Each phase prints its seconds.
Its last line is ``{"ok": true, "device": {...}}``; the line before it is
the JSON list of kernels, one entry per kernel and path, with launches on
that path, errors, times and the bound (the card's least time for the
work, from the package's ``utils/bounds.py``).  There is no CPU fallback:
without a CUDA card the script raises.
"""

from __future__ import annotations

import gc
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
# the node (phase 9): the flagship node takes 16 frames of 6,272 points a
# window (16 x 6,272 = 100,352 = FLAGSHIP_CONFIG.max_points, so device
# accumulation applies); the fullscale node the shipped 200 frames of 10,000
NODE_FRAMES, NODE_FRAME_POINTS = 16, 6_272
NODE_WARMUP, NODE_WINDOWS, NODE_CADENCE_WINDOWS = 2, 10, 5
FULLSCALE_FRAME_POINTS = 10_000
FULLSCALE_NODE_WARMUP, FULLSCALE_NODE_WINDOWS = 1, 3
NODE_MODES = ((False, False), (False, True), (True, False), (True, True))  # (async, device)
SHADOW_PATH = ["shadow_slots", "shadow_raster"]  # the shadow stage's kernels, on every scan path
# the kernels every scan path launches: the shadow stage's, and the fused
# multiply-add chains (``ops.fma``, many launches a scan)
# RANSAC's kernels, on every scan path: each round's hypotheses built, gated,
# scored and selected in one launch; the winner's and the refinement's masks;
# the mask that closes the round
RANSAC_PATH = ["ransac_hypotheses_score", "plane_inliers", "plane_inliers_close"]
SCAN_PATH = [*SHADOW_PATH, "fma_chain", *RANSAC_PATH]
# fma_chain launches a scan (or batch) of the flagship, fullscale and batch
# paths: RANSAC's round makes none since its score kernel builds the
# hypotheses (it made 5 a round, 49 a scan, before)
FMA_A_SCAN = 29
SHADOW_SWEEP_STRIDE = 509  # phase 13: every 509th float32 of the trig routines' domains
# phase 13: the cast_shadows calls of one scan, by path (captured in phases 3 and 4)
SHADOW_SCANS: dict = {}
# phase 15: RANSAC's calls of one run, by path (``capture_ransac``), and the
# RANSAC configuration of each path
RANSAC_RUNS: dict = {}


def _mode_name(async_mode: bool, device_mode: bool) -> str:
    return f"{'async' if async_mode else 'sync'}+{'device' if device_mode else 'host'}"


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


def _warm_card(seconds: float = 1.0) -> None:
    """Elementwise passes over 256 MB for about ``seconds``, so that the
    card's clocks have left idle before timings of short kernels that follow
    host work (no matrix product: cuBLAS would keep a workspace allocated
    and lift the later peak-memory readings)."""
    import torch

    x = torch.ones(1 << 26, device="cuda")
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        for _ in range(20):
            x.mul_(0.5).add_(0.5)
        torch.cuda.synchronize()


PROFILER_SESSIONS = 5  # torch.profiler sessions tried before a device time is "not measured"


def _profiled_device_events(fn, reps: int = 1) -> list:
    """The device's kernels, memsets and copies (``torch.profiler``) while
    ``fn`` runs, ending in a synchronize.  A session runs ``fn`` twice: a
    warm-up step whose events are dropped, then the recorded step.  In a
    long process a session can lose events (a one-operation call counted
    as 0.35-0.45 operations) or record none; a session whose count is not
    a whole multiple of ``reps`` (the identical calls inside ``fn``) is
    taken again, up to PROFILER_SESSIONS times, and then the list is
    empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    counts = []
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own span on the device timeline is no operation
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")]
        if events and len(events) % reps == 0:
            return events
        counts.append(len(events))
    print(f"torch.profiler recorded {counts} device events in {PROFILER_SESSIONS} sessions of "
          f"{reps} call(s): device time not measured")
    return []


def _device_profile(fn, reps: int = 20) -> tuple[float | None, float | None]:
    """``(device ms a call, device operations a call)`` from
    ``torch.profiler`` over ``reps`` calls after a warm-up: the summed
    durations of the device's kernels, memsets and copies, and their count,
    each over ``reps`` (``(None, None)`` where no session recorded a whole
    count, ``_profiled_device_events``)."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    events = _profiled_device_events(run, reps)
    if not events:
        return None, None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps, len(events) / reps


def _device_ms(fn, reps: int = 20) -> float | None:
    """Device time per call (``_device_profile``).  Unlike ``_time_ms`` it
    leaves out the host's gaps between launches."""
    return _device_profile(fn, reps)[0]


def _graph_device(fn, reps: int = 20) -> tuple[float | None, int | None]:
    """``(graph ms a call, device operations a call)`` of ``fn`` from CUDA
    graphs: one call captured and its nodes counted (the driver's
    ``cuGraphGetNodes``), and ``reps`` calls captured and replayed between
    two CUDA events, so the device runs them back to back with no host
    gap.  The graph time includes each node's start on the device, so it
    is not ``_device_ms`` (the kernels' own durations) and is reported
    under its own name.  ``(None, None)`` where ``fn`` cannot be
    captured."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        one = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(one):
            fn()
        count = ctypes.c_size_t(0)
        err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(one.raw_cuda_graph()), None, ctypes.byref(count))
        ops = count.value if err == 0 else None
        many = torch.cuda.CUDAGraph()
        with torch.cuda.graph(many):
            for _ in range(reps):
                fn()
    except (RuntimeError, OSError, AttributeError, TypeError) as e:
        print(f"CUDA graph capture failed ({e}): graph device time not measured")
        return None, None
    many.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    replays = 5
    start.record()
    for _ in range(replays):
        many.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * reps)
    # the graphs' memory pools go now, before a later peak-memory reading
    del one, many
    gc.collect()
    torch.cuda.empty_cache()
    return ms, ops


def _kernel_us(fn, reps: int = 20) -> dict:
    """Launches and device time (us) a call of each kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls (empty where no session
    recorded a whole count)."""
    import re

    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    out: dict = {}
    for e in _profiled_device_events(run, reps):
        names = re.findall(r"::(\w+)", e.name)
        key = names[0] if names else e.name[:40]
        n, us = out.get(key, (0.0, 0.0))
        out[key] = (n + 1 / reps, us + e.time_range.elapsed_us() / reps)
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


def _bound(name: str, *args, **kw) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the card's least time for a kernel's work,
    ``utils.bounds.<name>(*args, **kw)`` (the H100's data-sheet peaks and
    the work counted from the shapes and this run's data) in ms."""
    from pointcloud_obstacle_processing_tpu_torch.utils import bounds

    seconds, limiter = getattr(bounds, name)(*args, **kw)
    return seconds * 1e3, limiter


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
    bound = _bound("runreduce", n, k, w)
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
        _bound("compact_gather", nv, min(int(nk), ccap), c),
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
        "knn_mean", path, f"{what}, row tile {rt}, window {width}, k {k}, {live_tiles} live tiles",
        "knn_select.cu", "outliers.py:142", err,
        lambda: outliers.knn_mean(*args),
        lambda: outliers.knn_mean_plain(*args),
        _bound("knn_mean", nv, tiles, tiles, live_tiles, rt, width, scans),
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


def capture_shadow(call) -> tuple[tuple, tuple, tuple]:
    """The arguments of the one call ``call()`` (a scan, batch or window)
    makes to ``pipeline.cast_shadows``, and of the stage's calls to
    ``ops.shadow.shadow_slots`` and ``shadow_raster``."""
    from pointcloud_obstacle_processing_tpu_torch import pipeline
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    slots, raster = [], []
    stage = _capture(pipeline, "cast_shadows", lambda: slots.extend(_capture(
        shadow, "shadow_slots", lambda: raster.extend(_capture(shadow, "shadow_raster", call)))))
    ((stage_args, _),), ((s_args, _),), ((r_args, _),) = stage, slots, raster
    return stage_args, s_args, r_args


def _shadow_rows(path: str, what: str, s_args, r_args) -> list[dict]:
    """The shadow kernels on a path's own inputs: each held bitwise against
    its plain twin on a CPU copy (and the twin run on the card against the
    same), then timed as in phase 2; the library call is none (no PyTorch
    call computes either step)."""
    from pointcloud_obstacle_processing_tpu_torch.ops import shadow

    pts, ok, pc, sv, tf, cfg = s_args
    grid, lines, opacity = r_args
    want = shadow.shadow_slots_plain(pts.cpu(), ok.cpu(), pc.cpu(), sv.cpu(), tf.to("cpu"), cfg)
    err = _assert_equal(f"shadow_slots {path} ({what})", shadow.shadow_slots(*s_args), want)
    _assert_equal(f"shadow_slots_plain {path} on the card", shadow.shadow_slots_plain(*s_args), want)
    want_grid = shadow.shadow_raster_plain(grid.cpu(), lines.cpu(), opacity)
    err = max(err, _assert_equal(f"shadow_raster {path} ({what})", shadow.shadow_raster(*r_args),
                                 want_grid))
    _assert_equal(f"shadow_raster_plain {path} on the card", shadow.shadow_raster_plain(*r_args),
                  want_grid)
    scans, c, m = pts[..., 0, 0].numel(), pts.shape[-2], sv.shape[-1]
    h, w = grid.shape[-2:]
    active = int(lines[..., 6].sum())
    return [
        _row("shadow_slots", path, f"{what}: {scans} x {c} cluster points, {m} slots",
             "shadow.cu", "shadow.py:100 (per_cluster; plain XLA, no TPU kernel)", err,
             lambda: shadow.shadow_slots(*s_args), lambda: shadow.shadow_slots_plain(*s_args),
             _bound("shadow_slots", scans, c, m), plain_reps=5),
        _row("shadow_raster", path, f"{what}: {scans} x {h} x {w} cells, {m} slots, {active} active",
             "shadow.cu", "shadow.py:142 (the sweep raster; plain XLA, no TPU kernel)", err,
             lambda: shadow.shadow_raster(*r_args), lambda: shadow.shadow_raster_plain(*r_args),
             _bound("shadow_raster", scans, m, h, w), plain_reps=5),
    ]


def capture_fma(call) -> list:
    """Every call ``call()`` makes to ``ops.fma_chain`` (looked up at call
    time by the chain helpers), as (pairs, addend, the card's result and
    CPU copies of the operands, both taken as the call returns, and the
    caller's ``file:line`` in the port, outside ``ops/__init__.py``)."""
    from pointcloud_obstacle_processing_tpu_torch import ops

    seen, fn = [], ops.fma_chain

    def spy(pairs, c=None):
        out = fn(pairs, c)
        f = sys._getframe(1)
        while f.f_code.co_filename == ops.__file__:
            f = f.f_back
        seen.append((pairs, c, out.cpu(), [(a.cpu(), b.cpu()) for a, b in pairs],
                     None if c is None else c.cpu(),
                     f"{Path(f.f_code.co_filename).name}:{f.f_lineno}"))
        return out

    ops.fma_chain = spy
    try:
        call()
    finally:
        ops.fma_chain = fn
    return seen


def _capture_cloned(module, name: str, call) -> list:
    """``_capture``, each tensor argument (and each of a ``RoundState``'s)
    cloned as the call is made: the mask that closes a RANSAC round updates
    the loop's state in place, and so later rounds change the valid mask an
    earlier call was given."""
    import torch

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(copy(x) for x in v))
        return v

    seen, fn = [], getattr(module, name)

    def spy(*a, **kw):
        seen.append((tuple(copy(x) for x in a), {k: copy(v) for k, v in kw.items()}))
        return fn(*a, **kw)

    setattr(module, name, spy)
    try:
        call()
    finally:
        setattr(module, name, fn)
    return seen


def capture_ransac(path: str, call, config, runs: int = 1) -> list:
    """Record the calls ``call()`` (a scan, batch or window) makes to
    ``pipeline.segment_planes`` and to ``ops.ransac.ransac_hypotheses_score``,
    ``plane_inliers`` and ``plane_inliers_close`` (each looked up at call
    time by its caller; their arguments cloned as each call is made) under
    ``path`` for phase 15, with ``config`` and ``runs``, the RANSAC runs
    (scans, batches or windows) of the path's counted main-path run.  Holds
    every ``ops.fma_chain`` call of ``call()`` bitwise against its plain
    form on a CPU copy of its operands, and returns those calls
    (``capture_fma``)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import ops, pipeline
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    scores, masks, closes, chains = [], [], [], []
    stage = _capture(pipeline, "segment_planes", lambda: scores.extend(_capture_cloned(
        ransac, "ransac_hypotheses_score", lambda: masks.extend(_capture_cloned(
            ransac, "plane_inliers", lambda: closes.extend(_capture_cloned(
                ransac, "plane_inliers_close", lambda: chains.extend(capture_fma(call)))))))))
    RANSAC_RUNS[path] = {"stage": stage[0], "score": [a for a, _ in scores], "mask": masks,
                         "close": [a for a, _ in closes], "config": config, "runs": runs}
    for i, (_, _, got, pairs, c, caller) in enumerate(chains):
        want = ops.fma_chain_plain(pairs, c)
        nan = torch.isnan(want)  # a NaN's payload is the device's own
        _assert_equal(f"fma_chain {path} call {i} of {len(chains)} ({caller}) NaNs",
                      torch.isnan(got), nan)
        _assert_equal(f"fma_chain {path} call {i} of {len(chains)} ({caller})",
                      got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])
    print(f"fma_chain {path}: every call of a run ({len(chains)}) equal to its plain form on a "
          f"CPU copy")
    return chains


def _fma_row(path: str, what: str, chains) -> dict:
    """The fused multiply-add chain kernel on the largest call of a path's
    run (``capture_ransac``'s calls, each already held bitwise against its
    plain form on a CPU copy), timed as in phase 2 beside the plain form on
    the card and ``torch.addcmul``, one elementwise pass over the call's
    first pair and its addend (the chain's accumulator where it has none):
    the yardstick, which does not round as the reference does."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import ops

    pairs, c, got, _, _, caller = max(chains, key=lambda r: r[2].numel())
    operands = [t for p in pairs for t in p] + ([] if c is None else [c])
    dev = next(t.device for t in operands if t.is_cuda)
    (a, b), acc = pairs[0], (got if c is None else c).to(dev)
    a, b = a.to(dev), b.to(dev)  # a 0-d constant on the card for addcmul
    shapes = " x ".join(str(tuple(t.shape)) for t in operands)
    return _row("fma_chain", path,
                f"{what}: the largest of {len(chains)} calls, {len(pairs)} pair(s)"
                f"{'' if c is None else ' and an addend'}, operands {shapes} -> "
                f"{tuple(got.shape)}", "fma_chain.cu",
                f"{caller.split(':')[0]} (the port's call at {caller}: XLA:CPU's fused "
                "multiply-add; plain XLA, no TPU kernel)", 0.0, lambda: ops.fma_chain(pairs, c),
                lambda: ops.fma_chain_plain(pairs, c),
                _bound("fma_chain", got.numel(), sum(t.numel() for t in operands), len(pairs)),
                library_fn=lambda: torch.addcmul(acc, a, b), plain_reps=5)


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
        _bound("cluster_sweep", c, c, n_valid, n_valid),
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
             + (f", {scans} scans, {int((sweeps * n_valid ** 2).sum())} valid pairs swept"
                if scans > 1 else ""))
    return _row(
        "cluster_loop", path, shape, "cluster_loop.cu", "cluster.py:86", err,
        lambda: cluster.cluster_loop(*args),
        lambda: cluster.cluster_loop_plain(*args),
        _bound("cluster_loop", c, n_valid.tolist(), sweeps.tolist()),
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
        _bound("cluster_grid_loop", c, n_valid.tolist(), sweeps.tolist()),
        plain_reps=2,
    )
    row["sweeps"] = int(sweeps.sum())
    return row


def _sum_rows(path, calls):
    """The sum kernel on every call a scan (or batch) made to it, each held
    bitwise against the plain version (one launch a call); each distinct
    call shape timed beside its library call, ``.sum(-1)`` of the same
    values (of the products, for two operands)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build, ops

    err, shapes = 0.0, {}
    for i, ((a, b), _) in enumerate(calls):
        _build.reset_launch_counts()
        got = ops._xla_sum_kernel(a, b)
        if _build.LAUNCHES["xla_sum"] != 1:
            raise AssertionError(f"sum kernel {path} call {i}: {_build.LAUNCHES['xla_sum']} "
                                 "launches, one expected")
        err = max(err, _assert_equal(f"sum kernel {path} call {i} ({tuple(a.shape)})",
                                     got.view(torch.int32),
                                     ops.sum_like_xla_plain(a, b).view(torch.int32)))
        key = (tuple(a.shape), a.stride(), None if b is None else (tuple(b.shape), b.stride()))
        shapes.setdefault(key, []).append(i)
    rows = []
    for idx in shapes.values():
        (a, b), _ = calls[idx[0]]
        lead, sa, n = a[..., 0, 0].numel(), a.shape[-2], a.shape[-1]
        sb = 1 if b is None else b.shape[-2]
        what = (f"{tuple(a.shape)}{'' if a.is_contiguous() else ' strided'}"
                + ("" if b is None else f" x {tuple(b.shape)}"))
        rows.append(_row(
            "xla_sum", path, f"{what}: {len(idx)} of the run's {len(calls)} calls, all equal",
            "xla_sum.cu", "ransac.py:174 (plain XLA, no TPU kernel)", err,
            lambda a=a, b=b: ops._xla_sum_kernel(a, b),
            lambda a=a, b=b: ops.sum_like_xla_plain(a, b),
            _bound("xla_sum", lead, sa, n, None if b is None else sb),
            library_fn=(lambda a=a: a.sum(-1)) if b is None else
            (lambda a=a, b=b: (a[..., :, None, :] * b[..., None, :, :]).sum(-1)),
            plain_reps=3,
        ))
    return rows


def _tail_row(path, calls):
    """RANSAC's refinement step (``covariance_tail``: the covariance sums
    and the 3x3 tail in one launch) on every call a run made to it, each
    held bitwise against ``sum_like_xla_plain`` then ``plane_tail_plain`` on
    the same inputs; one timed.  No one PyTorch call computes the step."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build, ops
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    def plain(masked, off, *rest):
        return ransac.plane_tail_plain(ops.sum_like_xla_plain(masked, off), *rest)

    err = 0.0
    for i, (args, _) in enumerate(calls):
        _build.reset_launch_counts()
        got = ransac.covariance_tail(*args)
        if _build.LAUNCHES["covariance_tail"] != 1 or _build.LAUNCHES["xla_sum"]:
            raise AssertionError(f"covariance_tail {path} call {i}: launches {_build.LAUNCHES}")
        for g, w in zip(got, plain(*args)):
            err = max(err, _assert_equal(f"covariance_tail {path} call {i}", g.view(torch.int32),
                                         w.view(torch.int32)))
    args = calls[0][0]
    b, n = args[0].shape[0], args[0].shape[-1]
    return _row(
        "covariance_tail", path, f"[{b}, 3, {n}] x [{b}, 3, {n}] and the 3x3 tail: "
        f"{len(calls)} calls a run, all equal; {b} scan(s) a call",
        "xla_sum.cu", "ransac.py:184-195 (plain XLA, no TPU kernel)", err,
        lambda: ransac.covariance_tail(*args), lambda: plain(*args),
        _bound("covariance_tail", b, n), plain_reps=3,
    )


def capture_refine(run) -> tuple[list, list]:
    """The calls one run makes to the sum kernel and to ``covariance_tail``."""
    from pointcloud_obstacle_processing_tpu_torch import ops
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    sums = []
    tails = _capture(ransac, "covariance_tail",
                     lambda: sums.extend(_capture(ops, "_xla_sum_kernel", run)))
    return sums, tails


def count_refine(run):
    """``run()`` with the calls it makes to the sum kernel and to
    ``covariance_tail`` counted: (result, sum calls, step calls)."""
    from pointcloud_obstacle_processing_tpu_torch import ops
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    seen = {"sum": 0, "tail": 0}
    fns = {"sum": (ops, "_xla_sum_kernel"), "tail": (ransac, "covariance_tail")}
    saved = {k: getattr(m, n) for k, (m, n) in fns.items()}

    def counting(k):
        def call(*a, **kw):
            seen[k] += 1
            return saved[k](*a, **kw)
        return call

    for k, (m, n) in fns.items():
        setattr(m, n, counting(k))
    try:
        res = run()
    finally:
        for k, (m, n) in fns.items():
            setattr(m, n, saved[k])
    return res, seen["sum"], seen["tail"]


def check_refine_launches(label: str, launches: dict, sums: int, tails: int) -> None:
    """The sum kernel launched once a call of ``sum_like_xla`` at every
    length, ``covariance_tail`` once a call and at least once, and the
    standalone 3x3 tail kernel (``plane_refine``) gone."""
    if launches["xla_sum"] != sums or launches["covariance_tail"] != tails or not tails or \
            "plane_refine" in launches:
        raise AssertionError(f"{label}: sum kernel launches {launches['xla_sum']} for {sums} "
                             f"calls, covariance_tail {launches['covariance_tail']} for {tails} "
                             f"calls (launches {launches})")


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
            _bound("cluster_sweep_banded", c, 128, window, computed),
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
        _bound("binned_sum", n, c, k, n_terms),
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
            _bound("segscan", c_, n_, steps),
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
    of ``path`` was not launched, or the sum kernel and ``covariance_tail``
    not once a call (``check_refine_launches``).  Returns the result and
    the counts."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build

    _build.reset_launch_counts()
    res, sums, tails = count_refine(lambda: model(cloud, draw=draw))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    check_refine_launches("main path", counts, sums, tails)
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
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_loop", "xla_sum", "covariance_tail",
            *SCAN_PATH]
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
    stage, s_args, r_args = capture_shadow(lambda: model(gpu_clouds[0], draw=draw_cuda))
    SHADOW_SCANS["flagship"] = stage
    chains = capture_ransac("flagship", lambda: model(gpu_clouds[0], draw=draw_cuda), cfg,
                            runs=len(SCENE_SEEDS))
    return launches, [check_k3_scan("flagship", model, gpu_clouds[0], draw_cuda),
                      _loop_row("flagship", "the scan's non-plane cloud", loop_args),
                      *_sum_rows("flagship", sums), _tail_row("flagship", tails),
                      *_shadow_rows("flagship", "the scan's clusters", s_args, r_args),
                      _fma_row("flagship", "a scan", chains)]


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
            "covariance_tail", *SCAN_PATH]
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
    stage, s_args, r_args = capture_shadow(lambda: model(gpu_cloud, draw=draw_cuda))
    SHADOW_SCANS["fullscale"] = stage
    chains = capture_ransac("fullscale", lambda: model(gpu_cloud, draw=draw_cuda), cfg)
    return launches, [check_k3_scan("fullscale", model, gpu_cloud, draw_cuda),
                      *_sum_rows("fullscale", sums), _tail_row("fullscale", tails),
                      *_shadow_rows("fullscale", "the window's clusters", s_args, r_args),
                      _fma_row("fullscale", "a window", chains)], res


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
            "covariance_tail", *SCAN_PATH]
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
    capture_ransac("fullscale_bandoff", lambda: model(gpu_cloud, draw=draw_cuda), cfg)
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
        _bound("runreduce", n, kept, w, scans),
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
        _bound("compact_gather", nv, kept, c, scans),
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
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_loop", *SHADOW_PATH]
    _build.reset_launch_counts()
    res, sums, tails = count_refine(lambda: run(clouds, draw))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches[k] != 1 for k in path) or any(launches[k] < 1 for k in ("fma_chain",
                                                                          *RANSAC_PATH)):
        raise AssertionError(f"batched flagship: each of {path} must launch once a batch, and "
                             f"fma_chain and {RANSAC_PATH} at least once, got {launches}")
    check_refine_launches("batched flagship", launches, sums, tails)
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
    _, s_args, r_args = capture_shadow(once)
    rows = [
        *_shadow_rows("flagship_batch", f"the batch's clusters ({BATCH} scans)", s_args, r_args),
        _fma_row("flagship_batch", f"a batch of {BATCH} scans",
                 capture_ransac("flagship_batch", once, cfg)),
        _k1_batch_row("flagship_batch", *k1),
        _k2_batch_row("flagship_batch", k2[0]),
        _k3_row("flagship_batch", f"the batch's voxel clouds ({BATCH} scans)", k3[0]),
        _loop_row("flagship_batch", "the batch's non-plane clouds", lp[0]),
        *_sum_rows("flagship_batch", sums),
        _tail_row("flagship_batch", tails),
    ]
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    loop_blocks(lp[0], card)
    return launches, rows


def _k5_row(path, calls, plain_reps=20):
    """K5 on every call a run made to it (each sweep of the banded loop, one
    scan or a batch), each held bitwise against the plain version; timed on
    the first."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    err = 0.0
    for i, (args, _) in enumerate(calls):
        err = max(err, _assert_equal(f"K5 cluster_sweep_banded {path} sweep {i}",
                                     cluster.sweep_jump_banded(*args),
                                     cluster.sweep_jump_banded_plain(*args)))
    args = calls[0][0]
    pk, valid, _, _, tile, window, _, live = args
    c = valid.shape[-1]
    b = valid[..., 0].numel()
    has_valid = valid.reshape(*valid.shape[:-1], c // tile, tile).any(dim=-1)
    computed = int((has_valid if live is None else has_valid & live).sum())
    return _row(
        "cluster_sweep_banded", path,
        f"{f'B {b}, ' if valid.dim() > 1 else ''}{len(calls)} sweeps a run, all equal; timed: "
        f"the first, C {c}, {valid.sum(dim=-1).tolist()} valid, window {window}, {computed} "
        f"tiles computed", "cluster_sweep_banded.cu", "cluster.py:329", err,
        lambda: cluster.sweep_jump_banded(*args), lambda: cluster.sweep_jump_banded_plain(*args),
        _bound("cluster_sweep_banded", c, tile, window, computed, b),
        plain_reps=plain_reps,
    )


def _node_rows(path: str, once, loop: str, config) -> list[dict]:
    """The node path's kernels on the inputs one of its windows gives them
    (``once`` runs that window's pipeline call again): K1, K2, K3, the
    cluster loop (``loop``: the loop kernel or K5), the sum kernel and
    ``covariance_tail``, each checked and timed as in phase 2; RANSAC's
    calls recorded for phase 15."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster, compaction, outliers, voxel

    (k1,) = _capture(voxel, "sorted_run_reduce", once)
    (k2,) = _capture(compaction, "compact_and_gather_exact", once)
    (k3,) = _capture(outliers, "knn_mean", once)
    rows = [_k1_batch_row(path, *k1), _k2_batch_row(path, k2[0])]
    nv = int(k3[0][2].sum())
    rows.append(_k3_row(path, f"the window's voxel cloud ({nv} valid of {k3[0][1].shape[-1]})",
                        k3[0]))
    if loop == "cluster_loop":
        (lp,) = _capture(cluster, "cluster_loop", once)
        rows.append(_loop_row(path, "the window's non-plane cloud", lp[0]))
    else:
        rows.append(_k5_row(path, _capture(cluster, "sweep_jump_banded", once)))
    sums, tails = capture_refine(once)
    _, s_args, r_args = capture_shadow(once)
    capture_ransac(path, once, config)
    return rows + [*_sum_rows(path, sums), _tail_row(path, tails),
                   *_shadow_rows(path, "the window's clusters", s_args, r_args)]


def _node_rig(cfg, dev, async_mode: bool, device_mode: bool, points: int, draw_for_cycle=None):
    """A node on a bus of its own with the launch's static sensor mount and
    a synthetic Kinect (scene seed 0) publishing to it; records every
    frame message and every published grid."""
    from pointcloud_obstacle_processing_tpu_torch.runtime.bus import MessageBus
    from pointcloud_obstacle_processing_tpu_torch.runtime.driver import (
        POINT_TOPIC,
        ObstacleDetectionNode,
    )
    from pointcloud_obstacle_processing_tpu_torch.runtime.launch import (
        DEFAULT_SENSOR_POS,
        DEFAULT_SENSOR_QUAT,
        SyntheticKinect,
    )
    from pointcloud_obstacle_processing_tpu_torch.runtime.tf import TransformBuffer

    bus, tf = MessageBus(immediate=True), TransformBuffer()
    tf.set_static("world", "kinect2_link", DEFAULT_SENSOR_QUAT, DEFAULT_SENSOR_POS)
    node = ObstacleDetectionNode(cfg, bus=bus, tf_buffer=tf, async_pipeline=async_mode,
                                 accumulate_on_device=device_mode, device=dev,
                                 draw_for_cycle=draw_for_cycle)
    if node.accumulator.backend != "native":
        raise AssertionError("the node's host accumulator fell back to NumPy: g++ build failed")
    kinect = SyntheticKinect(bus.advertise(POINT_TOPIC),
                             tf.lookup_transform("world", "kinect2_link"),
                             points_per_frame=points)
    rec = {"frames": [], "grids": []}
    bus.subscribe(POINT_TOPIC, rec["frames"].append, queue_size=1)
    bus.subscribe("occupancy_grid", lambda m: rec["grids"].append(m.data.copy()))
    return node, kinect, rec


def _node_window(node, kinect, sleep_s: float = 0.0) -> None:
    """The frames of one window and its trigger frame (``sleep_s`` after
    each accumulated frame: a sensor cadence)."""
    for _ in range(node.config.accumulate_count):
        kinect.emit_frame()
        if sleep_s:
            time.sleep(sleep_s)
    kinect.emit_frame()


def _count_node_syncs(node, kinect) -> int:
    """Host syncs (sync debug mode) of one trigger frame's callback and of
    the dispatch it hands over (joined), the window's frames before it
    uncounted."""
    import torch

    for _ in range(node.config.accumulate_count):
        kinect.emit_frame()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            kinect.emit_frame()
            node.join()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _replay_draws(cfg, dev, n: int) -> list:
    """The draws a node seeded 0 takes for its first ``n`` windows."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.pipeline import default_draw

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return [default_draw(cfg, gen, dev) for _ in range(n)]


def _grids_equal(label: str, a: list, b: list) -> None:
    if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: published grids differ")


def _window_frames(msgs, cfg, dev):
    """A device-mode window as the node uploads it: each frame decoded,
    truncated to its capacity and padded with empty slots."""
    import torch

    A, F = cfg.accumulate_count, cfg.max_points // cfg.accumulate_count
    pts, valid = np.zeros((A, F, 3), np.float32), np.zeros((A, F), bool)
    for a, m in enumerate(msgs):
        xyz = m.xyz()[:F]
        pts[a, : len(xyz)], valid[a, : len(xyz)] = xyz, True
    return torch.tensor(pts, device=dev), torch.tensor(valid, device=dev)


def _stats_of(res) -> dict:
    return {k: int(getattr(res.stats, k).item()) for k in _COUNTS + _FLAGS}


def run_node_flagship(dev, card: str) -> tuple[dict, list[dict], dict]:
    """Phase 9a: the flagship node (``FLAGSHIP_CONFIG.replace(
    accumulate_count=16)``, 6,272-point frames) in the four modes."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_frames
    from pointcloud_obstacle_processing_tpu_torch.runtime.driver import POINT_TOPIC
    from pointcloud_obstacle_processing_tpu_torch.runtime.launch import (
        DEFAULT_SENSOR_POS,
        DEFAULT_SENSOR_QUAT,
    )

    cfg = FLAGSHIP_CONFIG.replace(accumulate_count=NODE_FRAMES, publish_point_clouds=False)
    A = cfg.accumulate_count
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_loop", "xla_sum", "covariance_tail",
            *SCAN_PATH]
    out, grids, trig, launches = {}, {}, {}, None
    for async_mode, device_mode in NODE_MODES:
        mode = _mode_name(async_mode, device_mode)
        node, kinect, rec = _node_rig(cfg, dev, async_mode, device_mode, NODE_FRAME_POINTS)
        for _ in range(NODE_WARMUP):
            _node_window(node, kinect)
        node.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NODE_WINDOWS):
            _node_window(node, kinect)
        node.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        measured = slice(NODE_WARMUP, NODE_WARMUP + NODE_WINDOWS)
        t_trig = statistics.median(node.trigger_seconds[measured]) * 1e3
        t_win = statistics.median(m["window_seconds"] for m in node.metrics[measured]) * 1e3
        n_sync = _count_node_syncs(node, kinect)
        node.flush()
        # the path's launches a window: counts from 0 around one trigger
        # (every mode drives this window, so that the modes see the same
        # frames and draws throughout; the sync device-mode counts are kept)
        for _ in range(A):
            kinect.emit_frame()
        _build.reset_launch_counts()
        _, sums, tails = count_refine(lambda: (kinect.emit_frame(), node.flush()))
        torch.cuda.synchronize()
        if not async_mode and device_mode:
            launches = dict(_build.LAUNCHES)
            missing = [k for k in path if launches[k] <= 0]
            if missing:
                raise AssertionError(f"node flagship: kernels not launched in a window: {missing}")
            check_refine_launches("node flagship window", launches, sums, tails)
        # a sensor cadence that gives the card each window while the host
        # accumulates the next (tests/test_async_driver.py's production regime)
        sleep_s = 1.5 * trig.get((False, device_mode), t_trig) * 1e-3 / A
        n0 = len(node.trigger_seconds)
        for _ in range(NODE_CADENCE_WINDOWS):
            _node_window(node, kinect, sleep_s)
        node.flush()
        torch.cuda.synchronize()
        t_cad = statistics.median(node.trigger_seconds[n0:]) * 1e3
        trig.setdefault((False, device_mode), t_trig)
        m = node.metrics[NODE_WARMUP]
        bad = [k for k in _OVERFLOWS if any(x[k] for x in node.metrics)]
        if bad:
            raise AssertionError(f"node flagship {mode}: overflow flags {bad}")
        if async_mode and device_mode and n_sync:
            raise AssertionError(f"node flagship {mode}: {n_sync} host syncs in the trigger "
                                 "callback and its dispatch, expected 0")
        grids[async_mode, device_mode] = rec["grids"]
        out[mode] = dict(windows_per_s=NODE_WINDOWS / wall,
                         frames_per_s=NODE_WINDOWS * (A + 1) / wall, window_p50_ms=t_win,
                         trigger_p50_ms=t_trig, cadence_trigger_p50_ms=t_cad,
                         upload_bytes=m["upload_bytes"], fetch_bytes=m["fetch_bytes"],
                         syncs=n_sync, node=node, rec=rec)
        print(f"node flagship {mode}: {NODE_WINDOWS / wall:.2f} windows per second, "
              f"{NODE_WINDOWS * (A + 1) / wall:.1f} frames per second ({NODE_WINDOWS} windows "
              f"after {NODE_WARMUP}, frames back to back); window p50 {t_win:.3f} ms (trigger "
              f"frame to publish); trigger callback p50 {t_trig:.3f} ms back to back, {t_cad:.3f} "
              f"ms at a cadence of {sleep_s * 1e3:.3f} ms a frame; upload {m['upload_bytes']} "
              f"bytes, fetch {m['fetch_bytes']} bytes a window; flagged syncs {n_sync} (trigger "
              f"callback + its dispatch); counts {{{', '.join(f'{k}: {m[k]}' for k in _COUNTS)}}}; "
              f"accumulator {node.accumulator.backend} [{card}]")
    for device_mode in (False, True):
        _grids_equal(f"node flagship sync vs async ({'device' if device_mode else 'host'})",
                     grids[False, device_mode], grids[True, device_mode])
    for device_mode in (False, True):
        s, a = (out[_mode_name(x, device_mode)]["cadence_trigger_p50_ms"] for x in (False, True))
        out[f"ratio_{'device' if device_mode else 'host'}"] = a / s
        print(f"node flagship t_async / t_sync ({'device' if device_mode else 'host'} "
              f"accumulation, at the cadence): {a:.3f} / {s:.3f} ms = {a / s:.4f} [{card}]")

    # every sync device-mode window equals a direct process_frames of its frames
    run = out[_mode_name(False, True)]
    node, rec = run["node"], run["rec"]
    n_win = len(node.metrics)
    draws = _replay_draws(cfg, dev, n_win)
    q, t = (torch.tensor(np.float32(x), device=dev) for x in (DEFAULT_SENSOR_QUAT, DEFAULT_SENSOR_POS))
    poses = RigidTransform(q.expand(A, 4), t.expand(A, 3))

    def direct(c):
        pts, valid = _window_frames(rec["frames"][c * (A + 1): c * (A + 1) + A], cfg, dev)
        return process_frames(pts, valid, cfg, poses, shadow_sensor_pose=RigidTransform(q, t),
                              draw=draws[c])

    for c in range(n_win):
        res = direct(c)
        if not np.array_equal(res.grid.data.cpu().numpy().reshape(-1), rec["grids"][c]):
            raise AssertionError(f"node flagship window {c}: grid != direct process_frames")
        want = _stats_of(res)
        got = {k: int(node.metrics[c][k]) for k in want}
        if got != want:
            raise AssertionError(f"node flagship window {c}: {got} != direct {want}")
    print(f"node flagship sync+device: each of {n_win} windows == a direct process_frames of its "
          f"frames on the card (grid, counts, flags) [{card}]")
    rows = _node_rows("node_flagship", lambda: direct(n_win - 1), "cluster_loop", cfg)

    # one window on the card == the port's CPU node on the same frames (the
    # same RANSAC uniforms on both sides)
    u = np.random.default_rng(RANSAC_SEED).random(
        (cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    card_node, kinect, _ = _node_rig(cfg, dev, False, True, NODE_FRAME_POINTS,
                                     lambda c: draw_from_uniform(torch.tensor(u, device=dev)))
    cpu_node, _, _ = _node_rig(cfg, "cpu", False, True, NODE_FRAME_POINTS,
                               lambda c: draw_from_uniform(torch.tensor(u)))
    kinect.pub.bus.subscribe(POINT_TOPIC, cpu_node.cloud_cb)  # the same frames
    t = time.perf_counter()
    _node_window(card_node, kinect)
    err = _compare("node flagship card vs cpu node", card_node.last_result, cpu_node.last_result)
    print(f"node flagship: card window == cpu node window (grid, counts, flags exact; centroid "
          f"max |d| {err:.2e}; {time.perf_counter() - t:.1f} s) [{card}]")

    # publish_point_clouds: one window that fetches and publishes the debug clouds
    dbg, kinect, _ = _node_rig(cfg.replace(publish_point_clouds=True), dev, True, True,
                               NODE_FRAME_POINTS)
    sizes = {}
    for topic in ("voxel_grid", "statistical_outliers", "planar_cloud", "indices_cloud", "cloud_f"):
        dbg.bus.subscribe(topic, lambda m, k=topic: sizes.setdefault(k, m.xyz()))
    _node_window(dbg, kinect)
    dbg.flush()
    m = dbg.metrics[-1]
    if len(sizes) != 5 or len(sizes["voxel_grid"]) != m["voxel_points"] or \
            len(sizes["cloud_f"]) != m["nonplane_points"] or \
            not all(np.isfinite(v).all() for v in sizes.values()):
        raise AssertionError(f"node flagship debug clouds: {({k: len(v) for k, v in sizes.items()})}, "
                             f"metrics {m}")
    print(f"node flagship publish_point_clouds: five debug clouds published "
          f"({', '.join(f'{k} {len(v)}' for k, v in sizes.items())} points); fetch "
          f"{m['fetch_bytes']} bytes a window [{card}]")
    for r in out.values():
        if isinstance(r, dict):
            r.pop("node"), r.pop("rec")
    return launches, rows, out


def run_node_fullscale(dev, card: str) -> tuple[dict, list[dict], dict]:
    """Phase 9b: the fullscale node through ``launch`` (200 frames of
    10,000 points, host accumulation), sync and async."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG
    from pointcloud_obstacle_processing_tpu_torch.native import ScanAccumulator
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
    from pointcloud_obstacle_processing_tpu_torch.runtime.driver import ObstacleDetectionNode
    from pointcloud_obstacle_processing_tpu_torch.runtime.launch import launch

    cfg = REFERENCE_FULLSCALE_CONFIG
    try:
        ObstacleDetectionNode(cfg, accumulate_on_device=True, device=dev)
    except ValueError:
        pass
    else:
        raise AssertionError("fullscale node: device accumulation accepted a window that does "
                             "not divide max_points")
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_sweep_banded", "xla_sum",
            "covariance_tail", *SCAN_PATH]
    cycles = FULLSCALE_NODE_WARMUP + FULLSCALE_NODE_WINDOWS
    out, grids, launches, rows = {}, {}, None, []
    for async_mode in (False, True):
        mode = _mode_name(async_mode, False)
        snaps, marks, orig = [], [], ScanAccumulator.snapshot

        def recording(self, out=None):
            pts, valid = orig(self, out)
            snaps.append((pts.copy(), valid.copy()))
            marks.append((time.perf_counter(), dict(_build.LAUNCHES)))
            return pts, valid

        ScanAccumulator.snapshot = recording
        _build.reset_launch_counts()
        try:
            node, results = launch(config=cfg, cycles=cycles,
                                   points_per_frame=FULLSCALE_FRAME_POINTS,
                                   async_pipeline=async_mode, device=dev)
            node.flush()
            torch.cuda.synchronize()
        finally:
            ScanAccumulator.snapshot = orig
        end = dict(_build.LAUNCHES)
        if node.accumulator.backend != "native":
            raise AssertionError("fullscale node: the host accumulator fell back to NumPy")
        windows = (results[1:] + [node.last_result]) if async_mode else results
        if len(windows) != cycles or len(snaps) != cycles:
            raise AssertionError(f"fullscale node {mode}: {len(windows)} windows published, "
                                 f"{len(snaps)} snapshots")
        # each window == a direct process_scan of its snapshot with its draw
        draws = _replay_draws(cfg, dev, cycles)
        sensor = node.tf.lookup_transform("world", "kinect2_link").to(dev)
        worst = 0.0
        for c, ((pts, valid), res) in enumerate(zip(snaps, windows)):
            cloud = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))

            def once(cloud=cloud, c=c):
                return process_scan(cloud, cfg, sensor, draw=draws[c])

            worst = max(worst, _compare(f"fullscale node {mode} window {c}", res, once()))
            _assert_equal(f"fullscale node {mode} window {c} point_cluster",
                          res.clusters.point_cluster, once().clusters.point_cluster)
        grids[async_mode] = [w.grid.data.cpu().numpy() for w in windows]
        if not async_mode:
            # a sync window's kernels all launch in its trigger callback:
            # the counts between two triggers (the last: to the end)
            per = [{k: b[k] - a[k] for k in a} for (_, a), (_, b) in
                   zip(marks[1:], marks[2:] + [(None, end)])]
            for i, w in enumerate(per):
                missing = [k for k in path if w[k] <= 0]
                if missing:
                    raise AssertionError(f"fullscale node: kernels not launched in window "
                                         f"{i + 1}: {missing}")
            launches = per[-1]
            rows = _node_rows("node_fullscale", once, "cluster_sweep_banded", cfg)
        stamps = [t for t, _ in marks[FULLSCALE_NODE_WARMUP:]]
        rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        measured = slice(FULLSCALE_NODE_WARMUP, None)
        t_trig = statistics.median(node.trigger_seconds[measured]) * 1e3
        t_win = statistics.median(m["window_seconds"] for m in node.metrics[measured]) * 1e3
        m = node.metrics[-1]
        out[mode] = dict(windows_per_s=rate, frames_per_s=rate * (cfg.accumulate_count + 1),
                         window_p50_ms=t_win, trigger_p50_ms=t_trig,
                         upload_bytes=m["upload_bytes"], fetch_bytes=m["fetch_bytes"])
        print(f"node fullscale {mode}: {rate:.3f} windows per second, "
              f"{rate * (cfg.accumulate_count + 1):.1f} frames per second (between the "
              f"triggers of {FULLSCALE_NODE_WINDOWS} windows after {FULLSCALE_NODE_WARMUP}; "
              f"launch's back-to-back synthetic frames); window p50 {t_win:.3f} ms; trigger "
              f"callback p50 {t_trig:.3f} ms; upload {m['upload_bytes']} bytes, fetch "
              f"{m['fetch_bytes']} bytes a window; each window == a direct process_scan of its "
              f"snapshot (centroid max |d| {worst:.2e}); counts "
              f"{{{', '.join(f'{k}: {m[k]}' for k in _COUNTS)}}} [{card}]")
    _grids_equal("fullscale node sync vs async", grids[False], grids[True])
    s, a = (out[_mode_name(x, False)]["trigger_p50_ms"] for x in (False, True))
    out["ratio_host"] = a / s
    print(f"node fullscale t_async / t_sync: {a:.3f} / {s:.3f} ms = {a / s:.4f} [{card}]")
    return launches, rows, out


# ---- phase 10: point-sharded runs, 4 gloo ranks sharing the card ------------

SP_SHARDS = 4  # the points axis of phase 10
SP_WINDOWS = 3  # timed windows a job runs on the card, after one warm-up (checked)
DP_RANKS, DP_SCANS = 2, 32  # data_parallel_pipeline: 2 ranks x 16 flagship scans
SP_TIMEOUT_S = 900.0  # every rank group's process group and join
CPU_RANK_THREADS = 2  # the CPU ranks' threads (4 ranks on the host's 8 cores)
_MOD = f"{PKG}.ops"
SP_CAPTURE = [(f"{_MOD}.voxel", "sorted_run_reduce"),
              (f"{PKG}.parallel.sharding", "sorted_run_reduce"),
              (f"{_MOD}.voxel", "compact_and_gather_exact"),
              (f"{_MOD}.compaction", "compact_and_gather_exact"), (f"{_MOD}.outliers", "knn_mean"),
              (f"{_MOD}.cluster", "sweep_jump"), (f"{_MOD}.cluster", "sweep_jump_banded"),
              (_MOD, "_xla_sum_kernel"), (f"{_MOD}.ransac", "covariance_tail")]
# kernels each sharded path must launch on every rank, counted from 0
SP_PATHS = {
    "sp_flagship": ["runreduce", "compact_gather", "knn_mean_rows", "cluster_sweep_rows",
                    *SCAN_PATH],
    "sp_fullscale": ["runreduce", "runreduce_counts", "compact_gather", "knn_mean_rows",
                     "cluster_sweep_banded_rows", *SCAN_PATH],
    "sp_fullscale_replicated": ["runreduce", "runreduce_counts", "compact_gather",
                                "knn_mean_rows", "cluster_sweep_banded_rows", *SCAN_PATH],
    "sp_dp_2x2": ["runreduce", "compact_gather", "knn_mean_rows", "cluster_sweep_rows",
                  *SCAN_PATH],
    "data_parallel": ["runreduce", "compact_gather", "knn_mean", "cluster_loop", *SCAN_PATH],
    "merge_fullscale": ["runreduce", "runreduce_counts"],
}


def _to_dev(obj, dev):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_dev(v, dev) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_dev(v, dev) for k, v in obj.items()}
    return obj


def _leaves(res) -> list:
    import dataclasses

    import torch

    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(res)
    return out


def _same(label: str, a, b) -> None:
    """Every tensor of two results equal, bit for bit."""
    import torch

    for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b), strict=True)):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{label}: field {i} differs")


def _structural(label: str, sp, single) -> float:
    """The reference's point-sharded-against-single bar
    (tests/test_sharding.py:61-84): crop and voxel counts exact, cluster
    count equal, under 1% of the grid's cells different, centroids within
    5e-2 (the voxel sums re-associate across shards).  Returns the grid's
    disagreement."""
    for k in ("cropped_points", "voxel_points", "num_clusters"):
        a, b = int(getattr(sp.stats, k)), int(getattr(single.stats, k))
        if a != b:
            raise AssertionError(f"{label}: {k} sharded {a} != single {b}")
    frac = float((sp.grid.data.cpu() != single.grid.data.cpu()).float().mean())
    err = float((sp.centroids.points.xyzr.cpu() - single.centroids.points.xyzr.cpu()).abs().max())
    if frac >= 0.01 or err >= 5e-2:
        raise AssertionError(f"{label}: grid disagreement {frac}, centroid |d| {err}")
    return frac


def _sp_inputs():
    """Phase 10's inputs: the flagship scene 0 (one scan), the fullscale
    window, four flagship scenes for the 2x2 mesh and the 32 scans of the
    data-parallel run, with their RANSAC uniforms (as numpy arrays)."""
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    def scans(count, scenes):
        pts = np.zeros((count, fl.max_points, 3), np.float32)
        valid = np.zeros((count, fl.max_points), bool)
        for b in range(count):
            p = scenes[b % len(scenes)].points[: fl.max_points]
            pts[b, : len(p)] = p
            valid[b, : len(p)] = True
        return pts, valid

    def uniforms(cfg, count):
        return np.random.default_rng(RANSAC_SEED).random(
            (count, cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)

    scenes = [_scene(s) for s in range(BATCH_SCENES)]
    fs_pts, fs_valid = make_fullscale_window(FULLSCALE_POINTS)
    return {
        "flagship": (*scans(1, scenes[:1]), uniforms(fl, 1)),
        "fullscale": (fs_pts[None], fs_valid[None], uniforms(fs, 1)),
        "dp_sp": (*scans(4, scenes[:4]), uniforms(fl, 4)),
        "dp": (*scans(DP_SCANS, scenes), uniforms(fl, DP_SCANS)),
    }


def _sp_jobs(inputs, device: str, windows: int) -> dict:
    """Phase 10's jobs by path (the data-parallel one on the card only)."""
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs

    def job(kind, cfg, mesh, key, **kw):
        pts, valid, u = inputs[key]
        return dict(kind=kind, config=cfg, mesh=mesh, points=pts, valid=valid,
                    draw=("uniform", u), device=device, windows=windows,
                    warmup=int(device == "cuda"),
                    capture=SP_CAPTURE if device == "cuda" else None, **kw)

    sp = {"data": 1, "points": SP_SHARDS}
    jobs = {
        "sp_flagship": job("dp_sp", fl, sp, "flagship"),
        "sp_fullscale": job("dp_sp", fs, sp, "fullscale"),  # the distributed merge (default)
        "sp_fullscale_replicated": job("dp_sp", fs, sp, "fullscale",
                                       options={"distribute_merge": False}),
        "sp_dp_2x2": job("dp_sp", fl, {"data": 2, "points": 2}, "dp_sp"),
    }
    if device == "cuda":
        jobs["data_parallel"] = job("data_parallel", fl, {"data": DP_RANKS}, "dp")
        pts, valid, _ = inputs["fullscale"]  # the window's voxel tables merged both ways
        jobs["merge_fullscale"] = dict(kind="merge", config=fs, mesh=sp, points=pts[0],
                                       valid=valid[0], device=device, windows=windows, warmup=1)
    return jobs


def _k1_counts_row(path, what, call):
    """K1's counts mode on a merge's own sorted rows."""
    from pointcloud_obstacle_processing_tpu_torch.ops import runreduce

    a, kw = call
    skey, offs, sentinel, cap = a
    vk, nk = runreduce.sorted_run_reduce(*a, **kw)
    vp, np_ = runreduce.sorted_run_reduce_plain(*a, **kw)
    _assert_equal(f"K1 counts {path} run counts", nk, np_)
    k = min(int(np_.reshape(-1)[0]), cap)
    err = _assert_equal(f"K1 counts {path} ({what})", vk[..., :k, :], vp[..., :k, :])
    n = skey.shape[-1]
    w = runreduce.default_group(n) * 128
    return _row(
        "runreduce_counts", path, f"{what}: {n} rows, {w}-row windows, {int(np_.sum())} runs, "
        f"cap {cap}", "runreduce.cu", "pallas_runreduce.py:115 (counts :162-163, :488, :693)", err,
        lambda: runreduce.sorted_run_reduce(*a, **kw),
        lambda: runreduce.sorted_run_reduce_plain(*a, **kw),
        _bound("runreduce_counts", n, k, w),
        plain_reps=2,
    )


def _k3_rows_row(path, what, call):
    """K3 over one shard's range of the query tiles."""
    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    a, kw = call
    pch, p_sq, valid, starts, rt, width, k = a
    first, count = kw["tile_range"]
    err = _assert_equal(f"K3 knn_mean rows {path} ({what})", outliers.knn_mean(*a, **kw),
                        outliers.knn_mean_plain(*a, **kw))
    live = int(outliers._tile_live(valid, starts.shape[0], rt)[..., first:first + count].sum())
    nv, scans = p_sq.shape[-1], p_sq[..., 0].numel()
    return _row(
        "knn_mean_rows", path, f"{what}: tiles {first}-{first + count - 1} of {starts.shape[0]}, "
        f"row tile {rt}, window {width}, k {k}", "knn_select.cu", "outliers.py:142 (tiles "
        "of a shard, :407-416)", err,
        lambda: outliers.knn_mean(*a, **kw), lambda: outliers.knn_mean_plain(*a, **kw),
        _bound("knn_mean", nv, starts.shape[0], count, live, rt, width, scans),
        plain_reps=2,
    )


def _k4_rows_row(path, what, call):
    """K4's per-sweep kernel over one shard's range of the query rows."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    a, kw = call
    pch, valid, labels, tol2, rows = a
    err = _assert_equal(f"K4 cluster_sweep rows {path} ({what})", cluster.sweep_jump(*a),
                        cluster.sweep_jump_plain(*a))
    c = labels.shape[0]
    n_valid = int(valid.sum())
    q_valid = int(valid[rows[0]:rows[0] + rows[1]].sum())
    return _row(
        "cluster_sweep_rows", path, f"{what}: rows {rows[0]}-{rows[0] + rows[1] - 1} of C {c}, "
        f"{n_valid} valid", "cluster_sweep.cu", "cluster.py:86 (qslice, :461-530)", err,
        lambda: cluster.sweep_jump(*a), lambda: cluster.sweep_jump_plain(*a),
        _bound("cluster_sweep", c, rows[1], q_valid, n_valid),
        plain_reps=5,
    )


def _k5_rows_row(path, what, call):
    """K5 over one shard's range of the query tiles."""
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster

    a, kw = call
    pk, valid, labels, tol2, tile, window, starts, live, tile_range = a
    err = _assert_equal(f"K5 sweep_banded rows {path} ({what})", cluster.sweep_jump_banded(*a),
                        cluster.sweep_jump_banded_plain(*a))
    c = labels.shape[-1]
    b = labels[..., 0].numel()  # the scans of the batch (each scan's range)
    first, count = tile_range
    vt = valid.reshape(*valid.shape[:-1], c // tile, tile)[..., first:first + count, :].any(-1)
    if live is not None:
        vt &= live[..., first:first + count]
    return _row(
        "cluster_sweep_banded_rows", path, f"{what}: {b} scan(s), tiles {first}-"
        f"{first + count - 1} of {c // tile}, window {window}, {int(vt.sum())} live",
        "cluster_sweep_banded.cu", "cluster.py:329 (qslice)", err,
        lambda: cluster.sweep_jump_banded(*a), lambda: cluster.sweep_jump_banded_plain(*a),
        _bound("cluster_sweep_banded", c, tile, window, int(vt.sum()), b, count * tile),
        plain_reps=5,
    )


def _k2_merge_row(path, what, call):
    """K2 on the dense merge's [4, Kp] bins."""
    from pointcloud_obstacle_processing_tpu_torch.ops import compaction

    a, kw = call
    bins, occ2d, cap = a
    lk, nk, vk = compaction.compact_and_gather_exact(*a)
    lp, np_, vp = compaction.compact_and_gather_plain(*a)
    _assert_equal(f"K2 merge {path} count", nk, np_)
    k = min(int(np_.reshape(-1)[0]), cap)
    _assert_equal(f"K2 merge {path} loc", lk[..., :k], lp[..., :k])
    err = _assert_equal(f"K2 merge {path} vals", vk[..., :k, :], vp[..., :k, :])
    kp = bins.shape[-1]
    return _row(
        "compact_gather", path, f"{what}: [4, {kp}] bins -> {cap} slots, {k} occupied",
        "compaction.cu", "pallas_compaction.py:59", err,
        lambda: compaction.compact_and_gather_exact(*a),
        lambda: compaction.compact_and_gather_plain(*a),
        _bound("compact_gather", kp, k),
        library_fn=lambda: bins.reshape(4, kp).T[occ2d.reshape(-1)],
    )


def _sp_rows(path: str, captured: dict, dev) -> list[dict]:
    """The path's kernels on rank 0's own inputs of its first window."""
    shard_k1 = [c for c in captured[f"{_MOD}.voxel.sorted_run_reduce"] if "quantum" in c[1]]
    rows = [_k1_batch_row(path, *_to_dev(shard_k1[0], dev))]  # rank 0's shard's voxels
    merges = [c for c in captured[f"{PKG}.parallel.sharding.sorted_run_reduce"]] + \
        [c for c in captured[f"{_MOD}.voxel.sorted_run_reduce"] if len(c[0][1]) == 4]
    for c in merges[:1]:
        what = ("the distributed merge's range" if path == "sp_fullscale"
                else "the replicated sort merge")
        rows.append(_k1_counts_row(path, what, _to_dev(c, dev)))
    if captured[f"{_MOD}.voxel.compact_and_gather_exact"]:
        rows.append(_k2_merge_row(path, "the dense merge", _to_dev(
            captured[f"{_MOD}.voxel.compact_and_gather_exact"][0], dev)))
    else:  # the compaction before clustering
        rows.append(_k2_batch_row(path, _to_dev(
            captured[f"{_MOD}.compaction.compact_and_gather_exact"][0][0], dev)))
    knn = [c for c in captured[f"{_MOD}.outliers.knn_mean"] if c[1].get("tile_range")]
    rows.append(_k3_rows_row(path, "rank 0's tiles of the merged voxel cloud",
                             _to_dev(knn[0], dev)))
    for name, fn in (("sweep_jump", _k4_rows_row), ("sweep_jump_banded", _k5_rows_row)):
        calls = captured[f"{_MOD}.cluster.{name}"]
        if calls:
            rows.append(fn(path, "rank 0's rows, first sweep", _to_dev(calls[0], dev)))
    if path in ("sp_flagship", "sp_fullscale"):  # the sums and steps of the window
        rows += _sum_rows(path, _to_dev(captured[f"{_MOD}._xla_sum_kernel"], dev))
        rows.append(_tail_row(path, _to_dev(captured[f"{_MOD}.ransac.covariance_tail"], dev)))
    return rows


def _sp_line(path: str, res: dict, card: str) -> dict:
    ms = [s * 1e3 for s in res["seconds"]]
    p50 = statistics.median(ms)
    c = res["collectives"]
    out = {"path": path, "backend": res["backend"], "staging": res["staging"],
           "windows_per_s": 1e3 / p50, "p50_ms": p50, "ms": ms,
           "collective_bytes_per_window": c["bytes"], "collective_calls": c["calls"],
           "host_reads": c["host_reads"] + int(res["host_syncs"] or 0)}
    print(f"sharded: {path}: backend {res['backend']}, staging {res['staging']}; "
          f"{out['windows_per_s']:.2f} windows per second, p50 {p50:.3f} ms over {len(ms)} "
          f"windows ({', '.join(f'{m:.3f}' for m in ms)}); {c['bytes']} collective bytes and "
          f"{c['calls']} collectives a window (rank 0); host reads {out['host_reads']} "
          f"({c['host_reads']} staged copies, {res['host_syncs']} change tests) [{card}]")
    return out


def run_sharded(dev, card: str) -> tuple[dict, list[dict]]:
    """Phase 10: the point-sharded and data-parallel paths on 4 gloo ranks
    sharing the card, held to the same runs on 4 gloo CPU ranks."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as fl
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as fs
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.parallel import ranks
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
    from pointcloud_obstacle_processing_tpu_torch.types import scan_of

    inputs = _sp_inputs()
    t = time.perf_counter()
    cuda_jobs = _sp_jobs(inputs, dev.type, SP_WINDOWS)
    out = ranks.spawn(ranks.run_jobs, SP_SHARDS, list(cuda_jobs.values()), timeout_s=SP_TIMEOUT_S)
    card_runs = {p: [r[j] for r in out] for j, p in enumerate(cuda_jobs)}
    print(f"phase 10 card ranks: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cpu_jobs = _sp_jobs(inputs, "cpu", 1)
    out = ranks.spawn(ranks.run_jobs, SP_SHARDS, list(cpu_jobs.values()), timeout_s=SP_TIMEOUT_S,
                      threads=CPU_RANK_THREADS)
    cpu_runs = {p: [r[j] for r in out] for j, p in enumerate(cpu_jobs)}
    print(f"phase 10 CPU ranks: {time.perf_counter() - t:.1f} s")

    launches, lines = {}, []
    for path, runs in card_runs.items():
        members = [r for r in runs if r is not None]
        for rank, r in enumerate(members):
            missing = [k for k in SP_PATHS[path] if r["launches"][k] <= 0]
            if missing:
                raise AssertionError(f"{path} rank {rank}: kernels not launched: {missing}")
            if r["backend"] != "gloo" or r["staging"] != "pinned host":
                raise AssertionError(f"{path}: backend {r['backend']}, staging {r['staging']}")
        launches[path] = members[0]["launches"]
        p = cuda_jobs[path]["mesh"].get("points", 1)
        for rank, r in enumerate(members):  # every rank of a points row holds one result
            _same(f"{path} rank {rank} vs its row's first", r["out"],
                  members[rank - rank % p]["out"])
        lines.append(_sp_line(path, members[0], card))
        if path in cpu_runs:  # the card run against the same run on gloo CPU ranks
            for rank, (a, b) in enumerate(zip(members, cpu_runs[path])):
                for i in range(a["out"].grid.data.shape[0]):
                    ra, rb = scan_of(a["out"], i), scan_of(b["out"], i)
                    _compare(f"{path} rank {rank} scan {i}", ra, rb)
                    _assert_equal(f"{path} rank {rank} scan {i} point_cluster",
                                  ra.clusters.point_cluster, rb.clusters.point_cluster)
            counts = {k: getattr(members[0]["out"].stats, k).tolist() for k in _COUNTS}
            print(f"{path}: {len(members)} card ranks equal, each == its gloo CPU rank (grid, "
                  f"counts, flags, point clusters exact; centroids within 1e-5); {counts}; "
                  f"launches on rank 0 {members[0]['launches']} [{card}]")

    # the two fullscale merges agree: keys, counts, num exact, sums within
    # the reference's test tolerance (test_sharding.py, rtol = atol = 1e-5)
    m = card_runs["merge_fullscale"][0]["out"]
    d, r = m["distributed"], m["replicated"]
    n = int(r.num_voxels[0])
    if bool(d.overflow[0]) or bool(r.overflow[0]) or int(d.num_voxels[0]) != n:
        raise AssertionError("fullscale merges: overflow or voxel counts differ")
    for f in ("keys", "counts"):
        _assert_equal(f"fullscale merges' {f}", getattr(d, f)[0, :n], getattr(r, f)[0, :n])
    sums_err = float((d.sums[0, :n] - r.sums[0, :n]).abs().max())
    if not torch.allclose(d.sums[0, :n], r.sums[0, :n], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"fullscale merges' sums differ by {sums_err}")
    print(f"fullscale distributed == replicated merge of the window's 4 shard tables: {n} "
          f"voxels, keys, counts and num exact, sums max |d| {sums_err:.2e}")
    dist_v, rep_v = (card_runs[p][0]["out"].voxel_cloud for p in
                     ("sp_fullscale", "sp_fullscale_replicated"))
    dist_s, rep_s = (card_runs[p][0]["out"].stats
                     for p in ("sp_fullscale", "sp_fullscale_replicated"))
    if int(dist_s.voxel_points) != int(rep_s.voxel_points) or bool(dist_s.voxel_overflow):
        raise AssertionError("fullscale: distributed and replicated merges differ in count")
    _assert_equal("fullscale merges' voxel masks", dist_v.valid, rep_v.valid)
    cen = float((dist_v.points - rep_v.points).abs().max())
    if cen >= 1e-5:
        raise AssertionError(f"fullscale merges' centroids differ by {cen}")
    print(f"fullscale distributed == replicated merge: {int(dist_s.voxel_points[0])} voxels, "
          f"masks exact, centroid max |d| {cen:.2e}")

    # the sharded runs against the single-scan card runs (structure)
    for path, cfg, key in (("sp_flagship", fl, "flagship"), ("sp_fullscale", fs, "fullscale")):
        pts, valid, u = inputs[key]
        single = process_scan(Cloud(points=torch.tensor(pts[0], device=dev),
                                    valid=torch.tensor(valid[0], device=dev)), cfg,
                              draw=draw_from_uniform(torch.tensor(u[0], device=dev)))
        frac = _structural(path, scan_of(card_runs[path][0]["out"], 0), single)
        print(f"{path} vs the single-scan card run: counts exact, grid disagreement {frac:.5f}")

    # data_parallel_pipeline == batched_pipeline, bit for bit
    pts, valid, u = inputs["dp"]
    whole = batched_pipeline(fl)(Cloud(points=torch.tensor(pts, device=dev),
                                       valid=torch.tensor(valid, device=dev)),
                                 draw=draw_from_uniform(torch.tensor(u, device=dev)))
    per = DP_SCANS // DP_RANKS
    for rank in range(DP_RANKS):
        r = card_runs["data_parallel"][rank]
        if r["collectives"]["calls"]:
            raise AssertionError("data_parallel_pipeline ran a collective")
        for i in range(per):
            _same(f"data_parallel rank {rank} scan {i}", scan_of(r["out"], i),
                  scan_of(whole, rank * per + i))
    print(f"data_parallel_pipeline ({DP_RANKS} ranks x {per} scans) == batched_pipeline "
          f"({DP_SCANS} scans), every field bitwise")

    rows = []
    for path in ("sp_flagship", "sp_fullscale", "sp_fullscale_replicated"):
        rows += _sp_rows(path, card_runs[path][0]["captured"], dev)
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    print("sharded: " + json.dumps({"shards": SP_SHARDS, "card": card, "paths": lines}))
    return launches, rows


# ---- phase 11: the fullscale batch (K5 with the scan as a grid dimension) --
# and the kNN engines off the sorting network ---------------------------------

FULLSCALE_BATCH_SEEDS = (100, 101)  # two arenas (make_fullscale_window's seed)
FULLSCALE_BATCH_TIMED = 5
KNN_ENGINES = (  # name -> FLAGSHIP_CONFIG overrides
    ("exact", dict(knn_backend="exact")),
    ("approx", dict(knn_backend="approx")),
    ("banded_approx", dict(knn_backend="banded_approx")),
    ("banded_k20", dict(statistical_outlier_mean_k=20)),  # the in-window k-min
    ("no_downsampling", dict(downsample_input_data=False)),  # full-width approx
)
KNN_TIMED = 5


def _p50_ms(fn, n: int) -> float:
    """Median of ``n`` calls, each timed with CUDA events, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def run_fullscale_batch(dev, card: str) -> tuple[dict, list[dict]]:
    """Phase 11a: ``batched_pipeline(REFERENCE_FULLSCALE_CONFIG)`` on two
    fullscale windows (two arenas), counts from 0: the banded loop's K5
    launches once a sweep for the batch (as many sweeps as the slower
    window's single run, not their sum), host reads at most the sweeps less
    one; each window equals its single-window card run with its draws (the
    crosscheck bar, every point's cluster exact); batch p50, windows per
    second against the single window's, peak memory; batched K5 against its
    plain version on every sweep of the batch."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build
    from pointcloud_obstacle_processing_tpu_torch.models import REFERENCE_FULLSCALE_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import cluster
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
    from pointcloud_obstacle_processing_tpu_torch.types import scan_of
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    b = len(FULLSCALE_BATCH_SEEDS)
    windows = [make_fullscale_window(FULLSCALE_POINTS, seed=s) for s in FULLSCALE_BATCH_SEEDS]
    clouds = Cloud(points=torch.tensor(np.stack([w[0] for w in windows])),
                   valid=torch.tensor(np.stack([w[1] for w in windows]))).to(dev)
    u = np.random.default_rng(RANSAC_SEED).random(
        (b, cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32)
    u = torch.tensor(u, device=dev)
    draw = draw_from_uniform(u)
    pipe = batched_pipeline(cfg)

    def run(c, draw):
        return pipe(c, draw=draw)

    # the single windows first: each one's sweeps (K5 launches)
    singles, single_sweeps = [], []
    for i in range(b):
        _build.reset_launch_counts()
        singles.append(process_scan(scan_of(clouds, i), cfg, draw=draw_from_uniform(u[i])))
        torch.cuda.synchronize()
        single_sweeps.append(_build.LAUNCHES["cluster_sweep_banded"])

    # main path: counts from 0, one batch
    path = ["runreduce", "compact_gather", "knn_mean", "cluster_sweep_banded", "xla_sum",
            "covariance_tail", *SCAN_PATH]
    _build.reset_launch_counts()
    res, sums, tails = count_refine(lambda: run(clouds, draw))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check_refine_launches("fullscale batch", launches, sums, tails)
    missing = [k for k in path if launches[k] <= 0]
    sweeps = launches["cluster_sweep_banded"]
    if missing or sweeps != max(single_sweeps) or res.host_syncs > sweeps - 1:
        raise AssertionError(
            f"fullscale batch: kernels not launched {missing}; K5 launches {sweeps} for the "
            f"batch, single windows {single_sweeps} (one a sweep for the batch expected); "
            f"host reads {res.host_syncs} (at most the sweeps less one)")
    worst = 0.0
    for i in range(b):
        rb = scan_of(res, i)
        # arena 101's non-plane cloud overflows the 4,096-column band: its
        # cluster_band_overflow is set, in the single-window run alike
        # (compared below)
        for k in ("voxel_overflow", "cluster_overflow"):
            if bool(getattr(rb.stats, k)):
                raise AssertionError(f"fullscale batch window {i}: {k} set")
        worst = max(worst, _compare(f"fullscale batch window {i}", rb, singles[i]))
        _assert_equal(f"fullscale batch window {i} point_cluster", rb.clusters.point_cluster,
                      singles[i].clusters.point_cluster)
        if int(rb.stats.num_clusters) < 1:
            raise AssertionError(f"fullscale batch window {i}: no cluster found")
    n_sync, res = _count_syncs(run, clouds, draw)
    _check_syncs("fullscale batch", n_sync, res)
    counts = {k: getattr(res.stats, k).tolist() for k in _COUNTS + ("cluster_band_overflow",)}
    print(f"fullscale batch of {b}: each window == its single-window card run (grid, counts, "
          f"flags, point clusters exact; centroid max |d| {worst:.2e}); {counts}; K5 launches "
          f"{sweeps} (single windows {single_sweeps}); host reads {n_sync} (sync debug mode; "
          f"cluster loop counts {res.host_syncs}); launches {launches} [{card}]")

    times = _time_scans(run, [clouds], draw, FULLSCALE_BATCH_TIMED)
    p50 = statistics.median(times)
    one = scan_of(clouds, 0)
    single = _time_scans(lambda c, draw: process_scan(c, cfg, draw=draw), [one],
                         draw_from_uniform(u[0]), FULLSCALE_BATCH_TIMED)
    single_p50 = statistics.median(single)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run(clouds, draw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"fullscale batch p50 {p50:.3f} ms per batch of {b} over {len(times)} batches (min "
          f"{min(times):.3f}, max {max(times):.3f}); {b / p50 * 1e3:.2f} windows per second "
          f"against {1e3 / single_p50:.2f} for single windows (p50 {single_p50:.3f} ms, same "
          f"call); peak device memory {peak / 2**20:.1f} MiB [{card}]")

    calls = _capture(cluster, "sweep_jump_banded", lambda: run(clouds, draw))
    sums, tails = capture_refine(lambda: run(clouds, draw))
    capture_ransac("fullscale_batch", lambda: run(clouds, draw), cfg)
    return launches, [_k5_row("fullscale_batch", calls, plain_reps=3),
                      *_sum_rows("fullscale_batch", sums), _tail_row("fullscale_batch", tails)]


def run_knn_engines(dev, card: str) -> dict:
    """Phase 11b: the flagship scan (scene 0) with each kNN engine off the
    sorting network, on the card against the port's CPU run of the same
    input and draws: grid, counts and flags exact, centroids within 1e-5,
    the kNN mean distances bitwise; none of them launches K3.  Each
    engine's kNN stage p50 (CUDA events, on the scan's own voxel cloud)."""
    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build, pipeline
    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG, ObstacleDetectionModel
    from pointcloud_obstacle_processing_tpu_torch.ops import outliers

    scene = _scene(SCENE_SEEDS[0])
    out = {}
    for name, override in KNN_ENGINES:
        cfg = FLAGSHIP_CONFIG.replace(**override)
        cloud = Cloud.pad_to(scene.points[: cfg.max_points], cfg.max_points)
        draw_cuda, draw_cpu = _draws(cfg, dev)
        results = {}
        for where, model, c, d in (("cuda", ObstacleDetectionModel(cfg, device=dev),
                                    cloud.to(dev), draw_cuda),
                                   ("cpu", ObstacleDetectionModel(cfg, device="cpu"), cloud,
                                    draw_cpu)):
            _build.reset_launch_counts()
            # the outlier stage as the pipeline calls it (imported by name there)
            seen, fn = [], pipeline.remove_statistical_outliers

            def spy(*a, **kw):
                r = fn(*a, **kw)
                seen.append((a, kw, r))
                return r

            pipeline.remove_statistical_outliers = spy
            try:
                res = model(c, draw=d)
            finally:
                pipeline.remove_statistical_outliers = fn
            results[where] = (res, seen[0], dict(_build.LAUNCHES))
        (res, (args, kw, outl), launches), (ref, (_, _, outl_cpu), _) = \
            results["cuda"], results["cpu"]
        if launches["knn_mean"] or not launches["runreduce" if cfg.downsample_input_data
                                               else "compact_gather"]:
            raise AssertionError(f"knn engine {name}: K3 launched or the voxel stage missing: "
                                 f"{launches}")
        err = _compare(f"knn engine {name}", res, ref)
        _assert_equal(f"knn engine {name} mean distances", outl.mean_distances,
                      outl_cpu.mean_distances)
        ms = _p50_ms(lambda: outliers.remove_statistical_outliers(*args, **kw), KNN_TIMED)
        flags = {k: bool(getattr(res.stats, k).item()) for k in _FLAGS}
        out[name] = dict(knn_p50_ms=ms, backend=kw["backend"],
                         voxel_points=int(res.stats.voxel_points), flags=flags)
        print(f"knn engine {name} ({kw['backend']}): cuda == cpu plain (grid, counts, flags "
              f"exact, mean distances bitwise; centroid max |d| {err:.2e}); kNN stage p50 "
              f"{ms:.3f} ms over {KNN_TIMED} calls; {int(res.stats.voxel_points)} voxel slots "
              f"filled; flags {flags} [{card}]")
    print("knn engines: " + json.dumps({"card": card, "engines": out}))
    return out


# ---- phase 12: the voxel engines off the sort engine's lattice order --------

VOXEL_PATHS = (  # name -> (base preset, overrides, timed scans)
    ("flagship_mxu_fast", "flagship", dict(voxel_binning="mxu", voxel_payload_packing=False), 5),
    ("flagship_mxu_exact", "flagship", dict(voxel_binning="mxu", voxel_payload_packing=False,
                                            voxel_sum_precision="exact"), 5),
    ("flagship_scatter", "flagship", dict(voxel_binning="scatter", voxel_payload_packing=False),
     5),
    ("flagship_morton", "flagship", dict(voxel_order="morton"), 5),
    ("fullscale_scatter", "fullscale", dict(voxel_binning="scatter",
                                            voxel_payload_packing=False), 3),
    ("fullscale_morton", "fullscale", dict(voxel_order="morton"), 3),
    # a leaf past 2^23 lattice bins (452 x 380 x 77): the 3-key fallback;
    # capacities raised until no flag is set on scene 0
    ("fine_leaf", "flagship", dict(downsample_leaf_size=0.01, voxel_payload_packing=False,
                                   max_voxels=98_304, cluster_capacity=16_384), 5),
)
VOXEL_BATCH = 4  # flagship scans of one scatter batch (scenes 0-3)


def unfused_fold(fold, dest, vals, bins, order=None, bf16_terms=0, width=None):
    """The same function as one fused ``segment_fold`` call, composed as the
    callers composed it before the kernel took the gather and the split
    terms in: the bf16 split terms as separate passes, each term's values
    gathered by the sort's permutation, one three-argument ``fold`` launch
    a term (the dense engine's dropped rows mapped to the padded width, the
    ``mxu`` terms folded into ``bins``), the terms' add and the pad to
    ``width``.  ``fold`` may be any checkout's ``segment_fold``."""
    import torch

    width = bins if width is None else width
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    if bf16_terms == 0 and width > bins:
        dest, bins = torch.where(dest >= bins, width, dest), width
    terms = [vals]
    if bf16_terms:
        terms = [vals.to(torch.bfloat16).to(torch.float32)]
        if bf16_terms == 2:
            terms.append((vals - terms[0]).to(torch.bfloat16).to(torch.float32))
    acc = None
    for t in terms:
        if order is not None:
            t = t.gather(-1, order[..., None, :].expand(*lead, c, n))
        part = fold(dest, t, bins)
        acc = part if acc is None else acc + part
    return torch.nn.functional.pad(acc, (0, width - acc.shape[-1])) if acc.shape[-1] < width \
        else acc


def _unfused_launches(dest, vals, bins, order=None, bf16_terms=0, width=None):
    """The unfused form's fold launches' operands, precomputed: a list of
    (dest, term values gathered, bins), one a term."""
    import torch

    calls = []
    unfused_fold(lambda d, v, b: calls.append((d, v.contiguous(), b)) or
                 torch.zeros(*v.shape[:-1], b, device=v.device),
                 dest, vals, bins, order, bf16_terms, width)
    return calls


def _fold_library(dest, vals, bins, order=None, bf16_terms=0, width=None):
    """One PyTorch call of the fold's function, used nowhere in the port:
    CUDA's ``index_add_`` (atomics, in an order that changes from run to
    run) of the first term's rows in input order into the bins of every
    scan, dropped rows into one extra bin; its operands precomputed."""
    import torch

    width = bins if width is None else width
    lead, (c, n) = vals.shape[:-2], vals.shape[-2:]
    scans = dest[..., 0].numel()
    if order is not None:  # each row's dest at its input position
        dest = torch.empty_like(dest).scatter_(-1, order, dest)
    t = vals if bf16_terms == 0 else vals.to(torch.bfloat16).to(torch.float32)
    keep = (dest >= 0) & (dest < bins)
    base = torch.arange(scans, device=dest.device).reshape(*lead, 1) * (width + 1)
    idx = (torch.where(keep, dest.long(), width) + base).reshape(-1)
    rows = t.transpose(-1, -2).reshape(-1, c).contiguous()
    return lambda: torch.zeros(scans * (width + 1), c, device=dest.device).index_add_(0, idx, rows)


def fold_rows(path, calls, segfold, label: str = "") -> list[dict]:
    """The segment fold on every call a run made to it (each as one fused
    call: the sort's permutation, the split terms, the padded width), held
    bitwise (int32 views) against its plain version on a CPU copy; then
    three rows on the first call: the fused call, the unfused form's fold
    launches alone on their own operands, and the whole unfused form (the
    gather, the split passes, a launch a term, the add), each held to the
    fused call's output bitwise, timed beside the fused work's bound (from
    ``utils.bounds``), the plain version on the CPU (host clock) and CUDA's
    ``index_add_``.  Device time is the profiler's, as on every other row;
    the CUDA-graph time (``_graph_device``) and the operations a call (the
    graph's nodes, beside the profiler's count) stand under their own
    names.  ``segfold`` is the ``ops.segfold`` of the checkout timed: one
    whose ``segment_fold`` takes three arguments gets the two unfused rows
    only."""
    import inspect

    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build

    fold, plain = segfold.segment_fold, segfold.segment_fold_plain
    fused = "order" in inspect.signature(fold).parameters
    (dest, vals, bins), kw = calls[0]
    kw = dict(kw)
    c, n = vals.shape[-2:]
    scans = dest[..., 0].numel()
    width = kw.get("width") or bins
    what = (f"{scans} x {n} rows, {c} channels, {bins} bins ({width} written) a scan, "
            f"{'the sort permutation, ' if kw.get('order') is not None else ''}"
            f"{kw.get('bf16_terms', 0)} split term(s)")
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t  # noqa: E731
    args_cpu = [cpu(dest), cpu(vals), bins]
    kw_cpu = {k: cpu(v) for k, v in kw.items()}
    want = plain(*args_cpu, **kw_cpu) if fused else None
    err = 0.0
    if fused:
        for i, ((d, v, b), k) in enumerate(calls):
            _build.reset_launch_counts()
            got = fold(d, v, b, **k)
            if _build.LAUNCHES["segment_fold"] != 1:
                raise AssertionError(f"segment_fold {path} call {i}: {_build.LAUNCHES}")
            wi = want if i == 0 else plain(cpu(d), cpu(v), b, **{q: cpu(x) for q, x in k.items()})
            err = max(err, _assert_equal(f"segment_fold {path} call {i}",
                                         got.view(torch.int32), wi.view(torch.int32)))
    bound = _bound("segment_fold", scans, n, c, width, kw.get("order") is not None,
                   kw.get("bf16_terms", 0))
    library = _fold_library(dest, vals, bins, **kw)
    t = time.perf_counter()
    reps = 3
    for _ in range(reps):
        plain(*args_cpu, **kw_cpu) if fused else \
            unfused_fold(plain, *args_cpu, **kw_cpu)
    plain_ms = (time.perf_counter() - t) * 1e3 / reps
    # the unfused form (and its fold launches alone on their own operands)
    # against its composition on the CPU through the plain version
    err = max(err, _assert_equal(
        f"segment_fold {path} unfused form",
        unfused_fold(fold, dest, vals, bins, **kw).view(torch.int32),
        unfused_fold(plain, *args_cpu, **kw_cpu).view(torch.int32)))
    launches = _unfused_launches(dest, vals, bins, **kw)
    alone_bound = [0.0, "bytes"]
    for d, v, b in launches:
        ms, by = _bound("segment_fold", scans, n, c, b)
        alone_bound = [alone_bound[0] + ms, by]
    # a call with no permutation, no split and no padding is its own
    # unfused form
    trivial = kw.get("order") is None and not kw.get("bf16_terms") and width == bins
    forms = []
    if fused:
        forms.append((f"{label}fused call: {what}; {len(calls)} call(s) a run, all equal",
                      lambda: fold(dest, vals, bins, **kw), bound))
    if not (fused and trivial):
        forms.append((f"{label}fold launch(es) alone on the unfused operands: {len(launches)} "
                      f"launch(es) of {scans} x {n} rows into {launches[0][2]} bins",
                      lambda: [fold(d, v, b) for d, v, b in launches], tuple(alone_bound)))
    if not trivial:
        forms.append((f"{label}unfused form (gather, split passes, a launch a term, add, "
                      f"pad): {what}", lambda: unfused_fold(fold, dest, vals, bins, **kw), bound))
    rows = []
    _warm_card()  # the CPU plain runs above leave the card idle
    library_graph_ms, _ = _graph_device(library)
    for shape, fn, b in forms:
        graph_ms, ops = _graph_device(fn)
        profiled = _device_profile(fn)[1]
        row = _row("segment_fold", path, f"{shape}; {ops} device operation(s) a call "
                   f"(profiler: {profiled}); graph {_ms(graph_ms)}, library graph "
                   f"{_ms(library_graph_ms)}", "segment_fold.cu",
                   "voxel.py:542-544 (plain XLA scatter-add, no TPU kernel)",
                   err, fn, lambda: None, b, library_fn=library, plain_reps=1)
        row.update(plain_ms=plain_ms, graph_ms=graph_ms, device_ops=ops, profiler_ops=profiled,
                   library_graph_ms=library_graph_ms)
        rows.append(row)
    if fused and rows[0]["device_ops"] != 1:
        raise AssertionError(f"segment_fold {path}: {rows[0]['device_ops']} device operations "
                             "a fused call (None: the graph capture failed), not 1")
    return rows


def _voxel_partials_equal(label, args, kw):
    """The voxel stage's partials on the card equal the CPU run's bitwise
    (keys, sums, counts, num, overflow), from the scan's own cropped cloud."""
    from pointcloud_obstacle_processing_tpu_torch.ops import voxel

    cloud, rest = args[0], args[1:]
    got = voxel.voxel_partials(cloud, *rest, **kw)
    want = voxel.voxel_partials(cloud.to("cpu"), *rest, **kw)
    for f in ("keys", "sums", "counts", "num_voxels", "overflow"):
        _assert_equal(f"{label} voxel partials {f}", getattr(got, f), getattr(want, f))
    return int(want.num_voxels.reshape(-1)[0])


def run_voxel_engines(dev, card: str) -> tuple[dict, list[dict]]:
    """Phase 12: the flagship scan under the ``mxu`` (fast and exact) and
    ``scatter`` engines and the Morton order, the fullscale window under
    ``scatter`` and Morton, the flagship scan at a 0.01 leaf (the 3-key
    fallback), and a scatter batch of 4 flagship scans.  Each card run,
    counts from 0, against the same run through the plain versions on the
    CPU (the crosscheck bar; the voxel partials bitwise); the kernels each
    engine names launched (the segment fold once a scan, the ``mxu``
    engine's split terms included; K2 on the dense bins, K1 for Morton);
    scan p50 with the voxel stage's p50 beside the sort engine's and the
    peak device memory; the segment fold (``fold_rows``: the fused call,
    its unfused form and that form's fold launches alone, with the device
    operations a call), K1 and K2 checked and timed on each path's own
    inputs."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import Cloud, _build, pipeline
    from pointcloud_obstacle_processing_tpu_torch.models import (
        FLAGSHIP_CONFIG,
        REFERENCE_FULLSCALE_CONFIG,
        ObstacleDetectionModel,
    )
    from pointcloud_obstacle_processing_tpu_torch.ops import histogram, segfold, voxel
    from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.pipeline import process_scan
    from pointcloud_obstacle_processing_tpu_torch.types import scan_of
    from pointcloud_obstacle_processing_tpu_torch.utils.scene import make_fullscale_window

    scene = _scene(SCENE_SEEDS[0])
    fs_pts, fs_valid = make_fullscale_window(FULLSCALE_POINTS)
    inputs = {
        "flagship": (FLAGSHIP_CONFIG, Cloud.pad_to(scene.points[: FLAGSHIP_CONFIG.max_points],
                                                  FLAGSHIP_CONFIG.max_points)),
        "fullscale": (REFERENCE_FULLSCALE_CONFIG,
                      Cloud(points=torch.tensor(fs_pts), valid=torch.tensor(fs_valid))),
    }
    # the fullscale lattice (302 x 254 x 52 bins) is past the mxu engine's 2^19
    cfg = REFERENCE_FULLSCALE_CONFIG.replace(voxel_binning="mxu", voxel_payload_packing=False)
    try:
        ObstacleDetectionModel(cfg, device=dev)(inputs["fullscale"][1].to(dev))
    except ValueError as e:
        if "binning='mxu' requires K <= 524288" not in str(e):
            raise
        print(f"fullscale mxu refused as the reference refuses it: {e}")
    else:
        raise AssertionError("fullscale mxu: the lattice past 2^19 bins was not refused")

    def stage(run):
        """The voxel stage's call as the pipeline makes it, and its output."""
        seen, fn = [], pipeline.voxel_downsample
        pipeline.voxel_downsample = lambda *a, **kw: seen.append((a, kw)) or fn(*a, **kw)
        try:
            out = run()
        finally:
            pipeline.voxel_downsample = fn
        return out, seen[0]

    launches, rows, summary = {}, [], {}
    for name, base, override, timed in VOXEL_PATHS:
        t0 = time.perf_counter()
        base_cfg, cloud = inputs[base]
        cfg = base_cfg.replace(**override)
        model = ObstacleDetectionModel(cfg, device=dev)
        draw_cuda, draw_cpu = _draws(cfg, dev)
        gc = cloud.to(dev)
        engine = "morton" if cfg.voxel_order == "morton" else (
            "fallback" if name == "fine_leaf" else cfg.voxel_binning)
        # one fold launch a scan: the mxu engine's split terms fold in one launch
        folds = {"mxu": 1, "scatter": 1, "fallback": 1, "morton": 0}[engine]
        path = ["knn_mean", "compact_gather", "xla_sum", "covariance_tail"]
        path += ["runreduce"] if engine == "morton" else ["segment_fold"]
        path += ["cluster_sweep_banded"] if cfg.cluster_band_window else (
            ["cluster_grid_loop"] if cfg.cluster_capacity > 2048 else ["cluster_loop"])
        (res, counts), (vargs, vkw) = stage(lambda: _drive(model, gc, draw_cuda, path))
        want_k1 = 1 if engine == "morton" else 0
        want_k2 = 2 if engine in ("mxu", "scatter") else 1  # the dense bins', the cluster buffer's
        if counts["segment_fold"] != folds or counts["runreduce"] != want_k1 or \
                counts["compact_gather"] != want_k2:
            raise AssertionError(f"{name}: launches {counts}: expected {folds} segment fold(s), "
                                 f"{want_k1} K1, {want_k2} K2")
        launches[name] = counts
        for k in ("voxel_overflow", "cluster_overflow"):
            if bool(getattr(res.stats, k)):
                raise AssertionError(f"{name}: {k} set")
        t = time.perf_counter()
        ref = ObstacleDetectionModel(cfg, device="cpu")(cloud, draw=draw_cpu)
        cpu_s = time.perf_counter() - t
        err = _compare(name, res, ref)
        _assert_equal(f"{name} point_cluster", res.clusters.point_cluster,
                      ref.clusters.point_cluster)
        _assert_equal(f"{name} voxel cloud", res.voxel_cloud.points, ref.voxel_cloud.points)
        nv = _voxel_partials_equal(name, vargs, vkw)
        if int(res.stats.num_clusters) < 1:
            raise AssertionError(f"{name}: no cluster found")

        times = _time_scans(model, [gc], draw_cuda, timed)
        n_sync, sres = _count_syncs(model, gc, draw_cuda)
        _check_syncs(name, n_sync, sres, expected=None if cfg.cluster_band_window else 0)
        vd = pipeline.voxel_downsample
        stage_ms = _p50_ms(lambda: vd(*vargs, **vkw), 5)
        # the same cropped cloud through the preset's own engine (the sort engine)
        sort_args = (*vargs[:4], base_cfg.voxel_sum_precision, base_cfg.voxel_binning,
                     base_cfg.voxel_order, base_cfg.voxel_payload_packing)
        sort_ms = None if name == "fine_leaf" else _p50_ms(lambda: vd(*sort_args), 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model(gc, draw=draw_cuda)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        flags = {k: bool(getattr(res.stats, k).item()) for k in _FLAGS}
        p50 = statistics.median(times)
        summary[name] = dict(scan_p50_ms=p50, voxel_stage_p50_ms=stage_ms,
                             sort_engine_stage_p50_ms=sort_ms, peak_mib=peak / 2**20,
                             voxels=nv, flags=flags, host_syncs=n_sync)
        print(f"voxel engine {name}: cuda == cpu plain (grid, counts, flags, point clusters, "
              f"voxel cloud and partials exact; centroid max |d| {err:.2e}); {nv} voxels; flags "
              f"{flags}; scan p50 {p50:.3f} ms over {len(times)} scans (min {min(times):.3f}, "
              f"max {max(times):.3f}); voxel stage p50 {stage_ms:.3f} ms, the sort engine's "
              f"{'n/a (the lattice does not pack)' if sort_ms is None else f'{sort_ms:.3f} ms'}; "
              f"host syncs {n_sync}; peak device memory {peak / 2**20:.1f} MiB; launches "
              f"{counts}; cpu plain run {cpu_s:.1f} s [{card}]")

        def once():
            model(gc, draw=draw_cuda)

        if engine == "morton":
            (k1,) = _capture(voxel, "sorted_run_reduce", once)
            rows.append(_k1_batch_row(name, *k1))
        else:
            terms: list = []  # the mxu engine folds in ops.histogram
            calls = _capture(voxel, "segment_fold",
                             lambda: terms.extend(_capture(histogram, "segment_fold", once)))
            rows.extend(fold_rows(name, calls + terms, segfold))
            if engine != "fallback":
                (k2,) = _capture(voxel, "compact_and_gather_exact", once)
                rows.append(_k2_batch_row(name, k2[0]))
        print(f"voxel engine {name}: {time.perf_counter() - t0:.1f} s")

    # a scatter batch of flagship scans: one segment fold launch a batch
    name = "flagship_scatter_batch"
    cfg = FLAGSHIP_CONFIG.replace(voxel_binning="scatter", voxel_payload_packing=False)
    n = cfg.max_points
    pts = np.zeros((VOXEL_BATCH, n, 3), np.float32)
    valid = np.zeros((VOXEL_BATCH, n), bool)
    for b in range(VOXEL_BATCH):
        p = _scene(b).points[:n]
        pts[b, : len(p)] = p
        valid[b, : len(p)] = True
    clouds = Cloud(points=torch.tensor(pts, device=dev), valid=torch.tensor(valid, device=dev))
    u = torch.tensor(np.random.default_rng(RANSAC_SEED).random(
        (VOXEL_BATCH, cfg.max_planes, cfg.ransac_hypotheses, 3)).astype(np.float32), device=dev)
    pipe = batched_pipeline(cfg)
    _build.reset_launch_counts()
    res = pipe(clouds, draw=draw_from_uniform(u))
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    if counts["segment_fold"] != 1 or counts["runreduce"] or counts["compact_gather"] != 2:
        raise AssertionError(f"{name}: launches {counts}: one segment fold and two K2 a batch")
    launches[name] = counts
    worst = 0.0
    for b in range(VOXEL_BATCH):
        one = process_scan(scan_of(clouds, b), cfg, draw=draw_from_uniform(u[b]))
        worst = max(worst, _compare(f"{name} scan {b}", scan_of(res, b), one))
        _assert_equal(f"{name} scan {b} point_cluster", scan_of(res, b).clusters.point_cluster,
                      one.clusters.point_cluster)
    times = _time_scans(lambda c, draw: pipe(c, draw=draw), [clouds], draw_from_uniform(u), 5)
    p50 = statistics.median(times)
    summary[name] = dict(batch_p50_ms=p50, scans=VOXEL_BATCH)
    print(f"voxel engine {name}: each scan == its single-scan card run (grid, counts, flags, "
          f"point clusters exact; centroid max |d| {worst:.2e}); batch p50 {p50:.3f} ms "
          f"({VOXEL_BATCH / p50 * 1e3:.1f} scans per second); launches {counts} [{card}]")
    rows.extend(fold_rows(name, _capture(voxel, "segment_fold",
                                         lambda: pipe(clouds, draw=draw_from_uniform(u))),
                          segfold))
    forms = {}
    for r in rows:
        if r["name"] == "segment_fold":
            forms.setdefault(r["path"], []).append(dict(
                form=r["shape"].split(":")[0], device_ops=r["device_ops"],
                profiler_ops=r["profiler_ops"], ms=r["ms"], device_ms=r["device_ms"],
                graph_ms=r["graph_ms"], host_ms=r["host_ms"], bound_ms=r["bound_ms"],
                library_device_ms=r["library_device_ms"],
                library_graph_ms=r["library_graph_ms"]))
    print("segment fold forms: " + json.dumps({"card": card, "paths": forms}))
    for r in rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    print("voxel engines: " + json.dumps({"card": card, "paths": summary}))
    return launches, rows


# ---- phase 13: the shadow stage's kernels and the reference's trig ----------


def _eager_shadows_before(grid, cloud, clusters, world_from_sensor, config):
    """The shadow stage as the port ran it before its two kernels: eager
    PyTorch over ``[..., M, C]`` and ``[..., M, H, W]``, with torch's
    ``arcsin`` and ``tan`` (on the card, CUDA's ``asinf`` and ``tanf``).
    Phase 13's yardstick of device operations only."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import f32, fma, int32_like_xla
    from pointcloud_obstacle_processing_tpu_torch.ops.shadow import _cell, _lengths, sweep_lines

    H, W = config.grid_height, config.grid_width
    M = clusters.sizes.shape[-1]
    lead = clusters.sizes.shape[:-1]
    inf = float("inf")
    spts = world_from_sensor.inverse().apply(cloud.points)
    mask = (clusters.point_cluster[..., None, :] == torch.arange(M, device=grid.device)[:, None]) \
        & cloud.valid[..., None, :]
    sx, sy = spts[..., None, :, 0], spts[..., None, :, 1]
    i_min = torch.argmin(torch.where(mask, sx, inf), dim=-1)
    vmin = spts.gather(-2, i_min[..., None].expand(*lead, M, 3))
    vmax = torch.where(mask, sx, -inf).max(dim=-1).values
    width = torch.abs(torch.where(mask, sy, -inf).max(dim=-1).values
                      - torch.where(mask, sy, inf).min(dim=-1).values)
    c, v_len = _lengths(vmin)
    e = torch.abs(vmax) - torch.abs(vmin[..., 0]) + f32(0.04)
    d = fma(torch.tan(torch.arcsin(vmin[..., 2] / torch.clamp_min(c, 1e-20))), e, f32(0.25))
    end = fma(vmin / torch.clamp_min(v_len, 1e-20)[..., None], d[..., None], vmin)
    end_world, start_world = world_from_sensor.apply(torch.cat([end, vmin], dim=-2)).split(M, -2)
    e_col, e_row = _cell(end_world, config)
    s_col, s_row = _cell(start_world, config)
    shift, n_lines = sweep_lines(width, config.block_size)
    active = clusters.valid & (mask.sum(dim=-1) >= 2)
    x0, y0, x1, y1 = s_col + shift, s_row, e_col + shift, e_row
    steep = torch.abs(y1 - y0) > torch.abs(x1 - x0)
    x0, y0 = torch.where(steep, y0, x0), torch.where(steep, x0, y0)
    x1, y1 = torch.where(steep, y1, x1), torch.where(steep, x1, y1)
    back = x0 > x1
    x0, x1 = torch.where(back, x1, x0), torch.where(back, x0, x1)
    y0, y1 = torch.where(back, y1, y0), torch.where(back, y0, y1)
    dx, dy = (x1 - x0).to(torch.float32), (y1 - y0).to(torch.float32)
    g = torch.where(dx == 0.0, 1.0, dy / torch.where(dx == 0.0, 1.0, dx))[..., None, None]
    fx0, y0f = x0.to(torch.float32)[..., None, None], y0.to(torch.float32)[..., None, None]
    ix0, ix1, n = x0[..., None, None], x1[..., None, None], n_lines[..., None, None]
    rows = torch.arange(H, dtype=torch.int32, device=grid.device).reshape(H, 1)
    cols = torch.arange(W, dtype=torch.int32, device=grid.device).reshape(1, W)

    def fy(u):
        return int32_like_xla(torch.floor(y0f + g * (u.to(torch.float32) - fx0)))

    fy_r = fy(rows)
    steep_hit = (rows >= ix0) & (rows <= ix1) & (cols >= fy_r - (n - 1)) & (cols <= fy_r + 1)
    u_lo, u_hi = torch.maximum(ix0, cols - 1), torch.minimum(ix1, cols + (n - 1))
    lo, hi = fy(u_lo), fy(u_hi)
    shallow_hit = (u_lo <= u_hi) & (rows >= torch.minimum(lo, hi)) & (rows <= torch.maximum(lo, hi))
    hit = (active[..., None, None] & torch.where(steep[..., None, None], steep_hit, shallow_hit)
           ).any(dim=-3)
    return torch.where(hit, torch.full_like(grid, config.grid_opacity), grid)


def _cuda_trig_slots(stage) -> tuple[int, int, int]:
    """On one scan's ``cast_shadows`` inputs: (active slots, slots whose
    ``d`` from CUDA's ``asinf``/``tanf`` (torch's ``arcsin``/``tan`` on
    the card) differs from the reference's, whose line differs).  The
    reference's ``d`` is ``shadow_end`` run on the card, held bitwise to
    its CPU run first; the lines are ``slot_lines`` of either end point."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import f32, fma, shadow

    grid, cloud, clusters, tf, cfg = stage
    m = clusters.valid.shape[-1]
    spts = tf.inverse().apply(cloud.points)
    vmin, vmax, hmin, hmax, count = shadow.slot_extremes(spts, clusters.point_cluster, cloud.valid,
                                                         m)
    d, end = shadow.shadow_end(vmin, vmax)
    d_cpu, _ = shadow.shadow_end(vmin.cpu(), vmax.cpu())
    _assert_equal("shadow_end on the card", d.view(torch.int32), d_cpu.view(torch.int32))
    c, v_len = shadow._lengths(vmin)
    e = torch.abs(vmax) - torch.abs(vmin[..., 0]) + f32(0.04)
    d_cuda = fma(torch.tan(torch.arcsin(vmin[..., 2] / torch.clamp_min(c, 1e-20))), e, f32(0.25))
    end_cuda = fma(vmin / torch.clamp_min(v_len, 1e-20)[..., None], d_cuda[..., None], vmin)
    active = clusters.valid & (count >= 2)

    def lines(end_sensor):
        end_world, start_world = tf.apply(torch.cat([end_sensor, vmin], dim=-2)).split(m, -2)
        return shadow.slot_lines(start_world, end_world, torch.abs(hmax - hmin), active, cfg)

    d_apart = (d_cuda.view(torch.int32) != d.view(torch.int32)) & active
    lines_apart = (lines(end_cuda) != lines(end)).any(-1) & active
    return int(active.sum()), int(d_apart.sum()), int(lines_apart.sum())


def run_shadow(dev, card: str) -> None:
    """Phase 13: the shadow kernels bitwise their plain twins on seeded
    inputs at the flagship, fullscale and batch-of-32 shapes and on the
    edge scan (``utils.shadow_cases``); the card's trig routines against
    the plain forms over a strided sweep of their domains; the stage's
    device operations and time on the flagship scan before (the earlier
    eager form) and after; and how many slots of the flagship and fullscale scans
    CUDA's own ``asinf``/``tanf`` would move."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.models import FLAGSHIP_CONFIG as cfg
    from pointcloud_obstacle_processing_tpu_torch.ops import libm, shadow
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform
    from pointcloud_obstacle_processing_tpu_torch.utils import shadow_cases

    m = cfg.max_clusters
    cases = {"flagship": shadow_cases.random_slots(0, 1, cfg.cluster_capacity, m),
             "fullscale": shadow_cases.random_slots(1, 1, 16_384, m),
             "batch": shadow_cases.random_slots(2, BATCH, cfg.cluster_capacity, m,
                                                pose_per_scan=True),
             "edges": shadow_cases.edge_slots(m)}
    for name, case in cases.items():
        args = [torch.tensor(case[k]) for k in ("points", "valid", "point_cluster", "slot_valid")]
        tf = RigidTransform.from_quat_trans(case["quat"], case["trans"])
        want = shadow.shadow_slots_plain(*args, tf, cfg)
        got = shadow.shadow_slots(*[a.to(dev) for a in args], tf.to(dev), cfg)
        _assert_equal(f"shadow_slots seeded {name}", got, want)
        grid = torch.tensor(np.random.default_rng(3).choice(
            [0, 100], (*want.shape[:-2], cfg.grid_height, cfg.grid_width)).astype(np.int8))
        want_grid = shadow.shadow_raster_plain(grid, want, 50)
        _assert_equal(f"shadow_raster seeded {name}", shadow.shadow_raster(grid.to(dev), got, 50),
                      want_grid)
        print(f"shadow kernels seeded {name} {tuple(args[0].shape)}, {m} slots: equal to plain "
              f"({int(want[..., 6].sum())} active slots) [{card}]")
        g = grid.to(dev)
        bound = _bound("shadow_raster", got[..., 0, 0].numel(), m, cfg.grid_height,
                       cfg.grid_width)[0]
        print(f"raster seeded {name}: device "
              f"{_ms(_device_ms(lambda g=g, got=got: shadow.shadow_raster(g, got, 50)))}, bound "
              f"{bound:.7f} ms [{card}]")

    for name, top in (("asin_like_xla", np.float32(1.0)),
                      ("tanf", np.nextafter(np.float32(np.pi / 2), np.float32(4)))):
        bits = np.arange(0, int(top.view(np.int32)) + 1, SHADOW_SWEEP_STRIDE, dtype=np.int32)
        x = torch.tensor(np.concatenate([bits, bits | np.int32(-2**31)]).view(np.float32))
        _assert_equal(f"libm32 {name} sweep", libm.on_card(name, x.to(dev)).view(torch.int32),
                      libm.ROUTINES[name](x).view(torch.int32))
        print(f"libm32 {name}: equal to the plain form on every {SHADOW_SWEEP_STRIDE}th float32 "
              f"of [-{top!r}, {top!r}] ({x.numel():,} values) [{card}]")

    grid, cloud, clusters, tf, scfg = SHADOW_SCANS["flagship"]
    before = lambda: _eager_shadows_before(grid, cloud, clusters, tf, scfg)  # noqa: E731
    after = lambda: shadow.cast_shadows(grid, cloud, clusters, tf, scfg)  # noqa: E731
    apart = int((before() != after().grid).sum())
    print(f"shadow stage, flagship scan: the eager form with CUDA's trig paints {apart} cells "
          f"otherwise than the kernels [{card}]")
    for label, fn in (("before (eager, CUDA trig)", before), ("after (two kernels)", after)):
        dev_ms, ops = _device_profile(fn)
        print(f"shadow stage {label}, flagship scan: {ops} device operations, device "
              f"{_ms(dev_ms)}, call {_time_ms(fn):.4f} ms, host {_host_ms(fn):.4f} ms [{card}]")
    for path, stage in SHADOW_SCANS.items():
        active, d_apart, lines_apart = _cuda_trig_slots(stage)
        print(f"CUDA asinf/tanf on the {path} scan: {d_apart} of {active} active slots get "
              f"another d than the kernel's, {lines_apart} another line [{card}]")


# ---- phase 14: the fused multiply-add chain kernel on near ties -------------

FMA_TIES = 200_000  # near-tie triples (and chain operands: 100,000 a helper)


def run_fma(dev, card: str) -> None:
    """Phase 14: ``ops.fma`` and the chain helpers on the card (one
    ``fma_chain`` launch a call) bitwise their plain forms on a CPU copy, on
    the seeded near-tie sets of ``utils.fma_cases``: triples, triples with
    a float32-subnormal result, and ``dot3``/``sum_sq3``/``add_sq3``
    operands whose second step is a near tie; each with how many elements
    the double-rounded form (the float64 sum rounded to float32) misses."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build, ops
    from pointcloud_obstacle_processing_tpu_torch.utils import fma_cases

    sets = {"fma near ties": ("fma", fma_cases.near_ties(0, FMA_TIES)),
            "fma subnormal results": ("fma", fma_cases.subnormal_ties(1, FMA_TIES // 10))}
    for kind in ("dot3", "sum_sq3", "add_sq3"):
        sets[f"{kind} near ties"] = (kind, fma_cases.chain_ties(2, FMA_TIES // 2, kind))
    for label, (kind, arrays) in sets.items():
        cpu = [torch.tensor(a) for a in arrays]
        want = getattr(ops, kind)(*cpu)
        card_ops = [t.to(dev) for t in cpu]
        _build.reset_launch_counts()
        got = getattr(ops, kind)(*card_ops)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        if launched != {"fma_chain": 1}:
            raise AssertionError(f"{label}: one fma_chain launch expected, got {launched}")
        _assert_equal(f"fma_chain {label}", got.view(torch.int32), want.view(torch.int32))
        if kind == "fma":
            a, b, c = (x.double() for x in cpu)
            old = (a * b + c).to(torch.float32)
        elif kind == "dot3":
            ax, ay, _, bx, by, _ = cpu
            old = (ax.double() * bx.double() + (ay * by).double()).to(torch.float32)
        else:
            first, second = cpu[:2] if kind == "sum_sq3" else cpu[1::-1]
            old = (second.double() * second.double() + (first * first).double()).to(torch.float32)
        missed = int((old.view(torch.int32) != want.view(torch.int32)).sum())
        print(f"fma_chain {label}: {len(cpu[0]):,} cases, equal to the plain form in one launch; "
              f"the double-rounded form misses {missed:,} [{card}]")

    # the wrapper's host time a call at two shapes (a flagship scan's
    # largest call, the voxel key with a constant; RANSAC's [1, 128]
    # hypothesis offset in its eager form), with its cached plan and with
    # the plan rebuilt every call, and part by part
    g = torch.Generator().manual_seed(0)
    shapes = {"fma [1, 100352, 3] with a constant (the voxel key)":
              (((torch.rand(1, 100_352, 3, generator=g).to(dev), ops.f32(0.04)),),
               torch.rand(1, 100_352, 3, generator=g).to(dev)),
              "dot3 [1, 128] (RANSAC's hypothesis offset, eager)":
              (tuple((torch.randn(1, 128, generator=g).to(dev),
                      torch.randn(1, 128, generator=g).to(dev)) for _ in range(3)), None)}
    for label, (pairs, c) in shapes.items():
        def cold(pairs=pairs, c=c):
            ops._chain_plan.cache_clear()
            return ops.fma_chain(pairs, c)

        parts = _fma_host_parts(pairs, c)
        print(f"fma_chain host {label}: {_host_ms(lambda p=pairs, c=c: ops.fma_chain(p, c)):.4f} "
              f"ms a call with the cached plan, {_host_ms(cold):.4f} ms with the plan rebuilt "
              f"every call; by part, us a call: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in parts.items())} [{card}]")


def _fma_host_parts(pairs, c, reps: int = 2000) -> dict:
    """The chain wrapper's host time a call (``ops._fma_chain_kernel``
    behind ``ops.fma_chain``), part by part: each part ``reps`` times back
    to back on the host's clock, in us a call; ``whole call`` is
    ``ops.fma_chain`` itself, ``rest`` what the parts leave of it (Python's
    calls and returns between them)."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build, ops

    operands = [t for pair in pairs for t in pair] + ([] if c is None else [c])
    key = tuple((t.shape, t.stride(), t.get_device(), t.dtype) for t in operands)
    shape, n, packed, slots, out_at = ops._chain_plan(len(pairs), key)
    card = next(t for t in operands if t.is_cuda)
    lib = _build.kernels()
    out = card.new_empty(shape)

    def fields():
        args = bytearray(packed)
        for t, (at, on_card) in zip(operands, slots):
            if on_card:
                ops._PTR.pack_into(args, at, t.data_ptr())
            else:
                ops._BITS.pack_into(args, at + ops._FIELD, t.item())
        ops._OUT_STREAM.pack_into(args, out_at, out.data_ptr(), _build.stream_handle())
        return bytes(args)

    args = fields()
    parts = {
        "whole call": lambda: ops.fma_chain(pairs, c),
        "operand list and CUDA test": lambda: any(
            isinstance(t, torch.Tensor) and t.is_cuda
            for t in [t for pair in pairs for t in pair] + ([] if c is None else [c])),
        "plan key (with the dtype check)":
            lambda: tuple((t.shape, t.stride(), t.get_device(), t.dtype) for t in operands),
        "plan lookup": lambda: ops._chain_plan(len(pairs), key),
        "output allocation": lambda: card.new_empty(shape),
        "fields (pointers, constants, out, stream)": fields,
        "stream handle alone": _build.stream_handle,
        "launch (ctypes call, CUDA launch, error check)":
            lambda: _build.check(lib.pcp_fma_chain(args), "fma_chain"),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        us[name] = (time.perf_counter() - t) * 1e6 / reps
        torch.cuda.synchronize()
    us["rest"] = us["whole call"] - sum(v for k, v in us.items()
                                        if k not in ("whole call", "stream handle alone"))
    return us


# ---- phase 15: RANSAC's round kernels ---------------------------------------

# (scans, rows, hypotheses) of the seeded cases: rows off the 256-row tile,
# K from 1 to past the 1,024 planes a block stages at once
RANSAC_CASES = [(1, 24_576, 128), (32, 1_500, 128), (3, 777, 200), (1, 3_001, 1_000),
                (2, 1_000, 1), (2, 300, 1_100)]


def _ransac_equal(label: str, got, want) -> None:
    """Two results of RANSAC's kernels (``RoundScore``, ``RoundState``, or
    tuples of tensors) bitwise alike, field by field."""
    import torch

    fields = getattr(want, "_fields", range(len(want)))
    for field, g, w in zip(fields, got, want, strict=True):
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        _assert_equal(f"{label} {field}", g, w)


def _cpu(v):
    """``v`` with every tensor of more than 0 dims (and a NamedTuple's) on
    the CPU: a copy of a call's arguments for the plain version there."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.cpu() if v.dim() else v
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*(_cpu(x) for x in v))
    if isinstance(v, (tuple, list)):
        return type(v)(_cpu(x) for x in v)
    return v


def _fresh(args):
    """A closing call's arguments with a fresh copy of its state, which the
    kernel updates in place."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    return (*args[:-1], ransac.RoundState(*[t.clone() for t in args[-1]]))


# calls ``_row`` makes of a kernel's wrapper at most: ``_time_ms`` 21,
# ``_device_ms`` 1 and 2 x 20 a profiler session, ``_host_ms`` 201
ROW_CALLS = 21 + 1 + PROFILER_SESSIONS * 2 * 20 + 201
# the score kernel's forms (rows a thread, hypotheses a z-slice) timed on
# each path's first round
SCORE_FORMS = ((2, 32), (2, 64), (2, 128), (8, 32), (8, 64), (8, 128))


def _each_on_a_copy(args, count: int = ROW_CALLS):
    """``plane_inliers_close`` on ``args``, each call on the next of
    ``count`` copies of the state made beforehand: the kernel updates the
    state in place, so a second call on one state would find the round's
    inliers already taken, and every timed call is to be the path's own."""
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    states = iter([ransac.RoundState(*[t.clone() for t in args[-1]]) for _ in range(count)])
    return lambda: ransac.plane_inliers_close(*args[:-1], next(states))


def _score_host_parts(args, reps: int = 2000) -> dict:
    """The score wrapper's host time a call (``ops.ransac.
    ransac_hypotheses_score`` on ``args``, a path's captured call), part by
    part: each part ``reps`` times back to back on the host's clock, in us
    a call; ``rest`` is what the parts leave of the whole call."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    points, valid, tri, n_valid, thresh, cos_min, axis = args
    operands = (points, valid, tri, n_valid)
    consts = (float(thresh), float(cos_min), tuple(axis))

    def key():
        return tuple((t.shape, t.stride(), t.get_device(), t.dtype) for t in operands)

    b, k, packed = ransac._score_plan(key(), consts, None)
    stream = _build.stream_handle()
    scratch = ransac._score_scratch(points, stream, b * k + b)
    found, normal, d = ransac._score_outputs(points, b)
    lib = _build.kernels()

    def fields():
        out = bytearray(packed)
        ransac._SCORE_IN.pack_into(out, 0, points.data_ptr(), valid.data_ptr(), tri.data_ptr(),
                                   n_valid.data_ptr())
        ransac._SCORE_OUT.pack_into(out, ransac._SCORE_OUT_AT, scratch.data_ptr(),
                                    found.data_ptr(), normal.data_ptr(), d.data_ptr(), 0, 0,
                                    stream)
        return bytes(out)

    packed_args = fields()
    parts = {
        "whole call": lambda: ransac.ransac_hypotheses_score(*args),
        "constants (three floats and the axis)":
            lambda: (float(thresh), float(cos_min), tuple(axis)),
        "layout key": key,
        "plan lookup (with its key)": lambda: ransac._score_plan(key(), consts, None),
        "outputs (one allocation, three views)": lambda: ransac._score_outputs(points, b),
        "stream handle": _build.stream_handle,
        "scratch lookup": lambda: ransac._score_scratch(points, stream, b * k + b),
        "fields (pointers)": fields,
        "launch (ctypes call, CUDA launch, error check)":
            lambda: _build.check(lib.pcp_ransac_score(packed_args), "ransac_hypotheses_score"),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        us[name] = (time.perf_counter() - t) * 1e6 / reps
        torch.cuda.synchronize()
    us["rest"] = us["whole call"] - sum(v for k, v in us.items()
                                        if k not in ("whole call", "plan lookup (with its key)"))
    return us


def _ransac_rows(path: str, run: dict, card: str) -> list[dict]:
    """RANSAC's kernels on every call of a path's run: each held bitwise
    against its plain version on the card (the first also on a CPU copy),
    then timed on the first round's score call, the first refinement mask
    and the first closing mask beside the plain version on the card; the
    score kernel's forms on the first round, and its wrapper's host time
    part by part."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import ransac

    for i, args in enumerate(run["score"]):
        want = ransac.ransac_hypotheses_score_plain(*args)
        _ransac_equal(f"ransac_hypotheses_score {path} round {i}",
                      ransac.ransac_hypotheses_score(*args), want)
        if not i:
            _ransac_equal(f"ransac_hypotheses_score {path} round {i} (CPU plain)", want,
                          ransac.ransac_hypotheses_score_plain(*_cpu(args)))
    for i, (args, kw) in enumerate(run["mask"]):
        want = ransac.plane_inliers_plain(*args, **kw)
        _assert_equal(f"plane_inliers {path} call {i}", ransac.plane_inliers(*args, **kw), want)
        if not i:
            _assert_equal(f"plane_inliers {path} call {i} (CPU plain)", want,
                          ransac.plane_inliers_plain(*_cpu(args), **_cpu(kw)))
    for i, args in enumerate(run["close"]):
        want = ransac.plane_inliers_close_plain(*args)
        _ransac_equal(f"plane_inliers_close {path} round {i}",
                      ransac.plane_inliers_close(*_fresh(args)), want)
        if not i:
            _ransac_equal(f"plane_inliers_close {path} round {i} (CPU plain)", want,
                          ransac.plane_inliers_close_plain(*_cpu(args)))
    args = run["score"][0]
    points, valid = args[:2]
    scans, n, k = *valid.shape, args[2].shape[1]
    rows = int(valid.sum())
    margs, mkw = next(c for c in run["mask"] if c[1])  # a refinement's mask, with its select
    cargs = run["close"][0]
    closed = ransac.plane_inliers_close_plain(*cargs)
    _, _, _, found, active, _, state = cargs
    af = active & found
    close_counts = (scans, n, int(active.sum()), int(af.sum()),
                    int((state.valid & af[:, None]).sum()), int((state.valid & ~closed.valid).sum()))

    want = ransac.ransac_hypotheses_score(*args)
    consts = (float(args[4]), float(args[5]), tuple(args[6]))
    times = {}
    for form in SCORE_FORMS:
        _ransac_equal(f"ransac_hypotheses_score {path} round 0 form {form}",
                      ransac._score_launch(args[:4], consts, form), want)
        times[form] = _device_ms(lambda form=form: ransac._score_launch(args[:4], consts, form))
    torch.cuda.synchronize()
    auto = ransac.score_form(scans, n, k, ransac._sms(points.get_device()))
    print(f"score forms {path}: {scans} x {n} rows ({rows} valid), K {k}, score_form's {auto}; "
          f"device ms: " + ", ".join(f"{f} {_ms(v)}" for f, v in times.items())
          + f"; each form equal [{card}]")
    parts = _score_host_parts(args)
    print(f"score host {path}: by part, us a call: "
          f"{', '.join(f'{key} {v:.2f}' for key, v in parts.items())} [{card}]")
    return [
        _row("ransac_hypotheses_score", path,
             f"round 0: {scans} x {n} rows ({rows} valid) against {k} hypotheses a scan, built "
             f"from the draws; {len(run['score'])} rounds a run, all equal", "ransac_score.cu",
             "ransac.py:124-168 (the hypotheses' planes, gate, scoring and selection; plain "
             "XLA, no TPU kernel)", 0.0, lambda: ransac.ransac_hypotheses_score(*args),
             lambda: ransac.ransac_hypotheses_score_plain(*args),
             _bound("ransac_hypotheses_score", scans, n, k, rows), plain_reps=5),
        _row("plane_inliers", path,
             f"a refinement's mask: {scans} x {n} rows; {len(run['mask'])} calls a run, all "
             f"equal", "ransac_score.cu",
             "ransac.py:194-204 (the refinement's mask; plain XLA, no TPU kernel)", 0.0,
             lambda: ransac.plane_inliers(*margs, **mkw),
             lambda: ransac.plane_inliers_plain(*margs, **mkw),
             _bound("plane_inliers", scans, n, True), plain_reps=5),
        _row("plane_inliers_close", path,
             f"round 0's closing mask: {scans} x {n} rows, {close_counts[2]} scan(s) active, "
             f"{close_counts[3]} found, {close_counts[4]} valid rows tested, {close_counts[5]} "
             f"inliers; {len(run['close'])} calls a run, all equal; each timed call on a fresh "
             f"copy of the state", "ransac_score.cu",
             "ransac.py:194-214, 264-276 (the round's last mask and the loop's state; plain "
             "XLA, no TPU kernel)", 0.0, _each_on_a_copy(cargs),
             lambda: ransac.plane_inliers_close_plain(*cargs),
             _bound("plane_inliers_close", *close_counts), plain_reps=5),
    ]


def _stage_numbers(fn) -> str:
    """Device operations, device time and peak new device memory of one
    call of ``fn``."""
    import torch

    dev_ms, ops = _device_profile(fn, reps=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    return (f"{ops} device operations, device {_ms(dev_ms)}, call {_time_ms(fn, 5):.4f} ms, "
            f"peak {peak:.1f} MiB above the inputs")


def run_ransac(dev, card: str, launches: dict) -> list[dict]:
    """Phase 15: RANSAC's kernels bitwise their plain versions on seeded
    rounds and on every scan path's own calls, the launches a run, each
    kernel timed beside its plain version, the score kernel's forms and
    host time, and the RANSAC stage with the kernels and with the plain
    versions.  Returns the kernel rows."""
    import torch

    from pointcloud_obstacle_processing_tpu_torch import _build, pipeline
    from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG
    from pointcloud_obstacle_processing_tpu_torch.ops import ransac
    from pointcloud_obstacle_processing_tpu_torch.utils import ransac_cases

    gates = {"radians": REFERENCE_YAML_CONFIG.eps_angle_radians,
             "degrees": REFERENCE_YAML_CONFIG.replace(
                 pcl_compat_eps_angle_bug=False).eps_angle_radians}
    for scans, n, k in RANSAC_CASES:
        for kind in ("probes", "ties", "gated", "random"):
            c = ransac_cases.round_case(n + k, scans, n, k, kind)
            args = [torch.tensor(c[f]) for f in ("points", "valid", "tri", "n_valid")]
            on_card = [a.to(dev) for a in args]
            for gate, eps in gates.items():
                cos_min = ransac.axis_cos_min(eps)
                planes = ransac.hypotheses_plain(args[0], args[2], args[3], cos_min,
                                                 (0.0, 0.0, 1.0))
                full = ransac.ransac_score_plain(*args[:2], *planes, c["thresh"])
                want = ransac.RoundScore(full.found, full.normal, full.d)
                label = f"ransac_hypotheses_score seeded {kind} {gate} {(scans, n, k)}"
                for rep in range(2):  # the cached scratch and tickets reset themselves
                    _build.reset_launch_counts()
                    got = ransac.ransac_hypotheses_score(*on_card, c["thresh"], cos_min)
                    torch.cuda.synchronize()
                    if {key: v for key, v in _build.LAUNCHES.items() if v} != \
                            {"ransac_hypotheses_score": 1}:
                        raise AssertionError(f"{label}: launches {_build.LAUNCHES}")
                    _ransac_equal(f"{label} call {rep}", got, want)
                res, counts, best = ransac._score_launch(
                    on_card, (float(c["thresh"]), float(cos_min), (0.0, 0.0, 1.0)), detail=True)
                _ransac_equal(f"{label} with counts", (counts, best, *res), full[:5])
        rng = np.random.default_rng(n)
        c = ransac_cases.round_case(n * 3 + k, scans, n, k, "probes")
        points, valid, tri, n_valid = (torch.tensor(c[f]) for f in ("points", "valid", "tri",
                                                                     "n_valid"))
        state = ransac.RoundState(
            valid=valid, union=torch.tensor(rng.random((scans, n)) < 0.3),
            last=torch.tensor(rng.random((scans, n)) < 0.3),
            coeffs=torch.tensor(rng.standard_normal((scans, 4, 4)).astype(np.float32)),
            pvalid=torch.tensor(rng.random((scans, 4)) < 0.5),
            i=torch.tensor(rng.integers(0, 5, scans), dtype=torch.int32),
            found=torch.tensor(rng.random(scans) < 0.5))
        plane = ransac.ransac_hypotheses_score_plain(points, valid, tri, n_valid, c["thresh"],
                                                     ransac.axis_cos_min(gates["radians"]),
                                                     (0.0, 0.0, 1.0))
        close = (points, plane.normal, plane.d, plane.found,
                 torch.tensor(rng.random(scans) < 0.8), c["thresh"], state)
        want = ransac.plane_inliers_close_plain(*close)
        _build.reset_launch_counts()
        got = ransac.plane_inliers_close(*_fresh([
            *[a.to(dev) if a.dim() else a for a in close[:-1]],
            ransac.RoundState(*[t.to(dev) for t in state])]))
        torch.cuda.synchronize()
        if {key: v for key, v in _build.LAUNCHES.items() if v} != {"plane_inliers_close": 1}:
            raise AssertionError(f"plane_inliers_close seeded: launches {_build.LAUNCHES}")
        _ransac_equal(f"plane_inliers_close seeded {(scans, n)}", got, want)
        print(f"ransac seeded {(scans, n, k)}: ransac_hypotheses_score on probes, ties, "
              f"degenerate draws and random draws at both gates (one launch a call; the counts "
              f"and winner too) and plane_inliers_close (one launch) each equal to the plain "
              f"version on a CPU copy [{card}]")

    rows = []
    for path, run in RANSAC_RUNS.items():
        cfg = run["config"]
        # a round a plane slot, for each RANSAC run of the path's counted
        # run (the flagship path counts its three scenes' scans)
        runs, rounds = run["runs"], cfg.max_planes
        want = {"ransac_hypotheses_score": runs * rounds,
                "plane_inliers": runs * rounds * cfg.ransac_refine_iters,
                "plane_inliers_close": runs * rounds}
        got = {key: launches[path][key] for key in want}
        if got != want or len(run["score"]) != rounds or len(run["close"]) != rounds:
            raise AssertionError(f"{path}: RANSAC launches {got} over {runs} run(s), expected "
                                 f"{want}")
        if path in ("flagship", "fullscale", "fullscale_bandoff", "flagship_batch") and \
                launches[path]["fma_chain"] != FMA_A_SCAN * runs:
            raise AssertionError(f"{path}: {launches[path]['fma_chain']} fma_chain launches over "
                                 f"{runs} run(s), expected {FMA_A_SCAN} a run")
        rows += _ransac_rows(path, run, card)
        print(f"ransac {path}: every call of the run equal to the plain version; launches {got}, "
              f"fma_chain {launches[path]['fma_chain']} over {runs} run(s) [{card}]")
    for path, run in RANSAC_RUNS.items():
        args, kw = run["stage"]

        def stage(args=args, kw=kw):
            pipeline.segment_planes(*args, **kw)

        _build.reset_launch_counts()
        stage()
        torch.cuda.synchronize()
        if _build.LAUNCHES["fma_chain"]:
            raise AssertionError(f"ransac stage {path}: {_build.LAUNCHES['fma_chain']} fma_chain "
                                 f"launches, expected none")
        kernels = _stage_numbers(stage)
        names = ("ransac_hypotheses_score", "plane_inliers", "plane_inliers_close")
        saved = [getattr(ransac, name) for name in names]
        for name in names:
            setattr(ransac, name, getattr(ransac, f"{name}_plain"))
        try:
            plain = _stage_numbers(stage)
        finally:
            for name, fn in zip(names, saved):
                setattr(ransac, name, fn)
        print(f"ransac stage {path}: with the kernels {kernels}; the plain versions {plain} "
              f"[{card}]")
    return rows


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
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

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
    t = time.perf_counter()
    launches["node_flagship"], flagship_rows, node = run_node_flagship(dev, card)
    launches["node_fullscale"], fullscale_rows, node_fs = run_node_fullscale(dev, card)
    for r in flagship_rows + fullscale_rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    rows += flagship_rows + fullscale_rows
    print("node: " + json.dumps({"flagship": node, "fullscale": node_fs}))
    print(f"phase 9 (node): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    sp_launches, sp_rows = run_sharded(dev, card)
    launches.update(sp_launches)
    rows += sp_rows
    print(f"phase 10 (point-sharded, 4 ranks on one card): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches["fullscale_batch"], fb_rows = run_fullscale_batch(dev, card)
    for r in fb_rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    rows += fb_rows
    run_knn_engines(dev, card)
    print(f"phase 11 (fullscale batch, kNN engines): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    voxel_launches, voxel_rows = run_voxel_engines(dev, card)
    launches.update(voxel_launches)
    rows += voxel_rows
    print(f"phase 12 (voxel engines): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run_shadow(dev, card)
    print(f"phase 13 (shadow kernels, trig): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    run_fma(dev, card)
    print(f"phase 14 (fma_chain near ties): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ransac_rows = run_ransac(dev, card, launches)
    for r in ransac_rows:
        print(f"kernel {r['name']} [{r['path']}: {r['shape']}]: equal to plain; {_times(r)} "
              f"[{card}]")
    rows += ransac_rows
    print(f"phase 15 (RANSAC kernels): {time.perf_counter() - t:.1f} s")

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
