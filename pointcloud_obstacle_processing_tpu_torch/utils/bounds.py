"""The least time the H100 could take for each kernel's and each stage's
work: the port's roofline.

Counterpart of ``pointcloud_obstacle_processing_tpu/utils/bounds.py``, whose
model is the TPU v5e's (its VPU, MXU and serialized gathers); none of its
numbers carry over.  Here a bound is the larger of two times: the bytes the
work must move, each input read once and each output written once, over the
card's memory rate, and the operations it must do over the card's peak rate
for their type.  Counts come from the shapes and from what the run's data
needs (runs kept, live tiles, valid points, sweeps), never from how a
kernel reads or recomputes them, so a bound reads the same work whatever
implements it.  ``chip_smoke.py`` prints every kernel's bound from this
module; ``tests/test_torch_bounds.py`` holds the functions to the bounds in
``PERF.md``'s kernel table.

The card's published peaks (NVIDIA H100 SXM data sheet, 700 W, dense,
without sparsity):

* ``HBM_BYTES_PER_S`` = 3.35e12 B/s, HBM3.
* ``FP32_OPS_PER_S`` = 67e12 op/s, float32 outside the tensor cores.
* ``FP64_OPS_PER_S`` = 34e12 op/s, float64 outside the tensor cores
  (RANSAC scores its hypotheses in float64).

A card set below 700 W runs slower under load; ``nvidia-smi`` gives its
limit, which every measurement names beside these bounds.
"""

from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "FP64_OPS_PER_S", "D2_OPS", "LATENCY_CLASS",
           "stage_bounds", "runreduce", "runreduce_counts", "compact_gather", "knn_mean",
           "cluster_sweep", "cluster_loop", "cluster_grid_loop", "cluster_sweep_banded",
           "segscan", "binned_sum", "xla_sum", "covariance_tail", "segment_fold"]

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# float32 operations a scored pair of points in the distance kernels (K3-K5):
# the cross term's multiply and two fused multiply-adds; the d2 add,
# multiply and subtract; the compare with the tolerance
D2_OPS = 9

# bytes a packed cluster point: x, y, z, |p|^2 (16), the label (4) and the
# valid byte (1)
_CLUSTER_POINT_BYTES = 21


def _bound(n_bytes: float, fp32_ops: float = 0.0, fp64_ops: float = 0.0) -> tuple[float, str]:
    """``(seconds, limiter)``: the larger of the bytes' time and the
    operations' time (float32 and float64 at their own peaks, added);
    ``limiter`` is "bytes" or "operations"."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = fp32_ops / FP32_OPS_PER_S + fp64_ops / FP64_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def runreduce(n: int, kept: int, window: int, scans: int = 1,
              payloads: int = 2) -> tuple[float, str]:
    """K1, a run reduce over ``scans`` key-sorted buffers of ``n`` rows: the
    keys and ``payloads`` int32 payload words a row read once, the ``kept``
    runs' slots (key and four sums, 20 bytes) and each scan's count written;
    four channels of log2(``window``) Hillis-Steele adds a row."""
    return _bound(scans * n * (4 + 4 * payloads) + kept * 20 + scans * 4,
                  4 * scans * n * int(math.log2(window)))


def runreduce_counts(n: int, kept: int, window: int, scans: int = 1) -> tuple[float, str]:
    """K1's counts mode (the voxel-table merges): three payload words and
    the count buffer a row."""
    return runreduce(n, kept, window, scans, payloads=4)


def compact_gather(slots: int, kept: int, channels: int = 4, scans: int = 1) -> tuple[float, str]:
    """K2, a stable compaction of ``slots`` entries a scan: the occupancy
    mask (a byte an entry) read once; each of the ``kept`` filled slots'
    channels read, its index and channels written; each scan's count."""
    return _bound(scans * slots + kept * (4 * channels + 4 + 4 * channels) + scans * 4)


def knn_mean(rows: int, tiles: int, out_tiles: int, live_tiles: int, row_tile: int, width: int,
             scans: int = 1) -> tuple[float, str]:
    """K3, the banded kNN mean: the channels, |p|^2 and the mask (17 bytes a
    row) read once, the tiles' window starts, the means of ``out_tiles``
    query tiles written; each live query tile scores its rows against its
    ``width``-column window."""
    return _bound(scans * rows * 17 + tiles * 4 + scans * out_tiles * row_tile * 4,
                  live_tiles * row_tile * width * D2_OPS)


def cluster_sweep(c: int, rows: int, q_valid: int, n_valid: int) -> tuple[float, str]:
    """K4, one full sweep over a range of ``rows`` query rows of a
    ``c``-point buffer: the packed points read once, the range's labels
    written; its ``q_valid`` valid rows against every valid column."""
    return _bound(c * _CLUSTER_POINT_BYTES + rows * 4, q_valid * n_valid * D2_OPS)


def cluster_loop(c: int, n_valid, sweeps) -> tuple[float, str]:
    """K4's whole loop (the loop kernel, or the grid-wide loop above it):
    ``n_valid`` and ``sweeps`` give each scan's valid points and sweeps run.
    The packed points read once, the labels, the flag and the sweep count
    written; each sweep scores every pair of valid points."""
    n_valid, sweeps = list(n_valid), list(sweeps)
    pairs = sum(float(s) * float(v) ** 2 for s, v in zip(sweeps, n_valid))
    return _bound(len(n_valid) * (c * _CLUSTER_POINT_BYTES + c * 4 + 5), pairs * D2_OPS)


cluster_grid_loop = cluster_loop  # the same work, above the loop kernel's capacity


def cluster_sweep_banded(c: int, tile: int, window: int, computed: int, scans: int = 1,
                         out_rows: int | None = None) -> tuple[float, str]:
    """K5, one banded sweep: the packed points, each tile's start and live
    flag (5 bytes) read once, ``out_rows`` labels a scan written (default
    every row); each of the ``computed`` tiles (live and holding a valid
    row) scores ``tile`` rows against its ``window``."""
    out_rows = c if out_rows is None else out_rows
    return _bound(scans * (c * _CLUSTER_POINT_BYTES + (c // tile) * 5 + out_rows * 4),
                  computed * tile * window * D2_OPS)


def segscan(channels: int, n: int, steps: int) -> tuple[float, str]:
    """K6, a segmented inclusive scan of ``channels`` rows of ``n`` float32
    values: values read and written once, the head flags (a byte a value)
    read once; one add a value a Hillis-Steele step."""
    return _bound(channels * n * 8 + n, steps * channels * n)


def binned_sum(n: int, channels: int, k: int, terms: int) -> tuple[float, str]:
    """K7, weighted bin sums: ids, weights and the valid byte a row read
    once, ``k`` bins of ``channels`` written; one add a nonzero split
    term."""
    return _bound(n * (4 + 4 * channels + 1) + k * channels * 4, terms)


def xla_sum(lead: int, rows_a: int, n: int, rows_b: int | None = None) -> tuple[float, str]:
    """The sum kernel (``ops.sum_like_xla``): ``lead`` x ``rows_a`` rows of
    ``n`` values (and ``rows_b`` rows to multiply them with) read once, the
    ``lead * rows_a * rows_b`` sums written; an add (and a product) a term."""
    sb = 1 if rows_b is None else rows_b
    return _bound(lead * (rows_a + (0 if rows_b is None else rows_b)) * n * 4 + lead * rows_a * sb * 4,
                  lead * rows_a * sb * n * (1 if rows_b is None else 2))


def covariance_tail(scans: int, n: int) -> tuple[float, str]:
    """RANSAC's refinement step (``ops.ransac.covariance_tail``): six rows
    of ``n`` read once, 8 floats in and 4 out a scan; the nine sums'
    products and adds, then the 3x3 tail's 24 steps of ~50 operations."""
    return _bound(scans * (6 * n + 12) * 4, scans * (9 * n * 2 + 24 * 50))


def segment_fold(scans: int, n: int, channels: int, width: int, order: bool = False,
                 bf16_terms: int = 0) -> tuple[float, str]:
    """The segment fold: each row's dest (4 bytes), its sort permutation
    entry (8, with ``order``) and its ``channels`` values read once, the
    ``width`` bins of ``channels`` a scan written once; an add a value and
    term, and one more a bin channel where two split terms are added."""
    terms = max(1, bf16_terms)
    return _bound(scans * n * (4 + (8 if order else 0) + 4 * channels)
                  + scans * width * 4 * channels,
                  scans * n * channels * terms
                  + (scans * width * channels if bf16_terms == 2 else 0))


def stage_bounds(cfg, n_valid: int, n_voxels: int, n_cluster_rows: int, sweeps: int = 5) -> dict:
    """``{stage: (seconds, limiter, note)}`` for one scan or window on the
    card, with the reference's stage keys.

    ``n_valid``: points in the window; ``n_voxels``: live voxel-table rows
    entering the kNN stage; ``n_cluster_rows``: live rows entering the
    cluster stage; ``sweeps``: label-propagation sweeps to convergence.
    """
    N, V, C = cfg.max_points, cfg.max_voxels, cfg.cluster_capacity
    H, W = cfg.grid_height, cfg.grid_width
    out = {}

    # 1. crop + seed: the points (12 B) and the mask read, the cropped cloud
    #    and its mask written; the occupancy histogram is an int32
    #    scatter-add of the cropped points into [H, W] (written once)
    out["crop+seed"] = _bound(N * 13 * 2 + H * W * 4) + (
        "point stream and the [H, W] int32 histogram",)

    # 2. voxel (the sort engine): a stable radix sort of the int32 key with
    #    an int64 permutation, 8 bits a pass (key and permutation read and
    #    written each pass); the payloads (12 B) gathered by the permutation;
    #    then K1's stream (keys and payloads read, V slots of 20 B written)
    passes = 32 // 8
    sort_bytes = passes * N * (4 + 8) * 2
    gather_bytes = N * (8 + 12 + 12)
    reduce_bytes = N * 16 + V * 20
    out["voxel"] = _bound(sort_bytes + gather_bytes + reduce_bytes) + (
        f"{passes}-pass radix sort + payload gather + run-reduce stream",)

    # 3. outlier (K3): each live row scores its band's window, D2_OPS a pair;
    #    the voxel table (17 B a row) read once, the means written
    T = cfg.knn_row_tile
    Wk = min(T + 2 * cfg.knn_band, V)
    live_tiles = math.ceil(n_voxels / T)
    out["outlier"] = _bound(V * 17 + V * 4, live_tiles * T * Wk * D2_OPS) + (
        f"{n_voxels} rows x {Wk} window x {D2_OPS} fp32 ops",)

    # 4. RANSAC: each round scores every hypothesis against every live row
    #    in float64 (the plane distance's three products and three adds, the
    #    absolute value and the compare: 8 operations), then refines the
    #    best; the points (16 B) read twice a round, the inlier mask written
    K = cfg.ransac_hypotheses
    rounds = cfg.max_planes
    out["ransac"] = _bound(rounds * n_voxels * (16 * 2 + 1),
                           fp64_ops=8.0 * rounds * K * n_voxels) + (
        f"{rounds} rounds x {K} hyp x {n_voxels} rows, float64",)

    # 5. compact (K2): the mask once, the non-plane rows' 4 channels moved
    rows = min(n_cluster_rows, C)
    out["compact"] = _bound(V + rows * (16 + 4 + 16) + 4) + ("stream compaction",)

    # 6. cluster: each sweep scores the valid rows against their window (the
    #    whole buffer for the full sweep); the full sweep is one launch (the
    #    points read once), the banded sweep a launch a sweep (read a sweep).
    #    The pointer jump runs inside the kernels: no serialized gather.
    Wc = min(cfg.cluster_band_window or C, C)
    launches = sweeps if cfg.cluster_band_window else 1
    clus_bytes = launches * (C * _CLUSTER_POINT_BYTES + C * 4) + 5
    out["cluster"] = _bound(clus_bytes, float(sweeps) * rows * min(rows, Wc) * D2_OPS) + (
        f"{sweeps} sweeps x {rows} rows x {min(rows, Wc)} columns",)

    # 7. glue (centroids + shadows + grid marks): a chain of small launches
    #    whose time is launch latency, not bytes or operations; the traffic
    #    bound is orders below it and not a meaningful floor
    out["glue"] = _bound(rows * 16 * 4 + cfg.max_clusters * H * W * 1.0) + (
        "latency-class small kernels (bound not meaningful)",)
    return out


# stages whose time on the card is launch latency and the host's issue
# rate, not bytes or operations: their share of the bound is no drift
# signal.  RANSAC issues about half of a scan's ~1,930 launches; compact
# moves a few hundred rows; the glue is dozens of small launches.
LATENCY_CLASS = {"glue", "ransac", "compact"}
