"""The port's roofline (``utils/bounds.py``): each kernel's bound at the
shapes of each row of PERF.md's kernel table is the bound that row prints,
to its printed digits (``chip_smoke.py`` prints every bound from this
module); ``stage_bounds`` keeps the reference's stage keys and latency
class.  The shapes are the ones ``chip_smoke.py`` printed beside each bound
on the H100."""

from __future__ import annotations

import os
import re

import pytest

import pointcloud_obstacle_processing_tpu.models as ref_models
from pointcloud_obstacle_processing_tpu.utils import bounds as ref_bounds

import pointcloud_obstacle_processing_tpu_torch.models as port_models
from pointcloud_obstacle_processing_tpu_torch.utils import bounds

PERF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "PERF.md")

# (a substring naming PERF.md's table row, the bound's function and
# arguments, the bound that row prints in ms).  Data-dependent counts (runs
# kept, live tiles, valid points, sweeps) are those the row's shape prints;
# a compacted cloud's live tiles are its valid rows over the row tile,
# rounded up.
ROWS = [
    # K1: flagship 21,154 runs; fullscale 166,000 lattice cells; runs over windows
    ("`_pallas_batched` :742", "runreduce", (100_352, 21_154, 1024), "0.0005"),
    ("`_pallas_batched` :742", "runreduce", (2_097_152, 166_000, 4096), "0.0085"),
    ("`_pallas_batched` :742", "runreduce", (2_097_152, 334, 4096), "0.0075"),
    ("`_pallas_batched8` :881", "runreduce", (100_352, 681_856, 1024, 32), "0.0156"),
    # K2: 641 and 7,102 occupied; the batch 19,948
    ("`_pallas_compact_gather_batched` :185", "compact_gather", (24_576, 641), "0.000014"),
    ("`_pallas_compact_gather_batched` :185", "compact_gather", (262_144, 7_102), "0.000155"),
    ("`_pallas_compact_gather_batched` :185", "compact_gather", (24_576, 19_948, 4, 32),
     "0.0004"),
    # K3 on the scans' voxel clouds: 21,521 of 24,576 (57 live tiles of 384),
    # 165,898 of 262,144 (163 of 1,024)
    ("`_sortnet_mean_pallas` :142 (vmapped", "knn_mean", (24_576, 64, 64, 57, 384, 1408),
     "0.0041"),
    ("`_sortnet_mean_pallas` :142 (vmapped", "knn_mean", (262_144, 256, 256, 163, 1024, 3584),
     "0.0804"),
    # K4's loop: 600 valid, 4 sweeps; the scan's 566 valid, 5 sweeps
    ("`_pallas_sweep_jump` :86 (and the", "cluster_loop", (1024, [600], [4]), "0.00019"),
    ("`_pallas_sweep_jump` :86 (and the", "cluster_loop", (1024, [566], [5]), "0.00022"),
    # the grid-wide loop: band off 7,069 valid, 8 sweeps; C 10,240, 6,400 valid, 6 sweeps
    ("the same above 2,048 points", "cluster_grid_loop", (16_384, [7_069], [8]), "0.0537"),
    ("the same above 2,048 points", "cluster_grid_loop", (10_240, [6_400], [6]), "0.0330"),
    # K5: 55 and 26 tiles computed; the batch of 2, 123
    ("`_pallas_sweep_jump_banded` :329 (one scan)", "cluster_sweep_banded",
     (16_384, 128, 4096, 55), "0.0039"),
    ("`_pallas_sweep_jump_banded` :329 (one scan)", "cluster_sweep_banded",
     (16_384, 128, 4096, 26), "0.0018"),
    ("| K5 batch |", "cluster_sweep_banded", (16_384, 128, 4096, 123, 2), "0.0087"),
    # K6: 17 and 21 steps
    ("`_segscan_pallas` :59", "segscan", (4, 131_072, 17), "0.0013"),
    ("`_segscan_pallas` :59", "segscan", (4, 2_097_152, 21), "0.0207"),
    # K7: N 131,072, k 214,000, C 4, at most two terms of each of 117,912 valid rows
    ("`_kernel` :52", "binned_sum", (131_072, 4, 214_000, 2 * 4 * 117_912), "0.0018"),
    # the sum kernel's masked sums; covariance_tail
    ("`jnp.sum` in XLA:CPU's order", "xla_sum", (1, 4, 24_576), "0.00012"),
    ("`jnp.sum` in XLA:CPU's order", "xla_sum", (1, 4, 262_144), "0.00125"),
    ("`jnp.sum` in XLA:CPU's order", "xla_sum", (32, 4, 24_576), "0.0038"),
    ("RANSAC's refinement step", "covariance_tail", (1, 24_576), "0.00018"),
    ("RANSAC's refinement step", "covariance_tail", (1, 262_144), "0.0019"),
    ("RANSAC's refinement step", "covariance_tail", (32, 24_576), "0.0056"),
    # the multi-device rows: 37,710 and 165,898 runs; the dense merge's
    # 21,521 occupied; whole tiles of the merged clouds, all live; rank 0's
    # first 256 rows, all valid
    ("| K1 counts mode |", "runreduce_counts", (524_288, 37_710, 1024), "0.0034"),
    ("| K1 counts mode |", "runreduce_counts", (1_048_576, 165_898, 4096), "0.0073"),
    ("the dense merge's bins", "compact_gather", (229_888, 21_521), "0.0003"),
    ("| K3 rows |", "knn_mean", (24_576, 64, 16, 16, 384, 1408), "0.0012"),
    ("| K3 rows |", "knn_mean", (262_144, 256, 64, 64, 1024, 3584), "0.0316"),
    ("| K4 rows |", "cluster_sweep", (1024, 256, 256, 566), "0.00002"),
    ("| K5 rows |", "cluster_sweep_banded", (16_384, 128, 4096, 32, 1, 32 * 128), "0.0023"),
    ("| K1 shard |", "runreduce", (25_088, 14_419, 512), "0.0002"),
    ("| K1 shard |", "runreduce", (524_288, 145_031, 1024), "0.0027"),
    # the segment fold: the fused calls (the sort's permutation, the split
    # terms, the 128-padded width), and the unfused fold launches alone
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 100_352, 4, 230_144, True, 1),
     "0.0019"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 100_352, 4, 230_144, True, 2),
     "0.0019"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 100_352, 4, 229_888, True), "0.0019"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 2_097_152, 4, 3_988_864, True),
     "0.0366"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 100_352, 4, 98_304), "0.0011"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (4, 100_352, 4, 229_888, True), "0.0077"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 100_352, 4, 230_080), "0.0017"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (1, 2_097_152, 4, 3_988_864), "0.0316"),
    ("XLA:CPU's in-order scatter-add", "segment_fold", (4, 100_352, 4, 229_888), "0.0068"),
    # K2 on the dense engines' bins; K1 on the Morton keys
    ("the dense engines' bins", "compact_gather", (230_144, 21_521), "0.0003"),
    ("the dense engines' bins", "compact_gather", (3_988_864, 165_898), "0.0030"),
    ("the Morton keys", "runreduce", (100_352, 21_521, 1024), "0.0005"),
    ("the Morton keys", "runreduce", (2_097_152, 165_898, 4096), "0.0085"),
    # the shadow kernels: 64 slots over the flagship's 1,024 and the
    # fullscale 16,384 cluster points, and the batch of 32; 120 x 101 cells
    ("the shadow stage's per-slot geometry", "shadow_slots", (1, 1024, 64), "0.0000057"),
    ("the shadow stage's per-slot geometry", "shadow_slots", (1, 16_384, 64), "0.000084"),
    ("the shadow stage's per-slot geometry", "shadow_slots", (32, 1024, 64), "0.00018"),
    ("the shadow's closed-form sweep raster", "shadow_raster", (1, 64, 120, 101), "0.0000116"),
    ("the shadow's closed-form sweep raster", "shadow_raster", (32, 64, 120, 101), "0.00037"),
    # the fused multiply-add chain at each path's largest call, the voxel
    # key (one pair and an addend): [B, N, 3] points, a 0-d constant and
    # [B, N, 3] lattice products, N = 100,352 (flagship and the batch of
    # 32) and 2,097,152 (fullscale)
    ("XLA:CPU's fused multiply-add chains", "fma_chain", (301_056, 2 * 301_056 + 1, 1),
     "0.0011"),
    ("XLA:CPU's fused multiply-add chains", "fma_chain", (6_291_456, 2 * 6_291_456 + 1, 1),
     "0.0225"),
    ("XLA:CPU's fused multiply-add chains", "fma_chain", (9_633_792, 2 * 9_633_792 + 1, 1),
     "0.0345"),
    # a refinement's mask on the paths' first rounds
    ("a plane's inlier mask a scan", "plane_inliers", (1, 24_576, True), "0.00011"),
    ("a plane's inlier mask a scan", "plane_inliers", (1, 262_144, True), "0.0012"),
    ("a plane's inlier mask a scan", "plane_inliers", (32, 24_576, True), "0.0035"),
    # the round's hypotheses built and scored in one launch on the paths'
    # first rounds (the valid rows of the flagship's, fullscale's and the
    # batch's voxel clouds, and the fullscale batch of 2), and the mask that
    # closes the round (active and found scans, valid rows tested, inliers)
    ("the round's hypotheses built from the draws", "ransac_hypotheses_score",
     (1, 24_576, 128, 21_388), "0.00033"),
    ("the round's hypotheses built from the draws", "ransac_hypotheses_score",
     (1, 262_144, 128, 164_366), "0.0025"),
    ("the round's hypotheses built from the draws", "ransac_hypotheses_score",
     (32, 24_576, 128, 677_452), "0.0104"),
    ("the round's hypotheses built from the draws", "ransac_hypotheses_score",
     (2, 262_144, 128, 330_088), "0.0050"),
    ("the round's hypotheses built from the draws", "ransac_hypotheses_score",
     (1, 262_144, 128, 64_487), "0.0010"),
    ("the mask that closes a RANSAC round", "plane_inliers_close",
     (1, 24_576, 1, 1, 21_388, 20_822), "0.00010"),
    ("the mask that closes a RANSAC round", "plane_inliers_close",
     (1, 262_144, 1, 1, 164_366, 157_297), "0.00084"),
    ("the mask that closes a RANSAC round", "plane_inliers_close",
     (32, 24_576, 32, 32, 677_452, 657_504), "0.0033"),
    ("the mask that closes a RANSAC round", "plane_inliers_close",
     (2, 262_144, 2, 2, 330_088, 314_521), "0.0017"),
    ("the mask that closes a RANSAC round", "plane_inliers_close",
     (1, 262_144, 1, 1, 64_487, 61_838), "0.00042"),
]


def _bound_cell(key: str) -> str:
    """The Bound ms cell of the one PERF.md table row that names ``key``."""
    header = None
    lines = []
    for line in open(PERF).read().splitlines():
        if line.startswith("| # | TPU kernel"):
            header = [c.strip() for c in line.split("|")[1:-1]]
        elif header and line.startswith("|") and key in line:
            lines.append(line)
    assert header and len(lines) == 1, (key, len(lines))
    return [c.strip() for c in lines[0].split("|")[1:-1]][header.index("Bound ms")]


@pytest.mark.parametrize("key,name,args,printed", ROWS,
                         ids=[f"{r[1]}-{i}" for i, r in enumerate(ROWS)])
def test_bound_is_the_perf_table_row(key, name, args, printed):
    seconds, limiter = getattr(bounds, name)(*args)
    digits = len(printed.split(".")[1])
    assert f"{seconds * 1e3:.{digits}f}" == printed
    cell = _bound_cell(key)
    assert printed in re.findall(r"\d+\.\d+", cell), (printed, cell)
    assert limiter in cell, (limiter, cell)


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert bounds._bound(3.35e12) == (1.0, "bytes")
    assert bounds._bound(0, fp32_ops=67e12) == (1.0, "operations")
    assert bounds._bound(0, fp64_ops=34e12) == (1.0, "operations")
    assert bounds._bound(3.35e12, fp32_ops=2 * 67e12) == (2.0, "operations")


@pytest.mark.parametrize("preset", ["FLAGSHIP_CONFIG", "REFERENCE_FULLSCALE_CONFIG"])
def test_stage_bounds_keep_the_reference_stages(preset):
    """The reference's stage keys, each a (seconds, limiter, note) with a
    positive bound; the same latency class."""
    args = (21_500, 21_500, 566) if preset == "FLAGSHIP_CONFIG" else (1_929_208, 165_898, 7_069)
    want = ref_bounds.stage_bounds(getattr(ref_models, preset), *args)
    got = bounds.stage_bounds(getattr(port_models, preset), *args)
    assert list(got) == list(want)
    for stage, (seconds, limiter, note) in got.items():
        assert seconds > 0 and limiter in ("bytes", "operations") and note, stage
    assert bounds.LATENCY_CLASS == ref_bounds.LATENCY_CLASS


def test_ransac_stage_bound_counts_float32_plane_tests():
    """``stage_bounds["ransac"]`` counts the card's float32 plane tests
    (``PLANE_TEST_OPS`` a valid row and hypothesis a round), and the two
    RANSAC kernels' bounds count the same tests and bytes."""
    cfg = port_models.REFERENCE_FULLSCALE_CONFIG
    rounds, k, rows = cfg.max_planes, cfg.ransac_hypotheses, 165_898
    seconds, limiter, note = bounds.stage_bounds(cfg, 1_929_208, rows, 7_069)["ransac"]
    assert (seconds, limiter) == bounds._bound(rounds * rows * 33,
                                               fp32_ops=bounds.PLANE_TEST_OPS * rounds * k * rows)
    assert "float32" in note and limiter == "operations"
    assert bounds.ransac_hypotheses_score(1, 262_144, k, rows) == bounds._bound(
        262_144 * 13 + k * 24 + 21, rows * k * bounds.PLANE_TEST_OPS + k * bounds.HYPOTHESIS_OPS)
    assert bounds.plane_inliers(2, 1000, True) == bounds._bound(2 * (1000 * 15 + 20),
                                                                2 * 1000 * bounds.PLANE_TEST_OPS)


def test_round_kernel_bounds_count_their_work():
    """The round's two kernels: the score kernel's bound adds the drawn
    indices and the hypotheses' arithmetic to the scoring's and writes only
    the winner; the closing mask counts what the call's data needs: last a
    row of an active scan, valid a row where a plane was found, the point
    of each valid row tested there, two flags an inlier."""
    k, rows = 128, 21_388
    assert bounds.ransac_hypotheses_score(1, 24_576, k, rows) == bounds._bound(
        24_576 * 13 + k * 24 + 21, rows * k * bounds.PLANE_TEST_OPS + k * bounds.HYPOTHESIS_OPS)
    assert bounds.plane_inliers_close(3, 1000, 2, 1, 900, 400) == bounds._bound(
        3 + 2 * 1043 + 1000 + 900 * 12 + 400 * 2, 900 * bounds.PLANE_TEST_OPS)
    # no active scan: a flag a scan read, nothing tested
    assert bounds.plane_inliers_close(3, 1000, 0, 0, 0, 0) == bounds._bound(3, 0)
