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
