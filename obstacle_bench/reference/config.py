"""Pipeline configuration.

A copy of ``pointcloud_obstacle_processing_tpu/config.py``: the reference
package's ``__init__`` imports JAX, so even its pure-Python config cannot be
imported where JAX is absent.  ``tests/test_torch_config_scene.py`` holds
the copy equal to the original, ``validate()`` included.

TPU-native re-design of the reference node's rosparam surface
(reference: minibot_cr18/src/obstacle_detection.cpp:940-975 reads ~20 params via
``nh.param``; values come from minibot_cr18/params.yaml via the launch file).

Everything here is resolved *before* trace time: shapes, thresholds and
capacities are compile-time constants, so each distinct config compiles one XLA
program.  The reference's runtime-global mutable parameters
(obstacle_detection.cpp:82-118) become a frozen dataclass.

Known reference quirks that are represented explicitly (SURVEY.md §5):

* ``plane_segment_angle`` is an integer number of *degrees* in params.yaml but
  is passed to ``pcl::SACSegmentation::setEpsAngle`` which expects *radians*
  (obstacle_detection.cpp:371, :970).  20 rad makes the perpendicular-plane
  constraint vacuous, i.e. the node behaves as plain RANSAC plane.  We model
  this with ``pcl_compat_eps_angle_bug``: when True (default, fidelity mode)
  the axis constraint uses ``plane_segment_angle`` interpreted as radians;
  when False the angle is properly converted from degrees.
* params.yaml has the typo ``downsame_input_data`` (params.yaml:15) so the
  C++ default ``true`` always wins (obstacle_detection.cpp:943); the flag (and
  ``passthrough_filter_enable``) is read but never consulted.  We keep the
  flags and actually honor them.
* Grid dimensions are derived as ``ceil((|min| + |max|) / block_size)``
  (obstacle_detection.cpp:958-959) — note the absolute values, reproduced here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["PipelineConfig"]


def _cdiv(a: float, b: float) -> int:
    return int(math.ceil(a / b))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration for the scan→obstacles pipeline.

    Field defaults mirror the C++ ``nh.param`` defaults
    (obstacle_detection.cpp:940-975), *not* params.yaml.
    """

    # ---- crop box, world frame (params.yaml:2-7; cpp:948-953) -------------
    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -0.5
    y_max: float = 0.6
    z_min: float = 0.0
    z_max: float = -0.5  # cpp default quirk: z_min > z_max rejects everything

    # ---- accumulation (cpp:940) -------------------------------------------
    accumulate_count: int = 2

    # ---- occupancy grid / hole detection (cpp:955-956, :946) --------------
    block_size: float = 0.15
    dev_percent: float = 0.5
    grid_opacity: int = 0

    # ---- downsampling (cpp:943, :964) --------------------------------------
    downsample_input_data: bool = True
    downsample_leaf_size: float = 0.015
    # Voxel centroid sum precision on the dense-bin paths: "fast" carries
    # the voxel-corner-relative offsets (binning) and corner-relative
    # centroids (slot gather) as single bf16 terms — max centroid error
    # leaf * 2^-8 ~ 1.6e-4 m at leaf 0.04, far below sensor noise; counts
    # stay exact either way.  "exact" uses multi-term bf16 splits
    # (~leaf * 2^-24, f32-ulp level) at ~2x the binning/gather matmul cost.
    voxel_sum_precision: str = "fast"
    # Voxel reduction engine: "auto"/"sort" = stable-sort + segmented scan
    # + Pallas run-end compaction (K-independent, full-f32 sums, fastest
    # measured); "mxu" = dense one-hot-matmul histogram (K <= 2^19, uses
    # voxel_sum_precision); "scatter" = dense [K, 4] scatter-add.  The
    # choice is backend-independent so TPU<->CPU runs compare identical
    # programs.
    voxel_binning: str = "auto"
    # Output ordering of the sort engine: "lattice" = ascending packed
    # (ix, iy, iz) (row-major, PCL-packed-leaf spirit; the default and the
    # banded kNN's assumption); "morton" = Z-curve bit-interleaved order,
    # kept only as an experiment — it was MEASURED WORSE for the banded
    # kNN (Z-curve rank discontinuities scatter spatial neighbors: 11-20%
    # of kNN neighbor sets perturbed at any band <= 512 vs 0.11% for
    # lattice at band 512; docs/PERFORMANCE.md rejected list).  Requires
    # the sort engine and a <= 24-bit lattice.
    voxel_order: str = "lattice"
    # Pack the sort engine's three f32 offset payloads into two int32
    # columns (x|y 16-bit fixed point in one, z in the other; quantum =
    # leaf/65536 ~ 0.6 um at leaf 0.04): the stable sort moves one fewer
    # payload and the run-reduce kernel streams one fewer buffer,
    # decoding in-register.  Centroids shift by <= one quantum (still
    # bitwise-identical across TPU/CPU — both backends quantize the same
    # way).  The hardware A/B shipped: sort 7.85 -> 6.05 ms/batch at the
    # flagship shape and ~0.5-1 ms/window at fullscale
    # (scripts/tpu_experiments31/32.py + 49.py) — both shipped presets
    # (models/) turn this ON.  The dataclass default stays False because
    # packing is a PARITY deviation (docs/PARITY.md #11): an unconfigured
    # PipelineConfig reproduces the reference bit-budget exactly.
    # Requires the sort engine.
    voxel_payload_packing: bool = False

    # ---- passthrough (cpp:944; dead code path :298-314) --------------------
    passthrough_filter_enable: bool = True

    # ---- statistical outlier removal (cpp:966-967) -------------------------
    statistical_outlier_mean_k: int = 15
    statistical_outlier_std_dev_thresh: float = 1.0
    # k-smallest reduction backend.  Default "banded": rank-window
    # candidate pruning over the voxel-lattice-sorted cloud (the grid-hash
    # neighbor engine, SURVEY.md §7 step 4) with EXACT in-window k-min
    # selection (the same plain-XLA extraction loop on every backend, so
    # TPU and CPU agree bitwise) — the near-exact PCL-faithful engine
    # (0.11% of kNN means perturbed at band 512; the band window is the
    # ONLY deviation from PCL's exact kNN).  Requires downsampled input
    # (the pipeline falls back to "approx" when downsampling is
    # disabled).  Opt-in alternatives: "exact" = full-width hierarchical
    # top_k (exact PCL semantics, no band); "approx" = lax.approx_min_k
    # (recall 0.98, ~0.1% mean perturbation — fastest full-width form);
    # "banded_approx" = the band window with approx_min_k selection.
    knn_backend: str = "banded"
    # half-width (in rank space) of the "banded" candidate window; the
    # window is knn_row_tile + 2*knn_band columns wide.
    knn_band: int = 512
    # query-tile height of the tiled kNN scorer.  Total banded-window
    # work is N + 2*knn_band*N/knn_row_tile — LARGER tiles score strictly
    # fewer window columns and give each row a SUPERSET candidate window
    # (better fidelity) — but past the VMEM sweet spot the Pallas sortnet
    # tile spills.  The best tile is SHAPE-DEPENDENT: 384 at the flagship
    # 24576-voxel shape (26.22 ms/batch prefix-3 vs 256's 27.00, 512's
    # 27.49, 768's 33.11 — scripts/tpu_experiments44.py), 1024 at the
    # fullscale 262144 shape (scripts/tpu_experiments49.py); both presets
    # (models/) pin their measured best.  This default is the untuned
    # middle for ad-hoc configs nobody has measured — tune per shape.
    # Must be a multiple of 128 for the Pallas network's lane tiling.
    knn_row_tile: int = 512
    # Skip all-invalid query tiles via a per-tile lax.cond (results are
    # identical — those tiles' outputs are discarded by the valid mask).
    # Enable ONLY for configs run as a single unbatched program whose
    # capacity far exceeds the typical valid count (the fullscale window:
    # 15.3 -> 11.4 ms/window).  Under vmap the batched cond lowers to a
    # select that costs ~2x the stage (measured 27.1 vs 13.9 ms/batch on
    # the batched flagship) — keep False for batched workloads.
    knn_skip_dead_tiles: bool = False

    # ---- RANSAC plane segmentation (cpp:969-970, :364-399) -----------------
    plane_segment_dist_thresh: float = 0.040
    plane_segment_angle: float = 20.0
    pcl_compat_eps_angle_bug: bool = True
    plane_min_remaining_frac: float = 0.3  # while-loop gate, cpp:379
    ransac_hypotheses: int = 128  # batched hypotheses scored per round
    ransac_refine_iters: int = 2  # inlier LSQ refinement passes (setOptimizeCoefficients, cpp:365)
    max_planes: int = 4  # static bound on the multi-plane while loop

    # ---- euclidean clustering (cpp:972-974) ---------------------------------
    euc_cluster_tolerance: float = 0.4
    euc_min_cluster_size: int = 5
    euc_max_cluster_size: int = 20000
    # Banded cluster sweep: 0 = full C x C sweep; > 0 = each query tile
    # scores only a window of this many columns placed by the x monotone
    # envelopes of the lattice-ordered cloud (exact when the window covers
    # every tolerance edge; a too-small window raises the observable
    # StageStats.cluster_band_overflow).  Worth it when cluster_capacity
    # is large (fullscale: 40960 capacity, 16384 window = 2.5x less sweep
    # work); pointless below ~4k capacity.  Must be a multiple of 128.
    cluster_band_window: int = 0

    # ---- dormant/unused reference knobs kept for API parity ----------------
    convex_hull_alpha: float = 180.0  # read at cpp:975, never used
    publish_point_clouds: bool = True  # gates per-stage cloud outputs (cpp:945)

    # ---- TPU static capacities (no reference analog: PCL is dynamic) -------
    max_points: int = 131072  # capacity of the accumulated, cropped cloud
    max_voxels: int = 16384  # capacity after VoxelGrid downsample
    cluster_capacity: int = 4096  # capacity of the post-plane obstacle cloud
    max_clusters: int = 64  # max clusters reported (PointIndicesArray capacity)
    # NOTE: the shadow sweep needs no line/step capacity — the closed-form
    # rasterizer (ops/shadow.py) covers the reference's unbounded sweep
    # (cpp:650-669) exactly for arbitrary cluster widths.
    cluster_max_iters: int = 64  # static bound on label-propagation sweeps

    # ------------------------------------------------------------------ grid
    @property
    def grid_width(self) -> int:
        """obstacle_detection.cpp:958 (note the |.| quirk)."""
        return _cdiv(abs(self.y_min) + abs(self.y_max), self.block_size)

    @property
    def grid_height(self) -> int:
        """obstacle_detection.cpp:959."""
        return _cdiv(abs(self.x_min) + abs(self.x_max), self.block_size)

    @property
    def grid_size(self) -> int:
        return self.grid_width * self.grid_height

    @property
    def eps_angle_radians(self) -> float:
        """Effective eps angle fed to the perpendicular-plane constraint."""
        if self.pcl_compat_eps_angle_bug:
            return float(self.plane_segment_angle)  # degrees misread as radians
        return math.radians(self.plane_segment_angle)

    def replace(self, **kw: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.max_voxels % 8:
            raise ValueError("max_voxels should be a multiple of 8 for TPU tiling")
        if self.cluster_capacity % 8:
            raise ValueError("cluster_capacity should be a multiple of 8")
        if self.x_min >= self.x_max or self.y_min >= self.y_max:
            raise ValueError("degenerate crop box")
        if self.voxel_binning not in ("auto", "sort", "mxu", "scatter"):
            raise ValueError(f"unknown voxel_binning {self.voxel_binning!r}")
        if self.voxel_order not in ("lattice", "morton"):
            raise ValueError(f"unknown voxel_order {self.voxel_order!r}")
        if self.voxel_order == "morton" and self.voxel_binning not in ("auto", "sort"):
            raise ValueError("voxel_order='morton' requires the sort engine")
        if self.voxel_payload_packing and self.voxel_binning not in ("auto", "sort"):
            raise ValueError(
                "voxel_payload_packing requires the sort engine "
                "(voxel_binning 'auto' or 'sort')"
            )
        if self.cluster_band_window % 128:
            raise ValueError("cluster_band_window must be a multiple of 128")
        if self.cluster_band_window and self.cluster_capacity % 128:
            # the banded sweep tiles queries per-128; a non-128 capacity
            # would silently fall back to the C^2 full sweep with no flag
            raise ValueError(
                "cluster_band_window requires cluster_capacity to be a "
                f"multiple of 128 (got {self.cluster_capacity}); set "
                "cluster_band_window=0 for the full sweep"
            )


