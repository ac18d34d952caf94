"""Synthetic mining-arena scene generator.

A copy of ``pointcloud_obstacle_processing_tpu/utils/scene.py`` (NumPy only),
so scenes can be made where JAX is absent; ``tests/test_torch_config_scene.py``
holds the two equal.

The reference was validated only against the live robot (SURVEY.md §4: no
tests, no recorded bags).  The rebuild needs deterministic inputs with known
ground truth: a ground plane at z≈0, K rock clusters (points above the
plane), crater regions where ground returns are removed, and uniform noise —
matching the NASA RMC arena the node was built for
(obstacle_detection.cpp:1-5: Kinect v2 staring at a mining arena).

Pure NumPy on purpose: test fixtures and oracles must not depend on the JAX
code under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SceneSpec", "Scene", "make_scene", "make_fullscale_window"]


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    # arena extents, world frame (params.yaml:2-7 crop box)
    x_min: float = 0.0
    x_max: float = 4.5
    y_min: float = 0.0
    y_max: float = 3.78
    ground_z: float = 0.0
    ground_noise: float = 0.005  # sensor noise sigma on the plane
    n_ground: int = 80_000
    # rocks: spherical blobs sitting on the plane
    n_rocks: int = 4
    rock_radius: tuple = (0.10, 0.25)
    points_per_rock: int = 2_000
    # craters: elliptical regions with ground returns removed
    n_craters: int = 2
    crater_radius: tuple = (0.2, 0.4)
    # uniform clutter, some outside the crop box
    n_noise: int = 1_000
    noise_z: tuple = (-0.4, 0.6)


@dataclasses.dataclass
class Scene:
    points: np.ndarray  # [N, 3] float32, shuffled
    labels: np.ndarray  # [N] int32: 0 ground, 1..n_rocks rock id, -1 noise
    rock_centers: np.ndarray  # [n_rocks, 3]
    rock_radii: np.ndarray  # [n_rocks]
    crater_centers: np.ndarray  # [n_craters, 2]
    crater_radii: np.ndarray  # [n_craters]
    spec: SceneSpec


def make_scene(seed: int = 0, spec: SceneSpec | None = None, nan_frac: float = 0.0) -> Scene:
    spec = spec or SceneSpec()
    rng = np.random.default_rng(seed)

    margin = 0.5
    # Rock centers placed away from the box edge and from each other.
    centers = []
    while len(centers) < spec.n_rocks:
        c = rng.uniform(
            [spec.x_min + margin, spec.y_min + margin],
            [spec.x_max - margin, spec.y_max - margin],
        )
        if all(np.linalg.norm(c - np.asarray(p)) > 0.9 for p in centers):
            centers.append(c)
    rock_centers_xy = np.asarray(centers)
    rock_radii = rng.uniform(*spec.rock_radius, size=spec.n_rocks)

    crater_centers = []
    while len(crater_centers) < spec.n_craters:
        c = rng.uniform(
            [spec.x_min + margin, spec.y_min + margin],
            [spec.x_max - margin, spec.y_max - margin],
        )
        if all(
            np.linalg.norm(c - rock_centers_xy[k]) > 1.0 for k in range(spec.n_rocks)
        ) and all(np.linalg.norm(c - np.asarray(p)) > 1.2 for p in crater_centers):
            crater_centers.append(c)
    crater_centers = np.asarray(crater_centers)
    crater_radii = rng.uniform(*spec.crater_radius, size=spec.n_craters)

    # Ground plane with craters carved out.
    gx = rng.uniform(spec.x_min, spec.x_max, spec.n_ground)
    gy = rng.uniform(spec.y_min, spec.y_max, spec.n_ground)
    gz = spec.ground_z + rng.normal(0, spec.ground_noise, spec.n_ground)
    keep = np.ones(spec.n_ground, bool)
    for c, r in zip(crater_centers, crater_radii):
        keep &= (gx - c[0]) ** 2 + (gy - c[1]) ** 2 > r * r
    ground = np.stack([gx, gy, gz], -1)[keep]

    # Rocks: upper-hemisphere point shells (what a depth camera sees).
    rock_pts, rock_lbl = [], []
    rock_centers3 = []
    for k in range(spec.n_rocks):
        r = rock_radii[k]
        c3 = np.array([rock_centers_xy[k, 0], rock_centers_xy[k, 1], spec.ground_z])
        rock_centers3.append(c3)
        u = rng.normal(size=(spec.points_per_rock, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        u[:, 2] = np.abs(u[:, 2])  # visible hemisphere
        radial = r * (0.92 + 0.08 * rng.random(spec.points_per_rock)[:, None])
        p = c3 + u * radial
        rock_pts.append(p)
        rock_lbl.append(np.full(spec.points_per_rock, k + 1, np.int32))

    # Clutter noise.
    nx = rng.uniform(spec.x_min - 0.5, spec.x_max + 0.5, spec.n_noise)
    ny = rng.uniform(spec.y_min - 0.5, spec.y_max + 0.5, spec.n_noise)
    nz = rng.uniform(*spec.noise_z, size=spec.n_noise)
    noise = np.stack([nx, ny, nz], -1)

    pts = np.concatenate([ground] + rock_pts + [noise]).astype(np.float32)
    lbl = np.concatenate(
        [np.zeros(len(ground), np.int32)]
        + rock_lbl
        + [np.full(spec.n_noise, -1, np.int32)]
    )

    if nan_frac > 0:
        idx = rng.random(len(pts)) < nan_frac
        pts[idx] = np.nan  # Kinect NaN returns (obstacle_detection.cpp:197)
        lbl[idx] = -1

    order = rng.permutation(len(pts))
    return Scene(
        points=pts[order],
        labels=lbl[order],
        rock_centers=np.asarray(rock_centers3),
        rock_radii=rock_radii,
        crater_centers=crater_centers,
        crater_radii=crater_radii,
        spec=spec,
    )


def make_fullscale_window(
    max_points: int,
    n_obs: int = 8,
    seed: int = 100,
    noise_sigma: float = 0.003,
    noise_seed: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The canonical fullscale benchmark window: ONE arena re-observed
    ``n_obs`` times with fresh sensor noise per observation — the
    authentic accumulation semantics (the reference accumulates frames of
    the SAME arena, obstacle_detection.cpp:691-698).

    Shared by bench.py, scripts/speed_of_light.py and the merge A/B
    experiment scripts so achieved-vs-bound and A/B comparisons are
    guaranteed to run the identical workload (review r5 finding #5 —
    three hand-copied constructions could silently drift apart).

    ``noise_seed`` defaults to the canonical stream (7) when ``seed`` is
    the canonical 100, and to ``seed + 1`` otherwise — so windows built
    from different arenas get independent noise too, not the same stream
    replayed (review r5b finding #5).

    Returns ``(points[max_points, 3] float32, valid[max_points] bool)``
    zero-padded to capacity.
    """
    spec = SceneSpec(
        n_ground=230_000, n_rocks=6, points_per_rock=3_000, n_noise=2_000
    )
    base = make_scene(seed=seed, spec=spec).points
    if noise_seed is None:
        noise_seed = 7 if seed == 100 else seed + 1
    rng = np.random.default_rng(noise_seed)
    parts = [
        base + rng.normal(0, noise_sigma, base.shape).astype(np.float32)
        for _ in range(n_obs)
    ]
    window = np.concatenate(parts)[:max_points]
    pts = np.zeros((max_points, 3), np.float32)
    pts[: len(window)] = window
    valid = np.zeros(max_points, bool)
    valid[: len(window)] = True
    return pts, valid
