"""The benchmark's frozen copies still equal what the port gives now, at
small sizes on the CPU: the reference pipeline, the scene generator, the
bound arithmetic and the configuration files.

    python -m pytest obstacle_bench -q
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from obstacle_bench import bounds, check, scene
from pointcloud_obstacle_processing_tpu_torch.config import REFERENCE_YAML_CONFIG, PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_uniform
from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
from pointcloud_obstacle_processing_tpu_torch.types import Cloud
from pointcloud_obstacle_processing_tpu_torch.utils import bounds as port_bounds
from pointcloud_obstacle_processing_tpu_torch.utils import scene as port_scene

BENCH = Path(__file__).resolve().parent
CONFIGS = ("flagship", "fullscale")


def config_file(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def config(name):
    data = config_file(name)
    return PipelineConfig(**{f.name: data[f.name] for f in dataclasses.fields(PipelineConfig)})

# small forms of the two configurations, run on the CPU
SMALL = {
    "flagship": dict(max_points=8192, max_voxels=8192, cluster_capacity=512),
    "fullscale": dict(max_points=65536, max_voxels=16384, cluster_capacity=1024,
                      cluster_band_window=512),
}
SMALL_SCENE = scene.SceneSpec(n_ground=6000, points_per_rock=300, n_noise=200)


def small_fields(name):
    return dataclasses.asdict(config(name).replace(**SMALL[name]))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_params_yaml_but_for_the_keys_it_names(name):
    """Every field as params.yaml ships it (the port's REFERENCE_YAML_CONFIG),
    but for the capacities and knobs listed under ``assumed`` and the cuts
    under ``reduced``; the file is a valid configuration."""
    data = config_file(name)
    named = set(data["assumed"]) | set(data["reduced"])
    shipped = dataclasses.asdict(REFERENCE_YAML_CONFIG)
    changed = {k for k, v in shipped.items() if data[k] != v}
    assert changed <= named, changed - named
    assert all(data["assumed"][k] == data[k] for k in named & set(shipped) - set(data["reduced"]))
    config(name).validate()


@pytest.mark.parametrize("name,seed", [("flagship", 11), ("flagship", 4_000_000_007),
                                       ("fullscale", 101), ("fullscale", 5)])
def test_reference_equals_the_port_on_the_cpu(name, seed):
    fields = small_fields(name)
    cfg = PipelineConfig(**fields)
    rng = np.random.default_rng(seed)
    if name == "flagship":
        pts = [scene.make_scene(seed=seed + i, spec=SMALL_SCENE).points for i in range(2)]
        points = np.zeros((2, cfg.max_points, 3), np.float32)
        valid = np.zeros((2, cfg.max_points), bool)
        for i, p in enumerate(pts):
            points[i, :len(p)], valid[i, :len(p)] = p, True
    else:
        w = [scene.make_fullscale_window(cfg.max_points, seed=seed + i, spec=SMALL_SCENE)
             for i in range(2)]
        points, valid = np.stack([p for p, _ in w]), np.stack([v for _, v in w])
    u = rng.random((2, cfg.max_planes, cfg.ransac_hypotheses, 3), dtype=np.float32)
    res = batched_pipeline(cfg)(Cloud(torch.from_numpy(points), torch.from_numpy(valid)),
                                draw=draw_from_uniform(torch.from_numpy(u)))
    port = {k: v.numpy() for k, v in check.published(res).items()}
    for b in range(2):
        ref = check.reference_scan(fields, points[b], valid[b], u[b])
        reading = check.compare_scan({k: v[b] for k, v in port.items()}, ref)
        assert all(v == 0 for v in reading.values()), reading
        for k in ref:
            np.testing.assert_array_equal(port[k][b], ref[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_001])
def test_scene_copy_equals_the_port(seed):
    a, b = scene.make_scene(seed=seed), port_scene.make_scene(seed=seed)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("seed", [100, 101])
def test_window_copy_equals_the_port(seed):
    pa, va = scene.make_fullscale_window(262144, seed=seed)
    pb, vb = port_scene.make_fullscale_window(262144, seed=seed)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("name", CONFIGS)
def test_bounds_copy_at_capacity_equals_the_port(name):
    """The copied stages equal the port's arithmetic at capacity; the voxel
    stage counts each cropped point read and each kept voxel written once,
    13 bytes each, whatever engine runs it."""
    cfg = config(name)
    rows = 700
    port = port_bounds.stage_bounds(cfg, n_valid=cfg.max_points, n_voxels=cfg.max_voxels,
                                    n_cluster_rows=rows)
    ours = bounds.scan_bounds(cfg, cfg.max_points, cfg.max_points, cfg.max_voxels, rows)
    for stage, port_stage in (("crop", "crop+seed"), ("outlier", "outlier"),
                              ("ransac", "ransac"), ("compact", "compact")):
        assert ours[stage][:2] == port[port_stage][:2], stage
    cropped, kept = 90_000, 60_000
    voxel = bounds.scan_bounds(cfg, 95_000, cropped, kept, rows)["voxel"]
    assert voxel == ((cropped + kept) * 13 / bounds.HBM_BYTES_PER_S, "bytes")


def test_bounds_sum_over_the_scans_of_a_call():
    cfg = config("flagship")
    scans = [(90_000, 85_000, 21_000, 600), (95_000, 90_000, 22_000, 700)]
    total = bounds.stage_bounds(cfg, scans)
    each = [bounds.scan_bounds(cfg, *s) for s in scans]
    for stage in total:
        assert total[stage] == pytest.approx(sum(e[stage][0] for e in each), rel=1e-12)
    # fewer valid points, less work
    assert total["voxel"] < 2 * bounds.scan_bounds(cfg, cfg.max_points, cfg.max_points,
                                                   cfg.max_voxels, 700)["voxel"][0]
