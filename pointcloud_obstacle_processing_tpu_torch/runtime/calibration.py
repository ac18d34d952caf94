"""Calibration persistence (SURVEY.md §5 checkpoint/resume).

The reference persists nothing — its only cross-callback state is the
accumulation buffer, cleared each cycle (obstacle_detection.cpp:78, :926).
The one thing worth saving is *calibration*: the pipeline configuration and
the sensor extrinsics (the static tf the launch file would publish,
main.launch:12-13).  Plain JSON: inspectable, diffable, no heavyweight
checkpoint dependency for a few dozen scalars.  A copy of
``pointcloud_obstacle_processing_tpu/runtime/calibration.py`` on the port's
``PipelineConfig`` and ``RigidTransform``; the file format is the same, so
either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json

from ..config import PipelineConfig
from ..ops.transforms import RigidTransform

__all__ = ["save_calibration", "load_calibration"]

_FORMAT = "pcp-tpu-calibration-v1"


def save_calibration(
    path: str,
    config: PipelineConfig,
    world_from_sensor: RigidTransform | None = None,
    sensor_frame: str = "kinect2_link",
    world_frame: str = "world",
) -> None:
    blob = {
        "format": _FORMAT,
        "config": dataclasses.asdict(config),
        "world_frame": world_frame,
        "sensor_frame": sensor_frame,
    }
    if world_from_sensor is not None:
        blob["world_from_sensor"] = {
            "quat_xyzw": world_from_sensor.quat_xyzw.cpu().tolist(),
            "translation": world_from_sensor.translation.cpu().tolist(),
        }
    with open(path, "w") as f:
        json.dump(blob, f, indent=2, sort_keys=True)


def load_calibration(path: str):
    """Returns (config, world_from_sensor | None, world_frame, sensor_frame)."""
    with open(path) as f:
        blob = json.load(f)
    if blob.get("format") != _FORMAT:
        raise ValueError(f"not a calibration file: {path}")
    config = PipelineConfig(**blob["config"])
    tf = None
    if "world_from_sensor" in blob:
        tf = RigidTransform.from_quat_trans(
            blob["world_from_sensor"]["quat_xyzw"],
            blob["world_from_sensor"]["translation"],
        )
    return config, tf, blob.get("world_frame", "world"), blob.get("sensor_frame", "kinect2_link")
