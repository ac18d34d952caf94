"""Launch equivalent: config load + node + scan source (L5 of SURVEY.md).

The reference boots via roslaunch (minibot_cr18/launch/main.launch): load
params.yaml, start kinect2_bridge, start the detection node in the
``pointcloud_obstacle_processing`` namespace.  Here the same composition is
a function/CLI: load a params.yaml-compatible config, set the static sensor
tf (the commented static_transform_publisher of main.launch:12-13), start
the node on an in-process bus, and feed it scans — synthetic arena frames
by default (there is no Kinect in CI), or replayed serialized scans.

Counterpart of ``pointcloud_obstacle_processing_tpu/runtime/launch.py``; the
node runs on the card unless ``device="cpu"`` (``--device cpu``) is given.

    python3 -m pointcloud_obstacle_processing_tpu_torch.runtime.launch --cycles 2 -v
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from ..config import PipelineConfig, REFERENCE_YAML_CONFIG, config_from_yaml
from ..runtime.bus import MessageBus
from ..runtime.driver import POINT_TOPIC, ObstacleDetectionNode
from ..runtime.msgs import PointCloud2Msg
from ..runtime.tf import TransformBuffer, attach_tf_listener
from ..utils.scene import SceneSpec, make_scene

__all__ = ["launch", "SyntheticKinect"]

log = logging.getLogger("pointcloud_obstacle_processing_tpu_torch")

# The arena-mounted Kinect pose from main.launch:12-13 (commented static tf,
# kept as the canonical demo pose): sensor at the arena edge looking down-range.
DEFAULT_SENSOR_QUAT = (-0.5, 0.5, -0.5, 0.5)
DEFAULT_SENSOR_POS = (0.0, 1.89, 1.55)


class SyntheticKinect:
    """kinect2_bridge stand-in: streams sensor-frame frames of one scene."""

    def __init__(self, publisher, world_from_sensor, scene_seed: int = 0,
                 points_per_frame: int = 10_000, spec: SceneSpec | None = None):
        self.pub = publisher
        self.world_from_sensor = world_from_sensor
        self.scene = make_scene(seed=scene_seed, spec=spec or SceneSpec())
        self.rng = np.random.default_rng(scene_seed)
        self.points_per_frame = points_per_frame
        self.seq = 0
        # world -> sensor, applied on the host to emit sensor-frame scans
        inv = self.world_from_sensor.inverse()
        self._inv_q = inv.quat_xyzw.numpy()
        self._inv_t = inv.translation.numpy()

    def _to_sensor(self, pts):
        u, w = self._inv_q[:3], self._inv_q[3]
        t = 2.0 * np.cross(u, pts)
        return pts + w * t + np.cross(u, t) + self._inv_t

    def emit_frame(self) -> PointCloud2Msg:
        idx = self.rng.integers(0, len(self.scene.points), self.points_per_frame)
        world_pts = self.scene.points[idx]
        sensor_pts = self._to_sensor(world_pts).astype(np.float32)
        self.seq += 1
        msg = PointCloud2Msg.from_xyz(sensor_pts, "kinect2_link", seq=self.seq)
        self.pub.publish(msg)
        return msg


def launch(
    params_yaml: str | None = None,
    config: PipelineConfig | None = None,
    cycles: int = 1,
    points_per_frame: int = 10_000,
    accumulate_count: int | None = None,
    force_numpy_accumulator: bool = False,
    async_pipeline: bool = False,
    accumulate_on_device: bool = False,
    device="cuda",
):
    """Boot the node + synthetic sensor; run ``cycles`` full windows (in
    async mode the last window stays pending until ``node.flush()``)."""
    if config is None:
        config = (
            config_from_yaml(params_yaml, REFERENCE_YAML_CONFIG)
            if params_yaml
            else REFERENCE_YAML_CONFIG
        )
    if accumulate_count is not None:
        config = config.replace(accumulate_count=accumulate_count)
    # capacity must hold one accumulation window
    need = config.accumulate_count * points_per_frame
    if config.max_points < need:
        config = config.replace(max_points=int(np.ceil(need / 1024)) * 1024)

    bus = MessageBus(immediate=True)
    tf = TransformBuffer()
    # the listener feeds the buffer from the bus's tf/tf_static topics — so
    # transforms published in-process OR bridged from a remote BusServer
    # (connect_bus) reach the stamped history, exactly like the reference's
    # tf2 listener subscribing the ROS tf bus (cpp:124-125, :938)
    attach_tf_listener(bus, tf)
    tf.set_static("world", "kinect2_link", DEFAULT_SENSOR_QUAT, DEFAULT_SENSOR_POS)

    node = ObstacleDetectionNode(
        config, bus=bus, tf_buffer=tf,
        force_numpy_accumulator=force_numpy_accumulator,
        async_pipeline=async_pipeline,
        accumulate_on_device=accumulate_on_device,
        device=device,
    )
    kinect = SyntheticKinect(
        bus.advertise(POINT_TOPIC),
        tf.lookup_transform("world", "kinect2_link"),
        points_per_frame=points_per_frame,
    )

    results = []
    t0 = time.perf_counter()
    for _ in range(cycles):
        for _ in range(config.accumulate_count + 1):  # +1: the trigger frame
            kinect.emit_frame()
        results.append(node.last_result)
    wall = time.perf_counter() - t0
    log.info("ran %d cycles in %.2fs (accumulator backend: %s)",
             cycles, wall, node.accumulator.backend)
    return node, results


def main(argv=None):
    ap = argparse.ArgumentParser(description="obstacle-detection node demo (PyTorch + CUDA)")
    ap.add_argument("--params", default=None, help="params.yaml-compatible config")
    ap.add_argument("--cycles", type=int, default=1)
    ap.add_argument("--frames", type=int, default=None,
                    help="override accumulate_count")
    ap.add_argument("--points-per-frame", type=int, default=10_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(message)s")
    node, _ = launch(
        params_yaml=args.params,
        cycles=args.cycles,
        accumulate_count=args.frames,
        points_per_frame=args.points_per_frame,
        device=args.device,
    )
    r = node.last_result
    grid = r.grid.data.cpu().numpy()
    xyzr = r.centroids.points.xyzr.cpu().numpy()[r.centroids.valid.cpu().numpy()]
    print(
        f"cycles={args.cycles} device={node.device} grid={grid.shape} "
        f"occupied={int((grid == 100).sum())} clusters={int(r.clusters.num_clusters)} "
        f"centroids={xyzr.round(3).tolist()}"
    )


if __name__ == "__main__":
    main()
