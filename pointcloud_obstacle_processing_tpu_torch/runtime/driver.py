"""Host driver: the obstacle-detection node (L3 process shell of SURVEY.md).

Counterpart of ``pointcloud_obstacle_processing_tpu/runtime/driver.py``,
the reference node's ``main`` + ``cloud_cb`` plumbing
(obstacle_detection.cpp:930-1015, :674-698): subscribe to the scan topic,
accumulate ``accumulate_count`` transformed frames, run the pipeline on the
card, and publish the topic surface:

  input : /kinect2/qhd/points          (cpp:80, :1001)
  output: occupancy_grid               (cpp:1011, :852)
          centroids (PointIndicesArray) (cpp:1009; dormant in reference)
          euc_clusters                  (cpp:1010)
          voxel_grid / statistical_outliers / planar_cloud / indices_cloud /
          cloud_f  (per-stage debug clouds, gated by publish_point_clouds,
          cpp:1004-1008)

How the host and the card overlap (where the JAX node leans on JAX's
asynchronous dispatch, this node writes it out on CUDA streams):

- Every host-to-device copy starts from pinned memory with
  ``non_blocking=True`` (a copy from pageable memory waits for the
  stream): the accumulator's window snapshot, the per-frame uploads and
  the poses.  Pinned buffers are double-buffered by window parity and
  rewritten only once the copy that read them has completed.
- When a window is dispatched, the fields that ``_publish`` reads (grid,
  centroids, obstacle cloud, point labels, the debug clouds when
  ``publish_point_clouds`` is set, and every stage count and flag packed
  into one int32 vector) are copied to pinned host buffers on the same
  stream, and an event is recorded after them.  ``_publish`` waits on that
  event only, and masks the debug clouds on the host (a boolean index on
  the card would wait for its output size).
- ``accumulate_on_device``: each frame is copied into its slot of a
  preallocated device window ``[A, F, 3]`` on a side upload stream as it
  arrives; the compute stream waits on the upload stream's event before
  ``process_frames``.
- ``async_pipeline``: a window is issued to the card from one dispatch
  thread (the port issues ~2,000 launches a window; JAX issues one
  executable), so the trigger frame's callback returns after handing the
  window over and publishing the window before it.  Windows are issued in
  order on the node's stream; ``flush`` joins the thread.

While the program's tracing is on (``utils.timing.tracing``), each
cycle's ``metrics`` entry also holds its host seconds by stage, in its
device-to-host reads and in the kernel wrappers (``host_seconds``), and
its launch and read counts, from the spans its dispatch closed; the
reference's per-cycle TOTAL TIME table of the stages (cpp:872-925) is
logged at debug level.

The RANSAC draws of window c come from the node's own device
``torch.Generator`` (seeded from ``seed``), or from ``draw_for_cycle(c)``
where it is given (the tests replay the reference's
``fold_in(PRNGKey(seed), c)`` key chain through it).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import time

import numpy as np
import torch

from .. import _build
from ..config import PipelineConfig
from ..native import ScanAccumulator, decode_cloud2_organized
from ..ops.transforms import RigidTransform
from ..pipeline import default_draw, process_frames, process_scan
from ..types import Cloud
from ..utils import timing
from .bus import MessageBus
from .msgs import (
    Header,
    OccupancyGridMsg,
    PointCloud2Msg,
    PointIndicesArrayMsg,
)
from .tf import TransformBuffer

__all__ = ["ObstacleDetectionNode", "POINT_TOPIC"]

POINT_TOPIC = "/kinect2/qhd/points"
log = logging.getLogger("pointcloud_obstacle_processing_tpu_torch")

STAT_COUNTS = ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
               "nonplane_points", "num_planes", "num_clusters")
# capacity-truncation observability: True means fixed-shape buffers
# silently dropped data that cycle (every truncation in the pipeline
# surfaces here)
STAT_FLAGS = ("voxel_overflow", "cluster_overflow", "cluster_band_overflow",
              "planes_truncated", "cluster_unconverged")
# the PipelineResult fields of the debug clouds (publish_point_clouds)
_DEBUG_CLOUDS = ("voxel_cloud", "outlier_filtered_cloud", "nonplane_cloud", "last_plane_cloud")
_IDENTITY_POSE = np.array([0, 0, 0, 1, 0, 0, 0], np.float32)  # xyzw quaternion, translation


def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """Host-side xyzw quaternion -> 3x3 rotation (NumPy twin of
    ops.transforms.quat_to_matrix; a verbatim copy of the reference
    node's).  The per-frame accumulation path touches no device."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class _Pinned:
    """Host buffers on either device: pinned on the card's host (copies
    from and to them run asynchronously), plain tensors on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def empty(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)

    def event(self, stream=None):
        """An event recorded on ``stream`` now (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev


def _on(stream):
    """``torch.cuda.stream(stream)``; nothing on the CPU (no stream)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _wait(event) -> None:
    """Wait on the host for an event (a no-op once it has completed)."""
    if event is not None:
        event.synchronize()


def _span_metrics(spans: list, seq: int) -> dict:
    """A cycle's ``metrics`` fields from the spans its dispatch closed: host
    seconds by stage, in the host reads (``host_read``) and in the kernel
    wrappers (``kernels``), and the launch and host read counts; logs the
    stages' TOTAL TIME table at debug level."""
    totals = timing.totals(spans)
    stages = {name[len("pcp.stage."):]: t.seconds for name, t in totals.items()
              if name.startswith("pcp.stage.")}
    if log.isEnabledFor(logging.DEBUG):
        table = timing.StageTimer()
        for name, seconds in stages.items():
            table.record(name, seconds)
        log.debug("cycle %d host time by stage\n%s", seq, table.table())
    kernels = [t for name, t in totals.items() if name.startswith("pcp.kernel.")]
    read = totals.get("pcp.host_read")
    return {
        "host_seconds": {**stages, "host_read": read.seconds if read else 0.0,
                         "kernels": sum(t.seconds for t in kernels)},
        "launches": sum(t.counts.get("launches", 0) for t in kernels),
        "host_reads": read.counts.get("host_reads", 0) if read else 0,
    }


class ObstacleDetectionNode:
    def __init__(
        self,
        config: PipelineConfig,
        bus: MessageBus | None = None,
        tf_buffer: TransformBuffer | None = None,
        input_topic: str = POINT_TOPIC,
        world_frame: str = "world",
        sensor_frame: str = "kinect2_link",
        seed: int = 0,
        force_numpy_accumulator: bool = False,
        async_pipeline: bool = False,
        accumulate_on_device: bool = False,
        device="cuda",
        draw_for_cycle=None,
    ):
        """``async_pipeline``: double-buffered mode — window k is dispatched
        without waiting for it and window k-1's results are published
        instead, overlapping the card's compute with the host's
        accumulation of the next window (one-window publish latency).  Call
        :meth:`flush` to drain the final pending window.

        ``accumulate_on_device``: upload each frame as it arrives and run
        the sensor->world transform + accumulation on the card via
        ``process_frames`` — no bulk window upload sits on the critical
        path between windows.  Requires ``config.max_points`` divisible by
        ``config.accumulate_count`` (fixed per-frame capacity); frames
        larger than that capacity are truncated.

        ``device``: the card unless ``"cpu"`` is passed (no fallback: this
        raises where there is no card).  ``draw_for_cycle(c)``, if given,
        returns the RANSAC ``Draw`` of window c (c counts from 0)."""
        config.validate()
        self.config = config
        self.device = _build.resolve_device(device)
        self.bus = bus or MessageBus(immediate=True)
        self.tf = tf_buffer or TransformBuffer()
        self.world_frame = world_frame
        self.sensor_frame = sensor_frame
        self.async_pipeline = async_pipeline
        self.accumulate_on_device = accumulate_on_device
        self._draw_for_cycle = draw_for_cycle
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._cycle = 0
        self._frames = 0
        self._pending = None  # the dispatched window awaiting publish
        self._mem = _Pinned(self.device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.current_stream(self.device) if cuda else None
        self._dispatcher = (concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="pcp-dispatch") if async_pipeline else None)

        A, N = config.accumulate_count, config.max_points
        # per-window poses: A frame poses + the sensor pose (row A), by parity
        self._poses = self._mem.empty((2, A + 1, 7), torch.float32)
        if accumulate_on_device:
            if N % A:
                raise ValueError(
                    "accumulate_on_device needs max_points divisible by "
                    f"accumulate_count ({N} % {A} != 0)"
                )
            F = self._frame_capacity = N // A
            # the device window, by parity: frames of window k+1 upload
            # while window k computes
            self._win_pts = torch.zeros((2, A, F, 3), dtype=torch.float32, device=self.device)
            self._win_valid = torch.zeros((2, A, F), dtype=torch.bool, device=self.device)
            self._win_read = [None, None]  # compute-stream event: window of that parity read
            # one pinned staging slot a frame, reused once its copy is done
            self._stage_pts = self._mem.empty((A, F, 3), torch.float32)
            self._stage_valid = self._mem.empty((A, F), torch.bool)
            self._stage_done = [None] * A
            self._upload_stream = torch.cuda.Stream(self.device) if cuda else None
        else:
            self._snap_pts = self._mem.empty((2, N, 3), torch.float32)
            self._snap_valid = self._mem.empty((2, N), torch.bool)
            self._snap_done = [None, None]  # upload of that parity's snapshot done
        self._fetch_bufs = [None, None]  # pinned result buffers, by parity
        self.accumulator = ScanAccumulator(N, force_numpy=force_numpy_accumulator)
        self.last_result = None
        self.last_cycle_seconds = 0.0
        self.metrics: list[dict] = []  # per-cycle structured stats history
        # host seconds of each trigger frame's callback (dispatch, and the
        # publish of this window or, async, of the one before)
        self.trigger_seconds: list[float] = []
        # host->device bytes of the window being accumulated
        self._upload_bytes = 0

        # topic surface (cpp:1004-1011)
        adv = self.bus.advertise
        self.pub_occupancy = adv("occupancy_grid", 1)
        self.pub_centroids = adv("centroids", 1)
        self.pub_clusters = adv("euc_clusters", 5)
        self.pub_voxel = adv("voxel_grid", 1)
        self.pub_outliers = adv("statistical_outliers", 1)
        self.pub_planar = adv("planar_cloud", 1000)
        self.pub_indices = adv("indices_cloud", 1000)
        self.pub_filtered = adv("cloud_f", 1000)
        self.sub = self.bus.subscribe(input_topic, self.cloud_cb, queue_size=1)

    # ------------------------------------------------------------ callbacks
    def cloud_cb(self, msg: PointCloud2Msg) -> None:
        """The reference's cloud_cb (cpp:674-928): accumulate until the
        window is full, then process.  Note the reference quirk mirrored
        here: the frame that triggers processing is *not* accumulated
        (cpp:691-699 else-branch)."""
        if self._frames < self.config.accumulate_count:
            # host-side (NumPy) tf lookup: no device work per frame
            q, t = self.tf.lookup_quat_trans(self.world_frame, self.sensor_frame)
            if self.accumulate_on_device:
                self._append_frame_device(msg, q, t)
            else:
                R = _quat_to_matrix_np(q)
                # full wire layout: organized clouds (height x width, row
                # padding) and arbitrary field offsets decode natively
                self.accumulator.append_cloud2_organized(
                    msg.data, msg.height, msg.width, msg.row_step,
                    msg.point_step, msg.off_x, msg.off_y, msg.off_z, R, t,
                )
            self._frames += 1
        else:
            self.process_window()

    def _append_frame_device(self, msg: PointCloud2Msg, q, t) -> None:
        """Decode + pad one frame into its pinned staging slot and start its
        copy into the device window now, on the upload stream: the copy
        overlaps the sensor cadence instead of a bulk window upload sitting
        between windows (the sensor->world transform runs on the card
        inside process_frames)."""
        i, p, F = self._frames, self._cycle % 2, self._frame_capacity
        xyz = decode_cloud2_organized(
            msg.data, msg.height, msg.width, msg.row_step,
            msg.point_step, msg.off_x, msg.off_y, msg.off_z,
        )[:F]
        _wait(self._stage_done[i])  # the slot's previous copy has been read
        pts, valid = self._stage_pts[i].numpy(), self._stage_valid[i].numpy()
        n = len(xyz)
        pts[:n] = xyz
        pts[n:] = 0.0
        valid[:n] = True
        valid[n:] = False
        self._poses[p, i, :4] = torch.from_numpy(np.asarray(q, np.float32))
        self._poses[p, i, 4:] = torch.from_numpy(np.asarray(t, np.float32))
        with _on(self._upload_stream):
            if i == 0 and self._win_read[p] is not None:
                # the window buffer of this parity was read by window k-2
                self._upload_stream.wait_event(self._win_read[p])
            self._win_pts[p, i].copy_(self._stage_pts[i], non_blocking=True)
            self._win_valid[p, i].copy_(self._stage_valid[i], non_blocking=True)
            self._stage_done[i] = self._mem.event(self._upload_stream)
        self._upload_bytes += F * 12 + F

    # ------------------------------------------------------------- pipeline
    def process_window(self):
        """Run the pipeline over the accumulated window on the card and
        publish.

        In async mode the window is handed to the dispatch thread and the
        previous window's results are published instead, so the card
        crunches window k while the host accumulates window k+1."""
        t_trigger = time.perf_counter()
        c, p = self._cycle, self._cycle % 2
        q, t = self.tf.lookup_quat_trans(self.world_frame, self.sensor_frame)
        poses = self._poses[p]
        poses[-1, :4] = torch.from_numpy(np.asarray(q, np.float32))
        poses[-1, 4:] = torch.from_numpy(np.asarray(t, np.float32))

        if self.accumulate_on_device:
            A, n = self.config.accumulate_count, self._frames
            # a short window (flush before full) pads with empty frames and
            # identity poses
            poses[n:A] = torch.from_numpy(_IDENTITY_POSE)
            with _on(self._upload_stream):
                if n < A:
                    if n == 0 and self._win_read[p] is not None:
                        self._upload_stream.wait_event(self._win_read[p])
                    self._win_pts[p, n:].zero_()
                    self._win_valid[p, n:].zero_()
                ready = self._mem.event(self._upload_stream)
            args = (p, ready)
        else:
            _wait(self._snap_done[p])  # this parity's last upload has been read
            self.accumulator.snapshot(out=(self._snap_pts[p].numpy(),
                                           self._snap_valid[p].numpy()))
            self._upload_bytes += self.config.max_points * 13
            self.accumulator.clear()
            args = (p, None)
        self._cycle += 1
        self._frames = 0
        upload_bytes, self._upload_bytes = self._upload_bytes, 0

        window = (self._cycle, upload_bytes, t_trigger)
        if not self.async_pipeline:
            out = self._publish(self._dispatch(c, *args), *window)
        else:
            job = self._dispatcher.submit(self._dispatch, c, *args)
            prev, self._pending = self._pending, (job, *window)
            out = None if prev is None else self._publish(prev[0].result(), *prev[1:])
        self.trigger_seconds.append(time.perf_counter() - t_trigger)
        return out

    def _dispatch(self, c: int, p: int, ready):
        """Issue window ``c`` (buffers of parity ``p``) to the card: the
        poses' and (host mode) the snapshot's copies, the pipeline, and the
        copies of what ``_publish`` reads into pinned buffers, followed by
        an event.  Returns (result, host arrays, bytes fetched, event, the
        spans the dispatch closed)."""
        with _on(self._stream), timing.collect() as spans:
            dev, cfg = self.device, self.config
            poses = self._poses[p].to(dev, non_blocking=True)
            sensor = RigidTransform(poses[-1, :4], poses[-1, 4:])
            draw = (self._draw_for_cycle(c) if self._draw_for_cycle is not None
                    else default_draw(cfg, self.generator, dev))
            if self.accumulate_on_device:
                if ready is not None:
                    self._stream.wait_event(ready)
                A = cfg.accumulate_count
                result = process_frames(
                    self._win_pts[p], self._win_valid[p], cfg,
                    RigidTransform(poses[:A, :4], poses[:A, 4:]),
                    shadow_sensor_pose=sensor, draw=draw,
                )
                self._win_read[p] = self._mem.event(self._stream)
            else:
                cloud = Cloud(points=self._snap_pts[p].to(dev, non_blocking=True),
                              valid=self._snap_valid[p].to(dev, non_blocking=True))
                self._snap_done[p] = self._mem.event(self._stream)
                result = process_scan(cloud, cfg, sensor, draw=draw)
            host, fetch_bytes = self._fetch(result, p)
            return result, host, fetch_bytes, self._mem.event(self._stream), spans

    def _fetch(self, result, p: int) -> dict:
        """Start the copies of every field ``_publish`` reads into the
        pinned buffers of parity ``p``; the stage counts and flags go as one
        int32 vector.  Returns the host arrays by field and the bytes
        copied (the published arrays; the stats vector aside)."""
        s = result.stats
        fields = {
            "grid": result.grid.data,
            "xyzr": result.centroids.points.xyzr,
            "centroid_valid": result.centroids.valid,
            "obstacles": result.obstacle_cloud.points,
            "labels": result.clusters.point_cluster,
            "stats": torch.stack([getattr(s, k).to(torch.int32)
                                  for k in STAT_COUNTS + STAT_FLAGS]),
        }
        if self.config.publish_point_clouds:
            for name in _DEBUG_CLOUDS:
                c = getattr(result, name)
                fields[name + ".points"], fields[name + ".valid"] = c.points, c.valid
        bufs = self._fetch_bufs[p]
        if bufs is None:
            bufs = self._fetch_bufs[p] = {
                k: self._mem.empty(v.shape, v.dtype) for k, v in fields.items()}
        copied = {}  # one copy a tensor (the last plane shares the outliers' points)
        n_bytes = 0
        for k, v in fields.items():
            key = (v.data_ptr(), v.dtype, tuple(v.shape))
            if key in copied:
                bufs[k] = bufs[copied[key]]
                continue
            copied[key] = k
            bufs[k].copy_(v, non_blocking=True)
            n_bytes += 0 if k == "stats" else v.numel() * v.element_size()
        return {k: bufs[k].numpy() for k in fields}, n_bytes

    def flush(self):
        """Publish the pending async window, if any (joining its dispatch)."""
        if self._pending is not None:
            prev, self._pending = self._pending, None
            return self._publish(prev[0].result(), *prev[1:])
        return None

    def join(self) -> None:
        """Wait until every dispatched window has been issued to the card
        (async mode); its results are published by the next trigger frame
        or by :meth:`flush`."""
        if self._pending is not None:
            self._pending[0].result()

    def close(self) -> None:
        """Stop the dispatch thread (a pending window is dropped unless
        :meth:`flush` ran first)."""
        if self._dispatcher is not None:
            self._dispatcher.shutdown(wait=True)

    def _publish(self, dispatched, seq, upload_bytes: int = 0, t_trigger: float | None = None):
        """Wait for one window's copies and publish the topic surface."""
        t0 = time.perf_counter()
        result, host, fetch_bytes, done, spans = dispatched
        _wait(done)
        cfg = self.config
        self.last_result = result
        grid = host["grid"]
        self.pub_occupancy.publish(
            OccupancyGridMsg(
                header=Header.now(self.world_frame, seq),
                resolution=cfg.block_size,
                width=cfg.grid_width,
                height=cfg.grid_height,
                data=grid.reshape(-1).copy(),  # the pinned buffer is reused
                origin_position=result.grid.origin_position,
                origin_orientation_xyzw=result.grid.origin_orientation_xyzw,
            )
        )
        self.pub_centroids.publish(
            PointIndicesArrayMsg.from_array(host["xyzr"], host["centroid_valid"], seq)
        )
        obst, labels = host["obstacles"], host["labels"]
        self.pub_clusters.publish(
            PointCloud2Msg.from_xyz(obst[labels >= 0], self.world_frame, seq=seq)
        )

        if cfg.publish_point_clouds:
            def cloud_msg(name):
                p = host[name + ".points"][host[name + ".valid"]]
                return PointCloud2Msg.from_xyz(p, self.world_frame, seq=seq)

            self.pub_voxel.publish(cloud_msg("voxel_cloud"))
            self.pub_outliers.publish(cloud_msg("outlier_filtered_cloud"))
            # planar_cloud / cloud_f carry the FULL non-plane cloud
            # (cpp:401-426) — not the cluster_capacity-compacted obstacle
            # cloud, so a cluster_overflow never drops debug points.  One
            # message serves both topics.
            nonplane_msg = cloud_msg("nonplane_cloud")
            self.pub_planar.publish(nonplane_msg)
            self.pub_indices.publish(cloud_msg("last_plane_cloud"))
            self.pub_filtered.publish(nonplane_msg)

        now = time.perf_counter()
        self.last_cycle_seconds = now - t0
        stats = dict(zip(STAT_COUNTS + STAT_FLAGS, host["stats"].tolist()))
        counts = {k: stats[k] for k in STAT_COUNTS}
        flags = {k: bool(stats[k]) for k in STAT_FLAGS}
        # structured per-cycle metrics (the reference's stage-size/timing
        # logs, cpp:706, :735, :747, :872-925, as data instead of text)
        self.metrics.append(
            {
                "cycle": int(seq),
                "publish_seconds": self.last_cycle_seconds,
                # trigger frame of this window to the end of its publish
                "window_seconds": None if t_trigger is None else now - t_trigger,
                # what this cycle moved between host and card: upload
                # counted at dispatch (frames or snapshot), fetch at publish
                # (the published arrays; the 48-byte stats vector aside)
                "upload_bytes": int(upload_bytes),
                "fetch_bytes": int(fetch_bytes),
                **counts,
                **flags,
                **(_span_metrics(spans, seq) if spans else {}),
            }
        )
        if flags["cluster_band_overflow"]:
            log.warning(
                "cycle %d: cluster_band_window=%d exceeded — sweep edges "
                "dropped (clusters may split); raise cluster_band_window",
                seq, cfg.cluster_band_window,
            )
        if flags["voxel_overflow"]:
            log.warning(
                "cycle %d: max_voxels=%d overflowed — voxel cloud truncated;"
                " raise max_voxels",
                seq, cfg.max_voxels,
            )
        if flags["cluster_overflow"]:
            log.warning(
                "cycle %d: cluster_capacity=%d overflowed (%d non-plane points)"
                " — obstacle cloud truncated; raise cluster_capacity",
                seq, cfg.cluster_capacity, counts["nonplane_points"],
            )
        if flags["planes_truncated"]:
            log.warning(
                "cycle %d: max_planes=%d hit with >%.0f%% of points still"
                " unsegmented — the reference's unbounded plane loop would"
                " have continued; raise max_planes",
                seq, cfg.max_planes, 100.0 * cfg.plane_min_remaining_frac,
            )
        if flags["cluster_unconverged"]:
            log.warning(
                "cycle %d: cluster label propagation hit cluster_max_iters"
                "=%d before the fixpoint — clusters may be split; raise"
                " cluster_max_iters",
                seq, cfg.cluster_max_iters,
            )
        log.info(
            "cycle %d publish: %.1f ms | in=%d cropped=%d voxels=%d inliers=%d "
            "nonplane=%d planes=%d clusters=%d",
            seq, 1e3 * self.last_cycle_seconds, *counts.values(),
        )
        return result
