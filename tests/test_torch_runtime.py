"""The port's host runtime copies held to the JAX package's originals on the
CPU: message codecs, recording, bus, tf, the native accumulator, the TCP
transport, calibration files and the stage timer.

Each copy must behave exactly as its original: the same wire bytes, the
same lookups to 0 ulps, the same accumulated windows.  Both packages run
in this process (JAX on the CPU); data crosses as NumPy arrays.
"""

import dataclasses
import time

import numpy as np
import pytest

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG
from pointcloud_obstacle_processing_tpu import native as ref_native
from pointcloud_obstacle_processing_tpu.runtime import bus as ref_bus
from pointcloud_obstacle_processing_tpu.runtime import calibration as ref_calib
from pointcloud_obstacle_processing_tpu.runtime import msgs as ref_msgs
from pointcloud_obstacle_processing_tpu.runtime import recording as ref_rec
from pointcloud_obstacle_processing_tpu.runtime import tf as ref_tf
from pointcloud_obstacle_processing_tpu.runtime import transport as ref_transport
from pointcloud_obstacle_processing_tpu_torch import native
from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.runtime import bus, calibration, msgs, recording, tf
from pointcloud_obstacle_processing_tpu_torch.runtime import transport
from pointcloud_obstacle_processing_tpu_torch.utils import timing
from pointcloud_obstacle_processing_tpu_torch.utils.timing import StageTimer, profile_trace


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ------------------------------------------------------------------ msgs
def _cloud_msgs(mod, rng_seed):
    """The same clouds built by one package's msgs: packed, organized with
    row padding, an extra channel and an invalid pixel, and a non-standard
    field layout (x/y/z at 4/8/12 behind an rgb field)."""
    rng = np.random.default_rng(rng_seed)
    xyz = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    xyz[5] = np.inf
    packed = mod.PointCloud2Msg.from_xyz(xyz, seq=3)
    img = rng.uniform(-2, 2, (8, 6, 3)).astype(np.float32)
    img[2, 3] = np.nan
    inten = rng.uniform(0, 1, (8, 6)).astype(np.float32)
    organized = mod.PointCloud2Msg.from_organized(
        img, seq=7, extra_channels={"intensity": inten}, row_pad=5)
    fields = [mod.PointField(n, o) for n, o in (("rgb", 0), ("x", 4), ("y", 8), ("z", 12))]
    odd = mod.PointCloud2Msg.from_organized(img[:4, :5], fields=fields, point_step=16)
    out = [packed, organized, odd]
    for m in out:
        m.header = mod.Header("kinect2_link", 12.5, m.header.seq)
    return out


@pytest.mark.parametrize("which", ["packed", "organized", "nonstandard_offsets"])
def test_pointcloud2_wire_bytes_equal_the_reference(which):
    i = ["packed", "organized", "nonstandard_offsets"].index(which)
    ours, theirs = _cloud_msgs(msgs, 0)[i], _cloud_msgs(ref_msgs, 0)[i]
    wire = ours.serialize()
    assert wire == theirs.serialize()
    # each package decodes the other's bytes to the same message
    a, b = msgs.PointCloud2Msg.deserialize(theirs.serialize()), ref_msgs.PointCloud2Msg.deserialize(wire)
    assert (a.height, a.width, a.row_step, a.point_step, a.off_x, a.off_y, a.off_z) == \
        (b.height, b.width, b.row_step, b.point_step, b.off_x, b.off_y, b.off_z)
    np.testing.assert_array_equal(a.xyz(), b.xyz())
    np.testing.assert_array_equal(ours.xyz(), theirs.xyz())


def test_grid_centroid_and_transform_wire_bytes_equal_the_reference(rng):
    grid = (rng.integers(0, 3, 120 * 101) * 50).astype(np.int8)
    xyzr = rng.normal(size=(16, 4)).astype(np.float32)
    valid = rng.random(16) < 0.5
    q = _unit_quats(rng, 1)[0]
    built = {}
    for name, m in (("port", msgs), ("ref", ref_msgs)):
        h = m.Header("world", 3.25, 9)
        g = m.OccupancyGridMsg(header=h, resolution=0.0375, width=101, height=120, data=grid,
                               origin_position=(4.5, 0.0, 0.0),
                               origin_orientation_xyzw=(0.0, 0.0, 0.707, 0.707))
        c = m.PointIndicesArrayMsg.from_array(xyzr, valid, seq=9)
        c.header = h
        t = m.TransformStampedMsg(header=h, child_frame_id="kinect2_link",
                                  translation=(0.125, -2.0, 1.55), rotation_xyzw=tuple(q))
        built[name] = (g, c, t)
    for ours, theirs in zip(built["port"], built["ref"]):
        wire = ours.serialize()
        assert wire == theirs.serialize()
        assert type(theirs).deserialize(wire).serialize() == wire
        assert type(ours).deserialize(wire).serialize() == wire


# ------------------------------------------------------------- recording
def test_recording_round_trips_against_the_reference(tmp_path):
    clouds = _cloud_msgs(msgs, 1)
    path = str(tmp_path / "ours.scans")
    with recording.ScanWriter(path) as w:
        for m in clouds:
            w.write(m)
    got = list(ref_rec.read_scans(path))
    assert [m.serialize() for m in got] == [m.serialize() for m in clouds]
    path2 = str(tmp_path / "theirs.scans")
    with ref_rec.ScanWriter(path2) as w:
        for m in _cloud_msgs(ref_msgs, 1):
            w.write(m)
    assert open(path, "rb").read() == open(path2, "rb").read()
    back = list(recording.read_scans(path2))
    assert [m.serialize() for m in back] == [m.serialize() for m in clouds]


# ------------------------------------------------------------------- bus
@pytest.mark.parametrize("mod", [bus, ref_bus], ids=["port", "reference"])
def test_bus_queue_latch_and_unsubscribe(mod):
    """The copy keeps the original's semantics: drop-oldest queues,
    immediate delivery, latched replay to late subscribers, unsubscribe
    (cf. tests/test_runtime.py:92-112, :318)."""
    b = mod.MessageBus()
    seen = []
    sub = b.subscribe("t", seen.append, queue_size=2)
    pub = b.advertise("t")
    for i in range(5):
        pub.publish(i)
    assert sub.dropped == 3
    b.spin_once()
    assert seen == [3, 4]

    b = mod.MessageBus(immediate=True)
    pub = b.advertise("tf_static", latch=True)
    pub.publish("static-pose")
    got = []
    sub = b.subscribe("tf_static", got.append)
    assert got == ["static-pose"]
    pub.publish("static-pose-2")
    assert got == ["static-pose", "static-pose-2"] and b.latched("tf_static") == "static-pose-2"
    b.unsubscribe(sub)
    pub.publish("after")
    assert got == ["static-pose", "static-pose-2"]
    b.unsubscribe(sub)  # idempotent

    q = mod.MessageBus()
    q.advertise("t", latch=True).publish(42)
    got2 = []
    q.subscribe("t", got2.append)
    assert got2 == []
    q.spin_once()
    assert got2 == [42]


# -------------------------------------------------------------------- tf
def _tf_pair(rng):
    """The same frame graph in both packages: a static mount, a stamped
    moving edge and a static child of the sensor."""
    bufs = (tf.TransformBuffer(), ref_tf.TransformBuffer())
    q0 = _unit_quats(rng, 3)
    for b, m in zip(bufs, (msgs, ref_msgs)):
        b.set_static("world", "base", q0[0], (1.0, -0.5, 0.25))
        for k, stamp in enumerate((1.0, 2.0)):
            b.set_transform(m.TransformStampedMsg(
                header=m.Header("base", stamp), child_frame_id="kinect2_link",
                translation=(0.1 * k, 1.89, 1.55), rotation_xyzw=tuple(q0[1 + k])))
        b.set_static("kinect2_link", "ir_optical", (-0.5, 0.5, -0.5, 0.5), (0.0, 0.05, 0.0))
    return bufs


@pytest.mark.parametrize("target,source,time_", [
    ("world", "kinect2_link", None), ("kinect2_link", "world", None),
    ("world", "ir_optical", None), ("ir_optical", "base", 1.5),
    ("world", "kinect2_link", 1.25), ("world", "kinect2_link", 2.0),
])
def test_tf_lookups_equal_the_reference_to_0_ulps(rng, target, source, time_):
    ours, theirs = _tf_pair(rng)
    q, t = ours.lookup_quat_trans(target, source, time_)
    rq, rt = theirs.lookup_quat_trans(target, source, time_)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(t, rt)
    tr, ref = ours.lookup_transform(target, source, time_), theirs.lookup_transform(target, source, time_)
    assert tr.quat_xyzw.device.type == "cpu"
    np.testing.assert_array_equal(tr.quat_xyzw.numpy(), np.asarray(ref.quat_xyzw))
    np.testing.assert_array_equal(tr.translation.numpy(), np.asarray(ref.translation))


def test_tf_extrapolation_and_disconnected_frames_raise_as_the_reference(rng):
    for b in _tf_pair(rng):
        with pytest.raises(KeyError):  # ExtrapolationError is a KeyError
            b.lookup_quat_trans("world", "kinect2_link", 5.0)
        with pytest.raises(KeyError):
            b.lookup_quat_trans("world", "mars")
        assert b.can_transform("world", "ir_optical") and not b.can_transform("world", "mars")


# ---------------------------------------------------------------- native
@pytest.mark.parametrize("force_numpy", [False, True], ids=["native", "numpy"])
def test_accumulator_equals_the_reference(rng, force_numpy):
    """Both backends: transform, NaN drop, organized decode and the
    capacity clamp give the reference's window bit for bit."""
    ours = native.ScanAccumulator(700, force_numpy=force_numpy)
    theirs = ref_native.ScanAccumulator(700, force_numpy=force_numpy)
    assert ours.backend == theirs.backend == ("numpy" if force_numpy else "native")
    q = _unit_quats(rng, 1)[0]
    from pointcloud_obstacle_processing_tpu_torch.runtime.driver import _quat_to_matrix_np

    R, t = _quat_to_matrix_np(q), np.array([0.5, -1.0, 2.0])
    xyz = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    xyz[7] = np.nan
    img = rng.uniform(-2, 2, (20, 30, 3)).astype(np.float32)
    img[1, 2] = np.inf
    for acc, m in ((ours, msgs), (theirs, ref_msgs)):
        assert acc.append_xyz(xyz, R, t) == 299
        o = m.PointCloud2Msg.from_organized(img, row_pad=3)
        # 600 - 1 finite records, clamped to the 401 slots left
        assert acc.append_cloud2_organized(o.data, o.height, o.width, o.row_step, o.point_step,
                                           o.off_x, o.off_y, o.off_z, R, t) == 401
        assert acc.count() == 700
    (p1, v1), (p2, v2) = ours.snapshot(), theirs.snapshot()
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(p1, p2)
    # the snapshot into given buffers (the node's pinned staging) is the same
    out = (np.full((700, 3), 7.0, np.float32), np.zeros(700, bool))
    p3, v3 = ours.snapshot(out=out)
    assert p3 is out[0]
    np.testing.assert_array_equal(p3, p1)
    np.testing.assert_array_equal(v3, v1)
    with pytest.raises(ValueError):
        ours.snapshot(out=(np.zeros((699, 3), np.float32), np.zeros(699, bool)))
    ours.clear()
    theirs.clear()
    assert ours.count() == theirs.count() == 0
    np.testing.assert_array_equal(ours.snapshot()[1], theirs.snapshot()[1])


def test_decoders_equal_the_reference(rng):
    m = _cloud_msgs(msgs, 2)[1]
    a = native.decode_cloud2_organized(m.data, m.height, m.width, m.row_step, m.point_step,
                                       m.off_x, m.off_y, m.off_z)
    b = ref_native.decode_cloud2_organized(m.data, m.height, m.width, m.row_step, m.point_step,
                                           m.off_x, m.off_y, m.off_z)
    np.testing.assert_array_equal(a, b)
    p = _cloud_msgs(msgs, 2)[0]
    short = p.data[: 40 * p.point_step + 7]  # a truncated tail clamps to whole records
    a = native.decode_cloud2(short, p.n_points, p.point_step, 0, 4, 8)
    np.testing.assert_array_equal(a, ref_native.decode_cloud2(short, p.n_points, p.point_step, 0, 4, 8))
    assert len(a) == 39  # 40 whole records, one of them the non-finite point 5
    with pytest.raises(ValueError):
        native.decode_cloud2(p.data, p.n_points, p.point_step, 0, 4, 13)


# ------------------------------------------------------------- transport
def _wait_for(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("client", ["port", "reference"])
def test_transport_loopback_round_trip(rng, client):
    """A port BusServer on localhost forwards a grid and a cloud to a
    remote bus (the port's own client, or the reference's: one wire)."""
    pub_bus, sub_bus = bus.MessageBus(immediate=True), bus.MessageBus(immediate=True)
    srv = transport.BusServer(pub_bus, ["occupancy_grid", "cloud"], port=0)
    try:
        connect = transport.connect_bus if client == "port" else ref_transport.connect_bus
        connect(sub_bus, srv.address[0], srv.address[1], ["occupancy_grid", "cloud"])
        got = {}
        sub_bus.subscribe("occupancy_grid", lambda m: got.setdefault("grid", m))
        sub_bus.subscribe("cloud", lambda m: got.setdefault("cloud", m))
        time.sleep(0.2)  # let the server register its local subscriptions
        grid = (rng.integers(0, 3, 40 * 30) * 50).astype(np.int8)
        gmsg = msgs.OccupancyGridMsg(header=msgs.Header("world", 1.5, 2), resolution=0.15,
                                     width=30, height=40, data=grid)
        cmsg = _cloud_msgs(msgs, 3)[1]
        pub_bus.advertise("occupancy_grid").publish(gmsg)
        pub_bus.advertise("cloud").publish(cmsg)
        assert _wait_for(lambda: len(got) == 2)
        assert got["grid"].serialize() == gmsg.serialize()
        assert got["cloud"].serialize() == cmsg.serialize()
    finally:
        srv.close()


# ----------------------------------------------------------- calibration
def test_calibration_files_cross_between_the_packages(tmp_path):
    cfg = REFERENCE_YAML_CONFIG.replace(accumulate_count=16, max_points=100352)
    port_cfg = PipelineConfig(**dataclasses.asdict(cfg))
    from pointcloud_obstacle_processing_tpu.ops.transforms import RigidTransform as RefTF
    from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform

    q, t = (-0.5, 0.5, -0.5, 0.5), (0.0, 1.89, 1.55)
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    calibration.save_calibration(ours, port_cfg, RigidTransform.from_quat_trans(q, t))
    ref_calib.save_calibration(theirs, cfg, RefTF.from_quat_trans(q, t))
    assert open(ours).read() == open(theirs).read()
    c, pose, world, sensor = calibration.load_calibration(theirs)
    assert dataclasses.asdict(c) == dataclasses.asdict(cfg) and (world, sensor) == ("world", "kinect2_link")
    np.testing.assert_array_equal(pose.quat_xyzw.numpy(), np.float32(q))
    with pytest.raises(ValueError):
        (tmp_path / "bad.json").write_text('{"format": "x"}')
        calibration.load_calibration(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------- timing
def test_stage_timer_marks_clamped_below_noise():
    t = StageTimer()
    t.record("real stage", 0.004)
    t.record("tiny stage", 0.0, clamped=True)
    table = t.table()
    assert "real stage: 0.004000 seconds" in table
    assert "0.000000" not in table
    assert "<noise" in table


def test_time_fn_and_trace_on_the_cpu(tmp_path):
    """``profile_trace`` exports a chrome trace of one call with the
    program's tracing on for it: the call's spans lie in the trace as
    ``record_function`` ranges, and stay for ``take``; tracing is off
    again after it."""
    import json

    import torch

    def call(a):
        with timing.span("pcp.call"):
            with timing.span("pcp.stage.sum"):
                return (a * 2).sum()

    timing.take()
    path = profile_trace(call, torch.ones(1000), trace_dir=str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    assert {"pcp.call", "pcp.stage.sum"} <= {e.get("name") for e in events}
    assert [s.name for s in timing.take().spans] == ["pcp.stage.sum", "pcp.call"]
    assert timing.span("pcp.call") is timing.OFF
