"""The port's node and device accumulation against the JAX package on the
CPU: the four rigid-transform functions and the batched ``apply`` bitwise
to the reference's jitted ones, ``process_frames`` bitwise to the
reference's on a seeded window, and the port's ``ObstacleDetectionNode``
against the JAX node on the same frames in all four modes (sync or async,
host or device accumulation), with the reference's RANSAC key chain
replayed through ``draw_for_cycle``: grids bitwise, every stage count and
flag equal, centroids within 1e-5.  Sizes are the reference's own node
tests' (``tests/test_async_driver.py``): 4,096-point frames, 4 a window,
3 windows.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_obstacle_processing_tpu import REFERENCE_YAML_CONFIG
from pointcloud_obstacle_processing_tpu.ops.transforms import RigidTransform as RefTF
from pointcloud_obstacle_processing_tpu.ops.transforms import quat_to_matrix as ref_quat_to_matrix
from pointcloud_obstacle_processing_tpu.pipeline import process_frames as ref_process_frames
from pointcloud_obstacle_processing_tpu.runtime.bus import MessageBus as RefBus
from pointcloud_obstacle_processing_tpu.runtime.driver import POINT_TOPIC
from pointcloud_obstacle_processing_tpu.runtime.driver import ObstacleDetectionNode as RefNode
from pointcloud_obstacle_processing_tpu.runtime.launch import (
    DEFAULT_SENSOR_POS,
    DEFAULT_SENSOR_QUAT,
    SyntheticKinect,
)
from pointcloud_obstacle_processing_tpu.runtime.tf import TransformBuffer as RefTFBuffer
from pointcloud_obstacle_processing_tpu_torch import from_reference
from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.models import process_frames
from pointcloud_obstacle_processing_tpu_torch.ops.transforms import RigidTransform, quat_to_matrix
from pointcloud_obstacle_processing_tpu_torch.runtime import launch as port_launch
from pointcloud_obstacle_processing_tpu_torch.runtime.bus import MessageBus
from pointcloud_obstacle_processing_tpu_torch.runtime.driver import ObstacleDetectionNode
from pointcloud_obstacle_processing_tpu_torch.runtime.tf import TransformBuffer
from pointcloud_obstacle_processing_tpu_torch.utils.scene import SceneSpec, make_scene
from test_torch_ransac import jax_key_chain_draw

# tests/test_async_driver.py's node configuration, 4 frames a window so
# that the device mode's fixed frame capacity is 4,096 points
CFG = REFERENCE_YAML_CONFIG.replace(
    max_points=16384, max_voxels=4096, cluster_capacity=1024,
    max_clusters=16, accumulate_count=4, downsample_leaf_size=0.06,
)
PORT_CFG = PipelineConfig(**dataclasses.asdict(CFG))
FRAME_POINTS = 4096
WINDOWS = 3
N_POSES = 10_000


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    t = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    return q, t


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ----------------------------------------------------- rigid transforms
def _quat_to_matrix(q, t, q2, t2):
    return (np.asarray(jax.jit(jax.vmap(ref_quat_to_matrix))(q)),
            quat_to_matrix(torch.tensor(q)).numpy())


def _matrix(q, t, q2, t2):
    ref = jax.jit(jax.vmap(lambda a, b: RefTF(a, b).matrix()))(q, t)
    return np.asarray(ref), RigidTransform(torch.tensor(q), torch.tensor(t)).matrix().numpy()


def _compose(q, t, q2, t2):
    q, q2 = _unit(q), _unit(q2)
    ref = jax.jit(jax.vmap(lambda a, b, c, d: RefTF(a, b).compose(RefTF(c, d))))(q, t, q2, t2)
    out = RigidTransform(torch.tensor(q), torch.tensor(t)).compose(
        RigidTransform(torch.tensor(q2), torch.tensor(t2)))
    return (np.concatenate([np.asarray(ref.quat_xyzw), np.asarray(ref.translation)], -1),
            torch.cat([out.quat_xyzw, out.translation], -1).numpy())


def _from_matrix(q, t, q2, t2):
    # rotation matrices of the seeded poses, half of them perturbed off
    # orthonormality (the branch-free candidate select must still agree)
    m = np.array(jax.jit(jax.vmap(lambda a, b: RefTF(a, b).matrix()))(q, t))
    m[len(m) // 2:, :3, :3] += np.random.default_rng(9).normal(
        0, 0.05, (len(m) - len(m) // 2, 3, 3)).astype(np.float32)
    ref = jax.jit(jax.vmap(RefTF.from_matrix))(m)
    out = RigidTransform.from_matrix(torch.tensor(m))
    return (np.concatenate([np.asarray(ref.quat_xyzw), np.asarray(ref.translation)], -1),
            torch.cat([out.quat_xyzw, out.translation], -1).numpy())


@pytest.mark.parametrize("fn", [_quat_to_matrix, _matrix, _compose, _from_matrix],
                         ids=["quat_to_matrix", "matrix", "compose", "from_matrix"])
def test_transform_functions_are_bitwise_the_reference(fn):
    """On 10,000 seeded poses each function equals the reference's jitted
    one bit for bit (the fused chains read off XLA:CPU's optimized HLO;
    ``jax.vmap`` gives the single pose's bits, checked on one below)."""
    q, t = _poses(1, N_POSES)
    q2, t2 = _poses(2, N_POSES)
    ref, got = fn(q, t, q2, t2)
    np.testing.assert_array_equal(got, ref)
    one_ref, one = fn(q[:1], t[:1], q2[:1], t2[:1])
    np.testing.assert_array_equal(one, one_ref)


def test_single_pose_functions_take_the_unbatched_forms():
    q, t = _poses(3, 1)
    q, t = _unit(q)[0], t[0]
    m = RigidTransform(torch.tensor(q), torch.tensor(t)).matrix()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jax.jit(lambda a, b: RefTF(a, b).matrix())(q, t)))
    back = RigidTransform.from_matrix(m)
    ref = jax.jit(RefTF.from_matrix)(np.asarray(m))
    np.testing.assert_array_equal(back.quat_xyzw.numpy(), np.asarray(ref.quat_xyzw))
    np.testing.assert_array_equal(back.translation.numpy(), t)


def test_batched_apply_is_bitwise_the_vmapped_reference():
    """``process_frames`` transforms each frame by its own pose under
    ``jax.vmap(lambda tf, p: tf.apply(p))``: the port's broadcasting
    ``apply`` gives its bits on 40 poses x 4,096 points."""
    q, t = _poses(4, 40)
    q = _unit(q)
    pts = np.random.default_rng(5).uniform(-4, 4, (40, 4096, 3)).astype(np.float32)
    ref = jax.jit(lambda a, b, p: jax.vmap(lambda tf, x: tf.apply(x))(RefTF(a, b), p))(q, t, pts)
    got = RigidTransform(torch.tensor(q), torch.tensor(t)).apply(torch.tensor(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------ process_frames
def _window(seed):
    """A = 4 sensor-frame frames of F = 4,096 slots of one scene, each seen
    from its own pose near the arena mount, the last two frames short."""
    rng = np.random.default_rng(seed)
    scene = make_scene(seed=seed, spec=SceneSpec(n_ground=12_000, n_rocks=3,
                                                 points_per_rock=800, n_noise=100))
    A, F = CFG.accumulate_count, CFG.max_points // CFG.accumulate_count
    q = np.tile(np.float32(DEFAULT_SENSOR_QUAT), (A, 1)) + rng.normal(0, 0.02, (A, 4)).astype(np.float32)
    q = _unit(q)
    t = (np.float32(DEFAULT_SENSOR_POS) + rng.normal(0, 0.05, (A, 3))).astype(np.float32)
    frames = np.zeros((A, F, 3), np.float32)
    valid = np.zeros((A, F), bool)
    for a, n in enumerate((F, F, 3000, 1200)):
        world = scene.points[rng.integers(0, len(scene.points), n)]
        inv = np.asarray(RefTF(q[a], t[a]).inverse().apply(jnp.asarray(world, jnp.float32)))
        frames[a, :n], valid[a, :n] = inv, True
    return frames, valid, q, t


def _assert_results_equal(got, ref):
    np.testing.assert_array_equal(got.grid.data.numpy(), np.asarray(ref.grid.data))
    for k in ("accumulated_points", "cropped_points", "voxel_points", "inlier_points",
              "nonplane_points", "num_planes", "num_clusters", "voxel_overflow",
              "cluster_overflow", "cluster_band_overflow", "planes_truncated",
              "cluster_unconverged"):
        assert int(getattr(got.stats, k)) == int(getattr(ref.stats, k)), k
    np.testing.assert_array_equal(got.planes.coeffs.numpy(), np.asarray(ref.planes.coeffs))
    cv = got.centroids.valid.numpy()
    np.testing.assert_array_equal(cv, np.asarray(ref.centroids.valid))
    np.testing.assert_allclose(got.centroids.points.xyzr.numpy()[cv],
                               np.asarray(ref.centroids.points.xyzr)[cv], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.clusters.point_cluster.numpy(),
                                  np.asarray(ref.clusters.point_cluster))


def test_process_frames_is_bitwise_the_reference():
    frames, valid, q, t = _window(7)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(partial(ref_process_frames, config=CFG))(
        frames, valid, key, world_from_sensor_per_frame=RefTF(q, t))
    st = from_reference(dataclasses.asdict(CFG), frames=frames, frame_valid=valid,
                        quat_xyzw=q, translation=t, device="cpu")
    got = process_frames(st.frames, st.frame_valid, st.config, st.pose,
                         draw=jax_key_chain_draw(key, CFG.ransac_hypotheses))
    assert int(got.stats.num_clusters) >= 1
    _assert_results_equal(got, ref)


def test_process_frames_refuses_a_window_that_is_not_max_points():
    frames, valid, q, t = _window(7)
    pose = RigidTransform(torch.tensor(q), torch.tensor(t))
    with pytest.raises(ValueError, match="max_points"):
        process_frames(torch.tensor(frames[:3]), torch.tensor(valid[:3]), PORT_CFG, pose)


# ----------------------------------------------------------------- node
def _nodes(async_mode, device_mode):
    """The JAX node and the port's on buses of their own, with one source
    that publishes each synthetic frame to both."""
    ref_bus, bus = RefBus(immediate=True), MessageBus(immediate=True)
    ref_tf, tf = RefTFBuffer(), TransformBuffer()
    for b in (ref_tf, tf):
        b.set_static("world", "kinect2_link", DEFAULT_SENSOR_QUAT, DEFAULT_SENSOR_POS)
    ref = RefNode(CFG, bus=ref_bus, tf_buffer=ref_tf, async_pipeline=async_mode,
                  accumulate_on_device=device_mode)
    key = jax.random.PRNGKey(0)  # the JAX node's seed 0
    port = ObstacleDetectionNode(
        PORT_CFG, bus=bus, tf_buffer=tf, async_pipeline=async_mode,
        accumulate_on_device=device_mode, device="cpu",
        draw_for_cycle=lambda c: jax_key_chain_draw(jax.random.fold_in(key, c),
                                                    CFG.ransac_hypotheses))
    source = RefBus(immediate=True)
    source.subscribe(POINT_TOPIC, lambda m: (ref_bus._dispatch(POINT_TOPIC, m),
                                             bus._dispatch(POINT_TOPIC, m)))
    kinect = SyntheticKinect(source.advertise(POINT_TOPIC),
                             ref_tf.lookup_transform("world", "kinect2_link"),
                             points_per_frame=FRAME_POINTS)
    published = {}
    for name, b in (("ref", ref_bus), ("port", bus)):
        for topic in ("occupancy_grid", "centroids", "euc_clusters", "voxel_grid", "cloud_f"):
            b.subscribe(topic, lambda m, k=(name, topic): published.setdefault(k, []).append(m))
    return ref, port, kinect, published


@pytest.mark.parametrize("async_mode,device_mode", [(False, False), (False, True),
                                                    (True, False), (True, True)],
                         ids=["sync-host", "sync-device", "async-host", "async-device"])
def test_node_matches_the_jax_node(async_mode, device_mode):
    """Three windows of the same frames through both nodes: every published
    grid bitwise, every stage count, flag and upload equal, centroids within
    1e-5, the cluster and debug clouds equal.  Async publishes each window
    one trigger late and ``flush`` publishes the last (cf.
    tests/test_async_driver.py:54-72).  Device mode never snapshots the
    bulk accumulator (cf. :118-124), and a short window (process_window
    after 2 frames) pads with empty frames and identity poses as the
    reference does."""
    ref, port, kinect, published = _nodes(async_mode, device_mode)
    if device_mode:
        def _forbidden(*a, **k):
            raise AssertionError("bulk accumulator snapshot on the device-accumulate path")
        port.accumulator.snapshot = _forbidden
    A = CFG.accumulate_count
    for w in range(WINDOWS):
        for _ in range(A + 1):  # +1: the trigger frame
            kinect.emit_frame()
        assert port.pub_occupancy.n_published == ref.pub_occupancy.n_published == w + (not async_mode)
    if device_mode:
        for _ in range(2):
            kinect.emit_frame()
        ref.process_window()
        port.process_window()
    if async_mode:
        ref.flush()
        port.flush()
        assert port.flush() is None
    windows = WINDOWS + device_mode
    assert port.pub_occupancy.n_published == ref.pub_occupancy.n_published == windows
    for a, b in zip(published["port", "occupancy_grid"], published["ref", "occupancy_grid"]):
        np.testing.assert_array_equal(a.data, b.data)
    for topic in ("euc_clusters", "voxel_grid", "cloud_f"):
        for a, b in zip(published["port", topic], published["ref", topic]):
            np.testing.assert_array_equal(a.xyz(), b.xyz())
    for a, b in zip(published["port", "centroids"], published["ref", "centroids"]):
        ra = np.array([[p.x, p.y, p.z, p.r] for p in a.points], np.float32).reshape(-1, 4)
        rb = np.array([[p.x, p.y, p.z, p.r] for p in b.points], np.float32).reshape(-1, 4)
        assert ra.shape == rb.shape
        np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-5)
    assert len(port.metrics) == len(ref.metrics) == windows
    for pm, rm in zip(port.metrics, ref.metrics):
        for k, v in rm.items():
            if k == "fetch_bytes":
                # the four debug clouds share the voxel cloud's points in
                # both packages (the gate and the plane loop change only
                # the masks); the port copies that buffer once, the JAX
                # node fetches it for each cloud
                assert pm[k] == v - 3 * CFG.max_voxels * 12
            elif k != "publish_seconds":
                assert pm[k] == v, (k, pm[k], v)
    assert max(m["num_clusters"] for m in port.metrics) >= 1
    assert len(port.trigger_seconds) == windows
    port.close()


def test_node_refuses_an_uneven_window_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="divisible"):
        ObstacleDetectionNode(PORT_CFG.replace(accumulate_count=3), accumulate_on_device=True,
                              device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ObstacleDetectionNode(PORT_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_launch.launch(config=PORT_CFG, cycles=1, points_per_frame=1024)


def test_launch_end_to_end_on_the_cpu():
    """The port's launch composition (cf. tests/test_runtime.py:137):
    synthetic frames -> bus -> tf -> native accumulator -> pipeline ->
    publish, two windows."""
    cfg = PORT_CFG.replace(accumulate_count=3)
    node, results = port_launch.launch(config=cfg, cycles=2, points_per_frame=FRAME_POINTS,
                                       device="cpu")
    assert node.device.type == "cpu" and node.accumulator.backend == "native"
    assert len(results) == 2 and node.last_result is results[-1]
    r = node.last_result
    assert int(r.clusters.num_clusters) >= 1
    assert (r.grid.data.numpy() == 100).sum() > 0
    assert node.pub_occupancy.n_published == node.pub_centroids.n_published == 2
    assert node.pub_voxel.n_published == 2
    assert node.accumulator.count() == 0
    m = node.metrics[0]
    assert [x["cycle"] for x in node.metrics] == [1, 2] and m["num_clusters"] >= 1
    assert m["publish_seconds"] > 0 and m["window_seconds"] >= m["publish_seconds"]
    assert m["upload_bytes"] == cfg.max_points * 13
    assert m["fetch_bytes"] >= cfg.grid_height * cfg.grid_width
    # the launch path attaches the tf listener
    from pointcloud_obstacle_processing_tpu_torch.runtime.msgs import Header, TransformStampedMsg
    from pointcloud_obstacle_processing_tpu_torch.runtime.tf import TF_TOPIC

    node.bus.advertise(TF_TOPIC).publish(TransformStampedMsg(
        header=Header("world", 5.0), child_frame_id="aux_sensor",
        translation=(1.0, 2.0, 3.0), rotation_xyzw=(0.0, 0.0, 0.0, 1.0)))
    np.testing.assert_array_equal(node.tf.lookup_transform("world", "aux_sensor").translation.numpy(),
                                  [1.0, 2.0, 3.0])
