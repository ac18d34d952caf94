"""tf2-style transform buffer with stamped history.

The reference looks up ``world <-> kinect2_link`` from a tf2 listener
(obstacle_detection.cpp:124-125, :570, :592, :634, :692) — always at
``ros::Time(0)`` = latest-available, which is what the node driver uses
too.  Beyond that parity surface, this buffer carries tf2's stamped
HISTORY semantics: each edge keeps a bounded
time-ordered history (``cache_time`` seconds, tf2's default 10), and
``lookup_transform(..., time=t)`` interpolates between the bracketing
stamps — slerp for rotation, lerp for translation, exactly tf2's
``TimeCache::interpolate`` — so a replayed-bag deployment with a moving
sensor resolves each frame at its own stamp instead of arrival time.
Lookups outside an edge's recorded span raise (tf2's
ExtrapolationException); static edges (``set_static``) are timeless.

A copy of ``pointcloud_obstacle_processing_tpu/runtime/tf.py``, NumPy
inside; ``lookup_transform`` returns the port's ``RigidTransform`` on the
CPU.
"""

from __future__ import annotations

import threading
from bisect import bisect_left, insort

import numpy as np

from ..ops.transforms import RigidTransform
from .msgs import TransformStampedMsg

__all__ = [
    "TransformBuffer",
    "ExtrapolationError",
    "attach_tf_listener",
    "TF_TOPIC",
    "TF_STATIC_TOPIC",
]

# tf2's two-topic split: dynamic transforms stream on /tf, latched static
# ones on /tf_static — staticness is a property of the topic, not the
# message (tf2_ros::TransformListener subscribes both; the reference's
# listener at obstacle_detection.cpp:124-125, :938).  For the latch to
# hold across process boundaries, publish tf_static with
# ``bus.advertise(TF_STATIC_TOPIC, latch=True)`` and bridge it with
# ``connect_bus(..., latched=[TF_STATIC_TOPIC])`` — then a static mount
# published once at startup reaches subscribers that connect later.
TF_TOPIC = "tf"
TF_STATIC_TOPIC = "tf_static"


class ExtrapolationError(KeyError):
    """Requested time outside an edge's recorded history (tf2's
    ExtrapolationException equivalent)."""


def _quat_mul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def _quat_rot(q, v):
    u, w = np.asarray(q[:3]), q[3]
    t = 2.0 * np.cross(u, v)
    return np.asarray(v) + w * t + np.cross(u, t)


def _slerp(q0, q1, alpha):
    """Shortest-path spherical interpolation (tf2's Quaternion::slerp)."""
    q0 = np.asarray(q0, np.float64)
    q1 = np.asarray(q1, np.float64)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:  # shortest arc
        q1 = -q1
        dot = -dot
    if dot > 1.0 - 1e-9:  # near-parallel: lerp + renormalize
        q = q0 + alpha * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(dot, -1.0, 1.0))
    s = np.sin(theta)
    return (np.sin((1.0 - alpha) * theta) / s) * q0 + (
        np.sin(alpha * theta) / s
    ) * q1


class _EdgeHistory:
    """Time-ordered (stamp, quat, trans) samples for one child frame."""

    __slots__ = ("parent", "stamps", "quats", "transs", "static")

    def __init__(self, parent: str, static: bool = False):
        self.parent = parent
        self.stamps: list[float] = []
        self.quats: list[np.ndarray] = []
        self.transs: list[np.ndarray] = []
        self.static = static

    def insert(self, stamp: float, q: np.ndarray, t: np.ndarray) -> None:
        i = bisect_left(self.stamps, stamp)
        if i < len(self.stamps) and self.stamps[i] == stamp:
            self.quats[i] = q  # tf2: same-stamp update replaces
            self.transs[i] = t
            return
        self.stamps.insert(i, stamp)
        self.quats.insert(i, q)
        self.transs.insert(i, t)

    def prune(self, cache_time: float) -> None:
        if not self.stamps or self.static:
            return
        cutoff = self.stamps[-1] - cache_time
        i = bisect_left(self.stamps, cutoff)
        if i > 0:
            del self.stamps[:i], self.quats[:i], self.transs[:i]

    def at(self, time: float | None):
        """(quat, trans) at ``time``; None/0 = latest (ros::Time(0))."""
        if self.static or time is None or time == 0 or len(self.stamps) == 1:
            if time is not None and time != 0 and not self.static:
                s = self.stamps[0]
                if time != s:
                    raise ExtrapolationError(
                        f"single sample at {s}, requested {time}"
                    )
            return self.quats[-1], self.transs[-1]
        if not self.stamps:
            raise KeyError("empty edge history")
        if time < self.stamps[0] or time > self.stamps[-1]:
            raise ExtrapolationError(
                f"time {time} outside history "
                f"[{self.stamps[0]}, {self.stamps[-1]}]"
            )
        i = bisect_left(self.stamps, time)
        if self.stamps[i] == time:
            return self.quats[i], self.transs[i]
        t0, t1 = self.stamps[i - 1], self.stamps[i]
        alpha = (time - t0) / (t1 - t0)
        q = _slerp(self.quats[i - 1], self.quats[i], alpha)
        t = (1.0 - alpha) * self.transs[i - 1] + alpha * self.transs[i]
        return q, t


class TransformBuffer:
    """frame graph: child -> parent edge with stamped history.

    ``cache_time`` bounds each edge's history span (tf2 default 10 s);
    static edges are timeless.  ``lookup_transform(target, source)``
    resolves at the latest sample per edge (the reference's sole usage,
    ``ros::Time(0)``); pass ``time=`` for interpolated stamped lookups.
    """

    def __init__(self, cache_time: float = 10.0):
        self.cache_time = float(cache_time)
        self._edges: dict[str, _EdgeHistory] = {}
        self._lock = threading.Lock()

    def set_transform(self, msg: TransformStampedMsg, static: bool = False) -> None:
        q = np.asarray(msg.rotation_xyzw, np.float64)
        t = np.asarray(msg.translation, np.float64)
        stamp = float(getattr(msg.header, "stamp", 0.0) or 0.0)
        with self._lock:
            hist = self._edges.get(msg.child_frame_id)
            if (
                hist is None
                or hist.parent != msg.header.frame_id
                or (hist.static and not static)
            ):
                # Reset the history on: a new edge; re-parenting (tf2
                # keeps one parent per child, a parent change invalidates
                # old samples); or a STATIC edge receiving its first
                # DYNAMIC sample — a streaming publisher taking over a
                # mount makes the edge dynamic, and without the demotion
                # the edge would stay static forever: prune() skips
                # static edges (unbounded history growth at sensor rate)
                # and at() would keep returning latest instead of
                # interpolating.
                hist = _EdgeHistory(msg.header.frame_id, static=static)
                self._edges[msg.child_frame_id] = hist
            # NOTE deliberately NO re-promotion: a static sample arriving
            # on an already-DYNAMIC edge inserts as an ordinary sample
            # (tf2's one-cache-per-frame behavior) — promoting it would
            # ping-pong the edge static<->dynamic under mixed publishers
            # (e.g. a bridge reconnect replaying the latched tf_static
            # while /tf streams), and every demotion would wipe the
            # accumulated interpolation history.
            hist.insert(stamp, q, t)
            hist.prune(self.cache_time)

    def set_static(self, parent: str, child: str, quat_xyzw, translation) -> None:
        from .msgs import Header

        self.set_transform(
            TransformStampedMsg(
                header=Header.now(parent),
                child_frame_id=child,
                translation=tuple(translation),
                rotation_xyzw=tuple(quat_xyzw),
            ),
            static=True,
        )

    def _chain_to_root(self, frame: str, time: float | None):
        """Accumulated (q, t) mapping `frame` coords into the root frame,
        each edge resolved at ``time`` (None = latest).

        Holds the buffer lock across the whole walk: ``_EdgeHistory``
        mutates its stamp/quat/trans lists in place under ``set_transform``
        (insert/prune), so resolving ``at()`` outside the lock could read a
        torn (stamp, quat, trans) triple mid-mutation — exactly in the
        moving-sensor replay scenario the stamped history exists for.
        Lookups are cheap host-side work; the lock is never held across
        device dispatch."""
        q = np.array([0.0, 0.0, 0.0, 1.0])
        t = np.zeros(3)
        seen = set()
        with self._lock:
            while frame in self._edges:
                if frame in seen:
                    raise ValueError(f"tf cycle at {frame}")
                seen.add(frame)
                hist = self._edges[frame]
                eq, et = hist.at(time)
                # parent_from_frame ∘ current
                t = _quat_rot(eq, t) + et
                q = _quat_mul(eq, q)
                frame = hist.parent
        return frame, q, t

    def lookup_quat_trans(self, target: str, source: str, time: float | None = None):
        """Host-side lookup: (quat_xyzw, translation) as float64 NumPy.

        The hot accumulation path (one lookup per sensor frame) stays off
        the device: a pose built as a device tensor here would cost a copy
        (and a stream sync from pageable memory) per frame."""
        root_s, qs, ts = self._chain_to_root(source, time)
        root_t, qt, tt = self._chain_to_root(target, time)
        if root_s != root_t:
            raise KeyError(f"frames {source} and {target} are not connected")
        # target_from_source = inv(root_from_target) ∘ root_from_source
        qt_inv = qt * np.array([-1.0, -1.0, -1.0, 1.0])
        q = _quat_mul(qt_inv, qs)
        t = _quat_rot(qt_inv, ts - tt)
        return q, t

    def lookup_transform(
        self, target: str, source: str, time: float | None = None
    ) -> RigidTransform:
        """Transform mapping source-frame points into target frame
        (tfBuffer.lookupTransform(target, source, time) semantics; the
        default ``time=None`` is ros::Time(0) latest-available — the
        reference's only usage, cpp:570, :592, :634, :692)."""
        q, t = self.lookup_quat_trans(target, source, time)
        return RigidTransform.from_quat_trans(q, t)

    def can_transform(
        self, target: str, source: str, time: float | None = None
    ) -> bool:
        try:
            self.lookup_transform(target, source, time)
            return True
        except Exception:
            return False


def attach_tf_listener(
    bus,
    buffer: TransformBuffer,
    topic: str = TF_TOPIC,
    static_topic: str = TF_STATIC_TOPIC,
):
    """Feed ``buffer`` from the bus's tf topics (tf2_ros::TransformListener).

    The reference's tf2 listener is a TCPROS subscriber feeding its buffer
    (obstacle_detection.cpp:124-125, :938); here the same composition works
    across processes: a remote node publishes ``TransformStampedMsg`` on its
    bus, a :class:`~..runtime.transport.BusServer` exposes the tf topics,
    ``connect_bus`` republishes them locally, and this listener inserts each
    arriving transform into the stamped history — so lookup-at-time resolves
    remote poses exactly as in-process ones.

    Returns the (dynamic, static) subscriptions so callers can unsubscribe.
    """
    # queue_size 100 = tf2_ros::TransformListener's /tf subscription depth:
    # a burst of per-edge samples between spins must not drop history
    dyn = bus.subscribe(
        topic, lambda m: buffer.set_transform(m, static=False), queue_size=100
    )
    stat = bus.subscribe(
        static_topic, lambda m: buffer.set_transform(m, static=True), queue_size=100
    )
    return dyn, stat
