"""In-process pub/sub message bus (the reference's ROS-graph equivalent).

A copy of ``pointcloud_obstacle_processing_tpu/runtime/bus.py`` (plain
Python; the port keeps its own).

The reference moves data between processes over TCPROS topics — 1 input and
8 output topics (obstacle_detection.cpp:1001-1011, SURVEY.md §5).  Inside
one host process, "transport" is a thread-safe topic registry with
bounded per-subscriber queues honoring ROS's ``queue_size`` semantics (the
reference subscribes with queue_size=1: a slow consumer sees only the
freshest scan — same drop-oldest behavior here).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable

__all__ = ["MessageBus", "Publisher", "Subscription"]


class Subscription:
    def __init__(self, topic: str, callback: Callable[[Any], None], queue_size: int):
        self.topic = topic
        self.callback = callback
        self.queue = collections.deque(maxlen=max(1, queue_size))
        self.dropped = 0  # observability: messages lost to the bound
        self._lock = threading.Lock()

    def push(self, msg: Any) -> None:
        with self._lock:
            if len(self.queue) == self.queue.maxlen:
                self.dropped += 1
            self.queue.append(msg)

    def drain(self) -> int:
        """Deliver every queued message to the callback; returns count."""
        n = 0
        while True:
            with self._lock:
                if not self.queue:
                    return n
                msg = self.queue.popleft()
            self.callback(msg)
            n += 1


class Publisher:
    def __init__(self, bus: "MessageBus", topic: str, latch: bool = False):
        self.bus = bus
        self.topic = topic
        self.latch = latch
        self.n_published = 0

    def publish(self, msg: Any) -> None:
        self.n_published += 1
        self.bus._dispatch(self.topic, msg, latch=self.latch)


class MessageBus:
    """Topic registry.  ``spin_once`` drains queues on the caller's thread —
    the single-threaded callback model of ``ros::spin()``
    (obstacle_detection.cpp:1014); ``publish`` may be called from any
    thread."""

    def __init__(self, immediate: bool = False):
        self._subs: dict[str, list[Subscription]] = {}
        self._latched: dict[str, Any] = {}  # topic -> last latched message
        self._lock = threading.Lock()
        self.immediate = immediate  # deliver on publish (no spin needed)

    def advertise(self, topic: str, queue_size: int = 1, latch: bool = False) -> Publisher:
        """``latch``: ROS latched-topic semantics (the /tf_static idiom) —
        the last published message is retained and delivered to every
        LATER subscriber, so a static transform published once at startup
        reaches consumers that connect afterwards."""
        del queue_size  # publisher-side queueing is a transport concern
        return Publisher(self, topic, latch=latch)

    def subscribe(self, topic: str, callback: Callable[[Any], None], queue_size: int = 1) -> Subscription:
        sub = Subscription(topic, callback, queue_size)
        # Latched replay with registration-ordering guarantee: deliver the
        # retained message BEFORE the sub becomes visible to _dispatch,
        # re-checking under the lock until the latched value is the one we
        # delivered — so a publish racing this subscribe can never deliver
        # a NEWER message first and have the stale replay clobber it.
        # Delivery happens outside the lock (immediate-mode callbacks may
        # themselves publish).
        delivered: Any = None
        while True:
            with self._lock:
                latched = self._latched.get(topic)
                if latched is None or latched is delivered:
                    self._subs.setdefault(topic, []).append(sub)
                    break
            if self.immediate:
                sub.callback(latched)
            else:
                sub.push(latched)
            delivered = latched
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        """Detach a subscription.  Idempotent.  After this returns, only a
        ``_dispatch`` that had ALREADY snapshotted the subscriber list may
        still deliver one in-flight message; nothing further after that.
        (Transport-bridge connections unsubscribe on disconnect so
        reconnecting subscribers don't leak dead subscriptions — review
        r5 finding #2.)"""
        with self._lock:
            group = self._subs.get(sub.topic)
            if group is not None:
                try:
                    group.remove(sub)
                except ValueError:
                    pass

    def latched(self, topic: str) -> Any | None:
        """The retained message of a latched topic, if any."""
        with self._lock:
            return self._latched.get(topic)

    def _dispatch(self, topic: str, msg: Any, latch: bool = False) -> None:
        with self._lock:
            if latch:
                self._latched[topic] = msg
            subs = list(self._subs.get(topic, ()))
        for sub in subs:
            if self.immediate:
                sub.callback(msg)
            else:
                sub.push(msg)

    def spin_once(self) -> int:
        with self._lock:
            subs = [s for group in self._subs.values() for s in group]
        return sum(s.drain() for s in subs)
