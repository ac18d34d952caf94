"""Cross-process topic transport (the TCPROS equivalent of SURVEY.md L4).

A copy of ``pointcloud_obstacle_processing_tpu/runtime/transport.py`` (plain Python
and NumPy; the port keeps its own).

The reference node interoperates with other OS processes (kinect2_bridge,
the nav stack, RViz) over ROS's TCPROS: a publisher accepts TCP connections
and streams length-prefixed serialized messages per topic
(obstacle_detection.cpp:1001-1011 advertise/subscribe surface).  The
in-process ``MessageBus`` covers the intra-node graph; this module bridges
buses ACROSS processes with the same drop-oldest queue semantics:

* :class:`BusServer` — "advertise over TCP": accepts connections, reads the
  client's topic subscription list, then forwards every matching local-bus
  publication as a framed message.  Slow subscribers never stall the node:
  each connection has a bounded drop-oldest queue (ROS queue_size
  semantics) drained by its own writer thread.
* :func:`connect_bus` — "subscribe over TCP": connects to a BusServer,
  requests topics, and republishes the received messages on a local bus.

Wire format: per message a fixed frame header
``[u32 magic 'PCPB'][u16 type][u16 topic_len][u64 payload_len]`` followed
by the UTF-8 topic name and the message's own ``serialize()`` payload.
Message types carry their own versioned binary codecs (runtime/msgs.py) —
no pickle on the wire.
"""

from __future__ import annotations

import collections
import logging
import queue
import socket
import struct
import threading
from typing import Iterable

from .bus import MessageBus
from .msgs import (
    OccupancyGridMsg,
    PointCloud2Msg,
    PointIndicesArrayMsg,
    TransformStampedMsg,
)

__all__ = ["BusServer", "ConnectionStats", "connect_bus", "FRAME_MAGIC"]

log = logging.getLogger("pointcloud_obstacle_processing_tpu_torch")

FRAME_MAGIC = b"PCPB"
_HEADER = "<4sHHQ"
_HEADER_SIZE = struct.calcsize(_HEADER)

# type id <-> codec (stable wire contract; extend by appending)
_TYPES = {
    1: PointCloud2Msg,
    2: OccupancyGridMsg,
    3: PointIndicesArrayMsg,
    4: TransformStampedMsg,
}
_TYPE_IDS = {cls: tid for tid, cls in _TYPES.items()}


def _frame(topic: str, msg) -> bytes:
    tid = _TYPE_IDS.get(type(msg))
    if tid is None:
        raise TypeError(f"{type(msg).__name__} has no wire codec")
    t = topic.encode()
    payload = msg.serialize()
    return struct.pack(_HEADER, FRAME_MAGIC, tid, len(t), len(payload)) + t + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _read_frame(sock: socket.socket):
    head = _read_exact(sock, _HEADER_SIZE)
    magic, tid, tlen, plen = struct.unpack(_HEADER, head)
    if magic != FRAME_MAGIC:
        raise ValueError("bad frame magic")
    topic = _read_exact(sock, tlen).decode()
    payload = _read_exact(sock, plen)
    cls = _TYPES.get(tid)
    if cls is None:
        raise ValueError(f"unknown wire type id {tid}")
    return topic, cls.deserialize(payload)


class ConnectionStats:
    """Per-connection observability counters (the TCP mirror of the
    in-process bus's ``Subscription.dropped``).

    ``dropped`` counts messages lost to the bounded queue; ``disconnected``
    flips when the connection ends, with ``abnormal`` True when the peer
    vanished mid-stream (connection reset / broken pipe) rather than via a
    clean shutdown/close."""

    def __init__(self, peer):
        self.peer = peer
        self.sent = 0
        self.dropped = 0
        self.disconnected = False
        self.abnormal = False

    def as_dict(self) -> dict:
        return dict(
            peer=self.peer, sent=self.sent, dropped=self.dropped,
            disconnected=self.disconnected, abnormal=self.abnormal,
        )


class BusServer:
    """Expose selected local-bus topics to TCP subscribers.

    Equivalent of the reference's advertised topic surface: remote
    processes connect, send a newline-separated topic list terminated by an
    empty line, and receive framed messages.  ``queue_size`` bounds each
    connection's backlog with drop-oldest semantics (ROS publisher queues).
    Per-connection send/drop/disconnect counters are exposed via
    :meth:`connection_stats`, mirroring the in-process bus's per-subscriber
    drop counters; an abnormal disconnect logs a warning.
    """

    # closed-connection stats retained for observability (bounded: a
    # long-running node with reconnecting subscribers must not grow the
    # list without bound)
    MAX_CLOSED_STATS = 64

    def __init__(self, bus: MessageBus, topics: Iterable[str],
                 host: str = "127.0.0.1", port: int = 0, queue_size: int = 10):
        self.bus = bus
        self.topics = list(topics)
        self.queue_size = queue_size
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._stop = threading.Event()
        self._clients: list = []
        self._stats: list[ConnectionStats] = []  # live connections
        self._closed_stats: collections.deque = collections.deque(
            maxlen=self.MAX_CLOSED_STATS
        )
        self._stats_lock = threading.Lock()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def connection_stats(self) -> list[dict]:
        """Snapshot of every connection's counters: the most recent
        ``MAX_CLOSED_STATS`` closed connections, then the live ones."""
        with self._stats_lock:
            return [s.as_dict() for s in (*self._closed_stats, *self._stats)]

    # ---------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_client, args=(conn,), daemon=True
            ).start()

    def _serve_client(self, conn: socket.socket) -> None:
        try:
            peer = conn.getpeername()
        except OSError:
            peer = None
        stats = ConnectionStats(peer)
        with self._stats_lock:
            self._stats.append(stats)
        subs: list = []
        try:
            # subscription request: newline-separated topics, blank line ends
            req = b""
            while not req.endswith(b"\n\n"):
                chunk = conn.recv(4096)
                if not chunk:
                    return
                req += chunk
            wanted = [t for t in req.decode().split("\n") if t]
            wanted = [t for t in wanted if t in self.topics] or list(self.topics)

            q: queue.Queue = queue.Queue(maxsize=self.queue_size)

            def enqueue(topic):
                def cb(msg):
                    try:
                        q.put_nowait((topic, msg))
                    except queue.Full:  # drop-oldest (ROS queue semantics)
                        try:
                            q.get_nowait()
                            stats.dropped += 1
                        except queue.Empty:
                            pass
                        q.put_nowait((topic, msg))
                return cb

            # NOTE: a latched topic's retained message is replayed by
            # bus.subscribe straight into the queue, so a late TCP
            # subscriber still receives e.g. the tf_static transforms
            # published before it connected
            subs = [self.bus.subscribe(t, enqueue(t), queue_size=1) for t in wanted]
            self._clients.append(conn)
            conn.sendall(b"ok\n")
            while not self._stop.is_set():
                try:
                    topic, msg = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                conn.sendall(_frame(topic, msg))
                stats.sent += 1
        except (ConnectionError, OSError):
            # the peer vanished mid-stream: a reset/broken pipe, not a
            # clean unsubscribe — surface it
            if not self._stop.is_set():
                stats.abnormal = True
                log.warning(
                    "BusServer: subscriber %s disconnected abnormally "
                    "(%d msgs sent, %d dropped)",
                    stats.peer, stats.sent, stats.dropped,
                )
        finally:
            # detach this connection's bus subscriptions: a reconnecting
            # subscriber must not leak dead callbacks that every future
            # publish keeps invoking
            for s in subs:
                self.bus.unsubscribe(s)
            stats.disconnected = True
            with self._stats_lock:
                try:
                    self._stats.remove(stats)
                except ValueError:
                    pass
                self._closed_stats.append(stats)
            try:
                self._clients.remove(conn)
            except ValueError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for c in self._clients:
            try:
                c.close()
            except OSError:
                pass


def connect_bus(bus: MessageBus, host: str, port: int,
                topics: Iterable[str], daemon: bool = True,
                latched: Iterable[str] = ()) -> threading.Thread:
    """Subscribe a local bus to a remote BusServer's topics.

    Returns the receiver thread; messages arriving on the socket are
    republished on ``bus`` under their original topic names.  Topics in
    ``latched`` republish with latch semantics (the /tf_static idiom):
    the last bridged message is retained for local subscribers that
    attach later.
    """
    sock = socket.create_connection((host, port))
    req = "".join(f"{t}\n" for t in topics) + "\n"
    sock.sendall(req.encode())
    ack = _read_exact(sock, 3)
    if ack != b"ok\n":
        raise ConnectionError(f"bad subscribe ack: {ack!r}")
    pubs: dict = {}
    latched_set = set(latched)

    def recv_loop():
        try:
            while True:
                topic, msg = _read_frame(sock)
                if topic not in pubs:
                    pubs[topic] = bus.advertise(topic, latch=topic in latched_set)
                pubs[topic].publish(msg)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    t = threading.Thread(target=recv_loop, daemon=daemon)
    t.start()
    return t
