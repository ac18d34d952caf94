"""Scan stream recording/replay (the "recorded-bag harness").

The reference had no fixture or recorded-bag harness — validation meant
running the physical robot (SURVEY.md §4).  This module supplies the
missing piece: a length-prefixed append-only log of serialized
PointCloud2 messages that the launch layer can replay instead of a live
sensor, making regressions reproducible offline.  A copy of
``pointcloud_obstacle_processing_tpu/runtime/recording.py``.
"""

from __future__ import annotations

import struct
from typing import Iterator

from .msgs import PointCloud2Msg

__all__ = ["ScanWriter", "read_scans", "replay"]

_REC = struct.Struct("<Q")


class ScanWriter:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self.n_written = 0

    def write(self, msg: PointCloud2Msg) -> None:
        payload = msg.serialize()
        self._f.write(_REC.pack(len(payload)))
        self._f.write(payload)
        self.n_written += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scans(path: str) -> Iterator[PointCloud2Msg]:
    with open(path, "rb") as f:
        while True:
            head = f.read(_REC.size)
            if len(head) < _REC.size:
                return
            (n,) = _REC.unpack(head)
            yield PointCloud2Msg.deserialize(f.read(n))


def replay(path: str, publisher) -> int:
    """Publish every recorded scan on ``publisher``; returns count."""
    n = 0
    for msg in read_scans(path):
        publisher.publish(msg)
        n += 1
    return n
