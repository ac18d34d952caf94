"""Host-side message schema (L6 wire API of SURVEY.md §1).

A copy of ``pointcloud_obstacle_processing_tpu/runtime/msgs.py`` (plain Python
and NumPy; the port keeps its own).

The reference's wire types are ROS messages: ``sensor_msgs/PointCloud2`` in
(obstacle_detection.cpp:80, :1001), ``nav_msgs/OccupancyGrid`` out
(:838-852), and the generated ``PointWithRad`` / ``PointIndicesArray``
(msg/PointWithRad.msg:1-4, msg/PointIndicesArray.msg:1).  These dataclasses
carry the same information for the in-process bus, with flat binary
(de)serialization so recorded streams can be replayed (the "recorded-bag
harness" the reference never had, SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Sequence

import numpy as np

__all__ = [
    "Header",
    "PointField",
    "PointCloud2Msg",
    "OccupancyGridMsg",
    "PointWithRadMsg",
    "PointIndicesArrayMsg",
    "TransformStampedMsg",
]

_MAGIC = b"PCPT"


@dataclasses.dataclass
class Header:
    frame_id: str = "world"
    stamp: float = 0.0
    seq: int = 0

    @classmethod
    def now(cls, frame_id: str = "world", seq: int = 0) -> "Header":
        return cls(frame_id=frame_id, stamp=time.time(), seq=seq)


# sensor_msgs/PointField datatype codes
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)


@dataclasses.dataclass
class PointField:
    """sensor_msgs/PointField: one channel of a PointCloud2 record."""

    name: str
    offset: int
    datatype: int = FLOAT32
    count: int = 1


@dataclasses.dataclass
class PointCloud2Msg:
    """sensor_msgs/PointCloud2 equivalent — the full wire surface.

    Carries everything the ROS message does (obstacle_detection.cpp:682-689
    consumes it via pcl conversions; the input is an organized 960x540 qhd
    cloud, cpp:80): ``height`` x ``width`` records, a ``fields`` schema
    naming each channel's offset/type, ``row_step`` (>= width*point_step;
    row padding allowed), ``is_bigendian`` and ``is_dense``.  The xyz
    offsets are derived from the fields schema when one is given, so
    arbitrary field layouts (rgb, intensity, padding...) decode correctly.

    Constructor defaults keep the simple unorganized form working:
    height=1, width=n_points, row_step=width*point_step, fields=x/y/z
    float32 at (off_x, off_y, off_z).
    """

    header: Header
    n_points: int
    point_step: int
    data: bytes
    off_x: int = 0
    off_y: int = 4
    off_z: int = 8
    height: int = 0  # 0 => unorganized (1 row)
    width: int = 0  # 0 => n_points
    row_step: int = 0  # 0 => width * point_step
    is_bigendian: bool = False
    is_dense: bool = False
    fields: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.height <= 0 or self.width <= 0:
            self.height, self.width = 1, self.n_points
        if self.row_step <= 0:
            self.row_step = self.width * self.point_step
        if not self.fields:
            self.fields = [
                PointField("x", self.off_x),
                PointField("y", self.off_y),
                PointField("z", self.off_z),
            ]
        else:
            by_name = {f.name: f for f in self.fields}
            for name, attr in (("x", "off_x"), ("y", "off_y"), ("z", "off_z")):
                f = by_name.get(name)
                if f is None:
                    raise ValueError(f"PointCloud2 fields schema lacks '{name}'")
                if f.datatype != FLOAT32:
                    raise ValueError(
                        f"field '{name}' must be FLOAT32 (datatype 7), got "
                        f"{f.datatype} — non-f32 coordinates are not supported"
                    )
                setattr(self, attr, f.offset)

    @classmethod
    def from_xyz(cls, xyz: np.ndarray, frame_id: str = "kinect2_link",
                 point_step: int = 16, seq: int = 0) -> "PointCloud2Msg":
        """Pack an [n,3] array the way kinect2_bridge does (16-byte step:
        x,y,z float32 + 4 bytes padding)."""
        xyz = np.asarray(xyz, np.float32)
        rec = np.zeros((len(xyz), point_step), np.uint8)
        rec[:, 0:12] = xyz.view(np.uint8).reshape(len(xyz), 12)
        return cls(
            header=Header.now(frame_id, seq),
            n_points=len(xyz),
            point_step=point_step,
            data=rec.tobytes(),
        )

    @classmethod
    def from_organized(
        cls, xyz_image: np.ndarray, frame_id: str = "kinect2_link",
        seq: int = 0, point_step: int | None = None,
        fields: list | None = None, row_pad: int = 0,
        extra_channels: dict | None = None,
    ) -> "PointCloud2Msg":
        """Pack an [H, W, 3] image-form cloud as an organized PointCloud2.

        ``extra_channels``: optional {name: [H, W] float32} channels appended
        after xyz (e.g. intensity), producing a non-16-byte record and a
        fields schema the decoder must honor.  ``row_pad``: extra bytes of
        padding per row (row_step = W*point_step + row_pad).
        """
        xyz_image = np.asarray(xyz_image, np.float32)
        h, w, _ = xyz_image.shape
        extra = list((extra_channels or {}).items())
        if fields is None:
            fields = [PointField("x", 0), PointField("y", 4), PointField("z", 8)]
            off = 12
            for name, _ in extra:
                fields.append(PointField(name, off))
                off += 4
            point_step = point_step or off
        else:
            point_step = point_step or (
                max(f.offset for f in fields) + 4
            )
        rec = np.zeros((h, w, point_step), np.uint8)
        by_name = {f.name: f for f in fields}
        for name, values in [("x", xyz_image[..., 0]), ("y", xyz_image[..., 1]),
                             ("z", xyz_image[..., 2])] + [
            (n, np.asarray(v, np.float32)) for n, v in extra
        ]:
            o = by_name[name].offset
            rec[:, :, o : o + 4] = (
                np.ascontiguousarray(values, np.float32)
                .view(np.uint8)
                .reshape(h, w, 4)
            )
        row_step = w * point_step + row_pad
        rows = np.zeros((h, row_step), np.uint8)
        rows[:, : w * point_step] = rec.reshape(h, w * point_step)
        return cls(
            header=Header.now(frame_id, seq),
            n_points=h * w,
            point_step=point_step,
            data=rows.tobytes(),
            height=h,
            width=w,
            row_step=row_step,
            is_dense=bool(np.isfinite(xyz_image).all()),
            fields=fields,
        )

    def xyz(self) -> np.ndarray:
        """Decode to packed finite [n,3] float32 (native fast path)."""
        if self.is_bigendian:
            raise ValueError("big-endian PointCloud2 payloads are not supported")
        from ..native import decode_cloud2_organized

        return decode_cloud2_organized(
            self.data, self.height, self.width, self.row_step,
            self.point_step, self.off_x, self.off_y, self.off_z,
        )

    def serialize(self) -> bytes:
        fid = self.header.frame_id.encode()
        head = struct.pack(
            "<4sBdqiHiiiiiiqBBH",
            _MAGIC, 2, self.header.stamp, self.header.seq, self.n_points,
            len(fid), self.point_step, self.off_x, self.off_y, self.off_z,
            self.height, self.width, self.row_step,
            int(self.is_bigendian), int(self.is_dense), len(self.fields),
        )
        fblob = b""
        for f in self.fields:
            nm = f.name.encode()
            fblob += struct.pack("<HiiI", len(nm), f.offset, f.datatype, f.count)
            fblob += nm
        return head + fblob + fid + self.data

    @classmethod
    def deserialize(cls, buf: bytes) -> "PointCloud2Msg":
        magic, ver = struct.unpack("<4sB", buf[:5])
        if magic != _MAGIC:
            raise ValueError("bad magic")
        if ver == 1:  # round-1 recordings: unorganized, fixed x/y/z schema
            fmt = "<4sBdqiHiiii"
            size = struct.calcsize(fmt)
            _, _, stamp, seq, n, fl, step, ox, oy, oz = struct.unpack(
                fmt, buf[:size]
            )
            fid = buf[size : size + fl].decode()
            return cls(
                header=Header(frame_id=fid, stamp=stamp, seq=seq),
                n_points=n, point_step=step, data=buf[size + fl :],
                off_x=ox, off_y=oy, off_z=oz,
            )
        if ver != 2:
            raise ValueError(f"unknown PointCloud2 serialization version {ver}")
        fmt = "<4sBdqiHiiiiiiqBBH"
        size = struct.calcsize(fmt)
        (_, _, stamp, seq, n, fl, step, ox, oy, oz, h, w, row_step,
         bigend, dense, n_fields) = struct.unpack(fmt, buf[:size])
        pos = size
        fields = []
        for _ in range(n_fields):
            nl, off, dt, cnt = struct.unpack("<HiiI", buf[pos : pos + 14])
            pos += 14
            fields.append(PointField(buf[pos : pos + nl].decode(), off, dt, cnt))
            pos += nl
        fid = buf[pos : pos + fl].decode()
        pos += fl
        return cls(
            header=Header(frame_id=fid, stamp=stamp, seq=seq),
            n_points=n, point_step=step, data=buf[pos:],
            off_x=ox, off_y=oy, off_z=oz,
            height=h, width=w, row_step=row_step,
            is_bigendian=bool(bigend), is_dense=bool(dense), fields=fields,
        )


@dataclasses.dataclass
class OccupancyGridMsg:
    """nav_msgs/OccupancyGrid payload (obstacle_detection.cpp:838-852)."""

    header: Header
    resolution: float
    width: int
    height: int
    data: np.ndarray  # [height*width] int8, row-major
    origin_position: tuple = (0.0, 0.0, 0.0)
    origin_orientation_xyzw: tuple = (0.0, 0.0, 0.707, 0.707)

    def serialize(self) -> bytes:
        fid = self.header.frame_id.encode()
        head = struct.pack(
            "<4sBdqHfii3d4d",
            b"PCOG", 1, self.header.stamp, self.header.seq, len(fid),
            self.resolution, self.width, self.height,
            *self.origin_position, *self.origin_orientation_xyzw,
        )
        return head + fid + np.asarray(self.data, np.int8).tobytes()

    @classmethod
    def deserialize(cls, buf: bytes) -> "OccupancyGridMsg":
        fmt = "<4sBdqHfii3d4d"
        size = struct.calcsize(fmt)
        vals = struct.unpack(fmt, buf[:size])
        magic, ver, stamp, seq, fl, res, w, h = vals[:8]
        pos = tuple(vals[8:11])
        quat = tuple(vals[11:15])
        if magic != b"PCOG":
            raise ValueError("bad magic")
        fid = buf[size : size + fl].decode()
        data = np.frombuffer(buf[size + fl :], np.int8)[: h * w]
        return cls(
            header=Header(frame_id=fid, stamp=stamp, seq=seq),
            resolution=res, width=w, height=h, data=data,
            origin_position=pos, origin_orientation_xyzw=quat,
        )


@dataclasses.dataclass
class PointWithRadMsg:
    """msg/PointWithRad.msg: float32 x, y, z, r."""

    x: float
    y: float
    z: float
    r: float


@dataclasses.dataclass
class PointIndicesArrayMsg:
    """msg/PointIndicesArray.msg: PointWithRad[] points."""

    header: Header
    points: Sequence[PointWithRadMsg]

    @classmethod
    def from_array(cls, xyzr: np.ndarray, valid: np.ndarray, seq: int = 0):
        pts = [PointWithRadMsg(*row) for row in np.asarray(xyzr)[np.asarray(valid)]]
        return cls(header=Header.now("world", seq), points=pts)

    def serialize(self) -> bytes:
        fid = self.header.frame_id.encode()
        head = struct.pack(
            "<4sBdqHI", b"PCIA", 1, self.header.stamp, self.header.seq,
            len(fid), len(self.points),
        )
        rows = np.array(
            [[p.x, p.y, p.z, p.r] for p in self.points], np.float32
        ).reshape(len(self.points), 4)
        return head + fid + rows.tobytes()

    @classmethod
    def deserialize(cls, buf: bytes) -> "PointIndicesArrayMsg":
        fmt = "<4sBdqHI"
        size = struct.calcsize(fmt)
        magic, ver, stamp, seq, fl, n = struct.unpack(fmt, buf[:size])
        if magic != b"PCIA":
            raise ValueError("bad magic")
        fid = buf[size : size + fl].decode()
        rows = np.frombuffer(buf[size + fl :], np.float32).reshape(-1, 4)[:n]
        return cls(
            header=Header(frame_id=fid, stamp=stamp, seq=seq),
            points=[PointWithRadMsg(*map(float, r)) for r in rows],
        )


@dataclasses.dataclass
class TransformStampedMsg:
    """geometry_msgs/TransformStamped equivalent for the tf bus.

    Carries a versioned wire codec so stamped transforms can cross the TCP
    bridge like every other message type — the reference's tf2 listener is
    itself a TCPROS subscriber (obstacle_detection.cpp:124-125, :938), so a
    remote process supplying the sensor pose is part of the reference's
    transport surface.  Whether an edge is static
    is a property of the TOPIC it arrives on (tf2's /tf vs /tf_static
    split), not of the message — see runtime/tf.py's listener.
    """

    header: Header
    child_frame_id: str
    translation: tuple  # (x, y, z)
    rotation_xyzw: tuple  # quaternion

    _FMT = "<4sBdqHH3d4d"

    def serialize(self) -> bytes:
        fid = self.header.frame_id.encode()
        cid = self.child_frame_id.encode()
        head = struct.pack(
            self._FMT, b"PCTF", 1, self.header.stamp, self.header.seq,
            len(fid), len(cid), *self.translation, *self.rotation_xyzw,
        )
        return head + fid + cid

    @classmethod
    def deserialize(cls, buf: bytes) -> "TransformStampedMsg":
        size = struct.calcsize(cls._FMT)
        vals = struct.unpack(cls._FMT, buf[:size])
        magic, ver, stamp, seq, fl, cl = vals[:6]
        if magic != b"PCTF":
            raise ValueError("bad magic")
        if ver != 1:
            raise ValueError(f"unknown TransformStamped serialization version {ver}")
        trans = tuple(vals[6:9])
        quat = tuple(vals[9:13])
        fid = buf[size : size + fl].decode()
        cid = buf[size + fl : size + fl + cl].decode()
        return cls(
            header=Header(frame_id=fid, stamp=stamp, seq=seq),
            child_frame_id=cid,
            translation=trans,
            rotation_xyzw=quat,
        )
