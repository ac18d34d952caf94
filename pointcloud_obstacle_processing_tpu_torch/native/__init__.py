"""Native host runtime (C++ via ctypes) with a NumPy fallback.

Counterpart of ``pointcloud_obstacle_processing_tpu/native``, with its own
copy of ``scanio.cpp``: scan decode + transform + accumulation run in C++,
compiled with g++ at first use (never at import) into ``_build/`` of the
package (listed in ``.gitignore``; the library's name carries a hash of
the source and flags, so an edited source is rebuilt).  Where the build
fails (no g++), everything runs on the NumPy fallback; ``backend`` says
which one a ``ScanAccumulator`` took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "scanio.cpp"
_OUT = _HERE.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error: str | None = None


def _so_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _OUT / f"_scanio_{digest}_{sys.implementation.cache_tag}.so"


def _build(so: Path) -> str | None:
    """Compile into a file of this process, then move it into place (so a
    concurrent loader never sees half a library)."""
    _OUT.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:  # missing g++, compile error, ...
        out = getattr(e, "stderr", b"")
        return f"{e}: {out.decode() if isinstance(out, bytes) else out}"
    os.replace(tmp, so)
    return None


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = _so_path()
        if not so.exists():
            _build_error = _build(so)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.accumulator_create.restype = ctypes.c_void_p
        lib.accumulator_create.argtypes = [ctypes.c_int64]
        lib.accumulator_destroy.argtypes = [ctypes.c_void_p]
        lib.accumulator_clear.argtypes = [ctypes.c_void_p]
        lib.accumulator_count.restype = ctypes.c_int64
        lib.accumulator_count.argtypes = [ctypes.c_void_p]
        lib.accumulator_capacity.restype = ctypes.c_int64
        lib.accumulator_capacity.argtypes = [ctypes.c_void_p]
        lib.accumulator_snapshot.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.accumulator_append_cloud2.restype = ctypes.c_int64
        lib.accumulator_append_cloud2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.accumulator_append_xyz.restype = ctypes.c_int64
        lib.accumulator_append_xyz.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.decode_cloud2.restype = ctypes.c_int64
        lib.decode_cloud2.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.decode_cloud2_rows.restype = ctypes.c_int64
        lib.decode_cloud2_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.accumulator_append_cloud2_rows.restype = ctypes.c_int64
        lib.accumulator_append_cloud2_rows.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _check_cloud2_layout(
    data, n_points: int, point_step: int, off_x: int, off_y: int, off_z: int
) -> int:
    """Validate a strided-record layout before it reaches native code.

    The C++ reads ``data + i*point_step + off`` with no bounds check, so a
    truncated or corrupt recorded scan must be rejected/clamped HERE.
    Returns the (possibly clamped-down) safe n_points; raises on layouts
    that can never be safe (bad offsets / step).
    """
    if point_step <= 0:
        raise ValueError(f"point_step must be positive, got {point_step}")
    for name, off in (("off_x", off_x), ("off_y", off_y), ("off_z", off_z)):
        if off < 0 or off + 4 > point_step:
            raise ValueError(
                f"{name}={off} does not fit a float32 in point_step={point_step}"
            )
    if n_points < 0:
        raise ValueError(f"n_points must be >= 0, got {n_points}")
    # clamp (not raise): a truncated stream tail is recoverable — decode the
    # complete records and drop the partial one
    return min(n_points, len(data) // point_step)


def _check_cloud2_rows_layout(
    data, height: int, width: int, row_step: int, point_step: int,
    off_x: int, off_y: int, off_z: int,
) -> None:
    """Organized-layout validation (the native code also bounds-checks every
    record read against the buffer length — this gives clear errors)."""
    if point_step <= 0:
        raise ValueError(f"point_step must be positive, got {point_step}")
    if height < 0 or width < 0:
        raise ValueError(f"height/width must be >= 0, got {height}x{width}")
    if row_step < width * point_step:
        raise ValueError(
            f"row_step={row_step} < width*point_step={width * point_step}"
        )
    for name, off in (("off_x", off_x), ("off_y", off_y), ("off_z", off_z)):
        if off < 0 or off + 4 > point_step:
            raise ValueError(
                f"{name}={off} does not fit a float32 in point_step={point_step}"
            )


def _decode_rows_numpy(
    data, height, width, row_step, point_step, off_x, off_y, off_z
) -> np.ndarray:
    """NumPy fallback for the organized decode: honors row padding and
    truncated tails exactly like the native path."""
    buf = np.frombuffer(data, np.uint8)
    r = np.repeat(np.arange(height, dtype=np.int64), width)
    c = np.tile(np.arange(width, dtype=np.int64), height)
    rec = r * row_step + c * point_step
    rec = rec[rec + point_step <= len(buf)]
    cols = []
    for off in (off_x, off_y, off_z):
        b = buf[rec[:, None] + off + np.arange(4)]
        cols.append(b.copy().view(np.float32)[:, 0])
    xyz = np.stack(cols, axis=1)
    return xyz[np.all(np.isfinite(xyz), axis=1)]


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class ScanAccumulator:
    """Fixed-capacity scan accumulation window.

    Equivalent of the reference's ``passthrough_input_cloud`` global plus the
    per-frame transform+concatenate (obstacle_detection.cpp:78, :691-698):
    frames arrive in the sensor frame, are rigidly transformed to world, and
    appended to a padded [capacity, 3] buffer with a validity mask.
    """

    def __init__(self, capacity: int, force_numpy: bool = False):
        self.capacity = int(capacity)
        self._lib = None if force_numpy else _load()
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.accumulator_create(self.capacity))
        else:
            self._pts = np.zeros((self.capacity, 3), np.float32)
            self._valid = np.zeros(self.capacity, bool)
            self._n = 0

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    def count(self) -> int:
        if self._lib is not None:
            return int(self._lib.accumulator_count(self._h))
        return self._n

    def clear(self) -> None:
        if self._lib is not None:
            self._lib.accumulator_clear(self._h)
        else:
            self._valid[:] = False
            self._n = 0

    def append_xyz(self, xyz: np.ndarray, rotation: np.ndarray, translation: np.ndarray) -> int:
        """Append an [n, 3] float32 frame transformed by (R, t)."""
        xyz = np.ascontiguousarray(xyz, np.float32)
        R = np.ascontiguousarray(rotation, np.float32).reshape(9)
        t = np.ascontiguousarray(translation, np.float32).reshape(3)
        if self._lib is not None:
            return int(
                self._lib.accumulator_append_xyz(
                    self._h, _fptr(xyz), len(xyz), _fptr(R), _fptr(t)
                )
            )
        world = xyz @ R.reshape(3, 3).T + t
        finite = np.all(np.isfinite(world), axis=1)
        world = world[finite]
        take = min(len(world), self.capacity - self._n)
        self._pts[self._n : self._n + take] = world[:take]
        self._valid[self._n : self._n + take] = True
        self._n += take
        return take

    def append_cloud2_organized(
        self, data: bytes, height: int, width: int, row_step: int,
        point_step: int, off_x: int, off_y: int, off_z: int,
        rotation: np.ndarray, translation: np.ndarray, n_threads: int = 0,
    ) -> int:
        """Append a full sensor_msgs/PointCloud2 layout: ``height`` rows of
        ``width`` records, rows ``row_step`` bytes apart (row padding
        allowed), float32 xyz at the given in-record offsets.  The
        reference input is an organized 960x540 qhd cloud
        (obstacle_detection.cpp:80)."""
        _check_cloud2_rows_layout(data, height, width, row_step, point_step,
                                  off_x, off_y, off_z)
        R = np.ascontiguousarray(rotation, np.float32).reshape(9)
        t = np.ascontiguousarray(translation, np.float32).reshape(3)
        if self._lib is not None:
            buf = np.frombuffer(data, np.uint8)
            return int(
                self._lib.accumulator_append_cloud2_rows(
                    self._h, _u8ptr(buf), len(data), height, width, row_step,
                    point_step, off_x, off_y, off_z, _fptr(R), _fptr(t),
                    n_threads,
                )
            )
        xyz = _decode_rows_numpy(
            data, height, width, row_step, point_step, off_x, off_y, off_z
        )
        return self.append_xyz(xyz, rotation, translation)

    def append_cloud2(
        self, data: bytes, n_points: int, point_step: int,
        off_x: int, off_y: int, off_z: int,
        rotation: np.ndarray, translation: np.ndarray, n_threads: int = 0,
    ) -> int:
        """Append a PointCloud2-style binary frame (strided float32 xyz)."""
        n_points = _check_cloud2_layout(data, n_points, point_step, off_x, off_y, off_z)
        R = np.ascontiguousarray(rotation, np.float32).reshape(9)
        t = np.ascontiguousarray(translation, np.float32).reshape(3)
        if self._lib is not None:
            buf = np.frombuffer(data, np.uint8)
            return int(
                self._lib.accumulator_append_cloud2(
                    self._h, _u8ptr(buf), n_points, point_step,
                    off_x, off_y, off_z, _fptr(R), _fptr(t), n_threads,
                )
            )
        rec = np.frombuffer(data, np.uint8)[: n_points * point_step].reshape(
            n_points, point_step
        )
        xyz = np.stack(
            [rec[:, o : o + 4].copy().view(np.float32)[:, 0] for o in (off_x, off_y, off_z)],
            axis=1,
        )
        xyz = xyz[np.all(np.isfinite(xyz), axis=1)]
        return self.append_xyz(xyz, rotation, translation)

    def snapshot(self, out: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """(points [capacity,3] float32, valid [capacity] bool) copies, into
        ``out`` where it is given (two C-contiguous arrays of those shapes
        and types: the node passes its pinned staging buffers, so the window
        is copied once on the host)."""
        if out is None:
            out = (np.empty((self.capacity, 3), np.float32), np.empty(self.capacity, bool))
        pts, valid = out
        if (pts.shape, pts.dtype, valid.shape, valid.dtype) != (
                (self.capacity, 3), np.float32, (self.capacity,), bool) or \
                not (pts.flags.c_contiguous and valid.flags.c_contiguous):
            raise ValueError("snapshot out= needs C-contiguous float32 [capacity, 3] "
                             "and bool [capacity] arrays")
        if self._lib is not None:
            # bool is one byte holding 0 or 1, the accumulator's own mask bytes
            self._lib.accumulator_snapshot(self._h, _fptr(pts), _u8ptr(valid.view(np.uint8)))
        else:
            pts[...] = self._pts
            valid[...] = self._valid
        return pts, valid

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None:
            try:
                lib.accumulator_destroy(self._h)
            except Exception:
                pass


def decode_cloud2_organized(
    data: bytes, height: int, width: int, row_step: int, point_step: int,
    off_x: int, off_y: int, off_z: int,
) -> np.ndarray:
    """Decode a full PointCloud2 layout (row padding allowed) into packed
    finite [n, 3] float32."""
    _check_cloud2_rows_layout(data, height, width, row_step, point_step,
                              off_x, off_y, off_z)
    lib = _load()
    if lib is not None:
        cap = height * width
        out = np.empty((max(cap, 1), 3), np.float32)
        buf = np.frombuffer(data, np.uint8)
        n = int(
            lib.decode_cloud2_rows(
                _u8ptr(buf), len(data), height, width, row_step, point_step,
                off_x, off_y, off_z, _fptr(out), cap,
            )
        )
        return out[:n]
    return _decode_rows_numpy(
        data, height, width, row_step, point_step, off_x, off_y, off_z
    )


def decode_cloud2(data: bytes, n_points: int, point_step: int,
                  off_x: int, off_y: int, off_z: int) -> np.ndarray:
    """Decode a strided binary scan into packed finite [n, 3] float32."""
    n_points = _check_cloud2_layout(data, n_points, point_step, off_x, off_y, off_z)
    lib = _load()
    if lib is not None:
        out = np.empty((n_points, 3), np.float32)
        buf = np.frombuffer(data, np.uint8)
        n = int(
            lib.decode_cloud2(
                _u8ptr(buf), n_points, point_step, off_x, off_y, off_z,
                _fptr(out), n_points,
            )
        )
        return out[:n]
    rec = np.frombuffer(data, np.uint8)[: n_points * point_step].reshape(n_points, point_step)
    xyz = np.stack(
        [rec[:, o : o + 4].copy().view(np.float32)[:, 0] for o in (off_x, off_y, off_z)],
        axis=1,
    )
    return xyz[np.all(np.isfinite(xyz), axis=1)]
