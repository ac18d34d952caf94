"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import, into ``_build/`` beside this file
(listed in ``.gitignore``); the library's name carries a hash of the sources
and flags, so an edited source is rebuilt and a current one is reused.

``-fmad=false`` keeps every ``a*b + c`` as a rounded multiply then a rounded
add, the fixed float32 expression trees the reference's kernels are written
to; the kernels' results then do not depend on what the compiler fuses.

Each kernel wrapper counts its launches in ``LAUNCHES``: one per call that
launched the kernel, none for calls that took the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "kernels", "check", "stream_handle", "require_cuda",
           "resolve_device"]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset
LAUNCHES = {"runreduce": 0, "compact_gather": 0, "knn_select": 0, "cluster_sweep": 0,
            "cluster_sweep_banded": 0}

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points: argument types in order (all return cudaError_t as int)
_SIGNATURES = {
    # skey, pay_a, pay_b, pay_c, packed, quantum, n, w, sentinel, excl,
    # capacity, local, lastcol, first_head, carry, out, stream
    "pcp_runreduce": [_VP, _VP, _VP, _VP, _I, _F, _I, _I, _I, _VP,
                      _I, _VP, _VP, _VP, _VP, _VP, _VP],
    # bins, occ, excl, c, k, capacity, loc, vals, stream
    "pcp_compact_gather": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP],
    # px, py, pz, psq, valid, starts, tile_live, n, n_q, row_tile, width,
    # big, out, stream
    "pcp_knn_select": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                       _F, _VP, _VP],
    # px, py, pz, psq, valid, labels, c, tol2, out, stream
    "pcp_cluster_sweep": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _F, _VP, _VP],
    # px, py, pz, psq, valid, labels, starts, tile_live, c, window, tol2,
    # out, stream
    "pcp_cluster_sweep_banded": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _F,
                                 _VP, _VP],
}

BUILD_SECONDS: list[float] = []  # wall time of each build this process ran


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.cache
def kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    sources = sorted(_SRC.glob("*.cu"))
    digest = hashlib.sha256()
    for s in sources:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = _OUT / f"libpcp_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        _OUT.mkdir(exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        objs = [_OUT / f"{s.stem}.{os.getpid()}.o" for s in sources]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)])
                 for s, o in zip(sources, objs)]
        failed = [str(s) for s, p in zip(sources, procs) if p.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                       check=True)
        for o in objs:
            o.unlink()
        BUILD_SECONDS.append(time.perf_counter() - t0)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present (the entry points default to the card and never fall back
    to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=None) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one device,
    with the dtype ``dtypes[i]`` where one is given."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} must be contiguous")
        if dtypes is not None and dtypes[i] is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: operand {i} must be {dtypes[i]}, got {t.dtype}")
