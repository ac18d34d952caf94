"""Builds and loads the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, never at import, into ``_build/`` beside this file
(listed in ``.gitignore``); the library's name carries a hash of the sources,
the headers they include (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and a current one is reused.

``-fmad=false`` keeps every ``a*b + c`` as a rounded multiply then a rounded
add, the fixed float32 expression trees the reference's kernels are written
to; the kernels' results then do not depend on what the compiler fuses.
Where the reference's chain is fused (XLA:CPU contracts it), a kernel
writes ``__fmaf_rn`` out, which the flag leaves alone.

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
# (a kernel's mode or form that a path must be seen to take counts apart:
# K1's counts mode, K3-K5 over a row range of the query rows)
LAUNCHES = {"runreduce": 0, "runreduce_counts": 0, "compact_gather": 0, "knn_mean": 0,
            "knn_mean_rows": 0, "cluster_loop": 0, "cluster_grid_loop": 0, "cluster_sweep": 0,
            "cluster_sweep_rows": 0, "cluster_sweep_banded": 0, "cluster_sweep_banded_rows": 0,
            "segscan": 0, "binned_sum": 0, "xla_sum": 0, "covariance_tail": 0, "segment_fold": 0}

_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# C entry points: argument types in order (all return cudaError_t as int)
_SIGNATURES = {
    # skey, pay_a, pay_b, pay_c, counts (or null), packed, quantum, batch, n,
    # w, sentinel, capacity, workspace, out, num, stream
    "pcp_runreduce": [_VP, _VP, _VP, _VP, _VP, _I, _F, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP],
    # bins, occ, batch, c, k, capacity, loc, vals, scratch (num, block
    # counts), stream
    "pcp_compact_gather": [_VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP],
    # px, py, pz, psq, valid, starts, batch, n, first tile, tiles, row_tile,
    # width, k, big, half, out, stream
    "pcp_knn_mean": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _F,
                     _F, _VP, _VP],
    # pts (packed [B, C, 4]), valid, labels, batch, c, tol2, max_iters,
    # blocks a scan, labels out, unconverged, sweeps, stream
    "pcp_cluster_loop": [_VP, _VP, _VP, _I, _I, _F, _I, _I, _VP, _VP, _VP, _VP],
    # pts (packed [B, C, 4]), valid, labels, batch, c, tol2, max_iters,
    # labels out, unconverged, sweeps, scratch, stream
    "pcp_cluster_grid_loop": [_VP, _VP, _VP, _I, _I, _F, _I, _VP, _VP, _VP, _VP, _VP],
    # c, nb -> blocks of the loop kernel's cluster (nb 0: the one-scan
    # choice; 0: none fits)
    "pcp_cluster_loop_blocks": [_I, _I],
    # px, py, pz, psq, valid, labels, c, first row, rows, tol2, out, stream
    "pcp_cluster_sweep": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP, _VP],
    # pts (packed [C, 4]), valid, labels, starts, tile_live, c, first tile,
    # tiles, window, tol2, out, stream
    "pcp_cluster_sweep_banded": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP, _VP],
    # values, heads, c, n, out, scratch, flags ([2, n] bytes), ints (tile
    # flags, -0.0 bits), stream
    "pcp_segscan": [_VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP],
    # n -> steps past the local kernel's reach
    "pcp_segscan_global_steps": [_I],
    # ids, weights, valid, n, c, k, exact, out (zeroed by the call), stream
    "pcp_binned_sum": [_VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP],
    # the arguments packed as csrc/xla_sum.cu's SumArgs (ops._SUM_ARGS)
    "pcp_xla_sum": [ctypes.c_char_p],
    # the tile (rows of a, rows of b; 0: one operand), covariance_tail ->
    # the largest cluster the card schedules
    "pcp_xla_sum_max_blocks": [_I, _I, _I],
    # the arguments packed as SumArgs, covariance_tail's operands included
    "pcp_covariance_tail": [ctypes.c_char_p],
    # dest, vals, order (or null), scans, n, c, bins, width, vals' strides
    # (scan, channel, row), bf16 terms, out (every element written), stream
    "pcp_segment_fold": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _LL, _LL, _LL, _I, _VP, _VP],
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
    for s in sources + sorted(_SRC.glob("*.cuh")):
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
    """The current device's current CUDA stream as a ``cudaStream_t``
    handle, the value of ``torch.cuda.current_stream().cuda_stream``,
    without building a ``torch.cuda.Stream`` (the call PyTorch's generated
    kernels use to find their stream; a card test holds the two equal)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


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
    with the dtype ``dtypes[i]`` where one is given.  (``get_device`` and
    ``is_cuda`` build no ``torch.device``: this runs on every launch.)"""
    index = tensors[0].get_device()
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: every operand must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand {i} must be contiguous")
        if dtypes is not None and dtypes[i] is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: operand {i} must be {dtypes[i]}, got {t.dtype}")
