#!/usr/bin/env python3
"""Every float32 of the shadow's two trigonometric steps against the C
library: ``ops.libm.asin_like_xla`` over [-1, 1] and ``ops.libm.tanf`` over
[-pi/2, pi/2] rounded up, each against a small C harness built with the
host compiler that calls the C library's ``atan2f`` and ``tanf`` under the
floating-point mode XLA:CPU runs in (flush-to-zero and denormals-are-zero
set in MXCSR), with XLA:CPU's lowering of ``arcsin`` around ``atan2f``.

    python3 scripts/torch_libm_exhaustive.py            # both, every float32
    python3 scripts/torch_libm_exhaustive.py --routine tanf --stride 97

It prints the count of results whose bits differ for each routine (a NaN
counts as equal to a NaN) and exits 1 if any does.  The CPU only; about
8 minutes for both on 8 cores, in chunks of ``2^--chunk-bits`` values.
Not part of the tests: ``tests/test_torch_shadow_trig.py`` holds seeded
samples and the edge sets against the jitted JAX functions.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

HARNESS = r"""
#include <math.h>
#include <stdint.h>
#include <xmmintrin.h>

/* XLA:CPU's mode: flush-to-zero (bit 15) and denormals-are-zero (bit 6) */
static unsigned xla_mode(void) {
  unsigned old = _mm_getcsr();
  _mm_setcsr(old | 0x8040u);
  return old;
}

void asin_like_xla(const float* x, float* out, int64_t n) {
  unsigned old = xla_mode();
  for (int64_t i = 0; i < n; ++i) {
    float v = x[i];
    out[i] = 2.0f * atan2f(v, 1.0f + sqrtf((1.0f - v) * (1.0f + v)));
  }
  _mm_setcsr(old);
}

void tan_f(const float* x, float* out, int64_t n) {
  unsigned old = xla_mode();
  for (int64_t i = 0; i < n; ++i) out[i] = tanf(x[i]);
  _mm_setcsr(old);
}
"""


def build_harness(workdir: Path) -> ctypes.CDLL:
    """Compile the harness (no contraction, no builtins: the library's own
    ``atan2f`` and ``tanf`` are called) and load it."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise SystemExit("torch_libm_exhaustive: needs a C compiler (cc or gcc)")
    src, lib = workdir / "harness.c", workdir / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cc, "-O2", "-ffp-contract=off", "-fno-builtin", "-shared", "-fPIC", "-o",
                    str(lib), str(src), "-lm"], check=True)
    out = ctypes.CDLL(str(lib))
    for name in ("asin_like_xla", "tan_f"):
        getattr(out, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    return out


def domain_bits(top: np.float32, stride: int) -> np.ndarray:
    """Bit patterns of every ``stride``-th float32 of [0, top] and of its
    negatives (-0.0 included), as uint32."""
    pos = np.arange(0, int(np.float32(top).view(np.uint32)) + 1, stride, dtype=np.uint32)
    return np.concatenate([pos, pos | np.uint32(0x80000000)])


def run(routine: str, lib: ctypes.CDLL, stride: int, chunk: int) -> int:
    import torch

    from pointcloud_obstacle_processing_tpu_torch.ops import libm

    top = np.float32(1.0) if routine == "asin_like_xla" else \
        np.nextafter(np.float32(np.pi / 2), np.float32(4))
    bits = domain_bits(top, stride)
    c_fn = getattr(lib, "asin_like_xla" if routine == "asin_like_xla" else "tan_f")
    py_fn = getattr(libm, routine)
    apart, t0 = 0, time.perf_counter()
    for i, start in enumerate(range(0, len(bits), chunk)):
        x = bits[start:start + chunk].view(np.float32)
        want = np.empty_like(x)
        c_fn(x.ctypes.data, want.ctypes.data, x.size)
        got = py_fn(torch.from_numpy(x)).numpy()
        differ = got.view(np.uint32) != want.view(np.uint32)
        differ &= ~(np.isnan(got) & np.isnan(want))
        apart += int(differ.sum())
        if differ.any():
            j = int(np.argmax(differ))
            print(f"  {routine}({x[j]!r}, bits {x.view(np.uint32)[j]:#010x}): "
                  f"{got[j]!r} against {want[j]!r}")
        if i % 16 == 15:
            print(f"  {routine}: {start + x.size:,} of {len(bits):,} values, {apart} apart, "
                  f"{time.perf_counter() - t0:.0f} s", flush=True)
    print(f"{routine}: {apart} of {len(bits):,} float32 results differ from the C library's "
          f"(every {stride}th value of [-{top!r}, {top!r}]; {time.perf_counter() - t0:.0f} s)")
    return apart


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routine", choices=("asin_like_xla", "tanf", "both"), default="both")
    ap.add_argument("--stride", type=int, default=1, help="every stride-th float32")
    ap.add_argument("--chunk-bits", type=int, default=22, help="log2 of the values a chunk")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    routines = ("asin_like_xla", "tanf") if args.routine == "both" else (args.routine,)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_harness(Path(tmp))
        apart = sum(run(r, lib, args.stride, 1 << args.chunk_bits) for r in routines)
    sys.exit(1 if apart else 0)


if __name__ == "__main__":
    main()
