"""The benchmark's plain reference: a frozen copy of the port's plain path.

Copied from ``pointcloud_obstacle_processing_tpu_torch`` (``pipeline.py``,
``config.py``, ``types.py`` and the ``ops`` modules the pipeline imports):
only the plain PyTorch functions that ``process_scan`` reaches for some
configuration, on one device.  The kernel wrappers, their launch plans and
scratch caches, and the point-sharded paths are left out; each wrapper that
the pipeline calls takes its plain version.  The arithmetic replays
XLA:CPU's, which the port's CPU tests hold bitwise against the JAX package.
It imports neither JAX nor the port, and
``obstacle_bench/test_obstacle_bench_copies.py`` holds it equal to the
port's current CPU output.
"""
