"""The benchmark of the port ``pointcloud_obstacle_processing_tpu_torch``.

    python3 obstacle_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process is started
on and prints one JSON result as its last line (``harness.py`` says what a
run does).  It exits non-zero and prints no result where there is no card,
too few cards, or JAX or the JAX package loaded.
"""

import time

_T0 = time.perf_counter()  # setup_s runs from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from obstacle_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], _T0))
