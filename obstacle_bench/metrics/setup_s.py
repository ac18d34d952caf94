"""Process start to the first timed request: torch and the CUDA context,
the kernel library (built on a checkout's first run), the pool, the
warm-up."""


def read(run):
    return run.setup_s
