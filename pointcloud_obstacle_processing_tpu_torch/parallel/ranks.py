"""Groups of ranks spawned on one host, and the sharded runs they make.

``spawn(fn, world, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (the spawn start method), joins them in one
``torch.distributed`` world over a ``FileStore`` (gloo, or NCCL where every
rank has a card of its own), calls ``fn(rank, world, *args)`` in each and
returns each rank's value.  The process group and the join both have a
timeout: a rank that hangs fails the call instead of the caller.  Ranks
run one CPU thread each.  Nothing here imports JAX: the ranks import this
package alone.

``run_jobs`` is the ``fn`` of the CPU tests and of ``chip_smoke.py``'s
sharded phase: a list of runs (``dp_sp``, ``data_parallel``, ``merge``),
each on a mesh of the first ranks of the world, the others waiting.  A
job's result holds the rank's output moved to the CPU, its host wall time
a window, the kernels' launches in its first window (counted from 0), and
what its mesh's collectives moved.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import _build
from ..config import PipelineConfig
from ..ops.ransac import draw_from_bits, draw_from_uniform
from ..types import Cloud
from .collectives import DEFAULT_TIMEOUT_S, make_mesh

__all__ = ["spawn", "run_jobs", "to_cpu", "foreign_modules"]


def _entry(rank: int, fn, world: int, store_path: str, out_dir: str, backend: str,
           timeout_s: float, threads: int) -> None:
    torch.set_num_threads(threads)
    args = torch.load(Path(out_dir, "args.pt"), weights_only=False)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, Path(out_dir, f"rank{rank}.pt"))
        # a rank that ends early must not close its connections while a
        # peer is still making them (gloo: "connection closed by peer")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S,
          tmp_dir: str | None = None, threads: int = 1) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of ``threads``
    CPU threads each; each rank's return value (saved with ``torch.save``),
    in rank order.  ``fn`` must be importable (a module-level function).
    Raises if a rank raised, or when the ranks have not all ended within
    ``timeout_s`` (they are then killed)."""
    with tempfile.TemporaryDirectory(dir=tmp_dir) as d:
        # the arguments go through a file: a start blocks until its child has
        # read what it was handed, which it does only after importing torch
        torch.save(args, Path(d, "args.pt"))
        ctx = mp.start_processes(
            _entry, args=(fn, world, os.path.join(d, "store"), d, backend, timeout_s, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks not done after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(Path(d, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def foreign_modules(rank: int, world: int) -> list[str]:
    """The modules of JAX or of the JAX package loaded in this rank (none:
    the ranks import this package alone, whatever their parent holds)."""
    roots = ("jax", "jaxlib", "flax", "pointcloud_obstacle_processing_tpu")
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


def to_cpu(obj):
    """``obj`` with every tensor in it (dataclasses, tuples, dicts) on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return type(obj)(**{k: to_cpu(getattr(obj, k)) for k in obj.__dataclass_fields__})
    return obj


def _draw(spec, device) -> dict:
    """The draw keywords from a picklable spec: ("uniform", u), ("bits",
    hi, lo), or ("generator", seed), a generator seeded ``seed + rank``
    (the pipeline makes the draws on the first rank and broadcasts them)."""
    kind, *args = spec
    if kind == "generator":
        return {"generator": torch.Generator(device=device).manual_seed(args[0] + dist.get_rank())}
    arrays = [torch.as_tensor(np.asarray(a)).to(device) for a in args]
    return {"draw": draw_from_uniform(*arrays) if kind == "uniform" else draw_from_bits(*arrays)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _capture(targets: list[tuple], call) -> dict:
    """Run ``call()`` with each ``(module, name)`` wrapped to record its
    calls' arguments (moved to the CPU): {"module.name": [(args, kwargs),
    ...]}."""
    seen = {f"{m.__name__}.{n}": [] for m, n in targets}
    saved = [(m, n, getattr(m, n)) for m, n in targets]
    for m, n, fn in saved:
        def wrapped(*a, _fn=fn, _key=f"{m.__name__}.{n}", **kw):
            seen[_key].append((to_cpu(a), to_cpu(kw)))
            return _fn(*a, **kw)
        setattr(m, n, wrapped)
    try:
        call()
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    return seen


def _job_run(job: dict, mesh, device):
    """The callable that runs one job on this rank."""
    from .sharding import (
        _distributed_merge,
        data_parallel_pipeline,
        dp_sp_pipeline,
    )
    from ..ops.voxel import _pack_keys, _pack_spec, merge_voxel_partials_packed, voxel_partials

    cfg: PipelineConfig = job["config"]
    pts = torch.as_tensor(np.asarray(job["points"])).to(device)
    valid = torch.as_tensor(np.asarray(job["valid"])).to(device)
    clouds = Cloud(points=pts, valid=valid)
    kind = job["kind"]
    if kind == "merge":  # one scan's voxel tables merged both ways
        axis = mesh["points"]
        n = valid.shape[-1] // axis.size
        sl = slice(axis.rank * n, (axis.rank + 1) * n)
        bounds = ((cfg.x_min, cfg.y_min, cfg.z_min), (cfg.x_max, cfg.y_max, cfg.z_max))
        spec = _pack_spec(bounds, cfg.downsample_leaf_size)

        def run():
            parts = voxel_partials(Cloud(points=pts[None, sl], valid=valid[None, sl]),
                                   cfg.downsample_leaf_size, cfg.max_voxels, bounds,
                                   cfg.voxel_payload_packing)
            dist_m = _distributed_merge(parts, cfg, axis, spec)
            rep = merge_voxel_partials_packed(
                axis.all_gather(_pack_keys(parts.keys, parts.counts, spec), dim=-1),
                axis.all_gather(parts.sums, dim=-2), axis.all_gather(parts.counts, dim=-1),
                cfg.max_voxels, spec, cfg.downsample_leaf_size, tables=axis.size)
            return {"distributed": dist_m, "replicated": rep}

        return run
    draw = _draw(job["draw"], device)
    if kind == "dp_sp":
        fn = dp_sp_pipeline(cfg, mesh, **job.get("options", {}))
    elif kind == "data_parallel":
        fn = data_parallel_pipeline(cfg, mesh)
    else:
        raise ValueError(f"unknown job kind {kind!r}")
    return lambda: fn(clouds, **draw)


def run_jobs(rank: int, world: int, jobs: list[dict]) -> list:
    """Each job on a mesh of the world's first ranks (``job["mesh"]``, axis
    sizes); the other ranks make the same process groups and wait.
    ``job["warmup"]`` (default 0) and then ``job["windows"]`` (default 1)
    runs, after a barrier each; the output is the first run's.  Returns, a
    job, None off the mesh, else a dict: ``out`` (on the CPU), ``seconds``
    (host wall time a run after the warm-up), ``launches`` (the kernels'
    launches in the first run), ``collectives`` (bytes, calls, host reads
    a run, from the first), ``backend``, ``staging``,
    ``host_syncs`` (the output's count, if it has one) and, with
    ``job["capture"]`` (a list of (module path, name)), on rank 0 the
    arguments of each call of those functions in one more run, untimed
    (every rank runs it: the collectives need them all)."""
    import importlib

    results = []
    for job in jobs:
        device = torch.device(job.get("device", "cpu"))
        sizes = job["mesh"]
        members = list(range(int(np.prod(list(sizes.values())))))
        mesh = make_mesh(sizes, ranks=members)
        # the mesh's ranks as one group (new_group is collective: every rank)
        sub = dist.new_group(members) if len(members) < world else None
        if mesh is None:
            dist.barrier()
            results.append(None)
            continue
        run = _job_run(job, mesh, device)
        seconds, out, launches, moved, captured = [], None, None, None, {}
        warmup = job.get("warmup", 0)
        for w in range(warmup + job.get("windows", 1)):
            if len(members) > 1:
                dist.barrier(group=sub)
            _build.reset_launch_counts()
            mesh.reset_counts()
            _sync(device)
            t = time.perf_counter()
            res = run()
            _sync(device)
            if w >= warmup:
                seconds.append(time.perf_counter() - t)
            if w == 0:
                out, launches, moved = to_cpu(res), dict(_build.LAUNCHES), mesh.counts()
        if job.get("capture") and rank == 0:
            targets = [(importlib.import_module(m), n) for m, n in job["capture"]]
            captured = _capture(targets, run)
        elif job.get("capture"):
            run()
        axis = max(mesh.axes.values(), key=lambda a: a.size)  # the one that moves data
        results.append({
            "out": out, "seconds": seconds, "launches": launches, "collectives": moved,
            "backend": axis.backend, "staging": axis.staging, "captured": captured,
            "host_syncs": getattr(out, "host_syncs", None),
        })
        dist.barrier()
    return results
