"""One run of one cell: set-up, the measured window, the traced requests,
the comparison with the reference, the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the ``PipelineConfig`` fields as run, with the
source, the cuts and the assumed sizes) and a traffic mix
(``traffic/<name>.json``, read by ``traffic.py``).  A run:

1. makes the traffic's pool of scans from ``--seed`` (pinned host memory),
   builds ``batched_pipeline(config)`` and a device ``torch.Generator``
   seeded from ``--seed`` for the RANSAC draws, and warms up on each block
   of the pool (the first run in a checkout builds the kernels here);
   ``setup_s`` ends here;
2. measures a closed loop for ``--seconds``: a request uploads one block
   of ``batch`` scans, calls the entry, starts the copies of what the node
   publishes (``check.published``) into pinned buffers, and synchronises;
   the next request starts when the last is on the host.  The window ends
   with the first request that completes after ``--seconds``;
3. with ``--trace 1``: the stage spans of ``spans.json`` wrap the
   pipeline's stage entry points for the whole run, and after the window
   ``trace_requests`` more requests run under ``torch.profiler``
   (``trace.py`` reads them);
4. reads the peak device memory, frees the program's state, and compares a
   sample of the window's scans (drawn from ``--seed``: ``check.requests``
   requests, and of each ``check.scans`` scans, one from each of that many
   equal parts of the batch) with the reference (``check.py``);
5. prints what it read on earlier lines and the result as its last line;
   each compared number and its limit go last on standard error too.

The metrics are the cell's in ``BENCHMARK.json`` (end-to-end with
``--trace 0``, per-layer with ``--trace 1``), each computed by its reader
``metrics/<name>.py`` from the ``Run`` below; a reader that finds nothing
to read returns ``None`` and the metric is left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from . import check, faults
from . import trace as trace_reader
from .bounds import stage_bounds
from .traffic import make_pool

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pointcloud_obstacle_processing_tpu"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    metrics: list  # BENCHMARK.json's metric entries this cell reports, both kinds
    spans: list  # spans.json's stage spans


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer") for m in bench[kind]
               if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((bench_path.parent / conf["file"]).read_text()),
                traffic=json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text()),
                metrics=metrics,
                spans=json.loads((BENCH_DIR / "spans.json").read_text())["stages"])


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take their numbers from it."""

    batch: int
    setup_s: float
    window_s: float  # wall time of the measured window
    latencies: list  # seconds, one a window request: upload to outputs on the host
    issues: list  # seconds, one a window request: host time inside the entry call
    host_syncs: list  # PipelineResult.host_syncs, one a window request
    span_host_s: dict  # host seconds inside each stage span over the window (traced runs)
    trace: dict | None = None  # trace.read's numbers (traced runs)
    trace_requests: int = 0
    trace_bounds: dict | None = None  # bounds' seconds by stage over the traced requests
    spans: list = dataclasses.field(default_factory=list)

    @property
    def requests(self) -> int:
        return len(self.latencies)

    def stage_roofline_pct(self, bound: str) -> float | None:
        """The share of its bound that the stage of ``spans.json`` with
        ``bound`` reached: the bound over the device time of every device
        operation launched inside that stage's span, in percent."""
        if not self.trace or not self.trace_bounds:
            return None
        span = next(s["span"] for s in self.spans if s.get("bound") == bound)
        device_s = self.trace["stage_device_s"].get(span, 0.0)
        if device_s <= 0.0:
            return None
        return 100.0 * self.trace_bounds[bound] / device_s


def _reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "obstacle_bench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card_info() -> dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({type(e).__name__})"
    return {"nvidia_smi": out}


def _install_spans(spans: list, acc: dict):
    """Wrap the pipeline's stage entry points in ``record_function`` ranges
    that also add their host seconds to ``acc``; returns the undo."""
    from pointcloud_obstacle_processing_tpu_torch import pipeline

    originals = {}
    for s in spans:
        attr = s["span"]
        f = originals[attr] = getattr(pipeline, attr)

        def wrapped(*a, _f=f, _name=attr, **k):
            t = time.perf_counter()
            with torch.profiler.record_function(_name):
                out = _f(*a, **k)
            acc[_name] += time.perf_counter() - t
            return out

        setattr(pipeline, attr, wrapped)
    return lambda: [setattr(pipeline, a, f) for a, f in originals.items()]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: str, t0: float,
             fault: str | None = None, info=print) -> tuple[dict, dict]:
    """One run; returns ``(result line, checks)``.  ``info`` takes the
    earlier lines' objects."""
    from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
    from pointcloud_obstacle_processing_tpu_torch.parallel.sharding import batched_pipeline
    from pointcloud_obstacle_processing_tpu_torch.types import Cloud

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fields = {f.name: cell.config[f.name] for f in dataclasses.fields(PipelineConfig)}
    cfg = PipelineConfig(**fields)
    traffic = cell.traffic
    B = traffic["batch"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    pool_pts, pool_valid, seeds = make_pool(traffic, cfg.max_points, seed)
    blocks = len(seeds) // B
    pts = torch.from_numpy(pool_pts).view(blocks, B, cfg.max_points, 3)
    valid = torch.from_numpy(pool_valid).view(blocks, B, cfg.max_points)
    if cuda:
        pts, valid = pts.pin_memory(), valid.pin_memory()
    fn = (faults.FAULTS[fault] if fault else (lambda factory, c: factory(c)))(batched_pipeline, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**64)

    span_acc = defaultdict(float)
    undo = _install_spans(cell.spans, span_acc) if traced else None
    bufs = {}
    flag_counts = np.zeros(len(check.STAT_FLAGS), np.int64)

    def request(r: int):
        k = r % blocks
        state = gen.get_state()
        t_start = time.perf_counter()
        clouds = Cloud(points=pts[k].to(dev, non_blocking=True),
                       valid=valid[k].to(dev, non_blocking=True))
        t_call = time.perf_counter()
        res = fn(clouds, generator=gen)
        t_ret = time.perf_counter()
        for name, v in check.published(res).items():
            if name not in bufs:
                bufs[name] = torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
            bufs[name].copy_(v, non_blocking=True)
        sync()
        t_end = time.perf_counter()
        return t_end - t_start, t_ret - t_call, res.host_syncs, k, state

    try:
        for r in range(blocks):  # warm-up: every block of the pool once
            request(r)
        sync()
        setup_s = time.perf_counter() - t0

        # the measured window; a sample of its requests kept for the
        # comparison (reservoir sampling, drawn from the seed)
        keep = traffic["check"]["requests"]
        rng = np.random.default_rng([seed % 2**64, 1])
        samples = []
        latencies, issues, host_syncs = [], [], []
        span_acc.clear()
        r, i = blocks, 0
        ends = []
        w_start = time.perf_counter()
        while True:
            lat, issue, syncs, k, state = request(r)
            latencies.append(lat)
            issues.append(issue)
            host_syncs.append(syncs)
            flag_counts += (bufs["stats"].numpy()[:, len(check.STAT_COUNTS):] != 0).sum(0)
            j = i if i < keep else int(rng.integers(0, i + 1))
            if j < keep:
                kept = (i, k, state, {n: b.numpy().copy() for n, b in bufs.items()})
                if j == len(samples):
                    samples.append(kept)
                else:
                    samples[j] = kept
            r, i = r + 1, i + 1
            ends.append(time.perf_counter() - w_start)
            if ends[-1] >= seconds:
                break
        window_s = time.perf_counter() - w_start
        span_host_s = dict(span_acc)

        run = Run(batch=B, setup_s=setup_s, window_s=window_s, latencies=latencies,
                  issues=issues, host_syncs=host_syncs, span_host_s=span_host_s,
                  spans=cell.spans)
        if traced:
            n = traffic["trace_requests"]
            traced_stats = []
            tmp = tempfile.mkdtemp(prefix="obstacle_bench_trace_")
            try:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1)
                with torch.profiler.profile(activities=acts, schedule=sched) as prof:
                    for step in range(n + 1):
                        request(r)
                        r += 1
                        if step:
                            traced_stats.append(bufs["stats"].numpy().copy())
                        prof.step()
                path = str(Path(tmp) / "trace.json")
                prof.export_chrome_trace(path)
                run.trace = trace_reader.read(path, [s["span"] for s in cell.spans])
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            run.trace_requests = n
            c = check.STAT_COUNTS
            run.trace_bounds = stage_bounds(cfg, (
                (int(s[c.index("accumulated_points")]), int(s[c.index("cropped_points")]),
                 int(s[c.index("voxel_points")]), int(s[c.index("nonplane_points")]))
                for st in traced_stats for s in st))
    finally:
        if undo:
            undo()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    fn = bufs = None
    sync()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison: the sampled requests' scans against the reference
    readings = []
    pick = np.random.default_rng([seed % 2**64, 2])
    shape = (B, cfg.max_planes, cfg.ransac_hypotheses, 3)
    t_ref = time.perf_counter()
    for _, k, state, host in sorted(samples, key=lambda s: s[0]):
        g = torch.Generator(device=dev)
        g.set_state(state)
        uniforms = torch.rand(shape, generator=g, device=dev).cpu().numpy()
        for b in check.scans_to_compare(pick, B, traffic["check"]["scans"]):
            ref = check.reference_scan(fields, pool_pts[k * B + b], pool_valid[k * B + b],
                                       uniforms[b])
            readings.append(check.compare_scan({n: v[b] for n, v in host.items()}, ref))
    reference_s = time.perf_counter() - t_ref
    checks = check.combine(readings)

    info({"cell": cell.name, "seed": seed, "device": str(dev), "torch": torch.__version__,
          **(_card_info() if cuda else {}), "pool_seeds": seeds})
    info({"requests": run.requests, "scans": run.requests * B, "window_s": window_s,
          "setup_s": setup_s, "compared_scans": len(readings), "reference_s": reference_s,
          "latency_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
          "requests_each_second": np.bincount(np.asarray(ends, int)).tolist(),
          "scans_with_flag": dict(zip(check.STAT_FLAGS, flag_counts.tolist()))})
    if run.trace:
        info({"trace": {k: v for k, v in run.trace.items() if k != "op_device_s"},
              "trace_bounds_s": run.trace_bounds})

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        value = _reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": check.passes(checks) and len(readings) > 0,
              "attempted": run.requests * B, "failed": 0, "metrics": metrics, "device": dev_info}
    if run.trace and cuda:
        dev_info["busy_s"] = run.trace["busy_s"]
        dev_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": trace_reader.top(run.trace["op_device_s"]),
                               "idle_gaps": trace_reader.top(run.trace["idle_by_host"])}
    result["checks"] = checks
    return result, checks


def forbidden_modules() -> list:
    """Top-level names of the loaded modules that the benchmark may not
    load, compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="run a control or a fault in the program's place (never in a check)")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2

    def info(obj):
        print(json.dumps(obj), flush=True)

    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0,
                              fault=args.fault, info=info)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0
