"""The benchmark's one traffic generator, driven by a traffic file.

A traffic file (``traffic/<name>.json``) gives:

* ``batch``: scans a request (one ``batched_pipeline`` call);
* ``pool``: distinct scans made once a run (a whole number of requests;
  request ``r`` takes block ``r mod (pool / batch)``);
* ``scene``: the arena, ``scene.SceneSpec``'s fields;
* ``kind``: ``"scan"`` (one ``make_scene`` a scan, its seed drawn from
  ``--seed``) or ``"window"`` (``make_fullscale_window``: the arena of
  ``arenas[i]`` re-observed ``observations`` times with sensor noise of
  ``noise_sigma`` m, the noise drawn from ``--seed``, in ``max_points``
  slots).  A window's rocks set how many sweeps its clustering takes, and
  each sweep is a host read: fixed arenas give every seed the same work;
* ``check``: the requests the comparison samples from the window
  (``requests``) and the scans of each it compares (``scans``, one drawn
  from each of that many equal parts of the batch, so two or more hold a
  scan of each half);
* ``trace_requests``: the requests a ``--trace 1`` run profiles after its
  window.

Each scan's seed (a window's noise seed) comes from ``--seed`` and the
scan's place in the pool, so the same seed gives the same pool.
"""

from __future__ import annotations

import numpy as np

from .scene import SceneSpec, make_fullscale_window, make_scene


def scan_seed(seed: int, index: int) -> int:
    """The generator seed of pool scan ``index`` in a run of ``seed``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint32)[0])


def make_pool(traffic: dict, max_points: int, seed: int) -> tuple[np.ndarray, np.ndarray, list]:
    """``(points [pool, max_points, 3] float32, valid [pool, max_points]
    bool, seeds)`` for ``traffic``; every scan zero-padded to capacity."""
    pool, batch = traffic["pool"], traffic["batch"]
    if pool % batch:
        raise ValueError(f"pool {pool} is not a whole number of requests of {batch}")
    spec = SceneSpec(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in traffic["scene"].items()})
    seeds = [scan_seed(seed, i) for i in range(pool)]
    points = np.zeros((pool, max_points, 3), np.float32)
    valid = np.zeros((pool, max_points), bool)
    for i, s in enumerate(seeds):
        if traffic["kind"] == "scan":
            p = make_scene(seed=s, spec=spec).points
            if len(p) > max_points:
                raise ValueError(f"a scene of {len(p)} points exceeds max_points {max_points}")
            points[i, :len(p)] = p
            valid[i, :len(p)] = True
        elif traffic["kind"] == "window":
            points[i], valid[i] = make_fullscale_window(
                max_points, n_obs=traffic["observations"], seed=traffic["arenas"][i],
                noise_sigma=traffic["noise_sigma"], noise_seed=s, spec=spec)
        else:
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    return points, valid, seeds
