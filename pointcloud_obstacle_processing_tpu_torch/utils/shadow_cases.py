"""Seeded inputs of the shadow stage (``ops.shadow``) for checks: random
cluster slots at a given shape, and a scan of edge cases.

NumPy only, so the CPU tests (against the JAX package), the card tests and
``chip_smoke.py`` build the same inputs.  Each function returns a dict of
numpy arrays: ``points`` [S, C, 3] float32 (world frame), ``valid`` [S, C]
bool, ``point_cluster`` [S, C] int32 (slot or -1), ``slot_valid`` [S, M]
bool, and the sensor pose ``quat`` ([4] or [S, 4], xyzw) and ``trans``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_slots", "edge_slots", "EDGE_SLOTS"]


def random_slots(seed: int, scans: int, capacity: int, slots: int,
                 pose_per_scan: bool = False) -> dict:
    """``scans`` clouds of ``capacity`` points: about 80% in the ``slots``
    clusters (Gaussian blobs over the arena, some wide, about a tenth of the
    slots empty or not valid), the rest unassigned; 3% of points not valid.
    The pose is a camera behind the arena, tilted down, jittered per scan
    with ``pose_per_scan``."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((scans, capacity, 3), np.float32)
    pc = np.full((scans, capacity), -1, np.int32)
    for s in range(scans):
        centers = rng.uniform([0.3, 0.2, 0.0], [4.3, 3.6, 0.3], (slots, 3))
        spread = rng.uniform(0.02, 0.15, (slots, 3)) * np.where(rng.random((slots, 1)) < 0.2,
                                                               [1.0, 8.0, 1.0], 1.0)
        owner = rng.integers(0, slots, capacity)
        owner = np.where(rng.random(capacity) < 0.8, owner, -1)
        empty = rng.random(slots) < 0.1
        owner = np.where((owner >= 0) & empty[np.maximum(owner, 0)], -1, owner)
        pts[s] = np.where(owner[:, None] >= 0,
                          rng.normal(centers[np.maximum(owner, 0)], spread[np.maximum(owner, 0)]),
                          rng.uniform([-0.5, -0.5, -0.2], [5.0, 4.3, 0.5], (capacity, 3)))
        pc[s] = owner
    valid = rng.random((scans, capacity)) >= 0.03
    slot_valid = rng.random((scans, slots)) >= 0.05
    q = np.array([0.0, 0.2588190, 0.0, 0.9659258])  # 30 degrees down about y
    t = np.array([-0.6, 1.9, 0.8])
    if pose_per_scan:
        q = q + rng.normal(0.0, 0.02, (scans, 4))
        t = t + rng.normal(0.0, 0.05, (scans, 3))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(points=pts, valid=valid, point_cluster=pc, slot_valid=slot_valid,
                quat=q.astype(np.float32), trans=t.astype(np.float32))


def _f32(bits: int) -> float:
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# The edge slots, one a slot, in the sensor frame (the pose is the
# identity, so sensor and world frames agree bit for bit): each a list of
# (x, y, z) points, the first point listed first in the cloud.
EDGE_SLOTS = {
    # the nearest point has x = +0: a / c = 1, asin rounds above pi/2 and
    # tanf gives about -2.29e7; the end point lies ~1e7 m away, its cells
    # saturate
    "x zero, z up": [(0.0, 1.0, 0.5), (0.8, 1.2, 0.4), (0.5, 1.4, 0.3)],
    # x = -0, z down: a / c = -1
    "x minus zero, z down": [(-0.0, 2.0, -0.4), (0.6, 2.3, -0.2)],
    # the nearest point at the sensor: c = |vmin| = 0, both floored at 1e-20
    "at the sensor": [(0.0, 0.0, 0.0), (0.5, 0.3, 0.1), (0.9, -0.2, 0.2)],
    # a subnormal z: the quotient is flushed to zero as XLA:CPU's
    "subnormal z": [(1.0, 1.0, _f32(0x00000400)), (1.5, 1.2, 0.1)],
    # a tiny normal z: the quotient a / c is normal, atan2f's y / x subnormal
    "tiny z": [(1.0, 2.5, _f32(0x00c00000)), (1.7, 2.8, 0.0)],
    # z = x: a / c = 1/sqrt(2), asin next to pi/4 where tanf's method switches
    "z equals x": [(1.25, 0.6, 1.25), (2.0, 0.9, 0.3)],
    # asin(a / c) next to 0.6744, the kernel's |x| >= 0.6744 switch
    "tanf switch": [(1.0, 3.0, 0.7985), (1.4, 3.2, 0.1)],
    # ties: two nearest points share x (the first wins), one +0 and one -0 y
    "ties": [(0.7, 0.0, 0.3), (0.7, -0.0, 0.2), (0.9, 0.4, 0.1)],
    # one point: inactive
    "one point": [(2.0, 2.0, 0.1)],
    # a slot of many points spread 3 m wide: a long sweep
    "wide": [(1.5 + 0.01 * i, 0.3 + 0.1 * i, 0.2) for i in range(30)],
    # steep (|dy| > |dx| in cells) and shallow shadows, both directions
    "steep": [(0.5, 1.5, -0.3), (0.6, 1.55, -0.2)],
    "shallow": [(3.5, 0.2, 0.05), (3.6, 0.25, 0.1)],
    "shallow back": [(3.5, 3.5, 0.6), (3.8, 3.6, 0.5)],
    # a / c just below 1 and just above -1
    "near one": [(1e-4, 1.8, 0.9), (0.5, 1.9, 0.8)],
    "near minus one": [(1e-4, 0.9, -0.9), (0.5, 1.0, -0.8)],
}


def edge_slots(slots: int | None = None) -> dict:
    """One scan whose slots are ``EDGE_SLOTS`` (then, up to ``slots``, an
    empty valid slot and a slot that is not valid though it has points),
    with points not valid and unassigned points between them, and the
    identity pose."""
    names = list(EDGE_SLOTS)
    m = max(slots or 0, len(names) + 2)
    rows, owner, ok = [], [], []
    for k, name in enumerate(names):
        for p in EDGE_SLOTS[name]:
            rows.append(p)
            owner.append(k)
            ok.append(True)
        rows.append((0.1 * k - 0.5, 0.2, 0.0))  # a point of the slot not valid
        owner.append(k)
        ok.append(False)
        rows.append((-0.3, 0.1 * k, 0.0))  # unassigned
        owner.append(-1)
        ok.append(True)
    not_valid_slot = len(names) + 1
    rows += [(1.0, 1.0, 0.2), (1.2, 1.1, 0.1)]
    owner += [not_valid_slot] * 2
    ok += [True, True]
    slot_valid = np.ones((1, m), bool)
    slot_valid[0, not_valid_slot] = False
    return dict(points=np.array(rows, np.float32)[None], valid=np.array(ok)[None],
                point_cluster=np.array(owner, np.int32)[None], slot_valid=slot_valid,
                quat=np.array([0.0, 0.0, 0.0, 1.0], np.float32),
                trans=np.zeros(3, np.float32))
