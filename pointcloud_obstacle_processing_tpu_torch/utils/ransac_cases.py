"""Seeded inputs of RANSAC's round (``ops.ransac.ransac_hypotheses_score``,
and its reference on given planes, ``ransac_score_plain``) and mask
(``plane_inliers``) that reach their edges: points a few ulps either side
of the distance threshold, counts that tie, hypotheses gated off, invalid
rows with NaN coordinates, and planes padded past a warp's 32.

``score_case`` (given planes) and ``round_case`` (drawn triples) return
numpy arrays, so the CPU tests, the card tests and ``chip_smoke.py`` phase
15 hand the same values to every version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dot3, f32

__all__ = ["THRESH", "score_case", "round_case", "probe_points"]

THRESH = 0.04  # the shipped plane_segment_dist_thresh


def _plane_dist(x, y, z, n, d) -> np.ndarray:
    """The port's plane distance (``ops.dot3`` then the add) on the CPU."""
    pts = [torch.tensor(np.asarray(v, np.float32)) for v in (x, y, z)]
    nrm = [torch.tensor(np.float32(v)) for v in n]
    return (dot3(*pts, *nrm) + torch.tensor(np.float32(d))).numpy()


def probe_points(rng, n, d, bases: int, ulps: int = 8) -> np.ndarray:
    """Points whose distance to the plane (``n``, ``d``) lies within
    ``ulps`` float32 steps of +-THRESH: for each of ``bases`` random (x, y),
    z solved for the threshold on a random side, then stepped one ulp at a
    time.  Returns [bases * (2 * ulps + 1), 3] float32."""
    t = np.float32(THRESH)
    steps = np.arange(-ulps, ulps + 1, dtype=np.int32)
    out = []
    for _ in range(bases):
        x, y = rng.uniform(-3.0, 3.0, 2).astype(np.float32)
        side = rng.choice([-1.0, 1.0])
        z0 = np.float32((side * t - d - n[0] * x - n[1] * y) / n[2])
        z = (z0.view(np.int32) + steps).view(np.float32)
        out.append(np.stack([np.full_like(z, x), np.full_like(z, y), z], -1))
    return np.concatenate(out).astype(np.float32)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def score_case(seed: int, scans: int, n: int, k: int, kind: str = "probes") -> dict:
    """``scans`` scans of ``n`` rows and ``k`` hypotheses.  Every scan holds
    near-horizontal planes with clutter; invalid rows (about 10%, and a
    ragged tail) carry NaN coordinates.  ``kind``:

    * ``"probes"``: hypothesis 0 of each scan is a fixed plane, and a share
      of its rows lie within 8 ulps of that plane's threshold;
    * ``"ties"``: each scan's best plane is repeated at several k (the
      first copy sometimes gated off), so the largest count ties;
    * ``"gated"``: scan 0 has every hypothesis gated off, and every
      other scan about half;
    * ``"random"``: planes through random triples of the scan's points.

    Returns numpy ``points`` [B, N, 3], ``valid`` [B, N], ``nx``, ``ny``,
    ``nz``, ``ds`` [B, K] float32, ``gate`` [B, K] bool, and ``thresh`` (``ops.f32``)."""
    rng = np.random.default_rng(seed)
    pts = np.empty((scans, n, 3), np.float32)
    valid = np.zeros((scans, n), bool)
    normals = np.empty((scans, k, 3), np.float32)
    ds = np.empty((scans, k), np.float32)
    gate = rng.random((scans, k)) < 0.9
    for b in range(scans):
        n_fill = int(n * rng.uniform(0.75, 1.0))
        m = n_fill // 2
        ground = np.stack([rng.uniform(0, 4, m), rng.uniform(0, 3, m),
                           rng.normal(0, 0.02, m)], -1)
        clutter = rng.uniform([0, 0, -0.3], [4, 3, 0.8], (n_fill - m, 3))
        cloud = np.concatenate([ground, clutter]).astype(np.float32)
        if kind == "probes":
            plane = _unit([rng.normal(0, 0.05), rng.normal(0, 0.05), 1.0])
            probes = probe_points(rng, plane, np.float32(0.0), bases=max(1, n_fill // 40))
            cloud[: len(probes)] = probes[: n_fill]
        cloud = cloud[rng.permutation(n_fill)]
        pts[b, :n_fill] = cloud
        valid[b, :n_fill] = rng.random(n_fill) < 0.9
        pts[b][~valid[b]] = np.nan
        tri = cloud[rng.integers(0, n_fill, (k, 3))]
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nrm = nrm + (np.linalg.norm(nrm, axis=-1, keepdims=True) == 0) * [0.0, 0.0, 1.0]
        normals[b] = _unit(nrm)
        ds[b] = -np.einsum("kc,kc->k", normals[b], tri[:, 0]).astype(np.float32)
        if kind == "probes":
            normals[b, 0], ds[b, 0] = plane, 0.0
        if kind == "ties":
            counts = [(np.abs(_plane_dist(*pts[b].T, normals[b, j], ds[b, j])) < THRESH).sum()
                      for j in range(k)]
            top = int(np.argmax(counts))
            copies = rng.choice(k, size=min(k, 4), replace=False)
            normals[b, copies], ds[b, copies] = normals[b, top], ds[b, top]
            gate[b, copies] = True
            gate[b, copies.min()] = rng.random() < 0.5
        if kind == "gated":
            gate[b] = rng.random(k) < 0.5 if b else False
    return {"points": pts, "valid": valid, "nx": normals[..., 0].copy(),
            "ny": normals[..., 1].copy(), "nz": normals[..., 2].copy(), "ds": ds, "gate": gate,
            "thresh": f32(THRESH)}


# three points of a near-horizontal plane through the origin's neighbourhood,
# exact in float32: the probes' hypothesis in ``round_case``
_PROBE_TRIPLE = np.float32([[0.5, 0.5, 0.0], [2.5, 0.75, 0.001], [1.0, 2.5, -0.001]])


def round_case(seed: int, scans: int, n: int, k: int, kind: str = "probes") -> dict:
    """``score_case``'s clouds (``scans`` x ``n`` rows, NaN coordinates on
    invalid rows) with ``k`` drawn triples a scan, as a round draws them:
    indices of valid rows (a scan with none draws row 0).  ``kind``:

    * ``"probes"``: hypothesis 0 of each scan draws three fixed points of a
      near-horizontal plane, and a share of the other valid rows lie within
      8 ulps of the threshold of the plane those points build
      (``ops.ransac.hypotheses_plain``);
    * ``"ties"``: each scan's best hypothesis is drawn again at several k,
      so the largest count ties;
    * ``"gated"``: scan 0 draws only degenerate triples (a point repeated),
      every other scan about half;
    * ``"random"``: random triples.

    Returns numpy ``points`` [B, N, 3], ``valid`` [B, N], ``tri`` [B, K, 3]
    int64, ``n_valid`` [B] int32, and ``thresh`` (``ops.f32``)."""
    from ..ops import ransac

    c = score_case(seed, scans, n, k, "random")
    pts, valid = c["points"], c["valid"]
    rng = np.random.default_rng(seed + 1)
    tri = np.zeros((scans, k, 3), np.int64)
    axis = (0.0, 0.0, 1.0)
    for b in range(scans):
        rows = np.flatnonzero(valid[b])
        if not len(rows):
            continue
        tri[b] = rows[rng.integers(0, len(rows), (k, 3))]
        if kind == "probes" and len(rows) > 3:
            pts[b, rows[:3]] = _PROBE_TRIPLE
            tri[b, 0] = rows[:3]
            nx, ny, nz, d, _ = (t.numpy()[0, 0] for t in ransac.hypotheses_plain(
                torch.tensor(_PROBE_TRIPLE[None]), torch.arange(3)[None, None],
                torch.tensor([3], dtype=torch.int32), f32(0.0), axis))
            probes = probe_points(rng, np.float32([nx, ny, nz]), d,
                                  bases=max(1, len(rows) // 40))
            at = rows[3:3 + len(probes)]
            pts[b, at] = probes[: len(at)]
        if kind == "gated":
            off = np.ones(k, bool) if b == 0 else rng.random(k) < 0.5
            tri[b, off, 1] = tri[b, off, 0]
    n_valid = valid.sum(-1).astype(np.int32)
    if kind == "ties":
        t_pts, t_valid = torch.tensor(pts), torch.tensor(valid)
        planes = ransac.hypotheses_plain(t_pts, torch.tensor(tri), torch.tensor(n_valid), f32(0.0),
                                         axis)
        counts = ransac.ransac_score_plain(t_pts, t_valid, *planes, f32(THRESH)).counts.numpy()
        for b in range(scans):
            top = int(np.argmax(counts[b]))
            copies = rng.choice(k, size=min(k, 4), replace=False)
            tri[b, copies] = tri[b, top]
    return {"points": pts, "valid": valid, "tri": tri, "n_valid": n_valid, "thresh": f32(THRESH)}
