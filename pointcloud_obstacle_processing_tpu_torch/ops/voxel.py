"""VoxelGrid downsampling (pcl::VoxelGrid equivalent), every engine.

Counterpart of ``pointcloud_obstacle_processing_tpu/ops/voxel.py``: points
bin into leaf-size cubes by ``floor(coord / leaf)`` and each occupied voxel
gives one centroid, in ascending (ix, iy, iz) order (Z-curve order under
``order="morton"``), for the first ``max_voxels`` voxels.  The engines, as
the reference chooses them (``voxel_partials``):

- **sort** (``binning`` "auto"/"sort", packable bounds, a buffer of a
  multiple of 128): the packed lattice key (or Morton code) sorted stably
  with the voxel-corner-relative offsets as payloads (three float32, or
  16-bit fixed point packed in two int32), each run of equal keys reduced
  by kernel K1 (``ops/runreduce.py``);
- **mxu** and **scatter** (packable bounds): the offsets and a unit count
  summed into dense bins over the crop box's lattice, the reference's bf16
  split terms for ``mxu`` (``ops.histogram.weighted_bin_sums``), its
  float32 scatter-add for ``scatter``; each bin's rows are folded in input
  order after a stable sort (``ops.segfold.segment_fold``, one launch that
  gathers the rows by the sort's permutation and, for ``mxu``, splits the
  terms), and the occupied bins are compacted by kernel K2;
- **the 3-key fallback** (no bounds, or a lattice past 2^23 bins): a stable
  lexicographic sort of the three keys (three stable sorts, least
  significant first) and in-order segment sums (``segment_fold``).

Every function takes one cloud or a batch of them (``[B, N]``, each scan
on its own).  The point-sharded path voxelizes each shard on its own and
merges the gathered per-shard (key, sum, count) tables
(``merge_voxel_partials_packed``, ``merge_voxel_partials``): large tables
by a stable sort on the packed key and K1 in counts mode, small ones by
adding into dense bins in shard order and compacting the occupied bins
with K2, unbounded keys by the 3-key sort.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import f32, fma, recip32
from ..types import Cloud
from .compaction import compact_and_gather_exact
from .histogram import MXU_HISTOGRAM_MAX_BINS, weighted_bin_sums
from .runreduce import sorted_run_reduce
from .segfold import segment_fold

__all__ = ["voxel_downsample", "voxel_partials", "finalize_voxels", "merge_voxel_partials",
           "merge_voxel_partials_packed", "VoxelResult", "VoxelPartials"]

_I32_MAX = 2**31 - 1

# merge_voxel_partials: gathered-table row count at or above which the
# packed-key sort and K1's counts mode replace the dense-bin merge (the
# reference's threshold, voxel.py:75, a property of the function, not of
# the device)
_SORT_MERGE_MIN_ROWS = 1 << 19


class VoxelResult(NamedTuple):  # a leading [B] on every field for a batch
    cloud: Cloud  # [max_voxels] centroids, key-sorted
    num_voxels: torch.Tensor  # [] int32: true number of occupied voxels
    overflow: torch.Tensor  # [] bool: num_voxels > max_voxels


class VoxelPartials(NamedTuple):  # a leading [B] on every field for a batch
    keys: torch.Tensor  # [cap, 3] int32 voxel coords (INT32_MAX = empty slot)
    sums: torch.Tensor  # [cap, 3] float32 coordinate sums
    counts: torch.Tensor  # [cap] float32 member counts (0 = empty)
    num_voxels: torch.Tensor  # [] int32
    overflow: torch.Tensor  # [] bool


def _pack_spec(bounds, leaf_size: float):
    """Static packing of (ix, iy, iz) into one int32 if the crop-box voxel
    ranges fit: (imin, dims) as Python ints, or None."""
    if bounds is None:
        return None
    (x0, y0, z0), (x1, y1, z1) = bounds
    imin = [math.floor(v / leaf_size) for v in (x0, y0, z0)]
    imax = [math.floor(v / leaf_size) for v in (x1, y1, z1)]
    dims = [max(b - a + 2, 1) for a, b in zip(imin, imax)]  # +1 span, +1 safety
    if dims[0] * dims[1] * dims[2] >= 2**31 - 2:
        return None
    return imin, dims


def _packable(spec) -> bool:
    """The lattice of ``spec`` packs into the one-key engines: at most 2^23
    bins (K1's float32 key channel is exact below 2^24)."""
    return spec is not None and spec[1][0] * spec[1][1] * spec[1][2] <= (1 << 23)


def _unpack_keys(packed: torch.Tensor, spec):
    """Packed lattice key (clipped to [0, K)) -> absolute (lx, ly, lz)."""
    imin, dims = spec
    lx = torch.div(packed, dims[1] * dims[2], rounding_mode="floor") + imin[0]
    lrem = packed % (dims[1] * dims[2])
    ly = torch.div(lrem, dims[2], rounding_mode="floor") + imin[1]
    lz = lrem % dims[2] + imin[2]
    return lx, ly, lz


def _morton_schedule(dims):
    """The reference's bit-interleave schedule for (ix, iy, iz) under the
    crop box (voxel.py:211-232): [(axis, source bit), ...] from the code's
    lowest bit up, cycling z, y, x while each axis has bits left (each
    axis as wide as its lattice dim needs), and the total bit count."""
    bits = [max(1, int(d - 1).bit_length()) for d in dims]
    sched = []
    cnt = [0, 0, 0]
    while any(cnt[a] < bits[a] for a in range(3)):
        for a in (2, 1, 0):  # z minor, as in the packed lattice order
            if cnt[a] < bits[a]:
                sched.append((a, cnt[a]))
                cnt[a] += 1
    return sched, sum(bits)


def _morton_encode(ix, iy, iz, sched):
    axes = (ix, iy, iz)
    out = torch.zeros_like(ix)
    for i, (a, b) in enumerate(sched):
        out = out | (((axes[a] >> b) & 1) << i)
    return out


def _morton_decode(code, sched):
    outs = [torch.zeros_like(code) for _ in range(3)]
    for i, (a, b) in enumerate(sched):
        outs[a] = outs[a] | (((code >> i) & 1) << b)
    return outs


def _sort_segment_partials(pts, valid, ijk, imin, dims, leaf_size: float, capacity: int,
                           order: str = "lattice", payload_packing: bool = False) -> VoxelPartials:
    """Stable sort on the packed lattice key (or the Morton code) + the
    run-reduce kernel (the reference's ``_sort_segment_partials``), each
    scan of a batch on its own: the sort runs along the last axis, so a
    scan's rows keep the order they have alone, and K1 takes the batch in
    one launch."""
    n = pts.shape[-2]
    if n % 128:
        raise ValueError(
            f"the sort engine needs the point buffer length to be a multiple of 128 (got {n})"
        )
    K = dims[0] * dims[1] * dims[2]
    ix = torch.clamp(ijk[..., 0] - imin[0], 0, dims[0] - 1)
    iy = torch.clamp(ijk[..., 1] - imin[1], 0, dims[1] - 1)
    iz = torch.clamp(ijk[..., 2] - imin[2], 0, dims[2] - 1)
    if order == "morton":
        sched, total_bits = _morton_schedule(dims)
        if total_bits > 24:
            raise ValueError(
                "voxel_order='morton' needs <= 24 key bits for the exact "
                f"f32 key channel (lattice {dims} needs {total_bits})"
            )
        sentinel = 1 << total_bits
        packed = torch.where(valid, _morton_encode(ix, iy, iz, sched), sentinel)
    else:
        sentinel = K
        packed = torch.where(valid, (ix * dims[1] + iy) * dims[2] + iz, K)
    packed = packed.to(torch.int32)

    # corner-relative offsets before the sort: a point's offset in its
    # voxel does not depend on its sorted position
    lf = f32(leaf_size)
    lattice = torch.stack([ix + imin[0], iy + imin[1], iz + imin[2]], dim=-1).to(torch.float32)
    # the reference contracts both multiply-adds of this stage; for these
    # operands (a lattice coordinate times the leaf, times a point count;
    # an offset next to its corner) the float64 sum inside ``fma`` is exact
    off0 = fma(-lattice, lf, pts)  # pts - lattice * leaf, [..., N, 3]
    off0 = torch.where(valid[..., None], off0, torch.zeros_like(off0))

    skey, perm = torch.sort(packed, dim=-1, stable=True)
    if payload_packing:
        quantum = leaf_size / 65536.0
        q = f32(65536.0 / leaf_size)
        qx, qy, qz = (torch.clamp((off0[..., c] * q).to(torch.int32), 0, 65535)
                      for c in range(3))
        pxy = (qx << 16) | qy
        slot_vals, num = sorted_run_reduce(
            skey, (pxy.gather(-1, perm), qz.gather(-1, perm)), sentinel, capacity,
            quantum=quantum,
        )
    else:
        slot_vals, num = sorted_run_reduce(
            skey, tuple(off0[..., c].gather(-1, perm) for c in range(3)), sentinel, capacity
        )

    target = torch.arange(capacity, device=pts.device)
    out_valid = target < torch.clamp_max(num, capacity)[..., None]
    slot_key = torch.clamp(slot_vals[..., 0].to(torch.int32), 0, sentinel - 1)
    if order == "morton":
        dx, dy, dz = _morton_decode(slot_key, sched)
        lx, ly, lz = dx + imin[0], dy + imin[1], dz + imin[2]
    else:
        lx, ly, lz = _unpack_keys(slot_key, (imin, dims))
    slot_counts = slot_vals[..., 4]
    key_cols, sum_cols = [], []
    for ch, l in ((1, lx), (2, ly), (3, lz)):
        key_cols.append(torch.where(out_valid, l, _I32_MAX))
        sum_cols.append(torch.where(
            out_valid, fma(l.to(torch.float32) * lf, slot_counts, slot_vals[..., ch]), 0.0))
    return VoxelPartials(
        keys=torch.stack(key_cols, dim=-1).to(torch.int32),
        sums=torch.stack(sum_cols, dim=-1),
        counts=torch.where(out_valid, slot_counts, 0.0),
        num_voxels=num,
        overflow=num > capacity,
    )


def _lexsort3(kx: torch.Tensor, ky: torch.Tensor, kz: torch.Tensor) -> torch.Tensor:
    """The permutation of ``lax.sort(num_keys=3, is_stable=True)`` along the
    last axis: ascending (kx, ky, kz), ties in input order; three stable
    sorts, the least significant key first."""
    perm = torch.sort(kz, dim=-1, stable=True).indices
    perm = perm.gather(-1, torch.sort(ky.gather(-1, perm), dim=-1, stable=True).indices)
    return perm.gather(-1, torch.sort(kx.gather(-1, perm), dim=-1, stable=True).indices)


def _reduce_sorted_keys(kx, ky, kz, sums, counts, capacity: int) -> VoxelPartials:
    """Segment-reduce (sums [..., N, 3], counts [..., N]) over rows sorted by
    (kx, ky, kz) into ``capacity`` compact slots (the reference's
    ``_reduce_sorted_keys``, voxel.py:94-139); ``counts > 0`` marks real
    rows.  A head is a real row whose key differs from the row before;
    each real row adds into its segment in row order, through
    ``segment_fold`` (the reference's scatter-add, an in-order fold on
    XLA:CPU), the keys through a scatter of unique indices.

    The fold's rows keep ``seg_id`` as their destination (it never falls
    along the rows, so each segment is one run), and a row that is not
    real adds +0.0 instead of being dropped: a sum folded from +0.0 is
    never -0.0, so adding +0.0 changes no bit.  Segments at or past
    ``capacity``, and the rows after the last real row, are dropped."""
    lead, n = kx.shape[:-1], kx.shape[-1]
    real = counts > 0.0
    row = torch.arange(n, device=kx.device)
    changed = (row == 0) | (kx != kx.roll(1, -1)) | (ky != ky.roll(1, -1)) | (kz != kz.roll(1, -1))
    head = changed & real
    seg_id = torch.cumsum(head.to(torch.int32), dim=-1, dtype=torch.int32) - 1
    num = head.sum(dim=-1, dtype=torch.int32)

    # rows that are not real add +0.0 (an invalid point's NaN product
    # ``sorted_pts * sv`` included: the reference drops such rows)
    vals = torch.cat([sums.transpose(-1, -2), counts[..., None, :]], dim=-2)  # [..., 4, N]
    vals = torch.where(real[..., None, :], vals, 0.0)
    # the rows after the last real one (the invalid rows and empty slots,
    # sorted last) are dropped outright: no run of them for the fold to walk
    last_real = torch.where(real, row, -1).amax(dim=-1, keepdim=True)
    folded = segment_fold(torch.where(row > last_real, capacity, seg_id), vals, capacity)
    head_ids = torch.where(head & (seg_id < capacity), seg_id, capacity).long()
    out_keys = torch.full((*lead, capacity + 1, 3), _I32_MAX, dtype=torch.int32,
                          device=kx.device)
    out_keys.scatter_(-2, head_ids[..., None].expand(*lead, n, 3),
                      torch.stack([kx, ky, kz], dim=-1).to(torch.int32))

    slot = torch.arange(capacity, device=kx.device)
    valid = slot < torch.clamp_max(num, capacity)[..., None]
    return VoxelPartials(
        keys=torch.where(valid[..., None], out_keys[..., :capacity, :], _I32_MAX),
        sums=torch.where(valid[..., None], folded[..., :3, :].transpose(-1, -2), 0.0),
        counts=torch.where(valid, folded[..., 3, :], 0.0),
        num_voxels=num,
        overflow=num > capacity,
    )


def _dense_partials(pts, valid, ijk, spec, capacity: int, leaf_size: float, sum_precision: str,
                    binning: str) -> VoxelPartials:
    """The dense-bin engines (voxel.py:492-550): each valid point's
    corner-relative offset and a unit count summed into the crop box's
    lattice bins, the ``mxu`` engine's bf16 split terms (``binning`` not
    "scatter" and K <= ``MXU_HISTOGRAM_MAX_BINS``) or the ``scatter``
    engine's float32 adds, each bin's rows in input order (a stable sort
    of the packed key, then one ``segment_fold`` into the 128-padded bins);
    then K2 compacts the occupied bins."""
    imin, dims = spec
    K = dims[0] * dims[1] * dims[2]
    ix, iy, iz = (torch.clamp(ijk[..., c] - imin[c], 0, dims[c] - 1) for c in range(3))
    packed = torch.where(valid, (ix * dims[1] + iy) * dims[2] + iz, K).to(torch.int32)
    # the offset from the unclipped lattice corner, pts - ijk * leaf: here
    # jitted XLA:CPU rounds the product before the subtraction (unlike the
    # sort engine's offset, which it fuses); invalid rows add +0.0
    off = pts - ijk.to(torch.float32) * f32(leaf_size)
    upd = torch.cat([torch.where(valid[..., None], off, 0.0),
                     valid.to(torch.float32)[..., None]], dim=-1)  # [..., N, 4]
    lead = pts.shape[:-2]
    if binning != "scatter" and K <= MXU_HISTOGRAM_MAX_BINS:
        # padded bins (>= K) have zero counts and are never occupied
        bins, _, _ = weighted_bin_sums(packed, upd, valid, K,
                                       exact_f32=(sum_precision == "exact"), align=128)
    else:
        skey, perm = torch.sort(packed, dim=-1, stable=True)
        # the invalid rows (key K, sorted last) add +0.0 to bin K in the
        # reference; dropped here (bins K), the bin keeps the +0.0 it is
        # zeroed to; the fold gathers the rows by the sort's permutation
        bins = segment_fold(skey, upd.transpose(-1, -2), K, order=perm,
                            width=-(-K // 128) * 128)  # [..., 4, kp]
    kp = bins.shape[-1]
    occ2d = (bins[..., 3, :] > 0.0).reshape(*lead, kp // 128, 128)
    return _dense_bins_to_partials(bins, occ2d, spec, capacity, leaf_size)


def voxel_partials(cloud: Cloud, leaf_size: float, capacity: int, bounds=None,
                   sum_precision: str = "exact", binning: str = "auto", order: str = "lattice",
                   payload_packing: bool = False) -> VoxelPartials:
    """Per-voxel (key, sum, count), key-sorted (the reference's signature
    and dispatch, voxel.py:399-568).

    ``bounds`` (the crop box enclosing every valid point) packs the
    lattice into one int32 key when it has at most 2^23 bins.  Packable
    bounds with ``binning`` "auto"/"sort" and a buffer of a multiple of 128
    take the sort engine (``order`` "lattice" or "morton"); other packable
    cases take the dense ``mxu`` or ``scatter`` engine ("auto": ``mxu`` up
    to ``MXU_HISTOGRAM_MAX_BINS`` bins); unpackable "auto" takes the 3-key
    fallback.  An engine that was asked for is never swapped for another:
    each case the reference refuses raises its ``ValueError``.
    """
    pts = cloud.points
    n = pts.shape[-2]
    valid = cloud.valid & torch.isfinite(pts).all(dim=-1)
    # the reference's floor(pts / leaf) as XLA:CPU evaluates it, a product
    # with the reciprocal; clamp before the int cast (a huge coordinate must
    # not wrap)
    ijk = torch.clamp(torch.floor(pts * recip32(leaf_size)), -(2.0**30), 2.0**30).to(torch.int32)
    spec = _pack_spec(bounds, leaf_size)
    packable = _packable(spec)
    if packable and binning in ("auto", "sort") and n % 128 == 0:
        imin, dims = spec
        return _sort_segment_partials(pts, valid, ijk, imin, dims, leaf_size, capacity, order,
                                      payload_packing)
    if payload_packing:
        raise ValueError(
            "voxel payload packing is only defined for the sort engine "
            "(packable bounds, capacity % 128 == 0)"
        )
    if binning == "sort":
        raise ValueError(
            "binning='sort' requires packable bounds and capacity % 128 == 0 "
            f"(got bounds={'packable' if packable else bounds!r}, n={n}); "
            "use binning='auto' to allow the dense-engine fallback"
        )
    if order == "morton":
        raise ValueError(
            "voxel_order='morton' requires the sort engine (packable bounds, "
            "capacity % 128 == 0, binning in ('auto', 'sort'))"
        )
    if binning not in ("auto", "mxu", "scatter"):
        raise ValueError(
            f"unknown voxel binning engine {binning!r} "
            "(choose 'auto', 'sort', 'mxu' or 'scatter')"
        )
    if binning in ("mxu", "scatter") and not packable:
        raise ValueError(
            f"binning={binning!r} requires packable bounds with <= 2^23 "
            f"bins (got bounds={bounds!r}); use binning='auto' to allow "
            "the unbounded 3-key-sort fallback"
        )
    if binning == "mxu":
        K_req = spec[1][0] * spec[1][1] * spec[1][2]
        if K_req > MXU_HISTOGRAM_MAX_BINS:
            raise ValueError(
                f"binning='mxu' requires K <= {MXU_HISTOGRAM_MAX_BINS} one-hot bins "
                f"(lattice {spec[1]} has {K_req}); use 'scatter' or 'auto'"
            )
    if packable:
        return _dense_partials(pts, valid, ijk, spec, capacity, leaf_size, sum_precision, binning)

    # the unbounded 3-key fallback (voxel.py:559-568)
    kx, ky, kz = (torch.where(valid, ijk[..., c], _I32_MAX) for c in range(3))
    perm = _lexsort3(kx, ky, kz)
    sv = valid.to(torch.float32).gather(-1, perm)
    sorted_pts = pts.gather(-2, perm[..., None].expand(pts.shape)) * sv[..., None]
    return _reduce_sorted_keys(kx.gather(-1, perm), ky.gather(-1, perm), kz.gather(-1, perm),
                               sorted_pts, sv, capacity)


def _pack_keys(keys: torch.Tensor, counts: torch.Tensor, spec) -> torch.Tensor:
    """[..., R, 3] (ix, iy, iz) table keys -> [..., R] packed int32 lattice
    keys under ``spec``: real rows (counts > 0) ``(kx*dy + ky)*dz + kz``
    after the imin shift and clip, empty rows the sentinel K."""
    imin, dims = spec
    K = dims[0] * dims[1] * dims[2]
    kx, ky, kz = (torch.clamp(keys[..., c] - imin[c], 0, dims[c] - 1) for c in range(3))
    return torch.where(counts > 0.0, (kx * dims[1] + ky) * dims[2] + kz, K).to(torch.int32)


def _channelled_vals_to_partials(sv: torch.Tensor, num: torch.Tensor, K: int, spec,
                                 capacity: int) -> VoxelPartials:
    """Channel-leading [..., 5, capacity] merged table (packed key, sum_xyz,
    count) and run count -> VoxelPartials: the output formatting the sort
    merge and the distributed merge share."""
    slot = torch.arange(capacity, device=sv.device)
    out_valid = slot < torch.clamp_max(num, capacity)[..., None]
    lx, ly, lz = _unpack_keys(torch.clamp(sv[..., 0, :].to(torch.int32), 0, K - 1), spec)
    keys = torch.stack([torch.where(out_valid, l, _I32_MAX) for l in (lx, ly, lz)], dim=-1)
    sums = torch.stack([torch.where(out_valid, sv[..., ch, :], 0.0) for ch in (1, 2, 3)], dim=-1)
    return VoxelPartials(
        keys=keys.to(torch.int32),
        sums=sums,
        counts=torch.where(out_valid, sv[..., 4, :], 0.0),
        num_voxels=num,
        overflow=num > capacity,
    )


def _dense_bins_to_partials(bins: torch.Tensor, occ2d: torch.Tensor, spec, capacity: int,
                            leaf_size: float) -> VoxelPartials:
    """Dense channel-leading [..., 4, Kp] corner-relative (sum_xyz, count)
    bins -> VoxelPartials: the first ``capacity`` occupied bins in ascending
    packed order through K2's compaction and exact gather, then each sum
    back to absolute, ``rel + corner * count`` as jitted XLA:CPU evaluates
    it: the product re-associated to ``lattice * (count * leaf)`` and fused
    into the add (``tests/test_torch_sharding.py`` holds the merge bitwise
    to the reference's)."""
    loc, num, slot_vals = compact_and_gather_exact(bins, occ2d, capacity)
    slot = torch.arange(capacity, device=bins.device)
    out_valid = slot < torch.clamp_max(num, capacity)[..., None]
    lx, ly, lz = _unpack_keys(loc, spec)
    slot_counts = slot_vals[..., 3]
    lf = f32(leaf_size)
    keys, sums = [], []
    for ch, l in enumerate((lx, ly, lz)):
        keys.append(torch.where(out_valid, l, _I32_MAX))
        sums.append(torch.where(
            out_valid, fma(l.to(torch.float32), slot_counts * lf, slot_vals[..., ch]), 0.0))
    return VoxelPartials(
        keys=torch.stack(keys, dim=-1).to(torch.int32),
        sums=torch.stack(sums, dim=-1),
        counts=torch.where(out_valid, slot_counts, 0.0),
        num_voxels=num,
        overflow=num > capacity,
    )


def merge_voxel_partials_packed(packed: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor,
                                capacity: int, spec, leaf_size: float,
                                tables: int = 1) -> VoxelPartials:
    """Merge concatenated partial tables keyed by packed int32 lattice keys
    (``_pack_keys``; [..., R], sums [..., R, 3], counts [..., R]): the
    reference's ``merge_voxel_partials_packed`` (voxel.py:617), each scan of
    a batch on its own.  The output is in ascending lattice order.

    Engines, by table size as the reference chooses (:652): at least
    ``_SORT_MERGE_MIN_ROWS`` rows, a multiple of 128, take a stable sort on
    the packed key and K1 in counts mode (the counts ride the count
    channel; integer-valued, so exact in any order); smaller tables add
    each row's corner-relative sums into dense [4, Kp] bins and compact the
    occupied bins with K2.  The reference's scatter-add applies the rows in
    order; the rows here are ``tables`` equal blocks (the per-shard tables
    of a gather), each with unique real keys, added block after block, so
    a bin takes its adds in the same order and no two adds of one block
    meet (exact on every device)."""
    imin, dims = spec
    K = dims[0] * dims[1] * dims[2]
    rows = packed.shape[-1]
    lead = packed.shape[:-1]
    if rows >= _SORT_MERGE_MIN_ROWS and rows % 128 == 0:
        sk, order = torch.sort(packed, dim=-1, stable=True)
        pay = [sums[..., c].gather(-1, order) for c in range(3)] + [counts.gather(-1, order)]
        vals, num = sorted_run_reduce(sk, pay, K, capacity)
        return _channelled_vals_to_partials(vals.transpose(-1, -2), num, K, spec, capacity)
    if rows % tables:
        raise ValueError(f"merge: {rows} rows do not split into {tables} tables")
    real = counts > 0.0
    lx, ly, lz = _unpack_keys(torch.clamp(packed, 0, K - 1), spec)
    lf = f32(leaf_size)
    # rel = sums - corner * counts, corner = lattice * leaf, as jitted
    # XLA:CPU evaluates it: fma(-lattice, counts * leaf, sums)
    rel = [fma(-l.to(torch.float32), counts * lf, sums[..., c]) for c, l in enumerate((lx, ly, lz))]
    upd = torch.stack([torch.where(real, r, 0.0) for r in rel]
                      + [torch.where(real, counts, 0.0)], dim=-1)  # [..., R, 4]
    kp = -(-K // 128) * 128
    scans = packed[..., 0].numel()
    # bin k of scan b at b * (kp + 1) + k; kp: the drop bin of empty rows
    flat = torch.zeros(scans * (kp + 1), 4, dtype=torch.float32, device=packed.device)
    base = (torch.arange(scans, device=packed.device) * (kp + 1)).reshape(*lead, 1)
    idx = torch.where(real, packed.long(), kp) + base  # [..., R]
    per = rows // tables
    for t in range(tables):
        blk = slice(t * per, (t + 1) * per)
        flat.index_add_(0, idx[..., blk].reshape(-1), upd[..., blk, :].reshape(-1, 4))
    bins = flat.reshape(*lead, kp + 1, 4)[..., :kp, :].transpose(-1, -2).contiguous()
    occ2d = (bins[..., 3, :] > 0.0).reshape(*lead, kp // 128, 128)
    return _dense_bins_to_partials(bins, occ2d, spec, capacity, leaf_size)


def merge_voxel_partials(partials: VoxelPartials, capacity: int, bounds=None,
                         leaf_size: float | None = None, tables: int = 1) -> VoxelPartials:
    """Merge concatenated partial tables (keys [..., R, 3]; the reference's
    ``merge_voxel_partials``, voxel.py:704): with ``bounds`` and
    ``leaf_size`` whose lattice packs into at most 2^23 bins the keys pack
    and ``merge_voxel_partials_packed`` merges them.  Other keys take the
    reference's 3-key sort fallback (voxel.py:732-747): a stable sort on
    (kx, ky, kz) and the in-order segment sums of ``_reduce_sorted_keys``."""
    spec = _pack_spec(bounds, leaf_size) if leaf_size is not None else None
    if _packable(spec):
        packed = _pack_keys(partials.keys, partials.counts, spec)
        return merge_voxel_partials_packed(packed, partials.sums, partials.counts, capacity,
                                           spec, leaf_size, tables)
    keys = partials.keys
    perm = _lexsort3(keys[..., 0], keys[..., 1], keys[..., 2])
    kx, ky, kz = (keys[..., c].gather(-1, perm) for c in range(3))
    sums = partials.sums.gather(-2, perm[..., None].expand(partials.sums.shape))
    return _reduce_sorted_keys(kx, ky, kz, sums, partials.counts.gather(-1, perm), capacity)


def finalize_voxels(partials: VoxelPartials) -> VoxelResult:
    """Partials -> centroid cloud: one reciprocal per voxel, three multiplies
    (the reference's exact operation order)."""
    cap = partials.counts.shape[-1]
    slot = torch.arange(cap, device=partials.counts.device)
    valid = slot < torch.clamp_max(partials.num_voxels, cap)[..., None]
    inv = 1.0 / torch.clamp_min(partials.counts, 1.0)
    centroids = torch.stack([partials.sums[..., c] * inv for c in range(3)], dim=-1)
    return VoxelResult(
        cloud=Cloud(points=centroids, valid=valid),
        num_voxels=partials.num_voxels,
        overflow=partials.overflow,
    )


def voxel_downsample(cloud: Cloud, leaf_size: float, max_voxels: int, bounds=None,
                     sum_precision: str = "exact", binning: str = "auto", order: str = "lattice",
                     payload_packing: bool = False) -> VoxelResult:
    """Downsample to per-voxel centroids (see the module docstring)."""
    return finalize_voxels(
        voxel_partials(cloud, leaf_size, max_voxels, bounds, sum_precision, binning, order,
                       payload_packing)
    )
