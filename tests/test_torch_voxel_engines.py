"""The voxel engines of the PyTorch port against the JAX package: the dense
``scatter`` and ``mxu`` engines, the Morton order, the 3-key fallback and
its merge, the in-order segment fold under them, the rank-scatter
``compact``, the reference's ``mxu_histogram`` functions and the small
leftovers (``passthrough_mask``, ``euclidean_distance``,
``hypotheses_for_confidence``).  Whole scans under each engine:
``tests/test_torch_voxel_engine_scans.py`` and
``tests/test_torch_voxel_fallback_scans.py``.

Bar: voxel partials bitwise (keys, sums, counts, ``num_voxels``,
``overflow``) against the jitted reference; every case the reference
refuses raises the reference's ``ValueError`` message."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_sharding import _assert_partials_equal

import pointcloud_obstacle_processing_tpu as ref
import pointcloud_obstacle_processing_tpu.ops as ref_ops
from pointcloud_obstacle_processing_tpu import Cloud as RCloud
from pointcloud_obstacle_processing_tpu.ops import compaction as ref_compaction
from pointcloud_obstacle_processing_tpu.ops import filters as ref_filters
from pointcloud_obstacle_processing_tpu.ops import mxu_histogram as ref_mxu
from pointcloud_obstacle_processing_tpu.ops import ransac as ref_ransac
from pointcloud_obstacle_processing_tpu.ops import voxel as ref_voxel

import pointcloud_obstacle_processing_tpu_torch as port
import pointcloud_obstacle_processing_tpu_torch.ops as port_ops
from pointcloud_obstacle_processing_tpu_torch import Cloud
from pointcloud_obstacle_processing_tpu_torch.ops import compaction, filters, histogram, ransac, voxel
from pointcloud_obstacle_processing_tpu_torch.ops.segfold import (
    meets_contract,
    segment_fold,
    segment_fold_plain,
)

BOUNDS = ((0.0, 0.0, -0.5), (4.5, 3.78, 0.25))
N, CAP = 8192, 2048

# name -> (voxel_partials keyword arguments, leaf, bounds, point buffer length)
ENGINES = {
    "scatter": (dict(binning="scatter"), 0.06, BOUNDS, N),
    "mxu_fast": (dict(binning="mxu", sum_precision="fast"), 0.06, BOUNDS, N),
    "mxu_exact": (dict(binning="mxu", sum_precision="exact"), 0.06, BOUNDS, N),
    "morton": (dict(order="morton"), 0.06, BOUNDS, N),
    "morton_packed": (dict(order="morton", payload_packing=True), 0.06, BOUNDS, N),
    "fallback_unbounded": ({}, 0.06, None, N),
    "fallback_fine_leaf": ({}, 0.005, BOUNDS, N),  # 902 x 758 x 152 bins: past 2^23
    "auto_dense_mxu": ({}, 0.06, BOUNDS, N - 8),  # a buffer off the 128 grid
    "auto_dense_scatter": ({}, 0.02, BOUNDS, N - 8),  # 227 x 191 x 39 bins: past 2^19
}


def _cloud(seed: int, n: int):
    """Points in the box, half of them clumped (runs of hundreds), the rest
    mostly alone in their voxels; some coordinates -0.0, some points on a
    voxel corner, 10% invalid with NaN coordinates."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(BOUNDS[0], np.float32), np.array(BOUNDS[1], np.float32)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    centres = pts[rng.integers(0, 64, n // 2)]
    pts[: n // 2] = np.clip(centres + rng.normal(0, 0.01, (n // 2, 3)), lo, hi)
    pts[rng.random(n) < 0.05, 0] = -0.0
    pts[rng.random(n) < 0.05, 1] = -0.0
    pts[rng.random(n) < 0.05, 2] = -0.0
    corner = rng.random(n) < 0.02
    pts[corner] = (np.floor(pts[corner] / np.float32(0.06)) * np.float32(0.06)).astype(np.float32)
    valid = rng.random(n) < 0.9
    pts[~valid] = np.nan
    return pts.astype(np.float32), valid


@functools.lru_cache(maxsize=None)
def _ref_partials_fn(name: str):
    kw, leaf, bounds, _ = ENGINES[name]
    return jax.jit(lambda c: ref_voxel.voxel_partials(c, leaf, CAP, bounds, **kw))


def _port_partials(name: str, pts, valid):
    kw, leaf, bounds, _ = ENGINES[name]
    return voxel.voxel_partials(Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)), leaf,
                                CAP, bounds, **kw)


@pytest.fixture
def fold_spy(monkeypatch):
    """Every call the voxel engines make to ``segment_fold``, each checked
    against the kernel's contract (within a scan, dest mapped to [-1,
    bins] is non-decreasing) as it is made: a list of ``(bins, any dest
    past bins)``, one entry a call."""
    seen = []

    def spy(dest, vals, bins, **kw):
        assert meets_contract(dest, bins), "segment_fold: dest breaks the kernel's contract"
        seen.append((bins, bool((dest >= bins).any())))
        return segment_fold(dest, vals, bins, **kw)

    monkeypatch.setattr(voxel, "segment_fold", spy)
    monkeypatch.setattr(histogram, "segment_fold", spy)
    return seen


def _seq_fold(dest, vals, bins):
    """A sequential float32 fold in row order, one scan: numpy's
    ``add.at`` adds its rows one after another."""
    out = np.zeros((vals.shape[0], bins), np.float32)
    keep = (dest >= 0) & (dest < bins)
    for c in range(vals.shape[0]):
        np.add.at(out[c], dest[keep], vals[c, keep])
    return out


@pytest.mark.parametrize("sort", [True, False])
def test_segment_fold_plain_is_a_sequential_fold(sort):
    """The plain version folds each bin's rows in input order, from +0.0 (a
    lone -0.0 comes out +0.0), over a batch of two scans, rows out of range
    dropped; values spread over 10^-6 to 10^3, where the order shows.
    Unsorted rows break the contract and are refused; folded through their
    stable sort's permutation (``order``) they give the fold in input
    order."""
    rng = np.random.default_rng(7)
    scans, n, bins = 2, 20_000, 300
    dest = rng.integers(-5, bins + 5, (scans, n)).astype(np.int32)
    if sort:
        dest = np.sort(dest, axis=-1)
    vals = (rng.standard_normal((scans, 3, n)) * 10.0 ** rng.uniform(-6, 3, (scans, 3, n)))
    vals = vals.astype(np.float32)
    vals[0, :, dest[0] == 7] = -0.0
    if sort:
        got = segment_fold(torch.tensor(dest), torch.tensor(vals), bins).numpy()
    else:
        with pytest.raises(ValueError, match="non-decreasing"):
            segment_fold(torch.tensor(dest), torch.tensor(vals), bins)
        perm = np.argsort(dest, axis=-1, kind="stable")
        got = segment_fold(torch.tensor(np.take_along_axis(dest, perm, -1)), torch.tensor(vals),
                           bins, order=torch.tensor(perm)).numpy()
    for b in range(scans):
        want = _seq_fold(dest[b], vals[b], bins)
        np.testing.assert_array_equal(got[b].view(np.int32), want.view(np.int32))
    assert (got[0, :, 7].view(np.int32) == 0).all()  # +0.0
    if sort:
        np.testing.assert_array_equal(
            segment_fold_plain(torch.tensor(dest[0]), torch.tensor(vals[0]), bins).numpy(),
            got[0])


def test_segment_fold_refuses_bad_operands():
    with pytest.raises(ValueError, match="1 to 8"):
        segment_fold(torch.zeros(4, dtype=torch.int32), torch.zeros(9, 4), 3)
    with pytest.raises(ValueError, match="same leading dims"):
        segment_fold(torch.zeros(5, dtype=torch.int32), torch.zeros(2, 4), 3)
    d, v = torch.zeros(4, dtype=torch.int32), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="order"):
        segment_fold(d, v, 3, order=torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="bf16_terms"):
        segment_fold(d, v, 3, bf16_terms=3)
    with pytest.raises(ValueError, match="width"):
        segment_fold(d, v, 3, width=2)


def _bf16_terms(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """The ``mxu`` engine's split terms as its callers wrote them out."""
    if terms == 0:
        return [x]
    t0 = x.to(torch.bfloat16).to(torch.float32)
    return [t0] if terms == 1 else [t0, (x - t0).to(torch.bfloat16).to(torch.float32)]


@pytest.mark.parametrize("c", range(1, 9))
@pytest.mark.parametrize("terms", [0, 1, 2])
def test_segment_fold_plain_options_equal_the_unfused_composition(c, terms):
    """``order``, ``bf16_terms`` and ``width`` against the composition the
    callers made before the fold took them in: the split terms, each
    term's rows gathered by the sort's permutation, a sequential fold a
    term (numpy's ``add.at``), the terms' float32 add, the bins padded to
    ``width``; a batch of three scans over a [S, N, C] buffer read through
    its transpose, keys out of range at both ends, long runs, -0.0 values.
    Odd C pass the permutation, even C the rows already in sorted order."""
    rng = np.random.default_rng(10 * c + terms)
    scans, n, bins, width = 3, 4000, 500, 512
    keys = rng.integers(-4, bins + 4, (scans, n))
    keys[:, : n // 3] = rng.integers(0, 40, (scans, n // 3))  # runs of ~30 rows
    perm = np.argsort(keys, axis=-1, kind="stable")
    dest = np.take_along_axis(keys, perm, -1).astype(np.int32)
    buf = (rng.standard_normal((scans, n, c)) * 10.0 ** rng.uniform(-6, 3, (scans, n, c)))
    buf = buf.astype(np.float32)
    buf[rng.random((scans, n)) < 0.02] = -0.0
    ordered = c % 2 == 1
    rows = buf if ordered else np.take_along_axis(buf, perm[..., None], 1)
    got = segment_fold_plain(torch.tensor(dest), torch.tensor(rows).transpose(-1, -2), bins,
                             order=torch.tensor(perm) if ordered else None, bf16_terms=terms,
                             width=width)
    assert got.shape == (scans, c, width)
    for s in range(scans):
        acc = None
        for t in _bf16_terms(torch.tensor(buf[s]), terms):
            part = _seq_fold(dest[s], t.numpy()[perm[s]].T, bins)
            acc = part if acc is None else acc + part
        want = np.zeros((c, width), np.float32)
        want[:, :bins] = acc
        np.testing.assert_array_equal(got[s].numpy().view(np.int32), want.view(np.int32))


def test_lexsort3_is_lax_sort_order():
    """Three stable sorts, least significant key first, give ``lax.sort``'s
    stable 3-key order on keys with many duplicates."""
    rng = np.random.default_rng(3)
    k = rng.integers(-3, 4, (3, 5000)).astype(np.int32)
    k[:, :50] = np.iinfo(np.int32).max
    want = lax.sort((*map(jnp.asarray, k), jnp.arange(5000)), num_keys=3, is_stable=True)[3]
    got = voxel._lexsort3(*map(torch.tensor, k))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_partials_bitwise_equal_reference(name, seed, fold_spy):
    """Every engine's partials bitwise the reference's; each fold call's
    dest meets the kernel's contract (the fine leaf's overflowing segments
    included), one fold call a run of a dense engine or the fallback."""
    n = ENGINES[name][3]
    pts, valid = _cloud(seed, n)
    want = _ref_partials_fn(name)(RCloud.from_points(pts, valid))
    got = _port_partials(name, pts, valid)
    _assert_partials_equal(want, got)
    assert int(got.num_voxels) > 100
    assert len(fold_spy) == (0 if "morton" in name else 1)
    if name == "fallback_fine_leaf":  # segments past the capacity, dropped
        assert bool(got.overflow) and fold_spy[0][1]


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_batch_equals_single_scans(name, fold_spy):
    """Each engine over a batch of three scans (one sort and one fold or
    K1 call for the batch, the fold's dest within the kernel's contract)
    equals its runs on each scan alone."""
    n = ENGINES[name][3]
    clouds = [_cloud(10 + b, n) for b in range(3)]
    batch = _port_partials(name, np.stack([c[0] for c in clouds]), np.stack([c[1] for c in clouds]))
    assert len(fold_spy) == (0 if "morton" in name else 1)
    for b, (pts, valid) in enumerate(clouds):
        single = _port_partials(name, pts, valid)
        for f in ("keys", "sums", "counts", "num_voxels", "overflow"):
            np.testing.assert_array_equal(getattr(batch, f)[b].numpy(),
                                          getattr(single, f).numpy(), err_msg=f)


def _tables(leaf, bounds, seed):
    """Four shards' reference partial tables of one cloud, concatenated."""
    pts, valid = _cloud(seed, 4 * 2048)
    t = jax.jit(jax.vmap(lambda p, v: ref_voxel.voxel_partials(
        RCloud(points=p, valid=v), leaf, 1024, bounds)))(
        jnp.asarray(pts).reshape(4, -1, 3), jnp.asarray(valid).reshape(4, -1))
    return [np.asarray(getattr(t, f)).reshape(-1, *getattr(t, f).shape[2:])
            for f in ("keys", "sums", "counts")]


@pytest.mark.parametrize("leaf,bounds", [(0.06, None), (0.005, BOUNDS)])
def test_three_key_merge_bitwise_equals_reference(leaf, bounds):
    """``merge_voxel_partials`` without packable bounds: the reference's
    3-key sort merge, bitwise; a batch of two merges equals each alone."""
    cat = _tables(leaf, bounds, 5)
    want = jax.jit(lambda k, s, c: ref_voxel.merge_voxel_partials(
        ref_voxel.VoxelPartials(k, s, c, 0, False), 2048, bounds=bounds, leaf_size=leaf))(
        *map(jnp.asarray, cat))
    parts = voxel.VoxelPartials(*map(torch.tensor, cat), torch.tensor(0), torch.tensor(False))
    got = voxel.merge_voxel_partials(parts, 2048, bounds=bounds, leaf_size=leaf)
    _assert_partials_equal(want, got)
    other = _tables(leaf, bounds, 6)
    two = voxel.VoxelPartials(*[torch.tensor(np.stack([a, b])) for a, b in zip(cat, other)],
                              torch.tensor(0), torch.tensor(False))
    _assert_partials_equal(want, voxel.merge_voxel_partials(two, 2048, bounds, leaf), scan=0)


# the reference's refusals: (config overrides for voxel_partials, leaf, bounds, buffer)
REFUSALS = {
    "sort_unpackable": (dict(binning="sort"), 0.06, None, N),
    "sort_unaligned": (dict(binning="sort"), 0.06, BOUNDS, N - 8),
    "packing_dense": (dict(binning="scatter", payload_packing=True), 0.06, BOUNDS, N),
    "packing_unaligned": (dict(payload_packing=True), 0.06, BOUNDS, N - 8),
    "morton_dense": (dict(binning="mxu", order="morton"), 0.06, BOUNDS, N),
    "morton_unpackable": (dict(order="morton"), 0.06, None, N),
    # 257 x 257 x 65 bins: packable, but 9 + 9 + 7 = 25 key bits
    "morton_wide": (dict(order="morton"), 0.5, ((0.0, 0.0, 0.0), (127.5, 127.5, 31.5)), N),
    "unknown_engine": (dict(binning="radix"), 0.06, BOUNDS, N - 8),
    "scatter_unpackable": (dict(binning="scatter"), 0.06, None, N),
    "mxu_unpackable": (dict(binning="mxu"), 0.005, BOUNDS, N),
    "mxu_too_many_bins": (dict(binning="mxu"), 0.02, BOUNDS, N),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_voxel_partials_refuses_as_the_reference(name):
    kw, leaf, bounds, n = REFUSALS[name]
    pts, valid = _cloud(0, n)
    with pytest.raises(ValueError) as want:
        ref_voxel.voxel_partials(RCloud.from_points(pts, valid), leaf, CAP, bounds, **kw)
    with pytest.raises(ValueError) as got:
        voxel.voxel_partials(Cloud.from_points(pts, valid), leaf, CAP, bounds, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override", [
    dict(voxel_binning="mxu"), dict(voxel_binning="scatter"), dict(voxel_order="morton"),
    dict(voxel_binning="radix"), dict(voxel_order="hilbert"),
    dict(voxel_binning="mxu", voxel_order="morton"),
    dict(voxel_binning="scatter", voxel_payload_packing=True),
    dict(voxel_binning="sort", voxel_order="morton", voxel_payload_packing=True),
    dict(max_voxels=2044), dict(max_voxels=2040, voxel_binning="mxu"),
])
def test_validate_raises_where_the_reference_does(override):
    base = dataclasses.asdict(ref.REFERENCE_YAML_CONFIG)
    a, b = ref.PipelineConfig(**{**base, **override}), port.PipelineConfig(**{**base, **override})
    try:
        a.validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            b.validate()
        assert str(got.value) == str(e)
    else:
        b.validate()


@pytest.mark.parametrize("n,cap,batch", [(1000, 512, 1), (1000, None, 1), (4000, 2040, 3),
                                         (8192, 2040, 1)])
def test_compact_off_the_128_grid_bitwise_equals_reference(n, cap, batch):
    """``compact`` of a cloud whose capacity is off the 128 grid (the rank
    scatter), or into such a capacity: bitwise the reference's; a batch
    equals each scan alone."""
    rng = np.random.default_rng(n)
    pts = rng.standard_normal((batch, n, 3)).astype(np.float32)
    valid = rng.random((batch, n)) < 0.7
    pts[~valid] = np.nan
    got = compaction.compact(Cloud(points=torch.tensor(pts), valid=torch.tensor(valid)), cap)
    for b in range(batch):
        want = jax.jit(lambda c: ref_compaction.compact(c, cap))(
            RCloud.from_points(pts[b], valid[b]))
        for f in ("count", "source_index", "overflow"):
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          getattr(got, f)[b].numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(want.cloud.valid), got.cloud.valid[b].numpy())
        np.testing.assert_array_equal(np.asarray(want.cloud.points), got.cloud.points[b].numpy())


@pytest.mark.parametrize("k,exact,hi", [(5000, True, None), (5000, False, None),
                                        (230_000, True, None), (1000, True, 64)])
def test_weighted_histogram_mxu_equals_reference(k, exact, hi):
    """The in-order fold of the split terms against the reference's one-hot
    products: bitwise wherever XLA:CPU's product sums a bin's terms
    exactly, which here is every bin channel but at most one in a thousand
    (the weights span the whole leaf, a bin takes up to ~90 rows; where a
    bin's float32 sum rounds, the product's blocked order and the fold's
    row order may part by an ulp), and every bin within the float32
    reordering bound; counts bitwise.  The voxel engine's own partials are
    bitwise (``test_engine_partials_bitwise_equal_reference``)."""
    from pointcloud_obstacle_processing_tpu_torch.ops.binning import reordering_bound

    rng = np.random.default_rng(k)
    n = 6000
    ids = rng.integers(-10, k + 10, n).astype(np.int32)
    ids[: n // 2] = ids[rng.integers(0, 50, n // 2)]  # bins of many rows
    w = rng.uniform(0.0, 0.06, (n, 4)).astype(np.float32)
    w[:, 3] = 1.0
    valid = rng.random(n) < 0.9
    want = np.asarray(jax.jit(lambda i, x, v: ref_mxu.weighted_histogram_mxu(
        i, x, v, k, hi, exact))(ids, w, valid))
    got = histogram.weighted_histogram_mxu(torch.tensor(ids), torch.tensor(w),
                                           torch.tensor(valid), k, hi, exact).numpy()
    np.testing.assert_array_equal(want[:, 3], got[:, 3])
    bound = reordering_bound(torch.tensor(ids), torch.tensor(w), torch.tensor(valid), k,
                             exact).numpy()
    assert (np.abs(want.astype(np.float64) - got) <= bound).all()
    differ = int((want != got).sum())
    print(f"weighted_histogram_mxu k={k} exact={exact}: {differ} of {want.size} bin channels "
          "differ from the reference's one-hot products")
    assert differ <= want.size // 1000
    blocks, a, b = histogram.weighted_histogram_blocks(
        torch.tensor(np.stack([ids, ids])), torch.tensor(np.stack([w, w])),
        torch.tensor(np.stack([valid, valid])), k, hi, exact)
    assert (a, b) == (ref_mxu.weighted_histogram_blocks(ids, w, valid, k, hi, exact)[1:])
    np.testing.assert_array_equal(blocks[1].reshape(4, -1).T[:k].numpy(), got)


def test_histogram2d_mxu_equals_reference():
    rng = np.random.default_rng(4)
    r, c = rng.integers(-2, 42, 9000), rng.integers(-2, 38, 9000)
    valid = rng.random(9000) < 0.8
    want = ref_mxu.histogram2d_mxu(jnp.asarray(r), jnp.asarray(c), jnp.asarray(valid), 40, 36)
    got = histogram.histogram2d_mxu(torch.tensor(r), torch.tensor(c), torch.tensor(valid), 40, 36)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("a,b,terms", [(40, 128, 2), (40, 128, (1, 2, 3, 2)), (30, 96, 1),
                                       (8200, 128, 2)])
def test_compact_and_gather_blocks_bitwise_equals_reference(a, b, terms):
    """The reference's one-hot compaction with values: exact gathers of the
    split terms up to 8,192 block rows, raw values above."""
    rng = np.random.default_rng(a)
    occ = rng.random((a, b)) < 0.05
    bins = (rng.standard_normal((4, a * b)) * occ.reshape(1, -1)).astype(np.float32)
    bins[0, np.flatnonzero(occ.reshape(-1))[:5]] = -0.0
    cap = 256
    want = jax.jit(lambda x, o: ref_mxu.compact_and_gather_blocks(x, o, cap, terms))(bins, occ)
    got = histogram.compact_and_gather_blocks(torch.tensor(bins), torch.tensor(occ), cap, terms)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_leftovers_bitwise_equal_reference():
    """``passthrough_mask``, ``euclidean_distance`` (the jitted reference's
    unfused sum of squares) and ``hypotheses_for_confidence``; the
    reference's ``ops`` names are exported."""
    rng = np.random.default_rng(9)
    p1, p2 = (rng.standard_normal((20000, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax.jit(ref_filters.euclidean_distance)(p1, p2))
    got = filters.euclidean_distance(torch.tensor(p1), torch.tensor(p2)).numpy()
    d = p2 - p1
    sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]  # numpy fuses nothing
    np.testing.assert_array_equal(got, np.sqrt(sq.astype(np.float64)).astype(np.float32))
    # the jitted reference gives this form in every run alone; in some runs
    # of the whole file it has differed on one element of the 20,000 by an
    # ulp (a different element each time; ROADMAP C)
    differ = int((want != got).sum())
    print(f"euclidean_distance: {differ} of {want.size} differ from the jitted reference")
    assert differ <= 2
    np.testing.assert_array_max_ulp(want, got, maxulp=1)
    for axis in ("x", "y", "z"):
        np.testing.assert_array_equal(
            np.asarray(ref_filters.passthrough_mask(jnp.asarray(p1), axis, -0.5, 0.7)),
            filters.passthrough_mask(torch.tensor(p1), axis, -0.5, 0.7).numpy())
    for w in (0.05, 0.15, 0.33, 0.5, 0.9, 1.0, 1.5):
        for conf in (0.9, 0.99, 0.999, 1.0):
            assert ransac.hypotheses_for_confidence(w, conf) == \
                ref_ransac.hypotheses_for_confidence(w, conf), (w, conf)
    for fn in (ransac.hypotheses_for_confidence, ref_ransac.hypotheses_for_confidence):
        with pytest.raises(ZeroDivisionError):  # 1 - 1e-18 rounds to 1: both divide by 0
            fn(0.0)
    assert ransac.hypotheses_for_confidence(0.15, multiple_of=8) == \
        ref_ransac.hypotheses_for_confidence(0.15, multiple_of=8)
    names = [n for n in dir(ref_ops) if not n.startswith("_") and callable(getattr(ref_ops, n))]
    assert names and all(callable(getattr(port_ops, n, None)) for n in names), names
