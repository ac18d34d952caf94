"""The voxel-table merges of the point-sharded path: K1's counts mode, both
engines of ``merge_voxel_partials_packed``, ``merge_voxel_partials`` and
the key-range ``_distributed_merge`` of the PyTorch port against the JAX
package's, bitwise (keys, sums, counts, ``num_voxels`` and the overflow
flags), on the 8-virtual-device CPU mesh that ``tests/conftest.py`` sets
up for the reference and on spawned gloo ranks for the port.  Also the
replay of the reference's RANSAC draws from their random bits, which the
port's ranks use.

The ranks are spawned once for the module (``parallel.ranks.spawn``, 8
ranks, every merge job in one group), with a timeout on the process group
and on the join."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_sharding import SHARD_CFG, _batch, _voxel_grid_points

from pointcloud_obstacle_processing_tpu import Cloud as RCloud
from pointcloud_obstacle_processing_tpu.ops import pallas_runreduce as ref_rr
from pointcloud_obstacle_processing_tpu.ops import voxel as ref_voxel
from pointcloud_obstacle_processing_tpu.parallel.sharding import _distributed_merge, make_mesh

from pointcloud_obstacle_processing_tpu_torch.config import PipelineConfig
from pointcloud_obstacle_processing_tpu_torch.ops import runreduce, voxel
from pointcloud_obstacle_processing_tpu_torch.ops.ransac import draw_from_bits
from pointcloud_obstacle_processing_tpu_torch.parallel import ranks

WORLD = 8
TIMEOUT_S = 240.0
MERGE_CFG = SHARD_CFG.replace(max_voxels=4096)  # the reference's merge test: no overflow
OVER_CFG = SHARD_CFG.replace(max_voxels=512)  # chunk_cap = range_cap = 128 at S = 8


def _port_cfg(cfg) -> PipelineConfig:
    return PipelineConfig(**dataclasses.asdict(cfg))


def _bounds(cfg):
    return ((cfg.x_min, cfg.y_min, cfg.z_min), (cfg.x_max, cfg.y_max, cfg.z_max))


def _chunk_overflow_points(cfg):
    """Every shard's 180 voxels in one key range (> chunk_cap rows): the
    reference's ``test_distributed_merge_chunk_overflow_is_observable``."""
    leaf = cfg.downsample_leaf_size
    n = cfg.max_points // 8
    pts = np.zeros((8, n, 3), np.float32)
    valid = np.zeros((8, n), bool)
    for s in range(8):
        p = _voxel_grid_points(cfg, n_y=30, n_z=6, x=leaf / 2)
        pts[s, : len(p)] = p
        valid[s, : len(p)] = True
    return pts.reshape(-1, 3), valid.reshape(-1)


def _range_overflow_points(cfg):
    """8 shards x 28 disjoint voxels of one key range: each chunk fits, the
    union (224 rows) overflows the range (the reference's
    ``test_distributed_merge_range_overflow_is_observable``)."""
    leaf = cfg.downsample_leaf_size
    n = cfg.max_points // 8
    pts = np.zeros((8, n, 3), np.float32)
    valid = np.zeros((8, n), bool)
    for s in range(8):
        p = _voxel_grid_points(cfg, n_y=4, n_z=7, x=leaf / 2, y0=s * 4 * leaf)
        pts[s, : len(p)] = p
        valid[s, : len(p)] = True
    return pts.reshape(-1, 3), valid.reshape(-1)


def _scene_points(seed0: int):
    clouds = _batch(1, seed0=seed0)
    return np.asarray(clouds.points[0]), np.asarray(clouds.valid[0])


# (name, config, shards, points)
MERGE_CASES = {
    "scene_s4": (MERGE_CFG, 4, lambda: _scene_points(6)),
    "scene_s8": (MERGE_CFG, 8, lambda: _scene_points(6)),
    "chunk_overflow_s8": (OVER_CFG, 8, lambda: _chunk_overflow_points(OVER_CFG)),
    "range_overflow_s8": (OVER_CFG, 8, lambda: _range_overflow_points(OVER_CFG)),
}


@pytest.fixture(scope="module")
def port_merges(tmp_path_factory):
    """Every merge case on the port's gloo ranks, in one spawn: {name: the
    rank outputs}."""
    jobs = []
    for cfg, shards, make in MERGE_CASES.values():
        pts, valid = make()
        jobs.append(dict(kind="merge", config=_port_cfg(cfg), mesh={"points": shards},
                         points=pts, valid=valid))
    out = ranks.spawn(ranks.run_jobs, WORLD, jobs, timeout_s=TIMEOUT_S,
                      tmp_dir=str(tmp_path_factory.mktemp("ranks")))
    return {name: [r[j] for r in out if r[j] is not None]
            for j, name in enumerate(MERGE_CASES)}


@functools.cache
def _ref_merges(name: str):
    """The reference's distributed merge (shard_map over the first S CPU
    devices) and its replicated merge of the gathered shard tables."""
    cfg, shards, make = MERGE_CASES[name]
    pts, valid = make()
    bounds = _bounds(cfg)
    pts = jnp.asarray(pts).reshape(shards, -1, 3)
    valid = jnp.asarray(valid).reshape(shards, -1)

    def local_parts(p, v):
        return ref_voxel.voxel_partials(RCloud(points=p, valid=v), cfg.downsample_leaf_size,
                                        cfg.max_voxels, bounds)

    mesh = make_mesh({"points": shards}, devices=jax.devices()[:shards])
    dist = jax.jit(jax.shard_map(
        lambda p, v: _distributed_merge(local_parts(p[0], v[0]), cfg, "points", shards),
        mesh=mesh, in_specs=(P("points"), P("points")), out_specs=P(), check_vma=False,
    ))(pts, valid)
    sp = jax.jit(jax.vmap(local_parts))(pts, valid)
    gathered = ref_voxel.VoxelPartials(
        keys=sp.keys.reshape(-1, 3), sums=sp.sums.reshape(-1, 3),
        counts=sp.counts.reshape(-1), num_voxels=sp.num_voxels[0], overflow=sp.overflow[0])
    rep = jax.jit(lambda g: ref_voxel.merge_voxel_partials(
        g, cfg.max_voxels, bounds=bounds, leaf_size=cfg.downsample_leaf_size))(gathered)
    return dist, rep


def _assert_partials_equal(ref, port, scan=None):
    for f in ("keys", "sums", "counts", "num_voxels", "overflow"):
        got = getattr(port, f)
        got = (got if scan is None else got[scan]).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), got, err_msg=f)


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_distributed_merge_matches_reference(port_merges, name):
    """Every rank's ``_distributed_merge`` equals the reference's bitwise,
    the overflow flags included (the reference's chunk and range overflow
    tests, :499-560), and so does the replicated merge of the gathered
    tables; where nothing overflows the two merges agree on keys, counts
    and ``num_voxels`` exactly and on sums within the reference's own
    tolerance."""
    dist_ref, rep_ref = _ref_merges(name)
    outs = port_merges[name]
    assert len(outs) == MERGE_CASES[name][1]
    for o in outs:
        _assert_partials_equal(dist_ref, o["out"]["distributed"], 0)
        _assert_partials_equal(rep_ref, o["out"]["replicated"], 0)
    d, r = outs[0]["out"]["distributed"], outs[0]["out"]["replicated"]
    if name.startswith("scene"):
        assert not bool(d.overflow[0])
        n = int(r.num_voxels[0])
        assert int(d.num_voxels[0]) == n
        np.testing.assert_array_equal(d.keys[0, :n].numpy(), r.keys[0, :n].numpy())
        np.testing.assert_array_equal(d.counts[0, :n].numpy(), r.counts[0, :n].numpy())
        np.testing.assert_allclose(d.sums[0, :n].numpy(), r.sums[0, :n].numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert bool(d.overflow[0]), f"{name}: the distributed merge must raise its flag"
        assert not bool(r.overflow[0])  # the table itself fits


def test_merge_ranks_report_their_collectives(port_merges):
    """One all_to_all, two all_gathers (tables, counts) and two ORs for the
    distributed merge, three gathers for the replicated one: the counts
    each rank reports, and gloo moving CPU tensors without staging."""
    for o in port_merges["scene_s4"]:
        assert o["backend"] == "gloo" and o["staging"] == "pinned host"
        assert o["collectives"]["calls"] == 8
        assert o["collectives"]["host_reads"] == 0  # CPU tensors: nothing staged
        assert o["launches"]["runreduce_counts"] == 0  # the plain version on the CPU


def _tables(rng, shards: int, rows: int, n_real: int, K: int):
    """Per-shard voxel tables as the shards emit them: unique packed keys in
    ascending order, then empty rows (sentinel K, zero sums and counts)."""
    packed = np.full((shards, rows), K, np.int32)
    sums = np.zeros((shards, rows, 3), np.float32)
    counts = np.zeros((shards, rows), np.float32)
    for s in range(shards):
        keys = np.sort(rng.choice(K, n_real, replace=False))
        packed[s, :n_real] = keys
        counts[s, :n_real] = rng.integers(1, 40, n_real)
        sums[s, :n_real] = rng.uniform(0.0, 3.0, (n_real, 3)) * counts[s, :n_real, None]
    return packed.reshape(-1), sums.reshape(-1, 3), counts.reshape(-1)


@pytest.mark.parametrize("engine,shards,rows,n_real,capacity", [
    ("dense", 4, 2048, 1500, 4096),
    ("sort", 4, 131_072, 100_000, 262_144),  # 524,288 rows >= 2^19: the sort engine
])
def test_merge_packed_engines_match_reference(engine, shards, rows, n_real, capacity):
    """``merge_voxel_partials_packed`` bitwise against the reference's, on
    gathered tables of either size: the dense merge's in-order scatter-add
    (shard after shard) and its unfused corner products, the sort merge's
    stable sort and K1's counts mode."""
    bounds = _bounds(SHARD_CFG)
    leaf = 0.04 if engine == "sort" else SHARD_CFG.downsample_leaf_size
    spec = ref_voxel._pack_spec(bounds, leaf)
    K = spec[1][0] * spec[1][1] * spec[1][2]
    packed, sums, counts = _tables(np.random.default_rng(3), shards, rows, n_real, K)
    want = jax.jit(lambda p, s, c: ref_voxel.merge_voxel_partials_packed(
        p, s, c, capacity, spec, leaf))(packed, sums, counts)
    got = voxel.merge_voxel_partials_packed(
        torch.tensor(packed), torch.tensor(sums), torch.tensor(counts), capacity,
        voxel._pack_spec(bounds, leaf), leaf, tables=shards)
    _assert_partials_equal(want, got)
    assert int(got.num_voxels) > 0


def test_merge_voxel_partials_packs_triple_keys_and_refuses_unbounded():
    """``merge_voxel_partials`` on (ix, iy, iz) keys equals the reference's;
    without bounds it takes the reference's 3-key sort fallback, bitwise
    too."""
    cfg = MERGE_CFG
    bounds = _bounds(cfg)
    pts, valid = _scene_points(6)
    tables = jax.jit(jax.vmap(lambda p, v: ref_voxel.voxel_partials(
        RCloud(points=p, valid=v), cfg.downsample_leaf_size, cfg.max_voxels, bounds)))(
        jnp.asarray(pts).reshape(4, -1, 3), jnp.asarray(valid).reshape(4, -1))
    cat = [np.asarray(getattr(tables, f)).reshape(-1, *getattr(tables, f).shape[2:])
           for f in ("keys", "sums", "counts")]
    want = jax.jit(lambda k, s, c: ref_voxel.merge_voxel_partials(
        ref_voxel.VoxelPartials(k, s, c, 0, False), cfg.max_voxels, bounds=bounds,
        leaf_size=cfg.downsample_leaf_size))(*map(jnp.asarray, cat))
    parts = voxel.VoxelPartials(*map(torch.tensor, cat), torch.tensor(0), torch.tensor(False))
    got = voxel.merge_voxel_partials(parts, cfg.max_voxels, bounds=bounds,
                                     leaf_size=cfg.downsample_leaf_size, tables=4)
    _assert_partials_equal(want, got)
    want = jax.jit(lambda k, s, c: ref_voxel.merge_voxel_partials(
        ref_voxel.VoxelPartials(k, s, c, 0, False), cfg.max_voxels))(*map(jnp.asarray, cat))
    _assert_partials_equal(want, voxel.merge_voxel_partials(parts, cfg.max_voxels))


def _k1_inputs(rng, b: int, n: int, n_keys: int, fractional: bool):
    sentinel = 1 << 20
    skey = np.full((b, n), sentinel, np.int32)
    for i in range(b):
        n_valid = n - 300 * (i + 1)
        skey[i, :n_valid] = np.sort(rng.choice(np.sort(rng.choice(sentinel, n_keys,
                                                                   replace=False)), n_valid))
    offs = [rng.standard_normal((b, n)).astype(np.float32) for _ in range(3)]
    cnt = rng.integers(1, 50, (b, n)).astype(np.float32)
    if fractional:  # not integer-valued: the count channel's add order shows
        cnt = cnt * np.float32(0.37)
    return skey, offs, cnt, sentinel


@pytest.mark.parametrize("n,n_keys,fractional", [
    (8192, 900, False),  # windows of 1,024 rows: runs span windows
    (8192, 60, True),
    (1024, 200, True),
])
def test_k1_counts_mode_plain_matches_reference(n, n_keys, fractional):
    """K1's counts mode (a fourth buffer of per-row counts): the plain
    version on a batch of two buffers equals the reference's
    ``sorted_run_reduce`` with four buffers (its XLA twin of the Pallas
    kernel) on each buffer, bitwise."""
    skey, offs, cnt, sentinel = _k1_inputs(np.random.default_rng(n + n_keys), 2, n, n_keys,
                                           fractional)
    cap = n_keys + 64
    vals, num = runreduce.sorted_run_reduce(
        torch.tensor(skey), [torch.tensor(o) for o in offs] + [torch.tensor(cnt)], sentinel, cap)
    ref = jax.jit(lambda k, *bufs: ref_rr.sorted_run_reduce(k, bufs, sentinel, cap,
                                                           use_pallas=False))
    for b in range(2):
        wv, wn = ref(skey[b], *(o[b] for o in offs), cnt[b])
        assert int(num[b]) == int(wn)
        k = min(int(wn), cap)
        np.testing.assert_array_equal(np.asarray(wv)[:k], vals[b, :k].numpy())


def test_k1_counts_mode_with_unit_counts_is_the_three_buffer_form():
    """All-ones counts give the three-buffer result bit for bit (the
    reference's contract, pallas_runreduce.py:981-983), in the port and
    against the reference's three-buffer call."""
    skey, offs, _, sentinel = _k1_inputs(np.random.default_rng(9), 2, 8192, 700, False)
    t = [torch.tensor(o) for o in offs]
    ones = torch.ones(skey.shape, dtype=torch.float32)
    v4, n4 = runreduce.sorted_run_reduce(torch.tensor(skey), t + [ones], sentinel, 800)
    v3, n3 = runreduce.sorted_run_reduce(torch.tensor(skey), t, sentinel, 800)
    assert torch.equal(n4, n3)
    for b in range(2):
        k = min(int(n3[b]), 800)
        assert torch.equal(v4[b, :k], v3[b, :k])
        wv, _ = jax.jit(lambda k, *bufs: ref_rr.sorted_run_reduce(
            k, bufs, sentinel, 800, use_pallas=False))(skey[b], *(o[b] for o in offs))
        np.testing.assert_array_equal(np.asarray(wv)[:k], v4[b, :k].numpy())


def jax_draw_bits(keys, rounds: int, hypotheses: int):
    """[B, rounds, K, 3] high and low random words of the reference's
    per-round ``randint`` draws from each scan's key chain (``segment_planes``
    splits the key once a round), as int64."""
    hi = np.zeros((len(keys), rounds, hypotheses, 3), np.int64)
    lo = np.zeros_like(hi)
    for b, key in enumerate(keys):
        k = key
        for r in range(rounds):
            k, sub = jax.random.split(k)
            k1, k2 = jax.random.split(sub)
            hi[b, r] = np.asarray(jax.random.bits(k1, (hypotheses, 3), jnp.uint32))
            lo[b, r] = np.asarray(jax.random.bits(k2, (hypotheses, 3), jnp.uint32))
    return hi, lo


def test_draw_from_bits_replays_jax_randint():
    """The draws the port's ranks replay from the random words equal the
    reference's ``jax.random.randint`` chain for every count tried."""
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    hi, lo = jax_draw_bits(keys, 4, 128)
    draw = draw_from_bits(torch.tensor(hi), torch.tensor(lo))
    for n_valid in (0, 1, 2, 3, 7, 1000, 2048, 65535, 65536, 65537, 300_001):
        got = draw(2, torch.tensor([n_valid, n_valid + 1]))
        for b in range(2):
            k = keys[b]
            for _ in range(3):
                k, sub = jax.random.split(k)
            want = jax.random.randint(sub, (128, 3), 0, max(n_valid + b, 1))
            np.testing.assert_array_equal(np.asarray(want), got[b].numpy())


def test_spawned_ranks_import_no_jax(tmp_path):
    """Ranks spawned from this process, which holds JAX and the JAX
    package, load neither."""
    assert "jax" in __import__("sys").modules
    out = ranks.spawn(ranks.foreign_modules, 2, timeout_s=TIMEOUT_S, tmp_dir=str(tmp_path))
    assert out == [[], []]
