"""The sharded find (both forms) and the sharded bloom union of the port
(parallel/find.py, parallel/bloom.py) over spawned gloo ranks on the
CPU, against the reference's shard_map programs on a mesh of the same
(dp, sp): block counts that do not split over the mesh, an id held by
two blocks (the higher wins the elected form), misses and empty inputs,
bit for bit; M1's plain version (the packed key) against the
reference's per-shard arithmetic; and the port's TempoDB, whose finds take the sharded route
on a mesh as the reference's do."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh_cases import SHAPE_IDS, SHAPES, start_mesh

from tempo_tpu.block.bloom import ShardedBloom as RBloom
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.parallel import sharded_bloom_union as r_union
from tempo_tpu.parallel import sharded_find as r_find
from tempo_tpu.parallel.find import sharded_find_rows as r_find_rows
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.ops.find import _find_elect_plain, decode_keys
from tempo_tpu_torch.parallel import sharded_bloom_union, sharded_find, sharded_find_rows

TENANT = "mesh-find"


@pytest.fixture(scope="module", params=SHAPES, ids=SHAPE_IDS)
def meshes(request, tmp_path_factory):
    yield from start_mesh(request.param, tmp_path_factory)


def _blocks(n_blocks: int, seed: int):
    """Sorted (Ti, 4) id-code arrays; block 1 shares an id with the last
    block, and queries take every 3rd id plus 4 misses."""
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(n_blocks):
        ids = rng.integers(-2**31, 2**31 - 1, (20 + 13 * b, 4), dtype=np.int64).astype(np.int32)
        blocks.append(ids)
    shared = blocks[min(1, n_blocks - 1)][3].copy()
    blocks[-1][0] = shared
    blocks = [np.unique(a, axis=0) for a in blocks]  # lexicographic, signed lanes
    every = np.concatenate(blocks)
    misses = rng.integers(-2**31, 2**31 - 1, (4, 4), dtype=np.int64).astype(np.int32)
    queries = np.concatenate([every[::3], shared[None], misses])
    return blocks, queries


@pytest.mark.parametrize("n_blocks", [1, 3, 5])
def test_sharded_find_rows_matches_reference(meshes, n_blocks):
    mesh, rmesh = meshes
    blocks, queries = _blocks(n_blocks, seed=n_blocks)
    got = sharded_find_rows(mesh, blocks, queries)
    want = np.asarray(r_find_rows(rmesh, blocks, queries))
    assert got.shape == (n_blocks, queries.shape[0]) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum(axis=0)[-5] == min(2, n_blocks)  # the shared id: both blocks report


@pytest.mark.parametrize("n_blocks", [3, 5])
def test_sharded_find_matches_reference(meshes, n_blocks):
    mesh, rmesh = meshes
    blocks, queries = _blocks(n_blocks, seed=10 + n_blocks)
    got = sharded_find(mesh, blocks, queries)
    want = np.asarray(r_find(rmesh, blocks, queries))
    np.testing.assert_array_equal(got, want)
    assert got[-5, 0] == n_blocks - 1  # the shared id: the higher block wins
    assert (got[-4:] == -1).all()  # misses are (-1, -1)


def test_empty_inputs(meshes):
    mesh, rmesh = meshes
    blocks, queries = _blocks(3, seed=3)
    for args in (([], queries), (blocks, queries[:0])):
        np.testing.assert_array_equal(sharded_find(mesh, *args), np.asarray(r_find(rmesh, *args)))
        np.testing.assert_array_equal(sharded_find_rows(mesh, *args),
                                      np.asarray(r_find_rows(rmesh, *args)))


def test_sharded_bloom_union_matches_reference(meshes):
    mesh, rmesh = meshes
    blooms, rblooms = [], []
    for k in range(5):
        ids = [bytes([k, i]) + b"\x00" * 14 for i in range(20)]
        b, rb = ShardedBloom(4), RBloom(4)
        b.add_many(ids)
        rb.add_many(ids)
        blooms.append(b)
        rblooms.append(rb)
    got = sharded_bloom_union(mesh, blooms)
    want = r_union(rmesh, rblooms)
    assert got.words.dtype == np.uint32
    np.testing.assert_array_equal(got.words, want.words)
    with pytest.raises(ValueError, match="geometry mismatch"):
        sharded_bloom_union(mesh, blooms + [ShardedBloom(2)])


def test_tempodb_finds_take_the_sharded_route(meshes, tmp_path):
    """Unbatched and batched finds of a port TempoDB on the mesh equal a
    reference TempoDB's on the same mesh shape, through sharded_find_rows."""
    mesh, rmesh = meshes
    path = str(tmp_path / "store")
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path}, batch_enabled=False,
                           wal_path=str(tmp_path / "wal")))
    ref._mesh = rmesh
    traces = [r_make_traces(25, seed=40 + i, n_spans=3) for i in range(3)]
    for batch in traces:
        ref.write_block(TENANT, batch)
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": path}, batch_enabled=False),
                   device="cpu")
    port.poll_now()
    assert port.mesh is mesh
    ids = [tid for batch in traces for tid, _ in batch[::6]] + [b"\x01" * 16]
    calls = []
    import tempo_tpu_torch.parallel.find as PF

    orig = PF.sharded_find_rows
    try:
        PF.sharded_find_rows = lambda *a: calls.append(1) or orig(*a)
        got = [port.find_trace_by_id(TENANT, t) for t in ids]
    finally:
        PF.sharded_find_rows = orig
    want = [ref.find_trace_by_id(TENANT, t) for t in ids]
    assert [None if g is None else dataclasses.asdict(g) for g in got] == \
        [None if w is None else dataclasses.asdict(w) for w in want]
    assert len(calls) == len(ids) - 1  # the absent id passes no bloom gate
    ref.close()


def test_find_elect_plain_matches_reference_arithmetic():
    """M1's plain version (the packed key a query, decoded) against
    tempo_tpu/parallel/find.py:44-64 run in jnp on one shard's rows (no
    collective: the shard is the mesh); and two shards' keys maxed (the
    all_reduce) against the reference's arithmetic over both shards'
    rows."""
    rng = np.random.default_rng(4)

    def reference(sids, base):
        gblock = base + jnp.arange(sids.shape[0], dtype=jnp.int32)[:, None]
        blk = jnp.where(sids >= 0, gblock, -1)
        best = jnp.max(blk, axis=0)
        row = jnp.max(jnp.where(blk == best[None, :], sids, -1), axis=0)
        return np.stack([np.asarray(best), np.asarray(row)], axis=-1)

    for bl, q, base in ((1, 5, 0), (3, 8, 6), (4, 16, 12)):
        sids = np.where(rng.random((bl, q)) < 0.4, rng.integers(0, 500, (bl, q)), -1)
        sids = sids.astype(np.int32)
        keys = _find_elect_plain(torch.from_numpy(sids), base)
        assert keys.dtype == torch.int64
        np.testing.assert_array_equal(decode_keys(keys.numpy()), reference(sids, base))
        # a second shard of blocks base + bl ..: its higher blocks win the max
        other = np.where(rng.random((2, q)) < 0.3, rng.integers(0, 500, (2, q)), -1)
        other = other.astype(np.int32)
        both = torch.maximum(keys, _find_elect_plain(torch.from_numpy(other), base + bl))
        np.testing.assert_array_equal(decode_keys(both.numpy()),
                                      reference(np.concatenate([sids, other]), base))
