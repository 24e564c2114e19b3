"""The stacked multi-block search and the composed query step of the port
over spawned gloo ranks on the CPU (a 2x2 mesh), against the reference on
a shard_map mesh of the same shape:

  * db/search.search_blocks_device over three blocks the reference wrote
    (padded to four for dp = 2),
    for ten queries (span, resource and attr leaves, a regex table, `>`,
    `>>`, `~`, an OR of span sets): the same traces in the same order;
    a group over the device budget returns None in both, counted the
    same way in the routing;
  * TempoDB.search_blocks on the mesh takes search_blocks_device for
    more than one block (and the per-block route after a refusal), with
    the reference TempoDB's answers;
  * parallel/step.distributed_query_step against the reference's step
    (tests/test_parallel.py:312) and against the port's three host
    entries (sharded_find, sharded_search, sharded_bloom_union).
Every compared output is exact."""

import dataclasses

import numpy as np
import pytest
from test_torch_mesh_cases import start_mesh

from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.db import search as RSM
from tempo_tpu.ops import filter as RF
from tempo_tpu.parallel import distributed_query_step as r_step
from tempo_tpu.util.kerneltel import TEL
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.db import search as SM
from tempo_tpu_torch.db import tempodb as TDB
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.parallel import (
    distributed_query_step,
    sharded_bloom_union,
    sharded_find,
    sharded_search,
)

TENANT = "mesh-step"
QUERIES = [
    '{ name = "db.query" }',
    '{ resource.service.name = "db" }',
    '{ span.component = "grpc" }',
    '{ resource.team.owner = "team-3" }',
    '{ name =~ "GET .*" }',
    '{ duration > 500ms && kind = server }',
    '{ kind = server } > { kind = client }',
    '{ name = "GET /" } >> { name = "db.query" }',
    '{ kind = client } ~ { kind = client }',
    '{ status = error } || { span.http.status_code = 404 }',
]


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    yield from start_mesh((2, 2), tmp_path_factory)


@pytest.fixture(scope="module")
def dbs(meshes, tmp_path_factory):
    """(port TempoDB on the CPU, reference TempoDB on the 2x2 shard_map
    mesh) over three blocks the reference wrote, each resource carrying a
    generic attribute (team.owner) beside the test data's own."""
    _, rmesh = meshes
    tmp = tmp_path_factory.mktemp("store")
    path = str(tmp / "store")
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path}, wal_path=str(tmp / "wal")))
    ref._mesh = rmesh
    for seed in (1, 2, 3):
        traces = make_traces(40, seed=seed, n_spans=6)
        for i, (_, t) in enumerate(traces):
            for j, rs in enumerate(t.resource_spans):
                rs.resource.attrs["team.owner"] = f"team-{(i + j) % 7}"
        ref.write_block(TENANT, traces)
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": path}), device="cpu")
    port.poll_now()
    return port, ref


def _dicts(resp):
    return [dataclasses.asdict(t) for t in resp.traces]


def _blocks(db, metas):
    return [db.open_block(m) for m in metas]


@pytest.mark.parametrize("query", QUERIES)
def test_search_blocks_device_matches_reference(meshes, dbs, query):
    mesh, rmesh = meshes
    port, ref = dbs
    got = SM.search_blocks_device(_blocks(port, port.metas(TENANT)),
                                  SearchRequest(query=query, limit=20), mesh)
    want = RSM.search_blocks_device(_blocks(ref, ref.blocklist.metas(TENANT)),
                                    RRequest(query=query, limit=20), rmesh)
    assert got is not None and want is not None
    assert _dicts(got) == _dicts(want) and got.traces, query
    assert (got.inspected_spans, got.inspected_bytes) == (want.inspected_spans,
                                                          want.inspected_bytes)


def _budget_routes(counts: dict) -> int:
    return counts.get(("search_mesh", "fallback", "pre_io_budget"), 0)


def test_budget_refusal_counted_like_reference(meshes, dbs, monkeypatch):
    mesh, rmesh = meshes
    port, ref = dbs
    monkeypatch.setattr(SM, "_DEVICE_SEARCH_MAX_BYTES", 0)
    monkeypatch.setattr(RSM, "_DEVICE_SEARCH_MAX_BYTES", 0)
    p0, r0 = _budget_routes(BX.routing_counts()), _budget_routes(TEL.routing_counts())
    for q in ('{ name = "db.query" }', '{ kind = server } > { kind = client }'):
        got = SM.search_blocks_device(_blocks(port, port.metas(TENANT)), SearchRequest(query=q),
                                      mesh)
        want = RSM.search_blocks_device(_blocks(ref, ref.blocklist.metas(TENANT)),
                                        RRequest(query=q), rmesh)
        assert (got is None) == (want is None), q
    refused = _budget_routes(BX.routing_counts()) - p0
    assert refused == _budget_routes(TEL.routing_counts()) - r0 and refused > 0


def test_tempodb_searches_blocks_on_the_mesh(meshes, dbs, monkeypatch):
    """More than one block on a mesh of four ranks: the stacked route;
    over budget, the per-block route, with the same answers."""
    mesh, _ = meshes
    port, ref = dbs
    assert port.mesh is mesh and len(port.metas(TENANT)) == 3
    calls = []

    def spy(*a, **k):
        got = SM.search_blocks_device(*a, **k)
        calls.append(got is not None)
        return got

    monkeypatch.setattr(TDB, "search_blocks_device", spy)
    for q in QUERIES[:4] + QUERIES[6:7]:
        got = port.search(TENANT, SearchRequest(query=q, limit=20))
        want = ref.search(TENANT, RRequest(query=q, limit=20))
        assert _dicts(got) == _dicts(want) and got.traces, q
    assert calls == [True] * 5
    monkeypatch.setattr(SM, "_DEVICE_SEARCH_MAX_BYTES", 0)
    monkeypatch.setattr(RSM, "_DEVICE_SEARCH_MAX_BYTES", 0)
    p0 = _budget_routes(BX.routing_counts())
    # the per-block route merges blocks in blocklist order up to the
    # limit: every match, so that the order of the blocks does not matter
    got = port.search(TENANT, SearchRequest(query=QUERIES[0], limit=1000))
    want = ref.search(TENANT, RRequest(query=QUERIES[0], limit=1000))
    assert _dicts(got) == _dicts(want) and calls[-1] is False
    assert _budget_routes(BX.routing_counts()) - p0 == 3


def _step_inputs(seed: int = 11):
    """tests/test_parallel.py:312's shapes, with ids that repeat across
    blocks and queries that miss."""
    rng = np.random.default_rng(seed)
    B, T, Q, S, NT, R, K, NS, W = 8, 32, 8, 32, 8, 4, 8, 2, 16
    ids = np.sort(rng.integers(0, 100, size=(B, T, 4)).astype(np.int32), axis=1)
    for b in range(B):
        ids[b] = ids[b][np.lexsort(ids[b].T[::-1])]
    n_valid = np.asarray([T, T, 20, T, 0, T, 7, T], np.int32)
    queries = np.concatenate([ids[:, 0, :][:Q - 2], np.full((2, 4), 1000, np.int32)])
    cols = {"span.trace_sid": rng.integers(0, NT, size=(B, S)).astype(np.int32),
            "span.dur_us": rng.integers(0, 100, size=(B, S)).astype(np.int32)}
    n_spans = np.asarray([32, 30, 32, 5, 32, 0, 17, 32], np.int32)
    blooms = rng.integers(0, 2**32, size=(K, NS, W), dtype=np.uint32)
    shape = (B, T, Q, S, R, NT, K, NS, W)
    return shape, ids, n_valid, queries, cols, n_spans, blooms


def test_step_matches_reference_and_host_entries(meshes):
    import jax.numpy as jnp

    mesh, rmesh = meshes
    shape, ids, n_valid, queries, cols, n_spans, blooms = _step_inputs()
    names = tuple(sorted(cols))
    tree = ("cond", 0)
    rows = [(0, 50, 0, 0.0, 0.0)]
    rop, op = RF.Operands.build(rows), F.Operands.build(rows)
    rfn = r_step(rmesh, tree, (RF.Cond("span", "span.dur_us", "ge"),), names, *shape)
    want = rfn(jnp.asarray(ids), jnp.asarray(n_valid), jnp.asarray(queries),
               jnp.asarray(rop.ints), jnp.asarray(rop.floats), jnp.asarray(n_spans),
               tuple(jnp.asarray(cols[n]) for n in names), jnp.asarray(blooms))
    conds = (F.Cond("span", "span.dur_us", "ge"),)
    fn = distributed_query_step(mesh, tree, conds, names, *shape)
    got = fn(ids, n_valid, queries, op.ints, op.floats, n_spans,
             tuple(cols[n] for n in names), blooms)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
    hits, tm, sc, union = got
    assert (hits[:, 0] >= 0).sum() >= 2 and (hits[-2:] == -1).all() and tm.any()
    # the three host entries, called apart
    np.testing.assert_array_equal(hits, sharded_find(
        mesh, [ids[b, : n_valid[b]] for b in range(len(ids))], queries))
    for g, w in zip((tm, sc), sharded_search(mesh, tree, conds, op, cols, n_spans, nt=shape[5])):
        np.testing.assert_array_equal(g, w)
    blist = []
    for k in range(blooms.shape[0]):
        b = ShardedBloom(blooms.shape[1])
        b.words = blooms[k].copy()
        blist.append(b)
    np.testing.assert_array_equal(union, sharded_bloom_union(mesh, blist).words)
