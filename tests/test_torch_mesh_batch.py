"""Mesh-batched search and finds of the port (parallel/multiquery.py and
the batchers' mesh legs, db/batchexec.py) over spawned gloo ranks on the
CPU, against the reference on a shard_map mesh of the same (dp, sp):
randomized windows (the counterpart of tests/test_mesh_batch.py:61-150)
whose M2 + all_reduce + M3 equal both the reference's
mesh_eval_multiquery and the port's own single-device eval_multiquery
bit for bit; mesh_batch_eligible on a world of 3; and a TempoDB burst
and batched finds routed to the mesh, equal to a reference TempoDB on
the same mesh shape."""

import dataclasses
import types

import numpy as np
import pytest
from test_torch_mesh_cases import SHAPE_IDS, SHAPES, start_mesh

from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.db.search import _plan_for_block as r_plan
from tempo_tpu.ops import multiquery as RMQ
from tempo_tpu.ops.filter import required_columns as r_required
from tempo_tpu.ops.stage import stage_block as r_stage
from tempo_tpu.parallel import make_mesh as r_make_mesh
from tempo_tpu.parallel.multiquery import mesh_batch_eligible as r_eligible
from tempo_tpu.parallel.multiquery import mesh_eval_multiquery as r_mesh_eval
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.db.search import _plan_for_block
from tempo_tpu_torch.ops import multiquery as MQ
from tempo_tpu_torch.ops.filter import required_columns
from tempo_tpu_torch.ops.stage import stage_block
from tempo_tpu_torch.parallel import mesh_batch_eligible, mesh_eval_multiquery

TENANT = "mesh-batch"

# tests/test_mesh_batch.py:33-43: eligible shapes and three fallbacks
QUERIES = [
    '{ name = "db.query" }',
    '{ duration > 500ms }',
    '{ status = error && kind = server }',
    '{ name = "GET /api" || name = "cache.get" }',
    '{ span.http.status_code >= 500 }',
    '{ name = "db.query" && resource.service.name = "db" }',
    '{ name = "GET /" } >> { name = "db.query" }',
    '{ name =~ "GET .*" }',
    '{ span.component = "grpc" }',
]


@pytest.fixture(scope="module", params=SHAPES, ids=SHAPE_IDS)
def meshes(request, tmp_path_factory):
    yield from start_mesh(request.param, tmp_path_factory)


def _pair(tmp_path, rmesh, traces, **over):
    """(port TempoDB on the CPU, reference TempoDB on rmesh, port meta,
    reference meta) over one store the reference wrote."""
    path = str(tmp_path / "store")
    window = over.pop("batch_window_ms", 200.0)
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path}, batch_window_ms=window,
                           device_promote_touches=1, wal_path=str(tmp_path / "wal"), **over))
    ref._mesh = rmesh
    rmeta = ref.write_block(TENANT, traces)
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": path},
                                 batch_window_ms=window, device_promote_touches=1, **over),
                   device="cpu")
    port.poll_now()
    return port, ref, port.metas(TENANT)[0], rmeta


def _dicts(resp):
    return [dataclasses.asdict(t) for t in resp.traces]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_randomized_windows_bit_identical(meshes, tmp_path, seed):
    """Ragged block sizes (nothing aligns with the split) and shuffled
    query mixes: every program shape's window through the port's mesh
    program equals the reference's and the port's single-device run."""
    mesh, rmesh = meshes
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(40, 160))
    traces = r_make_traces(n, seed=seed, n_spans=int(rng.integers(3, 9)))
    port, ref, meta, rmeta = _pair(tmp_path / str(seed), rmesh, traces)
    blk, rblk = port.open_block(meta), ref.open_block(rmeta)
    picks = [str(rng.choice(QUERIES)) for _ in range(12)]
    by_shape: dict = {}
    for q in picks:
        p, rp = _plan_for_block(blk, SearchRequest(query=q)), r_plan(rblk, RRequest(query=q))
        if p.prune:
            continue
        lq, rlq = MQ.lower_plan(p), RMQ.lower_plan(rp)
        assert (lq is None) == (rlq is None), q
        if lq is not None:
            by_shape.setdefault(lq.shape, []).append((lq, rlq, p, rp))
    assert by_shape
    for shape, group in by_shape.items():
        lqs, rlqs, p, rp = [g[0] for g in group], [g[1] for g in group], group[0][2], group[0][3]
        staged = stage_block(blk, required_columns(p.conds) + list(p.extra_cols)
                             + ["trace.start_ms"], device="cpu")
        rstaged = r_stage(rblk, r_required(rp.conds) + list(rp.extra_cols) + ["trace.start_ms"])
        q_b = MQ._p2(len(lqs), lo=1)
        progs, rprogs = MQ.pack_queries(lqs, q_b), RMQ.pack_queries(rlqs, q_b)
        assert mesh_batch_eligible(mesh, staged) and r_eligible(rmesh, rstaged)
        tm, counts = mesh_eval_multiquery(mesh, lqs, staged, progs)
        rtm, rcounts = r_mesh_eval(rmesh, rlqs, rstaged, rprogs)
        np.testing.assert_array_equal(tm, rtm)
        np.testing.assert_array_equal(counts, rcounts)
        tm1, c1 = MQ.eval_multiquery(lqs, staged, progs)
        np.testing.assert_array_equal(tm, tm1.numpy())
        np.testing.assert_array_equal(counts, c1.numpy())
    ref.close()


def test_mesh_batch_eligible_on_a_world_of_3(tmp_path):
    port = TempoDB(TempoDBConfig(backend={"backend": "mem"}), device="cpu")
    meta = port.write_block(TENANT, r_make_traces(30, seed=5, n_spans=4))
    staged = stage_block(port.open_block(meta), ["span.trace_sid", "trace.span_off"],
                         device="cpu")
    three = types.SimpleNamespace(size=3)
    ref = RTempoDB(RConfig(backend={"backend": "mem"}, wal_path=str(tmp_path / "wal")))
    rmeta = ref.write_block(TENANT, r_make_traces(30, seed=5, n_spans=4))
    rstaged = r_stage(ref.open_block(rmeta), ["span.trace_sid", "trace.span_off"])
    assert mesh_batch_eligible(three, staged) is r_eligible(r_make_mesh(3), rstaged) is False
    assert mesh_batch_eligible(types.SimpleNamespace(size=1), staged) is False
    assert mesh_batch_eligible(types.SimpleNamespace(size=4), staged) is \
        r_eligible(r_make_mesh(4), rstaged) is True
    ref.close()


def test_tempodb_burst_routes_to_the_mesh(meshes, tmp_path):
    """A 12-query single-block burst through the batchers: the eligible
    windows run the mesh program (routing 'mesh_batched'), every answer
    equals the reference TempoDB's on its mesh of the same shape."""
    mesh, rmesh = meshes
    port, ref, meta, rmeta = _pair(tmp_path, rmesh, r_make_traces(120, seed=9, n_spans=6))
    assert port.mesh is mesh and port._batch_mesh() is mesh
    calls = []
    orig = MQ.eval_multiquery
    MQ.eval_multiquery = lambda *a: calls.append(1) or orig(*a)
    before = BX.routing_counts().get(("search_batch", "mesh", "mesh_batched"), 0)
    try:
        qs = [QUERIES[i % len(QUERIES)] for i in range(12)]
        got = port.search_blocks_multi([(TENANT, [meta], SearchRequest(query=q, limit=50))
                                        for q in qs])
    finally:
        MQ.eval_multiquery = orig
    want = ref.search_blocks_multi([(TENANT, [rmeta], RRequest(query=q, limit=50)) for q in qs])
    assert [_dicts(g) for g in got] == [_dicts(w) for w in want]
    assert BX.routing_counts()[("search_batch", "mesh", "mesh_batched")] > before
    assert calls == []  # no window took the single-device launch
    ref.close()


def test_mesh_batch_env_off_keeps_the_device_launch(meshes, tmp_path, monkeypatch):
    mesh, rmesh = meshes
    monkeypatch.setenv("TEMPO_MESH_BATCH", "0")
    port, ref, meta, rmeta = _pair(tmp_path, rmesh, r_make_traces(60, seed=12, n_spans=5))
    before = dict(BX.routing_counts())
    qs = ['{ duration > 10ms }', '{ duration > 20ms }', '{ duration > 40ms }']
    got = port.search_blocks_multi([(TENANT, [meta], SearchRequest(query=q, limit=50))
                                    for q in qs])
    want = ref.search_blocks_multi([(TENANT, [rmeta], RRequest(query=q, limit=50)) for q in qs])
    assert [_dicts(g) for g in got] == [_dicts(w) for w in want]
    after = BX.routing_counts()
    key = ("search_batch", "device", "coalesced")
    assert after.get(key, 0) == before.get(key, 0) + 3
    assert after.get(("search_batch", "mesh", "mesh_batched"), 0) == \
        before.get(("search_batch", "mesh", "mesh_batched"), 0)
    ref.close()


def test_batched_finds_on_the_mesh(meshes, tmp_path):
    mesh, rmesh = meshes
    traces = r_make_traces(70, seed=15, n_spans=4)
    port, ref, meta, rmeta = _pair(tmp_path, rmesh, traces)
    rng = np.random.default_rng(6)
    ids = [tid for tid, _ in traces[:12]] + [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                                             for _ in range(4)]
    before = BX.routing_counts().get(("find_batch", "mesh", "coalesced"), 0)
    got = port.find_in_blocks_multi([(TENANT, i, [meta]) for i in ids])
    want = [ref.find_trace_by_id(TENANT, i) for i in ids]
    assert [None if g is None else dataclasses.asdict(g) for g in got] == \
        [None if w is None else dataclasses.asdict(w) for w in want]
    assert BX.routing_counts()[("find_batch", "mesh", "coalesced")] == before + len(ids)
    ref.close()
