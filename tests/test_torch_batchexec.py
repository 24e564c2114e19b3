"""The port's batching executors (db/batchexec.py) on the CPU against the
JAX package's TempoDB over one local backend: concurrent and multi-job
search and find give the reference's answers; a 16-query group runs one
multi-query program and one row-wise top-k where the sequential path
runs 16 of each; a lone query skips the window; a kernel fault inside a
fused group reaches every member and is not rerun sequentially.
(The counterparts of tests/test_batchexec.py:91-175.)"""

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.parallel import make_mesh
from tempo_tpu.util.testdata import make_traces
import tempo_tpu_torch.db.search as search_mod
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.kernels import KernelError
from tempo_tpu_torch.ops import multiquery as MQ
from tempo_tpu_torch.ops import select as SE

TENANT = "batch-t"

# tests/test_batchexec.py:62-77: batcher-eligible, then fallback queries
QUERIES = [
    '{ name = "db.query" }',
    '{ name != "render" }',
    '{ duration > 500ms }',
    '{ status = error }',
    '{ kind = server }',
    '{ span.http.method = "GET" && duration > 10ms }',
    '{ span.http.status_code >= 500 }',
    '{ name = "GET /api" || name = "cache.get" }',
    '{ name = "db.query" && resource.service.name = "db" }',
    '{ span.http.status_code = 200 && status != error }',
    '{ span.component = "grpc" }',
    '{ name =~ "GET .*" }',
]


def _dbs(tmp, traces, **over):
    """(port TempoDB on the CPU, reference TempoDB, block meta) over one
    local backend holding one block written by the port. Both batch and
    promote a block on its first search; the reference runs on one
    device, so its window leaders take the single-chip fused launch."""
    path = str(tmp / "store")
    cfg = TempoDBConfig(batch_window_ms=over.pop("batch_window_ms", 200.0), batch_max=16,
                        device_promote_touches=1, **over)
    port = TempoDB(cfg, backend=LocalBackend(path), device="cpu")
    meta = port.write_block(TENANT, traces)
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path}, wal_path=str(tmp / "wal"),
                           batch_window_ms=0.0, device_promote_touches=1))
    ref._mesh = make_mesh(1)
    ref.poll_now()
    return port, ref, meta


def _dicts(resp):
    return [dataclasses.asdict(t) for t in resp.traces]


@pytest.fixture
def counted(monkeypatch):
    """Calls of the fused (B5a, B5b) and sequential (K1, K2) dispatchers:
    the launches each would make on a card."""
    n = {"multiquery": 0, "mq_select": 0, "filter": 0, "select": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counting(*a, **k):
            n[key] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, counting)

    wrap(MQ, "eval_multiquery", "multiquery")
    wrap(MQ, "select_multiquery", "mq_select")
    wrap(search_mod, "eval_block", "filter")
    wrap(search_mod, "select_topk_device", "select")
    wrap(SE, "select_topk_device", "select")  # the batched path's escalations
    return n


def test_differential_batched_vs_reference(tmp_path):
    """The query mix concurrently through the port's batcher equals the
    reference's single-block search, one query at a time, result for
    result (limit above the trace count: no truncation)."""
    port, ref, meta = _dbs(tmp_path, make_traces(120, seed=7, n_spans=8))
    rmeta = ref.blocklist.metas(TENANT)[0]
    reqs = [q for q in QUERIES] * 2
    want = [_dicts(ref.search_blocks(TENANT, [rmeta], RRequest(query=q, limit=200)))
            for q in reqs]
    before = BX.routing_counts()
    with ThreadPoolExecutor(len(reqs)) as ex:
        futs = [ex.submit(port.search_blocks, TENANT, [meta], SearchRequest(query=q, limit=200))
                for q in reqs]
        got = [_dicts(f.result()) for f in futs]
    for q, w, g in zip(reqs, want, got):
        assert w == g, f"batched != reference for {q!r}"
    # the two ineligible forms took the fallback (how the eligible ones
    # grouped depends on thread timing; the launch test pins grouping)
    after = BX.routing_counts()
    assert after.get(("search_batch", "fallback", "ineligible_plan"), 0) >= \
        before.get(("search_batch", "fallback", "ineligible_plan"), 0) + 4


def test_batched_launch_reduction_and_identity(tmp_path, counted):
    """16 identical-shape queries in one group: one fused program run and
    one row-wise top-k, against 16 filter runs and 16 selects on the
    sequential path; every response equals the reference's."""
    port, ref, meta = _dbs(tmp_path, make_traces(150, seed=9, n_spans=8))
    rmeta = ref.blocklist.metas(TENANT)[0]
    query = '{ name != "zzz" && duration > 1ms }'
    want = _dicts(ref.search_blocks(TENANT, [rmeta], RRequest(query=query, limit=10)))
    blk = port.open_block(meta)
    req = SearchRequest(query=query, limit=10)
    outs = BX.batched_search_block_many(port.batchers.search, [(blk, req, None)] * 16,
                                        promote_touches=1)
    assert all(_dicts(o) == want for o in outs)
    batched = dict(counted)
    assert batched["multiquery"] == 1 and batched["mq_select"] == 1
    assert batched["filter"] == 0
    for k in counted:
        counted[k] = 0
    for _ in range(16):
        assert _dicts(search_mod.search_block(blk, req, device="cpu")) == want
    assert counted["filter"] == 16 and counted["select"] == 16
    assert counted["multiquery"] == 0
    # the same 16 queries from concurrent threads also coalesce
    with ThreadPoolExecutor(16) as ex:
        for f in [ex.submit(port.search_blocks, TENANT, [meta], req) for _ in range(16)]:
            assert _dicts(f.result()) == want
    assert port.batchers.search.stats["max_occupancy"] >= 2


def test_multi_job_routes_match_reference(tmp_path):
    """search_blocks_multi and search_block_shard_multi (one row-group
    range per job) against the reference's per-job answers."""
    port, ref, meta = _dbs(tmp_path, make_traces(120, seed=8, n_spans=10), row_group_spans=256)
    rmeta = ref.blocklist.metas(TENANT)[0]
    reqs = [SearchRequest(query=q, limit=20) for q in QUERIES]
    got = port.search_blocks_multi([(TENANT, [meta], r) for r in reqs])
    want = [ref.search_blocks(TENANT, [rmeta], RRequest(query=r.query, limit=20)) for r in reqs]
    assert [_dicts(g) for g in got] == [_dicts(w) for w in want]
    assert len(meta.row_groups) >= 3
    groups = [0, 1]
    got = port.search_block_shard_multi([(TENANT, meta, r, groups) for r in reqs])
    want = [ref.search_block_shard(TENANT, rmeta, RRequest(query=r.query, limit=20), groups)
            for r in reqs]
    assert [_dicts(g) for g in got] == [_dicts(w) for w in want]
    for g, w in zip(got, want):
        assert g.inspected_spans == w.inspected_spans
    one = port.search_block_shard(TENANT, meta, reqs[5], [1, 2])
    assert _dicts(one) == _dicts(ref.search_block_shard(
        TENANT, rmeta, RRequest(query=reqs[5].query, limit=20), [1, 2]))


def test_find_batched_equivalence(tmp_path):
    """Concurrent trace-by-ID lookups coalesce through the find batcher
    and return the reference's traces; find_in_blocks_multi likewise."""
    traces = make_traces(60, seed=11, n_spans=5)
    port, ref, meta = _dbs(tmp_path, traces)
    rng = np.random.default_rng(3)
    ids = [tid for tid, _ in traces[:10]] + [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
                                             for _ in range(4)]
    want = [ref.find_trace_by_id(TENANT, i) for i in ids]
    q0 = port.batchers.find.stats["queries"]
    with ThreadPoolExecutor(len(ids)) as ex:
        got = [f.result() for f in [ex.submit(port.find_trace_by_id, TENANT, i) for i in ids]]
    multi = port.find_in_blocks_multi([(TENANT, i, [meta]) for i in ids])
    for w, g, m in zip(want, got, multi):
        assert (g is None) == (w is None) == (m is None)
        if w is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w) == dataclasses.asdict(m)
    assert port.batchers.find.stats["queries"] - q0 >= 2 * len(ids)
    assert port.batchers.find.stats["max_occupancy"] == len(ids)


def test_lone_query_skips_window(tmp_path):
    """A lone query on an idle executor does not pay the admission
    window, for search and for back-to-back finds."""
    traces = make_traces(40, seed=13, n_spans=4)
    port, _, meta = _dbs(tmp_path, traces, batch_window_ms=500.0)
    req = SearchRequest(query='{ name != "zzz" }', limit=5)
    port.search_blocks(TENANT, [meta], req)  # warm: staging
    t0 = time.perf_counter()
    port.search_blocks(TENANT, [meta], req)
    assert time.perf_counter() - t0 < 0.5
    port.find_trace_by_id(TENANT, traces[0][0])
    t0 = time.perf_counter()
    for tid, _ in traces[1:5]:
        assert port.find_trace_by_id(TENANT, tid) is not None
    assert time.perf_counter() - t0 < 4 * 0.5


def test_kernel_error_reaches_every_member(tmp_path, monkeypatch):
    """A KernelError raised inside the fused group's program run is the
    answer of every member, and nothing reruns them sequentially."""
    port, _, meta = _dbs(tmp_path, make_traces(60, seed=3, n_spans=6))

    def broken(*a, **k):
        raise KernelError("multiquery: CUDA error 700")

    calls = {"seq": 0}
    seq = search_mod.search_block

    def counting_seq(*a, **k):
        calls["seq"] += 1
        return seq(*a, **k)

    monkeypatch.setattr(MQ, "_multiquery_plain", broken)
    monkeypatch.setattr(search_mod, "search_block", counting_seq)
    before = BX.routing_counts().get(("search_batch", "fallback", "fused_error"), 0)
    reqs = [SearchRequest(query=f"{{ duration > {i}ms }}", limit=5) for i in range(16)]
    out = port.search_blocks_multi([(TENANT, [meta], r) for r in reqs])
    assert all(isinstance(o, KernelError) for o in out)
    out = port.search_block_shard_multi([(TENANT, meta, r, [0]) for r in reqs[:4]])
    assert all(isinstance(o, KernelError) for o in out)
    assert calls["seq"] == 0
    assert BX.routing_counts().get(("search_batch", "fallback", "fused_error"), 0) == before


def test_other_group_errors_rerun_sequentially(tmp_path, monkeypatch):
    """Any other failure of the fused path keeps the reference's per-item
    isolation: the group reruns member by member, with right answers."""
    port, ref, meta = _dbs(tmp_path, make_traces(60, seed=4, n_spans=6))
    rmeta = ref.blocklist.metas(TENANT)[0]

    def broken(*a, **k):
        raise RuntimeError("not a kernel fault")

    monkeypatch.setattr(MQ, "_multiquery_plain", broken)
    before = BX.routing_counts().get(("search_batch", "fallback", "fused_error"), 0)
    qs = [f"{{ duration > {i}ms }}" for i in range(4)]
    out = port.search_blocks_multi([(TENANT, [meta], SearchRequest(query=q, limit=5)) for q in qs])
    want = [ref.search_blocks(TENANT, [rmeta], RRequest(query=q, limit=5)) for q in qs]
    assert [_dicts(o) for o in out] == [_dicts(w) for w in want]
    assert BX.routing_counts()[("search_batch", "fallback", "fused_error")] == before + 4


def test_kernel_load_builds_once_under_concurrent_first_use(monkeypatch):
    """Two batcher threads can make the first kernel call at once: the
    first builds and binds under the lock, the others find the table."""
    import threading

    from tempo_tpu_torch import kernels

    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(kernels, "_fns", None)
    monkeypatch.setattr(kernels, "build", slow_build)
    monkeypatch.setattr(kernels, "_SIGNATURES", {})
    with ThreadPoolExecutor(8) as ex:
        tables = [f.result() for f in [ex.submit(kernels._load) for _ in range(8)]]
    assert len(calls) == 1
    assert all(t is tables[0] for t in tables)


def test_grid_launch_counts_per_kernel_slot(monkeypatch):
    """multiquery.cu counts B5a in slot 0 and B5b in slot 1, blockcut.cu
    B9a/B9b/B9c in slots 0-2, bloom.cu B10a/B10b in slots 0-1; every
    other library one kernel in slot 0; reset_counts clears every slot."""
    from tempo_tpu_torch import kernels

    counts = {(src, slot): 10 * i + slot for i, src in enumerate(kernels.SOURCES)
              for slot in range(len(kernels._KERNEL_OF[src]))}

    def fake(src):
        def fn(reset, slot):
            v = counts[(src, slot)]
            if reset:
                counts[(src, slot)] = 0
            return v
        return fn

    monkeypatch.setattr(kernels, "_grid_fns", {src: fake(src) for src in kernels.SOURCES})
    got = kernels.grid_launches()
    i = kernels.SOURCES.index("multiquery")
    assert (got["multiquery"], got["mq_select"]) == (10 * i, 10 * i + 1)
    assert got["timeseries"] == 10 * kernels.SOURCES.index("timeseries")
    i = kernels.SOURCES.index("blockcut")
    assert (got["remap"], got["bloom_bits"], got["rowgroup"]) == (10 * i, 10 * i + 1, 10 * i + 2)
    i = kernels.SOURCES.index("bloom")
    assert (got["bloom_union"], got["bloom_test"]) == (10 * i, 10 * i + 1)
    assert set(got) == set(kernels.LAUNCHES)
    kernels.reset_counts()
    assert set(kernels.grid_launches().values()) == {0}
    assert set(kernels.LAUNCHES.values()) == {0}


def test_batch_executor_stress():
    """More submitters than cores, with a short switch interval: every
    item gets its own result back, and the stats and launch counts add
    up exactly (a lost update would break either)."""
    import sys

    from tempo_tpu_torch import kernels

    def runner(key, items):
        kernels._count("find")
        return [(key, x * 2) for x in items]

    ex = BX.BatchExecutor("stress", runner, window_s=0.002, max_batch=16)
    n_threads, per = 32, 40
    old = sys.getswitchinterval()
    before = kernels.LAUNCHES["find"]
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as pool:
            futs = [pool.submit(lambda t=t: [ex.submit(t % 3, t * 1000 + i) for i in range(per)])
                    for t in range(n_threads)]
            outs = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for t, out in enumerate(outs):
        assert out == [(t % 3, 2 * (t * 1000 + i)) for i in range(per)]
    assert ex.stats["queries"] == n_threads * per
    assert kernels.LAUNCHES["find"] - before == ex.stats["groups"]
    assert 1 < ex.stats["max_occupancy"] <= 16
