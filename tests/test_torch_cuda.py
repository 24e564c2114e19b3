"""Kernel-vs-plain tests of the port's CUDA kernels (K1-K4, B5a, B5b, B6)
on the card.

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is a bool, an int or a trace, so every comparison is
exact -- except B6's f32 sum, whose atomics add in a run-dependent
order: it is held to rtol 1e-5 on positive values and exactly on dyadic
ones."""

import dataclasses

import numpy as np
import pytest
import torch
import test_torch_cases as TC

import tempo_tpu_torch.db.search as search_mod
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import build_block_from_traces, open_block
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import find as FD
from tempo_tpu_torch.ops import multiquery as MQ
from tempo_tpu_torch.ops import timeseries as TS
from tempo_tpu_torch.ops import select as SE
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops.device import bucket, pad_rows
from tempo_tpu_torch.traceql.plan import plan_search_request
from tempo_tpu_torch.util.testdata import make_traces

pytestmark = pytest.mark.cuda

QUERIES = [
    '{ resource.service.name = "db" }',
    '{ span.http.status_code = 500 }',
    '{ .component = "grpc" && duration > 100ms }',
    '{ name =~ "GET.*" }',
    '{ name !~ "GET.*" }',
    '{ .latency.weight > 0.5 }',
    '{ .cache.hit = true }',
    '{ resource.k8s.namespace.name = "apps" }',
    '{ resource.k8s.cluster.name =~ "pr.*" }',
    '{ true } > { kind = client }',
    '{ true } >> { name = "db.query" }',
    '{ .component = "sql" } ~ { .cache.hit = true }',
    '{ status = error } || { traceDuration > 1s }',
    '{ .http.method = "GET" && .component != "grpc" }',
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def block():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    backend = MemBackend()
    traces = make_traces(120, seed=5, n_spans=10)
    meta = build_block_from_traces(backend, "t", traces, row_group_spans=256,
                                   device=torch.device("cuda", 0))
    return open_block(backend, "t", meta.block_id), traces, backend


def test_res_to_span_kernel(cuda):
    rng = np.random.default_rng(0)
    res = torch.from_numpy(rng.integers(-5, 1000, 777).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-3, 900, 4096).astype(np.int32)).to(cuda)
    got = ST.res_to_span(res, idx)
    assert torch.equal(got, ST._res_to_span_plain(res, idx))


def test_find_kernel(cuda):
    rng = np.random.default_rng(1)
    B, T, n = 3, 2048, [2048, 1500, 7]
    ids = np.full((B, T, 4), 2**31 - 1, np.int32)
    for b in range(B):
        a = rng.integers(-(2**31), 2**31 - 1, (n[b], 4), dtype=np.int64).astype(np.int32)
        a = a[np.lexsort(a.T[::-1])]
        ids[b, : n[b]] = a
    q = np.concatenate([ids[0, :40], ids[1, 100:140], rng.integers(-9, 9, (48, 4)).astype(np.int32),
                        np.asarray([[-(2**31)] * 4, [2**31 - 1] * 4], np.int32)])
    args = [torch.from_numpy(x).to(cuda) for x in (ids, q, np.asarray(n, np.int32))]
    got = FD.bisect_rows(*args, T.bit_length())
    want = FD._bisect_plain(*args, T.bit_length())
    assert torch.equal(got, want)
    assert (got[0, :40].cpu().numpy() == np.arange(40)).all()


def test_select_kernel(cuda):
    """Both routes equal the plain version bit for bit: each case runs
    the route select_plan picks, then the other route on the same
    inputs; the small-k route makes 2 __global__ launches a call; a
    k'-select is the first k' slots of a k-select."""
    from tempo_tpu_torch import kernels

    ks = kernels.K_SMALL
    for n, k, p_mask in [(1024, 16, 0.3), (1024, 1024, 0.3), (5000, 64, 0.3), (70000, 256, 0.3),
                         (70000, 70000, 0.3), (4095, 64, 0.3), (4096, 64, 0.3), (4097, 64, 0.3),
                         (327_680, ks, 0.3), (327_680, ks + 1, 0.3), (12289, 16, 0.0),
                         (12289, 16, 1.0), (70000, 1, 0.3)]:
        rng = np.random.default_rng(n + k)
        mask = torch.from_numpy(rng.random(n) < p_mask).to(cuda)
        key = torch.from_numpy(rng.integers(0, 7, n).astype(np.int32)).to(cuda)  # heavy ties
        counts = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32)).to(cuda)
        want = SE._select_plain(mask, key, counts, k)
        plan = kernels.select_plan(n, k)
        kernels.reset_counts()
        got = kernels.select_topk(mask, key, counts, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, k, plan.tiled)
        if plan.tiled:
            assert kernels.grid_launches()["select"] == 2, (n, k)
        other = (kernels._sort_plan(n, k) if plan.tiled
                 else kernels._tiled_plan(n, k) if k <= 8192 else None)
        if other is not None:
            assert torch.equal(kernels._select_run(mask, key, counts, k, other), want), \
                (n, k, other.tiled)
        k2 = max(1, k // 4)
        part = kernels.select_topk(mask, key, counts, k2)
        for i in range(3):
            assert torch.equal(part[i * k2:(i + 1) * k2], got[i * k:i * k + k2]), (n, k, k2)
        assert part[3 * k2] == got[3 * k] == int(mask.sum())
    assert kernels.select_plan(327_680, ks).tiled and not kernels.select_plan(327_680, ks + 1).tiled


def _kernel_vs_plain(cuda, tree, conds, ops, tables, staged, span_out):
    shapes = (staged.n_spans, staged.n_traces, staged.n_spans_b, staged.n_res_b,
              staged.n_traces_b)
    got = F.eval_block((tree, conds), staged.cols, ops, *shapes, span_out=span_out)
    ntree = F.normalize_tree(tree, conds) if tree is not None else None
    ttab = {i: torch.from_numpy(pad_rows(np.asarray(t, np.uint8), bucket(max(1, len(t))), 0)).to(cuda)
            for i, t in (tables or {}).items()}
    want = F._run_plain(ntree, conds, staged.cols, torch.from_numpy(ops.ints).to(cuda),
                        torch.from_numpy(ops.floats).to(cuda), ttab, *shapes, span_out)
    assert len(got) == len(want)
    return all(torch.equal(g.to(w.dtype), w) for g, w in zip(got, want))


def test_filter_kernel_on_a_block(cuda, block):
    blk = block[0]
    for query in QUERIES:
        p = plan_search_request(blk.dictionary, {}, query=query)
        assert not p.prune, query
        ops = F.Operands.build(p.rows, p.tables or None)
        staged = ST.stage_block(blk, F.required_columns(p.conds) + list(p.extra_cols), device=cuda)
        for span_out in (False, True):
            assert _kernel_vs_plain(cuda, p.tree, p.conds, ops, p.tables, staged, span_out), \
                (query, span_out)


def test_filter_kernel_edge_cases(cuda):
    for case, (specs, tree, rows, tables) in sorted(TC.filter_cases().items()):
        conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
        ops = F.Operands.build(rows, tables)
        staged = ST.staged_from_numpy(TC.make_cols(seed=len(case)), TC.N_SPANS, TC.N_TRACES,
                                      TC.N_RES, cuda)
        for span_out in (False, True):
            assert _kernel_vs_plain(cuda, tree, conds, ops, tables, staged, span_out), \
                (case, span_out)


def test_tempodb_card_matches_cpu(cuda, block, monkeypatch):
    _, traces, backend = block
    dev_db = TempoDB(TempoDBConfig(), backend=backend, device=cuda)
    cpu_db = TempoDB(TempoDBConfig(), backend=backend, device="cpu")
    dev_db.poll_now()
    cpu_db.poll_now()
    for tid, _ in traces[:8] + [(b"\x07" * 16, None)]:
        a, b = dev_db.find_trace_by_id("t", tid), cpu_db.find_trace_by_id("t", tid)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    # the fused multi-block search, then (budget 0) the per-block
    # fallback through search_block
    for budget in (search_mod._DEVICE_SEARCH_MAX_BYTES, 0):
        monkeypatch.setattr(search_mod, "_DEVICE_SEARCH_MAX_BYTES", budget)
        for q in QUERIES:
            ra = dev_db.search("t", SearchRequest(query=q, limit=20))
            rb = cpu_db.search("t", SearchRequest(query=q, limit=20))
            assert [dataclasses.asdict(t) for t in ra.traces] == \
                [dataclasses.asdict(t) for t in rb.traces], (budget, q)
            assert ra.inspected_spans == rb.inspected_spans


def test_multiquery_kernel_on_a_block(cuda, block):
    """Real plans of the batcher's query forms, grouped by program shape,
    on a staged block: the batcher's own use."""
    blk = block[0]
    kinds = ("server", "client", "internal")
    queries = ['{ name = "db.query" }', '{ name != "render" }', '{ duration > 500ms }',
               '{ status = error && kind = server }', '{ name = "GET /" || duration < 1ms }',
               '{ span.http.status_code >= 500 }', '{ name = "GET /api" || name = "cache.get" }',
               '{ name = "db.query" && resource.service.name = "db" }',
               '{ span.http.status_code = 200 && status != error }'] + \
        [f'{{ duration > {i}ms && kind != {kinds[i % 3]} }}' for i in range(12)]
    by_shape: dict = {}
    for q in queries:
        p = plan_search_request(blk.dictionary, {}, query=q)
        lq = MQ.lower_plan(p)
        assert lq is not None, q
        by_shape.setdefault(lq.shape, []).append((p, lq))
    assert max(len(v) for v in by_shape.values()) == 12
    for shape, pairs in by_shape.items():
        needed = sorted({n for p, _ in pairs for n in F.required_columns(p.conds)})
        staged = ST.stage_block(blk, needed, device=cuda)
        lowered = [lq for _, lq in pairs]
        progs = MQ.pack_queries(lowered, MQ._p2(len(lowered), lo=1))
        got = MQ.eval_multiquery(lowered, staged, progs)
        tp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in progs.items()}
        want = MQ._multiquery_plain([staged.cols[n] for n in shape.span_cols],
                                    [staged.cols[n] for n in shape.trace_cols],
                                    staged.cols["trace.span_off"], tp, staged.n_spans,
                                    staged.n_traces, staged.n_spans_b, staged.n_traces_b)
        for g, w in zip(got, want):
            assert torch.equal(g, w), shape


def test_multiquery_kernel(cuda):
    from tempo_tpu_torch import kernels

    for q in (1, 3, 16):
        rng = np.random.default_rng(q)
        lowered = [MQ.LoweredQuery.from_arrays(TC.random_program(rng)) for _ in range(q)]
        staged = ST.staged_from_numpy(TC.mq_cols(q), TC.N_SPANS, TC.N_TRACES, TC.N_RES, cuda)
        progs = MQ.pack_queries(lowered, MQ._p2(q, lo=1))
        n0 = kernels.LAUNCHES["multiquery"]
        got = MQ.eval_multiquery(lowered, staged, progs)
        assert kernels.LAUNCHES["multiquery"] == n0 + 1
        tp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in progs.items()}
        shape = lowered[0].shape
        want = MQ._multiquery_plain([staged.cols[n] for n in shape.span_cols],
                                    [staged.cols[n] for n in shape.trace_cols],
                                    staged.cols["trace.span_off"], tp, TC.N_SPANS, TC.N_TRACES,
                                    TC.N_SPANS_B, TC.N_TRACES_B)
        assert got[0][:q].any()
        for g, w in zip(got, want):
            assert torch.equal(g, w), q


def test_mq_select_kernel(cuda):
    from tempo_tpu_torch import kernels

    for q, n, k in [(16, 1024, 16), (16, 1024, 64), (3, 5000, 64), (16, 32768, 64), (2, 4096, 4096)]:
        rng = np.random.default_rng(n + k + q)
        tm = torch.from_numpy(rng.random((q, n)) < 0.3).to(cuda)
        key = torch.from_numpy(rng.integers(0, 7, n).astype(np.int32)).to(cuda)  # heavy ties
        counts = torch.from_numpy(rng.integers(0, 50, (q, n)).astype(np.int32)).to(cuda)
        got = kernels.mq_select(tm, key, counts, k)
        assert torch.equal(got, MQ._mq_select_plain(tm, key, counts, k)), (q, n, k)
        # each row equals K2 on that row alone
        for r in range(q):
            assert torch.equal(got[r], kernels.select_topk(tm[r], key, counts[r], k)), (q, n, k, r)


def _ts_both(cuda, case, n_groups, n_buckets, has_val, dyadic, t0, step):
    specs, tree, rows, tables = TC.filter_cases()[case]
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    ops = F.Operands.build(rows, tables)
    cols = TC.make_cols(seed=len(case))
    inp = TC.ts_inputs(len(case) + n_groups, n_groups, dyadic)
    cols["span.start_ms"] = inp["span.start_ms"]
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, cuda)
    gid = torch.from_numpy(inp["gid"]).to(cuda)
    val = torch.from_numpy(inp["val"]).to(cuda) if has_val else None
    pres = torch.from_numpy(inp["vpres"]).to(cuda) if has_val else None
    args = (t0, step, TC.N_SPANS, n_buckets, n_groups, TC.N_SPANS_B, TC.N_RES_B, TC.N_TRACES_B)
    got = TS.timeseries_fold((tree, conds), staged.cols, ops, gid, val, pres, *args)
    ttab = {i: torch.from_numpy(t).to(cuda) for i, t in TS._table_list(ops).items()}
    want = TS._timeseries_plain(tree, conds, staged.cols, torch.from_numpy(ops.ints).to(cuda),
                                torch.from_numpy(ops.floats).to(cuda), ttab, gid, val, pres, *args)
    return got, want


@pytest.mark.parametrize("has_val", [False, True])
def test_timeseries_kernel(cuda, has_val):
    # 12 x 50 cells fold in shared memory, 700 x 60 with values in global memory
    for n_groups, n_buckets in ((12, 50), (700, 60)):
        empty = set()
        for case in sorted(TC.span_level_cases()):
            got, want = _ts_both(cuda, case, n_groups, n_buckets, has_val, False, -3_000, 9_000)
            assert len(got) == len(want)
            if not got[0].any():
                empty.add(case)
            for i, (g, w) in enumerate(zip(got, want)):
                # the f32 sum: positive values, atomics in any order; the
                # rest exact (NaN cells propagate on both sides)
                torch.testing.assert_close(g, w, rtol=1e-5 if i == 2 else 0, atol=0,
                                           equal_nan=True, msg=f"{case} output {i}")
        assert empty <= {"rattr_str", "sattr_bool"}, empty  # the rest fold something


def test_timeseries_kernel_dyadic_sums_exact(cuda):
    for n_groups, n_buckets in ((12, 50), (700, 60)):
        for case in ("op_exists", "and_or_mixed", "trace_int", "rattr_int"):
            got, want = _ts_both(cuda, case, n_groups, n_buckets, True, True, 1_000, 7_777)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (case, n_groups)


def test_tempodb_batched_burst_card_matches_cpu(cuda, block):
    """16 same-shape queries as one group (search_blocks_multi) and from
    16 threads, and 16 finds: card and CPU TempoDBs agree; the card
    group ran B5a once with all 16 queries."""
    from concurrent.futures import ThreadPoolExecutor

    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.db import batchexec

    _, traces, backend = block
    cfg = TempoDBConfig(batch_window_ms=200.0, device_promote_touches=1)
    dev_db = TempoDB(cfg, backend=backend, device=cuda)
    cpu_db = TempoDB(cfg, backend=backend, device="cpu")
    dev_db.poll_now()
    cpu_db.poll_now()
    meta = dev_db.metas("t")[0]
    kinds = ("server", "client", "internal", "producer", "consumer", "unspecified")
    reqs = [SearchRequest(query=f'{{ duration > {i}ms && kind != {kinds[i % 6]} }}', limit=20)
            for i in range(16)]
    items = [("t", [meta], r) for r in reqs]

    def dicts(resp):
        return [dataclasses.asdict(t) for t in resp.traces]

    want = [dicts(r) for r in cpu_db.search_blocks_multi(items)]
    kernels.reset_counts()
    before = batchexec.routing_counts().get(("search_batch", "fallback", "fused_error"), 0)
    got = [dicts(r) for r in dev_db.search_blocks_multi(items)]
    assert got == want
    assert kernels.LAUNCHES["multiquery"] == 1 and kernels.LAUNCHES["mq_select"] == 1
    assert kernels.LAUNCHES["filter"] == 0
    assert dev_db.batchers.search.stats["max_occupancy"] == 16
    with ThreadPoolExecutor(16) as ex:
        got = [dicts(f.result()) for f in [ex.submit(dev_db.search_blocks, "t", [meta], r)
                                           for r in reqs]]
    assert got == want
    assert batchexec.routing_counts().get(("search_batch", "fallback", "fused_error"), 0) == before
    ids = [tid for tid, _ in traces[:12]] + [b"\x07" * 16] * 4
    fwant = cpu_db.find_in_blocks_multi([("t", i, [meta]) for i in ids])
    kernels.reset_counts()
    fgot = dev_db.find_in_blocks_multi([("t", i, [meta]) for i in ids])
    assert kernels.LAUNCHES["find"] == 1
    assert [None if t is None else dataclasses.asdict(t) for t in fgot] == \
        [None if t is None else dataclasses.asdict(t) for t in fwant]


def test_tempodb_metrics_card_matches_cpu(cuda, block):
    """TempoDB.metrics_query_range on the card (B6 once per block) and on
    the CPU: equal series -- the f32 sums at rtol 1e-5."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.db import metrics_exec as ME

    _, _, backend = block
    dev_db = TempoDB(TempoDBConfig(), backend=backend, device=cuda)
    cpu_db = TempoDB(TempoDBConfig(), backend=backend, device="cpu")
    dev_db.poll_now()
    cpu_db.poll_now()
    metas = dev_db.metas("t")
    lo = min(m.start_time_unix_nano for m in metas) // 10**9
    hi = -(-max(m.end_time_unix_nano for m in metas) // 10**9)
    for query in ['{ true } | rate() by(resource.service.name)',
                  '{ kind = server } | max_over_time(duration) by(name)',
                  '{ span.http.status_code >= 500 && traceDuration > 1ms } | count_over_time() by(kind)',
                  '{ .component = "grpc" || resource.service.name = "db" } | avg_over_time(duration)']:
        req = ME.align_params(query, lo, hi + 1, 0.5)
        kernels.reset_counts()
        a = dev_db.metrics_query_range("t", req)
        assert kernels.LAUNCHES["timeseries"] == len(metas), query
        b = cpu_db.metrics_query_range("t", req)
        assert a.series and set(a.series) == set(b.series), query
        for k, st in b.series.items():
            for f, arr in st.items():
                if f == "vsum":
                    np.testing.assert_allclose(a.series[k][f], arr, rtol=1e-5)
                else:
                    np.testing.assert_array_equal(a.series[k][f], arr)
