"""Kernel-vs-plain tests of the port's CUDA kernels (K1-K4, B5a, B5b, B6)
on the card; K1 by both of its routes (the trace tiles and the
multi-launch kernels).

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


def _kernel_vs_plain(cuda, tree, conds, ops, tables, staged, span_out, tiles=None):
    """K1 by the route filter_plan picks for the staged block's tiles (or
    `tiles`), and by the multi-launch route, each equal to the plain
    version."""
    from tempo_tpu_torch import kernels

    shapes = (staged.n_spans, staged.n_traces, staged.n_spans_b, staged.n_res_b,
              staged.n_traces_b)
    ntree = F.normalize_tree(tree, conds) if tree is not None else None
    ttab = {i: torch.from_numpy(pad_rows(np.asarray(t, np.uint8), bucket(max(1, len(t))), 0)).to(cuda)
            for i, t in (tables or {}).items()}
    want = F._run_plain(ntree, conds, staged.cols, torch.from_numpy(ops.ints).to(cuda),
                        torch.from_numpy(ops.floats).to(cuda), ttab, *shapes, span_out)
    for plan in (None, kernels.MULTI_LAUNCH):
        got = F.eval_block((tree, conds), staged.cols, ops, *shapes, span_out=span_out,
                           tiles=tiles or staged.tiles, plan=plan)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        if not all(torch.equal(g.to(w.dtype), w) for g, w in zip(got, want)):
            return False
    return True


def _retile(staged, tile, device):
    c = {k: v.cpu().numpy() for k, v in staged.cols.items()}
    t = F.trace_tiles(c["trace.span_off"], c.get("span.parent_idx"), c["span.trace_sid"],
                      staged.n_spans, tile)
    return dataclasses.replace(t, bounds=None if t.bounds is None else t.bounds.to(device))


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


def test_filter_tile_route_launches(cuda):
    """Every filter case on tiles of 128 spans (12 tiles, orphans in many):
    the trace-tile route equals the plain version, and one program run
    is one wrapper call and 1 __global__, plus the res pass where the
    program has resource.attr conditions and the flag pass where it has
    `~` (make_cols holds orphans)."""
    from tempo_tpu_torch import kernels

    tiled = 0
    for case, (specs, tree, rows, tables) in sorted(TC.filter_cases().items()):
        conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
        ops = F.Operands.build(rows, tables)
        staged = ST.staged_from_numpy(TC.make_cols(seed=len(case)), TC.N_SPANS, TC.N_TRACES,
                                      TC.N_RES, cuda)
        tiles = _retile(staged, 128, cuda)
        ntree = F.normalize_tree(tree, conds) if tree is not None else None
        prog = F._program(ntree, conds)
        for span_out in (False, True):
            plan = kernels.filter_plan(prog, tiles, span_out)
            assert plan.tiled, case
            assert plan.flag_pass == (prog.n_sib > 0)
            kernels.reset_counts()
            assert _kernel_vs_plain(cuda, tree, conds, ops, tables, staged, span_out, tiles), \
                (case, span_out)
            tiled += 1
            kernels.reset_counts()
            F.eval_block((tree, conds), staged.cols, ops, TC.N_SPANS, TC.N_TRACES, TC.N_SPANS_B,
                         TC.N_RES_B, TC.N_TRACES_B, span_out=span_out, tiles=tiles)
            want = 1 + bool(prog.rconds) + plan.flag_pass
            assert kernels.LAUNCHES["filter"] == 1, case
            assert kernels.grid_launches()["filter"] == want, (case, span_out)
    assert tiled == 2 * len(TC.filter_cases())


def test_filter_tile_route_edge_blocks(cuda):
    """Both routes against the plain version where the tiles end: a
    700-span chain (a tile of 512 cannot hold it, 1,024 can), a parent
    row in another trace, one lhs orphan in trace 0 against rhs orphans
    in the last trace (the block-wide flag), and group-range staging;
    where the plan refuses the tiles, forcing them raises."""
    from tempo_tpu_torch import kernels

    kinds = (F.Cond("span", "span.kind", "eq"), F.Cond("span", "span.kind", "ge"))
    rows = [(0, 1, 0, 0.0, 0.0), (0, 3, 0, 0.0, 0.0)]
    ops = F.Operands.build(rows)
    ns = TC.N_SPANS

    def check(cols, op, tiles_of, want_tiled):
        staged = ST.staged_from_numpy(cols, ns, TC.N_TRACES, TC.N_RES, cuda)
        tiles = _retile(staged, tiles_of, cuda)
        tree = ("tracify", ("struct", op, ("cond", 0), ("cond", 1)))
        prog = F._program(F.normalize_tree(tree, kinds), kinds)
        assert kernels.filter_plan(prog, tiles, False).tiled == want_tiled, op
        for span_out in (False, True):
            assert _kernel_vs_plain(cuda, tree, kinds, ops, None, staged, span_out, tiles), op
        if not want_tiled:  # the tiles cannot be forced where they are not exact
            forced = kernels.FilterPlan(True, False, 1, kernels.filter_tile_smem(prog, 1024))
            with pytest.raises(kernels.KernelError):
                F.eval_block((tree, kinds), staged.cols, ops, ns, TC.N_TRACES, TC.N_SPANS_B,
                             TC.N_RES_B, TC.N_TRACES_B, span_out=False, tiles=tiles, plan=forced)

    cols = TC.make_cols(seed=5)
    off = cols["trace.span_off"]
    off[1:TC.N_TRACES] = np.maximum(off[1:TC.N_TRACES], 700)
    cols["span.trace_sid"][:ns] = np.repeat(np.arange(TC.N_TRACES), np.diff(off[:TC.N_TRACES + 1]))
    pos, lo = np.arange(ns), off[cols["span.trace_sid"][:ns]]
    cols["span.parent_idx"][:ns] = np.where(pos == lo, -1, pos - 1)
    for op in (">", ">>", "~"):
        check(cols, op, 512, False)
        check(cols, op, 1024, True)
    cols = TC.make_cols(seed=6)
    cols["span.parent_idx"][int(cols["trace.span_off"][5]) + 1] = int(cols["trace.span_off"][9])
    check(cols, ">>", 128, False)
    cols = TC.make_cols(seed=3)
    p, kind, off = cols["span.parent_idx"], cols["span.kind"], cols["trace.span_off"]
    kind[:ns] = 2
    p[:ns] = np.where(p[:ns] == -2, -1, p[:ns])
    first, last = int(off[1]) - 1, int(off[TC.N_TRACES - 1])
    p[first], kind[first] = -2, 1
    p[last + 1:int(off[TC.N_TRACES])], kind[last + 1:int(off[TC.N_TRACES])] = -2, 3
    check(cols, "~", 128, True)
    backend = MemBackend()
    meta = build_block_from_traces(backend, "t", make_traces(120, seed=5, n_spans=10),
                                   row_group_spans=256, device=cuda)
    blk = open_block(backend, "t", meta.block_id)
    for q in QUERIES:
        p = plan_search_request(blk.dictionary, {}, query=q)
        if p.has_struct:
            continue
        staged = ST.stage_block(blk, F.required_columns(p.conds) + list(p.extra_cols),
                                groups=[1, 2], cache=False, device=cuda)
        assert staged.span_base == 256
        for span_out in (False, True):
            assert _kernel_vs_plain(cuda, p.tree, p.conds, F.Operands.build(p.rows, p.tables or None),
                                    p.tables, staged, span_out), q


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
    # 12 x 50 cells fold in one CTA's shared memory, 700 x 60 (with
    # values) over a cluster of CTAs
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


def _ts_true(cuda, n_spans, n_groups, n_buckets, has_val, dyadic, seed):
    """`{ true }` over n_spans spans (start times before, on and past the
    axis of n_buckets steps of 1,000 ms; gid -1 to n_groups - 1; values
    with NaN, -0.0, +0.0 and +-inf) -> (the kernel's call, its plain
    version's outputs)."""
    from tempo_tpu_torch import kernels

    rng = np.random.default_rng(seed)
    nsb = bucket(n_spans)
    start = pad_rows(rng.integers(-50_000, n_buckets * 1_000 + 50_000, n_spans).astype(np.int32),
                     nsb, np.int32(-(2**31)))
    cols = {"span.start_ms": start, "span.trace_sid": np.zeros(nsb, np.int32)}
    staged = ST.staged_from_numpy(cols, n_spans, 1, 1, cuda)
    gid = torch.from_numpy(pad_rows(rng.integers(-1, n_groups, n_spans).astype(np.int32), nsb,
                                    np.int32(-1))).to(cuda)
    val = pres = None
    if has_val:
        v = (rng.integers(-511, 512, n_spans) / 8 if dyadic
             else rng.lognormal(0, 2, n_spans)).astype(np.float32)
        special = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
        hit = rng.random(n_spans) < 0.001
        v[hit] = special[rng.integers(0, 5, hit.sum())]
        val = torch.from_numpy(pad_rows(v, nsb, np.float32(0))).to(cuda)
        pres = torch.from_numpy(pad_rows(rng.random(n_spans) < 0.9, nsb, False)).to(cuda)
    prog = TS._span_program(None, ())
    buf = prog.buffer(staged.cols, F.Operands.build([]), {})
    args = (0, 1_000, n_spans, staged.n_res_b, staged.n_traces_b, n_buckets, n_groups)

    def run(plan=None):
        return kernels.timeseries(prog, buf, staged.cols, staged.cols["span.start_ms"], gid, val,
                                  pres, *args, plan=plan)

    want = TS._timeseries_plain(None, (), staged.cols, None, None, {}, gid, val, pres, 0, 1_000,
                                n_spans, n_buckets, n_groups, nsb, staged.n_res_b,
                                staged.n_traces_b)
    return run, want


def _ts_cap(words: int, cluster: int) -> int:
    """Cells one CTA (cluster 1: a private grid) or a 16-CTA cluster
    (slices beside the record outbox) holds at most."""
    from tempo_tpu_torch import kernels

    if cluster == 1:
        return kernels.TS_SMEM_CTA // words
    return cluster * ((kernels.TS_SMEM_MAX - kernels.TS_EXCH) // words)


# (spans, groups, buckets, values, dyadic): phase 10's rate() by service
# and avg_over_time by name on a block's 1,048,576 spans; a grid one cell
# past one CTA's TS_SMEM_CTA and one past a 16-CTA cluster's TS_SMEM_MAX,
# with and without values (a counts-only grid past one CTA takes the
# global route, and is forced onto the others)
TS_GRIDS = [(1 << 20, 64, 61, False, False), (1 << 20, 512, 61, True, False),
            (1 << 20, 512, 61, True, True), (200_000, 1, _ts_cap(20, 1) + 1, True, False),
            (200_000, 1, _ts_cap(20, 16) + 1, True, True),
            (200_000, 1, _ts_cap(4, 1) + 1, False, False),
            (200_000, 1, _ts_cap(4, 16) + 1, False, False)]


@pytest.mark.parametrize("n_spans,n_groups,n_buckets,has_val,dyadic", TS_GRIDS)
def test_timeseries_routes(cuda, n_spans, n_groups, n_buckets, has_val, dyadic):
    """B6 by timeseries_plan's route and by every route the grid fits,
    forced, against the plain version: counts and value counts exact, min
    and max equal (NaN where a NaN was folded), sums within rtol 1e-5
    (exact on dyadic values); one __global__ a call; a forced plan the
    grid does not fit raises."""
    from tempo_tpu_torch import kernels

    run, want = _ts_true(cuda, n_spans, n_groups, n_buckets, has_val, dyadic,
                         n_groups + n_buckets)
    cells = n_groups * n_buckets
    fits, refused = [], []
    for route in kernels.TS_ROUTES:
        try:
            fits.append(kernels.timeseries_route(route, cells, has_val))
        except kernels.KernelError:
            refused.append(route)
    for p in [None] + fits:
        kernels.reset_counts()
        got = run(p)
        torch.cuda.synchronize()
        p = p or kernels.timeseries_plan(cells, has_val)
        assert kernels.LAUNCHES["timeseries"] == 1 and kernels.grid_launches()["timeseries"] == 1
        assert int(got[0].sum()) > 0
        for i, (g, w) in enumerate(zip(got, want)):
            exact = i != 2 or dyadic
            torch.testing.assert_close(g, w, rtol=0 if exact else 1e-5, atol=0, equal_nan=True,
                                       msg=f"{p} output {i}")
    assert kernels.timeseries_plan(cells, has_val).route == (
        "shared" if cells <= _ts_cap(20 if has_val else 4, 1)
        else "cluster" if has_val and cells <= _ts_cap(20, 16) else "global")
    words = 20 if has_val else 4
    for route in refused:  # the plan the route would need, forced, raises
        per = cells if route == "shared" else -(-cells // kernels.TS_CLUSTER)
        c = kernels.TS_SHARED_CLUSTER if route == "shared" else kernels.TS_CLUSTER
        with pytest.raises(kernels.KernelError):
            run(kernels.TsPlan(route, c, per, words * per + (route == "cluster") * kernels.TS_EXCH))
    with pytest.raises(kernels.KernelError):  # a plan that is no route's
        run(kernels.TsPlan("cluster", 4, -(-cells // 4), words * -(-cells // 4) + kernels.TS_EXCH))


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
