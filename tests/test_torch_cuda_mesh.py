"""The mesh programs' CUDA kernels on the card (M1 find_elect, fused
with K3, M2 mq_partial, M3 mq_combine, M4 timeseries_stacked, and K4's
one launch in M4's mesh body) against their plain versions, the five host entries on an NCCL mesh of one rank against the
single-card routes, and a gloo 2x2 mesh whose four ranks share the card,
under a TempoDB on the card against one on the CPU.

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is an int or a bool and compared exactly -- except the f32
sums of M4, whose atomics add in a run-dependent order: rtol 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch
import test_torch_cases as TC

from tempo_tpu_torch import kernels
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import schema as S
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.db import metrics_exec as ME
from tempo_tpu_torch.db.metrics_mesh import try_metrics_mesh
from tempo_tpu_torch.db.search import _plan_for_block
from tempo_tpu_torch.ops import bloom_ops as BO
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import find as FD
from tempo_tpu_torch.ops import multiquery as MQ
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops import timeseries as TS
from tempo_tpu_torch.parallel import (
    launch,
    mesh_eval_multiquery,
    sharded_bloom_union,
    sharded_find,
    sharded_find_rows,
)
from tempo_tpu_torch.parallel.mesh import Mesh
from tempo_tpu_torch.util.testdata import make_traces
from torch_tile_cases import (
    MQ_BOUNDS,
    MQ_CASES,
    STACKED_G,
    STACKED_NB,
    STACKED_SPECS,
    STACKED_STEP,
    STACKED_TREE,
    elect_case,
    mq_split_case,
    stacked_case,
)

pytestmark = pytest.mark.cuda

TENANT = "t"
METRICS = ['{ true } | rate() by(resource.service.name)',
           '{ kind = server } | max_over_time(duration) by(name)',
           '{ span.http.status_code >= 500 || traceDuration > 1ms } | count_over_time() by(kind)',
           '{ resource.service.name = "db" } | avg_over_time(duration)']
BURST = [f'{{ duration > {i}ms && kind != server }}' for i in range(16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _store(n_blocks: int = 3):
    backend = MemBackend()
    db = TempoDB(TempoDBConfig(batch_window_ms=200.0, device_promote_touches=1),
                 backend=backend, device="cpu")
    traces = [make_traces(90, seed=60 + i, n_spans=8) for i in range(n_blocks)]
    for batch in traces:
        db.write_block(TENANT, batch)
    return backend, traces


def _db(backend, device):
    db = TempoDB(TempoDBConfig(batch_window_ms=200.0, device_promote_touches=1),
                 backend=backend, device=device)
    db.poll_now()
    return db


@pytest.mark.parametrize("bl,q,short", [(1, 4, False), (3, 40, False), (12, 64, False),
                                         (12, 40, True), (130, 40, False)])
def test_find_elect_kernel_matches_plain(cuda, bl, q, short):
    """M1 fused with K3 (one CTA a query, a warp a block) over a rank's
    stack of bl blocks (torch_tile_cases.elect_case: n_valid from 0 to T,
    an id in block 0 and the last block, block 0's row 0, misses) against
    the plain election over the plain search: the packed keys equal,
    one wrapper call, a __global__ a 64 blocks (130: three, the later two
    folding into the first's keys). `short`: n_steps below
    bit_length(n_valid), the lockstep route; and a stack of misses only."""
    case = elect_case(3 + bl, bl, q=q)
    ids, nv, qs = (torch.from_numpy(case[k]).to(cuda) for k in ("ids", "n_valid", "queries"))
    steps = 3 if short else ids.shape[1].bit_length()
    kernels.reset_counts()
    got = kernels.find_elect(ids, qs, nv, steps, case["base"])
    assert kernels.LAUNCHES["find_elect"] == 1 and kernels.LAUNCHES["find"] == 0
    assert kernels.grid_launches()["find_elect"] == -(-bl // kernels.FIND_BLOCKS)
    want = FD._find_elect_plain(FD._bisect_plain(ids, qs, nv, steps), case["base"])
    assert got.dtype == torch.int64 and torch.equal(got, want)
    if not short:
        assert (got >= 0).sum() >= q - q // 4
        if bl > 1:  # the id in block 0 and the last block: the last wins
            assert int(got[1]) >> 32 == case["base"] + bl - 1
    miss = elect_case(3 + bl, bl, q=q, misses_only=True)
    qm = torch.from_numpy(miss["queries"]).to(cuda)
    assert (kernels.find_elect(ids, qm, nv, steps, case["base"]) == -1).all()


def test_ts_body_one_k4_launch(cuda):
    """M4's mesh body with two resource conditions over 3 stacked blocks
    (a 1x1 mesh on the card): one K4 call and one __global__ for both
    span@ columns, no torch.stack; the fold equals the CPU port's."""
    from tempo_tpu_torch.parallel.timeseries import sharded_timeseries

    rng = np.random.default_rng(16)
    cols, n_spans, _ = _stacked(rng, B=3)
    cols["res.namespace_id"] = rng.integers(-1, 4, cols["res.service_id"].shape).astype(np.int32)
    conds = (F.Cond("res", "res.service_id", "eq"), F.Cond("res", "res.namespace_id", "eq"),
             F.Cond("res", "res.service_id", "ne"))
    tree = ("or", ("and", ("cond", 0), ("cond", 1)), ("cond", 2))
    operands = [F.Operands.build([(0, b % 3, 0, 0.0, 0.0), (0, 1, 0, 0.0, 0.0),
                                  (0, 4, 0, 0.0, 0.0)]) for b in range(3)]
    gid = rng.integers(-1, 5, (3, cols["span.start_ms"].shape[1])).astype(np.int32)
    args = (tree, conds, operands, cols, n_spans, np.zeros(3, np.int32), gid, None, None, 10_000,
            7, 5)
    stack = torch.stack
    calls = []
    try:
        torch.stack = lambda *a, **k: calls.append(1) or stack(*a, **k)
        kernels.reset_counts()
        got = sharded_timeseries(Mesh(1, 1, cuda), *args)
    finally:
        torch.stack = stack
    assert kernels.LAUNCHES["res_to_span"] == 1 and kernels.grid_launches()["res_to_span"] == 1
    assert not calls
    want = sharded_timeseries(Mesh(1, 1, "cpu"), *args)
    assert int(want[0].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mq_partial_combine_match_plain_and_b5a(cuda):
    """M2 over 1, 2 and 4 row slices, summed, then M3: equal to their
    plain versions and to B5a on the whole block, bit for bit."""
    backend, _ = _store(1)
    db = _db(backend, cuda)
    blk = db.open_block(db.metas(TENANT)[0])
    plans = [_plan_for_block(blk, SearchRequest(query=q)) for q in BURST[:5]]
    lqs = [MQ.lower_plan(p) for p in plans]
    shape = lqs[0].shape
    staged = ST.stage_block(blk, F.required_columns(plans[0].conds) + ["trace.start_ms"],
                            device=cuda)
    progs = MQ.pack_queries(lqs, 8)
    rows = torch.from_numpy(MQ._program_rows(progs)).to(cuda)
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    span_mat = torch.stack([staged.cols[n] for n in shape.span_cols])
    trace_mat = torch.zeros((1, staged.n_traces_b), dtype=torch.int32, device=cuda)
    span_off = staged.cols["trace.span_off"]
    tm1, c1 = MQ.eval_multiquery(lqs, staged, progs)
    tables = MQ.program_tables(rows, dims)
    for w in (1, 2, 4):
        sl = staged.n_spans_b // w
        parts = []
        for r in range(w):
            sm = span_mat[:, r * sl:(r + 1) * sl].contiguous()
            got = kernels.mq_partial(rows, dims, sm, r * sl, span_off, staged.n_spans)
            want = MQ._mq_partial_plain(sm, span_off, tables, r * sl, staged.n_spans)
            assert torch.equal(got, want), (w, r)
            parts.append(got)
        total = torch.stack(parts).sum(dim=0, dtype=torch.int32)
        tm, cnt = kernels.mq_combine(rows, dims, total, trace_mat, staged.n_traces)
        ptm, pcnt = MQ._mq_combine_plain(total, trace_mat, tables, staged.n_traces)
        assert torch.equal(tm, ptm) and torch.equal(cnt, pcnt), w
        assert torch.equal(tm, tm1) and torch.equal(cnt, c1), w
    assert tm1.any()


@pytest.mark.parametrize("kind", [1, 2])
def test_mq_partial_combine_hostile_offsets(cuda, kind):
    """M2 over 1 and 3 row slices, then M3, on programs with offsets out
    of order or out of their tables and span offsets that run backwards:
    equal to their plain versions and, summed, to B5a, bit for bit."""
    rng = np.random.default_rng(50 + kind)
    arrays = [TC.hostile_program(TC.random_program(rng), rng, kind) if i % 2
              else TC.random_program(rng) for i in range(4)]
    lqs = [MQ.LoweredQuery.from_arrays(a) for a in arrays]
    cols = TC.hostile_cols(kind)
    cols["trace.span_off"] = np.maximum(cols["trace.span_off"], 0)  # backwards, not below zero
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, cuda)
    shape = lqs[0].shape
    progs = MQ.pack_queries(lqs, 4)
    rows = torch.from_numpy(MQ._program_rows(progs)).to(cuda)
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    span_mat = torch.stack([staged.cols[n] for n in shape.span_cols])
    trace_mat = torch.stack([staged.cols[n] for n in shape.trace_cols])
    span_off = staged.cols["trace.span_off"]
    tm1, c1 = MQ.eval_multiquery(lqs, staged, progs)
    tables = MQ.program_tables(rows, dims)
    for w in (1, 3):
        bounds = [staged.n_spans_b * r // w for r in range(w + 1)]
        parts = []
        for r in range(w):
            sm = span_mat[:, bounds[r]:bounds[r + 1]].contiguous()
            got = kernels.mq_partial(rows, dims, sm, bounds[r], span_off, staged.n_spans)
            assert torch.equal(got, MQ._mq_partial_plain(sm, span_off, tables, bounds[r],
                                                         staged.n_spans)), (w, r)
            parts.append(got)
        total = torch.stack(parts).sum(dim=0, dtype=torch.int32)
        tm, cnt = kernels.mq_combine(rows, dims, total, trace_mat, staged.n_traces)
        ptm, pcnt = MQ._mq_combine_plain(total, trace_mat, tables, staged.n_traces)
        assert torch.equal(tm, ptm) and torch.equal(cnt, pcnt), w
        assert torch.equal(tm, tm1) and torch.equal(cnt, c1), w
    assert (np.diff(cols["trace.span_off"][:TC.N_TRACES + 1]) < 0).any()


@pytest.mark.parametrize("case", MQ_CASES + ("short_tile", "ragged", "wrap"))
def test_mq_split_routes(cuda, case):
    """M2 and M3 on the routes of their redesign (tests/torch_tile_cases
    mq_split_case: chunks on the word operations and on the program rows,
    several chunks, NG = 8, P = 3, no span column; "short_tile": 1,012
    trace rows, M2's last tile of 4; "wrap": span offsets within row0 of
    INT_MIN, whose int32 difference wraps), one __global__ a call each: M2
    on every slice of 1-4 row slices that cut traces and on a slice past
    the spans (every tile empty: zeros), M3 into its packed output
    (counts, then tm), each against its plain version; summed, equal to
    B5a (but for "short_tile" and "wrap"). "ragged": 1,022 trace rows, or
    counts off a 16-byte boundary, which both wrappers refuse."""
    arrays, cols, q = mq_split_case(case if case in MQ_CASES else "regular", 700 + len(case))
    if case == "wrap":
        cols["trace.span_off"][[5, 9, 40]] = [-(2**31), -(2**31) + 700, -(2**31) + 1200]
    lqs = [MQ.LoweredQuery.from_arrays(a) for a in arrays]
    shape = lqs[0].shape
    progs = MQ.pack_queries(lqs, MQ._p2(q, lo=1))
    rows = torch.from_numpy(MQ._program_rows(progs)).to(cuda)
    q_b = rows.shape[0]
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    span_mat = torch.from_numpy(np.stack([cols[n] for n in shape.span_cols]) if shape.span_cols
                                else np.zeros((0, TC.N_SPANS_B), np.int32)).to(cuda)
    plain_mat = span_mat if shape.span_cols else torch.zeros((1, TC.N_SPANS_B),
                                                             dtype=torch.int32, device=cuda)
    trace_mat = torch.from_numpy(np.stack([cols[n] for n in shape.trace_cols])).to(cuda)
    span_off = torch.from_numpy(cols["trace.span_off"]).to(cuda)
    ntb = {"short_tile": 1012, "ragged": 1022}.get(case, TC.N_TRACES_B)
    span_off, trace_mat = span_off[:ntb + 1].contiguous(), trace_mat[:, :ntb].contiguous()
    tables = MQ.program_tables(rows, dims)
    if case == "ragged":
        kernels.reset_counts()
        with pytest.raises(kernels.KernelError):
            kernels.mq_partial(rows, dims, span_mat, 0, span_off, TC.N_SPANS)
        counts = torch.zeros((q_b, dims[2] + 1, ntb), dtype=torch.int32, device=cuda)
        with pytest.raises(kernels.KernelError):
            kernels.mq_combine_packed(rows, dims, counts, trace_mat, TC.N_TRACES)

        def off16(*shape):  # a view 4 bytes past a 16-byte boundary
            n = int(np.prod(shape))
            return torch.zeros(n + 1, dtype=torch.int32, device=cuda)[1:].view(*shape)

        n_tc, full = trace_mat.shape[0], (q_b, dims[2] + 1, TC.N_TRACES_B)
        with pytest.raises(kernels.KernelError):
            kernels.mq_combine_packed(rows, dims, off16(*full), torch.zeros(
                (n_tc, TC.N_TRACES_B), dtype=torch.int32, device=cuda), TC.N_TRACES)
        with pytest.raises(kernels.KernelError):
            kernels.mq_combine_packed(rows, dims, torch.zeros(full, dtype=torch.int32, device=cuda),
                                      off16(n_tc, TC.N_TRACES_B), TC.N_TRACES)
        assert not any(kernels.grid_launches().values())
        return

    def m2(r0, r1):
        kernels.reset_counts()
        got = kernels.mq_partial(rows, dims, span_mat[:, r0:r1].contiguous(), r0, span_off,
                                 TC.N_SPANS)
        assert kernels.grid_launches()["mq_partial"] == 1
        want = MQ._mq_partial_plain(plain_mat[:, r0:r1], span_off, tables, r0, TC.N_SPANS)
        assert torch.equal(got, want), (case, r0, r1)
        return got

    assert not m2(1536, TC.N_SPANS_B).any()
    b5a = case not in ("short_tile", "wrap")
    if b5a:
        staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, cuda)
        tm1, c1 = MQ.eval_multiquery(lqs, staged, progs)
        assert tm1.any()
    for w, bounds in MQ_BOUNDS.items():
        total = torch.stack([m2(r0, r1) for r0, r1 in zip(bounds, bounds[1:])]).sum(
            dim=0, dtype=torch.int32)
        kernels.reset_counts()
        packed = kernels.mq_combine_packed(rows, dims, total, trace_mat, TC.N_TRACES)
        assert kernels.grid_launches()["mq_combine"] == 1
        assert packed.dtype == torch.uint8 and packed.numel() == 5 * q_b * ntb
        tm, cnt = kernels.mq_views(packed, q_b, ntb)
        assert cnt.data_ptr() == packed.data_ptr()
        assert tm.data_ptr() == packed.data_ptr() + 4 * q_b * ntb
        ptm, pcnt = MQ._mq_combine_plain(total, trace_mat, tables, TC.N_TRACES)
        assert torch.equal(tm, ptm) and torch.equal(cnt, pcnt), (case, w)
        htm, hcnt = kernels.mq_views(packed.cpu(), q_b, ntb)  # one download
        assert torch.equal(htm, ptm.cpu()) and torch.equal(hcnt, pcnt.cpu())
        if b5a:
            assert torch.equal(tm, tm1) and torch.equal(cnt, c1), (case, w)


def _stacked(rng, B=4, S=4096, R=1024, NT=1024):
    n_spans = np.asarray([S - 100, S, 300, 0][:B], np.int32)
    cols = {
        "span.start_ms": rng.integers(-5_000, 70_000, (B, S)).astype(np.int32),
        "span.trace_sid": np.sort(rng.integers(0, 200, (B, S)), axis=1).astype(np.int32),
        "span.dur_us": rng.integers(0, 40, (B, S)).astype(np.int32),
        "span.res_idx": rng.integers(-1, 50, (B, S)).astype(np.int32),
        "res.service_id": rng.integers(-1, 6, (B, R)).astype(np.int32),
        "trace.dur_ms": rng.integers(0, 100, (B, NT)).astype(np.int32),
    }
    val = rng.integers(-8, 9, (B, S)).astype(np.float32) * np.float32(0.25)
    hit = rng.random((B, S)) < 0.03
    val[hit] = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)[
        rng.integers(0, 5, hit.sum())]
    return cols, n_spans, val


@pytest.mark.parametrize("has_val", [False, True])
def test_timeseries_stacked_matches_plain(cuda, has_val):
    """M4 over 4 stacked blocks (span, res and trace conditions, one
    operand set a block) against its plain version: counts, value counts
    and the encoded min / max exact (NaN, +-0, +-inf among the values),
    f32 sums at rtol 1e-5; then the finish against the plain decode."""
    rng = np.random.default_rng(2 + has_val)
    cols_np, n_spans, val = _stacked(rng)
    B, S = cols_np["span.start_ms"].shape
    specs = [("span", "span.dur_us", "gt", False), ("res", "res.service_id", "eq", False),
             ("trace", "trace.dur_ms", "ge", False), ("span", "span.dur_us", "ge", True)]
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    tree = ("and", ("or", ("cond", 0), ("cond", 1)), ("or", ("cond", 2), ("cond", 3)))
    operands = [F.Operands.build([(0, 20 + b, 0, 0.0, 0.0), (0, b % 3, 0, 0.0, 0.0),
                                  (0, 60 - 5 * b, 0, 0.0, 0.0), (0, 0, 0, 30.5 - b, 0.0)])
                for b in range(B)]
    cols = {k: torch.from_numpy(v).to(cuda) for k, v in cols_np.items()}
    cols["span@res.service_id"] = torch.stack([
        ST.res_to_span(cols["res.service_id"][b], cols["span.res_idx"][b]) for b in range(B)])
    gid = torch.from_numpy(rng.integers(-1, 5, (B, S)).astype(np.int32)).to(cuda)
    v = torch.from_numpy(val).to(cuda) if has_val else None
    pres = torch.from_numpy(rng.random((B, S)) < 0.8).to(cuda) if has_val else None
    t0 = torch.tensor([-3_000, 0, 12_345, 7], dtype=torch.int32, device=cuda)
    ns = torch.from_numpy(n_spans).to(cuda)
    kernels.reset_counts()
    got = TS.timeseries_stacked((tree, conds), cols, operands, gid, v, pres, t0, ns, 10_000, 7, 5)
    assert kernels.LAUNCHES["timeseries_stacked"] == 1
    want = TS._timeseries_stacked_plain(tree, conds, cols, operands, gid, v, pres,
                                        t0.tolist(), n_spans.tolist(), 10_000, 7, 5)
    assert len(got) == len(want) == (5 if has_val else 1) and int(got[0].sum()) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5)
        else:
            assert torch.equal(g, w), i
    if has_val:
        a, b = got[3].clone(), got[4].clone()
        mn, mx = kernels.timeseries_stacked_finish(a, b)
        np.testing.assert_array_equal(mn.cpu().numpy(), TS.ts_decode(want[3].cpu()).numpy())
        np.testing.assert_array_equal(mx.cpu().numpy(), TS.ts_decode(want[4].cpu()).numpy())
        assert torch.isnan(mn).any()


STACKED_ROUTES = [(route, bl, has_val) for route in ("shared", "cluster", "global")
                  for bl, has_val in ((1, True), (3, True), (10, True), (3, False), (40, True))]


@pytest.mark.parametrize("route,bl,has_val", STACKED_ROUTES)
def test_timeseries_stacked_routes(cuda, route, bl, has_val):
    """M4 on each route, forced through kernels.timeseries_route, over 1,
    3, 10 and 40 stacked blocks (40: past the TS_BLOCKS rows carried by
    value, so the block table is read on the card) of
    torch_tile_cases.stacked_case (span counts of 0 and S, group ids
    negative and past the grid, start - t0 wrapping in int32, NaN, +-0
    and +-inf values) against _timeseries_stacked_plain: one cooperative
    __global__ a fold, counts, value counts and the encoded min / max
    exact, the dyadic sums exact; then the finish against the plain
    decode."""
    case = stacked_case(20 + bl, bl, has_val=has_val)
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in STACKED_SPECS)
    operands = [F.Operands.build(r) for r in case["rows"]]
    cols = {k: torch.from_numpy(v).to(cuda) for k, v in case["cols"].items()}
    cols["span@res.service_id"] = torch.stack([
        ST.res_to_span(cols["res.service_id"][b], cols["span.res_idx"][b]) for b in range(bl)])
    gid = torch.from_numpy(case["gid"]).to(cuda)
    v = torch.from_numpy(case["val"]).to(cuda) if has_val else None
    pres = torch.from_numpy(case["pres"]).to(cuda) if has_val else None
    G, NB, step = STACKED_G, STACKED_NB, STACKED_STEP
    plan = kernels.timeseries_route(route, G * NB, has_val)
    kernels.reset_counts()
    got = TS.timeseries_stacked((STACKED_TREE, conds), cols, operands, gid, v, pres, case["t0"],
                                case["n_spans"], step, NB, G, plan=plan)
    assert kernels.LAUNCHES["timeseries_stacked"] == 1
    assert kernels.grid_launches()["timeseries_stacked"] == 1
    want = TS._timeseries_stacked_plain(STACKED_TREE, conds, cols, operands, gid, v, pres,
                                        case["t0"].tolist(), case["n_spans"].tolist(), step, NB, G)
    assert len(got) == len(want) == (5 if has_val else 1) and int(want[0].sum()) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(), err_msg=f"output {i}")
    if has_val:
        mn, mx = kernels.timeseries_stacked_finish(got[3].clone(), got[4].clone())
        np.testing.assert_array_equal(mn.cpu().numpy(), TS.ts_decode(want[3].cpu()).numpy())
        np.testing.assert_array_equal(mx.cpu().numpy(), TS.ts_decode(want[4].cpu()).numpy())
        assert torch.isnan(mn).any() and torch.isinf(mx).any()


def test_host_entries_on_nccl_world_1(cuda, tmp_path):
    """The five host entries on an NCCL mesh of one rank equal the
    single-card routes (the collectives run, over one rank)."""
    backend, traces = _store(3)
    db = _db(backend, cuda)
    blocks = [db.open_block(m) for m in db.metas(TENANT)]
    ids = [tid for batch in traces for tid, _ in batch[::9]] + [b"\x05" * 16]
    q = np.asarray([S.trace_id_to_codes(t) for t in ids], np.int32)
    codes = [b.trace_index["trace.id_codes"] for b in blocks]
    want_elect = sharded_find(Mesh(1, 1, "cpu"), codes, q)  # the CPU port, no group
    mesh = launch.init_controller(1, f"file://{tmp_path}/pg", "nccl", cuda, timeout_s=60)
    try:
        assert mesh.backend == "nccl" and db.mesh is mesh and db._batch_mesh() is None
        want_rows = FD.lookup_ids_blocks_cached(blocks, q, cuda)
        np.testing.assert_array_equal(sharded_find_rows(mesh, codes, q), want_rows)
        kernels.reset_counts()
        elect = sharded_find(mesh, codes, q)
        assert kernels.LAUNCHES["find_elect"] == 1 and kernels.LAUNCHES["find"] == 0
        assert kernels.grid_launches()["find_elect"] == 1
        np.testing.assert_array_equal(elect, want_elect)
        hit = (want_rows >= 0).any(axis=0)
        assert (elect[~hit] == -1).all() and hit.sum() == len(ids) - 1
        for qi in np.nonzero(hit)[0]:
            b = np.nonzero(want_rows[:, qi] >= 0)[0].max()
            assert tuple(elect[qi]) == (b, want_rows[b, qi])
        blooms = []
        for blk in blocks:
            bl = ShardedBloom(blk.meta.bloom_shards, blk.meta.bloom_shard_bits)
            bl.words = np.stack([blk.bloom_shard(i) for i in range(blk.meta.bloom_shards)])
            blooms.append(bl)
        kernels.reset_counts()
        gathers = mesh.calls.get("all_gather", 0)
        union = sharded_bloom_union(mesh, blooms).words
        # one rank: one B10a over its blooms, no all_gather, no union of one partial
        assert kernels.LAUNCHES["bloom_union"] == kernels.grid_launches()["bloom_union"] == 1
        assert mesh.calls.get("all_gather", 0) == gathers
        np.testing.assert_array_equal(union, BO.union_blooms(blooms, cuda).words)
        blk = blocks[0]
        plans = [_plan_for_block(blk, SearchRequest(query=x)) for x in BURST]
        lqs = [MQ.lower_plan(p) for p in plans]
        staged = ST.stage_block(blk, F.required_columns(plans[0].conds) + ["trace.start_ms"],
                                device=cuda)
        progs = MQ.pack_queries(lqs, 16)
        tm, cnt = mesh_eval_multiquery(mesh, lqs, staged, progs)
        tm1, c1 = MQ.eval_multiquery(lqs, staged, progs)
        np.testing.assert_array_equal(tm, tm1.cpu().numpy())
        np.testing.assert_array_equal(cnt, c1.cpu().numpy())
        lo = min(m.start_time_unix_nano for m in db.metas(TENANT)) // 10**9
        hi = -(-max(m.end_time_unix_nano for m in db.metas(TENANT)) // 10**9)
        for query in METRICS:
            req = ME.align_params(query, lo, hi + 1, 0.5)
            want = ME.metrics_query_range_blocks(blocks, req, device=cuda)
            resp = ME.MetricsResponse(fn=want.fn, start_ms=req.start_ms, step_ms=req.step_ms,
                                      n_buckets=req.n_buckets, label_names=want.label_names)
            assert try_metrics_mesh(mesh, blocks, ME.parse_metrics_query(query), req, resp), query
            _same_series(resp, want)
        secs = mesh.collective_seconds()
        assert secs.get("all_reduce", 0) > 0 and mesh.calls["gather"] >= 1
    finally:
        launch.shutdown(mesh, [])


def _same_series(got, want):
    assert got.series and set(got.series) == set(want.series)
    for k, st in want.series.items():
        for f, arr in st.items():
            if f == "vsum":
                np.testing.assert_allclose(got.series[k][f], arr, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got.series[k][f], arr)
    assert got.inspected_spans == want.inspected_spans


def test_gloo_2x2_on_one_card(cuda, tmp_path):
    """Four ranks on cuda:0 over gloo: the card TempoDB's finds, a
    16-query burst and metrics take the mesh routes and equal a CPU
    TempoDB's answers."""
    backend, traces = _store(3)
    init = f"file://{tmp_path}/pg"
    procs = launch.spawn_followers(4, init, "gloo", cuda, dp=2, sp=2, timeout_s=120)
    mesh = launch.init_controller(4, init, "gloo", cuda, dp=2, sp=2, timeout_s=120)
    try:
        db = _db(backend, cuda)
        assert db.mesh is mesh
        r0 = BX.routing_counts()
        meta = db.metas(TENANT)[0]
        ids = [tid for batch in traces for tid, _ in batch[:8]] + [b"\x09" * 16] * 2
        got = db.find_in_blocks_multi([(TENANT, t, db.metas(TENANT)) for t in ids])
        items = [(TENANT, [meta], SearchRequest(query=x, limit=20)) for x in BURST]
        burst = db.search_blocks_multi(items)
        lo = min(m.start_time_unix_nano for m in db.metas(TENANT)) // 10**9
        hi = -(-max(m.end_time_unix_nano for m in db.metas(TENANT)) // 10**9)
        series = [db.metrics_query_range(TENANT, ME.align_params(x, lo, hi + 1, 0.5))
                  for x in METRICS]
        routes = {k: v - r0.get(k, 0) for k, v in BX.routing_counts().items()
                  if v != r0.get(k, 0)}
        id_codes = [db.open_block(m).trace_index["trace.id_codes"] for m in db.metas(TENANT)]
        q = np.asarray([S.trace_id_to_codes(t) for t in ids], np.int32)
        kernels.reset_counts()
        elect = sharded_find(mesh, id_codes, q)  # rank 0's launches: one fused M1
        elect_launches = (kernels.LAUNCHES["find_elect"], kernels.LAUNCHES["find"])
    finally:
        codes = launch.shutdown(mesh, procs, join_timeout_s=60)
    assert codes == [0, 0, 0]
    assert elect_launches == (1, 0)
    np.testing.assert_array_equal(elect, sharded_find(Mesh(1, 1, "cpu"), id_codes, q))
    assert (elect[:, 0] >= 0).sum() == len(ids) - 2  # the absent id, twice
    # the CPU answers, without a mesh (the group is gone)
    cpu = _db(backend, "cpu")
    want = cpu.find_in_blocks_multi([(TENANT, t, cpu.metas(TENANT)) for t in ids])
    assert [None if t is None else dataclasses.asdict(t) for t in got] == \
        [None if t is None else dataclasses.asdict(t) for t in want]
    wburst = cpu.search_blocks_multi(items)
    assert [[dataclasses.asdict(t) for t in r.traces] for r in burst] == \
        [[dataclasses.asdict(t) for t in r.traces] for r in wburst]
    for x, s in zip(METRICS, series):
        _same_series(s, cpu.metrics_query_range(TENANT, ME.align_params(x, lo, hi + 1, 0.5)))
    assert routes.get(("find_batch", "mesh", "coalesced"), 0) == len(ids)
    assert routes.get(("search_batch", "mesh", "mesh_batched"), 0) == len(BURST)
    assert routes.get(("metrics_mesh", "device", "stacked"), 0) > 0, routes
