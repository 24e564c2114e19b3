"""The port's TraceQL metrics path on the CPU against the JAX package's:
the span-level planner (plan_metrics_filter), the timeseries fold (B6's
plain version against the reference's jitted `_compiled_ts` run), the
host span-mask engine, and TempoDB.metrics_query_range over one local
backend (tests/test_metrics_query.py's fixture and queries).

Counts, value counts, min and max are exact. The f32 sum of the fold
depends on the order of the adds: it is held to rtol 1e-5 (the
reference's own engine tolerance, tests/test_metrics_query.py:256) on
positive values and exactly on dyadic ones."""

import dataclasses

import numpy as np
import pytest
import torch
import test_torch_cases as TC
from test_metrics_query import ENGINE_QUERIES, PARSE_OK, RATE_Q, _req
from test_metrics_query import fixture_db  # noqa: F401  (the reference's fixture)

from tempo_tpu.db import metrics_exec as RME
from tempo_tpu.ops import filter as RF
from tempo_tpu.ops import hostfilter as RHF
from tempo_tpu.ops import timeseries as RTS
from tempo_tpu.parallel import make_mesh
from tempo_tpu.traceql import plan as RP
from tempo_tpu.traceql.parser import parse as r_parse
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.db import metrics_exec as ME
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import hostfilter as HF
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops import timeseries as TS
from tempo_tpu_torch.traceql import plan as P
from tempo_tpu_torch.traceql.parser import parse

# the exact-route queries of tests/test_metrics_query.py:261
EXACT_QUERIES = ['{ .w > 5.0 } | rate()', '{ span.foo = "bar" } | count() = 1 | rate()']
PLAN_QUERIES = PARSE_OK + ENGINE_QUERIES + EXACT_QUERIES + [
    '{ span.foo = "nope" } | rate()',  # dictionary miss: pruned
    '{ resource.service.name = "a" && duration > 1s } | count_over_time()',
    '{ span.foo = "bar" } >> { span.foo = "bar" } | rate()',
    '{ traceDuration > 2s || name = "op1" } | rate() by(name)',
]


@pytest.fixture(scope="module")
def both(fixture_db):  # noqa: F811
    """(port TempoDB on the CPU, reference TempoDB, metas) over the
    reference fixture's backend; the reference folds on one device."""
    ref, metas = fixture_db
    ref._mesh = make_mesh(1)
    port = TempoDB(TempoDBConfig(), backend=LocalBackend(ref.backend.path), device="cpu")
    port.poll_now()
    return port, ref, metas


def _cond_fields(conds):
    return [(c.target, c.col, c.op, c.is_float, c.needs_verify) for c in conds]


@pytest.mark.parametrize("query", PLAN_QUERIES)
def test_plan_metrics_filter_matches_reference(both, query):
    port, ref, metas = both
    d_ref = ref.open_block(metas[0]).dictionary
    pmeta = next(m for m in port.metas("t") if m.block_id == metas[0].block_id)
    d_port = port.open_block(pmeta).dictionary
    want = RP.plan_metrics_filter(r_parse(query), d_ref)
    got = P.plan_metrics_filter(parse(query), d_port)
    assert (got.tree, got.prune, got.needs_verify) == (want.tree, want.prune, want.needs_verify)
    assert _cond_fields(got.conds) == _cond_fields(want.conds)
    assert [tuple(r) for r in got.rows] == [tuple(r) for r in want.rows]
    assert sorted(got.tables) == sorted(want.tables)
    for i in want.tables:
        np.testing.assert_array_equal(np.asarray(got.tables[i]), np.asarray(want.tables[i]))


def _fold_both(case, n_groups, n_buckets, has_val, dyadic, t0, step):
    specs, tree, rows, tables = TC.filter_cases()[case]
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    cols = TC.make_cols(seed=len(case))
    inp = TC.ts_inputs(len(case) + n_groups, n_groups, dyadic)
    cols["span.start_ms"] = inp["span.start_ms"]
    rops = RF.Operands.build(rows, tables)
    table_idxs, tabs = RTS._table_list(rops)
    G_b, B_b = TS.bucket(n_groups), TS.bucket(n_buckets)
    fn = RTS._compiled_ts(tree, rconds, table_idxs, has_val, TC.N_SPANS_B, TC.N_RES_B,
                          TC.N_TRACES_B, G_b, B_b)
    empty = np.zeros(0, np.float32)
    want = fn(cols, rops.ints, rops.floats, tabs, inp["gid"],
              inp["val"] if has_val else empty, inp["vpres"] if has_val else empty,
              np.int32(t0), np.int32(step), np.int32(TC.N_SPANS), np.int32(n_buckets))
    want = [np.asarray(w)[:n_groups, :n_buckets] for w in want]
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    got = TS.timeseries_fold(
        (tree, conds), staged.cols, F.Operands.build(rows, tables),
        torch.from_numpy(inp["gid"]), torch.from_numpy(inp["val"]) if has_val else None,
        torch.from_numpy(inp["vpres"]) if has_val else None, t0, step, TC.N_SPANS, n_buckets,
        n_groups, TC.N_SPANS_B, TC.N_RES_B, TC.N_TRACES_B)
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("case", sorted(TC.span_level_cases()))
@pytest.mark.parametrize("has_val", [False, True])
def test_fold_matches_reference(case, has_val):
    """Negative t0 (spans before the origin floor into negative buckets)
    and gid -1 spans dropped; 12 groups x 50 buckets."""
    got, want = _fold_both(case, 12, 50, has_val, False, -3_000, 9_000)
    assert len(got) == len(want) == (5 if has_val else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{case} output {i}")


@pytest.mark.parametrize("case", ["op_exists", "and_or_mixed", "trace_int", "rattr_int",
                                  "sattr_int", "res_eq", "tree_none"])
def test_fold_dyadic_sums_exact(case):
    got, want = _fold_both(case, 7, 33, True, True, 2_500, 17_000)
    assert got[0].sum() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=case)


@pytest.mark.parametrize("case", sorted(TC.span_level_cases()))
def test_host_span_mask_matches_reference(case):
    """The numpy span-mask engine over raw columns (owner-row layout)."""
    specs, tree, rows, tables = TC.filter_cases()[case]
    cols = TC.make_cols(seed=len(case), layout="owners")
    raw = {k: (v[: TC.N_SPANS] if k.startswith("span.") else
               v[: TC.N_TRACES] if k.startswith("trace.") else
               v[: TC.N_RES] if k.startswith("res.") else v) for k, v in cols.items()}
    for pre in ("sattr", "rattr"):  # drop the padded attr rows
        n = int((raw[f"{pre}.key_id"] != TC.INT_MIN).sum())
        raw.update({k: v[:n] for k, v in raw.items() if k.startswith(pre + ".")})
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    want = RHF.eval_span_mask_host((tree, rconds), raw, RF.Operands.build(rows, tables),
                                   TC.N_SPANS, TC.N_TRACES)
    got = HF.eval_span_mask_host((tree, conds), raw, F.Operands.build(rows, tables),
                                 TC.N_SPANS, TC.N_TRACES)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", [">", ">>", "~"])
def test_host_struct_mask_matches_reference(op):
    cols = TC.make_cols(seed=3)
    rng = np.random.default_rng(4)
    lm, rm = rng.random(TC.N_SPANS) < 0.3, rng.random(TC.N_SPANS) < 0.5
    pidx = cols["span.parent_idx"][: TC.N_SPANS]
    np.testing.assert_array_equal(HF._struct_mask_np(op, lm, rm, pidx, TC.N_SPANS),
                                  RHF._struct_mask_np(op, lm, rm, pidx, TC.N_SPANS))


def _same_series(got, want):
    assert (got.fn, got.start_ms, got.step_ms, got.n_buckets, got.label_names) == \
        (want.fn, want.start_ms, want.step_ms, want.n_buckets, want.label_names)
    assert set(got.series) == set(want.series)
    for k, state in want.series.items():
        assert set(got.series[k]) == set(state)
        for f, arr in state.items():
            if f in ("count", "vcnt"):
                np.testing.assert_array_equal(got.series[k][f], arr, err_msg=f"{k} {f}")
            else:  # f32 folds merged in f64: the engines' own tolerance
                np.testing.assert_allclose(got.series[k][f], arr, rtol=1e-5, err_msg=f"{k} {f}")
    assert got.inspected_spans == want.inspected_spans


@pytest.mark.parametrize("query", ENGINE_QUERIES + EXACT_QUERIES)
def test_metrics_query_range_matches_reference(both, query):
    port, ref, _ = both
    req = _req(query)
    got = port.metrics_query_range("t", ME.MetricsRequest(req.query, req.start_ms, req.end_ms,
                                                          req.step_ms))
    want = ref.metrics_query_range("t", req)
    _same_series(got, want)
    assert ME.to_prometheus(got) == RME.to_prometheus(want)


def test_step_realignment_matches_reference(both):
    port, ref, _ = both
    want = ref.metrics_query_range("t", _req(RATE_Q, start=1_700_000_003, end=1_700_000_037))
    got = port.metrics_query_range("t", ME.align_params(RATE_Q, 1_700_000_003, 1_700_000_037, 10))
    assert got.start_ms == 1_700_000_000_000 and got.n_buckets == 4
    _same_series(got, want)


@pytest.mark.parametrize("query", [RATE_Q, '{ true } | max_over_time(duration) by(name)'])
def test_i32_overflow_takes_the_host_route(both, query):
    """A 30-day step: the step and the block-relative origin pass int32
    milliseconds, so the fold runs on the int64 numpy engine -- the
    reference's own route, with the same answers."""
    port, ref, _ = both
    step = 30 * 86_400
    before = BX.routing_counts().get(("metrics", "host", "i32_range"), 0)
    got = port.metrics_query_range("t", ME.align_params(query, 1_700_000_000 - 5 * 86_400,
                                                        1_700_000_040, step))
    want = ref.metrics_query_range("t", RME.align_params(query, 1_700_000_000 - 5 * 86_400,
                                                         1_700_000_040, step))
    assert got.step_ms > 2**31 and got.series
    _same_series(got, want)
    assert BX.routing_counts()[("metrics", "host", "i32_range")] == before + 2


def test_metrics_request_axis_matches_reference():
    for args in [("{ true } | rate()", 103, 158, 10), ("{ true } | rate()", 7, 7, 0.5)]:
        assert dataclasses.asdict(ME.align_params(*args)) == \
            dataclasses.asdict(RME.align_params(*args))
    with pytest.raises(ValueError):
        ME.align_params("{ true } | rate()", 0, 10_000_000, 1)


def test_span_program_buffer_builds_from_metrics_staging(both):
    """The metrics fold stages no trace.span_off: the span program's
    descriptor buffer (B6's operands on a card) must build from what it
    does stage -- here on the CPU, where the same code lays it out."""
    port, _, _ = both
    blk = port.open_block(port.metas("t")[0])
    q = ME.parse_metrics_query('{ span.foo = "bar" && traceDuration > 1s } | rate() by(name)')
    planned = P.plan_metrics_filter(q, blk.dictionary)
    needed = [n for n in F.required_columns(planned.conds) if n != "trace.span_off"]
    staged = ST.stage_block(blk, needed + ["span.start_ms"], device="cpu")
    assert "trace.span_off" not in staged.cols
    ops = F.Operands.build(planned.rows, planned.tables or None)
    prog = TS._span_program(planned.tree, tuple(planned.conds))
    buf = prog.buffer(staged.cols, ops, TS._table_list(ops))
    assert buf.device.type == "cpu" and buf.dtype == torch.uint8
    assert prog.trace_conds and prog.span_conds and len(prog.steps) == 1
