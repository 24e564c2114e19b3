"""Seeded random TraceQL searches and metrics queries through both
packages' query frontends on the CPU: the port's Frontend (its Querier
on device="cpu") against the JAX package's, each with one worker, over
the four blocks of test_torch_reference.slice_dbs (two make_traces
blocks, one written by each package, and two synth blocks).

Searches draw spanset filters with &&, ||, the structural operators
(>, >>, ~), regexes, arithmetic, count(), parent. and duration bounds,
at a limit above the match count (the slice holds 752 traces), so the
merge order of the jobs cannot choose the answer: equal traces (every
field) and inspected spans. Metrics queries draw six functions, zero
to two by() fields and random ranges and steps of 1-300 s, and go
through the time-sharded path (two or more jobs a query): equal headers,
series and counts, min and max, and inspected spans; sums at rtol 1e-5,
compared as arrays and not through to_prometheus strings (partials of
several blocks merge in another order). A query one package refuses
must raise the same exception type in the other."""

import dataclasses
import random

import numpy as np
import pytest
from test_torch_reference import TENANT, slice_dbs

from tempo_tpu.db import metrics_exec as RME
from tempo_tpu.db import search as r_search
from tempo_tpu.services import frontend as r_fe
from tempo_tpu.services.querier import Querier as RQuerier
from tempo_tpu_torch.db import metrics_exec as ME
from tempo_tpu_torch.db import search as SM
from tempo_tpu_torch.services import frontend as FE
from tempo_tpu_torch.services.querier import Querier
from tempo_tpu_torch.util import breaker

NAMES = ["GET /", "GET /api", "db.query", "cache.get", "render", "op-0001", "op-0042", "op-0100"]
SERVICES = ["db", "auth", "frontend", "checkout", "svc-007", "svc-012", "svc-030"]
KINDS = ["server", "client", "internal", "producer", "consumer"]
BY = ["resource.service.name", "name", "kind", "status", "span.http.status_code"]
FUNCS = ["rate()", "count_over_time()", "sum_over_time(duration)", "avg_over_time(duration)",
         "min_over_time(duration)", "max_over_time(duration)"]
LIMIT = 1000  # above the slice's 752 traces


def _cond(r: random.Random) -> str:
    k = r.randrange(9)
    if k == 0:
        return f'name {r.choice(["=", "!="])} "{r.choice(NAMES)}"'
    if k == 1:
        return f'duration {r.choice([">", "<", ">=", "<="])} {r.choice([1, 10, 100, 500, 1500])}ms'
    if k == 2:
        return f'status {r.choice(["=", "!="])} {r.choice(["error", "ok", "unset"])}'
    if k == 3:
        return f'kind {r.choice(["=", "!="])} {r.choice(KINDS)}'
    if k == 4:
        return f'span.http.status_code {r.choice(["=", ">=", "<", "!="])} {r.choice([200, 404, 500])}'
    if k == 5:
        return f'resource.service.name {r.choice(["=", "!=", "=~"])} "{r.choice(SERVICES)}"'
    if k == 6:
        return f'name =~ "{r.choice(["op-00[0-4].*", "GET.*", "db\\\\..*", ".*e.*"])}"'
    if k == 7:
        return f'parent.kind = {r.choice(KINDS)}'
    return f'span.http.status_code * 2 {r.choice([">", "<"])} {r.choice([500, 900])}'


def _filter(r: random.Random) -> str:
    body = _cond(r)
    for _ in range(r.randrange(3)):
        body = f'{body} {r.choice(["&&", "||"])} {_cond(r)}'
    return "{ " + body + " }"


def _search_query(r: random.Random) -> str:
    q = _filter(r)
    shape = r.randrange(6)
    if shape == 1:
        q = f'{q} {r.choice(["&&", "||", ">", ">>", "~"])} {_filter(r)}'
    elif shape == 2:
        q = f'{q} | count() {r.choice([">", ">=", "="])} {r.choice([1, 2, 3])}'
    elif shape == 3:
        q = "{ nil }" if r.random() < 0.2 else q
    return q


def _metrics_query(r: random.Random) -> str:
    by = r.sample(BY, r.randrange(3))
    tail = f" by ({', '.join(by)})" if by else ""
    return f"{_filter(r)} | {r.choice(FUNCS)}{tail}"


@pytest.fixture(autouse=True)
def _reset_port_breakers():
    breaker.reset_for_tests()
    yield
    breaker.reset_for_tests()


@pytest.fixture(scope="module")
def fronts(tmp_path_factory):
    """(port Frontend, reference Frontend, the slice's time span), one
    worker each, no hedging."""
    gen = slice_dbs(tmp_path_factory.mktemp("frontend-diff"))
    port, ref, _ = next(gen)
    pf = FE.Frontend(Querier(port, None, None), n_workers=1, hedge_after_s=0.0)
    rf = r_fe.Frontend(RQuerier(ref, None, None), n_workers=1, hedge_after_s=0.0)
    metas = port.metas(TENANT)
    span = (min(m.start_time_unix_nano for m in metas) // 10**9,
            -(-max(m.end_time_unix_nano for m in metas) // 10**9))
    yield pf, rf, span
    pf.stop()
    rf.stop()
    pf.querier.close()
    next(gen, None)


def _both(fn_port, fn_ref):
    """Both calls' results, or both exceptions' types (which must agree)."""
    try:
        got = fn_port()
    except Exception as e:  # noqa: BLE001 - compared with the reference's below
        got = e
    try:
        want = fn_ref()
    except Exception as e:  # noqa: BLE001
        want = e
    if isinstance(got, Exception) or isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__, (got, want)
        return None, None
    return got, want


@pytest.mark.parametrize("seed", range(8))
def test_random_searches_match_reference(fronts, seed):
    pf, rf, (lo, hi) = fronts
    r = random.Random(1000 + seed)
    n_matched = 0
    for _ in range(12):
        q = _search_query(r)
        start = end = 0
        if r.random() < 0.3:  # a random window of the slice's hour
            start = r.randrange(lo, hi)
            end = r.randrange(start + 1, hi + 60)
        kw = dict(query=q, start=start, end=end, limit=LIMIT)
        if r.random() < 0.2:
            kw["min_duration_ms"] = r.choice([1, 50, 300])
        got, want = _both(lambda: pf.search(TENANT, SM.SearchRequest(**kw)),
                          lambda: rf.search(TENANT, r_search.SearchRequest(**kw)))
        if got is None:
            continue
        assert [dataclasses.asdict(t) for t in got.traces] == \
            [dataclasses.asdict(t) for t in want.traces], kw
        assert got.inspected_spans == want.inspected_spans, kw
        assert len(got.traces) < LIMIT
        n_matched += bool(got.traces)
    assert n_matched >= 3


@pytest.mark.parametrize("seed", range(8))
def test_random_metrics_match_reference(fronts, seed):
    pf, rf, (lo, hi) = fronts
    r = random.Random(2000 + seed)
    n_series = 0
    for _ in range(8):
        q = _metrics_query(r)
        step = r.choice([1, 7, 15, 60, 120, 300])
        start = r.randrange(lo - 60, hi)
        end = r.randrange(start + step, hi + 120)
        got, want = _both(
            lambda: pf.metrics_query_range(TENANT, ME.align_params(q, start, end, step)),
            lambda: rf.metrics_query_range(TENANT, RME.align_params(q, start, end, step)))
        if got is None:
            continue
        assert (got.fn, got.start_ms, got.step_ms, got.n_buckets, tuple(got.label_names)) == \
            (want.fn, want.start_ms, want.step_ms, want.n_buckets, tuple(want.label_names)), q
        assert set(got.series) == set(want.series), q
        assert got.inspected_spans == want.inspected_spans, q
        for k, st in want.series.items():
            assert set(got.series[k]) == set(st), (q, k)
            for f, arr in st.items():
                if f == "vsum":
                    np.testing.assert_allclose(got.series[k][f], arr, rtol=1e-5, atol=0,
                                               err_msg=q)
                else:
                    np.testing.assert_array_equal(got.series[k][f], arr, err_msg=q)
        n_series += len(got.series)
    assert n_series >= 1
