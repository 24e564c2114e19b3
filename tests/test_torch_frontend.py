"""The port's read plane on the CPU against the JAX package's: the query
frontend's fair queue (RequestQueue), its sharded find, search and
metrics over the four blocks of test_torch_reference.slice_dbs, QoS
admission, the retry budget, hedging, the result cache (an exact hit and
an incremental extension), and the remote job plane (poll_job ->
worker.execute_job -> complete_job, single and `multi` jobs).

Each side runs its own Frontend over its own TempoDB of one store: the
port's Querier on device="cpu" (the kernels' plain versions), the
reference's on the CPU. A search's answer at a limit depends on the
order its jobs complete in, so the frontends run one worker, or the
limit holds every match. Traces, inspected spans, metrics counts, min
and max are exact; metrics sums at rtol 1e-5 (block partials merge in
another order)."""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest
from test_torch_reference import TENANT, slice_dbs

from tempo_tpu.backend.base import BackendError as RBackendError
from tempo_tpu.db import search as r_search
from tempo_tpu.db import metrics_exec as RME
from tempo_tpu.services import frontend as r_fe
from tempo_tpu.services import resultcache as r_rc
from tempo_tpu.services import worker as r_worker
from tempo_tpu.services.overrides import Limits as RLimits
from tempo_tpu.services.overrides import Overrides as ROverrides
from tempo_tpu.services.querier import Querier as RQuerier
from tempo_tpu_torch.backend import BackendError
from tempo_tpu_torch.db import metrics_exec as ME
from tempo_tpu_torch.db import search as SM
from tempo_tpu_torch.services import frontend as FE
from tempo_tpu_torch.services import resultcache as RC
from tempo_tpu_torch.services import worker as W
from tempo_tpu_torch.services.overrides import Limits, Overrides
from tempo_tpu_torch.services.querier import Querier
from tempo_tpu_torch.util import breaker

SEARCHES = [
    ('{ resource.service.name = "db" }', 20),
    ('{ duration > 100ms }', 200),
    ('{ kind = server } && { status = error }', 20),
    ('{ name = "op-0042" || span.http.status_code = 500 }', 200),
]
METRICS = [
    '{ true } | rate() by (resource.service.name)',
    '{ kind = server } | avg_over_time(duration) by (name)',
    '{ status = error } | max_over_time(duration)',
]


@pytest.fixture(autouse=True)
def _reset_port_breakers():
    """The port's breaker registry is its own process-wide singleton."""
    breaker.reset_for_tests()
    yield
    breaker.reset_for_tests()


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    gen = slice_dbs(tmp_path_factory.mktemp("frontend"))
    port, ref, ids = next(gen)
    yield port, ref, ids
    next(gen, None)


@pytest.fixture
def fronts(dbs):
    """(port Frontend, reference Frontend), one local worker each, no
    hedging."""
    port, ref, _ = dbs
    pf = FE.Frontend(Querier(port, None, None), n_workers=1, hedge_after_s=0.0)
    rf = r_fe.Frontend(RQuerier(ref, None, None), n_workers=1, hedge_after_s=0.0)
    yield pf, rf
    pf.stop()
    rf.stop()
    pf.querier.close()


def _traces(resp) -> list:
    return [dataclasses.asdict(t) for t in resp.traces]


def _same_series(got, want) -> None:
    assert (got.fn, got.start_ms, got.step_ms, got.n_buckets, tuple(got.label_names)) == \
        (want.fn, want.start_ms, want.step_ms, want.n_buckets, tuple(want.label_names))
    assert set(got.series) == set(want.series)
    assert got.inspected_spans == want.inspected_spans
    for k, st in want.series.items():
        for f, arr in st.items():
            if f == "vsum":
                np.testing.assert_allclose(got.series[k][f], arr, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(got.series[k][f], arr)


def _span(dbs) -> tuple[int, int]:
    port = dbs[0]
    metas = port.metas(TENANT)
    return (min(m.start_time_unix_nano for m in metas) // 10**9,
            -(-max(m.end_time_unix_nano for m in metas) // 10**9))


# ------------------------------------------------------------- the queue


def _queue_run(mod, ops: list) -> list:
    """Replay one op list on a package's RequestQueue; returns what each
    op gave (job ids, placements, 429s)."""
    q = mod.RequestQueue(max_per_tenant=6)
    out = []

    def claim(tenant, job, now):
        key = job.affinity_key
        if key is None:
            return "unowned"
        return {"b0": "own", "b1": "own", "b2": "steal"}.get(key)  # b3: deferred

    def ident(item):
        return None if item is None else (item[0], item[1].payload["id"], item[1].placement)

    for op in ops:
        if op[0] == "enq":
            _, tenant, i, key, bkey = op
            job = mod._Job(kind="search_blocks", payload={"id": i}, fn=None, args=(),
                           affinity_key=key, batch_key=bkey)
            try:
                q.enqueue(tenant, job)
                out.append(("enq", i))
            except mod.TooManyRequests:
                out.append(("429", i))
        elif op[0] == "deq":
            _, mode = op
            kw = {"claim": claim} if mode == "claim" else {}
            if mode == "allowed":
                kw["allowed"] = lambda t: t != "t1"
            out.append(("deq", ident(q.dequeue(timeout=0.01, **kw))))
        else:
            _, mode, n = op
            item = q.dequeue_batch(timeout=0.01, max_batch=n, key_fn=lambda j: j.batch_key,
                                   claim=claim if mode == "claim" else None)
            if item is None:
                out.append(("batch", None))
            else:
                t, j, extras = item
                out.append(("batch", (t, j.payload["id"], j.placement),
                            [(t2, j2.payload["id"], j2.placement) for t2, j2 in extras]))
    out.append(("depths", q.depths()))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_request_queue_order_matches_reference(seed):
    """Random enqueues over three tenants (with and without affinity and
    batch keys, past the per-tenant cap), fair dequeues (plain, claimed,
    tenant-filtered) and batch dequeues: the same ids in the same order,
    with the same placements and 429s."""
    r = random.Random(seed)
    ops, n = [], 0
    for step in range(150):
        x = r.random()
        if step < 30 or x < 0.45:  # fill past the cap first
            key = r.choice([None, "b0", "b1", "b2", "b3"])
            bkey = r.choice([None, ("k", 1), ("k", 2)])
            ops.append(("enq", r.choice(["t0", "t1", "t2"]), n, key, bkey))
            n += 1
        elif x < 0.8:
            ops.append(("deq", r.choice(["plain", "claim", "allowed"])))
        else:
            ops.append(("batch", r.choice(["plain", "claim"]), r.choice([1, 2, 4])))
    got, want = _queue_run(FE, ops), _queue_run(r_fe, ops)
    assert got == want
    assert any(o[0] == "429" for o in got) and any(o[0] == "batch" and o[1] and o[2] for o in got)


# --------------------------------------------------- find, search, metrics


def test_sharded_find_matches_reference(dbs, fronts, monkeypatch):
    """Every sample id (present in one of the four blocks) and four
    absent ones, the candidate blocks split into shard jobs of 2."""
    _, _, ids = dbs
    pf, rf = fronts
    monkeypatch.setattr(FE, "FIND_SHARD_BLOCKS", 2)
    monkeypatch.setattr(r_fe, "FIND_SHARD_BLOCKS", 2)
    absent = [bytes([0xEE] * 15 + [i]) for i in range(4)]
    for tid in ids + absent:
        got = pf.find_trace_by_id(TENANT, tid)
        want = rf.find_trace_by_id(TENANT, tid)
        assert (got is None) == (want is None), tid.hex()
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), tid.hex()
    assert pf.stats["queries"]["traces"]["ok"] == len(ids) + len(absent)


@pytest.mark.parametrize("query,limit", SEARCHES)
def test_sharded_search_matches_reference(fronts, query, limit):
    pf, rf = fronts
    got = pf.search(TENANT, SM.SearchRequest(query=query, limit=limit))
    want = rf.search(TENANT, r_search.SearchRequest(query=query, limit=limit))
    assert _traces(got) == _traces(want)
    assert got.inspected_spans == want.inspected_spans


@pytest.mark.parametrize("query", METRICS)
def test_time_sharded_metrics_match_reference(dbs, fronts, query):
    """At least two time-shard jobs a query (n_jobs is forced to 2),
    merged by label."""
    pf, rf = fronts
    lo, hi = _span(dbs)
    got = pf.metrics_query_range(TENANT, ME.align_params(query, lo, hi, 60))
    want = rf.metrics_query_range(TENANT, RME.align_params(query, lo, hi, 60))
    assert got.series
    _same_series(got, want)
    assert pf.querier.stats.metrics_queries >= 2


# ------------------------------------------------- QoS, retries, hedges


def test_qos_sheds_429_like_the_reference(dbs):
    """max_concurrent_queries=1: a second query of a tenant with one in
    flight sheds with TooManyRequests in both packages; another tenant
    is admitted."""
    port, ref, _ = dbs
    out = []
    for mod, db, q_cls, ov, lim in ((FE, port, Querier, Overrides(), Limits),
                                    (r_fe, ref, RQuerier, ROverrides(), RLimits)):
        ov.defaults = lim(max_concurrent_queries=1)
        fe = mod.Frontend(q_cls(db, None, None), n_workers=0, overrides=ov)
        try:
            assert fe._qos_admit(TENANT, 10) == 10
            with pytest.raises(mod.TooManyRequests):
                fe._qos_admit(TENANT, 10)
            assert fe._qos_admit("other", 5) == 5
            fe._qos_release(TENANT, 10)
            out.append(fe.qos.inflight(TENANT) + fe.qos.inflight("other"))
        finally:
            fe.stop()
    assert out[0] == out[1] == (0, 0, 1, 5)


def _stub_front(mod, db, q_cls, **kw):
    return mod.Frontend(q_cls(db, None, None), n_workers=kw.pop("n_workers", 2),
                        hedge_after_s=kw.pop("hedge_after_s", 0.0), **kw)


def test_retry_budget_runs_out_like_the_reference(dbs, monkeypatch):
    """Four always-failing backend jobs under a budget of 2 retries:
    4 first tries + 2 retries in both packages, every job failed."""
    port, ref, _ = dbs
    monkeypatch.setenv("TEMPO_RETRY_BUDGET", "2")
    calls = []
    for mod, db, q_cls, err in ((FE, port, Querier, BackendError),
                                (r_fe, ref, RQuerier, RBackendError)):
        fe = _stub_front(mod, db, q_cls)
        n = {"calls": 0}

        def boom(n=n, err=err):
            n["calls"] += 1
            raise err("down")

        jobs = [mod._Job(kind="search_blocks", payload={}, fn=boom, args=()) for _ in range(4)]
        try:
            fe._run_jobs(TENANT, jobs, timeout=10.0)
        finally:
            fe.stop()
        assert all(j.error is not None for j in jobs)
        calls.append(n["calls"])
        if mod is FE:
            assert fe.stats["retries"]["retry"] == 2
            assert fe.stats["retries"]["budget_exhausted"] >= 1
            assert fe.stats["jobs_failed"]["search_blocks"] == 4
    assert calls == [6, 6]


def test_hedge_fires_like_the_reference(dbs):
    """A job stuck past hedge_after_s gets a twin that wins."""
    port, ref, _ = dbs
    outcomes = []
    for mod, db, q_cls in ((FE, port, Querier), (r_fe, ref, RQuerier)):
        fe = _stub_front(mod, db, q_cls, hedge_after_s=0.05)
        state = {"calls": 0}

        def slow_then_fast(state=state):
            state["calls"] += 1
            if state["calls"] == 1:
                time.sleep(0.9)  # the stuck original
            return "r"

        job = mod._Job(kind="search_blocks", payload={}, fn=slow_then_fast, args=())
        try:
            fe._run_jobs(TENANT, [job], timeout=10.0)
        finally:
            fe.stop()
        assert job.result == "r" and job.error is None and job.hedged
        outcomes.append(job.hedge_outcome)
        if mod is FE:
            assert fe.stats["hedges"] == {"win": 1}
    assert outcomes == ["win", "win"]


def test_job_error_is_counted_and_search_degrades(dbs, fronts):
    """A search whose backend job raises a deterministic error still
    answers (the failed shard lowers coverage) in both packages; the
    port counts the failed job by kind, so a KernelError cannot hide
    behind a short answer."""
    pf, rf = fronts
    req_p = SM.SearchRequest(query='{ resource.service.name = "db" }', limit=20)
    req_r = r_search.SearchRequest(query=req_p.query, limit=20)

    def broken(*a, **k):
        raise ValueError("engine fault")

    pf.querier.search_blocks_multi = pf.querier.search_blocks = broken
    rf.querier.search_blocks_multi = rf.querier.search_blocks = broken
    got, want = pf.search(TENANT, req_p), rf.search(TENANT, req_r)
    assert _traces(got) == _traces(want) == []
    assert pf.stats["jobs_failed"] == {"search_blocks": 1}
    assert pf.stats["queries"]["search"]["ok"] == 1


# ----------------------------------------------------------- result cache


def test_result_cache_exact_hit_matches_reference(dbs, fronts):
    """A repeat of a past-range search and metrics query is an exact
    hit in both packages, with the first answer."""
    pf, rf = fronts
    lo, hi = _span(dbs)
    q = '{ duration > 100ms }'
    first_p = pf.search(TENANT, SM.SearchRequest(query=q, start=lo, end=hi, limit=50))
    first_r = rf.search(TENANT, r_search.SearchRequest(query=q, start=lo, end=hi, limit=50))
    again_p = pf.search(TENANT, SM.SearchRequest(query=q, start=lo, end=hi, limit=50))
    again_r = rf.search(TENANT, r_search.SearchRequest(query=q, start=lo, end=hi, limit=50))
    assert _traces(again_p) == _traces(first_p) == _traces(again_r) == _traces(first_r)
    mq = METRICS[0]
    mp = [pf.metrics_query_range(TENANT, ME.align_params(mq, lo, hi, 60)) for _ in range(2)]
    mr = [rf.metrics_query_range(TENANT, RME.align_params(mq, lo, hi, 60)) for _ in range(2)]
    _same_series(mp[1], mr[1])
    _same_series(mp[1], mp[0])
    ps, rs = pf.result_cache.stats(), rf.result_cache.stats()
    for k in ("hits", "misses", "extensions", "invalidations", "entries"):
        assert ps[k] == rs[k], k
    assert ps["hits"] == 2 and ps["misses"] == 2


class _Clock:
    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now


def test_result_cache_extension_matches_reference(dbs, fronts, monkeypatch):
    """With the clock just past the corpus, a now-edge search stores its
    immutable prefix; a later search starting inside the prefix runs
    only the tail and merges -- equal in both packages, and equal to an
    uncached search."""
    pf, rf = fronts
    lo, hi = _span(dbs)
    clock = _Clock(hi + 10)
    monkeypatch.setattr(RC, "time", clock)
    monkeypatch.setattr(r_rc, "time", clock)
    q, mid = '{ resource.service.name = "db" }', lo + (hi - lo) // 3
    for start in (lo, mid):
        got = pf.search(TENANT, SM.SearchRequest(query=q, start=start, end=hi + 10, limit=500))
        want = rf.search(TENANT, r_search.SearchRequest(query=q, start=start, end=hi + 10,
                                                        limit=500))
        assert _traces(got) == _traces(want)
    assert pf.result_cache.stats()["extensions"] == rf.result_cache.stats()["extensions"] == 1
    fresh = pf.querier.db.search(TENANT, SM.SearchRequest(query=q, start=mid, end=hi + 10,
                                                          limit=500))
    assert {t["trace_id"] for t in _traces(got)} == {t.trace_id for t in fresh.traces}


# --------------------------------------------------------- the job plane


def _drain(fe, mod_worker, querier, done: threading.Event, kinds: list) -> None:
    """A remote worker in this thread: poll -> execute -> complete until
    the caller's query is done."""
    while not done.is_set():
        job = fe.poll_job(wait_s=0.05, worker_id="")
        if job is None:
            continue
        kinds.append(job["kind"])
        try:
            out = mod_worker.execute_job(querier, job["tenant"], job["kind"], job["payload"])
            fe.complete_job(job["id"], True, result=out)
        except Exception as e:  # noqa: BLE001 - reported as the worker does
            fe.complete_job(job["id"], False, error=str(e), retryable=False)


def test_wire_job_plane_matches_reference(dbs):
    """A dispatcher-only frontend drained by a remote-style worker loop:
    find, search and metrics answers equal the reference's through its
    own wire plane."""
    port, ref, ids = dbs
    lo, hi = _span(dbs)
    answers = []
    for mod, wmod, db, q_cls, req_cls, me in (
            (FE, W, port, Querier, SM.SearchRequest, ME),
            (r_fe, r_worker, ref, RQuerier, r_search.SearchRequest, RME)):
        querier = q_cls(db, None, None)
        fe = mod.Frontend(querier, n_workers=0)
        done, kinds = threading.Event(), []
        t = threading.Thread(target=_drain, args=(fe, wmod, querier, done, kinds), daemon=True)
        t.start()
        try:
            found = fe.find_trace_by_id(TENANT, ids[3])
            srch = fe.search(TENANT, req_cls(query=SEARCHES[0][0], limit=20))
            mres = fe.metrics_query_range(TENANT, me.align_params(METRICS[1], lo, hi, 60))
        finally:
            done.set()
            t.join(timeout=5)
            fe.stop()
        assert not t.is_alive()
        assert {"find_recent", "find_blocks", "search_recent", "search_blocks",
                "metrics_query_range"} <= set(kinds)
        answers.append((dataclasses.asdict(found), _traces(srch), mres))
    assert answers[0][:2] == answers[1][:2]
    _same_series(answers[0][2], answers[1][2])


@pytest.mark.parametrize("kind", ["search_blocks", "find_blocks"])
def test_wire_multi_job_matches_reference(dbs, kind):
    """Three same-key jobs queued together leave as ONE `multi` wire
    job; the worker runs them as one coalesced call and complete_job
    demuxes the results -- each equal to the reference's."""
    port, ref, ids = dbs
    results = []
    for mod, wmod, db, q_cls, req_mod in ((FE, W, port, Querier, SM),
                                          (r_fe, r_worker, ref, RQuerier, r_search)):
        querier = q_cls(db, None, None)
        fe = mod.Frontend(querier, n_workers=0)
        block_ids = sorted(m.block_id for m in db.blocklist.metas(TENANT))
        jobs = []
        for i in range(3):
            if kind == "search_blocks":
                payload = {"req": req_mod.request_to_dict(req_mod.SearchRequest(
                    query=SEARCHES[i][0], limit=SEARCHES[i][1])), "block_ids": block_ids}
            else:
                payload = {"trace_id": ids[5 * i].hex(), "block_ids": block_ids}
            j = mod._Job(kind=kind, payload=payload, fn=None, args=(),
                         batch_key=(kind, TENANT, tuple(block_ids)))
            jobs.append(j)
            fe.queue.enqueue(TENANT, j)
        try:
            wire = fe.poll_job(wait_s=1.0)
            assert wire["kind"] == "multi" and len(wire["payload"]["jobs"]) == 3
            out = wmod.execute_job(querier, wire["tenant"], "multi", wire["payload"])
            fe.complete_job(wire["id"], True, result=out)
        finally:
            fe.stop()
        assert all(j.done.is_set() and j.error is None for j in jobs)
        if kind == "search_blocks":
            results.append([(_traces(j.result), j.result.inspected_spans) for j in jobs])
        else:
            results.append([dataclasses.asdict(j.result) for j in jobs])
    assert results[0] == results[1]
