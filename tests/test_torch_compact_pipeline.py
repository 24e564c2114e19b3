"""The pipelined compaction sweep of the port (db/compact_pipeline.py,
TempoDB.compact_tenants, services/compactor.Compactor) on device="cpu",
mirroring tests/test_compact_pipeline.py:
  * pipelined outputs byte-equal to the port's sequential compact()
    (multi-output jobs with cross-block id collisions), and equal to the
    JAX package's compact_tenants on the same inputs, route by route
    (columns, dictionary, bloom words and meta: the two packages' zstd
    writers may emit other bytes);
  * a crash between outputs is invisible after a re-poll, and a re-run
    converges;
  * the columnar plan refusing, and the assemble refusing late, fall back
    to the wire merge as in the reference;
  * round-robin admission, a tiny budget that never deadlocks, the
    prefetch outcomes, the blocklist and stats updates of
    compact_tenants;
  * Compactor.run_once takes the pipeline when the concurrency is above 1,
    and ring ownership keeps a job the instance does not own.
"""

import shutil
import time

import pytest
from test_torch_write_cases import ROUTES, TENANT, _dbs, _part, assert_same_output

from tempo_tpu_torch.backend import LocalBackend, MemBackend
from tempo_tpu_torch.block.builder import BLOOM_PREFIX, build_block_from_traces
from tempo_tpu_torch.block.meta import BlockMeta
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.db import compact_pipeline as cp
from tempo_tpu_torch.db.blocklist import Poller
from tempo_tpu_torch.db.compact_pipeline import CompactionPipeline
from tempo_tpu_torch.db.compactor import CompactionJob, CompactorConfig, compact
from tempo_tpu_torch.ring.ring import InMemoryKV, Lifecycler, Ring
from tempo_tpu_torch.services.compactor import Compactor
from tempo_tpu_torch.util.testdata import make_traces


def _meta(size: int, level: int = 0):
    m = BlockMeta.new(TENANT)
    m.size_bytes = size
    m.compaction_level = level
    m.end_time_unix_nano = 1_700_000_000 * 10**9
    return m


def _build_inputs(backend, n_blocks: int = 4, n_traces: int = 30, collide: bool = True) -> list:
    """n_blocks small blocks; with collide=True consecutive blocks share
    some trace ids (the collision path)."""
    metas = []
    for b in range(n_blocks):
        traces = make_traces(n_traces, seed=100 + b, n_spans=4)
        if collide and b:
            prev = make_traces(n_traces, seed=100 + b - 1, n_spans=4)
            traces = sorted(traces[:-3] + prev[:3], key=lambda p: p[0])
        metas.append(build_block_from_traces(backend, TENANT, traces, device="cpu"))
    return metas


def _objects(backend, meta) -> dict[str, bytes]:
    names = ["data.vtpu", "dict.vtpu"] + [f"{BLOOM_PREFIX}{s}" for s in range(meta.bloom_shards)]
    return {n: backend.read(TENANT, meta.block_id, n) for n in names}


def _db(backend=None, **compaction) -> TempoDB:
    db = TempoDB(TempoDBConfig(), backend=backend or MemBackend(), device="cpu")
    for k, v in compaction.items():
        setattr(db.cfg.compaction, k, v)
    return db


# ---------------------------------------------------------- differential
def test_pipeline_bytes_equal_sequential_compact(tmp_path):
    """Multi-output jobs with id collisions: every output object (data,
    dictionary, bloom shards) byte-equal between compact() and the
    pipeline, and the job results alike."""
    a = LocalBackend(str(tmp_path / "a"))
    metas = _build_inputs(a)
    shutil.copytree(str(tmp_path / "a"), str(tmp_path / "b"))
    b = LocalBackend(str(tmp_path / "b"))
    cfg = CompactorConfig(concat_small_input_bytes=0, target_block_bytes=16000)
    seq = [compact(a, j, cfg, "cpu") for j in (CompactionJob(TENANT, metas[:2]),
                                                 CompactionJob(TENANT, metas[2:]))]
    assert any(len(r.new_blocks) > 1 for r in seq), "want a multi-output job"
    outs = CompactionPipeline(b, cfg, concurrency=4, device="cpu").run(
        {TENANT: [CompactionJob(TENANT, metas[:2]), CompactionJob(TENANT, metas[2:])]})
    assert [o.error for o in outs] == [None, None]
    for rs, oc in zip(seq, outs):
        rp = oc.result
        assert (rp.traces_out, rp.spans_out) == (rs.traces_out, rs.spans_out)
        assert rp.compacted_ids == rs.compacted_ids
        assert len(rp.new_blocks) == len(rs.new_blocks)
        for ms, mp in zip(rs.new_blocks, rp.new_blocks):
            assert _objects(a, ms) == _objects(b, mp)


@pytest.mark.parametrize("scenario", ROUTES)
def test_compact_tenants_matches_reference(scenario, tmp_path):
    """The JAX package's compact_tenants and the port's over copies of one
    store (its input blocks written by the reference), at concurrency 3:
    the same jobs in the same order, equal outputs, equal blocklists."""
    ref, port = _dbs(tmp_path, scenario)
    ref.cfg.compaction.concurrency = port.cfg.compaction.concurrency = 3
    rout, pout = ref.compact_tenants(), port.compact_tenants()
    assert [o.error for o in pout] == [None] * len(rout) and rout
    assert [o.error for o in rout] == [None] * len(rout)
    for r, p in zip(rout, pout):
        assert r.job.hash.split("-")[:2] == p.job.hash.split("-")[:2]
        rr, pr = r.result, p.result
        assert sorted(map(_part, pr.compacted_ids)) == sorted(map(_part, rr.compacted_ids))
        assert (pr.traces_out, pr.spans_out) == (rr.traces_out, rr.spans_out)
        assert len(pr.new_blocks) == len(rr.new_blocks)
        if scenario != "concat":
            for rm, pm in zip(rr.new_blocks, pr.new_blocks):
                assert_same_output(port.backend, pm, ref.backend, rm)

    def live(metas):
        return sorted((m.compaction_level, m.total_traces, m.total_spans) for m in metas)

    assert live(port.metas(TENANT)) == live(ref.blocklist.metas(TENANT))
    assert sorted(_part(m.block_id) for m in port.blocklist.compacted_metas(TENANT)) == \
        sorted(_part(m.block_id) for m in ref.blocklist.compacted_metas(TENANT))
    ref.close()


# -------------------------------------------------------- crash/ordering
def test_pipeline_crash_between_outputs_is_invisible(monkeypatch):
    """The second output write of a multi-output job fails: no input is
    marked compacted, no partial output surfaces to a poll, and a re-run
    without the fault converges."""
    import tempo_tpu_torch.db.columnar_compact as cc

    backend = MemBackend()
    metas = _build_inputs(backend, n_blocks=3, collide=False)
    cfg = CompactorConfig(concat_small_input_bytes=0, target_block_bytes=16000,
                          prefetch_depth=0)
    real_write = cc.write_block
    calls = {"n": 0}

    def boom(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("injected: disk died between outputs")
        return real_write(*args, **kw)

    monkeypatch.setattr(cc, "write_block", boom)
    outs = CompactionPipeline(backend, cfg, concurrency=2, device="cpu").run(
        {TENANT: [CompactionJob(TENANT, list(metas))]})
    assert len(outs) == 1 and isinstance(outs[0].error, OSError)
    assert calls["n"] >= 2, "the job must have tried several outputs"
    for m in metas:
        assert not backend.has_object(TENANT, m.block_id, "meta.compacted.json")
    polled, compacted = Poller(backend, build_index=False).poll()
    assert {m.block_id for m in polled[TENANT]} == {m.block_id for m in metas}
    assert not compacted.get(TENANT)
    assert set(backend.blocks(TENANT)) == {m.block_id for m in metas}, "data reclaimed"

    monkeypatch.setattr(cc, "write_block", real_write)
    outs2 = CompactionPipeline(backend, cfg, concurrency=2, device="cpu").run(
        {TENANT: [CompactionJob(TENANT, list(metas))]})
    assert outs2[0].error is None
    res = outs2[0].result
    assert len(res.new_blocks) >= 2
    polled2, _ = Poller(backend, build_index=False).poll()
    live = {m.block_id for m in polled2[TENANT] if not m.compacted_at_unix}
    assert {m.block_id for m in res.new_blocks} <= live
    for m in metas:
        assert backend.has_object(TENANT, m.block_id, "meta.compacted.json")


def test_pipeline_falls_back_when_assemble_refuses_late(monkeypatch):
    """UnsupportedColumnar after the plan (in the assemble): the job falls
    back to the wire merge, as the sequential driver does."""
    import tempo_tpu_torch.db.columnar_compact as cc

    backend = MemBackend()
    metas = _build_inputs(backend, n_blocks=2, collide=False)
    cfg = CompactorConfig(concat_small_input_bytes=0, prefetch_depth=0)

    def refuse(plan, cfg_):
        raise cc.UnsupportedColumnar("late refusal (fixture)")
        yield  # noqa: unreachable -- a generator like the real one

    monkeypatch.setattr(cc, "iter_outputs", refuse)
    stats = cp.CompactionStats()
    outs = CompactionPipeline(backend, cfg, concurrency=2, device="cpu", stats=stats).run(
        {TENANT: [CompactionJob(TENANT, list(metas))]})
    assert outs[0].error is None, outs[0].error
    assert outs[0].result.new_blocks and outs[0].result.traces_out == 60
    assert "wire" in stats.snapshot()["stage_seconds"]
    for m in metas:
        assert backend.has_object(TENANT, m.block_id, "meta.compacted.json")


def test_pipeline_falls_back_when_plan_refuses(monkeypatch):
    """A plan-stage refusal routes the fetched job straight to the wire
    merge, planned once (not again through compact())."""
    import tempo_tpu_torch.db.columnar_compact as cc

    backend = MemBackend()
    metas = _build_inputs(backend, n_blocks=2, collide=False)
    cfg = CompactorConfig(concat_small_input_bytes=0, prefetch_depth=0)
    plan_calls = {"n": 0}

    def refuse(*a, **kw):
        plan_calls["n"] += 1
        raise cc.UnsupportedColumnar("differing column sets (fixture)")

    monkeypatch.setattr(cc, "plan_columnar", refuse)
    outs = CompactionPipeline(backend, cfg, concurrency=2, device="cpu").run(
        {TENANT: [CompactionJob(TENANT, list(metas))]})
    assert outs[0].error is None, outs[0].error
    assert plan_calls["n"] == 1, "the fallback must not plan again through compact()"
    assert outs[0].result.new_blocks and outs[0].result.traces_out == 60
    for m in metas:
        assert backend.has_object(TENANT, m.block_id, "meta.compacted.json")


# ----------------------------------------------------------- scheduling
def test_round_robin_interleaves_tenants():
    pipe = CompactionPipeline(MemBackend(), CompactorConfig(), device="cpu")

    def j(t, i):
        return CompactionJob(t, [_meta(10)], hash=f"{t}-{i}")

    tickets = pipe._round_robin({"a": [j("a", 0), j("a", 1), j("a", 2)], "b": [j("b", 0)],
                                 "c": [j("c", 0), j("c", 1)]})
    assert [t.tenant for t in tickets] == ["a", "b", "c", "a", "c", "a"]
    assert [t.job.hash for t in tickets][:3] == ["a-0", "b-0", "c-0"]


def test_admission_gate_tiny_budget_never_deadlocks(tmp_path):
    """A budget below any job's estimate admits one job at a time and
    finishes every job."""
    backend = LocalBackend(str(tmp_path / "s"))
    metas = _build_inputs(backend, collide=False)
    cfg = CompactorConfig(concat_small_input_bytes=0, pipeline_mem_budget_bytes=1)
    stats = cp.CompactionStats()
    outs = CompactionPipeline(backend, cfg, concurrency=4, device="cpu", stats=stats).run(
        {TENANT: [CompactionJob(TENANT, metas[:2]), CompactionJob(TENANT, metas[2:])]})
    assert [o.error for o in outs] == [None, None]
    snap = stats.snapshot()
    assert snap["max_jobs_inflight"] == 1 and snap["jobs_inflight"] == 0


def test_prefetch_runs_ahead_and_counts(tmp_path):
    """With four workers' worth of prefetch depth and one worker, the
    prefetcher opens the later jobs' readers: every job is a hit or a
    miss, and hits happen."""
    backend = LocalBackend(str(tmp_path / "s"))
    metas = _build_inputs(backend, n_blocks=8, collide=False)
    cfg = CompactorConfig(concat_small_input_bytes=0, prefetch_depth=4)
    stats = cp.CompactionStats()
    jobs = [CompactionJob(TENANT, metas[i:i + 2]) for i in range(0, 8, 2)]
    outs = CompactionPipeline(backend, cfg, concurrency=1, device="cpu", stats=stats).run(
        {TENANT: jobs})
    assert [o.error for o in outs] == [None] * 4
    pf = stats.snapshot()["prefetch"]
    assert pf.get("hit", 0) + pf.get("miss", 0) == 4 and pf.get("hit", 0) >= 1


def test_compact_tenants_updates_blocklist_and_stats():
    """The TempoDB-level sweep over two tenants: each job's blocklist
    update lands (inputs out of the live list into the compacted one,
    outputs in), and the database's compaction stats advance."""
    db = _db(concurrency=3, concat_small_input_bytes=0, min_input_blocks=2)
    for t in ("ta", "tb"):
        for b in range(2):
            db.blocklist.update(t, add=[build_block_from_traces(
                db.backend, t, make_traces(20, seed=7 * b + (t == "tb"), n_spans=3),
                device="cpu")])
    outcomes = db.compact_tenants()
    assert [oc.error for oc in outcomes] == [None, None]
    assert {oc.tenant for oc in outcomes} == {"ta", "tb"}
    for t in ("ta", "tb"):
        assert all(m.compaction_level >= 1 for m in db.blocklist.metas(t))
        assert len(db.blocklist.compacted_metas(t)) == 2
    snap = db.compaction_stats.snapshot()
    assert (snap["jobs"], snap["runs"], snap["errors"]) == (2, 1, 0)
    assert {"fetch", "merge", "assemble", "write"} <= set(snap["stage_seconds"])
    assert snap["overlap_ratio"] > 0 and snap["input_bytes"] > 0
    assert db.compact_tenants() == []  # nothing left to select
    db.close()


# ------------------------------------------------------------- service
@pytest.mark.parametrize("via", ["config", "env"])
def test_service_sweep_uses_pipeline(via, monkeypatch):
    """Compactor.run_once takes compact_tenants when the concurrency
    (config or TEMPO_COMPACT_CONCURRENCY) is above 1, and keeps its stats
    and retention."""
    db = _db(concat_small_input_bytes=0, min_input_blocks=2, retention_s=10**9)
    if via == "env":
        monkeypatch.setenv("TEMPO_COMPACT_CONCURRENCY", "4")
    else:
        db.cfg.compaction.concurrency = 2
    called = {"n": 0}
    real = db.compact_tenants

    def spy(*a, **k):
        called["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(db, "compact_tenants", spy)
    db.blocklist.update(TENANT, add=[
        build_block_from_traces(db.backend, TENANT, make_traces(15, seed=s), device="cpu")
        for s in (1, 2)])
    svc = Compactor(db)
    svc.run_once()
    assert called["n"] == 1 and svc.stats.errors == []
    assert svc.stats.blocks_compacted == 2 and len(svc.stats.cycle_seconds) == 1
    assert all(m.compaction_level >= 1 for m in db.blocklist.metas(TENANT))
    db.close()


def test_service_sequential_at_concurrency_one(monkeypatch):
    """At concurrency 1 the service runs compact_once a tenant, never the
    pipeline."""
    monkeypatch.delenv("TEMPO_COMPACT_CONCURRENCY", raising=False)
    db = _db(concat_small_input_bytes=0, min_input_blocks=2, retention_s=10**9)
    monkeypatch.setattr(db, "compact_tenants", lambda *a, **k: pytest.fail("pipelined"))
    db.blocklist.update(TENANT, add=[
        build_block_from_traces(db.backend, TENANT, make_traces(15, seed=s), device="cpu")
        for s in (3, 4)])
    svc = Compactor(db)
    svc.run_once()
    assert svc.stats.errors == [] and svc.stats.blocks_compacted == 2
    assert cp.resolve_concurrency(db.cfg.compaction) == 1
    db.close()


@pytest.mark.parametrize("concurrency", [None, 3])
def test_compactor_ring_ownership(concurrency):
    """tests/test_services.py's ring test on the port, sequential and
    pipelined: the ring's member compacts its job; an instance outside
    the ring owns no job, so its blocks stay as they were."""
    now_ns = time.time_ns()
    kv = InMemoryKV()
    Lifecycler(kv, "comp", "c0").join()
    ring = Ring(kv, "comp")
    db = _db(concurrency=concurrency)
    for s in (1, 2):
        db.write_block(TENANT, make_traces(10, seed=s, n_spans=3, base_time_ns=now_ns))
    comp = Compactor(db, ring, "c0", cycle_s=9999)
    comp.run_once()
    assert comp.stats.blocks_compacted >= 2 and comp.stats.errors == []
    metas = db.blocklist.metas(TENANT)
    # small level-0 inputs take the concat route: parts of one compound
    assert len(metas) == 2 and all(m.compaction_level == 1 for m in metas)
    assert len({m.block_id.split("/")[0] for m in metas}) == 1
    db2 = _db(concurrency=concurrency)
    for s in (3, 4):
        db2.write_block(TENANT, make_traces(6, seed=s, n_spans=2, base_time_ns=now_ns))
    before = sorted(m.block_id for m in db2.blocklist.metas(TENANT))
    comp2 = Compactor(db2, ring, "not-in-ring", cycle_s=9999)
    comp2.run_once()
    assert comp2.stats.blocks_compacted == 0
    assert sorted(m.block_id for m in db2.blocklist.metas(TENANT)) == before
    db.close()
    db2.close()


def test_resolve_concurrency_and_budget(monkeypatch):
    cfg = CompactorConfig()
    monkeypatch.delenv("TEMPO_COMPACT_CONCURRENCY", raising=False)
    monkeypatch.delenv("TEMPO_COMPACT_MEM_BUDGET", raising=False)
    assert cp.resolve_concurrency(cfg) == 1
    assert cp.resolve_mem_budget(cfg) == cp.DEFAULT_MEM_BUDGET_BYTES
    monkeypatch.setenv("TEMPO_COMPACT_CONCURRENCY", "5")
    monkeypatch.setenv("TEMPO_COMPACT_MEM_BUDGET", "12345")
    assert (cp.resolve_concurrency(cfg), cp.resolve_mem_budget(cfg)) == (5, 12345)
    monkeypatch.setenv("TEMPO_COMPACT_CONCURRENCY", "x")
    assert cp.resolve_concurrency(cfg) == 1
    cfg.concurrency, cfg.pipeline_mem_budget_bytes = 0, 0
    assert (cp.resolve_concurrency(cfg), cp.resolve_mem_budget(cfg)) == (1, 1)


def test_deferred_meta_publishes_last():
    """write_block and copy_block_through with defer_meta write every data
    object but no meta.json; publish_block_meta makes the block visible."""
    from tempo_tpu_torch.block.builder import BlockBuilder, publish_block_meta, write_block
    from tempo_tpu_torch.block.versioned import open_block_versioned
    from tempo_tpu_torch.db.columnar_compact import copy_block_through

    backend = MemBackend()
    b = BlockBuilder(TENANT, device="cpu")
    for tid, t in make_traces(5, seed=9):
        b.add_trace(tid, t)
    m = write_block(backend, b.finalize(), defer_meta=True)
    assert backend.has_object(TENANT, m.block_id, "data.vtpu")
    assert not backend.has_object(TENANT, m.block_id, "meta.json")
    assert not Poller(backend, build_index=False).poll()[0].get(TENANT)
    publish_block_meta(backend, m)
    assert [x.block_id for x in Poller(backend).poll()[0][TENANT]] == [m.block_id]
    c = copy_block_through(backend, open_block_versioned(backend, m), 1, defer_meta=True)
    assert not backend.has_object(TENANT, c.block_id, "meta.json")
    publish_block_meta(backend, c)
    assert backend.has_object(TENANT, c.block_id, "meta.json")
