"""The port's ingester and live-head engine against the JAX package's
Ingester driven by the same seeded operations: randomized push /
late-segment / cut / flush / rotate interleavings where the port's
device route (plain versions on the CPU) and its index oracle equal
each other and the reference's answers, and the numpy twin's slot mask
equals the device route's; flush-failure
restore; finds; delta uploads; the stager's compaction; concurrent push
and search; live metrics; WAL replay; and the entry points that need a
card unless the CPU is named."""

import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tempo_tpu.backend import MemBackend as RMem
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.db.metrics_exec import align_params as r_align
from tempo_tpu.db.search import SearchRequest as RSearchRequest
from tempo_tpu.db.wal import WAL as RWAL
from tempo_tpu.services.ingester import Ingester as RIngester
from tempo_tpu.services.overrides import Overrides as ROverrides
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db.metrics_exec import align_params
from tempo_tpu_torch.db.wal import WAL
from tempo_tpu_torch.ingest.columnar import kv_pair_key
from tempo_tpu_torch.ops.livestage import eval_live_device, eval_live_host
from tempo_tpu_torch.services.ingester import Ingester, IngesterConfig, PushError
from tempo_tpu_torch.services.overrides import Limits, Overrides
from tempo_tpu_torch.util.testdata import make_trace, make_trace_id, make_traces
from tempo_tpu_torch.wire.segment import segment_for_write

TENANT = "live-t"


class Pair:
    """The port's Ingester on the CPU and the reference's, fed the same
    segment bytes."""

    def __init__(self, tmp_path, **cfg):
        self.db = TempoDB(TempoDBConfig(), backend=MemBackend(), device="cpu")
        self.ing = Ingester(WAL(str(tmp_path / "w")), self.db, Overrides(),
                            IngesterConfig(**cfg), device="cpu")
        self.rdb = RTempoDB(RConfig(wal_path=str(tmp_path / "rdw")), backend=RMem())
        from tempo_tpu.services.ingester import IngesterConfig as RIngesterConfig

        self.ring = RIngester(RWAL(str(tmp_path / "rw")), self.rdb, ROverrides(),
                              RIngesterConfig(**cfg))
        self.inst = self.ing.instance(TENANT)
        self.rinst = self.ring.instance(TENANT)

    def push(self, tid, tr):
        lo, hi = tr.time_range_nanos()
        s, e = lo // 10**9, hi // 10**9 + 1
        batch = [(tid, s, e, segment_for_write(tr, s, e))]
        self.inst.push_segments(batch)
        self.rinst.push_segments(batch)

    def both(self, name, *a, **k):
        return getattr(self.inst, name)(*a, **k), getattr(self.rinst, name)(*a, **k)


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.rdb.close()


def _dump(resp):
    """Every wire-relevant field per result, ordering included."""
    return [(t.trace_id, t.start_time_unix_nano, t.root_service_name,
             t.root_trace_name, t.duration_ms) for t in resp.traces]


QUERIES = [
    dict(limit=200),
    dict(limit=3),
    dict(tags={"service.name": "db"}, limit=200),
    dict(tags={"name": "GET /api"}, limit=200),
    dict(tags={"service.name": "db", "name": "db.query"}, limit=200),
    dict(tags={"component": "sql"}, limit=200),
    dict(tags={"http.method": "get"}, limit=200),  # value lowering
    dict(tags={"no.such.key": "x"}, limit=200),
    dict(min_duration_ms=500, limit=200),
    dict(max_duration_ms=500, limit=200),
    dict(min_duration_ms=100, max_duration_ms=1500, limit=5),
    dict(start=1_700_000_000 - 50, end=1_700_000_000 + 50, limit=200),
    dict(start=1_900_000_000, limit=200),  # nothing that new
    dict(query='{ resource.service.name = "db" }', limit=200),
    dict(query='{ span.http.status_code = 500 }', limit=200),
    dict(tags={"service.name": "auth"}, min_duration_ms=200, limit=4),
]


def _twin_mask(inst, req):
    """The staged head's slot mask for req by the device route (B7a's
    plain version here) and by its numpy twin, over one snapshot; None
    when the head is empty or a tag string was never seen."""
    eng = inst.live_engine
    _, snap = eng._refresh()
    if snap is None:
        return None
    codes = ([], [])
    for k, v in (req.tags or {}).items():
        key = v if k == "name" else kv_pair_key(k, str(v).lower())
        c = eng.stager.dict.lookup(key)
        if c < 0:
            return None
        codes[k == "name"].append(c)
    args = (snap, codes[0], codes[1], req.start, req.end, req.min_duration_ms)
    return eval_live_device(*args)[: snap.n_slots].numpy(), eval_live_host(*args)


def _assert_engines_identical(p, queries=QUERIES):
    for i, kw in enumerate(queries):
        want = _dump(p.rinst.search_live_index(RSearchRequest(**kw)))
        req = SearchRequest(**kw)
        oracle = p.inst.search_live_index(req)
        dev = p.inst.search_live(req)
        assert _dump(oracle) == want, f"port oracle != reference on query {i}"
        assert _dump(dev) == want, f"device route != reference on query {i}"
        masks = _twin_mask(p.inst, req)
        if masks is not None:
            assert np.array_equal(*masks), f"host twin's mask != device's on query {i}"


@pytest.mark.parametrize("seed", [421, 422])
def test_differential_randomized_interleavings(pair, seed):
    """Device route == index oracle == the reference (and the host twin's
    mask == the device route's) across randomized push / late-segment /
    cut / flush / rotate interleavings."""
    rng = random.Random(seed)
    known = []
    for step in range(48):
        op = rng.random()
        if op < 0.55 or not known:
            # a fresh trace; base times cover distinct and tied seconds
            tid = make_trace_id(rng)
            base = 1_700_000_000_000_000_000 + rng.randrange(0, 4) * 10**9 * 60
            pair.push(tid, make_trace(rng, trace_id=tid, n_spans=rng.randrange(1, 6),
                                      base_time_ns=base))
            known.append(tid)
        elif op < 0.72:
            # a late segment for an existing trace (possibly already cut)
            tid = rng.choice(known)
            pair.push(tid, make_trace(rng, trace_id=tid, n_spans=rng.randrange(1, 4)))
        elif op < 0.85:
            a, b = pair.both("cut_complete_traces", force=rng.random() < 0.5)
            assert a == b
        else:
            pair.both("cut_block_if_ready", force=True)
            known = [t for t in known if t in pair.inst.live or t in pair.inst.cut
                     or t in pair.inst.flushing]
        if step % 8 == 7:
            _assert_engines_identical(pair)
    pair.both("cut_complete_traces", force=True)
    pair.both("cut_block_if_ready", force=True)
    _assert_engines_identical(pair)
    assert pair.inst.search_live(SearchRequest(limit=200)).traces == []
    assert pair.inst.blocks_flushed == pair.rinst.blocks_flushed > 0


def test_differential_flush_failure_restore(pair, monkeypatch):
    """A failed block flush restores the cut set; the staged head keeps
    answering as the reference does through the failure and the retry."""
    for tid, tr in make_traces(12, seed=3, n_spans=4):
        pair.push(tid, tr)
    pair.both("cut_complete_traces", force=True)

    def down(*a, **k):
        raise OSError("backend down")

    for db in (pair.db, pair.rdb):
        monkeypatch.setattr(db, "write_block", down)
    for inst in (pair.inst, pair.rinst):
        with pytest.raises(OSError):
            inst.cut_block_if_ready(force=True)
    assert pair.inst.flush_failures == 1 and len(pair.inst.cut) == 12
    _assert_engines_identical(pair)
    monkeypatch.undo()
    pair.both("cut_block_if_ready", force=True)
    _assert_engines_identical(pair)
    assert len(pair.db.metas(TENANT)) == 1


def test_find_differential(pair, monkeypatch):
    """The map route, the staged route (B7b's plain version) and the
    reference return the same trace; absent ids return nothing."""
    traces = make_traces(10, seed=11, n_spans=3)
    for tid, tr in traces:
        pair.push(tid, tr)
    late = make_trace(5, trace_id=traces[0][0], n_spans=2)
    pair.push(traces[0][0], late)
    pair.both("cut_complete_traces", force=True)
    pair.push(traces[1][0], make_trace(6, trace_id=traces[1][0], n_spans=2))  # cut + live
    for tid, _ in traces + [(b"\x01" * 16, None)]:
        monkeypatch.setenv("TEMPO_LIVE_FIND_DEVICE", "1")
        dev = pair.inst.find_trace_by_id(tid)
        monkeypatch.delenv("TEMPO_LIVE_FIND_DEVICE")
        host = pair.inst.find_trace_by_id(tid)
        want = pair.rinst.find_trace_by_id(tid)
        if want is None:
            assert dev is None and host is None
            continue
        assert dev is not None and host is not None
        from dataclasses import asdict

        assert asdict(dev) == asdict(host) == asdict(want)
    assert pair.inst.find_trace_by_id(traces[0][0]).span_count() == 5


def test_delta_upload_moves_only_new_rows(pair):
    """The refresh after a small push moves a small delta (B7c appends,
    B7d patches) instead of re-uploading the head; an unchanged head
    re-serves the same generation."""
    st = pair.inst.live_engine.stager
    for tid, tr in make_traces(80, seed=5, n_spans=6):
        pair.push(tid, tr)
    pair.inst.search_live(SearchRequest(limit=10))
    assert st.stats["full_uploads"] == 1 and st.last_upload["full"]
    full_bytes = st.last_upload["bytes"]
    for tid, tr in make_traces(2, seed=99, n_spans=2):
        pair.push(tid, tr)
    pair.inst.search_live(SearchRequest(limit=10))
    assert st.stats["full_uploads"] == 1 and st.stats["delta_uploads"] == 1
    assert 0 < st.last_upload["bytes"] < full_bytes / 4
    gen = st.generation
    pair.inst.search_live(SearchRequest(limit=10))
    assert st.generation == gen and st.stats["delta_uploads"] == 1
    _assert_engines_identical(pair)


def test_compaction_rebuild_after_churn(pair):
    """Repeated push -> flush churn retires most slots; the stager
    compacts its tails and keeps answering as the reference does."""
    for round_i in range(4):
        for tid, tr in make_traces(15, seed=100 + round_i, n_spans=3):
            pair.push(tid, tr)
        pair.inst.search_live(SearchRequest(limit=5))  # stage this round
        pair.both("cut_complete_traces", force=True)
        pair.both("cut_block_if_ready", force=True)
        pair.inst.search_live(SearchRequest(limit=5))  # observe retirement
    st = pair.inst.live_engine.stager
    assert st.dead_slots <= st.n_slots < 60  # dead rounds were reclaimed
    for tid, tr in make_traces(10, seed=777, n_spans=3):
        pair.push(tid, tr)
    _assert_engines_identical(pair)


def test_concurrent_push_and_search_no_slot_thrash(pair):
    """Concurrent pushes and searches never retire and restage a live
    trace: dead slots only come from real cuts and flushes."""
    inst = pair.inst
    stop = threading.Event()
    errors: list = []

    def pusher(seed):
        rng = random.Random(seed)
        try:
            while not stop.is_set():
                tid = make_trace_id(rng)
                tr = make_trace(rng, trace_id=tid, n_spans=2)
                lo, hi = tr.time_range_nanos()
                inst.push_segments([(tid, lo // 10**9, hi // 10**9 + 1,
                                     segment_for_write(tr, lo // 10**9, hi // 10**9 + 1))])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def searcher():
        try:
            while not stop.is_set():
                inst.search_live(SearchRequest(limit=10))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = ([threading.Thread(target=pusher, args=(i,)) for i in range(2)]
               + [threading.Thread(target=searcher) for _ in range(3)])
    for t in threads:
        t.start()
    time.sleep(0.8)
    stop.set()
    for t in threads:
        t.join(10)
    assert not errors, errors
    assert inst.live_engine.stager.dead_slots == 0
    oracle = _dump(inst.search_live_index(SearchRequest(limit=50)))
    assert _dump(inst.search_live(SearchRequest(limit=50))) == oracle and oracle


METRICS = [
    '{ true } | rate() by (resource.service.name)',
    '{ span.http.status_code = 500 } | count_over_time() by (kind)',
    '{ true } | avg_over_time(duration) by (name)',
    '{ kind = server } | max_over_time(duration) by (resource.service.name)',
]


@pytest.mark.parametrize("query", METRICS)
def test_metrics_over_the_live_head_match_reference(pair, query):
    rng = random.Random(12)
    for _ in range(30):
        tid = make_trace_id(rng)
        pair.push(tid, make_trace(rng, trace_id=tid, n_spans=rng.randrange(1, 6),
                                  base_time_ns=1_700_000_000_000_000_000
                                  + rng.randrange(0, 600) * 10**9))
    pair.both("cut_complete_traces", force=True)
    tid = make_trace_id(rng)
    pair.push(tid, make_trace(rng, trace_id=tid, n_spans=3))
    got = pair.inst.metrics_query_range(align_params(query, 1_700_000_000, 1_700_000_700, 60))
    want = pair.rinst.metrics_query_range(r_align(query, 1_700_000_000, 1_700_000_700, 60))
    assert got.series and set(got.series) == set(want.series)
    assert got.inspected_spans == want.inspected_spans
    for k, st in want.series.items():
        for f, arr in st.items():
            np.testing.assert_array_equal(got.series[k][f], arr)


def test_replay_wal_into_fresh_ingester(tmp_path):
    """A crash after pushes (some cut, some late), then replay into a new
    port Ingester and a new reference Ingester over copies of the WAL:
    the same record count, one block each, equal finds."""
    p = Pair(tmp_path / "a")
    traces = make_traces(20, seed=41, n_spans=4)
    for tid, tr in traces:
        p.push(tid, tr)
    p.both("cut_complete_traces", force=True)
    p.push(traces[0][0], make_trace(9, trace_id=traces[0][0], n_spans=2))
    p.inst.live_engine.maybe_refresh()
    p.inst.flush_wal_features()
    src = p.ing.wal.dir
    dirs = []
    for name in ("port", "ref"):
        dst = tmp_path / f"replay-{name}"
        os.makedirs(dst)
        for f in os.listdir(src):
            (dst / f).write_bytes((Path(src) / f).read_bytes())
        dirs.append(str(dst))
    db = TempoDB(TempoDBConfig(), backend=MemBackend(), device="cpu")
    ing = Ingester(WAL(dirs[0]), db, Overrides(), IngesterConfig(), device="cpu")
    rdb = RTempoDB(RConfig(wal_path=str(tmp_path / "rdw-b")), backend=RMem())
    ring = RIngester(RWAL(dirs[1]), rdb, ROverrides())
    assert ing.replay_wal() == ring.replay_wal() == 21
    inst, rinst = ing.instances[TENANT], ring.instances[TENANT]
    assert inst.blocks_flushed == rinst.blocks_flushed == 1
    assert inst.columnar.seeded == rinst.columnar.seeded > 0
    for tid, _ in traces[:8]:
        got, want = db.find_trace_by_id(TENANT, tid), rdb.find_trace_by_id(TENANT, tid)
        assert got is not None and got.span_count() == want.span_count()
    assert db.find_trace_by_id(TENANT, traces[0][0]).span_count() == 6
    rdb.close()
    p.rdb.close()


def test_sweeper_cuts_flushes_and_stop_drains(tmp_path):
    """The sweeper thread cuts idle traces and flushes them; stop() joins
    it and drains the rest, leaving the live head empty and every trace
    findable in a block."""
    db = TempoDB(TempoDBConfig(), backend=MemBackend(), device="cpu")
    ing = Ingester(WAL(str(tmp_path / "w")), db, Overrides(),
                   IngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0,
                                  flush_check_period_s=0.02), device="cpu")
    traces = make_traces(12, seed=8, n_spans=3)
    for tid, tr in traces[:6]:
        ing.push_segments(TENANT, [(tid, 1, 2, segment_for_write(tr, 1, 2))])
    ing.start_sweeper()
    deadline = time.time() + 10
    while not db.metas(TENANT) and time.time() < deadline:
        time.sleep(0.02)
    for tid, tr in traces[6:]:
        ing.push_segments(TENANT, [(tid, 1, 2, segment_for_write(tr, 1, 2))])
    ing.stop()
    assert not ing._sweeper.is_alive()
    inst = ing.instances[TENANT]
    assert not inst.live and not inst.cut and not inst.flushing
    assert inst.blocks_flushed >= 2 and inst.flush_failures == 0
    for tid, tr in traces:
        assert db.find_trace_by_id(TENANT, tid).span_count() == tr.span_count()


def test_push_limits(pair):
    pair.ing.overrides.per_tenant[TENANT] = Limits(max_traces_per_user=3)
    traces = make_traces(4, seed=2, n_spans=2)
    for tid, tr in traces[:3]:
        pair.inst.push_segments([(tid, 1, 2, segment_for_write(tr, 1, 2))])
    with pytest.raises(PushError) as e:
        tid, tr = traces[3]
        pair.inst.push_segments([(tid, 1, 2, segment_for_write(tr, 1, 2))])
    assert e.value.status == 429 and len(pair.inst.live) == 3


ENTRY_POINTS = {
    "Ingester": lambda tmp: Ingester(WAL(str(tmp / "w")), None, Overrides()),
    "Instance": lambda tmp: __import__(
        "tempo_tpu_torch.services.ingester", fromlist=["Instance"]).Instance(
            TENANT, WAL(str(tmp / "w")), None, Overrides(), IngesterConfig()),
    "LiveStager": lambda tmp: __import__(
        "tempo_tpu_torch.ops.livestage", fromlist=["LiveStager"]).LiveStager(),
    "BlockBuilder": lambda tmp: __import__(
        "tempo_tpu_torch.block", fromlist=["BlockBuilder"]).BlockBuilder(TENANT),
    "build_block_from_traces": lambda tmp: __import__(
        "tempo_tpu_torch.block", fromlist=["build_block_from_traces"]).build_block_from_traces(
            MemBackend(), TENANT, make_traces(2, seed=1, n_spans=2)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_cpu_is_named(tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](tmp_path)


def test_compact_columnar_needs_a_card(tmp_path, monkeypatch):
    from tempo_tpu_torch.db import compactor as comp
    from tempo_tpu_torch.db.columnar_compact import compact_columnar

    db = TempoDB(TempoDBConfig(), backend=MemBackend(), device="cpu")
    for i in range(2):
        db.write_block(TENANT, make_traces(8, seed=60 + i, n_spans=3))
    cfg = db.cfg.compaction
    job = comp.select_jobs(TENANT, db.metas(TENANT), cfg)[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compact_columnar(db.backend, job, cfg)
    res = compact_columnar(db.backend, job, cfg, device="cpu")
    assert len(res.new_blocks) == 1 and res.traces_out == 16


def test_ingest_modules_import_no_jax_and_no_reference():
    code = ("import sys, tempo_tpu_torch.services.ingester, tempo_tpu_torch.services.overrides, "
            "tempo_tpu_torch.ops.livestage, tempo_tpu_torch.db.live_engine, "
            "tempo_tpu_torch.db.wal, tempo_tpu_torch.ingest, tempo_tpu_torch.wire.otlp_pb, "
            "tempo_tpu_torch.wire.segment; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tempo_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
