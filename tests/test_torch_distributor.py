"""The port's distributor, ring, rate limiter and streaming generator tap
on the CPU, against the JAX package's Distributor + Ingester (wired as
tests/test_services.py:78-86 wires them) on the same payloads: the same
segments byte for byte (push and push_raw, whose segments equal the
reference's native split_by_trace), the same PushError statuses, the
same ring placement; the tap's zero extra decodes (ColumnarIngest.stats()
equal to the reference's), its kernel-fault handling, and its greedy
per-tenant merge. Every comparison is exact: bytes, ids and integers,
and the generator's exposition line for line (both fold a window's
latency sums in f32; here a series sees at most a few spans a window,
whose f32 sums agree in any order at the 6 printed decimals)."""

import threading
import time

import pytest

from tempo_tpu.backend import MemBackend as RMem
from tempo_tpu.db.tempodb import TempoDB as RTempoDB
from tempo_tpu.db.tempodb import TempoDBConfig as RConfig
from tempo_tpu.db.wal import WAL as RWAL
from tempo_tpu.ingest.columnar import ColumnarIngest as RColumnarIngest
from tempo_tpu.ring import ring as rring
from tempo_tpu.services.distributor import Distributor as RDistributor
from tempo_tpu.services.distributor import PushError as RPushError
from tempo_tpu.services.generator import MetricsGenerator as RMetricsGenerator
from tempo_tpu.services.ingester import Ingester as RIngester
from tempo_tpu.services.ingester import IngesterConfig as RIngesterConfig
from tempo_tpu.services.overrides import Limits as RLimits
from tempo_tpu.services.overrides import Overrides as ROverrides
from tempo_tpu.util.hashing import ring_token as r_ring_token
from tempo_tpu.wire.otlp_pb import decode_trace as r_decode_trace
from tempo_tpu.wire.otlp_splice import split_by_trace
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db.wal import WAL
from tempo_tpu_torch.ingest.columnar import ColumnarIngest
from tempo_tpu_torch.kernels import KernelError
from tempo_tpu_torch.ring import ring as pring
from tempo_tpu_torch.services import generator as G
from tempo_tpu_torch.services.app import generator_window_tap
from tempo_tpu_torch.services.distributor import Distributor, PushError
from tempo_tpu_torch.services.generator import MetricsGenerator
from tempo_tpu_torch.services.ingester import Ingester, IngesterConfig
from tempo_tpu_torch.services.overrides import Limits, Overrides, RateLimiter
from tempo_tpu_torch.util.hashing import ring_token
from tempo_tpu_torch.util.testdata import make_traces
from tempo_tpu_torch.wire.model import Trace
from tempo_tpu_torch.wire.otlp_pb import encode_trace

TENANT = "dist-t"


class Recorder:
    """A fake ingester client: records every batch it is sent."""

    def __init__(self, fail: Exception | None = None):
        self.batches = []
        self.fail = fail

    def push_segments(self, tenant, batch):
        if self.fail is not None:
            raise self.fail
        self.batches.append((tenant, list(batch)))


def _ring(mod, n=1, ring_key="ing"):
    kv = mod.InMemoryKV()
    for i in range(n):
        mod.Lifecycler(kv, ring_key, f"ing-{i}").join()
    return mod.Ring(kv, ring_key, replication_factor=1)


def _pair(n_ingesters=1, limits=None, rlimits=None, fail=None):
    """The port's and the reference's distributors over fake clients."""
    recs = {f"ing-{i}": Recorder(fail) for i in range(n_ingesters)}
    rrecs = {f"ing-{i}": Recorder(fail and RPushError(fail.status, str(fail)))
             for i in range(n_ingesters)}
    dist = Distributor(_ring(pring, n_ingesters), recs.__getitem__,
                       Overrides(defaults=limits or Limits()))
    rdist = RDistributor(_ring(rring, n_ingesters), rrecs.__getitem__,
                         ROverrides(defaults=rlimits or RLimits()))
    return dist, recs, rdist, rrecs


def _request(traces):
    """One export request holding every trace's resource spans."""
    t = Trace()
    for _, tr in traces:
        t.resource_spans.extend(tr.resource_spans)
    return t


def _segments(recs):
    return {addr: [(tenant, [tuple(x) for x in b]) for tenant, b in r.batches]
            for addr, r in recs.items()}


@pytest.mark.parametrize("n_ingesters", [1, 3])
def test_push_segments_equal_reference(n_ingesters):
    """push (model batches) and push_raw (OTLP bytes) give the same
    per-instance segment batches as the reference, byte for byte."""
    dist, recs, rdist, rrecs = _pair(n_ingesters)
    windows = [make_traces(12, seed=s, n_spans=5) for s in range(3)]
    for w in windows[:2]:
        req = _request(w)
        assert dist.push(TENANT, req.resource_spans) == sum(t.span_count() for _, t in w)
        rdist.push(TENANT, r_decode_trace(encode_trace(req)).resource_spans)
    payload = encode_trace(_request(windows[2]))
    assert dist.push_raw(TENANT, payload) == rdist.push_raw(TENANT, payload)
    assert _segments(recs) == _segments(rrecs)
    assert sum(len(b) for r in recs.values() for _, b in r.batches) == 36
    assert dist.stats.spans_received == rdist.stats.spans_received
    assert dist.stats.bytes_received == rdist.stats.bytes_received
    assert dist.stats.traces_pushed == rdist.stats.traces_pushed == 36


def test_push_raw_segments_equal_native_split():
    """The port's push_raw takes the decode + model path; its segments
    equal the reference's native split_by_trace of the same payload, byte
    for byte (64 traces in one request)."""
    dist, recs, _, _ = _pair(1)
    traces = make_traces(64, seed=41, n_spans=6)
    payload = encode_trace(_request(traces))
    n = dist.push_raw(TENANT, payload)
    native, n_native = split_by_trace(payload)
    assert n == n_native == 64 * 6
    (tenant, batch), = recs["ing-0"].batches
    assert {tid: (s, e, seg) for tid, s, e, seg in batch} == native


def test_push_raw_undecodable_is_400():
    dist, _, rdist, _ = _pair(1)
    bad = b"\x0a\xff\xff\xff\xff\x0f"
    with pytest.raises(PushError) as e:
        dist.push_raw(TENANT, bad)
    with pytest.raises(RPushError) as r:
        rdist.push_raw(TENANT, bad)
    assert e.value.status == r.value.status == 400


def test_rate_limit_statuses_equal_reference():
    w1, w2 = make_traces(8, seed=1, n_spans=4), make_traces(8, seed=2, n_spans=4)
    probe, *_ = _pair(1)
    probe.push(TENANT, _request(w1).resource_spans)
    # room for the first window and half of another
    lim = dict(ingestion_rate_limit_bytes=1,
               ingestion_burst_size_bytes=probe.stats.bytes_received * 3 // 2)
    dist, recs, rdist, rrecs = _pair(1, Limits(**lim), RLimits(**lim))
    for d, conv in ((dist, lambda r: r), (rdist, lambda r: r_decode_trace(encode_trace(r)))):
        d.push(TENANT, conv(_request(w1)).resource_spans)
    statuses = []
    for d, conv in ((dist, lambda r: r), (rdist, lambda r: r_decode_trace(encode_trace(r)))):
        with pytest.raises(Exception) as e:
            d.push(TENANT, conv(_request(w2)).resource_spans)
        statuses.append(e.value.status)
    assert statuses == [429, 429]
    assert dist.stats.spans_refused_rate == rdist.stats.spans_refused_rate == 32
    # the pre-gate refuses on a lower bound without encoding: 16 B a span
    huge = make_traces(1, seed=3, n_spans=500)
    with pytest.raises(PushError) as e:
        dist.push(TENANT, _request(huge).resource_spans)
    assert e.value.status == 429


def test_rate_limiter_peek_consumes_nothing():
    rl = RateLimiter(Overrides(defaults=Limits(ingestion_rate_limit_bytes=10,
                                               ingestion_burst_size_bytes=100)))
    assert rl.peek("t", 100, 0.0) and rl.peek("t", 100, 0.0)
    assert rl.allow("t", 60, 0.0) and not rl.peek("t", 60, 0.0)
    assert not rl.allow("t", 60, 0.0)
    assert rl.allow("t", 60, 2.0)  # 40 + 2 s x 10 B/s
    assert RateLimiter(Overrides(defaults=Limits(ingestion_rate_limit_bytes=0))).allow("t", 1e12, 0)


def test_trace_size_limit_statuses_equal_reference(tmp_path):
    """max_bytes_per_trace: a segment over the limit is filtered by the
    distributor (counted, no error); a trace that grows past it across
    pushes is refused by the ingester with 400 -- on both packages."""
    traces = make_traces(6, seed=9, n_spans=4)
    big = make_traces(1, seed=10, n_spans=80)
    one = len(encode_trace(traces[0][1]))
    lim = dict(max_bytes_per_trace=3 * one)
    ing = Ingester(WAL(str(tmp_path / "w")), TempoDB(TempoDBConfig(), backend=MemBackend(),
                                                      device="cpu"),
                   Overrides(defaults=Limits(**lim)), device="cpu")
    ring_ing = RIngester(RWAL(str(tmp_path / "rw")),
                         RTempoDB(RConfig(wal_path=str(tmp_path / "rdw")), backend=RMem()),
                         ROverrides(defaults=RLimits(**lim)))
    dist = Distributor(_ring(pring), lambda a: ing, Overrides(defaults=Limits(**lim)))
    rdist = RDistributor(_ring(rring), lambda a: ring_ing, ROverrides(defaults=RLimits(**lim)))
    req = _request(traces + big)
    dist.push(TENANT, req.resource_spans)
    rdist.push(TENANT, r_decode_trace(encode_trace(req)).resource_spans)
    assert dist.stats.traces_refused_size == rdist.stats.traces_refused_size == 1
    assert dist.stats.traces_pushed == rdist.stats.traces_pushed == 6
    statuses = []
    for d, conv in ((dist, lambda r: r), (rdist, lambda r: r_decode_trace(encode_trace(r)))):
        for _ in range(4):
            try:
                d.push(TENANT, conv(_request(traces[:1])).resource_spans)
            except Exception as e:  # noqa: BLE001 -- the status is the point
                statuses.append(e.status)
                break
    assert statuses == [400, 400]
    assert dist.stats.push_failures == rdist.stats.push_failures == 1


def test_no_healthy_ingester_is_500():
    kv = pring.InMemoryKV()
    dist = Distributor(pring.Ring(kv, "ing"), {}.__getitem__, Overrides())
    rdist = RDistributor(rring.Ring(rring.InMemoryKV(), "ing"), {}.__getitem__, ROverrides())
    req = _request(make_traces(2, seed=4, n_spans=2))
    for d, conv in ((dist, lambda r: r), (rdist, lambda r: r_decode_trace(encode_trace(r)))):
        with pytest.raises(Exception) as e:
            d.push(TENANT, conv(req).resource_spans)
        assert e.value.status == 500


def test_ingester_failure_status_surfaces():
    dist, _, rdist, _ = _pair(1, fail=PushError(429, "backpressure"))
    req = _request(make_traces(3, seed=5, n_spans=2))
    with pytest.raises(PushError) as e:
        dist.push(TENANT, req.resource_spans)
    with pytest.raises(RPushError) as r:
        rdist.push(TENANT, r_decode_trace(encode_trace(req)).resource_spans)
    assert e.value.status == r.value.status == 429
    assert dist.stats.push_failures == rdist.stats.push_failures == 3


def test_replicated_ring_is_refused():
    ring = pring.Ring(pring.InMemoryKV(), "ing", replication_factor=2)
    with pytest.raises(ValueError, match="replication factor 2"):
        Distributor(ring, {}.__getitem__, Overrides())


@pytest.mark.parametrize("rf", [1, 2, 3])
def test_ring_equals_reference(rf):
    """Tokens, the clockwise replica walk (with the RF=2 quorum rule),
    shuffle shards and job ownership equal the reference's."""
    kv, rkv = pring.InMemoryKV(), rring.InMemoryKV()
    for i in range(5):
        pring.Lifecycler(kv, "ing", f"ing-{i}").join()
        rring.Lifecycler(rkv, "ing", f"ing-{i}").join()
    ring, rr = pring.Ring(kv, "ing", rf), rring.Ring(rkv, "ing", rf)
    for i in range(5):
        assert (pring.deterministic_tokens("ing", f"ing-{i}")
                == rring.deterministic_tokens("ing", f"ing-{i}"))
    tids = [tid for tid, _ in make_traces(64, seed=6, n_spans=1)]
    for tid in tids:
        tok = ring_token(TENANT, tid)
        assert tok == r_ring_token(TENANT, tid)
        a, b = ring.get(tok), rr.get(tok)
        assert [d.instance_id for d in a.instances] == [d.instance_id for d in b.instances]
        assert a.max_errors == b.max_errors
    for t in ("a", "b", "tenant-x"):
        assert ([d.instance_id for d in ring.shuffle_shard(t, 3)]
                == [d.instance_id for d in rr.shuffle_shard(t, 3)])
        assert ring.owner_of(t) == rr.owner_of(t) and ring.owns(ring.owner_of(t), t)


def test_lifecycler_heartbeats_and_leaves():
    kv = pring.InMemoryKV()
    lc = pring.Lifecycler(kv, "ing", "ing-0", heartbeat_period=0.02, prune_timeout=0.5)
    dead = pring.Lifecycler(kv, "ing", "ing-dead")
    dead.join()
    dead.desc.heartbeat_ts -= 10.0
    lc.start()
    try:
        ring = pring.Ring(kv, "ing", heartbeat_timeout=0.3)
        t0 = lc.desc.heartbeat_ts
        deadline = time.time() + 5.0
        while (lc.desc.heartbeat_ts == t0 or "ing-dead" in kv.get_all("ing")) \
                and time.time() < deadline:
            time.sleep(0.01)
        assert lc.desc.heartbeat_ts > t0 and "ing-dead" not in kv.get_all("ing")
        assert [d.instance_id for d in ring.healthy_instances()] == ["ing-0"]
    finally:
        lc.leave()
    assert not lc._thread.is_alive() and kv.get_all("ing") == {}


# ------------------------------------------------------------ the tap


def _stack(tmp_path, device="cpu", **gen_kw):
    """The port's single-binary write path: a ring of one ingester, the
    distributor, a generator behind the streaming tap."""
    db = TempoDB(TempoDBConfig(), backend=MemBackend(), device=device)
    ing = Ingester(WAL(str(tmp_path / "w")), db, Overrides(),
                   IngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0), device=device)
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device=device, **gen_kw)
    dist = Distributor(_ring(pring), lambda addr: ing, Overrides(),
                       generator_window=generator_window_tap(ing, gen))
    return dist, ing, gen


def _ref_stack(tmp_path):
    db = RTempoDB(RConfig(wal_path=str(tmp_path / "rdw")), backend=RMem())
    ing = RIngester(RWAL(str(tmp_path / "rw")), db, ROverrides(),
                    RIngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0))
    gen = RMetricsGenerator(ROverrides(), stale_series_s=3600.0)

    def window(tenant, segs, push_ts):  # App._generator_window
        col = ing.instance(tenant).columnar
        cols = [f.spans for f in map(col.features_for, segs) if f.spans is not None]
        if cols:
            gen.push_window(tenant, cols, col.dict, push_ts)

    dist = RDistributor(_ring(rring), lambda addr: ing, ROverrides(), generator_window=window)
    return dist, ing, gen


def test_tap_zero_extra_decodes_and_stats_equal_reference(tmp_path):
    """The streaming tap decodes each pushed segment once (the cache
    holds every decode), the live head's refresh then reads the cache,
    and ColumnarIngest.stats() equals the reference's after the same
    pushes; the window's spans all became series, as on the reference."""
    dist, ing, gen = _stack(tmp_path)
    rdist, ring_ing, rgen = _ref_stack(tmp_path)
    traces = make_traces(24, seed=13, n_spans=4)
    try:
        for i in range(0, 24, 8):
            payload = encode_trace(_request(traces[i:i + 8]))
            dist.push_raw(TENANT, payload)
            rdist.push_raw(TENANT, payload)
            assert dist.flush_generator_tap()
            rdist.flush_generator_tap()
        st = ing.instance(TENANT).columnar.stats()
        rst = ring_ing.instance(TENANT).columnar.stats()
        assert st == rst, (st, rst)
        assert st["decodes"] == 24 and st["decodes"] - st["cached"] == 0
        r = ing.instance(TENANT).search_live(SearchRequest(limit=50))
        assert len(r.traces) == 24
        assert ing.instance(TENANT).columnar.stats() == st  # the refresh decoded nothing
        lines = gen.metrics_text()
        calls = [ln for ln in lines if ln.startswith("traces_spanmetrics_calls_total")]
        assert sum(int(ln.rsplit(" ", 1)[1]) for ln in calls) == 24 * 4
        assert lines == rgen.metrics_text()
        assert dist.stats.gen_tap_errors == dist.stats.gen_tap_dropped == 0
        assert gen.stats["windows"] == 3 and gen.stats["freshness_n"] == 3
    finally:
        dist.stop()
        rdist.stop()


def test_decode_window_and_stats_match_reference():
    """The repair: ColumnarIngest.decode_window decodes a window's
    segments in order through the cache, and stats() counts as the
    reference's on the same calls (replay seeds included)."""
    from tempo_tpu.wire.segment import segment_for_write as r_segment_for_write
    from tempo_tpu_torch.wire.segment import segment_for_write

    traces = make_traces(10, seed=21, n_spans=3)
    batch = []
    for tid, tr in traces:
        lo, hi = tr.time_range_nanos()
        batch.append((tid, lo // 10**9, hi // 10**9 + 1,
                      segment_for_write(tr, lo // 10**9, hi // 10**9 + 1)))
    rbatch = [(tid, s, e, r_segment_for_write(r_decode_trace(encode_trace(tr)), s, e))
              for (tid, s, e, _), (_, tr) in zip(batch, traces)]
    assert [b[3] for b in batch] == [b[3] for b in rbatch]
    col, rcol = ColumnarIngest(), RColumnarIngest()
    feats, rfeats = col.decode_window(batch), rcol.decode_window(rbatch)
    assert [f.kv_codes for f in feats] == [f.kv_codes for f in rfeats]
    assert [f.spans.svc_code.tolist() for f in feats] == [f.spans.svc_code.tolist()
                                                          for f in rfeats]
    col.decode_window(batch[:4])
    rcol.decode_window(rbatch[:4])
    col.seed_strings(b"x" * 9, ("k\x00v",), ("n",), 1, 2)
    rcol.seed_strings(b"y" * 9, ("k\x00v",), ("n",), 1, 2)
    assert col.stats() == rcol.stats() == {"cached": 11, "decodes": 10, "seeded": 1,
                                           "dict_size": len(col.dict)}
    col.discard([b[3] for b in batch[:3]])
    rcol.discard([b[3] for b in rbatch[:3]])
    assert col.stats() == rcol.stats()


def test_tap_kernel_fault_surfaces_at_flush_while_push_succeeds(tmp_path, monkeypatch):
    dist, ing, gen = _stack(tmp_path)

    def fault(*a, **k):
        raise KernelError("span_reduce: CUDA error 700")

    monkeypatch.setattr(G, "span_metrics_reduce", fault)
    traces = make_traces(4, seed=7, n_spans=3)
    try:
        assert dist.push(TENANT, _request(traces).resource_spans) == 12
        with pytest.raises(KernelError, match="CUDA error 700"):
            dist.flush_generator_tap()
        assert dist.flush_generator_tap()  # raised once, then cleared
        assert dist.stats.traces_pushed == 4 and dist.stats.gen_tap_errors == 0
        assert ing.instance(TENANT).search_live(SearchRequest(limit=10)).traces
        # the next fault is kept again and stop() raises it
        dist.push(TENANT, _request(make_traces(2, seed=8, n_spans=2)).resource_spans)
        with pytest.raises(KernelError):
            dist.stop()
    finally:
        dist.stop()


def test_tap_other_errors_are_counted_not_raised(tmp_path):
    def broken(tenant, segs, ts):
        raise ValueError("generator bug")

    dist = Distributor(_ring(pring), lambda a: Recorder(), Overrides(),
                       generator_window=broken)
    try:
        for s in range(3):
            dist.push(TENANT, _request(make_traces(2, seed=s, n_spans=2)).resource_spans)
            assert dist.flush_generator_tap()
        assert dist.stats.gen_tap_errors == 3 and dist.stats.traces_pushed == 6
    finally:
        dist.stop()


def test_tap_greedy_merge_per_tenant(tmp_path):
    """While the tap is busy, queued pushes pile up; the next pass folds
    them as ONE window per tenant, segments concatenated in push order,
    stamped with the oldest push time."""
    gate, entered = threading.Event(), threading.Event()
    calls = []

    def window(tenant, segs, ts):
        calls.append((tenant, list(segs), ts))
        entered.set()
        assert gate.wait(5.0)

    rec = Recorder()
    dist = Distributor(_ring(pring), lambda a: rec, Overrides(), generator_window=window)
    try:
        dist.push("a", _request(make_traces(2, seed=1, n_spans=2)).resource_spans)
        assert entered.wait(5.0)  # the tap holds the first window
        for seed, tenant in ((2, "a"), (3, "b"), (4, "a"), (5, "b")):
            dist.push(tenant, _request(make_traces(3, seed=seed, n_spans=2)).resource_spans)
        assert not dist.flush_generator_tap(timeout_s=0.05)  # still blocked
        gate.set()
        assert dist.flush_generator_tap()
    finally:
        gate.set()
        dist.stop()
    assert [(t, len(s)) for t, s, _ in calls] == [("a", 2), ("a", 6), ("b", 6)]
    sent = {"a": [], "b": []}
    for tenant, batch in rec.batches:
        sent[tenant].append([seg for *_, seg in batch])
    assert calls[1][1] == sent["a"][1] + sent["a"][2]
    assert calls[2][1] == sent["b"][0] + sent["b"][1]
    assert all(x is y for x, y in zip(calls[1][1], sent["a"][1] + sent["a"][2]))
    assert calls[1][2] <= calls[2][2]


def test_tap_queue_overflow_is_counted(tmp_path, monkeypatch):
    from tempo_tpu_torch.services import distributor as D

    gate, entered = threading.Event(), threading.Event()

    def window(tenant, segs, ts):
        entered.set()
        gate.wait(5.0)

    monkeypatch.setattr(D, "TAP_QUEUE", 2)
    dist = Distributor(_ring(pring), lambda a: Recorder(), Overrides(), generator_window=window)
    try:
        dist.push(TENANT, _request(make_traces(1, seed=1, n_spans=1)).resource_spans)
        assert entered.wait(5.0)
        for s in range(4):
            dist.push(TENANT, _request(make_traces(1, seed=10 + s, n_spans=1)).resource_spans)
        assert dist.stats.gen_tap_dropped == 2 and dist.stats.traces_pushed == 5
    finally:
        gate.set()
        dist.stop()


def test_decoded_trace_leg_without_a_window_tap(tmp_path):
    """generator_forward alone: the tap resolves the traces on its worker
    and forwards only the post-filter set."""
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")
    traces = make_traces(5, seed=31, n_spans=3)
    big = make_traces(1, seed=32, n_spans=60)
    lim = Limits(max_bytes_per_trace=2 * len(encode_trace(traces[0][1])))
    dist = Distributor(_ring(pring), lambda a: Recorder(), Overrides(defaults=lim),
                       generator_forward=gen.push)
    try:
        dist.push(TENANT, _request(traces + big).resource_spans)
        assert dist.flush_generator_tap()
    finally:
        dist.stop()
    assert dist.stats.traces_refused_size == 1
    assert gen.stats["spans"] == 15


def test_distributor_stack_needs_a_card_without_a_device(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _stack(tmp_path, device=None)


def test_generator_modules_import_no_jax_and_no_reference():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, tempo_tpu_torch.services.distributor, tempo_tpu_torch.services.generator, "
            "tempo_tpu_torch.services.app, tempo_tpu_torch.ring, tempo_tpu_torch.ops.reduce, "
            "tempo_tpu_torch.util.linkcost; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tempo_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_link_rtt_is_measured_once_per_device():
    from tempo_tpu_torch.util import linkcost

    a = linkcost.link_rtt_ms("cpu")
    assert a > 0 and linkcost.link_rtt_ms("cpu") == a and "cpu" in linkcost._RTT_MS


def test_concurrent_pushes_count_every_span_and_fold_every_window(tmp_path):
    """More pushing threads than cores, with a short switch interval: no
    stats update and no tap window is lost (a lost read-modify-write
    would break the exact totals)."""
    import os
    import sys

    dist, ing, gen = _stack(tmp_path)
    n_threads = 2 * (os.cpu_count() or 4)
    per = [[make_traces(3, seed=1000 * t + i, n_spans=2) for i in range(6)]
           for t in range(n_threads)]
    errors = []

    def worker(batches):
        try:
            for b in batches:
                dist.push(TENANT, _request(b).resource_spans)
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(b,)) for b in per]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert dist.flush_generator_tap(timeout_s=60.0)
    finally:
        sys.setswitchinterval(old)
        dist.stop()
    n_traces = n_threads * 6 * 3
    assert dist.stats.traces_pushed == n_traces and dist.stats.gen_tap_dropped == 0
    assert dist.stats.spans_received == gen.stats["spans"] == 2 * n_traces
    assert ing.instance(TENANT).columnar.stats()["decodes"] == n_traces
