"""The port's metrics-generator on the CPU: its streaming plane against
its legacy decoded-trace plane (the differential of
tests/test_generator_streaming.py:79-110, seeds 3, 11, 29), and the
port's MetricsGenerator against the JAX package's on the same traces,
metrics_text() line for line; shedding and re-admission, exemplars,
staleness eviction and the generator's stats.

Durations are dyadic (exact in f32 and in the f64 accumulators), so
every comparison is an exact equality whatever the summation order."""

import random

import pytest

from tempo_tpu.services.generator import MetricsGenerator as RMetricsGenerator
from tempo_tpu.services.overrides import Limits as RLimits
from tempo_tpu.services.overrides import Overrides as ROverrides
from tempo_tpu.wire.otlp_pb import decode_trace as r_decode_trace
from tempo_tpu_torch.ingest.columnar import LiveDict, span_columns_from_trace
from tempo_tpu_torch.services.generator import (
    MetricsGenerator,
    ServiceGraphsProcessor,
    SpanMetricsProcessor,
    StreamingServiceGraphs,
    StreamingSpanMetrics,
)
from tempo_tpu_torch.services.overrides import Limits, Overrides
from tempo_tpu_torch.wire.model import Resource, ResourceSpans, ScopeSpans, Span, Trace
from tempo_tpu_torch.wire.otlp_pb import encode_trace

TENANT = "t1"

# dyadic seconds: exact in f32 AND in the f64 accumulators
_DYADIC_NS = (125_000_000, 250_000_000, 500_000_000, 1_000_000_000,
              62_500_000, 2_000_000_000)
_SERVICES = ["api-gateway", "auth", "cart", "db", "payments"]
_OPS = ["GET /", "POST /api", "db.query", "rpc.Call"]


def _span(rng, tid, name, kind, status, parent=b"", span_id=None):
    start = 1_700_000_000_000_000_000 + rng.randrange(10**9)
    dur = rng.choice(_DYADIC_NS)
    return Span(trace_id=tid, span_id=span_id or rng.getrandbits(64).to_bytes(8, "big"),
                parent_span_id=parent, name=name, kind=kind,
                start_unix_nano=start, end_unix_nano=start + dur,
                status_code=status)


def _graph_trace(rng):
    """One trace holding a client/server pair (sometimes unpaired,
    sometimes failed) plus internal spans (the reference test's shape)."""
    tid = rng.getrandbits(128).to_bytes(16, "big")
    tr = Trace()
    csvc, ssvc = rng.sample(_SERVICES, 2)
    cid = rng.getrandbits(64).to_bytes(8, "big")
    c_status = 2 if rng.random() < 0.2 else 0
    client = _span(rng, tid, "call " + rng.choice(_OPS), 3, c_status, span_id=cid)
    tr.resource_spans.append(ResourceSpans(
        resource=Resource(attrs={"service.name": csvc}),
        scope_spans=[ScopeSpans(spans=[client])]))
    spans = []
    if rng.random() < 0.8:  # paired server half (else the edge dangles)
        spans.append(_span(rng, tid, "serve " + rng.choice(_OPS), 2,
                           2 if rng.random() < 0.2 else 0, parent=cid))
    for _ in range(rng.randrange(0, 3)):
        spans.append(_span(rng, tid, rng.choice(_OPS), rng.choice([1, 4, 5]),
                           2 if rng.random() < 0.1 else 0))
    if spans:
        tr.resource_spans.append(ResourceSpans(
            resource=Resource(attrs={"service.name": ssvc}),
            scope_spans=[ScopeSpans(spans=spans)]))
    return tr


def _ref(traces):
    """The same traces in the JAX package's model (through OTLP proto)."""
    return [r_decode_trace(encode_trace(t)) for t in traces]


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_streaming_matches_legacy_differential(seed):
    """Randomized interleavings of push / collect / metrics_text: every
    exposition line from the port's streaming plane equals its legacy
    decoded-trace plane."""
    rng = random.Random(seed)
    legacy_sm = SpanMetricsProcessor(device="cpu")
    legacy_sg = ServiceGraphsProcessor(device="cpu")
    stream = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")

    for _ in range(rng.randrange(6, 12)):
        batch = [_graph_trace(rng) for _ in range(rng.randrange(1, 5))]
        legacy_sm.push(TENANT, batch)
        legacy_sg.push(TENANT, batch)
        stream.push(TENANT, batch)
        r = rng.random()
        if r < 0.3:
            legacy_sm.collect()
            legacy_sg.collect()
        elif r < 0.5:
            legacy_sm.metrics_text()
            legacy_sg.metrics_text()
            stream.metrics_text()

    legacy = sorted(legacy_sm.metrics_text() + legacy_sg.metrics_text())
    streaming = sorted(stream.metrics_text())
    assert streaming == legacy
    assert any(line.startswith("traces_service_graph_request_total") for line in legacy)
    sg = stream._procs(TENANT)["service-graphs"]
    assert len(sg.pending) == len(legacy_sg.pending)


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_generator_matches_reference(seed):
    """The port's MetricsGenerator and the JAX package's, fed the same
    pushes with the same interleaved scrapes, expose the same lines."""
    rng = random.Random(seed + 100)
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")
    rgen = RMetricsGenerator(ROverrides(), stale_series_s=3600.0)
    for _ in range(rng.randrange(6, 12)):
        batch = [_graph_trace(rng) for _ in range(rng.randrange(1, 6))]
        gen.push(TENANT, batch)
        rgen.push(TENANT, _ref(batch))
        if rng.random() < 0.3:
            assert gen.metrics_text() == rgen.metrics_text()
    got, want = gen.metrics_text(), rgen.metrics_text()
    assert got == want and len(got) > 100
    sm, rsm = gen._procs(TENANT)["span-metrics"], rgen._procs(TENANT)["span-metrics"]
    assert [vars(k) for k in sm.key_list] == [vars(k) for k in rsm.key_list]
    sg, rsg = gen._procs(TENANT)["service-graphs"], rgen._procs(TENANT)["service-graphs"]
    assert sg.edge_list == rsg.edge_list and len(sg.pending) == len(rsg.pending)


def test_streaming_shed_matches_legacy_and_readmits():
    """max-active-series sheds the same spans on both planes, and a shed
    key is NOT cached: capacity freed by eviction re-admits it. The JAX
    package's generator sheds the same count."""
    rng = random.Random(5)
    traces = [_graph_trace(rng) for _ in range(10)]
    legacy = SpanMetricsProcessor(max_active_series=3, device="cpu")
    legacy.push(TENANT, traces)
    gen = MetricsGenerator(Overrides(defaults=Limits(metrics_generator_max_active_series=3)),
                           stale_series_s=3600.0, device="cpu")
    gen.push(TENANT, traces)
    rgen = RMetricsGenerator(ROverrides(defaults=RLimits(metrics_generator_max_active_series=3)),
                             stale_series_s=3600.0)
    rgen.push(TENANT, _ref(traces))
    sm = gen._procs(TENANT)["span-metrics"]
    assert sm.dropped_series == legacy.dropped_series > 0
    assert sm.dropped_series == rgen._procs(TENANT)["span-metrics"].dropped_series
    assert sorted(sm.metrics_text()) == sorted(legacy.metrics_text())
    assert gen.stats["shed"] == {TENANT: sm.dropped_series}
    assert sm.evict_stale(0.0) == 3
    n = sm.push_columns([span_columns_from_trace(traces[-1], LiveDict().code)], LiveDict())
    assert n > 0 and len(sm.keys) <= 3


def test_evict_stale_frees_slots_and_stops_export():
    rng = random.Random(8)
    sm = StreamingSpanMetrics(device="cpu")
    ld = LiveDict()
    t_old = [_graph_trace(rng) for _ in range(4)]
    sm.push_columns([span_columns_from_trace(t, ld.code) for t in t_old], ld, now=1000.0)
    n_old = len(sm.key_list)
    assert n_old > 0 and sm.metrics_text()
    t_new = [_graph_trace(rng) for _ in range(2)]
    sm.push_columns([span_columns_from_trace(t, ld.code) for t in t_new], ld, now=2000.0)
    fresh = {s for s, ts in sm.last_update.items() if ts == 2000.0}
    n_evicted = sm.evict_stale(500.0, now=2100.0)
    assert n_evicted == len(sm.key_list) - len(fresh) and n_evicted > 0
    assert sorted(sm.free_sids) == sorted(set(range(len(sm.key_list))) - fresh)
    for s in sm.free_sids:
        assert sm.calls[s] == 0 and not sm.lat_buckets[s].any() and s not in sm.exemplars
    exported = {line.split("{", 1)[1].split("}", 1)[0] for line in sm.metrics_text()
                if line.startswith("traces_spanmetrics_calls_total")}
    assert len(exported) == len(fresh)
    # new keys take the evicted slots first and start from zero
    n_keys, n_free = len(sm.key_list), len(sm.free_sids)
    t3 = _graph_trace(random.Random(99))
    sm.push_columns([span_columns_from_trace(t3, ld.code)], ld, now=2200.0)
    n_new = len(sm.keys) - len(fresh)
    assert len(sm.key_list) == n_keys + max(0, n_new - n_free)
    assert sm.calls.sum() == sum(int(sm.calls[s]) for s in sm.last_update)


def test_streaming_exemplars_carry_trace_ids():
    rng = random.Random(19)
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")
    tr = _graph_trace(rng)
    gen.push(TENANT, [tr])
    tid_hex = tr.resource_spans[0].scope_spans[0].spans[0].trace_id.hex()
    text = "\n".join(gen.metrics_text())
    assert f'trace_id="{tid_hex}"' in text


def test_generator_stats_count_windows_spans_edges_and_freshness():
    rng = random.Random(23)
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")
    ld = LiveDict()
    traces = [_graph_trace(rng) for _ in range(12)]
    cols = [span_columns_from_trace(t, ld.code) for t in traces]
    gen.push_window(TENANT, cols, ld, push_ts=0.0)
    st = gen.stats
    assert st["windows"] == 1 and st["spans"] == sum(t.span_count() for t in traces)
    sg = gen._procs(TENANT)["service-graphs"]
    assert st["edges"] == int(sg.counts.sum()) > 0
    assert st["unpaired"] == len(sg.pending) and st["expired"] == 0
    assert set(st["stage_s"]) == {"span-metrics", "service-graphs"}
    assert st["freshness_n"] == 1 and st["freshness_max_s"] > 0


def test_processors_are_per_tenant_and_follow_limits():
    ov = Overrides(per_tenant={"only-sm": Limits(metrics_generator_processors=("span-metrics",))})
    gen = MetricsGenerator(ov, device="cpu")
    gen.push("only-sm", [_graph_trace(random.Random(2))])
    gen.push(TENANT, [_graph_trace(random.Random(2))])
    assert set(gen.tenants["only-sm"]) == {"span-metrics"}
    assert set(gen.tenants[TENANT]) == {"span-metrics", "service-graphs"}
    assert isinstance(gen.tenants[TENANT]["service-graphs"], StreamingServiceGraphs)


def test_generator_without_a_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MetricsGenerator(Overrides())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpanMetricsProcessor()
