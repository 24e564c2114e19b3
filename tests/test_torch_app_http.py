"""The port's single binary against the JAX package's, over HTTP on the
CPU: both Apps serve on loopback (the port's with device="cpu"), take
the same OTLP JSON pushes, and answer the same requests with equal
status codes and equal JSON bodies -- echo, ready and config, finds live
and (after /flush) from the backend, 404 for an absent id, searches by
tags and by TraceQL, tag discovery, query_range (sums at rtol 1e-5), the
progressive stream's final event, the X-Tempo-Cache header on a repeat,
and the 400s of bad requests. Then target gating, what is not ported
refusing by name, the serverless handler, a querier attached to a
dispatcher-only frontend through the job routes, and the missing card.

The Apps' own stores are written by their own packages from the same
pushes: a search's inspectedBytes (bytes read from each store) is not
compared, its traces and inspectedSpans are."""

import json
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from tempo_tpu import serverless as r_serverless
from tempo_tpu.services.app import App as RApp
from tempo_tpu.services.app import AppConfig as RAppConfig
from tempo_tpu.services.ingester import IngesterConfig as RIngesterConfig
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch import serverless
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.services.app import App, AppConfig, load_config_file
from tempo_tpu_torch.services.ingester import IngesterConfig
from tempo_tpu_torch.services.querier import Querier
from tempo_tpu_torch.util import breaker
from tempo_tpu_torch.wire import otlp_json

TENANT = "single-tenant"
TRACES = make_traces(24, seed=42, n_spans=5)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _ingester_kw() -> dict:
    return dict(max_trace_idle_s=0.0, max_block_age_s=0.0, flush_check_period_s=9999)


@pytest.fixture(autouse=True)
def _reset_port_breakers():
    """The port's breaker registry is its own process-wide singleton."""
    breaker.reset_for_tests()
    yield
    breaker.reset_for_tests()


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    """(port base URL, reference base URL, port App, reference App),
    each App on its own store; the first 12 traces pushed as OTLP JSON
    to both."""
    root = tmp_path_factory.mktemp("apps")
    port = App(AppConfig(storage_path=str(root / "port"), http_port=_free_port(),
                         compaction_cycle_s=9999, device="cpu",
                         ingester=IngesterConfig(**_ingester_kw())))
    ref = RApp(RAppConfig(storage_path=str(root / "ref"), http_port=_free_port(),
                          compaction_cycle_s=9999, ingester=RIngesterConfig(**_ingester_kw())))
    bases = []
    try:
        for app in (port, ref):
            app.start()
            app.serve_http(background=True)
            bases.append(f"http://127.0.0.1:{app.cfg.http_port}")
        for _, tr in TRACES[:12]:
            body = otlp_json.dumps(tr).encode()
            for base in bases:
                assert _post(base, "/v1/traces", body)[0] == 200
        yield bases[0], bases[1], port, ref
    finally:
        port.stop()
        ref.stop()


def _get(base: str, path: str, headers: dict | None = None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post(base: str, path: str, body: bytes, ctype: str = "application/json"):
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _both(apps, path: str):
    """(status, body) of one GET on each App."""
    pb, rb = apps[0], apps[1]
    return _get(pb, path)[:2], _get(rb, path)[:2]


def _search_body(body: bytes) -> dict:
    d = json.loads(body)
    d["metrics"].pop("inspectedBytes")
    return d


def test_echo_ready_and_config_match_reference(apps):
    (ps, pb), (rs, rb) = _both(apps, "/api/echo")
    assert (ps, pb) == (rs, rb) == (200, b"echo")
    assert _both(apps, "/ready")[0] == _both(apps, "/ready")[1] == (200, b"ready")
    # the port adds one field, `device`; ports, paths and ids differ by App
    per_app = {"http_port", "storage_path", "instance_id", "device"}
    for mode in ("", "?mode=defaults", "?mode=diff"):
        (ps, pb), (rs, rb) = _both(apps, "/status/config" + mode)
        assert ps == rs == 200
        pd, rd = json.loads(pb), json.loads(rb)
        assert set(pd) - set(rd) <= {"device"}
        assert {k: v for k, v in pd.items() if k not in per_app} == \
            {k: v for k, v in rd.items() if k not in per_app}
    assert json.loads(_get(apps[0], "/status/config")[1])["device"] == "cpu"
    assert _both(apps, "/status/config?mode=bogus")[0][0] == _both(
        apps, "/status/config?mode=bogus")[1][0] == 400


def test_push_find_live_flush_find_backend(apps):
    """Found live, then /flush (both ingesters cut a block), then found
    from the backend; an absent id is a 404 in both."""
    for tid, _ in TRACES[:3]:
        (ps, pb), (rs, rb) = _both(apps, f"/api/traces/{tid.hex()}")
        assert ps == rs == 200
        assert otlp_json.loads(pb) == otlp_json.loads(rb)
    for base in apps[:2]:
        assert _post(base, "/flush", b"")[0] == 204
    for app in apps[2:]:
        app.db.poll_now()
        assert len(app.db.blocklist.metas(TENANT)) == 1
    for tid, tr in TRACES[3:12]:
        (ps, pb), (rs, rb) = _both(apps, f"/api/traces/{tid.hex()}")
        assert ps == rs == 200
        assert otlp_json.loads(pb) == otlp_json.loads(rb)
        assert otlp_json.loads(pb).span_count() == tr.span_count()
    (ps, pb), (rs, rb) = _both(apps, "/api/traces/" + "00" * 16)
    assert ps == rs == 404 and json.loads(pb) == json.loads(rb)


def test_push_after_flush_is_found_live_beside_the_block(apps):
    """The second half of the traces pushed after the flush: live in the
    ingester while the first half lives in the block; finds and a
    search cover both."""
    for _, tr in TRACES[12:]:
        body = otlp_json.dumps(tr).encode()
        for base in apps[:2]:
            assert _post(base, "/v1/traces", body)[0] == 200
    for tid, _ in TRACES[12::4]:
        (ps, pb), (rs, rb) = _both(apps, f"/api/traces/{tid.hex()}")
        assert ps == rs == 200 and otlp_json.loads(pb) == otlp_json.loads(rb)
    (ps, pb), (rs, rb) = _both(apps, "/api/search?limit=100")
    assert ps == rs == 200
    assert _search_body(pb) == _search_body(rb)
    assert len(json.loads(pb)["traces"]) == len(TRACES)


@pytest.mark.parametrize("params", [
    "tags=service.name%3Ddb&limit=100",
    "q=" + urllib.parse.quote('{ resource.service.name = "db" }') + "&limit=100",
    "q=" + urllib.parse.quote('{ kind = server && duration > 10ms }') + "&limit=7",
    "minDuration=50ms&maxDuration=2s&limit=100",
])
def test_search_matches_reference(apps, params):
    (ps, pb), (rs, rb) = _both(apps, f"/api/search?{params}")
    assert ps == rs == 200
    assert _search_body(pb) == _search_body(rb)
    assert json.loads(pb)["traces"]


def test_tag_discovery_matches_reference(apps):
    for path in ("/api/search/tags", "/api/search/tag/service.name/values",
                 "/api/search/tag/http.method/values"):
        (ps, pb), (rs, rb) = _both(apps, path)
        assert ps == rs == 200 and json.loads(pb) == json.loads(rb), path


def _range() -> tuple[int, int]:
    lo = min(t.time_range_nanos()[0] for _, t in TRACES) // 10**9
    hi = max(t.time_range_nanos()[1] for _, t in TRACES) // 10**9 + 1
    return lo, hi


@pytest.mark.parametrize("query", [
    '{ true } | count_over_time() by (resource.service.name)',
    '{ kind = server } | sum_over_time(duration) by (name)',
])
def test_query_range_matches_reference(apps, query):
    lo, hi = _range()
    path = (f"/api/metrics/query_range?q={urllib.parse.quote(query)}"
            f"&start={lo - 30}&end={hi + 30}&step=15s")
    (ps, pb), (rs, rb) = _both(apps, path)
    assert ps == rs == 200
    pd, rd = json.loads(pb), json.loads(rb)
    assert pd["status"] == rd["status"] == "success"
    got = {json.dumps(s["metric"], sort_keys=True): s["values"] for s in pd["data"]["result"]}
    want = {json.dumps(s["metric"], sort_keys=True): s["values"] for s in rd["data"]["result"]}
    assert got.keys() == want.keys() and got
    for k, vals in want.items():
        assert [t for t, _ in got[k]] == [t for t, _ in vals]
        np.testing.assert_allclose([float(v) for _, v in got[k]], [float(v) for _, v in vals],
                                   rtol=1e-5, atol=0)


def _stream_events(base: str, path: str) -> list:
    status, body, headers = _get(base, path)
    assert status == 200 and headers["Content-Type"] == "application/x-ndjson"
    return [json.loads(line) for line in body.decode().splitlines() if line]


def test_stream_final_event_equals_blocking_body(apps):
    """A fresh stream= search: its final event equals the reference's
    and, past the cache, the port's own blocking body. The stream merges
    its jobs as they complete, so the limit holds every match."""
    q = urllib.parse.quote('{ duration > 20ms }')
    path = f"/api/search?q={q}&limit=99&stream=true"
    port_ev = _stream_events(apps[0], path)
    ref_ev = _stream_events(apps[1], path)
    assert port_ev[-1]["done"] and ref_ev[-1]["done"]
    assert port_ev[-1]["jobsTotal"] == ref_ev[-1]["jobsTotal"] >= 2

    def final(ev):
        return {"traces": ev["traces"], "spans": ev["metrics"]["inspectedSpans"]}

    assert final(port_ev[-1]) == final(ref_ev[-1])
    apps[2].frontend.result_cache.clear()
    st, body, _ = _get(apps[0], f"/api/search?q={q}&limit=99")
    blocking = json.loads(body)
    assert final(port_ev[-1]) == {"traces": blocking["traces"],
                                  "spans": blocking["metrics"]["inspectedSpans"]}


def test_cache_header_on_repeat(apps):
    """A new query misses, its repeat hits, with the same body, in both."""
    q = urllib.parse.quote('{ span.http.status_code >= 400 }')
    heads, bodies = [], []
    for base in apps[:2]:
        for _ in range(2):
            st, body, h = _get(base, f"/api/search?q={q}&limit=11")
            assert st == 200
            heads.append(h["X-Tempo-Cache"])
            bodies.append(_search_body(body))
    assert heads == ["miss", "hit", "miss", "hit"]
    assert bodies[0] == bodies[1] == bodies[2] == bodies[3]


def test_bad_requests_match_reference(apps):
    for path in ("/api/search?q=" + urllib.parse.quote("{ name = "),
                 "/api/search?q=" + urllib.parse.quote("{ true } | rate()"),
                 "/api/search?minDuration=500us",
                 "/api/metrics/query_range?q=" + urllib.parse.quote("{ true } | rate()")
                 + "&step=-5",
                 "/api/metrics/query_range",
                 "/api/nope"):
        (ps, _), (rs, _) = _both(apps, path)
        assert ps == rs and ps in (400, 404), path


def test_usage_stats_and_metrics(apps):
    st, body, _ = _get(apps[0], "/status/usage-stats")
    rep = json.loads(body)
    assert st == 200 and rep["clusterID"] and rep["target"] == "all"
    assert json.loads(_get(apps[0], "/status/usage-stats")[1])["clusterID"] == rep["clusterID"]
    assert rep["metrics"]["blocklist_length"] == 1 and rep["metrics"]["spans_received"] > 0
    st, body, _ = _get(apps[0], "/metrics")
    text = body.decode()
    assert st == 200 and text.endswith("# EOF\n")
    total = sum(t.span_count() for _, t in TRACES)
    assert f"tempo_distributor_spans_received_total {total}" in text
    for fam in ('tempo_frontend_query_duration_seconds_bucket{op="search"',
                'tempo_frontend_queries_total{op="traces",outcome="ok"}',
                "tempo_result_cache_hits_total", "tempo_blocklist_length 1",
                "traces_spanmetrics_calls_total"):
        assert fam in text, fam


def test_multitenancy_header(tmp_path):
    """With multitenancy on, a push or a query without X-Scope-OrgID is
    a 401 in both packages; with one, the tenant's own data answers."""
    port = App(AppConfig(storage_path=str(tmp_path / "p"), multitenancy=True, device="cpu",
                         compaction_cycle_s=9999, ingester=IngesterConfig(**_ingester_kw())))
    ref = RApp(RAppConfig(storage_path=str(tmp_path / "r"), multitenancy=True,
                          compaction_cycle_s=9999, ingester=RIngesterConfig(**_ingester_kw())))
    out = []
    try:
        for app in (port, ref):
            app.start()
            app.serve_http(port=_free_port(), background=True)
            base = f"http://127.0.0.1:{app.http_server.server_address[1]}"
            tid, tr = TRACES[0]
            st_push = _post(base, "/v1/traces", otlp_json.dumps(tr).encode())[0]
            req = urllib.request.Request(base + "/v1/traces", data=otlp_json.dumps(tr).encode(),
                                         headers={"Content-Type": "application/json",
                                                  "X-Scope-OrgID": "acme"})
            with urllib.request.urlopen(req, timeout=30) as r:
                st_ok = r.status
            st_get = _get(base, f"/api/traces/{tid.hex()}")[0]
            st_t, body, _ = _get(base, f"/api/traces/{tid.hex()}", {"X-Scope-OrgID": "acme"})
            st_other = _get(base, f"/api/traces/{tid.hex()}", {"X-Scope-OrgID": "other"})[0]
            out.append((st_push, st_ok, st_get, st_t, st_other, otlp_json.loads(body)))
    finally:
        port.stop()
        ref.stop()
    assert out[0] == out[1]
    assert out[0][:5] == (401, 200, 401, 200, 404)


def test_target_gating(tmp_path):
    """querier-only and compactor-only processes, as in the JAX
    package's App; a standalone distributor and an unknown target are
    refused."""
    app = App(AppConfig(target="querier", storage_path=str(tmp_path / "s1"), device="cpu"))
    assert app.ingester is None and app.compactor is None and app.distributor is None
    assert app.querier is not None and app.frontend is not None
    assert app.frontend.self_tracer is None
    with pytest.raises(ValueError, match="self-tracing"):
        app.frontend.self_tracer = object()
    app.start()
    assert app.ready()
    app.stop()
    app = App(AppConfig(target="compactor", storage_path=str(tmp_path / "s2"),
                        compaction_cycle_s=9999, device="cpu"))
    assert app.compactor is not None and app.querier is None and app.frontend is None
    app.stop()
    app = App(AppConfig(target="ingester", storage_path=str(tmp_path / "s3"), device="cpu"))
    assert app.ingester is not None and app.querier is None and app.distributor is None
    app.stop()
    for target in ("distributor", "bogus"):
        with pytest.raises(ValueError):
            App(AppConfig(target=target, storage_path=str(tmp_path / "s4"), device="cpu"))


@pytest.mark.parametrize("field,value,item", [
    ("otlp_grpc_port", 4317, "item 8"),
    ("kv_dir", "/tmp/kv", "item 8"),
    ("replication_factor", 3, "item 8"),
    ("self_tracing_tenant", "self", "item 9"),
    ("compile_cache_dir", "/tmp/xla", "XLA compile plane"),
])
def test_unported_config_raises_naming_where_it_goes(tmp_path, field, value, item):
    cfg = AppConfig(storage_path=str(tmp_path / "s"), device="cpu")
    setattr(cfg, field, value)
    with pytest.raises(ValueError, match=item):
        App(cfg)


def test_unported_routes_answer_501(apps):
    for path in ("/status/kernels", "/status/slo", "/debug/threads",
                 f"/jaeger/api/traces/{TRACES[0][0].hex()}"):
        st, body, _ = _get(apps[0], path)
        assert st == 501 and "ROADMAP" in json.loads(body)["error"], path
    st, body = _post(apps[0], "/api/v2/spans", b"[]")
    assert st == 501 and "item 8" in json.loads(body)["error"]


def test_config_file_round_trip(tmp_path, monkeypatch):
    """load_config_file's envsubst and key check, as the JAX package's."""
    from tempo_tpu.services.app import load_config_file as r_load

    cfg = tmp_path / "tempo.yaml"
    cfg.write_text("target: ${T:-all}\nstorage_path: ${S}\nhttp_port: 0\ndevice: cpu\n")
    monkeypatch.setenv("S", "/data/blocks")
    got = load_config_file(str(cfg), expand_env=True)
    assert got == {"target": "all", "storage_path": "/data/blocks", "http_port": 0,
                   "device": "cpu"}
    cfg.write_text("target: all\nbogus: 1\n")
    for load in (load_config_file, r_load):
        with pytest.raises(ValueError, match="bogus"):
            load(str(cfg))


def test_serverless_handler_matches_reference(tmp_path):
    """A block-shard search through the port's serverless endpoint (on
    the CPU) equals the JAX package's handler on the same store, and the
    port's Querier ships its shard jobs there with a hedged POST."""
    store = str(tmp_path / "store")
    db = TempoDB(TempoDBConfig(backend={"backend": "local", "path": store}), device="cpu")
    db.write_block("t1", make_traces(40, seed=9, n_spans=6))
    db.poll_now()
    meta = db.blocklist.metas("t1")[0]
    event = {"backend": {"backend": "local", "path": store}, "tenant": "t1",
             "block_id": meta.block_id, "groups": None,
             "search": {"query": '{ kind = server }', "limit": 100}}
    got = serverless.handler(event, device="cpu")
    want = r_serverless.handler(event)
    assert got["traces"] == want["traces"] and got["inspectedSpans"] == want["inspectedSpans"]
    srv = serverless.serve(0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    q = Querier(db, None, None, external_endpoints=[f"http://127.0.0.1:{srv.server_address[1]}/"],
                external_hedge_after_s=2.0)
    try:
        req = SearchRequest(query='{ kind = server }', limit=100)
        ext = q.search_block_shard("t1", meta, req, None)
        local = db.search_block_shard("t1", meta, req, None)
        assert q.stats.external_searches == 1 and q.stats.external_failures == 0
        assert [t.trace_id for t in ext.traces] == [t.trace_id for t in local.traces]
        dead = Querier(db, None, None, external_endpoints=["http://127.0.0.1:1/"],
                       external_hedge_after_s=0.2)
        back = dead.search_block_shard("t1", meta, req, None)
        assert dead.stats.external_failures == 1
        assert [t.trace_id for t in back.traces] == [t.trace_id for t in local.traces]
        dead.close()
    finally:
        srv.shutdown()
        srv.server_close()
        q.close()


def test_querier_attaches_through_the_job_routes(apps, tmp_path):
    """A dispatcher-only query-frontend (no local workers) over the
    port App's store, and a standalone querier App that pulls its jobs
    through /internal/jobs/poll and /internal/jobs/result: the answers
    equal the single binary's."""
    store = apps[2].cfg.storage_path
    fe = App(AppConfig(target="query-frontend", storage_path=store, frontend_workers=0,
                       device="cpu", instance_id="fe"))
    fe.start()
    fe.serve_http(port=_free_port(), background=True)
    fe_base = f"http://127.0.0.1:{fe.http_server.server_address[1]}"
    qr = App(AppConfig(target="querier", storage_path=store, device="cpu", instance_id="q1",
                       frontend_addr=fe_base, worker_concurrency=2))
    qr.querier_worker.poll_wait_s = 0.5
    qr.start()
    try:
        tid = TRACES[5][0]
        st, body, _ = _get(fe_base, f"/api/traces/{tid.hex()}")
        assert st == 200
        assert otlp_json.loads(body) == otlp_json.loads(_get(apps[0], f"/api/traces/{tid.hex()}")[1])
        q = urllib.parse.quote('{ resource.service.name = "db" }')
        st, body, _ = _get(fe_base, f"/api/search?q={q}&limit=100")
        assert st == 200
        # the block only: this frontend's process hosts no ingester
        want = apps[2].db.search(TENANT, SearchRequest(query='{ resource.service.name = "db" }',
                                                       limit=100))
        assert [t["traceID"] for t in json.loads(body)["traces"]] == \
            [t.trace_id for t in want.traces]
        assert fe.frontend.stats_jobs_remote >= 3 and fe.frontend.stats_jobs_local == 0
        assert qr.querier_worker.jobs_executed >= 3 and qr.querier_worker.jobs_failed == 0
    finally:
        qr.stop()
        fe.stop()


def test_no_device_raises_without_a_card(tmp_path):
    """device=None means the first card: no card, no App (and nothing
    falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        App(AppConfig(storage_path=str(tmp_path / "s")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serverless.serve(0)
