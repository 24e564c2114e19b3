"""The port's App on the card against one on the CPU, over HTTP, over one
small store: two make_traces blocks and a 1,024 x 16 synth block. Finds,
searches (at a limit above every match count, so the order the jobs
finish in cannot choose the answer), tag discovery and query_range
answer the same on both; then the same OTLP pushes into both ingesters
are found and searched live. The card App must have launched K1, K2, K3,
B6 and B7a through the frontend's jobs.

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_cuda_app.py"""

import json
import socket
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from tempo_tpu_torch import kernels
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.services.app import App, AppConfig
from tempo_tpu_torch.services.ingester import IngesterConfig
from tempo_tpu_torch.util.synth import synth_block
from tempo_tpu_torch.util.testdata import make_traces
from tempo_tpu_torch.wire import otlp_json

pytestmark = pytest.mark.cuda

TENANT = "single-tenant"
QUERIES = ['{ resource.service.name = "db" }', '{ kind = server && duration > 10ms }',
           '{ name =~ "op-00[0-3].*" }', '{ kind = server } > { status = error }',
           '{ span.http.status_code = 500 } || { status = error }']
METRICS = ['{ true } | rate() by (resource.service.name)',
           '{ kind = server } | avg_over_time(duration) by (name)']


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(base + path, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    root = tmp_path_factory.mktemp("cuda-app")
    store = str(root / "store")
    db = TempoDB(TempoDBConfig(backend={"backend": "local", "path": store}), device="cpu")
    traces = make_traces(200, seed=3, n_spans=8)
    db.write_block(TENANT, traces[:100])
    db.write_block(TENANT, traces[100:])
    _, ids = synth_block(LocalBackend(store), TENANT, np.random.default_rng(5), 1024, 16)
    db.close()
    out = []
    for dev in ("cuda:0", "cpu"):
        app = App(AppConfig(storage_path=store, http_port=_free_port(), compaction_cycle_s=9999,
                            device=dev, instance_id=f"app-{dev}",
                            ingester=IngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0,
                                                    flush_check_period_s=9999)))
        app.start()
        app.serve_http(background=True)
        out.append((app, f"http://127.0.0.1:{app.cfg.http_port}"))
    yield out, traces, ids
    for app, _ in out:
        app.stop()


def _both(apps, path: str):
    (_, card), (_, cpu) = apps
    return _get(card, path), _get(cpu, path)


def _strip(body: bytes) -> dict:
    d = json.loads(body)
    d["metrics"].pop("inspectedBytes")
    return d


def test_card_app_answers_like_the_cpu_app(apps):
    pair, traces, ids = apps
    card_app = pair[0][0]
    assert card_app.db.device.type == "cuda" and card_app.ingester.device.type == "cuda"
    kernels.reset_counts()
    present = [t for t, _ in traces[::25]] + [bytes(ids[i]) for i in (0, 511, 1023)]
    for tid in present + [bytes([0xEE] * 16)]:
        (cs, cb), (ps, pb) = _both(pair, f"/api/traces/{tid.hex()}")
        assert cs == ps and cs in (200, 404)
        if cs == 200:
            assert otlp_json.loads(cb) == otlp_json.loads(pb)
    for q in QUERIES:
        (cs, cb), (ps, pb) = _both(pair, f"/api/search?q={urllib.parse.quote(q)}&limit=5000")
        assert cs == ps == 200 and _strip(cb) == _strip(pb), q
    for path in ("/api/search/tags", "/api/search/tag/service.name/values"):
        (cs, cb), (ps, pb) = _both(pair, path)
        assert cs == ps == 200 and json.loads(cb) == json.loads(pb)
    metas = card_app.db.metas(TENANT)
    lo = min(m.start_time_unix_nano for m in metas) // 10**9
    hi = -(-max(m.end_time_unix_nano for m in metas) // 10**9)
    for q in METRICS:
        (cs, cb), (ps, pb) = _both(
            pair, f"/api/metrics/query_range?q={urllib.parse.quote(q)}&start={lo}&end={hi}&step=60")
        assert cs == ps == 200
        got = {json.dumps(s["metric"], sort_keys=True): s["values"]
               for s in json.loads(cb)["data"]["result"]}
        want = {json.dumps(s["metric"], sort_keys=True): s["values"]
                for s in json.loads(pb)["data"]["result"]}
        assert got.keys() == want.keys() and got
        for k, vals in want.items():
            np.testing.assert_allclose([float(v) for _, v in got[k]],
                                       [float(v) for _, v in vals], rtol=1e-5, atol=0)
    counts = dict(kernels.LAUNCHES)
    for name in ("filter", "select", "find", "timeseries"):
        assert counts[name] > 0, (name, counts)
    assert not any(card_app.frontend.stats["jobs_failed"].values())


def test_card_app_live_head_answers_like_the_cpu_app(apps):
    pair, _, _ = apps
    live = make_traces(24, seed=11, n_spans=6)
    for _, tr in live:
        body = otlp_json.dumps(tr).encode()
        for _, base in pair:
            req = urllib.request.Request(base + "/v1/traces", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
    kernels.reset_counts()
    for tid, _ in live[::5]:
        (cs, cb), (ps, pb) = _both(pair, f"/api/traces/{tid.hex()}")
        assert cs == ps == 200 and otlp_json.loads(cb) == otlp_json.loads(pb)
    for q in QUERIES[:2]:
        (cs, cb), (ps, pb) = _both(pair, f"/api/search?q={urllib.parse.quote(q)}&limit=5000")
        assert cs == ps == 200 and _strip(cb) == _strip(pb), q
    assert kernels.LAUNCHES["live_filter"] > 0 and kernels.LAUNCHES["select"] > 0
    assert not any(pair[0][0].frontend.stats["jobs_failed"].values())
