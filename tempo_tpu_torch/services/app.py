"""App runtime: config root, module wiring, HTTP server, targets (port of
tempo_tpu/services/app.py).

Reference: cmd/tempo/app -- module DAG (modules.go:360-414), single
binary running any role or `all` (config.go Target), HTTP API routes
(pkg/api/http.go:56-60). The single-binary target wires every module
in-process over an in-memory ring, exactly the topology the reference
uses for tests (cmd/tempo/main.go:186-194).

    python -m tempo_tpu_torch.services.app --target=all --storage.path=DIR [--device cpu]

Every module of the process runs on one device: `AppConfig.device`
(None: the first card, and an error without one; "cpu" runs the plain
versions, as the tests do). The read path reaches the kernels through
the frontend's jobs: finds through K3, searches through K1/K2 (B5a/B5b
where the batcher groups jobs), metrics through B6, and the ingester
legs through the live head (B7a/B7b, then K2).

Targets: all, ingester, querier, query-frontend, compactor and
metrics-generator, on the in-memory ring. What is not ported refuses
loudly: an AppConfig field whose module is missing raises ValueError
naming its ROADMAP item (§A item 8: the receivers, shared rings and
remote transport, remote write; item 9: self-tracing, chaos, the
status and debug planes), and each of those routes answers 501.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..db.search import SearchRequest
from ..db.tempodb import TempoDB, TempoDBConfig
from ..db.wal import WAL
from ..ops.device import resolve_device
from ..ring.ring import HEARTBEAT_TIMEOUT_S, InMemoryKV, Lifecycler, Ring
from ..util.metrics import Gauge, escape_label, render_openmetrics
from ..util.traceid import parse_trace_id
from ..wire import otlp_json
from .compactor import Compactor
from .distributor import Distributor, PushError
from .frontend import Frontend, TooManyRequests
from .ingester import Ingester, IngesterConfig
from .overrides import Overrides
from .querier import Querier

DEFAULT_TENANT = "single-tenant"
TENANT_HEADER = "X-Scope-OrgID"  # reference: shared orgid header

INGESTER_RING = "ingester-ring"
COMPACTOR_RING = "compactor-ring"


def generator_window_tap(ingester, generator):
    """The distributor's `generator_window` for an in-process ingester
    and generator (App._generator_window of the JAX package). It runs on
    the distributor's tap worker: each segment's coded span columns come
    from the tenant instance's ColumnarIngest -- the one decode of that
    segment, whose cache the live head's refresh reads later -- and the
    window folds into the generator."""

    def tap(tenant: str, segs: list, push_ts: float) -> None:
        col = ingester.instance(tenant).columnar
        cols = []
        for seg in segs:
            feat = col.features_for(seg)
            if feat.spans is not None:
                cols.append(feat.spans)
        if cols:
            generator.push_window(tenant, cols, col.dict, push_ts)

    return tap


@dataclass
class AppConfig:
    target: str = "all"  # all | ingester | querier | query-frontend | ...
    http_port: int = 3200
    storage_path: str = "./tempo-data"
    wal_path: str = ""
    overrides_path: str = ""
    multitenancy: bool = False
    instance_id: str = ""  # empty = derive tempo-<http_port>
    replication_factor: int = 1
    ingester: IngesterConfig = field(default_factory=IngesterConfig)
    compaction_cycle_s: float = 30.0
    enable_generator: bool = True
    # multi-process topology: shared ring-KV directory + the address other
    # processes reach this one at (http://host:port). Empty = single binary
    # with an in-memory ring.
    kv_dir: str = ""
    # OR true multi-host membership: gossip bind addr (host:port, 0 port =
    # ephemeral) + comma-separated seed peers (reference: memberlist)
    gossip_bind: str = ""
    gossip_seeds: str = ""
    gossip_advertise: str = ""  # addr peers dial (wildcard binds need it)
    advertise_addr: str = ""
    http_host: str = ""  # default: loopback, or 0.0.0.0 when advertising non-loopback
    # shared secret for /internal/* and remote /flush//shutdown when the
    # server is reachable beyond loopback
    internal_token: str = ""
    # standalone querier: comma-separated frontend addresses to attach to
    # and pull jobs from (reference: querier.frontend-address)
    frontend_addr: str = ""
    frontend_workers: int = 8  # in-process worker threads (0 = dispatcher-only)
    # receiver ports (OTLP gRPC, OpenCensus, Jaeger gRPC and agent) and
    # the Kafka receiver: 0 / "" = disabled
    otlp_grpc_port: int = 0
    opencensus_grpc_port: int = 0
    jaeger_grpc_port: int = 0
    jaeger_agent_port: int = 0
    kafka_brokers: str = ""
    kafka_topic: str = ""
    kafka_tenant: str = ""
    # self-tracing: query operations emit spans into this tenant ("" = off)
    self_tracing_tenant: str = ""
    # metrics-generator remote-write target ("" = expose on /metrics only)
    remote_write_url: str = ""
    remote_write_interval_s: float = 15.0
    # comma-separated serverless search endpoints: block-shard jobs POST
    # there with hedging, local execution as fallback (reference:
    # querier.search.external_endpoints, querier.go:401-458)
    search_external_endpoints: str = ""
    search_external_hedge_after_s: float = 4.0
    # the JAX package's XLA compile plane: persistent compile cache,
    # measured-crossover CostLedger, AOT warmup of recorded shapes
    compile_cache_dir: str = ""
    cost_ledger_path: str = ""
    # chaos plane: fault-injection rules as inline JSON or a file path
    chaos_rules: str = ""
    warmup_shapes: bool = False
    # ring liveness window in seconds (0 = ring.HEARTBEAT_TIMEOUT_S)
    ring_heartbeat_timeout: float = 0.0
    # per-RPC deadline for remote ingester clients
    rpc_deadline_s: float = 10.0
    # standalone-querier worker threads against the frontend job API
    # (reference: querier.max-concurrent-queries)
    worker_concurrency: int = 4
    # the torch device every module of this process runs on (None: the
    # first card, an error without one; "cpu": the plain versions)
    device: str | None = None


# AppConfig fields whose module the port does not have yet, and where it
# is queued: setting one (to anything but its default) raises
_UNPORTED_FIELDS = {
    "kv_dir": "ROADMAP §A item 8 (shared rings: transport/filekv)",
    "gossip_bind": "ROADMAP §A item 8 (shared rings: transport/gossip)",
    "gossip_seeds": "ROADMAP §A item 8 (shared rings: transport/gossip)",
    "gossip_advertise": "ROADMAP §A item 8 (shared rings: transport/gossip)",
    "otlp_grpc_port": "ROADMAP §A item 8 (the receivers: services/otlp_grpc.py)",
    "opencensus_grpc_port": "ROADMAP §A item 8 (the receivers: services/opencensus_grpc.py)",
    "jaeger_grpc_port": "ROADMAP §A item 8 (the receivers: services/jaeger_grpc.py)",
    "jaeger_agent_port": "ROADMAP §A item 8 (the receivers: services/jaeger_agent.py)",
    "kafka_brokers": "ROADMAP §A item 8 (the receivers: services/kafka_receiver.py)",
    "kafka_topic": "ROADMAP §A item 8 (the receivers: services/kafka_receiver.py)",
    "kafka_tenant": "ROADMAP §A item 8 (the receivers: services/kafka_receiver.py)",
    "remote_write_url": "ROADMAP §A item 8 (services/remotewrite.py)",
    "remote_write_interval_s": "ROADMAP §A item 8 (services/remotewrite.py)",
    "replication_factor": "ROADMAP §A item 8 (rf > 1: fleet/replication and fleet/quorum)",
    "rpc_deadline_s": "ROADMAP §A item 8 (remote ingester clients: transport/client.py)",
    "self_tracing_tenant": "ROADMAP §A item 9 (services/selftrace.py)",
    "chaos_rules": "ROADMAP §A item 9 (chaos/)",
    "compile_cache_dir": "the JAX package's XLA compile plane, which the port has no use for",
    "cost_ledger_path": "the JAX package's XLA compile plane (util/costledger), which the "
                        "port has no use for",
    "warmup_shapes": "the JAX package's XLA compile plane (util/warmup), which the port has "
                     "no use for",
}

# routes of the JAX package's App that the port does not serve yet
_UNPORTED_ROUTES = {
    "/status/kernels": "ROADMAP §A item 9 (util/kerneltel)",
    "/status/cost": "ROADMAP §A item 9 (util/costmodel)",
    "/status/chaos": "ROADMAP §A item 9 (chaos/)",
    "/status/fleet": "ROADMAP §A item 8 (fleet/)",
    "/status/slo": "ROADMAP §A item 9 (util/slo)",
    "/status/profile": "ROADMAP §A item 9 (util/profiler)",
    "/debug/": "ROADMAP §A item 9 (util/profiler)",
    "/jaeger/api/traces/": "ROADMAP §A item 8 (wire/jaeger, tempo_query.py)",
    "/api/traces": "ROADMAP §A item 8 (wire/jaeger_thrift)",
    "/api/v2/spans": "ROADMAP §A item 8 (wire/zipkin)",
    "/internal/": "ROADMAP §A item 8 (transport/client.py)",
}


def _unported_route(path: str) -> str | None:
    for prefix, where in _UNPORTED_ROUTES.items():
        if path == prefix or (prefix.endswith("/") and path.startswith(prefix)):
            return where
    return None


def _check_ported(cfg: AppConfig) -> None:
    defaults = AppConfig()
    for name, where in _UNPORTED_FIELDS.items():
        if getattr(cfg, name) != getattr(defaults, name):
            raise ValueError(f"AppConfig.{name} = {getattr(cfg, name)!r}: the port does not "
                             f"have this yet ({where})")


class App:
    """All modules of one process, wired per target."""

    VALID_TARGETS = ("all", "distributor", "ingester", "querier", "query-frontend",
                     "compactor", "metrics-generator")

    def __init__(self, cfg: AppConfig):
        if cfg.target == "distributor":
            raise ValueError(
                "standalone distributor needs a shared ring to reach remote ingesters, "
                "which the port does not have yet (ROADMAP §A item 8); run -target=all "
                "(single binary)")
        if cfg.target not in self.VALID_TARGETS:
            raise ValueError(f"unknown target {cfg.target!r}; one of {self.VALID_TARGETS}")
        _check_ported(cfg)
        self.device = resolve_device(cfg.device)  # no card and no device: raises here
        if not cfg.instance_id:
            cfg.instance_id = f"tempo-{cfg.http_port}"
        self.cfg = cfg

        def has(role: str) -> bool:
            return cfg.target in ("all", role)

        # per-instance WAL dir: ingesters sharing --storage.path must never
        # replay (and delete) each other's live WAL files
        wal_path = cfg.wal_path or os.path.join(cfg.storage_path, "wal", cfg.instance_id)
        self.db = TempoDB(
            TempoDBConfig(backend={"backend": "local", "path": cfg.storage_path}),
            device=self.device,
        )
        self.db.poll_now()
        self.overrides = Overrides(path=cfg.overrides_path)
        self.kv = InMemoryKV()
        hb_timeout = cfg.ring_heartbeat_timeout or HEARTBEAT_TIMEOUT_S
        # heartbeat fast enough that a live instance never looks dead
        # inside its own liveness window
        hb_period = min(5.0, max(0.2, hb_timeout / 4.0))
        self.ring = Ring(self.kv, INGESTER_RING, heartbeat_timeout=hb_timeout)

        # addr -> in-process client (remote clients come with transport/)
        self._clients: dict[str, object] = {}

        def client_for(addr: str):
            try:
                return self._clients[addr]
            except KeyError:
                raise KeyError(f"unknown instance addr {addr!r} (remote ingester clients "
                               "need transport/, ROADMAP §A item 8)") from None

        self.client_for = client_for

        self.ingester = self.lifecycler = None
        if has("ingester"):
            self.ingester = Ingester(
                WAL(wal_path, fsync_interval_s=cfg.ingester.wal_fsync_interval_s),
                self.db, self.overrides, cfg.ingester, device=self.device)
            self.ingester.replay_wal()
            self.lifecycler = Lifecycler(self.kv, INGESTER_RING, cfg.instance_id,
                                         addr=cfg.advertise_addr,
                                         heartbeat_period=hb_period,
                                         prune_timeout=hb_timeout)
            self._clients[self.lifecycler.desc.addr] = self.ingester

        self.generator = None
        if cfg.enable_generator and has("metrics-generator"):
            from .generator import MetricsGenerator

            self.generator = MetricsGenerator(self.overrides, device=self.device)

        self.distributor = None
        if cfg.target == "all":
            # streaming tap: the generator AND the ingester share this
            # process, so the tap reads coded span columns out of the
            # ingester's ColumnarIngest cache (the write path already
            # decoded them) instead of re-decoding traces
            gen_window = (generator_window_tap(self.ingester, self.generator)
                          if self.generator is not None else None)
            self.distributor = Distributor(
                self.ring, self.client_for, self.overrides,
                generator_window=gen_window)

        self.querier = self.frontend = self.querier_worker = None
        if has("querier") or has("query-frontend"):
            ext = [e.strip() for e in cfg.search_external_endpoints.split(",")
                   if e.strip()]
            self.querier = Querier(
                self.db, self.ring if self._clients else None, self.client_for,
                external_endpoints=ext,
                external_hedge_after_s=cfg.search_external_hedge_after_s,
            )
            self.frontend = Frontend(self.querier, n_workers=cfg.frontend_workers,
                                     overrides=self.overrides)
            if self.frontend.result_cache is not None and self.ingester is not None:
                # live-head generation feed: result-cache entries over
                # ranges touching the live window key on it, so every
                # push/cut/flush invalidates them naturally. Without a
                # local ingester those ranges stay uncacheable.
                self.frontend.result_cache.live_gen = self.ingester.live_generation
            if cfg.target == "querier" and cfg.frontend_addr:
                from .worker import QuerierWorker

                self.querier_worker = QuerierWorker(
                    self.querier,
                    [a.strip() for a in cfg.frontend_addr.split(",") if a.strip()],
                    token=cfg.internal_token,
                    concurrency=cfg.worker_concurrency,
                    worker_id=cfg.instance_id,
                )

        self.compactor = self.compactor_lifecycler = None
        if has("compactor"):
            # compactors own jobs via their OWN ring (the reference's
            # compactor ring, modules/compactor/compactor.go:36-38)
            self.compactor_lifecycler = Lifecycler(self.kv, COMPACTOR_RING, cfg.instance_id)
            comp_ring = Ring(self.kv, COMPACTOR_RING)
            self.compactor = Compactor(self.db, comp_ring, cfg.instance_id,
                                       cycle_s=cfg.compaction_cycle_s)

        from .usagestats import UsageReporter

        self.usage = UsageReporter(self.db.backend, cfg.target)
        self._started = False
        self.http_server: ThreadingHTTPServer | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self.lifecycler:
            self.lifecycler.start()
        if self.compactor_lifecycler:
            self.compactor_lifecycler.start()
        if self.ingester:
            self.ingester.start_sweeper()
        if self.compactor:
            self.compactor.start()
        if self.querier_worker:
            self.querier_worker.start()
        self.overrides.start_reloader()  # hot-reload per-tenant limits
        self.db.enable_polling()
        self._started = True

    def stop(self) -> None:
        if self.distributor is not None:
            self.distributor.stop()  # drain the async generator tap
        self.overrides.stop()
        if self.querier_worker:
            self.querier_worker.stop()
        if self.compactor:
            self.compactor.stop()
        if self.ingester:
            self.ingester.stop()
        if self.frontend:
            self.frontend.stop()
        if self.querier:
            self.querier.close()
        if self.lifecycler:
            self.lifecycler.leave()
        if self.compactor_lifecycler:
            self.compactor_lifecycler.leave()
        self.db.close()
        if self.http_server:
            self.http_server.shutdown()
            self.http_server.server_close()

    def ready(self) -> bool:
        if not self._started:
            return False
        if self.ingester is not None:
            return bool(self.ring.healthy_instances())
        return True

    # ------------------------------------------------------------ tenant
    def tenant_of(self, headers) -> str:
        if not self.cfg.multitenancy:
            return DEFAULT_TENANT
        t = headers.get(TENANT_HEADER, "")
        if not t:
            raise PushError(401, f"missing {TENANT_HEADER} header")
        return t

    # ------------------------------------------------------------ http
    def _bind_host(self) -> str:
        """Explicit http_host wins; else a non-loopback advertise addr
        implies peers connect from other hosts (bind all interfaces),
        else stay loopback-only."""
        if self.cfg.http_host:
            return self.cfg.http_host
        adv = self.cfg.advertise_addr
        local = ("127.0.0.1" in adv) or ("localhost" in adv) or not adv
        return "127.0.0.1" if local else "0.0.0.0"

    def serve_http(self, port: int | None = None, background: bool = False):
        handler = _make_handler(self)
        host = self._bind_host()
        self.http_server = ThreadingHTTPServer((host, port or self.cfg.http_port), handler)
        if background:
            t = threading.Thread(target=self.http_server.serve_forever, daemon=True)
            t.start()
            return self.http_server
        self.http_server.serve_forever()


def _make_handler(app: App):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes | str, ctype="application/json",
                  headers: dict | None = None):
            if isinstance(body, str):
                body = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        @staticmethod
        def _cache_headers() -> dict:
            """X-Tempo-Cache: hit|miss|extend for the query routes."""
            from .resultcache import LAST_OUTCOME

            outcome = LAST_OUTCOME.get()
            LAST_OUTCOME.set(None)
            return {"X-Tempo-Cache": outcome} if outcome else {}

        def _err(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}))

        def _unported(self, where: str):
            self._err(501, f"{urlparse(self.path).path} is not served by the port yet ({where})")

        def _stream_json(self, events, sse: bool) -> None:
            """Write an event iterator as a chunked HTTP/1.1 response:
            SSE `data:` frames or NDJSON lines, one flush per event so
            the client sees each partial the moment its shard lands.
            The first event is pulled BEFORE the headers go out, so
            admission errors (QoS 429) still surface as real statuses."""
            import itertools

            close = getattr(events, "close", None)  # BEFORE chain rebinds
            try:
                first = next(events)
            except StopIteration:
                first = None
            else:
                events = itertools.chain([first], events)
            self.send_response(200)
            self.send_header(
                "Content-Type",
                "text/event-stream" if sse else "application/x-ndjson")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(payload: bytes) -> bytes:
                return b"%X\r\n%s\r\n" % (len(payload), payload)

            try:
                if first is not None:
                    for obj in events:
                        data = json.dumps(obj)
                        payload = (f"data: {data}\n\n"
                                   if sse else data + "\n").encode()
                        self.wfile.write(chunk(payload))
                        self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: close the generator so it
                # cancels its jobs and releases its QoS charge
                if close is not None:
                    close()
            except Exception:  # noqa: BLE001 - headers are out: end the stream cleanly
                # propagating would let do_GET write a SECOND status
                # line into the chunked body. Close the generator
                # (cancels jobs, releases QoS) and end the chunked stream
                if close is not None:
                    close()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        def _authorized_internal(self) -> bool:
            """Operational + internal endpoints: loopback peers are always
            trusted; remote peers must present the shared token."""
            if self.client_address[0] in ("127.0.0.1", "::1"):
                return True
            tok = app.cfg.internal_token
            return bool(tok) and self.headers.get("X-Tempo-Internal-Token", "") == tok

        # ----------------------------------------------------------- GET
        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                # operational endpoints never need a tenant (probes/scrapes
                # carry no X-Scope-OrgID)
                if u.path == "/api/echo":
                    return self._send(200, "echo", "text/plain")
                if u.path == "/ready":
                    ok = app.ready()
                    return self._send(200 if ok else 503, "ready" if ok else "starting",
                                      "text/plain")
                if u.path == "/metrics":
                    return self._send(
                        200, _metrics_text(app) + "# EOF\n",
                        "application/openmetrics-text; version=1.0.0; charset=utf-8",
                    )
                if u.path == "/status/config":
                    # ?mode=defaults -> the built-in config; ?mode=diff
                    # -> only fields differing from it
                    mode = q.get("mode", "")
                    if mode not in ("", "diff", "defaults"):
                        return self._err(
                            400, f"unknown mode {mode!r}; one of diff, defaults")
                    cfg_d = _config_dict(app.cfg)
                    if mode == "defaults":
                        cfg_d = _config_dict(AppConfig())
                    elif mode == "diff":
                        defaults = _config_dict(AppConfig())
                        cfg_d = {k: v for k, v in cfg_d.items()
                                 if v != defaults.get(k)}
                    return self._send(200, json.dumps(cfg_d, indent=2))
                if u.path == "/status/usage-stats":
                    return self._send(200, json.dumps(app.usage.report(app), indent=2))
                where = _unported_route(u.path)
                if where is not None:
                    return self._unported(where)
                if app.querier is None:
                    return self._err(404, f"target {app.cfg.target} serves no query API")
                tenant = app.tenant_of(self.headers)
                m = re.fullmatch(r"/api/traces/([0-9a-fA-F]+)", u.path)
                if m:
                    return self._trace_by_id(tenant, m.group(1), q)
                if u.path == "/api/search":
                    return self._search(tenant, q)
                if u.path == "/api/metrics/query_range":
                    return self._metrics_query_range(tenant, q)
                if u.path == "/api/search/tags":
                    tags = app.querier.search_tags(tenant)
                    return self._send(200, json.dumps({"tagNames": tags}))
                m = re.fullmatch(r"/api/search/tag/([^/]+)/values", u.path)
                if m:
                    vals = app.querier.search_tag_values(tenant, m.group(1))
                    return self._send(200, json.dumps({"tagValues": vals}))
                return self._err(404, f"no route {u.path}")
            except PushError as e:
                return self._err(e.status, str(e))
            except TooManyRequests as e:
                return self._err(429, str(e))
            except Exception as e:  # noqa: BLE001 - a failed request is a 500, never a dead server
                return self._err(500, f"{type(e).__name__}: {e}")

        def _trace_by_id(self, tenant: str, hex_id: str, q: dict):
            tid = parse_trace_id(hex_id)
            start = int(q.get("start", 0))
            end = int(q.get("end", 0))
            tr = app.frontend.find_trace_by_id(tenant, tid, start, end)
            hdrs = self._cache_headers()
            if tr is None:
                return self._err(404, "trace not found")
            return self._send(200, otlp_json.dumps(tr), headers=hdrs)

        def _metrics_query_range(self, tenant: str, q: dict):
            """GET /api/metrics/query_range?q=...&start=...&end=...&step=...
            -- TraceQL metrics over the backend and the live head
            (Prometheus-style matrix JSON; start/end unix seconds, step a
            Go duration or seconds). The step grid is aligned
            (metrics_exec.align_params), so any client polling cadence
            yields stable buckets."""
            from ..db.metrics_exec import align_params, parse_metrics_query, to_prometheus
            from ..traceql.ast import ParseError
            from ..traceql.parser import _parse_duration_ns

            query = q.get("q") or q.get("query", "")
            if not query:
                return self._err(400, "missing q parameter")
            try:
                parse_metrics_query(query)
            except ParseError as e:
                return self._err(400, f"invalid TraceQL metrics query: {e}")
            try:
                end = float(q["end"]) if "end" in q else time.time()
                start = float(q["start"]) if "start" in q else end - 3600.0
                if end <= start:
                    raise ValueError("end must be after start")
                sv = q.get("step", "")
                if sv:
                    try:
                        step = float(sv)
                    except ValueError:
                        step = _parse_duration_ns(sv) / 1e9
                    if step <= 0:
                        raise ValueError(f"invalid step {sv!r}")
                else:
                    # default: ~60 points over the range, 1s floor
                    step = max(1.0, round((end - start) / 60.0))
                req = align_params(query, start, end, step)
            except (ValueError, OverflowError) as e:
                return self._err(400, f"bad query_range parameter: {e}")
            try:
                resp = app.frontend.metrics_query_range(tenant, req)
            except ValueError as e:
                # execution-time request errors (e.g. by() cardinality
                # over the accumulator budget) are the caller's to fix
                return self._err(400, f"query_range failed: {e}")
            return self._send(200, json.dumps(to_prometheus(resp)),
                              headers=self._cache_headers())

        def _search(self, tenant: str, q: dict):
            tags = {}
            if "tags" in q:  # logfmt-ish k=v space separated
                for part in q["tags"].split():
                    if "=" in part:
                        k, v = part.split("=", 1)
                        tags[k] = v.strip('"')
            query = q.get("q", "")
            if query:
                # parse + type-check once at the API boundary so a bad
                # query is a 400, not a per-block failure downstream
                from ..traceql.ast import MetricsQuery, ParseError
                from ..traceql.parser import parse as parse_traceql

                try:
                    parsed = parse_traceql(query)
                except ParseError as e:
                    return self._err(400, f"invalid TraceQL: {e}")
                if isinstance(parsed, MetricsQuery):
                    return self._err(
                        400, "metrics queries (rate(), *_over_time()) belong "
                             "on /api/metrics/query_range, not /api/search")

            def dur_ms(name: str) -> int:
                """Go-style duration params ('300ms', '1m30s', '2h') per
                the reference's time.ParseDuration-based API; bare
                numbers are plain seconds."""
                v = q.get(name, "")
                if not v:
                    return 0
                try:
                    ms = int(float(v) * 1000)
                except ValueError:
                    from ..traceql.parser import _parse_duration_ns

                    ns = _parse_duration_ns(v)
                    if ns <= 0:
                        raise ValueError(f"invalid duration {name}={v!r}")
                    ms = ns // 1_000_000
                if ms <= 0:
                    # this filter API is ms-granularity; silently mapping
                    # '500us' to 0 would DROP the filter (0 = unset)
                    raise ValueError(
                        f"{name}={v!r} is below this API's 1ms granularity")
                return ms

            try:
                req = SearchRequest(
                    tags=tags,
                    query=query,
                    min_duration_ms=dur_ms("minDuration"),
                    max_duration_ms=dur_ms("maxDuration"),
                    start=int(q.get("start", 0)),
                    end=int(q.get("end", 0)),
                    limit=int(q.get("limit", 20)),
                )
            except (ValueError, OverflowError) as e:
                return self._err(400, f"bad search parameter: {e}")
            stream = q.get("stream", "").lower()
            if stream in ("true", "1", "sse"):
                # progressive delivery: newest-first partial result
                # snapshots flush as ingester/backend shards complete.
                # SSE when asked (stream=sse or an event-stream Accept
                # header), newline-delimited JSON otherwise; the final
                # event is the exact blocking-response body plus done=true
                sse = (stream == "sse"
                       or "text/event-stream" in self.headers.get("Accept", ""))
                return self._stream_json(
                    app.frontend.search_stream(tenant, req), sse)
            resp = app.frontend.search(tenant, req)
            return self._send(
                200,
                json.dumps(
                    {
                        "traces": [t.to_dict() for t in resp.traces],
                        "metrics": {
                            "inspectedBytes": str(resp.inspected_bytes),
                            "inspectedSpans": str(resp.inspected_spans),
                        },
                    }
                ),
                headers=self._cache_headers(),
            )

        # ---------------------------------------------------------- POST
        def do_POST(self):
            u = urlparse(self.path)
            ln = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(ln) if ln else b""
            try:
                if u.path in ("/internal/jobs/poll", "/internal/jobs/result"):
                    # remote querier pull (services/worker.py) against
                    # this frontend
                    if not self._authorized_internal():
                        return self._err(401, "missing or wrong internal token")
                    if app.frontend is None:
                        return self._err(404, f"target {app.cfg.target} hosts no frontend")
                    payload = json.loads(body or b"{}")
                    if u.path == "/internal/jobs/poll":
                        job = app.frontend.poll_job(
                            wait_s=float(payload.get("wait_s", 5.0)),
                            worker_id=payload.get("worker_id", ""))
                        return self._send(200, json.dumps(job or {}))
                    app.frontend.complete_job(
                        payload.get("id", ""), bool(payload.get("ok")),
                        result=payload.get("result"), error=payload.get("error", ""),
                        retryable=bool(payload.get("retryable")),
                        skipped=bool(payload.get("skipped")))
                    return self._send(200, "{}")
                if u.path == "/v1/traces":  # OTLP HTTP ingest
                    if app.distributor is None:
                        return self._err(404, f"target {app.cfg.target} does not ingest")
                    tenant = app.tenant_of(self.headers)
                    ctype = self.headers.get("Content-Type", "")
                    if "json" in ctype:
                        tr = otlp_json.loads(body)
                        app.distributor.push(tenant, tr.resource_spans)
                    else:
                        # proto bodies take the raw path (400 if undecodable)
                        app.distributor.push_raw(tenant, body)
                    return self._send(200, "{}")
                if u.path == "/flush":
                    if not self._authorized_internal():
                        return self._err(401, "missing or wrong internal token")
                    if app.ingester:
                        app.ingester.flush_all()
                    return self._send(204, "")
                if u.path == "/shutdown":
                    if not self._authorized_internal():
                        return self._err(401, "missing or wrong internal token")
                    if app.ingester:
                        app.ingester.flush_all()
                    threading.Thread(target=app.stop, daemon=True).start()
                    return self._send(204, "")
                where = _unported_route(u.path)
                if where is not None:
                    return self._unported(where)
                return self._err(404, f"no route {u.path}")
            except PushError as e:
                return self._err(e.status, str(e))
            except Exception as e:  # noqa: BLE001 - a failed request is a 500, never a dead server
                return self._err(500, f"{type(e).__name__}: {e}")

    return Handler


# point-in-time gauges, set at scrape (the reference's promauto GaugeFunc)
_BLOCKLIST_GAUGE = Gauge("tempo_blocklist_length",
                         help="blocks across all tenants in the blocklist")
_QUEUE_DEPTH_GAUGE = Gauge(
    "tempo_query_queue_depth",
    help="queued query jobs per tenant (the querier-pool autoscaling "
         "SLI: sustained depth means too few queriers for the load)")

# family -> help for the OpenMetrics renderer (families not listed get a
# generated default; TYPE is inferred from the suffix conventions)
_METRIC_HELP = {
    "tempo_distributor_spans_received": "spans accepted by the distributor",
    "tempo_distributor_push_failures": "ingester write failures (data loss)",
    "tempo_frontend_query_duration_seconds": "frontend query latency by op",
    "tempo_frontend_queries": "frontend queries by op and outcome",
    "tempo_frontend_jobs_failed": "frontend jobs that ended with an error, by kind",
    "tempo_query_queue_depth":
        "queued query jobs per tenant (querier-pool autoscaling SLI)",
}


def _frontend_lines(fe: Frontend) -> list[str]:
    """The frontend's stats counters as samples (the JAX package exports
    them through its kernel telemetry)."""
    with fe._stats_lock:
        st = copy.deepcopy(fe.stats)
    lines = [f'tempo_frontend_queries_total{{op="{op}",outcome="{oc}"}} {n}'
             for op, by in st["queries"].items() for oc, n in by.items()]
    lines += [f'tempo_frontend_query_shed_total{{tenant="{escape_label(t)}",budget="{b}"}} {n}'
              for t, by in st["shed"].items() for b, n in by.items()]
    for name, label in (("retries", "outcome"), ("hedges", "outcome"),
                        ("placements", "placement"), ("jobs_failed", "kind")):
        lines += [f'tempo_frontend_{name}_total{{{label}="{k}"}} {n}'
                  for k, n in st[name].items()]
    rc = fe.result_cache
    if rc is not None:
        s = rc.stats()
        lines += [f"tempo_result_cache_{k}_total {s[k]}"
                  for k in ("hits", "misses", "extensions", "invalidations")]
        lines.append(f"tempo_result_cache_bytes {s['bytes']}")
    return lines


def _metrics_text(app: App) -> str:
    from ..util import breaker

    lines = []
    if app.distributor:
        d = app.distributor.stats
        lines += [
            f"tempo_distributor_spans_received_total {d.spans_received}",
            f"tempo_distributor_bytes_received_total {d.bytes_received}",
            f"tempo_distributor_push_failures_total {d.push_failures}",
            f"tempo_distributor_spans_refused_rate_total {d.spans_refused_rate}",
            f"tempo_distributor_traces_refused_size_total {d.traces_refused_size}",
            f"tempo_distributor_gen_tap_dropped_total {d.gen_tap_dropped}",
            f"tempo_distributor_gen_tap_errors_total {d.gen_tap_errors}",
        ]
    if app.ingester:
        insts = list(app.ingester.instances.values())
        lines += [
            f"tempo_ingester_blocks_flushed_total {sum(i.blocks_flushed for i in insts)}",
            f"tempo_ingester_flush_failures_total {sum(i.flush_failures for i in insts)}",
            f"tempo_ingester_live_traces {sum(len(i.live) for i in insts)}",
        ]
    if app.querier is not None:
        q = app.querier.stats
        lines += [
            f"tempo_querier_searches_total {q.searches}",
            f"tempo_querier_traces_found_total {q.traces_found}",
            f"tempo_querier_metrics_queries_total {q.metrics_queries}",
            f"tempo_querier_external_searches_total {q.external_searches}",
            f"tempo_querier_external_failures_total {q.external_failures}",
        ]
    if app.compactor:
        c = app.compactor.stats
        lines += [
            f"tempo_compactor_runs_total {c.runs}",
            f"tempo_compactor_blocks_compacted_total {c.blocks_compacted}",
            f"tempo_compactor_blocks_retained_total {c.blocks_retained}",
            f"tempo_compactor_errors_total {len(c.errors)}",
        ]
    lines.append(f"tempo_blocklist_poll_errors_total {app.db.poll_errors}")
    _BLOCKLIST_GAUGE.set(
        sum(len(app.db.blocklist.metas(t)) for t in app.db.blocklist.tenants()))
    lines += _BLOCKLIST_GAUGE.text()
    if app.querier_worker:
        w = app.querier_worker
        lines += [
            f"tempo_querier_worker_jobs_executed_total {w.jobs_executed}",
            f"tempo_querier_worker_jobs_failed_total {w.jobs_failed}",
            f"tempo_querier_worker_jobs_skipped_total {w.jobs_skipped}",
        ]
    if app.frontend:
        lines += app.frontend.query_latency.text()
        lines += [
            f"tempo_frontend_jobs_local_total {app.frontend.stats_jobs_local}",
            f"tempo_frontend_jobs_remote_total {app.frontend.stats_jobs_remote}",
        ]
        lines += _frontend_lines(app.frontend)
        # per-tenant queue depth, zeroing tenants that drained since the
        # last scrape so the gauge never freezes on a stale depth
        depths = app.frontend.queue.depths()
        _QUEUE_DEPTH_GAUGE.set(sum(depths.values()))
        stale = getattr(app, "_queue_depth_tenants", set()) - set(depths)
        for t in stale:
            _QUEUE_DEPTH_GAUGE.set(0, labels=f'tenant="{escape_label(t)}"')
        for t, n in depths.items():
            _QUEUE_DEPTH_GAUGE.set(n, labels=f'tenant="{escape_label(t)}"')
        app._queue_depth_tenants = set(depths) | stale
        lines += _QUEUE_DEPTH_GAUGE.text()
    lines += breaker.metrics_lines()
    if app.generator is not None:
        lines.extend(app.generator.metrics_text())
    helps = dict(_METRIC_HELP)
    helps.update(breaker.help_entries())
    return render_openmetrics(lines, helps=helps)


def _config_dict(cfg: AppConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["device"] = None if cfg.device is None else str(cfg.device)
    return d


def load_config_file(path: str, expand_env: bool = False) -> dict:
    """YAML config root. Precedence: YAML supplies the base, explicitly
    set command-line flags override it. Keys mirror AppConfig fields;
    unknown keys are rejected so typos fail loudly like the reference's
    strict YAML. expand_env substitutes ${VAR} / ${VAR:-default}
    references BEFORE parsing (the reference's --config.expand-env,
    cmd/tempo/main.go envsubst). Names follow the shell grammar
    [A-Za-z_]\\w* (anything else passes through verbatim), and `$$`
    escapes a literal dollar -- envsubst behavior."""
    import yaml

    with open(path) as f:
        text = f.read()
    if expand_env:
        def sub(m):
            if m.group(0) == "$$":
                return "$"  # envsubst escape: $${FOO} stays the literal ${FOO}
            name, has_def, default = m.group(1).partition(":-")
            val = os.environ.get(name)
            if has_def:
                # shell ':-' semantics: default applies when unset OR empty
                return val if val else default
            if val is None:
                raise ValueError(
                    f"config references ${{{name}}} but it is not set "
                    f"(use ${{{name}:-default}} for an optional value)")
            return val

        # one alternation pass: the $$ alternative consumes its dollars
        # BEFORE the ${...} branch can see them
        text = re.sub(r"\$\$|\$\{([A-Za-z_]\w*(?::-[^}]*)?)\}", sub, text)
    data = yaml.safe_load(text) or {}
    valid = {f.name for f in dataclasses.fields(AppConfig)}
    unknown = set(data) - valid - {"ingester"}
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    if "ingester" in data:
        data["ingester"] = IngesterConfig(**(data["ingester"] or {}))
    return data


# flag -> AppConfig field, for the flags whose module the port has; the
# JAX package's other flags (receivers, gossip, chaos, self-tracing, the
# compile plane) are refused by AppConfig's check when set in a file
_FLAGS = (
    ("--target", "target", str),
    ("--http.port", "http_port", int),
    ("--storage.path", "storage_path", str),
    ("--overrides.path", "overrides_path", str),
    ("--advertise.addr", "advertise_addr", str),
    ("--instance.id", "instance_id", str),
    ("--internal.token", "internal_token", str),
    ("--querier.frontend-address", "frontend_addr", str),
    ("--querier.search-external-endpoints", "search_external_endpoints", str),
    ("--ring.heartbeat-timeout", "ring_heartbeat_timeout", float),
    ("--querier.worker-concurrency", "worker_concurrency", int),
    ("--device", "device", str),
)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tempo-tpu-torch")
    # None defaults = "flag not given"; a flag the user set ALWAYS overrides
    # the config file, even when set to the built-in default value
    ap.add_argument("--config.file", dest="config_file", default="")
    ap.add_argument("--config.expand-env", dest="config_expand_env",
                    action="store_true",
                    help="substitute ${VAR} / ${VAR:-default} in the config file")
    ap.add_argument("--multitenancy", action="store_const", const=True, default=None)
    for flag, dest, typ in _FLAGS:
        ap.add_argument(flag, dest=dest, type=typ, default=None)
    args = ap.parse_args(argv)
    base = (load_config_file(args.config_file, args.config_expand_env)
            if args.config_file else {})
    flag_vals = {dest: getattr(args, dest) for _, dest, _ in _FLAGS}
    flag_vals["multitenancy"] = args.multitenancy
    base.update({k: v for k, v in flag_vals.items() if v is not None})
    cfg = AppConfig(**base)
    if not cfg.advertise_addr:
        cfg.advertise_addr = f"http://127.0.0.1:{cfg.http_port}"
    app = App(cfg)
    app.start()
    print(f"tempo-tpu-torch target={cfg.target} device={app.device} "
          f"listening on :{cfg.http_port}", flush=True)
    try:
        app.serve_http()
    except KeyboardInterrupt:
        app.stop()


if __name__ == "__main__":
    main()
