"""Metrics-generator: span-metrics and service-graph series over an
active-series registry (port of tempo_tpu/services/generator.py).

Reference: modules/generator -- spanmetrics (spanmetrics.go:79-96: RED
counters/histograms per (service, span_name, kind, status)),
servicegraphs (servicegraphs.go:62-80: client/server span pairing via
an expiring edge store), registry with staleness + max-active-series
(registry/registry.go).

Two generations, as in the JAX package. The legacy processors
(SpanMetricsProcessor / ServiceGraphsProcessor) walk decoded Trace
objects and fold buffered columns per collection cycle; they stay as
the differential oracle and the decoded-trace entry point. The
STREAMING processors ride the write path: the distributor's tap hands
over ColumnarIngest SpanColumns (coded inside the one proto decode the
ingest plane performs), series keys assemble by packed-code hashing
against the never-remapping LiveDict, and every push window folds at
once through B8a / B8b (ops/reduce.py) on the generator's device, so a
scrape does no aggregation. Every processor runs its folds on the
device it is given: the first card unless the caller names the CPU.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from ..ingest.columnar import LiveDict, SpanColumns, span_columns_from_trace
from ..ops.device import resolve_device
from ..ops.reduce import edge_metrics_reduce, span_metrics_reduce
from ..wire.model import SpanKind, StatusCode, Trace

# seconds histogram buckets (reference spanmetrics defaults)
LATENCY_BUCKETS = (0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128, 0.256,
                   0.512, 1.024, 2.048, 4.096, 8.192, 16.384)


@dataclass
class SeriesKey:
    service: str
    span_name: str
    kind: int
    status: int

    def labels(self) -> str:
        return (
            f'service="{self.service}",span_name="{self.span_name}",'
            f'span_kind="{SpanKind(self.kind).name}",status_code="{StatusCode(self.status).name}"'
        )


class SpanMetricsProcessor:
    """Buffers spans as columns; B8a folds them into per-series counts,
    sums and bucket increments on collect()."""

    def __init__(self, max_active_series: int = 0, device=None):
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.keys: dict[tuple, int] = {}  # series key -> sid
        self.key_list: list[SeriesKey] = []
        self.free_sids: list[int] = []  # evicted slots, reused on new series
        self.max_active_series = max_active_series
        self.dropped_series = 0
        # pending span columns
        self._sid: list[int] = []
        self._dur_s: list[float] = []
        # exemplars: last observed (trace_id hex, duration s) per series
        self.exemplars: dict[int, tuple[str, float]] = {}
        # aggregated state
        self.calls = np.zeros(0, dtype=np.int64)
        self.lat_sum = np.zeros(0, dtype=np.float64)
        self.lat_count = np.zeros(0, dtype=np.int64)
        self.lat_buckets = np.zeros((0, len(LATENCY_BUCKETS) + 1), dtype=np.int64)
        self.last_update: dict[int, float] = {}

    def push(self, tenant_unused: str, traces: list[Trace]) -> None:
        with self.lock:
            for tr in traces:
                for res, _, sp in tr.all_spans():
                    k = (res.service_name, sp.name, int(sp.kind), int(sp.status_code))
                    sid = self.keys.get(k)
                    if sid is None:
                        active = len(self.key_list) - len(self.free_sids)
                        if self.max_active_series and active >= self.max_active_series:
                            self.dropped_series += 1
                            continue
                        if self.free_sids:  # reuse an evicted slot
                            sid = self.free_sids.pop()
                            self.key_list[sid] = SeriesKey(*k)
                            self.keys[k] = sid
                        else:
                            sid = self.keys[k] = len(self.key_list)
                            self.key_list.append(SeriesKey(*k))
                    dur_s = max(0, sp.duration_nanos) / 1e9
                    self._sid.append(sid)
                    self._dur_s.append(dur_s)
                    self.last_update[sid] = time.time()
                    if sp.trace_id:
                        self.exemplars[sid] = (sp.trace_id.hex(), dur_s)

    def collect(self) -> None:
        """Fold pending spans into series state with B8a."""
        with self.lock:
            if not self._sid:
                return
            sid = np.asarray(self._sid, dtype=np.int32)
            dur = np.asarray(self._dur_s, dtype=np.float32)
            self._sid, self._dur_s = [], []
            n_series = len(self.key_list)
        calls, lsum, buckets = span_metrics_reduce(sid, dur, n_series, LATENCY_BUCKETS,
                                                   self.device)
        with self.lock:
            self._apply_fold_locked(n_series, calls, lsum, buckets)

    def _apply_fold_locked(self, n_series: int, calls, lsum, buckets) -> None:
        """Accumulate one fold's per-series outputs into the registry
        state (caller holds self.lock). Shared by the legacy collect()
        cycle and the streaming per-window path."""
        if len(self.calls) < n_series:
            pad = n_series - len(self.calls)
            self.calls = np.concatenate([self.calls, np.zeros(pad, np.int64)])
            self.lat_sum = np.concatenate([self.lat_sum, np.zeros(pad, np.float64)])
            self.lat_count = np.concatenate([self.lat_count, np.zeros(pad, np.int64)])
            self.lat_buckets = np.concatenate(
                [self.lat_buckets, np.zeros((pad, self.lat_buckets.shape[1]), np.int64)]
            )
        self.calls[:n_series] += calls[:n_series]
        self.lat_sum[:n_series] += lsum[:n_series]
        self.lat_count[:n_series] += calls[:n_series]
        self.lat_buckets[:n_series] += buckets[:n_series]

    def evict_stale(self, max_idle_s: float, now: float | None = None) -> int:
        """Staleness eviction (registry.go): series with no updates for
        max_idle_s stop being exported; their key slots are freed for
        reuse so long-running processes don't grow without bound."""
        now = now or time.time()
        with self.lock:
            stale = [s for s, ts in self.last_update.items() if now - ts > max_idle_s]
            for s in stale:
                del self.last_update[s]
                key = self.key_list[s]
                self.keys.pop((key.service, key.span_name, key.kind, key.status), None)
                # zero the counter rows so a reused slot starts fresh,
                # then free the sid for the next new series
                self.exemplars.pop(s, None)
                if s < len(self.calls):
                    self.calls[s] = 0
                    self.lat_sum[s] = 0.0
                    self.lat_count[s] = 0
                    self.lat_buckets[s, :] = 0
                self.free_sids.append(s)
            return len(stale)

    def metrics_text(self) -> list[str]:
        self.collect()
        out = []
        with self.lock:
            for sid, key in enumerate(self.key_list):
                if sid >= len(self.calls) or self.calls[sid] == 0:
                    continue
                if sid not in self.last_update:
                    continue  # evicted as stale
                lab = key.labels()
                out.append(f"traces_spanmetrics_calls_total{{{lab}}} {int(self.calls[sid])}")
                out.append(
                    f"traces_spanmetrics_latency_sum{{{lab}}} {self.lat_sum[sid]:.6f}"
                )
                out.append(
                    f"traces_spanmetrics_latency_count{{{lab}}} {int(self.lat_count[sid])}"
                )
                ex = self.exemplars.get(sid)
                cum = 0
                for bi, edge in enumerate(LATENCY_BUCKETS):
                    cum += int(self.lat_buckets[sid, bi])
                    line = f'traces_spanmetrics_latency_bucket{{{lab},le="{edge}"}} {cum}'
                    if ex is not None and ex[1] <= edge and (bi == 0 or ex[1] > LATENCY_BUCKETS[bi - 1]):
                        # OpenMetrics exemplar: the trace behind this bucket
                        line += f' # {{trace_id="{ex[0]}"}} {ex[1]:.6f}'
                    out.append(line)
                cum += int(self.lat_buckets[sid, -1])
                line = f'traces_spanmetrics_latency_bucket{{{lab},le="+Inf"}} {cum}'
                if ex is not None and ex[1] > LATENCY_BUCKETS[-1]:
                    line += f' # {{trace_id="{ex[0]}"}} {ex[1]:.6f}'
                out.append(line)
        return out


@dataclass
class _Edge:
    client_service: str = ""
    server_service: str = ""
    client_dur_s: float = 0.0
    server_dur_s: float = 0.0
    failed: bool = False
    t: float = 0.0


class ServiceGraphsProcessor:
    """Pairs client/server spans by (trace_id, span_id/parent_id) through
    an expiring edge store (servicegraphs store/store.go), emitting the
    reference's edge series (servicegraphs.go:62-80): request counts,
    failed counts, and client/server latency histograms. Completed edges
    buffer as columns and fold on collect() with two B8a launches (one
    per side) and a host bincount of the failed flags."""

    def __init__(self, wait_s: float = 10.0, max_items: int = 10_000, device=None):
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.wait_s = wait_s
        self.max_items = max_items
        self.pending: dict = {}
        self.edge_ids: dict[tuple[str, str], int] = {}
        self.edge_list: list[tuple[str, str]] = []
        self.expired = 0
        # pending completed-edge columns
        self._eid: list[int] = []
        self._client_dur: list[float] = []
        self._server_dur: list[float] = []
        self._failed: list[bool] = []
        # aggregated state, per edge id
        self.counts = np.zeros(0, dtype=np.int64)
        self.failed_counts = np.zeros(0, dtype=np.int64)
        self.client_sum = np.zeros(0, dtype=np.float64)
        self.server_sum = np.zeros(0, dtype=np.float64)
        self.client_buckets = np.zeros((0, len(LATENCY_BUCKETS) + 1), dtype=np.int64)
        self.server_buckets = np.zeros((0, len(LATENCY_BUCKETS) + 1), dtype=np.int64)

    def _complete_locked(self, pair: tuple[str, str], cdur: float, sdur: float,
                         failed: bool) -> None:
        eid = self.edge_ids.get(pair)
        if eid is None:
            eid = self.edge_ids[pair] = len(self.edge_list)
            self.edge_list.append(pair)
        self._eid.append(eid)
        self._client_dur.append(cdur)
        self._server_dur.append(sdur)
        self._failed.append(failed)

    def push(self, tenant_unused: str, traces: list[Trace]) -> None:
        now = time.time()
        with self.lock:
            for tr in traces:
                for res, _, sp in tr.all_spans():
                    failed = int(sp.status_code) == 2
                    dur_s = max(0, sp.duration_nanos) / 1e9
                    if sp.kind == SpanKind.CLIENT:
                        key = (sp.trace_id, sp.span_id)
                        e = self.pending.setdefault(key, _Edge(t=now))
                        e.client_service = res.service_name
                        e.client_dur_s = dur_s
                        e.failed = e.failed or failed
                    elif sp.kind == SpanKind.SERVER:
                        key = (sp.trace_id, sp.parent_span_id)
                        e = self.pending.setdefault(key, _Edge(t=now))
                        e.server_service = res.service_name
                        e.server_dur_s = dur_s
                        e.failed = e.failed or failed
                    else:
                        continue
                    if e.client_service and e.server_service:
                        self._complete_locked((e.client_service, e.server_service),
                                              e.client_dur_s, e.server_dur_s, e.failed)
                        del self.pending[key]
            self._expire(now)

    def _expire(self, now: float) -> None:
        if len(self.pending) > self.max_items:
            cutoff = now - self.wait_s
            for k in [k for k, e in self.pending.items() if e.t < cutoff]:
                del self.pending[k]
                self.expired += 1

    def _take_completed_locked(self):
        """The buffered completed-edge columns, emptied (caller holds
        self.lock)."""
        cols = (np.asarray(self._eid, dtype=np.int32),
                np.asarray(self._client_dur, dtype=np.float32),
                np.asarray(self._server_dur, dtype=np.float32),
                np.asarray(self._failed, dtype=bool))
        self._eid, self._client_dur, self._server_dur, self._failed = [], [], [], []
        return cols, len(self.edge_list)

    def collect(self) -> None:
        """Fold pending completed edges into per-edge series with B8a
        per side, as the span-metrics processor folds spans."""
        with self.lock:
            if not self._eid:
                return
            (eid, cdur, sdur, failed), n_edges = self._take_completed_locked()
        ccalls, csum, cbuckets = span_metrics_reduce(eid, cdur, n_edges, LATENCY_BUCKETS,
                                                     self.device)
        _, ssum, sbuckets = span_metrics_reduce(eid, sdur, n_edges, LATENCY_BUCKETS,
                                                self.device)
        fcounts = np.bincount(eid[failed], minlength=n_edges).astype(np.int64)
        with self.lock:
            self._apply_fold_locked(n_edges, ccalls, fcounts, csum, ssum,
                                    cbuckets, sbuckets)

    def _apply_fold_locked(self, n_edges: int, counts, fcounts, csum, ssum,
                           cbuckets, sbuckets) -> None:
        """Accumulate one fold's per-edge outputs (caller holds
        self.lock). Shared by legacy collect() and the streaming fused
        edge reduce."""
        if len(self.counts) < n_edges:
            pad = n_edges - len(self.counts)
            zb = np.zeros((pad, self.client_buckets.shape[1]), np.int64)
            self.counts = np.concatenate([self.counts, np.zeros(pad, np.int64)])
            self.failed_counts = np.concatenate([self.failed_counts, np.zeros(pad, np.int64)])
            self.client_sum = np.concatenate([self.client_sum, np.zeros(pad, np.float64)])
            self.server_sum = np.concatenate([self.server_sum, np.zeros(pad, np.float64)])
            self.client_buckets = np.concatenate([self.client_buckets, zb])
            self.server_buckets = np.concatenate([self.server_buckets, zb.copy()])
        self.counts[:n_edges] += counts[:n_edges]
        self.failed_counts[:n_edges] += fcounts[:n_edges]
        self.client_sum[:n_edges] += csum[:n_edges]
        self.server_sum[:n_edges] += ssum[:n_edges]
        self.client_buckets[:n_edges] += cbuckets[:n_edges]
        self.server_buckets[:n_edges] += sbuckets[:n_edges]

    def metrics_text(self) -> list[str]:
        self.collect()
        out = []
        with self.lock:
            for eid, (c, s) in enumerate(self.edge_list):
                if eid >= len(self.counts) or self.counts[eid] == 0:
                    continue
                lab = f'client="{c}",server="{s}"'
                out.append(f"traces_service_graph_request_total{{{lab}}} {int(self.counts[eid])}")
                out.append(
                    f"traces_service_graph_request_failed_total{{{lab}}} "
                    f"{int(self.failed_counts[eid])}"
                )
                for side, total, buckets in (
                    ("client", self.client_sum, self.client_buckets),
                    ("server", self.server_sum, self.server_buckets),
                ):
                    out.append(
                        f"traces_service_graph_request_{side}_seconds_sum{{{lab}}} "
                        f"{total[eid]:.6f}"
                    )
                    out.append(
                        f"traces_service_graph_request_{side}_seconds_count{{{lab}}} "
                        f"{int(self.counts[eid])}"
                    )
                    cum = 0
                    for bi, edge in enumerate(LATENCY_BUCKETS):
                        cum += int(buckets[eid, bi])
                        out.append(
                            f'traces_service_graph_request_{side}_seconds_bucket'
                            f'{{{lab},le="{edge}"}} {cum}'
                        )
                    cum += int(buckets[eid, -1])
                    out.append(
                        f'traces_service_graph_request_{side}_seconds_bucket'
                        f'{{{lab},le="+Inf"}} {cum}'
                    )
        return out


class StreamingSpanMetrics(SpanMetricsProcessor):
    """Streaming variant fed by the write-path tap: consumes
    ColumnarIngest SpanColumns and folds each push window through B8a at
    once. Series keys assemble as packed-code hashing -- one int64 per
    span, np.unique over the window -- so Python runs only per UNIQUE NEW
    key; registry state, eviction and exposition are the parent's, which
    makes the streaming-vs-legacy differential like for like."""

    # packed series key layout: (svc_code << 34) | (name_code << 6) |
    # (kind << 3) | status. kind <= 5 and status <= 2 fit 3 bits each;
    # name gets 28 bits and svc 30 -- far above the live window's
    # dictionary cardinality
    _SVC_SHIFT = 34
    _NAME_SHIFT = 6
    _NAME_MASK = (1 << 28) - 1

    def __init__(self, max_active_series: int = 0, device=None):
        super().__init__(max_active_series, device)
        # per-source-dict packed-key -> sid cache: codes mean something
        # only against the LiveDict that assigned them, so the cache is
        # keyed by the dict object
        self._packed_sids: dict[object, dict[int, int]] = {}

    def push_columns(self, parts: list[SpanColumns], ldict: LiveDict,
                     now: float | None = None) -> int:
        """Fold one push window of coded span columns. Returns the span
        count folded (after series-limit shedding)."""
        parts = [p for p in parts if len(p.svc_code)]
        if not parts:
            return 0
        now = time.time() if now is None else now
        svc = np.concatenate([p.svc_code for p in parts]).astype(np.int64)
        name = np.concatenate([p.name_code for p in parts]).astype(np.int64)
        kind = np.concatenate([p.kind for p in parts]).astype(np.int64)
        status = np.concatenate([p.status for p in parts]).astype(np.int64)
        dur = np.concatenate([p.dur_s for p in parts])
        segi = np.concatenate([np.full(len(p.svc_code), i, np.int32)
                               for i, p in enumerate(parts)])
        packed = ((svc << self._SVC_SHIFT) | (name << self._NAME_SHIFT)
                  | (kind << 3) | status)
        uniq, first, inv = np.unique(packed, return_index=True,
                                     return_inverse=True)
        with self.lock:
            pmap = self._packed_sids.setdefault(ldict, {})
            usid = np.empty(len(uniq), np.int32)
            # new keys resolve strings and claim sids in first-seen SPAN
            # order: the legacy per-span assignment sequence, including
            # the max-active-series shed decisions
            for ui in np.argsort(first, kind="stable").tolist():
                pk = int(uniq[ui])
                s = pmap.get(pk)
                if s is None:
                    k = (ldict.string(pk >> self._SVC_SHIFT),
                         ldict.string((pk >> self._NAME_SHIFT) & self._NAME_MASK),
                         (pk >> 3) & 7, pk & 7)
                    s = self.keys.get(k)
                    if s is None:
                        active = len(self.key_list) - len(self.free_sids)
                        if self.max_active_series and active >= self.max_active_series:
                            # shed: NOT cached, so capacity freed by a
                            # later eviction re-admits the key (legacy
                            # re-checks per span the same way)
                            usid[ui] = -1
                            continue
                        if self.free_sids:
                            s = self.free_sids.pop()
                            self.key_list[s] = SeriesKey(*k)
                            self.keys[k] = s
                        else:
                            s = self.keys[k] = len(self.key_list)
                            self.key_list.append(SeriesKey(*k))
                    pmap[pk] = s
                usid[ui] = s
            sid = usid[inv]
            shed = sid < 0
            nshed = int(shed.sum())
            if nshed:
                self.dropped_series += nshed
                keep = ~shed
                sid, dur, segi = sid[keep], dur[keep], segi[keep]
            if len(sid) == 0:
                return 0
            n_series = len(self.key_list)
            # staleness stamps and exemplars: the last occurrence in the
            # window per series (np.unique over the reversed array finds
            # it without a per-span Python pass)
            ridx = np.unique(sid[::-1], return_index=True)[1]
            for li in (len(sid) - 1 - ridx).tolist():
                s = int(sid[li])
                self.last_update[s] = now
                tid = parts[int(segi[li])].tid_hex
                if tid:
                    self.exemplars[s] = (tid, float(dur[li]))
        calls, lsum, buckets = span_metrics_reduce(
            sid.astype(np.int32), dur.astype(np.float32), n_series, LATENCY_BUCKETS, self.device)
        with self.lock:
            self._apply_fold_locked(n_series, calls, lsum, buckets)
        return int(len(sid))

    def evict_stale(self, max_idle_s: float, now: float | None = None) -> int:
        n = super().evict_stale(max_idle_s, now)
        if n:
            # evicted sids may be reassigned to other keys; the packed
            # caches hold raw sids, so drop them wholesale (evictions are
            # rare; each live key re-resolves once)
            with self.lock:
                for m in self._packed_sids.values():
                    m.clear()
        return n


_KIND_CLIENT = int(SpanKind.CLIENT)


@dataclass
class _CodedEdge:
    """Pending edge in the coded store: service CODES plus the dict that
    assigned them (resolved to strings only at completion)."""

    t: float = 0.0
    cdict: LiveDict | None = None
    sdict: LiveDict | None = None
    csvc: int = 0  # 0 = unset (LiveDict codes "" as 0; legacy treats
    ssvc: int = 0  # an empty service name as not-set the same way)
    cdur: float = 0.0
    sdur: float = 0.0
    failed: bool = False


class StreamingServiceGraphs(ServiceGraphsProcessor):
    """Coded edge store: client/server spans pair on the uint64
    (trace-id, span-id/parent-id) hash computed inside the write-path
    decode (ingest/columnar.edge_key_client), so matching is one dict
    probe on an int. Completed edges fold per push window through ONE
    B8b pass instead of the legacy two B8a launches and a host bincount."""

    def push_columns(self, parts: list[SpanColumns], ldict: LiveDict,
                     now: float | None = None) -> int:
        """Pair one window's edge-role spans and fold the completed
        edges. Returns the number of edges completed this window."""
        now = time.time() if now is None else now
        with self.lock:
            for p in parts:
                idxs = np.flatnonzero(p.edge_key)
                if len(idxs) == 0:
                    continue
                ek, kinds = p.edge_key, p.kind
                status, durs, svcs = p.status, p.dur_s, p.svc_code
                for i in idxs.tolist():
                    key = int(ek[i])
                    e = self.pending.get(key)
                    if e is None:
                        e = self.pending[key] = _CodedEdge(t=now)
                    d = float(durs[i])
                    if int(kinds[i]) == _KIND_CLIENT:
                        e.cdict, e.csvc, e.cdur = ldict, int(svcs[i]), d
                    else:
                        e.sdict, e.ssvc, e.sdur = ldict, int(svcs[i]), d
                    e.failed = e.failed or int(status[i]) == 2
                    if e.csvc and e.ssvc:
                        self._complete_locked((e.cdict.string(e.csvc), e.sdict.string(e.ssvc)),
                                              e.cdur, e.sdur, e.failed)
                        del self.pending[key]
            self._expire(now)
            if not self._eid:
                return 0
            (eid, cdur, sdur, failed), n_edges = self._take_completed_locked()
        out = edge_metrics_reduce(eid, cdur, sdur, failed.astype(np.int32), n_edges,
                                  LATENCY_BUCKETS, self.device)
        with self.lock:
            self._apply_fold_locked(n_edges, *out)
        return int(len(eid))


class MetricsGenerator:
    """Per-tenant processor sets, fed by the distributor's tap
    (modules/generator/generator.go). Two entry points: push_window (the
    streaming tap: coded columns straight from the write path's single
    decode) and push (decoded traces from direct callers), which builds
    columns on a generator-owned per-tenant LiveDict and rides the same
    streaming fold. Every fold runs on `device` (None: the first card,
    an error without one).

    `stats` counts what the JAX package records in its kernel telemetry:
    windows, spans and edges folded, the edge store's unpaired and
    expired halves, spans shed per tenant, seconds per processor stage,
    and the push -> series-visible freshness (max, sum, count)."""

    def __init__(self, overrides, processors: tuple[str, ...] = ("span-metrics", "service-graphs"),
                 stale_series_s: float = 300.0, device=None):
        self.overrides = overrides
        self.default_processors = processors
        self.stale_series_s = stale_series_s
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.tenants: dict[str, dict[str, object]] = {}
        self._dicts: dict[str, LiveDict] = {}  # push()-path dictionaries
        self._stale: dict[str, float] = {}  # per-tenant staleness window
        self.stats = {"windows": 0, "spans": 0, "edges": 0, "unpaired": 0, "expired": 0,
                      "shed": {}, "stage_s": {}, "freshness_max_s": 0.0,
                      "freshness_sum_s": 0.0, "freshness_n": 0}

    def _procs(self, tenant: str) -> dict[str, object]:
        with self.lock:
            procs = self.tenants.get(tenant)
            if procs is None:
                lim = self.overrides.for_tenant(tenant)
                enabled = lim.metrics_generator_processors or self.default_processors
                procs = {}
                if "span-metrics" in enabled:
                    procs["span-metrics"] = StreamingSpanMetrics(
                        lim.metrics_generator_max_active_series, self.device)
                if "service-graphs" in enabled:
                    procs["service-graphs"] = StreamingServiceGraphs(device=self.device)
                self.tenants[tenant] = procs
                stale = lim.metrics_generator_stale_series_s
                self._stale[tenant] = stale if stale > 0 else self.stale_series_s
            return procs

    def push(self, tenant: str, traces: list[Trace]) -> None:
        with self.lock:
            ld = self._dicts.get(tenant)
            if ld is None:
                ld = self._dicts[tenant] = LiveDict()
        cols = [span_columns_from_trace(tr, ld.code) for tr in traces]
        self.push_window(tenant, cols, ld)

    def push_window(self, tenant: str, cols: list[SpanColumns],
                    ldict: LiveDict, push_ts: float | None = None) -> None:
        """Fold one push window of coded columns for `tenant`. push_ts
        (the distributor's receive time) feeds the freshness stats; after
        this returns the window's series ARE visible to the next
        metrics_text()."""
        procs = self._procs(tenant)
        now = time.time()
        sm = procs.get("span-metrics")
        sg = procs.get("service-graphs")
        shed0 = sm.dropped_series if sm is not None else 0
        edges = spans = 0
        stage_s = {}
        for pname, p in procs.items():
            t0 = time.perf_counter()
            r = p.push_columns(cols, ldict, now)
            stage_s[pname] = time.perf_counter() - t0
            if p is sg:
                edges = r
            else:
                spans = r
        fresh = time.time() - push_ts if push_ts is not None else None
        with self.lock:
            st = self.stats
            st["windows"] += 1
            st["spans"] += spans
            st["edges"] += edges
            if sg is not None:
                st["unpaired"], st["expired"] = len(sg.pending), sg.expired
            for pname, s in stage_s.items():
                st["stage_s"][pname] = st["stage_s"].get(pname, 0.0) + s
            if sm is not None and sm.dropped_series > shed0:
                st["shed"][tenant] = st["shed"].get(tenant, 0) + sm.dropped_series - shed0
            if fresh is not None:
                st["freshness_max_s"] = max(st["freshness_max_s"], fresh)
                st["freshness_sum_s"] += fresh
                st["freshness_n"] += 1

    def metrics_text(self) -> list[str]:
        out = []
        with self.lock:
            items = list(self.tenants.items())
            stale = dict(self._stale)
        for tenant, procs in items:
            for p in procs.values():
                if isinstance(p, SpanMetricsProcessor):
                    p.evict_stale(stale.get(tenant, self.stale_series_s))
                out.extend(p.metrics_text())
        return out
