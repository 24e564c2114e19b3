"""Tier A of the cache plane: the frontend query-result cache (port of
tempo_tpu/services/resultcache.py).

Dashboard read traffic is dominated by repeats of the same
search/metrics/by-id queries; the reference wraps its backend in
memcached/redis for blooms and pages (tempodb/backend/cache). Here the
cache sits one layer higher -- at the frontend, AHEAD of queue
admission -- so a hit costs microseconds of host work and never touches
QoS budgets, the queue, or a device.

Keys and invalidation: every entry is keyed on (tenant, the normalized
query identity, the exact time range) and carries the generation pair
it was computed under -- the tenant's blocklist generation
(db/blocklist bumps on flush/compaction/poll drift) plus, for ranges
that touch the live head, the ingester's live-head generation (bumps on
every push/cut/flush). A generation change counts as an invalidation
and replaces the entry, so corpus mutations invalidate naturally. A
range "touches the live head" when it ends within
TEMPO_RESULT_CACHE_LIVE_WINDOW_S of now (or is unbounded); spans
arriving LATER than that window into an older range are invisible to
the generation pair, so TEMPO_RESULT_CACHE_TTL_S bounds that staleness.

Incremental extension (the big win for moving now-edge dashboards): a
search/metrics response over [s, e] also stores its *immutable prefix*
-- results up to cut = now - live_window, which the live head can no
longer change under an unchanged blocklist generation. A later request
[s', e'] with s <= s' < cut re-executes only the tail [cut, e'] and
merges: a 1h range refreshed every 10s re-executes seconds of data,
not the hour. Extension stays in the under-limit regime (a truncated
result set is not a complete prefix); the search time filter is
trace-start within [start, end] (db/search._verify_candidates), so
splitting at `cut` partitions exactly.

Kill switch: TEMPO_RESULT_CACHE=0 makes the frontend skip construction
entirely -- the query path is byte-identical to a build without this
module.

The JAX package also reports hits, misses, extensions, invalidations and
bytes to its kernel telemetry, with a self-trace span a hit; the port
has neither plane yet (ROADMAP §A item 9), and ResultCache.stats() keeps
those counters.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ..util import knobs as _cfg
from ..db.search import (
    SearchRequest,
    SearchResponse,
    response_from_dict,
    response_to_dict,
)

# the per-request cache decision, for the HTTP layer's X-Tempo-Cache
# response header (soak/vulture classify hits client-side from it):
# "hit" | "miss" | "extend" | None (cache off / route not cacheable)
LAST_OUTCOME: contextvars.ContextVar = contextvars.ContextVar(
    "result_cache_outcome", default=None)


@dataclass
class SearchExtension:
    """A probe result saying: execute `tail_req` (the only slice the
    cached prefix cannot answer) and hand the partial response to
    ResultCache.complete_search_extension."""

    tenant: str
    req: SearchRequest
    tail_req: SearchRequest
    cut: int  # unix seconds; prefix covers trace starts in [req.start, cut)
    prefix_traces: list = field(default_factory=list)  # wire dicts


@dataclass
class MetricsExtension:
    tenant: str
    req: object  # MetricsRequest
    tail_req: object
    cut_ms: int
    prefix: dict = field(default_factory=dict)  # MetricsResponse wire dict


class ResultCache:
    """Bounded-byte LRU over serialized query results + immutable
    prefixes. One lock, microsecond operations only -- nothing in here
    does IO or touches a device."""

    def __init__(self, blocklist_gen, live_gen=None):
        self._lock = threading.Lock()
        self._store: OrderedDict[tuple, dict] = OrderedDict()
        self._bytes = 0
        self.blocklist_gen = blocklist_gen  # tenant -> int
        # tenant -> int | None; None = no local live-head view, so
        # live-touching ranges are uncacheable (extension still works:
        # the prefix depends only on the blocklist generation)
        self.live_gen = live_gen or (lambda tenant: None)
        self.max_bytes = _cfg.get_int("TEMPO_RESULT_CACHE_MAX_BYTES")
        self.ttl_s = _cfg.get_float("TEMPO_RESULT_CACHE_TTL_S")
        self.live_window_s = _cfg.get_float("TEMPO_RESULT_CACHE_LIVE_WINDOW_S")
        self.extend_enabled = _cfg.get_bool("TEMPO_RESULT_CACHE_EXTEND")
        self.stats_hits = 0
        self.stats_misses = 0
        self.stats_extensions = 0
        self.stats_invalidations = 0

    def _note(self, outcome: str) -> None:
        """Count one probe's outcome and publish it for the HTTP
        layer's X-Tempo-Cache header."""
        with self._lock:
            if outcome == "hit":
                self.stats_hits += 1
            elif outcome == "extend":
                self.stats_extensions += 1
            else:
                self.stats_misses += 1
        LAST_OUTCOME.set(outcome)

    # ------------------------------------------------------------- store
    def _get_locked(self, key: tuple, gens: tuple, now: float):
        """Entry payload for key iff fresh and generation-matched;
        drops stale entries (a generation mismatch counts as an
        invalidation, expiry does not)."""
        ent = self._store.get(key)
        if ent is None:
            return None
        if now >= ent["expires"]:
            self._evict_locked(key)
            return None
        if ent["gens"] != gens:
            self._evict_locked(key)
            self.stats_invalidations += 1
            return None
        self._store.move_to_end(key)
        return ent["payload"]

    def _put_locked(self, key: tuple, gens: tuple, payload, now: float,
                    nbytes: int | None = None, extra: dict | None = None) -> None:
        if nbytes is None:
            nbytes = len(json.dumps(payload, separators=(",", ":")).encode())
        nbytes = max(nbytes, 256)
        self._evict_locked(key)
        self._store[key] = {
            "expires": now + self.ttl_s, "gens": gens,
            "payload": payload, "nbytes": nbytes,
            **(extra or {}),
        }
        self._bytes += nbytes
        while self._bytes > self.max_bytes and self._store:
            k = next(iter(self._store))
            self._evict_locked(k)

    def _evict_locked(self, key: tuple) -> None:
        ent = self._store.pop(key, None)
        if ent is not None:
            self._bytes -= ent["nbytes"]

    # ------------------------------------------------------------ keying
    def _touches_live(self, end: float, now: float) -> bool:
        return end <= 0 or end >= now - self.live_window_s

    def _gens_for(self, tenant: str, end_s: float, now: float):
        """(gens tuple, cacheable) for a range ending at end_s (unix
        seconds; <=0 = unbounded)."""
        bl = self.blocklist_gen(tenant)
        if not self._touches_live(end_s, now):
            return ("bl", bl), True
        lv = self.live_gen(tenant)
        if lv is None:
            return None, False
        return ("bl", bl, "lv", lv), True

    @staticmethod
    def _search_qkey(tenant: str, req: SearchRequest) -> tuple:
        return ("search", tenant, req.query,
                tuple(sorted(req.tags.items())),
                req.min_duration_ms, req.max_duration_ms, req.limit)

    # ------------------------------------------------------------ search
    def probe_search(self, tenant: str, req: SearchRequest, now: float | None = None):
        """SearchResponse (exact hit) | SearchExtension (execute the
        tail, then complete_search_extension) | None (miss)."""
        now = now or time.time()
        qkey = self._search_qkey(tenant, req)
        gens, cacheable = self._gens_for(tenant, req.end, now)
        if cacheable:
            with self._lock:
                payload = self._get_locked(qkey + (req.start, req.end), gens, now)
            if payload is not None:
                self._note("hit")
                return response_from_dict(payload)
        ext = self._probe_search_extension(tenant, req, now)
        if ext is not None:
            self._note("extend")
            return ext
        self._note("miss")
        return None

    def _probe_search_extension(self, tenant: str, req: SearchRequest,
                                now: float) -> SearchExtension | None:
        if not (self.extend_enabled and req.start > 0 and req.end > 0
                and self._touches_live(req.end, now)):
            return None
        bl = self.blocklist_gen(tenant)
        pkey = ("searchx",) + self._search_qkey(tenant, req)
        with self._lock:
            p = self._get_locked(pkey, ("bl", bl), now)
            if p is None:
                return None
            prefix_start, cut, traces = p["start"], p["cut"], list(p["traces"])
        if not (prefix_start <= req.start < cut <= req.end):
            return None
        # filter the stored prefix to this request's start edge (the
        # time filter is trace-start in [start, end], so this slice is
        # exactly what a fresh execution would keep below `cut`)
        lo_ns = req.start * 1_000_000_000
        keep = [t for t in traces if int(t.get("startTimeUnixNano", "0")) >= lo_ns]
        if len(keep) >= (req.limit or 20):
            return None  # the truncation regime: extension can't be exact
        tail = SearchRequest(
            tags=dict(req.tags), query=req.query,
            min_duration_ms=req.min_duration_ms,
            max_duration_ms=req.max_duration_ms,
            start=cut, end=req.end, limit=req.limit)
        return SearchExtension(tenant=tenant, req=req, tail_req=tail,
                               cut=cut, prefix_traces=keep)

    def complete_search_extension(self, ext: SearchExtension,
                                  tail: SearchResponse,
                                  now: float | None = None) -> SearchResponse:
        """Merge the cached prefix with the freshly executed tail; store
        the advanced prefix when the merge is provably complete."""
        now = now or time.time()
        limit = ext.req.limit or 20
        merged = response_from_dict({"traces": ext.prefix_traces})
        merged.inspected_bytes = tail.inspected_bytes
        merged.inspected_spans = tail.inspected_spans
        seen = {t.trace_id for t in merged.traces}
        for t in tail.traces:
            if t.trace_id not in seen:
                merged.traces.append(t)
                seen.add(t.trace_id)
        merged.traces.sort(key=lambda r: -r.start_time_unix_nano)
        complete = len(merged.traces) < limit and len(tail.traces) < limit
        merged.traces = merged.traces[:limit]
        if complete:
            self._store_search_prefix(ext.tenant, ext.req, merged, now)
        return merged

    def store_search(self, tenant: str, req: SearchRequest,
                     resp: SearchResponse, now: float | None = None) -> None:
        now = now or time.time()
        qkey = self._search_qkey(tenant, req)
        gens, cacheable = self._gens_for(tenant, req.end, now)
        if cacheable:
            with self._lock:
                self._put_locked(qkey + (req.start, req.end), gens,
                                 response_to_dict(resp), now)
        if len(resp.traces) < (req.limit or 20):
            self._store_search_prefix(tenant, req, resp, now)

    def _store_search_prefix(self, tenant: str, req: SearchRequest,
                             resp: SearchResponse, now: float) -> None:
        """Keep the immutable part of an under-limit response as the
        extension prefix: trace starts below cut = now - live_window
        can only change via the blocklist generation."""
        if not (self.extend_enabled and req.start > 0 and req.end > 0):
            return
        cut = min(req.end, int(now - self.live_window_s))
        if cut <= req.start:
            return
        cut_ns = cut * 1_000_000_000
        traces = [
            {**t.to_dict(), "matchedSpans": t.matched_spans}
            for t in resp.traces if t.start_time_unix_nano < cut_ns
        ]
        bl = self.blocklist_gen(tenant)
        pkey = ("searchx",) + self._search_qkey(tenant, req)
        with self._lock:
            self._put_locked(
                pkey, ("bl", bl),
                {"start": req.start, "cut": cut, "traces": traces}, now)

    # ----------------------------------------------------------- by-id
    def probe_trace(self, tenant: str, hex_id: str,
                    time_start: int = 0, time_end: int = 0):
        """The cached Trace, or None on a miss (negative lookups are
        not cached: by-id results can grow from any push, so entries
        always carry both generations)."""
        now = time.time()
        gens, cacheable = self._gens_for(tenant, 0, now)  # always live-keyed
        if not cacheable:
            self._note("miss")
            return None
        key = ("trace", tenant, hex_id, time_start, time_end)
        with self._lock:
            alive = self._get_locked(key, gens, now)
            tr = self._store[key]["trace"] if alive else None
        if tr is not None:
            self._note("hit")
            return tr
        self._note("miss")
        return None

    def store_trace(self, tenant: str, hex_id: str, time_start: int,
                    time_end: int, trace, nbytes: int) -> None:
        now = time.time()
        gens, cacheable = self._gens_for(tenant, 0, now)
        if not cacheable:
            return
        key = ("trace", tenant, hex_id, time_start, time_end)
        with self._lock:
            # the Trace object rides outside any JSON payload, sized by
            # the caller's serialized response length
            self._put_locked(key, gens, True, now, nbytes=nbytes,
                             extra={"trace": trace})

    # ---------------------------------------------------------- metrics
    @staticmethod
    def _metrics_qkey(tenant: str, req) -> tuple:
        return ("metrics", tenant, req.query, req.step_ms)

    def probe_metrics(self, tenant: str, req, now: float | None = None):
        """MetricsResponse | MetricsExtension | None (miss). req is an
        aligned MetricsRequest (ms since epoch, end exclusive)."""
        from ..db.metrics_exec import response_from_dict as m_from_dict

        now = now or time.time()
        qkey = self._metrics_qkey(tenant, req)
        gens, cacheable = self._gens_for(tenant, req.end_ms / 1000.0, now)
        if cacheable:
            with self._lock:
                payload = self._get_locked(
                    qkey + (req.start_ms, req.end_ms), gens, now)
            if payload is not None:
                self._note("hit")
                return m_from_dict(payload)
        ext = self._probe_metrics_extension(tenant, req, now)
        if ext is not None:
            self._note("extend")
            return ext
        self._note("miss")
        return None

    def _probe_metrics_extension(self, tenant: str, req,
                                 now: float) -> MetricsExtension | None:
        from ..db.metrics_exec import MetricsRequest

        if not (self.extend_enabled
                and self._touches_live(req.end_ms / 1000.0, now)):
            return None
        bl = self.blocklist_gen(tenant)
        pkey = ("metricsx",) + self._metrics_qkey(tenant, req)
        with self._lock:
            p = self._get_locked(pkey, ("bl", bl), now)
            if p is None:
                return None
            p = dict(p)
        cut_ms = p["cut_ms"]
        if not (p["start_ms"] <= req.start_ms < cut_ms <= req.end_ms):
            return None
        tail = MetricsRequest(query=req.query, start_ms=cut_ms,
                              end_ms=req.end_ms, step_ms=req.step_ms)
        return MetricsExtension(tenant=tenant, req=req, tail_req=tail,
                                cut_ms=cut_ms, prefix=p["resp"])

    def complete_metrics_extension(self, ext: MetricsExtension, tail,
                                   now: float | None = None):
        """Merge the cached per-series accumulator prefix (sliced onto
        this request's bucket axis) with the tail execution -- exactly
        the shard merge the frontend's time-sharded jobs already do."""
        from ..db.metrics_exec import (
            MetricsResponse,
            response_from_dict as m_from_dict,
        )

        now = now or time.time()
        req = ext.req
        pre = m_from_dict(ext.prefix)
        nb = req.n_buckets
        resp = MetricsResponse(
            fn=pre.fn, start_ms=req.start_ms, step_ms=req.step_ms,
            n_buckets=nb, label_names=pre.label_names or tail.label_names)
        lo = (req.start_ms - pre.start_ms) // req.step_ms
        hi = (ext.cut_ms - pre.start_ms) // req.step_ms
        for labels, state in pre.series.items():
            sliced = {f: a[lo:hi] for f, a in state.items()}
            if not _state_has_data(sliced):
                continue  # a fresh run of this window would not emit it
            resp.add_partial(labels, sliced, offset=0)
        resp.merge(tail)  # also carries the tail's inspected counts
        self._store_metrics_prefix(ext.tenant, req, resp, now)
        return resp

    def store_metrics(self, tenant: str, req, resp,
                      now: float | None = None) -> None:
        from ..db.metrics_exec import response_to_dict as m_to_dict

        now = now or time.time()
        qkey = self._metrics_qkey(tenant, req)
        gens, cacheable = self._gens_for(tenant, req.end_ms / 1000.0, now)
        if cacheable:
            with self._lock:
                self._put_locked(qkey + (req.start_ms, req.end_ms), gens,
                                 m_to_dict(resp), now)
        self._store_metrics_prefix(tenant, req, resp, now)

    def _store_metrics_prefix(self, tenant: str, req, resp,
                              now: float) -> None:
        from ..db.metrics_exec import MetricsResponse, response_to_dict as m_to_dict

        if not self.extend_enabled:
            return
        cut_ms = int((now - self.live_window_s) * 1000)
        cut_ms = (cut_ms // req.step_ms) * req.step_ms  # step-grid aligned
        cut_ms = min(cut_ms, req.end_ms)
        if cut_ms <= req.start_ms:
            return
        nbp = (cut_ms - req.start_ms) // req.step_ms
        pre = MetricsResponse(
            fn=resp.fn, start_ms=req.start_ms, step_ms=req.step_ms,
            n_buckets=nbp, label_names=resp.label_names)
        for labels, state in resp.series.items():
            sliced = {f: a[:nbp].copy() for f, a in state.items()}
            if _state_has_data(sliced):
                pre.series[labels] = sliced
        bl = self.blocklist_gen(tenant)
        pkey = ("metricsx",) + self._metrics_qkey(tenant, req)
        with self._lock:
            self._put_locked(
                pkey, ("bl", bl),
                {"start_ms": req.start_ms, "cut_ms": cut_ms,
                 "resp": m_to_dict(pre)}, now)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            entries = len(self._store)
            nbytes = self._bytes
            counts = {"hits": self.stats_hits, "misses": self.stats_misses,
                      "extensions": self.stats_extensions,
                      "invalidations": self.stats_invalidations}
        return {
            "enabled": True,
            # live-touching ranges are only cacheable with a local
            # ingester feed; probes use this to decide whether an
            # exact hit is expected on a now-edge repeat
            "live_gen_wired": self.live_gen("") is not None,
            "entries": entries,
            "bytes": int(nbytes),
            "budget_bytes": int(self.max_bytes),
            "ttl_s": self.ttl_s,
            "live_window_s": self.live_window_s,
            **counts,
        }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._bytes = 0


def _state_has_data(state: dict) -> bool:
    """Whether a sliced accumulator state would exist at all in a fresh
    execution of its window (empty series must not survive slicing:
    a fresh run only emits series that contributed data)."""
    arr = state.get("count")
    if arr is None:
        arr = state.get("vcnt")
    return arr is not None and bool(arr.sum())
