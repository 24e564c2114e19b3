"""Ingester: per-tenant instances buffering live traces, WAL-backed,
cutting columnar blocks and flushing them to the backend (port of
tempo_tpu/services/ingester.py).

Reference: modules/ingester -- PushBytesV2 (ingester.go:208), instance
lifecycle (instance.go:238-348), flush state machine (flush.go:185-332),
WAL replay on start (ingester.go:326-400).

Pushes append to the WAL head block immediately (durable at ack time),
live search runs the staged live-head engine (db/live_engine: B7a-B7d
and K2 on the device), and block completion writes the columnar block
through TempoDB.write_block (the cut's B9a-B9c on the database's
device). Unlike the JAX package, a LiveEngine that cannot be built is an
error, not a silent fall back to the index walk.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..db.live_engine import LiveEngine
from ..db.search import SearchRequest, SearchResponse, SearchResult
from ..db.tempodb import TempoDB
from ..db.wal import DEFAULT_WAL_VERSION, WAL
from ..ingest.columnar import ColumnarIngest
from ..ops.device import resolve_device
from ..wire.combine import combine_traces, sort_trace
from ..wire.model import Trace
from ..wire.segment import segment_to_trace


class PushError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status  # 429 rate-limited / 400 too large / 500


@dataclass
class LiveTrace:
    trace_id: bytes
    segments: list[bytes] = field(default_factory=list)
    nbytes: int = 0
    last_append: float = 0.0
    start_s: int = 0
    end_s: int = 0
    # lazy search index (see _SearchEntry): built on first search touch,
    # reused until a new segment arrives; the decoded trace it was built
    # from is cached alongside (same invalidation via indexed_segments)
    search_index: object = None
    decoded: object = None
    indexed_segments: int = 0


@dataclass
class _SearchEntry:
    """Per-trace search index: tag kv pairs, names, time range and result
    fields extracted ONCE, so repeated live searches never re-decode
    segments. Built lazily at first search and invalidated by segment
    appends."""

    kv: set  # lowered (key, value) pairs across span+resource attrs
    names: set  # span names
    start_ns: int
    dur_ms: int
    root_service: str
    root_name: str

    @classmethod
    def build(cls, tr: Trace) -> "_SearchEntry":
        kv: set = set()
        names: set = set()
        root = None
        for res, _, sp in tr.all_spans():
            if root is None:
                root = (res.service_name, sp.name)
            names.add(sp.name)
            for k, v in sp.attrs.items():
                kv.add((k, str(v).lower()))
            for k, v in res.attrs.items():
                kv.add((k, str(v).lower()))
        lo, hi = tr.time_range_nanos()
        return cls(
            kv=kv,
            names=names,
            start_ns=lo or 0,
            dur_ms=max(0, ((hi or 0) - (lo or 0)) // 1_000_000),
            root_service=root[0] if root else "",
            root_name=root[1] if root else "",
        )

    def matches_tags(self, tags: dict[str, str]) -> bool:
        for k, v in tags.items():
            if k == "name":
                if v not in self.names:
                    return False
            elif (k, v.lower()) not in self.kv:
                return False
        return True


@dataclass
class IngesterConfig:
    max_trace_idle_s: float = 10.0
    max_block_age_s: float = 120.0
    max_block_bytes: int = 64 * 1024 * 1024
    flush_check_period_s: float = 2.0
    # WAL fsync cadence: acked pushes are flushed to the OS immediately
    # and fsynced at most this often; 0 fsyncs every flush
    wal_fsync_interval_s: float = 0.25
    # WAL write format: "w2" (columnar windows + feature checkpoints) or
    # "w1" (legacy one record per segment). Replay reads both.
    wal_version: str = DEFAULT_WAL_VERSION


class Instance:
    """One tenant inside one ingester (modules/ingester/instance.go),
    its live head staged on `device`."""

    def __init__(self, tenant: str, wal: WAL, db: TempoDB, overrides, cfg: IngesterConfig,
                 device=None):
        self.tenant = tenant
        self.wal = wal
        self.db = db
        self.overrides = overrides
        self.cfg = cfg
        self.lock = threading.RLock()
        self.live: dict[bytes, LiveTrace] = {}
        # columnar ingest plane: the shared LiveDict + decode-once
        # feature cache feeding live-search staging AND the WAL's
        # feature checkpoints (created BEFORE the live engine so the
        # engine's stager adopts the shared dictionary)
        self.columnar = ColumnarIngest()
        self.head = wal.new_block(tenant, cfg.wal_version)
        self.head_created = time.time()
        # traces cut from the live map, waiting to go into the next block
        self.cut: dict[bytes, LiveTrace] = {}
        # traces inside an in-flight block write: visible to find/search
        # between the flush snapshot and the blocklist update
        # (modules/ingester/instance.go:428-476)
        self.flushing: dict[bytes, LiveTrace] = {}
        self.blocks_flushed = 0
        self.flush_failures = 0
        # live-head mutation generation: bumps on every push / cut / flush
        self.live_gen = 0
        self.live_engine = LiveEngine(self, device=device)

    # ---------------------------------------------------------------- push
    def push_segments(self, batch: list[tuple[bytes, int, int, bytes]]) -> None:
        """batch: [(trace_id, start_s, end_s, segment)]"""
        lim = self.overrides.for_tenant(self.tenant)
        now = time.time()
        with self.lock:
            # phase 1: validate the WHOLE batch before touching any state,
            # so a limit error never leaves a half-applied batch behind
            new_tids = {tid for tid, *_ in batch if tid not in self.live}
            if lim.max_traces_per_user and len(self.live) + len(new_tids) > lim.max_traces_per_user:
                raise PushError(429, f"tenant {self.tenant}: max live traces reached")
            if lim.max_bytes_per_trace:
                incoming: dict[bytes, int] = {}
                for tid, _, _, seg in batch:
                    incoming[tid] = incoming.get(tid, 0) + len(seg)
                for tid, add in incoming.items():
                    base = self.live[tid].nbytes if tid in self.live else 0
                    if base + add > lim.max_bytes_per_trace:
                        raise PushError(400, "trace too large")
            # phase 2: apply
            for tid, s, e, seg in batch:
                lt = self.live.get(tid)
                if lt is None:
                    lt = self.live[tid] = LiveTrace(tid, start_s=s, end_s=e)
                lt.segments.append(seg)
                lt.nbytes += len(seg)
                lt.last_append = now
                lt.start_s = min(lt.start_s or s, s)
                lt.end_s = max(lt.end_s, e)
            self.live_gen += 1
            if hasattr(self.head, "append_window"):
                # columnar WAL: the whole push window is ONE framed
                # record -- one CRC, one file write on the ack path
                self.head.append_window(batch)
            else:
                for tid, s, e, seg in batch:
                    self.head.append(tid, s, e, seg)
            self.head.flush()

    def flush_wal_features(self) -> int:
        """Checkpoint already-decoded segment features into the columnar
        WAL head: replay of a checkpointed segment re-enters the stage
        buckets without a proto re-decode. Only features the columnar
        cache ALREADY holds are written. No-op on a legacy (w1) head."""
        head = self.head
        if not hasattr(head, "flush_features"):
            return 0
        with self.lock:
            if self.head is not head:  # rotated while unlocked: next sweep
                return 0
            n = head.flush_features(self.columnar.cached, self.columnar.dict)
            if n:
                head.flush()
            return n

    # ------------------------------------------------------------ lifecycle
    def cut_complete_traces(self, force: bool = False, now: float | None = None) -> int:
        """Idle live traces move to the cut set (instance.go:238-262)."""
        now = now or time.time()
        n = 0
        with self.lock:
            for tid in list(self.live):
                lt = self.live[tid]
                if force or (now - lt.last_append) >= self.cfg.max_trace_idle_s:
                    prev = self.cut.get(tid)
                    if prev:  # late spans for an already-cut trace merge in
                        prev.segments.extend(lt.segments)
                        prev.nbytes += lt.nbytes
                        prev.start_s = min(prev.start_s, lt.start_s)
                        prev.end_s = max(prev.end_s, lt.end_s)
                    else:
                        self.cut[tid] = lt
                    del self.live[tid]
                    n += 1
            if n:
                self.live_gen += 1
        return n

    def cut_block_if_ready(self, force: bool = False, now: float | None = None):
        """Cut set -> columnar block in the backend; WAL head rotates
        (instance.go:266-289 + CompleteBlock)."""
        now = now or time.time()
        with self.lock:
            if not self.cut:
                # nothing to write; an aged head with no live traces but
                # stale bytes rotates so the old file can be dropped
                if (force or (now - self.head_created) > self.cfg.max_block_age_s) \
                        and not self.live and self.head.size_bytes() > 0:
                    old = self.head
                    self.head = self.wal.new_block(self.tenant, self.cfg.wal_version)
                    self.head_created = now
                    old.clear()
                return None
            age = now - self.head_created
            size = self.head.size_bytes()
            if not (force or age >= self.cfg.max_block_age_s or size >= self.cfg.max_block_bytes):
                return None
            traces = []
            cut_snapshot = dict(self.cut)
            for tid, lt in self.cut.items():
                parts = [segment_to_trace(s) for s in lt.segments]
                traces.append((tid, sort_trace(combine_traces(parts)) if len(parts) > 1 else parts[0]))
            self.flushing.update(cut_snapshot)  # stay visible during the write
            self.cut.clear()
            # live traces staying behind move to the NEW head's WAL file so
            # the old file can be deleted after the block lands
            old_head = self.head
            self.head = self.wal.new_block(self.tenant, self.cfg.wal_version)
            self.head_created = now
            carry = [(lt.trace_id, lt.start_s, lt.end_s, seg)
                     for lt in self.live.values() for seg in lt.segments]
            if hasattr(self.head, "append_window"):
                if carry:
                    self.head.append_window(carry)
                    # carried segments were already decoded for staging:
                    # checkpoint those features into the fresh file
                    self.head.flush_features(self.columnar.cached, self.columnar.dict)
            else:
                for tid, s, e, seg in carry:
                    self.head.append(tid, s, e, seg)
            # the new head is about to become the ONLY wal copy of the
            # carried-over live traces: force the fsync
            self.head.flush(sync=True)
        try:
            meta = self.db.write_block(self.tenant, traces)
        except Exception:
            self.flush_failures += 1
            # block write failed: restore the cut set for the next retry;
            # the old WAL file stays on disk as the checkpoint. MERGE into
            # any entry cut for the same id since the snapshot.
            with self.lock:
                for tid, lt in cut_snapshot.items():
                    if self.flushing.get(tid) is lt:
                        del self.flushing[tid]
                    cur = self.cut.get(tid)
                    if cur is None:
                        self.cut[tid] = lt
                    elif cur is not lt:
                        cur.segments = lt.segments + cur.segments
                        cur.nbytes += lt.nbytes
                        cur.start_s = min(cur.start_s or lt.start_s, lt.start_s)
                        cur.end_s = max(cur.end_s, lt.end_s)
            raise
        self.blocks_flushed += 1
        with self.lock:
            # the blocklist now carries the block: retire the in-flight
            # snapshot
            for tid, lt in cut_snapshot.items():
                if self.flushing.get(tid) is lt:
                    del self.flushing[tid]
            self.live_gen += 1
            # flushed segments left the live window: release their
            # decoded-feature cache entries
            for lt in cut_snapshot.values():
                self.columnar.discard(lt.segments)
        old_head.clear()  # checkpoint advanced: block is durable in backend
        return meta

    # ---------------------------------------------------------------- read
    def find_trace_by_id(self, trace_id: bytes) -> Trace | None:
        return self.live_engine.find(trace_id)

    def _find_live_map(self, trace_id: bytes) -> Trace | None:
        """Hash-map find: segments combined in live/cut/flushing order
        (both find routes materialize through here)."""
        with self.lock:
            segs = []
            for src in (self.live.get(trace_id), self.cut.get(trace_id),
                        self.flushing.get(trace_id)):
                if src is not None:
                    segs.extend(src.segments)
        if not segs:
            return None
        return sort_trace(combine_traces([segment_to_trace(s) for s in segs]))

    def _index_of(self, lt: LiveTrace) -> tuple[_SearchEntry, Trace]:
        """The trace's search index, (re)built only when segments arrived
        since the last build; the decoded trace is cached alongside. The
        segment snapshot is taken under the instance lock: a segment
        appended mid-build must not be counted as indexed."""
        with self.lock:
            segs = list(lt.segments)
            idx = lt.search_index
            if idx is not None and lt.indexed_segments == len(segs):
                return idx, lt.decoded
        tr = sort_trace(combine_traces([segment_to_trace(s) for s in segs]))
        idx = _SearchEntry.build(tr)
        with self.lock:
            lt.search_index = idx
            lt.decoded = tr
            lt.indexed_segments = len(segs)
        return idx, tr

    def _live_groups(self) -> dict:
        """Consistent snapshot of the live head MERGED BY TRACE ID:
        {tid: [segments, state, start_s, end_s, [LiveTrace, ...]]} with
        segments concatenated in flushing->cut->live order (the order
        the cut/flush lifecycle keeps prefix-stable, so the staging
        layer's delta detection works by identity)."""
        groups: dict[bytes, list] = {}
        with self.lock:
            for state, src in (("flushing", self.flushing), ("cut", self.cut),
                               ("live", self.live)):
                for tid, lt in src.items():
                    g = groups.get(tid)
                    if g is None:
                        groups[tid] = [list(lt.segments), state,
                                       lt.start_s, lt.end_s, [lt]]
                    else:
                        g[0].extend(lt.segments)
                        g[1] = state  # latest lifecycle state wins
                        g[2] = min(g[2], lt.start_s)
                        g[3] = max(g[3], lt.end_s)
                        g[4].append(lt)
        return groups

    def _live_entry(self, tid: bytes, lts: list, segs: list):
        """(entry, decoded trace) for one merged live trace: the cached
        per-LiveTrace index when the tid lives in a single lifecycle
        dict, a transient merged build otherwise. Both the host oracle
        and the engine's verify step come through here."""
        if len(lts) == 1:
            return self._index_of(lts[0])
        tr = sort_trace(combine_traces([segment_to_trace(s) for s in segs]))
        return _SearchEntry.build(tr), tr

    def search_live(self, req: SearchRequest) -> SearchResponse:
        """Live + cut + flushing traces through the live-head engine
        (db/live_engine): slot mask -> top-k over the staged tails,
        candidates exactly re-verified against the oracle's own index."""
        return self.live_engine.search(req)

    def metrics_query_range(self, req):
        """TraceQL metrics over the MERGED live head (live/cut/flushing
        traces) by the exact host fold (metrics_exec.metrics_live_traces)
        over the same cached decodes the search oracle uses."""
        from ..db.metrics_exec import (
            MetricsResponse,
            expr_label,
            metrics_live_traces,
            parse_metrics_query,
        )

        q = parse_metrics_query(req.query)
        resp = MetricsResponse(
            fn=q.agg.fn, start_ms=req.start_ms, step_ms=req.step_ms,
            n_buckets=req.n_buckets,
            label_names=tuple(expr_label(e, i) for i, e in enumerate(q.agg.by)),
        )
        decoded = []
        for tid, (segs, _state, start_s, end_s, lts) in self._live_groups().items():
            # push-metadata time prefilter against the request range
            # (seconds resolution; 0 = unknown, never prunes)
            if end_s and end_s * 1000 < req.start_ms:
                continue
            if start_s and start_s * 1000 >= req.end_ms:
                continue
            _, tr = self._live_entry(tid, lts, segs)
            decoded.append(tr)
        metrics_live_traces(decoded, q, req, resp)
        return resp

    def search_live_index(self, req: SearchRequest) -> SearchResponse:
        """Host index walk over the merged live head -- the differential
        oracle for the engine (tests and the smoke run call it). Results are
        newest-first (exact start_ns, trace id tiebreak), truncated to
        the limit AFTER the sort."""
        from ..traceql.hosteval import trace_matches
        from ..traceql.parser import parse

        q = parse(req.query) if req.query else None
        resp = SearchResponse()
        matches: list[tuple[int, str, _SearchEntry]] = []
        for tid, (segs, _state, start_s, end_s, lts) in self._live_groups().items():
            if req.start and end_s < req.start:
                continue
            if req.end and start_s > req.end:
                continue
            idx, decoded = self._live_entry(tid, lts, segs)
            if req.tags and not idx.matches_tags(req.tags):
                continue
            if req.min_duration_ms and idx.dur_ms < req.min_duration_ms:
                continue
            if req.max_duration_ms and idx.dur_ms > req.max_duration_ms:
                continue
            if q is not None and not trace_matches(q, decoded):
                continue
            matches.append((idx.start_ns, tid.hex(), idx))
        matches.sort(key=lambda m: (-m[0], m[1]))
        for start_ns, tid_hex, idx in matches[: (req.limit or 20)]:
            resp.traces.append(
                SearchResult(
                    trace_id=tid_hex,
                    root_service_name=idx.root_service,
                    root_trace_name=idx.root_name,
                    start_time_unix_nano=idx.start_ns,
                    duration_ms=idx.dur_ms,
                )
            )
        return resp


class Ingester:
    """All tenants of one ingester process (modules/ingester/ingester.go).
    `device` holds every instance's live head: the first card unless the
    caller names another (device="cpu" runs the plain versions)."""

    def __init__(self, wal: WAL, db: TempoDB, overrides, cfg: IngesterConfig | None = None,
                 device=None):
        self.wal = wal
        self.db = db
        self.overrides = overrides
        self.cfg = cfg or IngesterConfig()
        self.device = resolve_device(device)
        self.instances: dict[str, Instance] = {}
        self.lock = threading.Lock()
        self._stop = threading.Event()
        self._flush_retry_at: dict[str, float] = {}
        self._flush_backoff: dict[str, float] = {}
        self._sweeper: threading.Thread | None = None
        self.replayed_blocks = 0

    def instance(self, tenant: str) -> Instance:
        with self.lock:
            inst = self.instances.get(tenant)
            if inst is None:
                inst = self.instances[tenant] = Instance(
                    tenant, self.wal, self.db, self.overrides, self.cfg, self.device)
            return inst

    # --------------------------------------------------------------- push
    def push_segments(self, tenant: str, batch) -> None:
        self.instance(tenant).push_segments(batch)

    # --------------------------------------------------------------- read
    def _get(self, tenant: str) -> Instance | None:
        with self.lock:
            return self.instances.get(tenant)

    def find_trace_by_id(self, tenant: str, trace_id: bytes) -> Trace | None:
        inst = self._get(tenant)
        return inst.find_trace_by_id(trace_id) if inst else None

    def search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        inst = self._get(tenant)
        return inst.search_live(req) if inst else SearchResponse()

    def metrics_query_range(self, tenant: str, req):
        """Live-head TraceQL metrics leg (None when this ingester holds
        nothing for the tenant)."""
        inst = self._get(tenant)
        return inst.metrics_query_range(req) if inst else None

    def live_generation(self, tenant: str) -> int:
        """The tenant's live-head mutation generation (0 = no instance)."""
        inst = self._get(tenant)
        return inst.live_gen if inst else 0

    # ---------------------------------------------------------- lifecycle
    def replay_wal(self) -> int:
        """Startup: WAL files -> live state of fresh instances, then an
        immediate cut (ingester.go:326-400 replays into blocks)."""
        n = 0
        for rb in self.wal.rescan_blocks():
            if not rb.records:
                self.wal.delete_block_file(rb.block_id, rb.tenant)
                continue
            inst = self.instance(rb.tenant)
            with inst.lock:
                # seed the file's dictionary delta FIRST, in file-code
                # order, so replayed feature codes land deterministically
                for s in rb.dict_delta:
                    inst.columnar.dict.code(s)
                for rec in rb.records:
                    lt = inst.live.setdefault(rec.trace_id, LiveTrace(rec.trace_id))
                    lt.segments.append(rec.segment)
                    lt.nbytes += len(rec.segment)
                    lt.start_s = min(lt.start_s or rec.start_s, rec.start_s)
                    lt.end_s = max(lt.end_s, rec.end_s)
                    lt.last_append = 0.0  # replayed = instantly idle
                for i, feat in rb.features.items():
                    # checkpointed features replay straight into the
                    # columnar cache: staging needs no proto re-decode
                    inst.columnar.seed_strings(rb.records[i].segment, *feat)
            n += len(rb.records)
            # records now tracked by the instance's new head after the
            # cut; the old file is superseded once the cut block lands
            inst.cut_complete_traces(force=True)
            inst.cut_block_if_ready(force=True)
            self.wal.delete_block_file(rb.block_id, rb.tenant)
            self.replayed_blocks += 1
        return n

    def sweep_all(self, force: bool = False) -> None:
        with self.lock:
            insts = list(self.instances.values())
        now = time.time()
        for inst in insts:
            inst.cut_complete_traces(force=force)
            # bound the push -> device-visible staging lag to the sweep
            # cadence even when no query arrives
            inst.live_engine.maybe_refresh()
            # features decoded by the refresh above checkpoint into the
            # WAL head so replay skips their proto decode
            inst.flush_wal_features()
            # per-tenant exponential backoff after a failed flush
            # (flush.go:62-67): a broken backend is not hammered every
            # sweep, and one tenant's failures do not skip the others'
            key = inst.tenant
            if not force and now < self._flush_retry_at.get(key, 0.0):
                continue
            try:
                inst.cut_block_if_ready(force=force)
                self._flush_retry_at.pop(key, None)
                self._flush_backoff.pop(key, None)
            except Exception:
                if force:
                    raise
                backoff = min(self._flush_backoff.get(key, 1.0) * 2, 60.0)
                self._flush_backoff[key] = backoff
                self._flush_retry_at[key] = now + backoff

    def start_sweeper(self) -> None:
        def loop():
            while not self._stop.wait(self.cfg.flush_check_period_s):
                self.sweep_all()

        self._sweeper = threading.Thread(target=loop, daemon=True, name="ingester-sweep")
        self._sweeper.start()

    def flush_all(self) -> None:
        """Graceful drain (/shutdown handler, flush.go:91-115)."""
        self.sweep_all(force=True)

    def stop(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join()
        self.flush_all()
