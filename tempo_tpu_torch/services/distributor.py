"""Distributor: receive trace batches, rebatch by trace id, rate-limit,
route to ingesters through the ring, and tap the metrics-generator
(port of tempo_tpu/services/distributor.py).

Reference: modules/distributor/distributor.go -- PushBatches (:277),
requestsByTraceID (:451-525), sendToIngestersViaBytes (:357-408,
ring.DoBatch). The transport boundary is `client_for(addr)`, a registry
mapping an instance address to an object with push_segments(tenant,
batch): the in-process Ingester in the single binary.

Scope of the port: replication factor 1 (the ring walk over several
ingesters included; replicated writes with their breakers and quorum
accounting are not ported, and a ring with rf > 1 is refused), the
in-process generator legs (`generator_window`, the streaming tap, and
`generator_forward`, decoded traces), and push_raw through the OTLP
decode (no native splice). The distributor holds no tensors: its
ingesters and generator run on the devices they were given.

The tap runs off the ingest path on one worker thread and never fails a
push. It does not hide a kernel fault either: a KernelError raised in
the tap is kept and re-raised by the next flush_generator_tap() or
stop(); any other tap exception is logged and counted in
`stats.gen_tap_errors`, as queue overflows are in `gen_tap_dropped`.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

from ..kernels import KernelError
from ..ring.ring import Ring
from ..util.hashing import ring_token
from ..wire.model import ResourceSpans, ScopeSpans, Trace
from ..wire.otlp_pb import decode_trace
from ..wire.segment import segment_for_write
from .ingester import PushError
from .overrides import Overrides, RateLimiter

__all__ = ["Distributor", "DistributorStats", "PushError"]

log = logging.getLogger(__name__)

TAP_QUEUE = 256  # tap items queued before the tap drops (lossy, counted)
TAP_MERGE = 64  # queued items one tap pass folds together


@dataclass
class DistributorStats:
    spans_received: int = 0
    bytes_received: int = 0
    traces_pushed: int = 0
    push_failures: int = 0
    spans_refused_rate: int = 0
    traces_refused_size: int = 0
    gen_tap_dropped: int = 0  # tap items dropped on a full queue
    gen_tap_errors: int = 0  # tap calls that raised (other than KernelError)


class Distributor:
    def __init__(self, ring: Ring, client_for, overrides: Overrides,
                 generator_forward=None, generator_window=None):
        """client_for(addr) -> object with push_segments(tenant, batch).
        generator_window(tenant, segs, push_ts) is the STREAMING
        in-process tap: it receives the post-filter segment bytes -- the
        very objects the ingester just staged, so the generator reads
        their coded features out of ColumnarIngest's identity-keyed cache
        with no extra decode. generator_forward(tenant, traces) is the
        decoded-trace leg, used only when no window tap is set."""
        if ring.rf > 1:
            raise ValueError(f"replication factor {ring.rf}: the port's distributor writes "
                             "at rf 1 only")
        self.ring = ring
        self.client_for = client_for
        self.overrides = overrides
        self.limiter = RateLimiter(overrides)
        self.generator_forward = generator_forward
        self.generator_window = generator_window
        self.stats = DistributorStats()
        self._stats_lock = threading.Lock()  # pushes come from many threads
        # the tap's worker, started at the first tapped push; a bounded
        # queue keeps the tap lossy on overflow (counted), never blocking
        # ingest
        self._gen_q: queue.Queue = queue.Queue(maxsize=TAP_QUEUE)
        self._gen_thread: threading.Thread | None = None
        self._gen_lock = threading.Lock()  # guards thread start, pending, the kept error
        self._gen_pending = 0  # queued + in-flight tap items
        self._gen_stop = threading.Event()
        self._tap_error: KernelError | None = None

    def _count(self, **add: int) -> None:
        with self._stats_lock:
            for name, n in add.items():
                setattr(self.stats, name, getattr(self.stats, name) + n)

    # ---------------------------------------------------------------- tap
    def _forward_to_generators(self, tenant: str, segs: dict, traces_fn,
                               push_ts: float) -> None:
        """Queue one push's post-filter segments ({tid: (s, e, seg)}) for
        the tap. traces_fn() -> {tid: Trace} is resolved only by the
        decoded-trace leg, on the tap worker."""
        if self.generator_forward is None and self.generator_window is None:
            return
        with self._gen_lock:
            if self._gen_thread is None:
                self._gen_thread = threading.Thread(
                    target=self._gen_tap_loop, daemon=True, name="generator-tap")
                self._gen_thread.start()
            try:
                self._gen_q.put_nowait((tenant, segs, traces_fn, push_ts))
                self._gen_pending += 1
            except queue.Full:
                self._count(gen_tap_dropped=1)

    def _gen_tap_loop(self) -> None:
        while not self._gen_stop.is_set():
            try:
                item = self._gen_q.get(timeout=0.5)
            except queue.Empty:
                continue
            # greedy drain: everything already queued folds in THIS pass,
            # merged per tenant into one window, so a backlog costs one
            # fold per tenant instead of one per push
            items = [item]
            while len(items) < TAP_MERGE:
                try:
                    items.append(self._gen_q.get_nowait())
                except queue.Empty:
                    break
            try:
                self._tap_call(self._forward_batch, items)
            finally:
                # pending counts queued + in-flight items and drops only
                # AFTER the work: a flush cannot slip between the queue
                # pop and the fold
                with self._gen_lock:
                    self._gen_pending -= len(items)

    def _tap_call(self, fn, *args) -> None:
        """Run one generator leg. A KernelError is kept for the next
        flush_generator_tap(); anything else is logged and counted. The
        push that queued the item has already been acknowledged."""
        try:
            fn(*args)
        except KernelError as e:
            log.exception("metrics tap: kernel fault")
            with self._gen_lock:
                if self._tap_error is None:
                    self._tap_error = e
        except Exception:
            log.exception("metrics tap failed")
            self._count(gen_tap_errors=1)

    def _forward_batch(self, items: list) -> None:
        """Forward one drained tap batch. The window leg merges items per
        tenant (segment lists concatenate -- a trace may continue across
        pushes, so never dedupe by id) and stamps the merged window with
        its OLDEST push_ts, keeping freshness an upper bound. The decoded
        leg keeps per-item calls."""
        if self.generator_window is None:
            for tenant, segs, traces_fn, _ in items:
                self._tap_call(self._forward_traces, tenant, segs, traces_fn)
            return
        merged: dict[str, tuple[list, float]] = {}
        for tenant, segs, _, push_ts in items:
            seg_list, ts = merged.get(tenant, ([], push_ts))
            seg_list.extend(seg for _, _, seg in segs.values())
            merged[tenant] = (seg_list, min(ts, push_ts))
        for tenant, (seg_list, ts) in merged.items():
            self._tap_call(self.generator_window, tenant, seg_list, ts)

    def _forward_traces(self, tenant: str, segs: dict, traces_fn) -> None:
        # restrict to the post-filter set: traces_fn() may also hold
        # size-refused traces
        per = traces_fn()
        self.generator_forward(tenant, [tr for tid, tr in per.items() if tid in segs])

    def flush_generator_tap(self, timeout_s: float = 5.0) -> bool:
        """Wait until the tap has folded everything queued (tests,
        shutdown). Re-raises a KernelError the tap met since the last
        flush. Returns False if the tap did not drain in time."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._gen_lock:
                drained = self._gen_pending == 0
                err, self._tap_error = self._tap_error, None
            if err is not None:
                raise err
            if drained or time.monotonic() >= deadline:
                return drained
            time.sleep(0.005)

    def stop(self) -> None:
        """Drain the tap (raising a kept KernelError), then end its worker."""
        try:
            self.flush_generator_tap(timeout_s=2.0)
        finally:
            self._gen_stop.set()
            if self._gen_thread is not None:
                self._gen_thread.join(timeout=2.0)

    # ---------------------------------------------------------------- push
    def push(self, tenant: str, batches: list[ResourceSpans]) -> int:
        """One OTLP export request worth of ResourceSpans. Returns the
        span count."""
        return self._push(tenant, batches)

    def push_raw(self, tenant: str, payload: bytes) -> int:
        """One OTLP export request as raw proto bytes: decoded, then the
        model path. A payload that does not decode raises PushError(400),
        so receivers can classify it as poison rather than transient.
        Returns the span count."""
        try:
            tr = decode_trace(payload)
        except Exception as e:
            raise PushError(400, f"undecodable OTLP payload: {e}") from e
        return self._push(tenant, tr.resource_spans)

    def _push(self, tenant: str, batches: list[ResourceSpans]) -> int:
        now = time.time()
        n_spans = sum(len(ss.spans) for rs in batches for ss in rs.scope_spans)
        self._count(spans_received=n_spans)

        # cheap pre-gate BEFORE rebatch/serialization: a LOWER BOUND on
        # the wire size (ids and timestamps alone exceed 16 bytes a span)
        # that cannot pass the bucket refuses without encoding; the
        # exact-bytes limiter still applies below on real wire bytes
        if not self.limiter.peek(tenant, n_spans * 16, now):
            self._count(spans_refused_rate=n_spans)
            raise PushError(429, f"tenant {tenant} over ingestion rate limit")

        per_trace = self._requests_by_trace_id(batches)
        if not per_trace:
            return 0

        # serialize first so the limiter and bytes_received see REAL wire
        # bytes (distributor.go:312-319 limits on the request's size)
        segs = {}
        for tid, tr in per_trace.items():
            lo, hi = tr.time_range_nanos()
            s, e = (lo or 0) // 10**9, ((hi or 0) + 10**9 - 1) // 10**9
            segs[tid] = (s, e, segment_for_write(tr, s, e))
        self._send_segments(tenant, segs, n_spans, lambda: per_trace, now)
        return n_spans

    def _send_segments(self, tenant: str, segs: dict, n_spans: int,
                       traces_fn, now: float) -> None:
        """Limit, route and write prepared per-trace segments, then tap
        the generator with the post-filter set."""
        nbytes = sum(len(seg) for _, _, seg in segs.values())
        self._count(bytes_received=nbytes)
        if not self.limiter.allow(tenant, nbytes, now):
            self._count(spans_refused_rate=n_spans)
            raise PushError(429, f"tenant {tenant} over ingestion rate limit")
        max_trace = self.overrides.for_tenant(tenant).max_bytes_per_trace

        lim_filtered = {}
        for tid, (s, e, seg) in segs.items():
            if max_trace and len(seg) > max_trace:
                self._count(traces_refused_size=1)
                continue
            lim_filtered[tid] = (s, e, seg)
        if not lim_filtered:
            return

        # group traces by owning instance (ring.DoBatch); snapshot the
        # healthy set once for the whole batch
        healthy = self.ring.healthy_instances()
        if not healthy:
            raise PushError(500, "no healthy ingesters in the ring")
        by_instance: dict[str, list] = defaultdict(list)
        if len(healthy) == 1:
            # the single-binary topology: every token resolves to the one
            # instance, so skip the per-trace ring walk
            by_instance[healthy[0].addr] = [(tid, s, e, seg)
                                            for tid, (s, e, seg) in lim_filtered.items()]
        else:
            for tid, (s, e, seg) in lim_filtered.items():
                rs = self.ring.get(ring_token(tenant, tid), instances=healthy)
                if not rs.instances:
                    raise PushError(500, "no healthy ingesters in the ring")
                by_instance[rs.instances[0].addr].append((tid, s, e, seg))

        failed, errors = 0, []
        for addr, batch in by_instance.items():
            try:
                self.client_for(addr).push_segments(tenant, batch)
            except Exception as e:  # an instance failure fails its traces
                failed += len(batch)
                errors.append(e)
        if failed:
            self._count(push_failures=failed)
            # surface the ingester's own status (429 backpressure / 400
            # too large) instead of flattening everything to 500
            push_errs = [e for e in errors if isinstance(e, PushError)]
            if push_errs:
                raise PushError(push_errs[0].status, str(push_errs[0]))
            raise PushError(500, f"{failed} traces failed to write: {errors[:1]}")
        self._count(traces_pushed=len(lim_filtered))

        # tap the POST-filter set (a trace refused from storage must not
        # produce span metrics) with the very segment objects the
        # ingester staged: ColumnarIngest's feature cache is keyed by
        # identity, and holding the refs pins its entries until the tap
        # reads them
        self._forward_to_generators(tenant, lim_filtered, traces_fn, now)

    # ------------------------------------------------------------ rebatch
    @staticmethod
    def _requests_by_trace_id(batches: list[ResourceSpans]) -> dict[bytes, Trace]:
        """Regroup spans by trace id keeping resource/scope structure
        (requestsByTraceID, distributor.go:451-525)."""
        out: dict[bytes, Trace] = {}
        for rs in batches:
            for ss in rs.scope_spans:
                groups: dict[bytes, list] = defaultdict(list)
                for sp in ss.spans:
                    groups[sp.trace_id].append(sp)
                for tid, spans in groups.items():
                    tr = out.get(tid)
                    if tr is None:
                        tr = out[tid] = Trace()
                    tr.resource_spans.append(
                        ResourceSpans(
                            resource=rs.resource,
                            scope_spans=[ScopeSpans(scope=ss.scope, spans=spans)],
                        )
                    )
        return out
