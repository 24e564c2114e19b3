"""Live-head engine: the ingester's live/cut/flushing traces searched
through the same filter -> top-k shape as complete blocks (port of
tempo_tpu/db/live_engine.py).

Execution contract (as db/search.py): the staged slot mask (B7a) is
CONSERVATIVE -- tag/name membership and the push-metadata
time prefilter are exact, min-duration filters on a >= bound, and
max-duration / TraceQL are not filtered at all -- then the top-k
selection (ops/select, newest first by the seconds-granularity start
key) feeds an escalating collect whose candidates are re-verified
bit-exactly through the SAME per-trace index the host oracle
(Instance.search_live_index) uses. The escalation widens k until either
every masked slot has been seen or the limit-th verified result's key
is STRICTLY newer than the selection boundary -- at that point no
unseen slot can displace a winner even under second-granularity ties,
so the result set equals the oracle's by construction.

Routing: every live search runs B7a, then K2, on the stager's device.
The JAX package's host route (numpy twins picked by a measured row-count
crossover, its EMAs and the persisted cost ledger) is not ported: a host
route comes back only with a crossover measured on this card, as for
blocks. The numpy twins stay in ops/livestage as test oracles.

TEMPO_LIVE_FIND_DEVICE=1 routes find-by-id through the staged id-code
kernel B7b (the hash-map lookup is the default, as in the JAX package).
"""

from __future__ import annotations

import os

from ..ingest.columnar import kv_pair_key
from ..ops.livestage import (
    LiveStager,
    _clip_i32,
    eval_live_device,
    find_slot_device,
)
from ..ops.select import k_bucket, select_topk_device
from ..ops.stage import GKEY_ORIGIN_S
from .search import DEFAULT_LIMIT, SearchRequest, SearchResponse, SearchResult


class LiveEngine:
    """One ingester Instance's staged live-head engine, on the
    instance's device. Query execution never holds the instance lock
    past the snapshot; staging mutation serializes on the stager's own
    lock."""

    def __init__(self, instance, device=None):
        self.inst = instance
        # share the instance's columnar-ingest plane: one LiveDict for
        # staging + WAL feature checkpoints, and staging reads decoded
        # features from the shared cache (decode once)
        col = instance.columnar
        self.stager = LiveStager(dictionary=col.dict, features_fn=col.features_for,
                                 device=device)

    def _refresh(self):
        """Snapshot the instance's live groups and reconcile the stager,
        atomically under the stager lock (lock order: stager outer,
        instance inner -- everywhere): a stale groups snapshot must
        never reach refresh after a newer one, or it would retire and
        restage traces the newer one staged. Returns (groups, snapshot);
        the snapshot is None when the head is empty."""
        with self.stager.lock:
            groups = self.inst._live_groups()
            if not groups and not self.stager.tails:
                return groups, None
            items = {tid: (g[0], g[1], g[2], g[3]) for tid, g in groups.items()}
            snap = self.stager.refresh(items)
        return groups, snap

    # --------------------------------------------------------- lifecycle
    def maybe_refresh(self) -> None:
        """Sweeper hook: bound the push -> device-visible staging lag
        without waiting for a query."""
        self._refresh()

    # ------------------------------------------------------------ search
    def search(self, req: SearchRequest) -> SearchResponse:
        from ..traceql.parser import parse

        q = parse(req.query) if req.query else None
        groups, snap = self._refresh()
        if not groups:
            return SearchResponse()

        # resolve tag strings through the append-only dictionary: a miss
        # proves no staged row carries the pair -> exact empty result
        tag_codes: list[int] = []
        name_codes: list[int] = []
        for k, v in (req.tags or {}).items():
            if k == "name":
                c = self.stager.dict.lookup(v)
                codes = name_codes
            else:
                c = self.stager.dict.lookup(kv_pair_key(k, str(v).lower()))
                codes = tag_codes
            if c < 0:
                return SearchResponse()
            codes.append(c)

        mask = eval_live_device(snap, tag_codes, name_codes,
                                req.start, req.end, req.min_duration_ms)

        def selector(k):
            sids, _, n_match = select_topk_device(mask, snap.dev["key_s"], mask, k)
            return sids, n_match

        return self._collect(snap, groups, req, q, selector)

    def _collect(self, snap, groups, req: SearchRequest, q, selector) -> SearchResponse:
        """Escalating top-k collect with exact host verification: the
        device mask proposes newest-first candidates, the
        per-trace index (the oracle's own entry) settles them."""
        inst = self.inst
        resp = SearchResponse()
        n = snap.n_slots
        if n == 0:
            return resp
        limit = req.limit or DEFAULT_LIMIT
        slot_tid = snap.slot_tid
        k = min(k_bucket(max(2 * limit, 32)), n)
        out: list[tuple[int, str, object]] = []
        seen: set[int] = set()
        while True:
            sids, n_match = selector(k)
            boundary_key = (int(snap.key_s[int(sids[-1])])
                            if len(sids) == k else None)
            for s in sids:
                s = int(s)
                if s in seen:
                    continue
                seen.add(s)
                tid = slot_tid.get(s)
                g = groups.get(tid) if tid is not None else None
                if g is None:
                    continue  # retired between snapshot and collect
                idx, decoded = inst._live_entry(tid, g[4], g[0])
                if req.tags and not idx.matches_tags(req.tags):
                    continue
                if req.min_duration_ms and idx.dur_ms < req.min_duration_ms:
                    continue
                if req.max_duration_ms and idx.dur_ms > req.max_duration_ms:
                    continue
                if q is not None:
                    from ..traceql.hosteval import trace_matches

                    if not trace_matches(q, decoded):
                        continue
                out.append((idx.start_ns, tid.hex(), idx))
            out.sort(key=lambda c: (-c[0], c[1]))
            done = len(seen) >= n_match or k >= n
            if not done and len(out) >= limit and boundary_key is not None:
                # exact stop: the limit-th verified result is strictly
                # newer (at key granularity) than anything unseen
                cutoff = _clip_i32(out[limit - 1][0] // 1_000_000_000 - GKEY_ORIGIN_S)
                done = cutoff > boundary_key
            if done:
                break
            k = min(k_bucket(k * 4), n)
        for start_ns, tid_hex, idx in out[:limit]:
            resp.traces.append(SearchResult(
                trace_id=tid_hex,
                root_service_name=idx.root_service,
                root_trace_name=idx.root_name,
                start_time_unix_nano=idx.start_ns,
                duration_ms=idx.dur_ms,
            ))
        resp.inspected_spans = snap.n_kv + snap.n_name
        return resp

    # -------------------------------------------------------------- find
    def find(self, trace_id: bytes):
        """Find-by-id through the live head. The hash-map lookup is the
        default; TEMPO_LIVE_FIND_DEVICE=1 locates the slot through the
        staged id codes (B7b on the device) first. Both materialize
        through the same segment combine, so their results are equal by
        construction."""
        inst = self.inst
        if os.environ.get("TEMPO_LIVE_FIND_DEVICE") != "1":
            return inst._find_live_map(trace_id)
        _, snap = self._refresh()
        if snap is None:
            return None
        if find_slot_device(snap, trace_id) < 0:
            return None
        return inst._find_live_map(trace_id)
