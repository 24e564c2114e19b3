"""Querier: fan trace-ID lookups and searches out to ingesters (ring
replication set) and the backend (TempoDB), combine partials (port of
tempo_tpu/services/querier.py).

Reference: modules/querier/querier.go -- FindTraceByID (:181-266),
forGivenIngesters (:269-293), SearchRecent (:295), SearchBlock (:401).
The ingester boundary is the same client registry the distributor uses.

Scope of the port: the ingester legs are the in-process clients of the
App's registry (the remote HTTP clients and their per-leg breakers come
with transport/, ROADMAP §A item 8), with the same tolerance of failed
legs. A ring with rf > 1 is refused: its quorum read needs fleet/quorum
(item 8), as the port's Distributor refuses rf > 1 writes. Block jobs
run on the TempoDB's device; the serverless endpoints run on theirs.
"""

from __future__ import annotations

import time
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import as_completed
from dataclasses import dataclass

from ..db.batchexec import record_routing
from ..db.search import SearchRequest, SearchResponse, request_to_dict, response_from_dict
from ..db.tempodb import TempoDB
from ..ring.ring import Ring
from ..util.ctxpool import ContextThreadPool
from ..wire.combine import combine_traces, sort_trace
from ..wire.model import Trace


@dataclass
class QuerierStats:
    traces_found: int = 0
    searches: int = 0
    metrics_queries: int = 0  # metrics_query_range jobs executed
    external_searches: int = 0  # shard jobs served by serverless endpoints
    external_failures: int = 0  # external legs that fell back to local


class Querier:
    def __init__(self, db: TempoDB, ring: Ring | None, client_for, workers: int = 8,
                 external_endpoints: list[str] | None = None,
                 external_hedge_after_s: float = 4.0):
        """client_for(addr) -> object with ingester read methods
        (find_trace_by_id / search / metrics_query_range).
        external_endpoints: serverless search handlers
        (tempo_tpu_torch.serverless HTTP mode); block-shard jobs POST
        there with hedged re-dispatch and fall back to local execution
        (querier.go:401-458 searchExternalEndpoints)."""
        if ring is not None and ring.rf > 1:
            raise ValueError(
                f"replication factor {ring.rf}: the quorum read of an rf > 1 ring needs "
                "fleet/quorum, which the port does not have yet (ROADMAP §A item 8)")
        self.db = db
        self.ring = ring
        self.client_for = client_for
        # the caller's contextvars follow each leg into the pool
        self.pool = ContextThreadPool(max_workers=workers, thread_name_prefix="querier")
        self.stats = QuerierStats()
        self.external_endpoints = list(external_endpoints or [])
        self.external_hedge_after_s = external_hedge_after_s
        self._external_rr = 0
        # per-endpoint circuit breaker: N consecutive failures skip the
        # endpoint for a cooldown instead of paying the hedge window on
        # every shard (reference: hedged client + endpoint weighting)
        self._external_fails: dict[str, int] = {}
        self._external_skip_until: dict[str, float] = {}
        self.external_breaker_fails = 3
        self.external_breaker_cooldown_s = 30.0

    def _ingester_clients(self) -> list:
        """The client of every healthy ring instance; an unresolvable
        addr degrades that leg, not the query."""
        if self.ring is None:
            return []
        out = []
        for d in self.ring.healthy_instances():
            try:
                out.append(self.client_for(d.addr))
            except KeyError:
                continue
        return out

    # ----------------------------------------------------------- trace by id
    def find_trace_by_id(self, tenant: str, trace_id: bytes,
                         time_start: int = 0, time_end: int = 0,
                         query_ingesters: bool = True,
                         query_backend: bool = True) -> Trace | None:
        """Both legs by default; the frontend's sharded pipeline sets
        query_backend=False for the ingester-leg job (backend blocks go
        through its own find_blocks shard jobs)."""
        futures = []
        if query_ingesters:
            for c in self._ingester_clients():
                futures.append(self.pool.submit(c.find_trace_by_id, tenant, trace_id))
        if query_backend:
            futures.append(self.pool.submit(
                self.db.find_trace_by_id, tenant, trace_id, time_start, time_end
            ))
        partials = []
        for f in futures:
            try:
                t = f.result()
            except Exception:  # noqa: BLE001 - tolerate failed legs like TolerateFailedBlocks
                continue
            if t is not None:
                partials.append(t)
        if not partials:
            return None
        self.stats.traces_found += 1
        return sort_trace(combine_traces(partials)) if len(partials) > 1 else partials[0]

    # ---------------------------------------------------------------- search
    def search_recent(self, tenant: str, req: SearchRequest) -> SearchResponse:
        """Recent (unflushed) data: all ingesters (querier.go:295)."""
        resp = SearchResponse()
        futs = [self.pool.submit(c.search, tenant, req) for c in self._ingester_clients()]
        for f in futs:
            try:
                resp.merge(f.result(), req.limit or 20)
            except Exception:  # noqa: BLE001 - a failed leg degrades coverage
                continue
        return resp

    def search_block_shard(self, tenant: str, meta, req: SearchRequest, groups) -> SearchResponse:
        """One backend search job: a row-group range of one block
        (the reference's SearchBlock page-shard job, querier.go:401-458).
        With external endpoints configured, the shard ships to a
        serverless handler (hedged); local execution is the fallback."""
        self.stats.searches += 1
        if self.external_endpoints:
            resp = self._search_external(tenant, meta, req, groups)
            if resp is not None:
                return resp
        return self.db.search_block_shard(tenant, meta, req, groups)

    def search_block_shard_multi(self, items: list) -> list:
        """Many shard jobs at once (the frontend's batch-aware dequeue):
        local execution goes through the coalescing db API; external
        serverless dispatch stays per-job (each leg hedges on its own)."""
        if self.external_endpoints:
            # search_block_shard counts its own stats per job
            return [self.search_block_shard(*it) for it in items]
        self.stats.searches += len(items)
        return self.db.search_block_shard_multi(items)

    def _external_candidates(self) -> list[str]:
        """Endpoints not in breaker cooldown (all of them when every
        breaker is open -- a dead fleet still gets probed)."""
        now = time.monotonic()
        ok = [e for e in self.external_endpoints
              if self._external_skip_until.get(e, 0.0) <= now]
        return ok or self.external_endpoints

    def _note_external(self, endpoint: str, ok: bool) -> None:
        if ok:
            self._external_fails[endpoint] = 0
            return
        n = self._external_fails.get(endpoint, 0) + 1
        self._external_fails[endpoint] = n
        if n >= self.external_breaker_fails:
            self._external_skip_until[endpoint] = (
                time.monotonic() + self.external_breaker_cooldown_s)

    def _search_external(self, tenant: str, meta, req: SearchRequest,
                         groups) -> SearchResponse | None:
        """POST the shard job to a serverless endpoint; if no response
        within external_hedge_after_s, hedge to the NEXT endpoint and
        take the first success. None -> caller runs locally."""
        event = {
            "backend": self.db.cfg.backend,
            "tenant": tenant,
            "block_id": meta.block_id,
            "groups": ([int(groups[0]), int(groups[-1]) + 1]
                       if groups is not None and len(groups) else None),
            "search": request_to_dict(req),
        }
        eps = self._external_candidates()
        first = eps[self._external_rr % len(eps)]
        self._external_rr += 1
        futs = {self.pool.submit(self._post_external, first, event): first}
        try:
            out = next(iter(futs)).result(timeout=self.external_hedge_after_s)
            self._note_external(first, out is not None)
            if out is not None:
                self.stats.external_searches += 1
                return out
        except FutureTimeout:
            if len(eps) > 1:  # hedge on a different endpoint
                second = eps[self._external_rr % len(eps)]
                self._external_rr += 1
                futs[self.pool.submit(self._post_external, second, event)] = second
            # await ALL legs up to one more hedge window: a slow first
            # leg failing must not discard a still-pending hedge winner
            try:
                for f in as_completed(futs, timeout=self.external_hedge_after_s):
                    out = f.exception() is None and f.result()
                    self._note_external(futs[f], bool(out))
                    if out:
                        self.stats.external_searches += 1
                        return out
            except FutureTimeout:
                for f, ep in futs.items():
                    if not f.done():
                        self._note_external(ep, False)
        except Exception:  # noqa: BLE001 - any failed leg falls back to local
            self._note_external(first, False)
        self.stats.external_failures += 1
        return None

    def _post_external(self, endpoint: str, event: dict) -> SearchResponse | None:
        import json
        import urllib.request

        try:
            r = urllib.request.urlopen(
                urllib.request.Request(
                    endpoint, data=json.dumps(event).encode(),
                    headers={"Content-Type": "application/json"},
                ),
                timeout=max(self.external_hedge_after_s * 4, 10.0),
            )
            return response_from_dict(json.loads(r.read()))
        except Exception:  # noqa: BLE001 - an unreachable or failing endpoint means no answer
            return None

    def search_blocks(self, tenant: str, metas: list, req: SearchRequest) -> SearchResponse:
        """One block-BATCH job: many whole blocks searched as one fused
        device program (db/search.search_blocks_fused) -- the job shape
        that amortizes a device sync across the batch, where the
        reference dispatches one 10-MiB page-shard job per querier
        round trip."""
        self.stats.searches += 1
        return self.db.search_blocks(tenant, metas, req)

    def search_blocks_multi(self, items: list) -> list:
        """Many block-batch jobs at once: eligible single-block jobs
        coalesce into fused multi-query launches (db/batchexec)."""
        self.stats.searches += len(items)
        return self.db.search_blocks_multi(items)

    def find_in_blocks_multi(self, items: list) -> list:
        """Many explicit-block lookups at once: jobs sharing a candidate
        partition share one batched lookup (db/batchexec)."""
        return self.db.find_in_blocks_multi(items)

    def metrics_query_range(self, tenant: str, req):
        """One metrics time-shard job: a step-aligned sub-range of the
        query_range axis, executed over the backend blocklist
        (db/metrics_exec) MERGED with every ingester's live-head leg --
        so recent unflushed spans are visible to TraceQL metrics.
        Time-shard jobs cover disjoint sub-ranges, so the per-shard
        ingester legs never double-count. Failed legs degrade coverage
        (the search_recent tolerance), never the query."""
        self.stats.metrics_queries += 1
        futs = []
        for c in self._ingester_clients():
            fn = getattr(c, "metrics_query_range", None)
            if fn is not None:
                futs.append(self.pool.submit(fn, tenant, req))
        resp = self.db.metrics_query_range(tenant, req)
        for f in futs:
            try:
                part = f.result()
            except Exception:  # noqa: BLE001 - a failed leg degrades coverage
                record_routing("metrics_live", "ingester", "leg_failed")
                continue
            if part is not None and part.series:
                record_routing("metrics_live", "ingester", "merged")
                resp.merge(part)
        return resp

    def find_in_blocks(self, tenant: str, trace_id: bytes, metas: list):
        """One frontend ID-shard job: lookup restricted to a partition
        of the candidate blocks (tracebyidsharding.go analog)."""
        return self.db.find_in_blocks(tenant, trace_id, metas)

    def search_tags(self, tenant: str, max_bytes: int = 0) -> list[str]:
        return self.db.search_tags(tenant, max_bytes)

    def search_tag_values(self, tenant: str, tag: str, max_bytes: int = 0) -> list[str]:
        return self.db.search_tag_values(tenant, tag, max_bytes)

    def close(self) -> None:
        self.pool.shutdown(wait=False)
