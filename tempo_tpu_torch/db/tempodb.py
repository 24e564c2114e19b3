"""TempoDB: the storage-engine facade of the port (port of
tempo_tpu/db/tempodb.py).

write_block cuts a block on the device (B9a/B9b/B9c, block/builder.py)
and adds it to the blocklist (db/blocklist.py, refreshed by poll_now or
by the thread enable_polling starts; close stops it); compact_once and
retention_once compact and expire a tenant's blocks (db/compactor.py:
concat, columnar and wire routes; the bloom union on B10a), and
compact_tenants runs every tenant's owned jobs through the pipelined
sweep (db/compact_pipeline.py). search_tags and search_tag_values list
the attribute keys and values of a tenant's blocks (host numpy), and
find_candidates the blocks that may hold an id. Find-by-ID runs the
host bloom gate and ONE batched bisection (K3) over every surviving
block's device index; search runs the fused multi-block device search
(db/search.py: K1 per block, one K2 across blocks). Concurrent
single-block search jobs and finds coalesce through the batching
executors (db/batchexec.py: B5a + B5b per search group, K3 with Q > 1
per find group), and TraceQL metrics range queries fold per block on
B6 (db/metrics_exec.py). On a mesh of more than one rank
(parallel/launch) finds run the sharded find, batched search windows
the mesh multi-query program, multi-block searches the stacked sharded
search and metrics the stacked mesh fold, where the reference routes
them. The WAL, the chaos wrap and the cost ledger of the JAX package
are not part of this port yet.

The device is the first card unless the caller names another one
(`device="cpu"` runs every kernel's plain PyTorch version).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..backend import LocalBackend, MemBackend
from ..backend.base import RawBackend
from ..block import schema as S
from ..block.builder import build_block_from_traces
from ..block.meta import BlockMeta
from ..block.reader import BackendBlock
from ..block.versioned import open_block_versioned
from ..ops.device import resolve_device
from ..ops.find import lookup_ids_blocks_cached
from ..util.distinct import DistinctStringCollector
from ..wire.combine import combine_traces
from ..wire.model import Trace
from . import compactor as comp
from .batchexec import (
    QueryBatchers,
    _FindItem,
    batched_find,
    batched_search_block,
    batched_search_block_many,
    find_key,
)
from .blocklist import Blocklist, Poller
from .compact_pipeline import CompactionPipeline, CompactionStats, JobOutcome
from .metrics_exec import MetricsRequest, MetricsResponse, metrics_query_range_blocks
from .search import (
    SearchRequest,
    SearchResponse,
    search_block,
    search_blocks_device,
    search_blocks_fused,
    search_tag_values,
    search_tags,
)


@dataclass
class TempoDBConfig:
    backend: dict = field(default_factory=lambda: {"backend": "local", "path": "./tempo-data"})
    row_group_spans: int = 1 << 16
    # chunk codec for written blocks (colio codec matrix)
    block_codec: str = "zstd"
    # seconds between the polls of the thread enable_polling starts
    blocklist_poll_s: float = 15.0
    block_cache_blocks: int = 64
    search_default_limit: int = 20
    # searches of a block before the batching executor takes it (the
    # touch count of search_blocks_fused)
    device_promote_touches: int = 2
    # cross-query batching executor (db/batchexec): None fields resolve
    # from the TEMPO_BATCH / TEMPO_BATCH_WINDOW_MS / TEMPO_BATCH_MAX env
    batch_enabled: bool | None = None
    batch_window_ms: float | None = None
    batch_max: int | None = None
    compaction: comp.CompactorConfig = field(default_factory=comp.CompactorConfig)


def open_backend(cfg: dict) -> RawBackend:
    kind = cfg.get("backend", "local")
    if kind == "local":
        return LocalBackend(cfg.get("path", "./tempo-data"))
    if kind in ("mem", "memory"):
        return MemBackend()
    raise ValueError(f"unknown backend {kind!r} (this port reads local and mem)")


class TempoDB:
    def __init__(self, cfg: TempoDBConfig, backend: RawBackend | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = backend or open_backend(cfg.backend)
        self.blocklist = Blocklist()
        self.poller = Poller(self.backend)
        # compaction ownership hook; services/compactor installs its ring's
        self.owns_job = lambda job_hash: True
        self._block_cache: dict[tuple[str, str], BackendBlock] = {}
        self._lock = threading.Lock()
        self._poll_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.poll_errors = 0
        # the pipelined sweeps' stage walls, occupancy and prefetch outcomes
        self.compaction_stats = CompactionStats()
        # concurrent search / find jobs that share a coalesce key merge
        # into one fused kernel launch
        self._mesh = None
        self.batchers = QueryBatchers(
            enabled=cfg.batch_enabled, window_ms=cfg.batch_window_ms,
            max_batch=cfg.batch_max, device=self.device, mesh_fn=self._batch_mesh)

    def _batch_mesh(self):
        """Mesh handed to the batching executors' window leaders
        (db/batchexec -> parallel/multiquery): the mesh when it has more
        than one rank, else None -- the single-device fused launch is
        already the route there."""
        mesh = self.mesh
        return mesh if mesh.size > 1 else None

    @property
    def mesh(self):
        """The mesh for the sharded find, batch and metrics paths: the
        process group's (parallel/launch) when one is up, else a 1x1
        mesh on this database's device, which takes no mesh route."""
        if self._mesh is None:
            from ..parallel import make_mesh

            self._mesh = make_mesh(device=self.device)
        return self._mesh

    # ------------------------------------------------------------ blocks
    def open_block(self, meta: BlockMeta) -> BackendBlock:
        key = (meta.tenant_id, meta.block_id)
        with self._lock:
            blk = self._block_cache.get(key)
            if blk is None:
                blk = open_block_versioned(self.backend, meta)
                # cached readers are long-lived over immutable blocks:
                # mark them device-worthy (row-group shard jobs batch on
                # them, metrics fold them on the card)
                blk.device_pinned = True
                if len(self._block_cache) >= self.cfg.block_cache_blocks:
                    self._block_cache.pop(next(iter(self._block_cache)))
                self._block_cache[key] = blk
            return blk

    def write_block(self, tenant: str, traces: list[tuple[bytes, Trace]]) -> BlockMeta:
        """Cut a complete block from (trace id, trace) pairs on this
        database's device and flush it (the ingester's CompleteBlock +
        WriteBlock path, tempodb.go:199-251)."""
        meta = build_block_from_traces(
            self.backend, tenant, traces, row_group_spans=self.cfg.row_group_spans,
            codec=self.cfg.block_codec, device=self.device,
        )
        self.blocklist.update(tenant, add=[meta])
        return meta

    def metas(self, tenant: str) -> list[BlockMeta]:
        return self.blocklist.metas(tenant)

    def tenants(self) -> list[str]:
        return self.blocklist.tenants()

    def poll_now(self) -> None:
        """Refresh the blocklist from the backend (compound blocks
        expanded, recently compacted ones kept for their grace window)."""
        metas, compacted = self.poller.poll()
        self.blocklist.apply_poll_results(metas, compacted)
        self._drop_readers({(t, m.block_id) for t in metas for m in metas[t]})

    def enable_polling(self) -> None:
        """Poll now, then every blocklist_poll_s seconds on a daemon thread
        until close(); a failed poll keeps the last list."""
        if self._poll_thread:
            return

        def loop():
            while not self._stop.wait(self.cfg.blocklist_poll_s):
                try:
                    self.poll_now()
                except Exception:  # noqa: BLE001 - poll errors keep the last list
                    self.poll_errors += 1

        self.poll_now()
        self._poll_thread = threading.Thread(target=loop, daemon=True, name="blocklist-poller")
        self._poll_thread.start()

    def close(self) -> None:
        """Stop the poll thread and join it."""
        self._stop.set()
        if self._poll_thread:
            self._poll_thread.join(timeout=2)

    def _drop_readers(self, live: set | None = None, gone: set | None = None) -> None:
        """Forget cached readers of blocks outside `live` or inside `gone`."""
        with self._lock:
            for key in [k for k in self._block_cache
                        if (live is not None and k not in live)
                        or (gone is not None and k in gone)]:
                del self._block_cache[key]

    # ------------------------------------------------------------- find
    def find_candidates(
        self, tenant: str, trace_id: bytes, time_start: int = 0, time_end: int = 0
    ) -> list[BlockMeta]:
        """Blocks whose id range and time window may hold the trace (the
        unit a frontend's id-space sharder partitions)."""
        hex_id = trace_id.rjust(16, b"\x00").hex()
        return [m for m in self.metas(tenant)
                if m.may_contain_id(hex_id) and m.overlaps_time(time_start, time_end)]

    def find_trace_by_id(
        self, tenant: str, trace_id: bytes, time_start: int = 0, time_end: int = 0
    ) -> Trace | None:
        """Candidate-block lookup + combine (reference: tempodb.Find,
        tempodb/tempodb.go:271-352)."""
        candidates = self.find_candidates(tenant, trace_id, time_start, time_end)
        return self.find_in_blocks(tenant, trace_id, candidates)

    def find_in_blocks(
        self, tenant: str, trace_id: bytes, candidates: list[BlockMeta]
    ) -> Trace | None:
        """Lookup restricted to an explicit block set; concurrent lookups
        against the same candidate partition share one K3 launch."""
        if not candidates:
            return None
        if self.batchers.enabled:
            return batched_find(self.batchers.find, self, candidates, trace_id)
        found = self._device_find(candidates, trace_id)
        return combine_traces(found) if found else None

    def find_in_blocks_multi(self, items: list) -> list:
        """Many (tenant, trace_id, candidates) lookups at once: jobs
        sharing a candidate partition submit to the find batcher as one
        group from this thread (and merge with any window-mates)."""
        out: list = [None] * len(items)
        groups: dict[tuple, list[tuple[int, object]]] = {}
        for i, (tenant, trace_id, candidates) in enumerate(items):
            if not candidates:
                continue
            if not self.batchers.enabled:
                out[i] = self.find_in_blocks(tenant, trace_id, candidates)
                continue
            groups.setdefault(find_key(candidates), []).append((i, _FindItem(
                metas=candidates, trace_id=trace_id, db=self)))
        for key, pairs in groups.items():
            results = self.batchers.find.submit_many(key, [it for _, it in pairs])
            for (i, _), r in zip(pairs, results):
                out[i] = r
        return out

    def _device_find(self, candidates: list[BlockMeta], trace_id: bytes) -> list[Trace]:
        """Host bloom gate (one shard read per block), then ONE K3 launch
        over every surviving block's stacked id index; each block reports
        its own hit row so partial traces combine."""
        blocks = [self.open_block(m) for m in candidates]
        blocks = [b for b in blocks if b.bloom_test(trace_id)]
        if not blocks:
            return []
        query = np.asarray(
            [S.trace_id_to_codes(trace_id.rjust(16, b"\x00"))], dtype=np.int32
        )
        if self.mesh.size > 1:
            from ..parallel.find import sharded_find_rows

            sids = sharded_find_rows(self.mesh, [b.trace_index["trace.id_codes"] for b in blocks],
                                     query)
        else:
            sids = lookup_ids_blocks_cached(blocks, query, self.device)
        return [blk.materialize_traces([int(sid)])[0]
                for blk, sid in zip(blocks, sids[:, 0]) if sid >= 0]

    # ------------------------------------------------------------ search
    def search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        metas = [m for m in self.metas(tenant) if m.overlaps_time(req.start, req.end)]
        return self.search_blocks(tenant, metas, req)

    def search_blocks(self, tenant: str, metas: list[BlockMeta], req: SearchRequest,
                      _skip_batcher: bool = False) -> SearchResponse:
        """Search a set of blocks as one unit. A single-block unit goes
        through the search batcher when eligible. Otherwise, on a mesh of
        more than one rank, a multi-block unit runs as one stacked
        sharded program (db/search.search_blocks_device); on one card,
        fused per-block filters + ONE cross-block top-k sync. Either
        falls back to per-block search when its footprint exceeds the
        device budget. _skip_batcher: the caller already probed batch
        eligibility for this query and got a fallback -- don't plan and
        count it twice."""
        limit = req.limit or self.cfg.search_default_limit
        if not metas:
            return SearchResponse()
        if len(metas) == 1 and self.batchers.enabled and not _skip_batcher:
            got = batched_search_block(
                self.batchers.search, self.open_block(metas[0]), req,
                promote_touches=self.cfg.device_promote_touches,
                default_limit=self.cfg.search_default_limit)
            if got is not None:
                return got
        blocks = [self.open_block(m) for m in metas]
        if self.mesh.size > 1 and len(metas) > 1:
            got = search_blocks_device(blocks, req, self.mesh,
                                       default_limit=self.cfg.search_default_limit)
        else:
            got = search_blocks_fused(blocks, req, default_limit=self.cfg.search_default_limit,
                                      device=self.device)
        if got is not None:
            return got
        resp = SearchResponse()
        for blk in blocks:
            resp.merge(search_block(blk, req, device=self.device), limit)
            if len(resp.traces) >= limit:
                break
        resp.traces.sort(key=lambda t: -t.start_time_unix_nano)
        return resp

    def search_block_shard(self, tenant: str, meta: BlockMeta, req: SearchRequest,
                           groups_range) -> SearchResponse:
        """One row-group shard job; concurrent shard jobs over the same
        range coalesce through the search batcher."""
        blk = self.open_block(meta)
        if self.batchers.enabled:
            got = batched_search_block(
                self.batchers.search, blk, req, groups_range=groups_range,
                promote_touches=self.cfg.device_promote_touches)
            if got is not None:
                return got
        return search_block(blk, req, groups_range=groups_range, device=self.device)

    def search_block_shard_multi(self, items: list) -> list:
        """Many (tenant, meta, req, groups_range) shard jobs at once;
        same-shard jobs submit to the batcher together."""
        out: list = [None] * len(items)
        if self.batchers.enabled:
            entries = [(self.open_block(m), req, groups) for (tenant, m, req, groups) in items]
            out = batched_search_block_many(
                self.batchers.search, entries,
                promote_touches=self.cfg.device_promote_touches)
        for i, (tenant, m, req, groups) in enumerate(items):
            if out[i] is None:
                out[i] = search_block(self.open_block(m), req, groups_range=groups,
                                      device=self.device)
        return out

    def search_blocks_multi(self, items: list) -> list:
        """Execute many (tenant, metas, req) search jobs at once: a whole
        burst handed over by one caller thread still forms full fused
        batches. Single-block jobs group by coalesce key and join the
        batcher window together; everything else runs the normal path."""
        out: list = [None] * len(items)
        singles: list[tuple[int, tuple]] = []
        for i, (tenant, metas, req) in enumerate(items):
            if self.batchers.enabled and len(metas) == 1:
                singles.append((i, (self.open_block(metas[0]), req, None)))
        if singles:
            got = batched_search_block_many(
                self.batchers.search, [e for _, e in singles],
                promote_touches=self.cfg.device_promote_touches,
                default_limit=self.cfg.search_default_limit)
            for (i, _), r in zip(singles, got):
                out[i] = r
        for i, (tenant, metas, req) in enumerate(items):
            if out[i] is None:
                # single-block entries were already probed (and refused)
                # by the batcher above: go straight to the engine
                out[i] = self.search_blocks(tenant, metas, req,
                                            _skip_batcher=len(metas) == 1)
        return out

    # ------------------------------------------------------------ metrics
    def metrics_query_range(self, tenant: str, req: MetricsRequest) -> MetricsResponse:
        """TraceQL metrics range query over the blocklist
        (db/metrics_exec): per-block filter -> bucketize -> fold on B6,
        partial series merged by label; the stacked mesh fold takes over
        on a mesh of more than one rank."""
        start_s, end_s = req.start_ms // 1000, -(-req.end_ms // 1000)
        metas = [m for m in self.metas(tenant) if m.overlaps_time(start_s, end_s)]
        blocks = [self.open_block(m) for m in metas]
        mesh = self.mesh if self.mesh.size > 1 else None
        return metrics_query_range_blocks(blocks, req, device=self.device, mesh=mesh)

    # ------------------------------------------------------ tag discovery
    def search_tags(self, tenant: str, max_bytes: int = 0) -> list[str]:
        """Every attribute key of the tenant's blocks, sorted; max_bytes
        caps the collected bytes (0: none)."""
        c = DistinctStringCollector(max_bytes)
        for m in self.metas(tenant):
            search_tags(self.open_block(m), c)
        return c.strings()

    def search_tag_values(self, tenant: str, tag: str, max_bytes: int = 0) -> list[str]:
        """Every value of `tag` in the tenant's blocks, sorted."""
        c = DistinctStringCollector(max_bytes)
        for m in self.metas(tenant):
            search_tag_values(self.open_block(m), tag, c)
        return c.strings()

    # --------------------------------------------------------- compaction
    def _apply_compaction_result(self, tenant: str, res: comp.CompactionResult,
                                 metas_by_id: dict[str, BlockMeta]) -> None:
        """One job's result into the blocklist: the same update for the
        sequential (compact_once) and the pipelined (compact_tenants)
        sweep."""
        removed = set(res.compacted_ids)
        self.blocklist.update(
            tenant,
            add=res.new_blocks,
            remove=list(removed),
            add_compacted=[m for bid, m in metas_by_id.items() if bid in removed],
        )
        self._drop_readers(gone={(tenant, bid) for bid in removed})

    def compact_once(self, tenant: str) -> list[comp.CompactionResult]:
        """One compaction sweep for a tenant: select jobs, run the owned
        ones on this database's device."""
        metas = self.blocklist.metas(tenant)
        metas_by_id = {m.block_id: m for m in metas}
        results = []
        for job in comp.select_jobs(tenant, metas, self.cfg.compaction):
            if not self.owns_job(job.hash):
                continue
            res = comp.compact(self.backend, job, self.cfg.compaction, self.device)
            self._apply_compaction_result(tenant, res, metas_by_id)
            results.append(res)
        return results

    def compact_tenants(self, tenants: list[str] | None = None) -> list[JobOutcome]:
        """The pipelined sweep across tenants (db/compact_pipeline): every
        tenant's owned jobs run on this database's device with
        resolve_concurrency(...) workers under the host-RAM admission
        budget, tenants admitted round robin; each job's blocklist update
        lands from its worker the moment it commits, the update
        compact_once makes. Returns the JobOutcome list; a job's error
        rides in its outcome."""
        if tenants is None:
            tenants = self.tenants()
        jobs_by_tenant: dict[str, list[comp.CompactionJob]] = {}
        metas_by_tenant: dict[str, dict[str, BlockMeta]] = {}
        for tenant in tenants:
            metas = self.blocklist.metas(tenant)
            jobs = [j for j in comp.select_jobs(tenant, metas, self.cfg.compaction)
                    if self.owns_job(j.hash)]
            if jobs:
                jobs_by_tenant[tenant] = jobs
                metas_by_tenant[tenant] = {m.block_id: m for m in metas}

        def on_result(tenant: str, job: comp.CompactionJob, res: comp.CompactionResult) -> None:
            self._apply_compaction_result(tenant, res, metas_by_tenant[tenant])

        pipeline = CompactionPipeline(self.backend, self.cfg.compaction, device=self.device,
                                      stats=self.compaction_stats)
        return pipeline.run(jobs_by_tenant, on_result=on_result)

    def retention_once(self, tenant: str) -> comp.RetentionResult:
        """Mark blocks past retention compacted and delete compacted
        blocks past compacted retention."""
        res = comp.apply_retention(
            self.backend, tenant, self.blocklist.metas(tenant),
            self.blocklist.compacted_metas(tenant), self.cfg.compaction, owns=self.owns_job)
        if res.marked:
            self.blocklist.update(tenant, remove=res.marked)
            self._drop_readers(gone={(tenant, bid) for bid in res.marked})
        return res
