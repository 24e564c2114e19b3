"""Pipelined concurrent compaction: fetch, merge, assemble and write
overlapped across jobs and output blocks.

Port of tempo_tpu/db/compact_pipeline.py. The sequential driver
(db/compactor.compact) runs one job, one stage at a time. This executor
runs a fixed set of jobs as a bounded, memory-budgeted pipeline:

  * job-level concurrency: `concurrency` worker threads run whole jobs
    at once (ranged reads, numpy gathers and zstd drop the GIL). Jobs
    own disjoint input blocks.
  * admission gate: a job's estimated peak host RAM is its input bytes
    x EXPANSION; a job waits while the estimate in flight would
    pass the budget. One job always admits, so an oversized job stalls
    the pipeline instead of deadlocking it.
  * per-tenant round-robin: the admission order interleaves tenants, so
    one tenant's backlog cannot starve the others.
  * input prefetch: a thread runs up to prefetch_depth jobs ahead of the
    workers, opening readers and preloading small packs with one ranged
    read, charged against the same budget.
  * assemble / write double-buffering: within a multi-output columnar
    job, output k + 1 assembles while output k is written (a queue of
    depth 1: at most one finalized block waits in memory).

Every job runs on the pipeline's device: the bloom union (B10a) and a
collision's rebuild (the cut, B9a-B9c) launch from the worker threads,
each wrapper with pinned buffers of its own call.

Crash and ordering safety: outputs are written with defer_meta=True and
their meta.json objects publish only after EVERY output's data is
durable; the inputs are marked compacted after the last publish. A
crash before the publish point leaves nothing visible to polling and no
input consumed, so a re-run converges. Output bytes equal a sequential
run's: the pipeline reorders work, never data.

The reference records stage walls, occupancy, prefetch outcomes and the
overlap ratio in its kernel telemetry; the port's telemetry plane is
not ported yet, so a `CompactionStats` object holds the same quantities
(TempoDB keeps one across sweeps: `TempoDB.compaction_stats`).
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..backend.base import RawBackend
from ..block.builder import publish_block_meta
from ..ops.device import resolve_device
from .compactor import (
    CompactionJob,
    CompactionResult,
    CompactorConfig,
    _compact_wire,
    compact,
    concat_eligible,
)

DEFAULT_MEM_BUDGET_BYTES = 1 << 30
# a job's estimated peak host RAM over its input bytes (the reference's
# CompactorConfig.pipeline_expansion default; nothing sets another)
EXPANSION = 3.0


def resolve_concurrency(cfg: CompactorConfig) -> int:
    """Worker count: the config, then TEMPO_COMPACT_CONCURRENCY, then 1
    (sequential)."""
    if cfg.concurrency is not None:
        return max(1, int(cfg.concurrency))
    try:
        return max(1, int(os.environ.get("TEMPO_COMPACT_CONCURRENCY", "") or 1))
    except ValueError:
        return 1


def resolve_mem_budget(cfg: CompactorConfig) -> int:
    """Admission budget in bytes: the config, then
    TEMPO_COMPACT_MEM_BUDGET, then 1 GiB."""
    if cfg.pipeline_mem_budget_bytes is not None:
        return max(1, int(cfg.pipeline_mem_budget_bytes))
    try:
        return max(1, int(os.environ.get("TEMPO_COMPACT_MEM_BUDGET", "")
                          or DEFAULT_MEM_BUDGET_BYTES))
    except ValueError:
        return DEFAULT_MEM_BUDGET_BYTES


class CompactionStats:
    """What the reference's kernel telemetry records of the pipeline:
    per-stage wall seconds (fetch, merge, assemble, write, and the
    unstaged concat and wire bodies), jobs and input bytes, jobs and
    estimated bytes in flight and the admission queue's depth (the
    latest, and the peaks), prefetch hits, misses and waste, and runs
    with their walls. overlap_ratio = stage seconds / run wall seconds:
    1.0 is strictly sequential, above 1 stages or jobs overlapped."""

    def __init__(self):
        self._lock = threading.Lock()
        self.runs = 0
        self.wall_seconds = 0.0
        self.jobs = 0
        self.errors = 0
        self.input_bytes = 0
        self.stage_seconds: dict[str, float] = {}
        self.prefetch: dict[str, int] = {}
        self.jobs_inflight = self.bytes_inflight = self.queue_depth = 0
        self.max_jobs_inflight = self.run_max_jobs_inflight = 0
        self.max_bytes_inflight = 0

    def stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + float(seconds)

    def job(self, input_bytes: int, ok: bool) -> None:
        with self._lock:
            if ok:
                self.jobs += 1
                self.input_bytes += int(input_bytes)
            else:
                self.errors += 1

    def prefetched(self, kind: str) -> None:
        """hit: a worker found its inputs preloaded; miss: it fetched them
        itself; waste: a prefetch failed and its IO was thrown away."""
        with self._lock:
            self.prefetch[kind] = self.prefetch.get(kind, 0) + 1

    def inflight(self, jobs: int, est_bytes: int, queued: int) -> None:
        with self._lock:
            self.jobs_inflight, self.bytes_inflight, self.queue_depth = jobs, est_bytes, queued
            self.max_jobs_inflight = max(self.max_jobs_inflight, jobs)
            self.run_max_jobs_inflight = max(self.run_max_jobs_inflight, jobs)
            self.max_bytes_inflight = max(self.max_bytes_inflight, est_bytes)

    def begin_run(self) -> None:
        with self._lock:
            self.run_max_jobs_inflight = 0

    def end_run(self, wall_seconds: float) -> None:
        with self._lock:
            self.runs += 1
            self.wall_seconds += float(wall_seconds)

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: v for k, v in vars(self).items() if not k.startswith("_")}
            out["stage_seconds"] = dict(self.stage_seconds)
            out["prefetch"] = dict(self.prefetch)
        stage_total = sum(out["stage_seconds"].values())
        out["overlap_ratio"] = stage_total / out["wall_seconds"] if out["wall_seconds"] else 0.0
        return out


@dataclass
class JobOutcome:
    """One job's end; exactly one of result and error is set."""

    tenant: str
    job: CompactionJob
    result: CompactionResult | None = None
    error: Exception | None = None


@dataclass
class _Ticket:
    """One scheduled job and its bookkeeping; every mutable field is read
    and written under the pipeline's condition variable."""

    tenant: str
    job: CompactionJob
    est_bytes: int
    fetch_claimed: bool = False  # the prefetcher or a worker owns the fetch
    pf_accounted: bool = False  # est_bytes already charged by the prefetcher
    pf_failed: bool = False  # the prefetch failed; the worker refetches
    blocks: list | None = None  # opened readers, packs preloaded
    fetch_seconds: float = 0.0


class CompactionPipeline:
    """A bounded pipeline over a fixed set of compaction jobs. One
    instance runs one job set (`run`); build one a sweep. Ring ownership
    is the caller's: pass only owned jobs. Outcomes come back in
    admission order; `on_result` (the blocklist update) runs on the
    worker thread as each job commits."""

    def __init__(self, backend: RawBackend, cfg: CompactorConfig, concurrency: int | None = None,
                 device=None, stats: CompactionStats | None = None):
        self.backend = backend
        self.cfg = cfg
        self.device = resolve_device(device)
        self.concurrency = max(1, concurrency if concurrency is not None
                               else resolve_concurrency(cfg))
        self.budget = resolve_mem_budget(cfg)
        self.prefetch_depth = max(0, int(cfg.prefetch_depth))
        self.stats = stats if stats is not None else CompactionStats()
        self._cv = threading.Condition()
        # ---- guarded by _cv ----
        self._tickets: list[_Ticket] = []
        self._next = 0  # admission cursor into _tickets
        self._inflight_jobs = 0
        self._inflight_bytes = 0  # admitted and prefetch-charged estimates
        self._stop = False

    # ------------------------------------------------------------ schedule
    def _round_robin(self, jobs_by_tenant: dict[str, list[CompactionJob]]) -> list[_Ticket]:
        """Deterministic admission order: tenants rotate (sorted), jobs
        first in, first out within a tenant."""
        order = sorted(t for t, jobs in jobs_by_tenant.items() if jobs)
        queues: dict[str, deque] = {t: deque(jobs_by_tenant[t]) for t in order}
        out: list[_Ticket] = []
        while order:
            for t in list(order):
                q = queues[t]
                job = q.popleft()
                est = int(sum(m.size_bytes for m in job.blocks) * EXPANSION)
                out.append(_Ticket(t, job, est_bytes=max(1, est)))
                if not q:
                    order.remove(t)
        return out

    # ---------------------------------------------------------------- run
    def run(self, jobs_by_tenant: dict[str, list[CompactionJob]],
            on_result=None) -> list[JobOutcome]:
        """Run every job; outcomes in admission order. on_result(tenant,
        job, result) runs on the worker thread right after the job's
        commit point (outputs published, inputs marked); an exception
        there turns the outcome into an error."""
        tickets = self._round_robin(jobs_by_tenant)
        if not tickets:
            return []
        self.stats.begin_run()
        t_run = time.perf_counter()
        with self._cv:
            self._tickets = tickets
            self._next = 0
            self._inflight_jobs = 0
            self._inflight_bytes = 0
            self._stop = False
        outcomes: list[JobOutcome | None] = [None] * len(tickets)
        workers = [threading.Thread(target=self._worker, args=(outcomes, on_result),
                                    name=f"compact-worker-{i}", daemon=True)
                   for i in range(min(self.concurrency, len(tickets)))]
        prefetcher = None
        if (self.prefetch_depth > 0 and len(tickets) > 1
                and any(self._prefetchable(t) for t in tickets)):
            # an all-concat sweep has nothing to prefetch
            prefetcher = threading.Thread(target=self._prefetcher, name="compact-prefetch",
                                          daemon=True)
            prefetcher.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if prefetcher is not None:
            prefetcher.join()
        self.stats.inflight(0, 0, 0)
        self.stats.end_run(time.perf_counter() - t_run)
        return [oc for oc in outcomes if oc is not None]

    # ------------------------------------------------------------- workers
    def _worker(self, outcomes: list, on_result) -> None:
        while True:
            with self._cv:
                while True:
                    if self._next >= len(self._tickets):
                        return
                    t = self._tickets[self._next]
                    extra = 0 if t.pf_accounted else t.est_bytes
                    if self._inflight_jobs == 0 or self._inflight_bytes + extra <= self.budget:
                        i = self._next
                        self._next += 1
                        self._inflight_jobs += 1
                        self._inflight_bytes += extra
                        break
                    # woken by releases; the timeout only covers a lost wakeup
                    self._cv.wait(0.1)
                occupancy = (self._inflight_jobs, self._inflight_bytes,
                             len(self._tickets) - self._next)
            self.stats.inflight(*occupancy)
            in_bytes = sum(m.size_bytes for m in t.job.blocks)
            try:
                res = self._run_job(t)
                if on_result is not None:
                    on_result(t.tenant, t.job, res)
                outcomes[i] = JobOutcome(t.tenant, t.job, result=res)
                self.stats.job(in_bytes, ok=True)
            except Exception as e:  # noqa: BLE001 - one job must not kill the sweep
                outcomes[i] = JobOutcome(t.tenant, t.job, error=e)
                self.stats.job(in_bytes, ok=False)
            finally:
                with self._cv:
                    self._inflight_jobs -= 1
                    self._inflight_bytes -= t.est_bytes
                    occupancy = (self._inflight_jobs, self._inflight_bytes,
                                 len(self._tickets) - self._next)
                    self._cv.notify_all()
                self.stats.inflight(*occupancy)

    # ------------------------------------------------------------ prefetch
    def _prefetcher(self) -> None:
        """Open readers and preload small packs for the jobs the workers
        take next: at most prefetch_depth jobs past the active window,
        charged against the admission budget."""
        while True:
            with self._cv:
                if self._stop or self._next >= len(self._tickets):
                    return
                target = None
                hi = min(len(self._tickets), self._next + self.concurrency + self.prefetch_depth)
                for j in range(self._next, hi):
                    c = self._tickets[j]
                    if c.fetch_claimed or not self._prefetchable(c):
                        continue
                    if self._inflight_bytes + c.est_bytes > self.budget:
                        # budget full: no one-job exemption here -- a skipped
                        # prefetch cannot deadlock (workers fetch for
                        # themselves), an exempted one could stack charges
                        continue
                    c.fetch_claimed = True
                    c.pf_accounted = True
                    self._inflight_bytes += c.est_bytes
                    target = c
                    break
                if target is None:
                    self._cv.wait(0.05)
                    continue
            try:
                blocks, dt = self._fetch(target)
            except Exception:  # noqa: BLE001 - the worker refetches and surfaces it
                blocks, dt = None, 0.0
                self.stats.prefetched("waste")
            with self._cv:
                if blocks is None:
                    target.pf_failed = True
                else:
                    target.blocks = blocks
                    target.fetch_seconds = dt
                self._cv.notify_all()

    def _prefetchable(self, t: _Ticket) -> bool:
        """Only columnar jobs take opened readers; concat jobs copy raw
        objects and wire-merge jobs are the rare fallback."""
        return self.cfg.columnar and not concat_eligible(t.job, self.cfg)

    def _fetch(self, t: _Ticket) -> tuple[list, float]:
        """The IO stage: open every input's reader; a small pack preloads
        with one ranged read (_Source.from_block's own preload is then a
        no-op)."""
        from ..block.versioned import open_block_versioned
        from .columnar_compact import _Source

        t0 = time.perf_counter()
        blocks = []
        for m in t.job.blocks:
            b = open_block_versioned(self.backend, m)
            pack = getattr(b, "pack", None)
            if pack is not None and m.size_bytes and m.size_bytes <= _Source.PRELOAD_MAX_BYTES:
                pack.preload()
            blocks.append(b)
        return blocks, time.perf_counter() - t0

    def _take_fetched(self, t: _Ticket) -> list:
        """The fetch stage on the worker's side: the prefetched readers
        (hit), a prefetch in flight waited for, or the IO done here
        (miss)."""
        with self._cv:
            wait_for_pf = t.fetch_claimed
            t.fetch_claimed = True
            while wait_for_pf and t.blocks is None and not t.pf_failed:
                self._cv.wait(0.05)
            blocks = t.blocks
            # tickets outlive their jobs; a kept reader would pin its
            # preloaded pack past the admission budget
            t.blocks = None
        if blocks is not None:
            self.stats.stage("fetch", t.fetch_seconds)
            self.stats.prefetched("hit")
            return blocks
        blocks, dt = self._fetch(t)
        self.stats.stage("fetch", dt)
        self.stats.prefetched("miss")
        return blocks

    # ------------------------------------------------------------ job body
    def _timed(self, stage: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stats.stage(stage, time.perf_counter() - t0)

    def _run_job(self, t: _Ticket) -> CompactionResult:
        """One job through the staged path. Concat and wire-merge jobs run
        their own bodies (already meta last, marked after durable);
        columnar jobs also overlap assemble with write."""
        job, cfg = t.job, self.cfg
        is_concat = concat_eligible(job, cfg)
        if not cfg.columnar or is_concat:
            return self._timed("concat" if is_concat else "wire", compact, self.backend, job,
                               cfg, self.device)
        blocks = self._take_fetched(t)
        from . import columnar_compact as cc

        t0 = time.perf_counter()
        try:
            plan = cc.plan_columnar(self.backend, job, cfg, self.device, blocks=blocks)
        except cc.UnsupportedColumnar:
            self.stats.stage("merge", time.perf_counter() - t0)
            # straight to the wire merge: compact() would fetch and decode
            # every input again only to refuse again
            return self._timed("wire", _compact_wire, self.backend, job, cfg, self.device)
        self.stats.stage("merge", time.perf_counter() - t0)
        try:
            return self._write_outputs(plan, job)
        except cc.UnsupportedColumnar:
            # the assemble can refuse late: straight to the wire merge
            # (compact() would publish early outputs before refusing
            # again); _write_outputs reclaimed its unpublished outputs
            return self._timed("wire", _compact_wire, self.backend, job, cfg, self.device)

    def _write_outputs(self, plan, job: CompactionJob) -> CompactionResult:
        """Assemble and write double-buffered, committed at once: every
        output's data lands (defer_meta) before the first meta.json;
        the inputs are marked after the last publish."""
        from . import columnar_compact as cc

        cfg = self.cfg
        result = CompactionResult()
        metas: list = []
        fins: _queue.Queue = _queue.Queue(maxsize=1)
        werr: list[BaseException] = []

        def writer():
            # drain on after a failure, so the assembler never blocks on
            # put(); the error surfaces after the join
            while True:
                fin = fins.get()
                if fin is None:
                    return
                if werr:
                    continue
                t0 = time.perf_counter()
                try:
                    metas.append(cc.write_output(self.backend, fin, cfg, plan.out_level,
                                                 defer_meta=True))
                except BaseException as e:  # noqa: BLE001 - surfaced after the join
                    werr.append(e)
                finally:
                    self.stats.stage("write", time.perf_counter() - t0)

        wt = threading.Thread(target=writer, name="compact-block-writer", daemon=True)
        wt.start()
        aerr: BaseException | None = None
        try:
            it = cc.iter_outputs(plan, cfg)
            while True:
                t0 = time.perf_counter()
                try:
                    fin = next(it)
                except StopIteration:
                    break
                self.stats.stage("assemble", time.perf_counter() - t0)
                if werr:
                    break
                fins.put(fin)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            aerr = e
        finally:
            fins.put(None)
            wt.join()
        if werr or aerr is not None:
            # unpublished outputs (no meta.json) are invisible to pollers;
            # reclaim their data objects, best effort
            for m in metas:
                try:
                    self.backend.delete_block(m.tenant_id, m.block_id)
                except Exception:  # noqa: BLE001 - cleanup only
                    pass
            raise werr[0] if werr else aerr
        # ---- the commit point ----
        for m in metas:
            publish_block_meta(self.backend, m)
            result.new_blocks.append(m)
            result.traces_out += m.total_traces
            result.spans_out += m.total_spans
        result.compacted_ids = [m.block_id for m in job.blocks]
        for m in job.blocks:
            self.backend.mark_compacted(job.tenant, m.block_id)
        return result
