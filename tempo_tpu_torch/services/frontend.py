"""Query frontend: per-tenant fair queue, job sharding, retry, combine
(port of tempo_tpu/services/frontend.py).

Reference: modules/frontend -- trace-by-ID pipeline (deduper->sharder->
retry, frontend.go:96-183), search sharder (searchsharding.go:69-247),
trace-ID-space sharding (tracebyidsharding.go:30-48), and the per-tenant
queue queriers pull from (v1/frontend.go:50-90, pkg/scheduler/queue).

Jobs carry BOTH a local closure (in-process worker threads, the
single-binary fast path) and a wire form (kind + payload): standalone
querier processes attach over HTTP long-poll (/internal/jobs/poll) and
pull the same queue the local workers drain -- the reference's
querier-worker frontend_processor loop (frontend_processor.go:57-80),
dispatcher and execution fully decoupled.

Search jobs are block BATCHES, not 10-MiB page shards: the device
engine answers a whole batch of blocks in one fused program + one
device sync (db/search.search_blocks_fused: K1 a block, one K2), so the
unit of dispatch is sized to amortize the sync, not to bound a Go
worker's scan time. Oversized single blocks still shard by row-group
range. Same-key jobs drained together run as one coalesced facade call
(search_blocks_multi, search_block_shard_multi, find_in_blocks_multi:
the batchers' fused launches, B5a/B5b and K3 with Q > 1).

Cache-affinity scheduling: block-carrying jobs hash their lead block ID
onto a consistent-hash ring over the live cache domains (this process's
local worker pool + every attached remote querier), and the dequeue
prefers handing a job to its affinity owner so a block staged on one
querier's card (ops/stage staged cache) stays staged there. A bounded
anti-starvation steal timeout (TEMPO_AFFINITY_STEAL_MS) lets any worker
take a job its owner hasn't claimed in time, so a slow or dead owner
never strands work; with affinity off (TEMPO_AFFINITY=0) or a single
cache domain the dequeue path is exactly the legacy head-of-queue
behavior.

What the port leaves out: the JAX package's kernel telemetry
(util/kerneltel, ROADMAP §A item 9) -- `Frontend.stats` counts queries
by op and outcome, QoS sheds, retries, hedge outcomes, affinity
placements and failed jobs by kind instead -- and the self-tracing of
queries (services/selftrace.py, item 9): `self_tracer` stays None, and
setting it raises.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field

from ..backend.base import BackendError, DoesNotExist
from ..db.search import (
    SearchRequest,
    SearchResponse,
    request_to_dict,
    response_from_dict,
)
from ..ring.ring import InMemoryKV, InstanceDesc, InstanceState, Ring, deterministic_tokens
from ..util import knobs as _cfg
from ..util.breaker import CircuitOpen, RetryBudget, get_breaker
from ..util.hashing import fnv1a_32
from ..util.metrics import Histogram, timed
from ..wire.combine import combine_traces, sort_trace
from .overrides import QueryAdmission
from .querier import Querier

TARGET_BATCH_BYTES = 256 << 20  # block-batch job size (device engine unit)
DEFAULT_CONCURRENT_JOBS = 50
MAX_RETRIES = 3
MAX_BLOCKS_PER_BATCH = 64
FIND_SHARD_BLOCKS = 16  # candidate blocks per ID-shard find job

# job kinds that scan backend blocks: the legs the backend circuit
# breaker guards (a shed search shard degrades coverage via the
# existing failed-shard tolerance; find/metrics fail fast -- their
# shard-loss rules forbid silent partials -- instead of hammering a
# dying backend)
BACKEND_KINDS = frozenset(
    {"search_blocks", "search_block_shard", "find_blocks",
     "metrics_query_range"})

AFFINITY_RING_KEY = "querier-affinity"
AFFINITY_SCAN_WINDOW = 64  # queued jobs per tenant an affinity scan inspects


class TooManyRequests(Exception):
    pass


def _retryable(e: Exception) -> bool:
    """Transient (IO / backend / timeout) errors retry; deterministic
    failures (parse errors, bad values, a KernelError) fail fast."""
    if isinstance(e, DoesNotExist):
        return False  # deterministic: the object is gone
    return isinstance(e, (OSError, TimeoutError, ConnectionError, BackendError))


class RequestQueue:
    """Per-tenant fair FIFO: tenants round-robin, jobs FIFO within a
    tenant (pkg/scheduler/queue/queue.go). Drained tenants are pruned
    from the rotation (a churning tenant population used to grow
    self.order without bound, and every dequeue scanned the corpses)."""

    CLAIM_RECHECK_S = 0.02  # re-scan cadence while steal clocks run

    def __init__(self, max_per_tenant: int = 2000):
        # every enqueue/dequeue (and the affinity claim scan)
        # serializes here; the Condition wraps the same lock
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.queues: dict[str, deque] = {}
        self.order: deque[str] = deque()
        self.max_per_tenant = max_per_tenant
        self.closed = False

    def enqueue(self, tenant: str, job) -> None:
        with self.cv:
            q = self.queues.get(tenant)
            if q is None:
                q = self.queues[tenant] = deque()
                self.order.append(tenant)
            if len(q) >= self.max_per_tenant:
                raise TooManyRequests(f"tenant {tenant} queue full")  # 429
            q.append(job)
            try:
                # a re-dispatched job must not carry its previous
                # dequeue's placement: the next dequeue stamps its own
                # (or none, on the legacy path) -- stale "own" would
                # double-count the placement counters
                job.placement = ""
            except AttributeError:
                pass
            if getattr(job, "queued_at", None) == 0.0:
                # steal clock starts at FIRST enqueue only: a hedged
                # twin keeps its original stamp (long past the steal
                # window by hedge time) and a retried job is demoted to
                # placement-free by the retry paths -- re-dispatch
                # exists precisely to dodge the owner that failed it
                job.queued_at = time.monotonic()
            # notify_all, not notify: under affinity a single wakeup can
            # land on a non-owner that defers the job and goes back to
            # waiting -- the sleeping owner would never hear about its
            # own job and every dequeue would pay the steal timeout
            self.cv.notify_all()

    def depths(self) -> dict[str, int]:
        """Per-tenant queue depth snapshot -- the fleet's autoscaling
        SLI (tempo_query_queue_depth): sustained depth means the
        querier pool is under-provisioned for the offered load."""
        with self.cv:
            return {t: len(q) for t, q in self.queues.items() if q}

    def _prune_locked(self, tenant: str, q) -> None:
        """Drop a drained tenant from both maps (invariant: a tenant is
        in self.order iff it has a non-empty deque)."""
        if not q:
            self.queues.pop(tenant, None)
            try:
                self.order.remove(tenant)
            except ValueError:
                pass

    def dequeue(self, timeout: float = 0.5, allowed=None, claim=None):
        """Next (tenant, job), fair across tenants; allowed(tenant) False
        skips a tenant for THIS caller (per-tenant querier shuffle-shard,
        pkg/scheduler/queue/user_queues.go). claim(tenant, job, now) ->
        placement string | None gates WHICH job this caller may take (block->
        querier affinity): the first claimable job within
        AFFINITY_SCAN_WINDOW of each tenant's FIFO is taken and stamped
        with its placement; jobs deferred to their owner are re-checked
        every CLAIM_RECHECK_S so steal timeouts fire without a notify.
        claim=None (affinity off / single cache domain) is exactly the
        legacy head-of-queue path."""
        with self.cv:
            if claim is None:
                while True:
                    item = self._take_head_locked(allowed)
                    if item is not None:
                        return item
                    if self.closed:
                        return None
                    if not self.cv.wait(timeout):
                        return None
            deadline = time.monotonic() + timeout
            while True:
                item, deferred = self._take_claimed_locked(allowed, claim)
                if item is not None:
                    return item
                if self.closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self.cv.wait(min(remaining, self.CLAIM_RECHECK_S)
                             if deferred else remaining)

    def _take_head_locked(self, allowed):
        """One fair pass taking the head job of the first allowed
        tenant -- the pre-affinity dequeue, byte for byte."""
        n = len(self.order)
        scanned = 0
        while scanned < n:
            tenant = self.order[0]
            q = self.queues.get(tenant)
            if not q:
                # drained (or orphaned) rotation slot: prune it
                self.order.popleft()
                self.queues.pop(tenant, None)
                n -= 1
                continue
            self.order.rotate(-1)
            scanned += 1
            if allowed is None or allowed(tenant):
                job = q.popleft()
                self._prune_locked(tenant, q)
                return tenant, job
        return None

    def _take_claimed_locked(self, allowed, claim):
        """One fair pass under affinity: per tenant, take the first job
        (within the scan window) the claimer may have. claim(tenant,
        job, now) sees the tenant because ownership is resolved within
        the tenant's reachable worker subset (querier shuffle-shard).
        Returns ((tenant, job), False) or (None, deferred) where
        deferred means jobs exist that only their owner (or the steal
        clock) can release."""
        now = time.monotonic()
        deferred = False
        n = len(self.order)
        scanned = 0
        while scanned < n:
            tenant = self.order[0]
            q = self.queues.get(tenant)
            if not q:
                self.order.popleft()
                self.queues.pop(tenant, None)
                n -= 1
                continue
            self.order.rotate(-1)
            scanned += 1
            if allowed is not None and not allowed(tenant):
                continue
            for i, job in enumerate(q):
                if i >= AFFINITY_SCAN_WINDOW:
                    break
                placement = claim(tenant, job, now)
                if placement:
                    del q[i]
                    try:
                        job.placement = placement
                    except AttributeError:
                        pass
                    self._prune_locked(tenant, q)
                    return (tenant, job), False
            deferred = True
        return None, deferred

    def dequeue_batch(self, timeout: float = 0.5, allowed=None,
                      max_batch: int = 1, key_fn=None, claim=None):
        """Fair dequeue of one job plus up to max_batch-1 ALREADY-QUEUED
        jobs sharing its coalesce key (key_fn(job), None = unbatchable),
        collected in one pass over the tenant rotation -- fairness within
        the window means every tenant's matching head jobs join the same
        fused launch rather than queueing behind it. Never waits for
        more jobs, so a lone query is never delayed here (the admission
        window lives in db/batchexec). Under affinity (claim) the
        same-key extras ride the lead's claim wherever they sit in the
        scan window: same blocks means same owner, so a coalesced
        multi-query launch lands whole on the warm staged cache.
        Returns (tenant, job, extras) where extras is a list of
        (tenant, job)."""
        item = self.dequeue(timeout, allowed, claim=claim)
        if item is None:
            return None
        tenant, job = item
        extras: list = []
        key = key_fn(job) if key_fn is not None else None
        if key is not None and max_batch > 1:
            lead_placement = getattr(job, "placement", "")
            with self.cv:
                for _ in range(len(self.order)):
                    if len(extras) >= max_batch - 1 or not self.order:
                        break
                    t2 = self.order[0]
                    self.order.rotate(-1)
                    q = self.queues.get(t2)
                    if not q or (allowed is not None and not allowed(t2)):
                        continue
                    if claim is None:
                        while (q and len(extras) < max_batch - 1
                               and key_fn(q[0]) == key):
                            extras.append((t2, q.popleft()))
                    else:
                        i = 0
                        while (i < min(len(q), AFFINITY_SCAN_WINDOW)
                               and len(extras) < max_batch - 1):
                            if key_fn(q[i]) == key:
                                j2 = q[i]
                                del q[i]
                                try:
                                    j2.placement = lead_placement
                                except AttributeError:
                                    pass
                                extras.append((t2, j2))
                            else:
                                i += 1
                    self._prune_locked(t2, q)
        return tenant, job, extras

    def close(self):
        with self.cv:
            self.closed = True
            self.cv.notify_all()


@dataclass
class _Job:
    kind: str  # wire kind: search_recent|search_blocks|search_block_shard|
    # find_recent|find_blocks|metrics_query_range
    payload: dict  # wire-shippable arguments (ids, not objects)
    fn: object  # local execution closure (in-process workers)
    args: tuple
    result: object = None
    error: Exception | None = None
    done: threading.Event = field(default_factory=threading.Event)
    tries: int = 0
    cancelled: bool = False
    hedged: bool = False
    enqueued_at: float = 0.0  # monotonic (hedging)
    batch_cv: threading.Condition | None = None
    # cross-query coalescing: jobs sharing a non-None batch_key target
    # the same data unit (block batch / shard / candidate partition) and
    # may execute together via batch_fn(group) -> list of results
    batch_key: tuple | None = None
    batch_fn: object = None
    # progressive delivery: a streaming collector's condition, notified
    # (in addition to batch_cv) whenever this job finishes so partial
    # results flush to the client as each shard completes
    stream_cv: threading.Condition | None = None
    # cache-affinity scheduling: the block ID this job's placement
    # hashes on (None = placement-free, claimable by anyone), the
    # monotonic stamp its steal clock runs from (set at first enqueue),
    # and the dequeue outcome ("own"/"steal"/"unowned") it executed under
    affinity_key: str | None = None
    queued_at: float = 0.0
    placement: str = ""
    # resilience plane: the query-wide retry budget this job draws
    # from, the caller's wall-clock deadline (rides the wire job so
    # remote workers skip work nobody can use), and hedge attribution
    # (exec_seq counts dispatches; the leg that lands the result says
    # whether the hedge twin won, lost, or never even started)
    retry_budget: object = None
    deadline_unix: float = 0.0
    exec_seq: int = 0
    hedge_started: bool = False
    hedge_outcome: str = ""
    lease_redispatched: bool = False  # re-enqueued by lease expiry

    def finish(self) -> None:
        self.done.set()
        cv = self.batch_cv
        if cv is not None:
            with cv:
                cv.notify_all()
        scv = self.stream_cv
        if scv is not None:
            with scv:
                scv.notify_all()


def decode_job_result(kind: str, out: dict):
    """Wire result -> the object the local closure would have returned."""
    if kind == "metrics_query_range":
        from ..db.metrics_exec import response_from_dict as metrics_response_from_dict

        return metrics_response_from_dict(out)
    if kind.startswith("search"):
        return response_from_dict(out)
    tr = out.get("trace")
    if not tr:
        return None
    from ..wire import otlp_json

    return otlp_json.loads(tr)


class Frontend:
    """Owns the queue + sharding logic; local worker threads and remote
    querier processes both pull from the queue."""

    def __init__(self, querier: Querier, n_workers: int = 8,
                 concurrent_jobs: int = DEFAULT_CONCURRENT_JOBS,
                 batch_bytes: int = TARGET_BATCH_BYTES,
                 hedge_after_s: float = 2.0,
                 lease_s: float = 30.0,
                 overrides=None,
                 worker_expiry_s: float = 60.0,
                 affinity: bool | None = None,
                 affinity_steal_ms: float | None = None):
        self.querier = querier
        self.queue = RequestQueue()
        self.concurrent_jobs = concurrent_jobs
        self.batch_bytes = batch_bytes
        self.hedge_after_s = hedge_after_s
        self.lease_s = lease_s
        self.overrides = overrides
        self.worker_expiry_s = worker_expiry_s
        # block->querier affinity routing (None = TEMPO_AFFINITY env,
        # default on; it is a no-op until a second cache domain appears)
        if affinity is None:
            affinity = _cfg.get("TEMPO_AFFINITY") != "0"
        self.affinity_enabled = affinity
        if affinity_steal_ms is None:
            affinity_steal_ms = _cfg.get_float("TEMPO_AFFINITY_STEAL_MS")
        self.affinity_steal_ms = affinity_steal_ms
        self._aff_ring = Ring(InMemoryKV(), AFFINITY_RING_KEY)
        self._aff_descs: dict[str, InstanceDesc] = {}  # member -> tokens
        self._local_member = "local" if n_workers > 0 else None
        # per-tenant read QoS (concurrency / inflight-byte budgets):
        # overrides-driven, so without overrides there is no gate
        self.qos = QueryAdmission(overrides) if overrides is not None else None
        self._remote_workers: dict[str, float] = {}  # worker id -> last poll
        # backend-leg circuit breaker (util/breaker): block-scanning
        # jobs shed fast onto the shard-degradation path while the
        # backend is dying, with half-open probes for recovery
        self.backend_breaker = get_breaker("backend")
        # lease id -> ([(tenant, job), ...], expiry, [exec_seq, ...]);
        # a `multi` wire job leases its whole merged batch under one id
        self._leases: dict[str, tuple] = {}
        self._lease_lock = threading.Lock()
        self.stats_jobs_remote = 0
        self.stats_jobs_local = 0
        # what the JAX package records in its kernel telemetry: queries
        # by op and outcome, QoS sheds by tenant and budget, retries
        # (granted / budget exhausted), hedge outcomes, dequeue
        # placements, and jobs that ended with an error, by kind
        self.stats = {"queries": {}, "shed": {}, "retries": {}, "hedges": {},
                      "placements": {}, "jobs_failed": {}}
        self._stats_lock = threading.Lock()
        self.query_latency = Histogram("tempo_frontend_query_duration_seconds")
        # Tier A result cache, AHEAD of queue admission: a hit answers
        # without touching QoS budgets, the queue, or a device. With
        # TEMPO_RESULT_CACHE=0 no cache object exists at all and every
        # query path below is byte-identical to a cacheless build. The
        # app points live_gen at the local ingester when one exists.
        if _cfg.get_bool("TEMPO_RESULT_CACHE"):
            from .resultcache import ResultCache

            # blocklists without a generation feed (stub queriers in
            # tests) get a constant generation: the cache still keys
            # correctly, it just can't observe block churn -- the real
            # db.Blocklist always provides one
            bl_gen = getattr(
                getattr(querier.db, "blocklist", None), "generation", None)
            self.result_cache = ResultCache(
                blocklist_gen=bl_gen or (lambda t: 0))
        else:
            self.result_cache = None
        self._workers = [
            threading.Thread(target=self._worker, daemon=True, name=f"frontend-worker-{i}")
            for i in range(n_workers)
        ]
        for w in self._workers:
            w.start()

    @property
    def self_tracer(self):
        """Always None: the self-tracing plane is not ported."""
        return None

    @self_tracer.setter
    def self_tracer(self, tracer) -> None:
        raise ValueError("self-tracing of queries needs services/selftrace.py, which the port "
                         "does not have yet (ROADMAP §A item 9)")

    def _count(self, section: str, *key: str) -> None:
        """One more in stats[section] under the nested key."""
        with self._stats_lock:
            d = self.stats[section]
            for k in key[:-1]:
                d = d.setdefault(k, {})
            d[key[-1]] = d.get(key[-1], 0) + 1

    def _job_failed(self, job, e: Exception) -> None:
        """Stamp a job's final error (unless a hedge twin already won)
        and count it by kind."""
        if not job.done.is_set():
            job.error = e
            self._count("jobs_failed", job.kind)

    # --------------------------------------------------- affinity routing
    def _affinity_members(self) -> list[InstanceDesc]:
        """The live cache domains jobs can be placed on: this process
        (when it runs local workers -- its threads share one staged
        cache) plus every remote querier that polled within
        worker_expiry_s. Token sets are deterministic per member id, so
        every frontend replica computes the same placement."""
        now = time.monotonic()
        members = [self._local_member] if self._local_member else []
        out = []
        with self._lease_lock:
            remote = [w for w, t in self._remote_workers.items()
                      if now - t < self.worker_expiry_s]
            members += sorted(remote)
            live = set(members)
            for m in list(self._aff_descs):
                if m not in live:  # churned worker ids must not accumulate
                    del self._aff_descs[m]
            for m in members:
                d = self._aff_descs.get(m)
                if d is None:
                    d = self._aff_descs[m] = InstanceDesc(
                        instance_id=m, state=InstanceState.ACTIVE,
                        tokens=deterministic_tokens(AFFINITY_RING_KEY, m))
                out.append(d)
        return out

    def _claimer(self, member: str):
        """Build claim(tenant, job, now) for one dequeue pass by
        `member`, or None when affinity is off or there is at most one
        cache domain (the legacy dequeue, preserved exactly). Ownership
        is resolved within the tenant's REACHABLE domains: with querier
        shuffle-shard on, a block is placed on the shard-member subset
        (plus the local pool, which shuffle-shard never filters), never
        on a worker the tenant's jobs can't be handed to -- otherwise
        every such job would pay the full steal timeout for an owner
        that can never claim it. Lookups memoize per pass -- one ring
        walk per distinct (tenant, block) per dequeue."""
        if not self.affinity_enabled or not member:
            return None
        members = self._affinity_members()
        if len(members) <= 1:
            return None
        ring = self._aff_ring
        steal_s = self.affinity_steal_ms / 1000.0
        owners: dict[tuple[str, str], str | None] = {}
        shards: dict[str, list[InstanceDesc]] = {}

        def shard_members(tenant: str) -> list[InstanceDesc]:
            ms = shards.get(tenant)
            if ms is None:
                ms = shards[tenant] = [
                    d for d in members
                    if d.instance_id == self._local_member
                    or self._tenant_allowed(tenant, d.instance_id)]
            return ms

        def claim(tenant: str, job, now: float) -> str | None:
            key = getattr(job, "affinity_key", None)
            if not key:
                return "unowned"
            ck = (tenant, key)
            if ck in owners:
                owner = owners[ck]
            else:
                owner = owners[ck] = ring.owner_of(
                    key, instances=shard_members(tenant))
            if owner == member:
                return "own"
            if owner is None:
                return "unowned"
            queued = getattr(job, "queued_at", 0.0)
            if queued and now - queued < steal_s:
                return None  # owner's job; steal clock still running
            return "steal"

        return claim

    def _note_placements(self, jobs: list) -> None:
        """Count dequeue placements."""
        for j in jobs:
            p = getattr(j, "placement", "")
            if p:
                self._count("placements", p)

    # ------------------------------------------------------ per-tenant QoS
    def _qos_admit(self, tenant: str, est_bytes: int) -> int:
        """Admit one query against the tenant's QoS budgets; returns the
        byte charge release() must return (0 when no gate is wired).
        Sheds with TooManyRequests (the HTTP layer's 429)."""
        if self.qos is None:
            return 0
        refused = self.qos.try_admit(tenant, est_bytes)
        if refused is not None:
            self._count("shed", tenant, refused)
            raise TooManyRequests(
                f"tenant {tenant} over per-tenant {refused} budget")
        return est_bytes

    def _qos_release(self, tenant: str, est_bytes: int) -> None:
        if self.qos is not None:
            self.qos.release(tenant, est_bytes)

    # ------------------------------------------------------- local workers
    WORKER_DEQUEUE_BATCH = 16  # same-key jobs one worker drains per pull

    def _worker(self):
        while True:
            item = self.queue.dequeue_batch(
                timeout=1.0, max_batch=self.WORKER_DEQUEUE_BATCH,
                key_fn=lambda j: j.batch_key,
                claim=self._claimer(self._local_member or ""))
            if item is None:
                if self.queue.closed:
                    return
                continue
            tenant, job, extras = item
            self._note_placements([job] + [j for _, j in extras])
            if extras and job.batch_fn is not None:
                self._execute_batch([(tenant, job)] + extras)
                continue
            self._execute_one(tenant, job)
            for t2, j2 in extras:  # batch_fn-less jobs never batch
                self._execute_one(t2, j2)

    def _execute_batch(self, group: list) -> None:
        """Run same-key jobs as ONE multi-job call (the coalesced db
        APIs); any failure degrades to per-job execution so a batch is
        never worse than the jobs run singly."""
        live = []
        for t, j in group:
            if j.cancelled or j.done.is_set():
                j.finish()
            else:
                live.append((t, j))
        if not live:
            return
        br = self._breaker_for(live[0][1].kind)
        if br is not None and br.state != "closed":
            # open/half-open: run the group per job so breaker probe
            # accounting stays one allow() per call -- a fused batch
            # would ram N block scans through one half-open probe slot
            # (and close the breaker off N records from one grant)
            for t, j in live:
                self._execute_one(t, j)
            return
        seqs: dict[int, int] = {}
        for _, j in live:
            j.exec_seq += 1
            seqs[id(j)] = j.exec_seq
            if j.exec_seq >= 2:
                j.hedge_started = True
        lead = live[0][1]
        try:
            results = lead.batch_fn(live)
        except Exception:  # noqa: BLE001 - a failed batch degrades to per-job runs below
            results = None
        if isinstance(results, list) and len(results) == len(live):
            for (t, j), r in zip(live, results):
                if isinstance(r, Exception):
                    # per-item failure inside the batch: same retry
                    # policy as single execution, isolated to this job
                    if br is not None and _retryable(r):
                        br.record(False)
                    self._fail_job(t, j, r)
                    continue
                if br is not None:
                    br.record(True)
                self._note_result(j, seqs.get(id(j), 1))
                if not j.done.is_set():
                    j.result = r
                self.stats_jobs_local += 1
                j.finish()
        else:
            for t, j in live:
                self._execute_one(t, j)

    def _breaker_for(self, kind: str):
        """The backend-leg breaker for block-scanning kinds."""
        return self.backend_breaker if kind in BACKEND_KINDS else None

    def _grant_retry(self, job) -> bool:
        """One more dispatch for a retryable shard failure? The per-
        query RetryBudget caps TOTAL retries across all of a query's
        jobs, so a dying backend can't amplify one query into a
        jobs x MAX_RETRIES storm."""
        b = job.retry_budget
        if b is None or b.take():
            self._count("retries", "retry")
            return True
        self._count("retries", "budget_exhausted")
        return False

    def _note_result(self, job, seq: int) -> None:
        """Hedge attribution, called by the execution leg that produced
        a result BEFORE publishing it: on the first completion of a
        hedged job, say whether the twin won (seq >= 2), lost (the
        original won after the twin started), or was unneeded (the
        original won before the twin ever ran). A job that also
        RETRIED is left unattributed: retry re-dispatches share the
        exec_seq counter, so a retry completion would masquerade as a
        hedge win exactly in the fault regimes hedging is watched in."""
        if not job.hedged or job.done.is_set() or job.hedge_outcome:
            return
        if job.tries or job.lease_redispatched:
            return
        if seq >= 2:
            outcome = "win"
        elif job.exec_seq >= 2 or job.hedge_started:
            outcome = "lose"
        else:
            outcome = "unneeded"
        job.hedge_outcome = outcome
        self._count("hedges", outcome)

    def _fail_job(self, tenant: str, job, e: Exception) -> None:
        """Apply the single-job failure policy (transient -> re-enqueue
        up to MAX_RETRIES within the query's retry budget, else error)
        to one job."""
        if job.done.is_set():
            return
        job.tries += 1
        if _retryable(e) and job.tries < MAX_RETRIES and self._grant_retry(job):
            try:
                job.affinity_key = None  # retry dodges the failing owner
                self.queue.enqueue(tenant, job)
                return
            except TooManyRequests:
                pass
        # re-check inside: a hedge twin may have succeeded while we
        # attempted the re-enqueue -- its result must not be clobbered
        # with an error the waiter would raise
        self._job_failed(job, e)
        job.finish()

    def _execute_one(self, tenant: str, job) -> None:
        if job.cancelled or job.done.is_set():
            job.finish()
            return
        if job.deadline_unix and time.time() > job.deadline_unix:
            # the caller's deadline already passed: don't burn an
            # engine pass nobody can use. Stamp the SAME TimeoutError
            # the dispatch deadline does -- a silently-cancelled shard
            # would let find/metrics return partial results their
            # shard-loss rule forbids
            self._job_failed(job, TimeoutError("query deadline exceeded before execution"))
            job.cancelled = True
            job.finish()
            return
        br = self._breaker_for(job.kind)
        if br is not None and not br.allow():
            # shed fast onto the shard-degradation path: search merges
            # what the healthy shards return; CircuitOpen is not
            # retryable, so the job never re-enters the open breaker
            self._job_failed(job, CircuitOpen("backend circuit breaker open"))
            job.finish()
            return
        job.exec_seq += 1
        seq = job.exec_seq
        if seq >= 2:
            job.hedge_started = True
        try:
            res = job.fn(*job.args)
            if br is not None:
                br.record(True)
            self._note_result(job, seq)
            if not job.done.is_set():
                job.result = res
            self.stats_jobs_local += 1
        except Exception as e:  # noqa: BLE001 - the job's failure policy decides
            # retry only transient failures (reference retries 5xx
            # only, modules/frontend/retry.go); a parse error or bad
            # argument fails identically every try. A hedge twin's
            # failure must never clobber its sibling's success.
            # Breaker food is TRANSIENT IO failures only: a device
            # fault / bad query failing a block job says nothing about
            # backend health and must not open the backend leg.
            if br is not None and _retryable(e):
                br.record(False)
            self._fail_job(tenant, job, e)
            return
        job.finish()

    # -------------------------------------------- coalesced job execution
    def _batch_search_blocks(self, group: list) -> list:
        """Same-key search_blocks jobs -> one multi-request db call (the
        batching executor fuses eligible ones into one launch)."""
        return self.querier.search_blocks_multi(
            [(j.args[0], j.args[1], j.args[2]) for _, j in group])

    def _batch_search_shards(self, group: list) -> list:
        return self.querier.search_block_shard_multi(
            [(j.args[0], j.args[1], j.args[2], j.args[3]) for _, j in group])

    def _batch_find_blocks(self, group: list) -> list:
        return self.querier.find_in_blocks_multi(
            [(j.args[0], j.args[1], j.args[2]) for _, j in group])

    # ------------------------------------------------ remote querier pull
    def _tenant_allowed(self, tenant: str, worker_id: str) -> bool:
        """Per-tenant querier shuffle-shard: with max_queriers_per_tenant
        set, each tenant's jobs go to a deterministic subset of the
        currently-attached workers (user_queues.go). Subsets re-shuffle
        as workers come and go, and every tenant always has at least one
        live assigned worker by construction."""
        if not worker_id or self.overrides is None:
            return True
        k = self.overrides.for_tenant(tenant).max_queriers_per_tenant
        if k <= 0:
            return True
        now = time.monotonic()
        with self._lease_lock:
            self._remote_workers = {
                w: t for w, t in self._remote_workers.items()
                if now - t < self.worker_expiry_s
            }
            workers = sorted(self._remote_workers)
        if k >= len(workers):
            return True
        rng = random.Random(fnv1a_32(tenant.encode()))
        return worker_id in rng.sample(workers, k)

    REMOTE_BATCH_MAX = 8  # same-key jobs merged into one wire pull

    def poll_job(self, wait_s: float = 5.0, worker_id: str = ""):
        """Long-poll dequeue for a remote querier worker
        (frontend_processor.go's stream recv). Returns a wire job dict
        or None on timeout. Same-key jobs queued at poll time merge into
        ONE `multi` wire job (the remote face of the batch-aware
        dequeue), leased together. Expired leases re-enter the queue
        first. Affinity: this worker prefers jobs whose block hashes to
        it on the cache-domain ring; a peer's jobs become claimable only
        past the steal timeout. The wire job carries the dequeue
        placement."""
        if worker_id:
            with self._lease_lock:
                self._remote_workers[worker_id] = time.monotonic()
        self._requeue_expired()
        allowed = (lambda t: self._tenant_allowed(t, worker_id)) if worker_id else None
        deadline = time.monotonic() + wait_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            item = self.queue.dequeue_batch(
                timeout=min(remaining, 1.0), allowed=allowed,
                max_batch=self.REMOTE_BATCH_MAX,
                key_fn=lambda j: j.batch_key,
                claim=self._claimer(worker_id))
            if item is None:
                if self.queue.closed:
                    return None
                continue
            tenant, job, extras = item
            pairs = []
            for t, j in [(tenant, job)] + list(extras):
                if j.cancelled or j.done.is_set():
                    j.finish()
                elif (j.kind in BACKEND_KINDS
                      and not self._breaker_for(j.kind).allow()):
                    # remote pulls shed at the same breaker as local
                    # workers: an open backend breaker means NOBODY
                    # scans blocks, not just this process
                    self._job_failed(j, CircuitOpen("backend circuit breaker open"))
                    j.finish()
                else:
                    pairs.append((t, j))
            if not pairs:
                continue
            self._note_placements([j for _, j in pairs])
            seqs = []
            for _, j in pairs:
                j.exec_seq += 1
                seqs.append(j.exec_seq)
                if j.exec_seq >= 2:
                    j.hedge_started = True
            jid = uuid.uuid4().hex
            with self._lease_lock:
                self._leases[jid] = (pairs, time.monotonic() + self.lease_s,
                                     seqs)
            placement = pairs[0][1].placement
            # deadline propagation, gRPC-style RELATIVE budget: the
            # remaining seconds at dispatch ride the wire job, so the
            # worker's skip decision never depends on clock agreement
            # between the two hosts. A merged multi job spans SEVERAL
            # queries, so it carries the MAX: the worker may only skip
            # when every window-mate's caller has given up
            deadlines = [j.deadline_unix for _, j in pairs
                         if j.deadline_unix]
            deadline_in_s = (round(max(deadlines) - time.time(), 3)
                             if deadlines else None)
            if len(pairs) == 1:
                t0, j0 = pairs[0]
                return {"id": jid, "tenant": t0, "kind": j0.kind,
                        "payload": j0.payload, "placement": placement,
                        "deadline_in_s": deadline_in_s}
            return {"id": jid, "tenant": pairs[0][0], "kind": "multi",
                    "placement": placement, "deadline_in_s": deadline_in_s,
                    "payload": {"kind": pairs[0][1].kind,
                                "tenants": [t for t, _ in pairs],
                                "jobs": [j.payload for _, j in pairs]}}

    def complete_job(self, jid: str, ok: bool, result: dict | None = None,
                     error: str = "", retryable: bool = False,
                     skipped: bool = False) -> None:
        """Remote worker posts a job result (or a `multi` result list,
        demuxed per leased job). Unknown/expired lease ids are dropped
        (the job was re-dispatched or timed out)."""
        with self._lease_lock:
            lease = self._leases.pop(jid, None)
        if lease is None:
            return
        pairs, _, lease_seqs = lease
        # whether this result actually EXERCISED the backend: worker-
        # side deadline skips and (below) undecodable/short results are
        # client/worker faults -- feeding them to the backend breaker
        # would let a backlogged queue or a buggy worker trip it and
        # shed block scans while the object store is perfectly healthy
        backend_exercised = not skipped
        results: list = [result or {}]
        if ok and len(pairs) > 1:
            results = (result or {}).get("results") or []
            if len(results) != len(pairs):
                ok, retryable = False, True
                error = error or "multi result arity mismatch"
                backend_exercised = False
        for i, (tenant, job) in enumerate(pairs):
            if job.done.is_set():
                continue
            job_ok, job_retryable, job_error = ok, retryable, error
            job_exercised = backend_exercised
            # results may be short (worker posted ok=False, or a multi
            # arity mismatch): never index past it -- every leased job
            # must still reach the retry/fail policy below, not hang
            # until the dispatch deadline on an IndexError
            if len(pairs) == 1:
                res_i = results[0]
            else:
                res_i = results[i] if i < len(results) else None
            if job_ok and isinstance(res_i, dict) and "__job_error__" in res_i:
                # per-job failure marker from a multi worker: only THIS
                # job fails/retries, its window-mates keep their results
                job_ok = False
                job_retryable = bool(res_i.get("__retryable__"))
                job_error = str(res_i["__job_error__"])
            elif job_ok:
                try:
                    decoded = decode_job_result(job.kind, res_i)
                except Exception as e:  # noqa: BLE001 - malformed result from a buggy worker:
                    # a retryable failure, so the request doesn't hang
                    # with its lease already popped
                    job_ok, job_retryable = False, True
                    job_error = f"undecodable result: {e}"
                    job_exercised = False  # worker bug, not a backend one
                else:
                    self._note_result(
                        job, lease_seqs[i] if i < len(lease_seqs) else 1)
                    job.result = decoded
                    self.stats_jobs_remote += 1
            # breaker food is results that exercised the backend AND
            # (on failure) look transient -- deterministic failures
            # (bad query, missing object) say nothing about its health
            if job_exercised and (job_ok or job_retryable):
                br = self._breaker_for(job.kind)
                if br is not None:
                    br.record(job_ok)
            if not job_ok:
                job.tries += 1
                if (job_retryable and job.tries < MAX_RETRIES
                        and self._grant_retry(job)):
                    try:
                        # demote to placement-free: a sick-but-alive
                        # owner polls fastest right after failing and
                        # would win its own job back every retry inside
                        # the steal window
                        job.affinity_key = None
                        self.queue.enqueue(tenant, job)
                        continue
                    except TooManyRequests:
                        pass
                self._job_failed(job, RuntimeError(job_error or "remote job failed"))
            job.finish()

    def _requeue_expired(self) -> None:
        now = time.monotonic()
        expired = []
        with self._lease_lock:
            for jid, (pairs, exp, _seqs) in list(self._leases.items()):
                if exp < now:
                    expired.extend(pairs)
                    del self._leases[jid]
        for tenant, job in expired:
            if not (job.done.is_set() or job.cancelled):
                try:
                    job.lease_redispatched = True
                    self.queue.enqueue(tenant, job)
                except TooManyRequests:
                    self._job_failed(job, TimeoutError("job lease expired, queue full"))
                    job.finish()

    # ---------------------------------------------------------- dispatch
    @staticmethod
    def _retry_budget_total(n_jobs: int) -> int:
        """Per-query retry cap: enough to absorb transient faults on a
        few shards, sublinear in fan-out so a dying backend sees
        additive (not multiplicative) retry load. TEMPO_RETRY_BUDGET
        overrides."""
        env = _cfg.get_int("TEMPO_RETRY_BUDGET")
        return env if env > 0 else max(4, n_jobs // 4)

    def _run_jobs(self, tenant: str, jobs: list[_Job], early_exit=None,
                  timeout: float = 60.0) -> None:
        """Enqueue with bounded in-flight jobs, reap completions in ANY
        order (one slow shard no longer stalls dispatch), hedge jobs
        stuck past hedge_after_s, and cancel everything at the deadline
        so late workers see job.cancelled and skip. Every job shares
        one RetryBudget (total retries per QUERY, not per job) and
        carries the wall-clock deadline so remote workers skip jobs
        whose caller already gave up."""
        cv = threading.Condition()
        budget = RetryBudget(self._retry_budget_total(len(jobs)))
        deadline_unix = time.time() + timeout
        for j in jobs:
            j.batch_cv = cv
            j.retry_budget = budget
            j.deadline_unix = deadline_unix
        deadline = time.monotonic() + timeout
        pending = list(jobs)
        inflight: list[_Job] = []
        while pending or inflight:
            if early_exit is not None and early_exit():
                for j in pending:
                    j.cancelled = True
                    j.finish()
                pending = []
            while pending and len(inflight) < self.concurrent_jobs:
                j = pending.pop(0)
                j.enqueued_at = time.monotonic()
                self.queue.enqueue(tenant, j)
                inflight.append(j)
            inflight = [j for j in inflight if not j.done.is_set()]
            if not inflight and not pending:
                break
            now = time.monotonic()
            if now >= deadline:
                for j in inflight + pending:
                    self._job_failed(j, TimeoutError("query job timed out"))
                    j.cancelled = True
                    j.finish()
                break
            if self.hedge_after_s > 0:
                for j in inflight:
                    if not j.hedged and now - j.enqueued_at > self.hedge_after_s:
                        j.hedged = True  # re-enqueue; first completion wins
                        try:
                            self.queue.enqueue(tenant, j)
                        except TooManyRequests:
                            pass
            with cv:
                cv.wait(min(0.25, deadline - now))

    def _observe(self, op: str, label: str, t0: float, outcome: str) -> None:
        """One finished query: its wall into the latency histogram, its
        outcome into stats["queries"]."""
        self.query_latency.observe(time.perf_counter() - t0, label)
        self._count("queries", op, outcome)

    # ----------------------------------------------------------- trace by id
    def find_trace_by_id(self, tenant: str, trace_id: bytes,
                         time_start: int = 0, time_end: int = 0):
        """ID-sharded lookup: one ingester-leg job plus the candidate
        blocks partitioned into parallel backend jobs, partial traces
        combined (tracebyidsharding.go:30-48 splits the ID space; here
        the candidate block set IS the shardable space, since the device
        engine answers a whole partition in one batched lookup)."""
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            return self._find_trace_by_id(tenant, trace_id, time_start, time_end)
        except TooManyRequests:
            outcome = "shed"  # QoS budget refusal, not a serving failure
            raise
        except Exception:
            outcome = "error"
            raise
        finally:
            self._observe("traces", 'op="traces"', t0, outcome)

    def _find_trace_by_id(self, tenant: str, trace_id: bytes,
                          time_start: int = 0, time_end: int = 0):
        rc = self.result_cache
        if rc is None:
            return self._find_trace_exec(tenant, trace_id, time_start, time_end)
        hex_id = trace_id.hex()
        tr = rc.probe_trace(tenant, hex_id, time_start, time_end)
        if tr is not None:
            return tr
        tr = self._find_trace_exec(tenant, trace_id, time_start, time_end)
        if tr is not None:
            # sized by span count (a serialization pass per store would
            # cost more than the lookup it saves); ~1KiB/span wire-side
            rc.store_trace(tenant, hex_id, time_start, time_end, tr,
                           nbytes=max(1024, tr.span_count() * 1024))
        return tr

    def _find_trace_exec(self, tenant: str, trace_id: bytes,
                         time_start: int = 0, time_end: int = 0):
        db = self.querier.db
        candidates = db.find_candidates(tenant, trace_id, time_start, time_end)
        charge = self._qos_admit(tenant, sum(m.size_bytes or 0 for m in candidates))
        try:
            jobs = [_Job(
                kind="find_recent",
                payload={"trace_id": trace_id.hex()},
                fn=self.querier.find_trace_by_id,
                args=(tenant, trace_id, time_start, time_end, True, False),
            )]
            for i in range(0, len(candidates), FIND_SHARD_BLOCKS):
                part = candidates[i : i + FIND_SHARD_BLOCKS]
                jobs.append(_Job(
                    kind="find_blocks",
                    payload={"trace_id": trace_id.hex(),
                             "block_ids": [m.block_id for m in part]},
                    fn=self.querier.find_in_blocks,
                    args=(tenant, trace_id, part),
                    batch_key=("find_blocks", tenant,
                               tuple(m.block_id for m in part)),
                    batch_fn=self._batch_find_blocks,
                    affinity_key=part[0].block_id,
                ))
            self._run_jobs(tenant, jobs)
        finally:
            self._qos_release(tenant, charge)
        partials = []
        for j in jobs:
            if j.error is not None:
                # a failed shard means the combined trace could silently
                # miss spans: fail the request (reference behavior)
                raise j.error
            if j.result is not None:
                partials.append(j.result)
        if not partials:
            return None
        return sort_trace(combine_traces(partials)) if len(partials) > 1 else partials[0]

    # ---------------------------------------------------------------- search
    def search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        """Sharded search: ingester job + block-batch jobs (+ row-group
        shard jobs for oversized blocks), bounded concurrency, early
        exit at limit."""
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            return self._search(tenant, req)
        except TooManyRequests:
            outcome = "shed"
            raise
        except Exception:
            outcome = "error"
            raise
        finally:
            self._observe("search", 'op="search"', t0, outcome)

    def _build_search_jobs(self, tenant: str, req: SearchRequest,
                           req_d: dict, metas: list) -> list[_Job]:
        """The search shard plan: one ingester-leg job FIRST (the
        newest data -- streaming delivery leans on this ordering), then
        block-batch jobs (+ row-group shard jobs for oversized
        blocks)."""
        jobs: list[_Job] = [_Job(
            kind="search_recent", payload={"req": req_d},
            fn=self.querier.search_recent, args=(tenant, req),
        )]
        batch: list = []
        batch_bytes = 0

        def flush_batch():
            nonlocal batch, batch_bytes
            if batch:
                part = batch
                jobs.append(_Job(
                    kind="search_blocks",
                    payload={"req": req_d, "block_ids": [m.block_id for m in part]},
                    fn=self.querier.search_blocks, args=(tenant, part, req),
                    batch_key=("search_blocks", tenant,
                               tuple(m.block_id for m in part)),
                    batch_fn=self._batch_search_blocks,
                    affinity_key=part[0].block_id,
                ))
                batch, batch_bytes = [], 0

        for m in metas:
            size = m.size_bytes or 0
            if size > self.batch_bytes:
                # a single oversized block: shard it by row-group range
                for groups in self._group_chunks(m):
                    jobs.append(_Job(
                        kind="search_block_shard",
                        payload={"req": req_d, "block_id": m.block_id, "groups": groups},
                        fn=self.querier.search_block_shard, args=(tenant, m, req, groups),
                        batch_key=("search_block_shard", tenant, m.block_id,
                                   tuple(groups)),
                        batch_fn=self._batch_search_shards,
                        affinity_key=m.block_id,
                    ))
                continue
            if batch_bytes + size > self.batch_bytes or len(batch) >= MAX_BLOCKS_PER_BATCH:
                flush_batch()
            batch.append(m)
            batch_bytes += size
        flush_batch()
        return jobs

    def _search(self, tenant: str, req: SearchRequest) -> SearchResponse:
        rc = self.result_cache
        if rc is None:
            return self._search_exec(tenant, req)
        out = rc.probe_search(tenant, req)
        if isinstance(out, SearchResponse):
            return out  # exact hit: no QoS charge, no jobs, no device
        if out is not None:
            # incremental extension: execute ONLY the mutable tail
            # slice through the normal shard plan, merge with the
            # cached immutable prefix
            tail = self._search_exec(tenant, out.tail_req)
            return rc.complete_search_extension(out, tail)
        resp = self._search_exec(tenant, req)
        rc.store_search(tenant, req, resp)
        return resp

    def _search_exec(self, tenant: str, req: SearchRequest) -> SearchResponse:
        limit = req.limit or 20
        resp = SearchResponse()
        lock = threading.Lock()
        req_d = request_to_dict(req)

        metas = [
            m for m in self.querier.db.blocklist.metas(tenant)
            if m.overlaps_time(req.start, req.end)
        ]
        charge = self._qos_admit(tenant, sum(m.size_bytes or 0 for m in metas))
        try:
            jobs = self._build_search_jobs(tenant, req, req_d, metas)

            def early():
                with lock:
                    return len(resp.traces) >= limit

            # collect results as jobs complete, merging under the limit
            collector_done = threading.Event()

            def collect():
                for j in jobs:
                    j.done.wait()
                    if j.error is None and j.result is not None:
                        with lock:
                            resp.merge(j.result, limit)
                collector_done.set()

            t = threading.Thread(target=collect, daemon=True)
            t.start()
            self._run_jobs(tenant, jobs, early_exit=early)
            collector_done.wait(timeout=60.0)
        finally:
            self._qos_release(tenant, charge)
        resp.traces.sort(key=lambda r: -r.start_time_unix_nano)
        resp.traces = resp.traces[:limit]
        return resp

    # ------------------------------------------------- progressive search
    def search_stream(self, tenant: str, req: SearchRequest):
        """Progressive search: a generator of result snapshots, one per
        completed shard wave, newest-first. Each yield is a dict
        {"traces": [...], "metrics": {...}, "done": bool,
        "jobsCompleted": n, "jobsTotal": m}; the final item has
        done=True and is the exact /api/search response body. Jobs ride
        the SAME queue/lease plane as blocking search -- local workers
        and remote querier polls both complete them -- the frontend just
        flushes the merged snapshot to the client as each completes
        instead of holding everything until the slowest shard."""
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            # its OWN query class: progressive delivery has a different
            # latency contract (time-to-final spans the slowest shard
            # by design)
            with timed(self.query_latency, 'op="search_stream"'):
                yield from self._search_stream(tenant, req)
        except TooManyRequests:
            outcome = "shed"
            raise
        except GeneratorExit:
            outcome = "cancelled"  # client went away, not a failure
            raise
        except Exception:
            outcome = "error"
            raise
        finally:
            self._count("queries", "search_stream", outcome)

    @staticmethod
    def _stream_final_body(resp: SearchResponse, limit: int) -> dict:
        return {
            "traces": [t.to_dict() for t in resp.traces[:limit]],
            "metrics": {
                "inspectedBytes": str(resp.inspected_bytes),
                "inspectedSpans": str(resp.inspected_spans),
            },
            "done": True,
            "jobsCompleted": 0,  # served from cache: no jobs dispatched
            "jobsTotal": 0,
        }

    def _search_stream(self, tenant: str, req: SearchRequest):
        limit = req.limit or 20
        rc = self.result_cache
        if rc is not None:
            out = rc.probe_search(tenant, req)
            if isinstance(out, SearchResponse):
                # progressive delivery collapses to its final event --
                # the cached response IS the exact /api/search body
                yield self._stream_final_body(out, limit)
                return
            if out is not None:
                tail = self._search_exec(tenant, out.tail_req)
                yield self._stream_final_body(
                    rc.complete_search_extension(out, tail), limit)
                return
        req_d = request_to_dict(req)
        metas = [
            m for m in self.querier.db.blocklist.metas(tenant)
            if m.overlaps_time(req.start, req.end)
        ]
        charge = self._qos_admit(tenant, sum(m.size_bytes or 0 for m in metas))
        runner = None
        jobs: list[_Job] = []
        try:
            jobs = self._build_search_jobs(tenant, req, req_d, metas)
            cv = threading.Condition()
            for j in jobs:
                j.stream_cv = cv
            resp = SearchResponse()
            lock = threading.Lock()

            def early():
                with lock:
                    return len(resp.traces) >= limit

            runner = threading.Thread(
                target=self._run_jobs, args=(tenant, jobs),
                kwargs={"early_exit": early}, daemon=True,
                name="search-stream-dispatch")
            runner.start()

            def body(done: bool) -> dict:
                with lock:
                    traces = sorted(resp.traces,
                                    key=lambda r: -r.start_time_unix_nano)
                    return {
                        "traces": [t.to_dict() for t in traces[:limit]],
                        "metrics": {
                            "inspectedBytes": str(resp.inspected_bytes),
                            "inspectedSpans": str(resp.inspected_spans),
                        },
                        "done": done,
                        "jobsCompleted": len(reaped),
                        "jobsTotal": len(jobs),
                    }

            reaped: set[int] = set()
            while len(reaped) < len(jobs):
                with cv:
                    if not any(j.done.is_set() and id(j) not in reaped
                               for j in jobs):
                        cv.wait(0.25)
                fresh = False
                for j in jobs:
                    if id(j) in reaped or not j.done.is_set():
                        continue
                    reaped.add(id(j))
                    # same tolerance as blocking search: a failed shard
                    # degrades coverage, it doesn't fail the stream
                    if j.error is None and j.result is not None:
                        with lock:
                            n0 = len(resp.traces)
                            resp.merge(j.result, limit)
                            fresh = fresh or len(resp.traces) > n0
                if fresh and len(reaped) < len(jobs):
                    yield body(False)
            runner.join(timeout=5.0)
            runner = None
            with lock:
                resp.traces.sort(key=lambda r: -r.start_time_unix_nano)
                resp.traces = resp.traces[:limit]
            if rc is not None:
                rc.store_search(tenant, req, resp)  # blocking search shares keys
            yield body(True)
        finally:
            if runner is not None:
                # client went away mid-stream: cancel the orphaned jobs
                # FIRST (workers skip cancelled jobs, finish() unblocks
                # the dispatcher), then settle the dispatcher, and only
                # then return the byte charge -- releasing while shard
                # jobs still run would let the tenant exceed its budget
                for j in jobs:
                    if not j.done.is_set():
                        j.cancelled = True
                        j.finish()
                runner.join(timeout=5.0)
            self._qos_release(tenant, charge)

    # ------------------------------------------------------------ metrics
    METRICS_BUCKETS_PER_JOB = 64  # time-shard unit of /api/metrics/query_range

    def metrics_query_range(self, tenant: str, req):
        """Time-sharded metrics range query: the step-aligned bucket
        axis splits into sub-range jobs (the metrics analog of the
        reference's searchsharding time splits), each executed by a
        local worker or a remote querier pull, partial series merged by
        label -- alignment to one global grid makes the shard merge
        exact (metrics_exec.align_params)."""
        t0 = time.perf_counter()
        outcome = "ok"
        try:
            return self._metrics_query_range(tenant, req)
        except TooManyRequests:
            outcome = "shed"
            raise
        except Exception:
            outcome = "error"
            raise
        finally:
            self._observe("metrics", 'op="metrics"', t0, outcome)

    def _metrics_query_range(self, tenant: str, req):
        rc = self.result_cache
        if rc is None:
            return self._metrics_exec(tenant, req)
        out = rc.probe_metrics(tenant, req)
        if out is None:
            resp = self._metrics_exec(tenant, req)
            rc.store_metrics(tenant, req, resp)
            return resp
        from .resultcache import MetricsExtension

        if isinstance(out, MetricsExtension):
            # re-execute only the tail buckets; the prefix accumulator
            # states merge exactly like the time-shard jobs below
            tail = self._metrics_exec(tenant, out.tail_req)
            return rc.complete_metrics_extension(out, tail)
        return out  # exact hit

    def _metrics_exec(self, tenant: str, req):
        from ..db.metrics_exec import (
            MetricsRequest,
            MetricsResponse,
            expr_label,
            parse_metrics_query,
            request_to_dict as metrics_request_to_dict,
        )

        q = parse_metrics_query(req.query)  # ParseError -> 400 at the API
        charge = self._qos_admit(tenant, 0)  # concurrency only
        try:
            nb = req.n_buckets
            n_jobs = max(1, -(-nb // self.METRICS_BUCKETS_PER_JOB))
            if nb >= 2 and n_jobs < 2:
                n_jobs = 2  # the shard/merge path is the production path: keep it hot
            per_job = -(-nb // n_jobs)
            jobs: list[_Job] = []
            for lo in range(0, nb, per_job):
                hi = min(lo + per_job, nb)
                sub = MetricsRequest(
                    query=req.query,
                    start_ms=req.start_ms + lo * req.step_ms,
                    end_ms=req.start_ms + hi * req.step_ms,
                    step_ms=req.step_ms,
                )
                jobs.append(_Job(
                    kind="metrics_query_range",
                    payload={"req": metrics_request_to_dict(sub)},
                    fn=self.querier.metrics_query_range, args=(tenant, sub),
                ))
            self._run_jobs(tenant, jobs)
        finally:
            self._qos_release(tenant, charge)
        resp = MetricsResponse(
            fn=q.agg.fn, start_ms=req.start_ms, step_ms=req.step_ms,
            n_buckets=nb,
            label_names=tuple(expr_label(e, i) for i, e in enumerate(q.agg.by)),
        )
        for j in jobs:
            if j.error is not None:
                # a lost time shard would silently zero part of every
                # series: fail the request (same rule as find shards)
                raise j.error
            if j.result is not None:
                resp.merge(j.result)
        return resp

    def _group_chunks(self, meta) -> list[list[int]]:
        """Split an oversized block's row groups into jobs of
        ~batch_bytes (searchsharding.go:266-310 page-range jobs)."""
        n_groups = max(1, len(meta.row_groups) or 1)
        size = meta.size_bytes or 0
        per_group = max(1, size // n_groups)
        per_job = max(1, int(self.batch_bytes // per_group))
        return [list(range(i, min(i + per_job, n_groups))) for i in range(0, n_groups, per_job)]

    def stop(self):
        self.queue.close()
