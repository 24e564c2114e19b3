"""Cross-query batching executor: coalesce concurrent jobs into fused
multi-query kernel launches (port of tempo_tpu/db/batchexec.py).

Under concurrency every in-flight query would dispatch its own K1 + K2
sequence over the SAME staged block. This module is the scheduling half
of the fix (ops/multiquery.py is the kernel half), the trace-search
analog of continuous batching in inference serving:

  * a short admission window (TEMPO_BATCH_WINDOW_MS, default 3 ms)
    opens when the first eligible job arrives; jobs submitted inside it
    group by *coalesce key* -- (block, row-group range, staged column
    set, program-shape bucket) -- so every member lowers onto the SAME
    program shape;
  * each group executes as ONE B5a launch (multi-query filter) + ONE
    B5b launch (row-wise top-k), and the per-query results demux back to
    their submitters, exact-verify preserved per query;
  * a lone query never waits past the window, and skips it entirely
    when nobody else is inside the executor (the in-flight fast path);
  * ineligible plans (regex tables, generic attr conds, struct
    relations, cold blocks) never enter the window: callers fall back
    to the single-query path unchanged.

Two executors share the machinery: `search` fuses TraceQL/tag search
jobs; `find` fuses trace-by-ID lookups through K3 with Q > 1. On a mesh
of more than one rank a search group runs as one mesh program
(parallel/multiquery) and a find group as the sharded find
(parallel/find.sharded_find_rows), where the reference routes them.

A fused group that fails falls back to running its members one by one,
as in the reference -- except for a kernels.KernelError or a
parallel.mesh.MeshError, which reaches every member: a kernel that does
not build or launch, or a mesh rank that failed, is never hidden behind
the sequential route. Each executor keeps a small stats dict
(queries, groups, max_occupancy); routing decisions are counted by
(site, engine, reason) in ROUTING.
"""

from __future__ import annotations

import os
import threading
from collections import Counter
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..kernels import KernelError

DEFAULT_WINDOW_MS = 3.0
DEFAULT_MAX_BATCH = 16
_FOLLOWER_TIMEOUT_S = 600.0

# (site, engine, reason) -> count, e.g. ("search_batch", "fallback",
# "ineligible_plan"): the routing the reference reports to its telemetry
ROUTING: Counter = Counter()
_routing_lock = threading.Lock()


def record_routing(site: str, engine: str, reason: str, n: int = 1) -> None:
    with _routing_lock:
        ROUTING[(site, engine, reason)] += n


def routing_counts() -> dict:
    with _routing_lock:
        return dict(ROUTING)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# the reference's fused-launch intermediate budget: a group estimated
# past it (ops/multiquery.mq_bytes_estimate) runs its members
# sequentially instead
_MQ_BUDGET_BYTES = 1 << 30


def resolve_batch_config(enabled=None, window_ms=None, max_batch=None):
    """(enabled, window_s, max_batch) from explicit config, falling back
    to env knobs: TEMPO_BATCH=0 disables, TEMPO_BATCH_WINDOW_MS,
    TEMPO_BATCH_MAX."""
    if enabled is None:
        enabled = os.environ.get("TEMPO_BATCH", "1") not in ("0", "false")
    if window_ms is None:
        window_ms = _env_float("TEMPO_BATCH_WINDOW_MS", DEFAULT_WINDOW_MS)
    if max_batch is None:
        max_batch = int(_env_float("TEMPO_BATCH_MAX", DEFAULT_MAX_BATCH))
    return bool(enabled), max(0.0, window_ms) / 1e3, max(1, max_batch)


class _Group:
    __slots__ = ("items", "done", "full", "closed", "results")

    def __init__(self):
        self.items: list = []
        self.done = threading.Event()
        self.full = threading.Event()
        self.closed = False
        self.results: list | None = None


class BatchExecutor:
    """Leader/follower admission-window batcher. The first submitter
    for a key becomes the group leader: it holds the window open (or
    until the group fills), then runs `runner(key, items)` and fans the
    per-item results (or per-item exceptions) back out. Followers that
    land inside the window just wait for demux."""

    def __init__(self, name: str, runner, window_s: float = DEFAULT_WINDOW_MS / 1e3,
                 max_batch: int = DEFAULT_MAX_BATCH, enabled: bool = True, device=None):
        self.name = name
        self.runner = runner  # (key, items) -> list of results/Exceptions
        self.window_s = window_s
        self.max_batch = max_batch
        self.enabled = enabled
        self.device = device  # where the groups' kernels run
        self._lock = threading.Lock()
        self._groups: dict = {}
        self._inflight = 0  # submitters currently inside submit_many
        self.stats = {"queries": 0, "groups": 0, "max_occupancy": 0}

    def submit(self, key, item):
        out = self.submit_many(key, [item])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def submit_many(self, key, items: list) -> list:
        """Submit items under one coalesce key; blocks until the fused
        group (this thread's and any window-mates') executes. Returns
        per-item results; a failed item comes back as its Exception so
        one poisoned query never discards its siblings' results."""
        if len(items) > self.max_batch:  # a single oversized submission
            out: list = []  # still respects the configured group cap
            for i in range(0, len(items), self.max_batch):
                out.extend(self.submit_many(key, items[i:i + self.max_batch]))
            return out
        with self._lock:
            self._inflight += 1
            g = self._groups.get(key)
            if (g is None or g.closed
                    or len(g.items) + len(items) > self.max_batch):
                g = _Group()
                self._groups[key] = g
                leader = True
            else:
                leader = False
            lo = len(g.items)
            g.items.extend(items)
            if not leader and len(g.items) >= self.max_batch:
                g.full.set()
        try:
            if leader:
                self._lead(key, g)
            elif not g.done.wait(_FOLLOWER_TIMEOUT_S):
                raise TimeoutError(f"batch group leader stalled ({self.name})")
        finally:
            with self._lock:
                self._inflight -= 1
        return g.results[lo:lo + len(items)]

    def _lead(self, key, g: _Group) -> None:
        # lone-query fast path: only hold the window open when another
        # SUBMITTER is inside the executor. Purely sequential traffic
        # therefore never pays the window; a concurrent burst's
        # stragglers group with each other while the first arrival's
        # launch is in flight.
        if self.window_s > 0:
            with self._lock:
                others = self._inflight > 1
            if others:
                g.full.wait(self.window_s)
        with self._lock:
            g.closed = True
            if self._groups.get(key) is g:
                del self._groups[key]
            items = list(g.items)
        try:
            results = self.runner(key, items)
            if not isinstance(results, list) or len(results) != len(items):
                raise RuntimeError(
                    f"batch runner returned {len(results) if isinstance(results, list) else type(results)} "
                    f"results for {len(items)} items")
            g.results = results
        except Exception as e:  # group-level failure: every member sees it
            g.results = [e] * len(items)
        finally:
            g.done.set()
        with self._lock:
            self.stats["queries"] += len(items)
            self.stats["groups"] += 1
            self.stats["max_occupancy"] = max(self.stats["max_occupancy"], len(items))


# ------------------------------------------------------------- search path


@dataclass
class _SearchItem:
    blk: object
    req: object
    planned: object
    lowered: object
    needed: list
    groups_range: object
    limit: int
    device: object = None


def _collect_seeded(blk, req, planned, seed, tm_row, counts_row, key_dev, limit: int):
    """db/search._collect_topk with the FIRST selection pre-computed by
    the fused batched top-k (the seed was sliced to exactly the k the
    collect loop asks for first); escalation falls back to per-query
    device selects (K2) on this query's mask row. Returns candidate
    records (materialize=False)."""
    from ..ops.select import select_topk_device
    from .search import _collect_topk

    state = [seed]

    def selector(k):
        if state:
            return state.pop()
        return select_topk_device(tm_row, key_dev, counts_row, k)

    return _collect_topk(blk, req, planned.needs_verify, selector, limit, materialize=False)


def _sequential_search(it: _SearchItem):
    from .search import search_block

    # honor the route's default limit (search_blocks passes the config
    # default; search_block alone would fall back to the module default)
    req = it.req if it.req.limit else replace(it.req, limit=it.limit)
    return search_block(it.blk, req, groups_range=it.groups_range, device=it.device)


def _seq_or_exc(it: _SearchItem):
    try:
        return _sequential_search(it)
    except Exception as e:
        return e


def _run_search_group(key, items: list, mesh_fn=None) -> list:
    """Execute one coalesced search group: stage once, ONE B5a launch
    (or one mesh program), ONE B5b launch, per-query verify +
    materialize. A fused-path failure other than a KernelError or a
    MeshError degrades to per-item single-query execution; those two
    reach every member."""
    from ..parallel.mesh import MeshError

    if len(items) == 1:
        return [_seq_or_exc(items[0])]
    try:
        return _run_search_group_fused(items, mesh_fn)
    except (KernelError, MeshError):
        raise
    except Exception:
        record_routing("search_batch", "fallback", "fused_error", n=len(items))
        return [_seq_or_exc(it) for it in items]


def _mesh_batch_enabled() -> bool:
    """TEMPO_MESH_BATCH=0 pins window leaders to the single-device fused
    launch even on a multi-rank mesh (as the reference reads it)."""
    return os.environ.get("TEMPO_MESH_BATCH", "1") not in ("0", "false")


def _run_search_group_fused(items: list, mesh_fn=None) -> list:
    from ..ops.multiquery import (
        _p2,
        eval_multiquery,
        mq_bytes_estimate,
        pack_queries,
        select_multiquery,
    )
    from ..ops.select import k_bucket
    from ..ops.stage import stage_block
    from .search import SearchResponse, _materialize

    blk = items[0].blk
    shape = items[0].lowered.shape
    q_b = _p2(len(items), lo=1)
    io0 = blk.pack.bytes_read
    staged = stage_block(blk, items[0].needed + ["trace.start_ms"],
                         groups=items[0].groups_range, device=items[0].device)
    if mq_bytes_estimate(shape, q_b, staged.n_spans_b) > _MQ_BUDGET_BYTES:
        record_routing("search_batch", "fallback", "mq_budget", n=len(items))
        return [_seq_or_exc(it) for it in items]
    lowered = [it.lowered for it in items]
    progs = pack_queries(lowered, q_b)
    # more than one rank: the window leader lowers the whole group to ONE
    # Q-programs x sharded-rows mesh program (parallel/multiquery);
    # shape-ineligible buckets and TEMPO_MESH_BATCH=0 keep the
    # single-device fused launch
    mesh = mesh_fn() if mesh_fn is not None else None
    engine = "device"
    if mesh is not None and _mesh_batch_enabled():
        from ..parallel.multiquery import mesh_batch_eligible, mesh_eval_multiquery

        if mesh_batch_eligible(mesh, staged):
            tm_h, counts_h = mesh_eval_multiquery(mesh, lowered, staged, progs)
            dev = staged.cols["trace.start_ms"].device
            tm, counts = torch.from_numpy(tm_h).to(dev), torch.from_numpy(counts_h).to(dev)
            engine = "mesh"
    if engine == "device":
        tm, counts = eval_multiquery(lowered, staged, progs)
    key_dev = staged.cols["trace.start_ms"]
    nt = blk.meta.total_traces
    record_routing("search_batch", engine, "mesh_batched" if engine == "mesh" else "coalesced",
                   n=len(items))

    responses: list = []
    if nt == 0:
        for it in items:
            r = SearchResponse()
            r.inspected_spans = staged.n_spans
            responses.append(r)
        responses[0].inspected_bytes = blk.pack.bytes_read - io0
        return responses
    ks = [min(k_bucket(max(2 * it.limit, 32)), nt) for it in items]
    rows = select_multiquery(tm, key_dev, counts, max(ks))
    for qi, it in enumerate(items):
        try:
            sids_k, cnts_k, valid_k, n_match = rows[qi]
            kq = ks[qi]
            seed = (sids_k[:kq][valid_k[:kq]], cnts_k[:kq][valid_k[:kq]], n_match)
            out = _collect_seeded(blk, it.req, it.planned, seed, tm[qi], counts[qi], key_dev,
                                  it.limit)
            results = [_materialize(c) for c in out]
            results.sort(key=lambda r: -r.start_time_unix_nano)
            resp = SearchResponse()
            resp.traces = results[:it.limit]
            resp.inspected_spans = staged.n_spans
            responses.append(resp)
        except Exception as e:  # verify/materialize is per-query: isolate
            responses.append(e)
    # IO attribution mirrors the sequential path: only the query that
    # triggered reads pays them (the group's one staging pass)
    for r in responses:
        if not isinstance(r, Exception):
            r.inspected_bytes = blk.pack.bytes_read - io0
            break
    return responses


def batched_search_block(batcher: BatchExecutor, blk, req, groups_range=None,
                         promote_touches: int = 2, default_limit: int | None = None):
    """Route one block search through the batching executor when
    eligible; None means "take the single-query path unchanged":

      * the plan must lower to a predicate program (ops/multiquery);
      * the block must be warm -- staged columns resident, or touched
        promote_touches times (search_blocks_fused's touch count), or
        device-pinned for row-group shard jobs;
      * tres-eligible plans and stream-sized scans keep the reference's
        routing (their own engines, not ported yet, fall to the single-
        query device path here)."""
    probe = _probe_search_entry(batcher, blk, req, groups_range, promote_touches, default_limit)
    if probe is None or not isinstance(probe, tuple):
        return probe  # ineligible (None) or a static empty response
    key, item = probe
    return batcher.submit(key, item)


def batched_search_block_many(batcher: BatchExecutor, entries: list, promote_touches: int = 2,
                              default_limit: int | None = None) -> list:
    """Many (blk, req, groups_range) searches from ONE caller thread,
    grouped by coalesce key and submitted together so a single worker
    draining a burst still forms full batches. Returns per-entry
    SearchResponse, None where the entry was ineligible (caller falls
    back), or the entry's own Exception."""
    out: list = [None] * len(entries)
    staged: dict = {}
    for i, (blk, req, groups_range) in enumerate(entries):
        probe = _probe_search_entry(batcher, blk, req, groups_range, promote_touches,
                                    default_limit)
        if probe is None:
            continue
        if isinstance(probe, tuple):
            key, item = probe
            staged.setdefault(key, []).append((i, item))
        else:  # an immediate empty response (prune / out of range)
            out[i] = probe
    for key, pairs in staged.items():
        results = batcher.submit_many(key, [it for _, it in pairs])
        for (i, _), r in zip(pairs, results):
            out[i] = r
    return out


def _probe_search_entry(batcher, blk, req, groups_range, promote_touches,
                        default_limit: int | None = None):
    """Eligibility probe: returns (key, item) when batchable, a
    SearchResponse for static empties, or None to fall back."""
    from ..block import schema as S
    from ..ops.device import resolve_device
    from ..ops.filter import required_columns
    from ..ops.multiquery import lower_plan
    from .search import (
        _STREAM_MIN_STAGE_BYTES,
        DEFAULT_LIMIT,
        SearchResponse,
        _plan_for_block,
        _tres_eligible,
    )

    if batcher is None or not batcher.enabled:
        return None
    if not blk.meta.overlaps_time(req.start, req.end):
        return SearchResponse()
    planned = _plan_for_block(blk, req)
    if not planned.prune and groups_range is not None and planned.has_struct:
        planned = _plan_for_block(blk, req, allow_struct=False)
    if planned.prune:
        return SearchResponse()
    lowered = lower_plan(planned)
    if lowered is None:
        record_routing("search_batch", "fallback", "ineligible_plan")
        return None
    if _tres_eligible(blk, planned):
        record_routing("search_batch", "fallback", "tres_host")
        return None
    needed = required_columns(planned.conds) + list(planned.extra_cols)
    span_ax = blk.pack.axes.get(S.AX_SPAN)
    n_rows = span_ax.n_rows if span_ax else 0
    n_span_cols = max(1, sum(1 for n in needed if n.startswith(("span.", "sattr."))))
    if n_rows * 4 * n_span_cols > _STREAM_MIN_STAGE_BYTES:
        record_routing("search_batch", "fallback", "stream_scan")
        return None
    dev = resolve_device(batcher.device)
    groups = tuple(groups_range) if groups_range is not None else None
    stage_key = (tuple(needed + ["trace.start_ms"]), groups, str(dev))
    store = getattr(blk, "_staged_cache", None)
    staged_hit = store is not None and stage_key in store
    touches = getattr(blk, "search_touches", 0)
    hot = (staged_hit
           or (groups_range is not None and getattr(blk, "device_pinned", False))
           or touches + 1 >= promote_touches)
    if not hot:
        record_routing("search_batch", "fallback", "cold_block")
        return None
    blk.search_touches = touches + 1
    item = _SearchItem(
        blk=blk, req=req, planned=planned, lowered=lowered, needed=needed,
        groups_range=list(groups_range) if groups_range is not None else None,
        limit=req.limit or default_limit or DEFAULT_LIMIT, device=dev,
    )
    key = ("search", blk.meta.tenant_id, blk.meta.block_id, groups, stage_key[0], lowered.shape)
    return key, item


# --------------------------------------------------------------- find path


@dataclass
class _FindItem:
    metas: list
    trace_id: bytes
    db: object = field(repr=False, default=None)


def _find_seq_or_exc(it: _FindItem):
    """Sequential twin of one find item (the unbatched path)."""
    from ..wire.combine import combine_traces

    try:
        found = it.db._device_find(it.metas, it.trace_id)
        return combine_traces(found) if found else None
    except Exception as e:
        return e


def _run_find_group(key, items: list) -> list:
    """One coalesced trace-by-ID group: bloom-gate per (block, id) on
    host, then ONE K3 bisection over every surviving block for ALL Q
    ids (the sharded find on a mesh), per-id hit rows materialized and
    combined. A fused-path failure other than a KernelError or a
    MeshError degrades to per-item sequential lookups."""
    from ..parallel.mesh import MeshError

    if len(items) == 1:
        return [_find_seq_or_exc(items[0])]
    try:
        return _run_find_group_fused(items)
    except (KernelError, MeshError):
        raise
    except Exception:
        record_routing("find_batch", "fallback", "fused_error", n=len(items))
        return [_find_seq_or_exc(it) for it in items]


def _run_find_group_fused(items: list) -> list:
    from ..block import schema as S
    from ..ops.find import lookup_ids_blocks_cached
    from ..wire.combine import combine_traces

    db = items[0].db
    blocks = [db.open_block(m) for m in items[0].metas]
    # a block survives the gate if ANY id in the window may be present;
    # the bisection compare is exact, so ids the bloom would have pruned
    # for a given block simply miss (-1) there
    keep = [b for b in blocks if any(b.bloom_test(it.trace_id) for it in items)]
    if not keep:
        return [None] * len(items)
    ids = [it.trace_id.rjust(16, b"\x00") for it in items]
    query = np.asarray([S.trace_id_to_codes(i) for i in ids], dtype=np.int32)
    if db.mesh.size > 1:
        from ..parallel.find import sharded_find_rows

        sids = sharded_find_rows(db.mesh, [b.trace_index["trace.id_codes"] for b in keep],
                                 query)  # (B, Q)
        record_routing("find_batch", "mesh", "coalesced", n=len(items))
    else:
        sids = lookup_ids_blocks_cached(keep, query, db.device)  # (B, Q)
        record_routing("find_batch", "device", "coalesced", n=len(items))
    per_block: dict[int, list[tuple[int, int]]] = {}
    for bi in range(sids.shape[0]):
        for qi in range(sids.shape[1]):
            if sids[bi, qi] >= 0:
                per_block.setdefault(bi, []).append((qi, int(sids[bi, qi])))
    found: list[list] = [[] for _ in items]
    for bi, pairs in per_block.items():
        traces = keep[bi].materialize_traces([row for _, row in pairs])
        for (qi, _), tr in zip(pairs, traces):
            if tr is not None:
                found[qi].append(tr)
    return [combine_traces(f) if f else None for f in found]


def find_key(metas: list) -> tuple:
    """The find batcher's coalesce key: lookups against the same
    candidate partition share one bisection batch."""
    return ("find", metas[0].tenant_id, tuple(m.block_id for m in metas))


def batched_find(batcher: BatchExecutor, db, metas: list, trace_id: bytes):
    """Trace-by-ID lookup through the find batcher: concurrent lookups
    against the same candidate partition share one bisection batch."""
    return batcher.submit(find_key(metas), _FindItem(metas=metas, trace_id=trace_id, db=db))


# ------------------------------------------------------------- aggregates


class QueryBatchers:
    """The per-TempoDB pair of batching executors (search + find) under
    one resolved config, both running their groups on `device`.
    `mesh_fn` (lazy: the mesh is looked up at the first group) lets
    window leaders lower a whole search group onto the mesh when it has
    more than one rank."""

    def __init__(self, enabled=None, window_ms=None, max_batch=None, device=None,
                 mesh_fn=None):
        on, window_s, max_b = resolve_batch_config(enabled, window_ms, max_batch)
        self.enabled = on

        def search_runner(key, items):
            return _run_search_group(key, items, mesh_fn)

        self.search = BatchExecutor("search", search_runner, window_s=window_s,
                                    max_batch=max_b, enabled=on, device=device)
        self.find = BatchExecutor("find", _run_find_group, window_s=window_s,
                                  max_batch=max_b, enabled=on, device=device)
