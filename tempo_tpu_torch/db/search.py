"""Search execution: tag / TraceQL queries -> filter plan -> results
(port of tempo_tpu/db/search.py, device engine only).

The per-block pipeline (analog of vparquet/block_search.go:78-116 +
block_traceql.go Fetch): the TraceQL planner resolves strings through
the block dictionary (a miss prunes the whole block) and emits a
trace-level condition tree; the filter (K1) evaluates it over the
block's staged columns; the top `limit` candidates BY TRACE START TIME
are selected on the card (K2) before any host materialization, and
only those are exactly re-verified on the host (device encodings are
conservative).

Every live block goes to the card: the host engine and its
temperature routing, streaming and the mesh path of the JAX package are
not part of this port yet. Concurrent single-block jobs coalesce in
db/batchexec.py, which calls back into this module for its fallbacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..block import schema as S
from ..block.reader import BackendBlock
from ..ops.filter import T_RATTR, T_RES, T_TRACE, Operands, eval_block, required_columns
from ..ops.select import k_bucket, select_topk_device, select_topk_device_multi
from ..ops.stage import stage_block
from ..traceql.plan import plan_search_request

DEFAULT_LIMIT = 20
# staged span-axis bytes of one fused multi-block search before it falls
# back to per-block search (as in the JAX package)
_DEVICE_SEARCH_MAX_BYTES = 512 << 20
# staged span-axis bytes past which the reference streams row-group
# chunks; the port has no streaming yet (ROADMAP A4), and the batching
# executor keeps the reference's routing at this threshold
_STREAM_MIN_STAGE_BYTES = 512 << 20


@dataclass
class SearchRequest:
    tags: dict[str, str] = field(default_factory=dict)
    min_duration_ms: int = 0
    max_duration_ms: int = 0
    start: int = 0  # unix seconds, 0 = unbounded
    end: int = 0
    limit: int = DEFAULT_LIMIT
    query: str = ""  # TraceQL spanset filter


@dataclass
class SearchResult:
    trace_id: str  # hex
    root_service_name: str
    root_trace_name: str
    start_time_unix_nano: int
    duration_ms: int
    matched_spans: int = 0


@dataclass
class SearchResponse:
    traces: list[SearchResult] = field(default_factory=list)
    inspected_bytes: int = 0
    inspected_spans: int = 0

    def merge(self, other: "SearchResponse", limit: int) -> None:
        seen = {t.trace_id for t in self.traces}
        for t in other.traces:
            if t.trace_id not in seen and len(self.traces) < limit:
                self.traces.append(t)
                seen.add(t.trace_id)
        self.inspected_bytes += other.inspected_bytes
        self.inspected_spans += other.inspected_spans


def _plan_for_block(blk: BackendBlock, req: SearchRequest, allow_struct: bool = True):
    start_rel = None
    if req.start or req.end:
        base_ms = blk.meta.start_time_unix_nano // 1_000_000
        lo = (req.start * 1000 - base_ms - 1) if req.start else -(2**31)
        hi = (req.end * 1000 - base_ms + 1) if req.end else 2**31 - 1
        start_rel = (
            int(np.clip(lo, -(2**31), 2**31 - 1)),
            int(np.clip(hi, -(2**31), 2**31 - 1)),
        )
    return plan_search_request(
        blk.dictionary,
        req.tags,
        query=req.query,
        min_duration_ms=req.min_duration_ms,
        max_duration_ms=req.max_duration_ms,
        start_rel_ms=start_rel,
        # struct nodes need the block to carry the parent-row column
        allow_struct=allow_struct and blk.pack.has("span.parent_idx"),
    )


def _verify_candidates(blk: BackendBlock, req: SearchRequest, sids, needs_verify: bool):
    """Exact host re-check of TraceQL candidates when the device filter
    was conservative. Bounded: callers pass at most the escalation k."""
    if not (needs_verify and req.query and len(sids)):
        return sids
    from ..traceql.hosteval import trace_matches
    from ..traceql.parser import parse

    q = parse(req.query)
    traces = blk.materialize_traces([int(s) for s in sids])
    return np.asarray(
        [s for s, tr in zip(sids, traces) if tr is not None and trace_matches(q, tr)],
        dtype=np.int64,
    )


def _candidates(
    blk: BackendBlock, req: SearchRequest, sids: list[int], counts: dict[int, int]
) -> list[tuple]:
    """Exact host re-check of time/duration + lightweight candidate
    records (start_ns, trace_id hex, dur_ms, matched, blk, sid); the
    dictionary lookups are deferred to the winners (_materialize)."""
    ti = blk.search_index
    if not len(sids):
        return []
    sa = np.asarray(sids, dtype=np.int64)
    start_ns = ti["trace.start_ns"][sa].astype(np.int64)
    end_ns = ti["trace.end_ns"][sa].astype(np.int64)
    dur_ms = np.maximum(0, (end_ns - start_ns) // 1_000_000)
    keep = np.ones(sa.shape[0], dtype=bool)
    if req.min_duration_ms:
        keep &= dur_ms >= req.min_duration_ms
    if req.max_duration_ms:
        keep &= dur_ms <= req.max_duration_ms
    if req.start:
        keep &= start_ns >= req.start * 1_000_000_000
    if req.end:
        keep &= start_ns <= req.end * 1_000_000_000
    ka = sa[keep]
    blob = np.ascontiguousarray(ti["trace.id"][ka]).tobytes().hex()
    ids_hex = [blob[i * 32 : (i + 1) * 32] for i in range(ka.shape[0])]
    return [
        (s, h, d, int(counts.get(sid, 0)), blk, sid)
        for s, h, d, sid in zip(start_ns[keep].tolist(), ids_hex,
                                dur_ms[keep].tolist(), ka.tolist())
    ]


def _materialize(cand: tuple) -> SearchResult:
    """One candidate record -> SearchResult."""
    start_ns, tid_hex, dur_ms, cnt, blk, sid = cand
    ti = blk.search_index
    d = blk.dictionary
    return SearchResult(
        trace_id=tid_hex,
        root_service_name=d.string(int(ti["trace.root_service_id"][sid])),
        root_trace_name=d.string(int(ti["trace.root_name_id"][sid])),
        start_time_unix_nano=start_ns,
        duration_ms=dur_ms,
        matched_spans=cnt,
    )


def _collect_topk(blk: BackendBlock, req: SearchRequest, needs_verify: bool,
                  selector, limit: int, materialize: bool = True):
    """Escalating top-k collect: select k candidates (newest first),
    verify exactly, and only widen k (x4) when verification rejected
    enough to fall short of the limit. selector(k) -> (sids, counts,
    n_match). materialize=False returns candidate records (_candidates)
    for a caller that materializes them itself (the batched search)."""
    nt = blk.meta.total_traces
    if nt == 0:
        return []
    k = min(k_bucket(max(2 * limit, 32)), nt)
    out: list = []
    seen: set[int] = set()
    while True:
        sids, cnts, n_match = selector(k)
        fresh = [(int(s), int(c)) for s, c in zip(sids, cnts) if int(s) not in seen]
        seen.update(s for s, _ in fresh)
        if fresh:
            ok = _verify_candidates(
                blk, req, np.asarray([s for s, _ in fresh], dtype=np.int64), needs_verify
            )
            okset = {int(s) for s in ok}
            out.extend(
                _candidates(blk, req, [s for s, _ in fresh if s in okset], dict(fresh))
            )
        if len(out) >= limit or len(seen) >= n_match or k >= nt:
            return [_materialize(c) for c in out] if materialize else out
        k = min(k_bucket(k * 4), nt)


def _collect_topk_multi(blocks, plans, offsets, req: SearchRequest, selector, limit: int):
    """Escalating cross-block top-k collect: global winners map back to
    (block, sid) via the padded part offsets, then per-block exact
    verification; returns candidate records for the global merge."""
    total = int(offsets[-1])
    if total == 0:
        return []
    k = min(k_bucket(max(2 * limit, 32)), total)
    out: list = []
    seen: set[int] = set()
    while True:
        gids, gcnts, n_match = selector(k)
        per_block: dict[int, list[tuple[int, int]]] = {}
        fresh = 0
        for g, c in zip(gids, gcnts):
            g = int(g)
            if g in seen:
                continue
            seen.add(g)
            fresh += 1
            bi = int(np.searchsorted(offsets, g, side="right")) - 1
            per_block.setdefault(bi, []).append((g - int(offsets[bi]), int(c)))
        for bi, pairs in per_block.items():
            blk, p = blocks[bi], plans[bi]
            sids = np.asarray([s for s, _ in pairs], dtype=np.int64)
            ok = _verify_candidates(blk, req, sids, p.needs_verify)
            okset = {int(s) for s in ok}
            out.extend(
                _candidates(blk, req, [s for s, c in pairs if s in okset], dict(pairs))
            )
        if len(out) >= limit or len(seen) >= n_match or k >= total or fresh == 0:
            return out
        k = min(k_bucket(k * 4), total)


def _tres_eligible(blk: BackendBlock, p) -> bool:
    """Res/trace-only condition trees can evaluate over the tres
    membership axis (one row per (trace, resource) pair) instead of the
    span axis. The host engine that would take them is not part of the
    port yet (ROADMAP A1); the batching executor reads this predicate to
    route such plans exactly as the reference does."""
    return (blk.pack.has("tres.res") and bool(p.conds)
            and not getattr(p, "has_struct", False)  # struct needs span rows
            and all(c.target in (T_RES, T_RATTR, T_TRACE) for c in p.conds))


def search_block(blk: BackendBlock, req: SearchRequest, groups_range: list[int] | None = None,
                 device=None) -> SearchResponse:
    """Search one block (optionally one row-group shard of it) on the
    device: stage -> eval_block (K1) -> select_topk_device (K2)."""
    resp = SearchResponse()
    if not blk.meta.overlaps_time(req.start, req.end):
        return resp
    planned = _plan_for_block(blk, req)
    if planned.prune:
        return resp
    if groups_range is not None and planned.has_struct:
        # struct nodes resolve parent links by GLOBAL row index; a
        # row-group slice would sever links across group boundaries, so
        # shards take the conservative plan (trace-AND + host verify)
        planned = _plan_for_block(blk, req, allow_struct=False)
        if planned.prune:  # the conservative fold may prove "no match"
            return resp
    limit = req.limit or DEFAULT_LIMIT
    operands = Operands.build(planned.rows, planned.tables or None)
    needed = required_columns(planned.conds) + list(planned.extra_cols)
    pack = blk.pack
    io0 = pack.bytes_read
    staged = stage_block(blk, needed + ["trace.start_ms"], groups=groups_range, device=device)
    tm, counts = eval_block(
        (planned.tree, planned.conds), staged.cols, operands,
        staged.n_spans, staged.n_traces, staged.n_spans_b, staged.n_res_b, staged.n_traces_b,
        span_out=False,
    )
    key = staged.cols["trace.start_ms"]

    def selector(k):
        return select_topk_device(tm, key, counts, k)

    results = _collect_topk(blk, req, planned.needs_verify, selector, limit)
    results.sort(key=lambda r: -r.start_time_unix_nano)
    resp.traces = results[:limit]
    resp.inspected_spans = staged.n_spans
    resp.inspected_bytes = pack.bytes_read - io0
    return resp


def search_blocks_fused(
    blocks: list[BackendBlock],
    req: SearchRequest,
    default_limit: int = DEFAULT_LIMIT,
    device=None,
) -> SearchResponse | None:
    """Search many blocks with ONE device sync: per-block K1 with
    span_out=False, then ONE cross-block K2 over the concatenated
    `trace@gkey_s` keys. Returns None when the staged footprint exceeds
    the device budget -- the caller falls back to per-block search."""
    resp = SearchResponse()
    limit = req.limit or default_limit
    in_range = [b for b in blocks if b.meta.overlaps_time(req.start, req.end)]
    plans = [_plan_for_block(b, req) for b in in_range]
    live = [(blk, p) for blk, p in zip(in_range, plans) if not p.prune]
    if not live:
        return resp
    est = 0
    for blk, p in live:
        # the touch count the batching executor's promotion rule reads
        blk.search_touches = getattr(blk, "search_touches", 0) + 1
        needed = required_columns(p.conds) + list(p.extra_cols) + ["trace@gkey_s"]
        n_span_cols = max(1, sum(1 for n in needed if n.startswith(("span.", "sattr."))))
        est += blk.pack.axes[S.AX_SPAN].n_rows * 4 * n_span_cols
    if est > _DEVICE_SEARCH_MAX_BYTES:
        return None

    io0 = {id(blk): blk.pack.bytes_read for blk, _ in live}
    tms, cnts, keys = [], [], []
    for blk, p in live:
        operands = Operands.build(p.rows, p.tables or None)
        needed = required_columns(p.conds) + list(p.extra_cols) + ["trace@gkey_s"]
        staged = stage_block(blk, needed, device=device)
        tm, counts = eval_block(
            (p.tree, p.conds), staged.cols, operands,
            staged.n_spans, staged.n_traces,
            staged.n_spans_b, staged.n_res_b, staged.n_traces_b,
            span_out=False,
        )
        tms.append(tm)
        cnts.append(counts)
        keys.append(staged.cols["trace@gkey_s"])
        resp.inspected_spans += int(staged.n_spans)
    offsets = np.cumsum([0] + [int(t.shape[0]) for t in tms])

    def selector(k):
        return select_topk_device_multi(tms, keys, cnts, k)

    results = _collect_topk_multi([blk for blk, _ in live], [p for _, p in live],
                                  offsets, req, selector, limit)
    # global merge over lightweight candidates; only the winning `limit`
    # pay dictionary lookups + SearchResult construction
    results.sort(key=lambda c: -c[0])
    seen: set[str] = set()
    for c in results:
        if c[1] in seen:
            continue
        seen.add(c[1])
        resp.traces.append(_materialize(c))
        if len(resp.traces) >= limit:
            break
    resp.inspected_bytes = sum(blk.pack.bytes_read - io0[id(blk)] for blk, _ in live)
    return resp
