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
temperature routing and streaming of the JAX package are not part of
this port yet. Concurrent single-block jobs coalesce in
db/batchexec.py, which calls back into this module for its fallbacks.
On a mesh of more than one rank, a multi-block search stacks its blocks
into one sharded program (search_blocks_device, parallel/search.py) and
selects each block's top k on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..block import schema as S
from ..block.reader import BackendBlock
from ..ops.filter import T_RATTR, T_RES, T_TRACE, Operands, eval_block, required_columns
from ..ops.device import PAD_I32, bucket
from ..ops.select import k_bucket, select_topk_device, select_topk_device_multi, select_topk_host
from ..ops.stage import stage_block
from ..traceql.plan import _WELL_KNOWN_RES, plan_search_request
from ..util.distinct import DistinctStringCollector

DEFAULT_LIMIT = 20
_INTRINSIC_NAME = "name"
# staged span-axis bytes of one fused multi-block search, and stacked
# column bytes of one mesh search group, before each falls back to
# per-block search (one budget for both, as in the JAX package)
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

    def to_dict(self) -> dict:
        return {
            "traceID": self.trace_id,
            "rootServiceName": self.root_service_name,
            "rootTraceName": self.root_trace_name,
            "startTimeUnixNano": str(self.start_time_unix_nano),
            "durationMs": self.duration_ms,
        }


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


# ---- wire forms (what the frontend's remote job plane, the serverless
# handler and the result cache serialize)


def request_to_dict(req: SearchRequest) -> dict:
    return {
        "tags": req.tags,
        "query": req.query,
        "min_duration_ms": req.min_duration_ms,
        "max_duration_ms": req.max_duration_ms,
        "start": req.start,
        "end": req.end,
        "limit": req.limit,
    }


def request_from_dict(d: dict) -> SearchRequest:
    return SearchRequest(
        tags=d.get("tags", {}),
        query=d.get("query", ""),
        min_duration_ms=d.get("min_duration_ms", 0),
        max_duration_ms=d.get("max_duration_ms", 0),
        start=d.get("start", 0),
        end=d.get("end", 0),
        limit=d.get("limit", DEFAULT_LIMIT),
    )


def response_to_dict(resp: SearchResponse) -> dict:
    return {
        "traces": [
            {**t.to_dict(), "matchedSpans": t.matched_spans} for t in resp.traces
        ],
        "inspectedBytes": resp.inspected_bytes,
        "inspectedSpans": resp.inspected_spans,
    }


def response_from_dict(d: dict) -> SearchResponse:
    resp = SearchResponse()
    resp.inspected_bytes = d.get("inspectedBytes", 0)
    resp.inspected_spans = d.get("inspectedSpans", 0)
    for t in d.get("traces", []):
        resp.traces.append(
            SearchResult(
                trace_id=t["traceID"],
                root_service_name=t.get("rootServiceName", ""),
                root_trace_name=t.get("rootTraceName", ""),
                start_time_unix_nano=int(t.get("startTimeUnixNano", "0")),
                duration_ms=t.get("durationMs", 0),
                matched_spans=t.get("matchedSpans", 0),
            )
        )
    return resp


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


def _start_key_host(blk: BackendBlock) -> np.ndarray:
    """trace.start_ms column (the top-k selection key), cached on the
    immutable block."""
    key = getattr(blk, "_start_key_host", None)
    if key is None:
        key = blk._start_key_host = blk.pack.read("trace.start_ms")
    return key


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
        span_out=False, tiles=staged.tiles,
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
            span_out=False, tiles=staged.tiles,
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


# ---- stacked multi-block device search (parallel/search.py)

def _count_struct_nodes(tree) -> int:
    """Struct ('>' / '>>' / '~') nodes in a condition tree. Each one
    costs its own span-axis lhs-mask all_gather on the mesh, so the
    pre-IO budget estimate scales with the count.
    ('struct', op, lhs, rhs): t[1] is the op STRING, never recursed."""
    if not isinstance(tree, tuple):
        return 0
    n = 1 if tree[0] == "struct" else 0
    children = tree[2:] if tree[0] == "struct" else tree[1:]
    return n + sum(_count_struct_nodes(ch) for ch in children if isinstance(ch, tuple))


def _has_deep_struct(tree) -> bool:
    """True when any '>>' or '~' node is present: those relations walk
    the gathered parent table, one gather per launch on top of the
    per-node masks ('>' runs off the local parent column)."""
    if not isinstance(tree, tuple):
        return False
    if tree[0] == "struct" and tree[1] in (">>", "~"):
        return True
    children = tree[2:] if tree[0] == "struct" else tree[1:]
    return any(_has_deep_struct(ch) for ch in children if isinstance(ch, tuple))


def _stacked_words_est(items, needed: list[str], tree, sp: int,
                       S_b: int, NT_b: int, attr_b: dict[str, int]) -> int:
    """Per-block stacked-column words the mesh program will hold on the
    device, estimated before any column IO, so that an over-budget group
    falls back without paying the cold reads (the reference's estimate,
    tempo_tpu/db/search.py:1003-1049): per-axis products, plus each
    struct node's lhs mask gathered onto every rank, plus one gathered
    parent table (and the pointer-doubling temporaries) for a tree with
    any '>>' or '~' node."""
    from ..parallel.search import struct_pack_enabled

    span_cols = [n for n in needed if n.startswith("span.")]
    est = S_b * max(1, len(span_cols))
    est += NT_b * sum(1 for n in needed if n.startswith("trace."))
    res_cols = [n for n in needed if n.startswith("res.")]
    if res_cols:
        r_rows = max((blk.pack.n_rows_of(n) for blk, _ in items for n in res_cols), default=1)
        est += bucket(max(r_rows, 1)) * len(res_cols)
    for pre, a_b in attr_b.items():
        n_val_cols = sum(1 for n in needed
                         if n.startswith(f"{pre}.") and not n.endswith((".span", ".res")))
        est += a_b * n_val_cols + (S_b + 1 if pre == "sattr" else 0)  # values + off
    if struct_pack_enabled():
        est += S_b * sp * _count_struct_nodes(tree)
        if _has_deep_struct(tree):
            est += 4 * S_b * sp
    else:  # TEMPO_STRUCT_PACK=0: every node gathers lm / pid / valid + temps
        est += 6 * S_b * sp * _count_struct_nodes(tree)
    return est


def search_blocks_device(blocks: list[BackendBlock], req: SearchRequest, mesh,
                         default_limit: int = DEFAULT_LIMIT) -> SearchResponse | None:
    """Search many blocks as ONE stacked mesh program: blocks shard over
    dp, span rows and generic-attr rows over sp, operands resolved
    through each block's dictionary (parallel/search.sharded_search).
    Each block's candidates are selected on the host (select_topk_host)
    and verified as on the single-card route. Returns None only when the
    stacked columns (with the struct gathers) exceed the device budget:
    the caller falls back to per-block search. Columns are read block by
    block."""
    resp = SearchResponse()
    in_range = [b for b in blocks if b.meta.overlaps_time(req.start, req.end)]
    live = [(blk, p) for blk, p in ((b, _plan_for_block(b, req)) for b in in_range)
            if not p.prune]
    if not live:
        return resp
    # identical plan structure -> one mesh program per group
    groups: dict[tuple, list] = {}
    for blk, p in live:
        groups.setdefault((p.tree, p.conds), []).append((blk, p))
    results: list[SearchResult] = []
    for (tree, conds), items in groups.items():
        got = _search_group_device(items, tree, conds, req, mesh, resp)
        if got is None:
            return None
        results.extend(got)
    results.sort(key=lambda r: -r.start_time_unix_nano)
    # a trace cut into several blocks hits in each: dedupe by trace id,
    # as SearchResponse.merge does on the per-block route
    seen: set[str] = set()
    deduped = []
    for r in results:
        if r.trace_id not in seen:
            seen.add(r.trace_id)
            deduped.append(r)
    resp.traces = deduped[: req.limit or default_limit]
    return resp


def _search_group_device(items, tree, conds, req: SearchRequest, mesh, resp: SearchResponse):
    from ..parallel.search import sharded_search

    io0 = [blk.pack.bytes_read for blk, _ in items]
    stacked = stack_group(items, tree, conds, mesh)
    if stacked is None:
        return None
    host, n_spans, operands, NT_b = stacked
    tm, sc = sharded_search(mesh, tree, conds, operands, host, n_spans, nt=NT_b)

    limit = req.limit or DEFAULT_LIMIT
    results: list[SearchResult] = []
    for bi, (blk, p) in enumerate(items):
        nt = blk.meta.total_traces
        mask, cnt = tm[bi][:nt], sc[bi][:nt]
        key = _start_key_host(blk)[:nt]

        def selector(k, mask=mask, cnt=cnt, key=key):
            return select_topk_host(mask, key, cnt, k)

        results.extend(_collect_topk(blk, req, p.needs_verify, selector, limit))
        resp.inspected_spans += int(n_spans[bi])
        resp.inspected_bytes += blk.pack.bytes_read - io0[bi]
    return results


def stack_group(items, tree, conds, mesh):
    """A plan group's (block, plan) items stacked for the mesh program:
    (columns by name, n_spans (Bp,), per-block Operands, NT_b), Bp the
    blocks padded to a multiple of dp. None when the estimate before any
    column IO exceeds the device budget (counted in the routing) or a
    column cannot be stacked."""
    from .batchexec import record_routing

    dp, sp = mesh.dp, mesh.sp
    # the stacked program reads raw columns: no span@ materialization;
    # extra_cols carries span.parent_idx for struct nodes
    needed = [n for n in required_columns(conds) + list(items[0][1].extra_cols)
              if not n.startswith("span@")]
    B = len(items)
    Bp = ((B + dp - 1) // dp) * dp
    s_max = max(blk.pack.axes[S.AX_SPAN].n_rows for blk, _ in items)
    S_b = sp * bucket(max(1, -(-max(s_max, 1) // sp)))
    NT_b = bucket(max(max(blk.meta.total_traces for blk, _ in items), 1))
    # attr rows ride sp like span rows, bucketed from the widest block's
    # axis metadata (no IO); resource attrs have no row-group axis, so
    # they take the smallest bucket, as in the reference
    attr_b: dict[str, int] = {}
    for pre, ax in (("sattr", S.AX_SATTR), ("rattr", S.AX_RATTR)):
        if f"{pre}.key_id" in needed:
            a_max = max(blk.pack.axes[ax].n_rows if ax in blk.pack.axes else 0
                        for blk, _ in items)
            attr_b[pre] = sp * bucket(max(1, -(-max(a_max, 1) // sp)))
    est = _stacked_words_est(items, needed, tree, sp, S_b, NT_b, attr_b)
    if Bp * est * 4 > _DEVICE_SEARCH_MAX_BYTES:
        record_routing("search_mesh", "fallback", "pre_io_budget", n=len(items))
        return None

    per_block = [{n: blk.pack.read(n) for n in needed} for blk, _ in items]
    n_res_per = [max((a.shape[0] for n, a in cols.items() if n.startswith("res.")), default=1)
                 for cols in per_block]
    R_b = bucket(max(max(n_res_per), 1))
    host: dict[str, np.ndarray] = {}
    for n in needed:
        pre = n.split(".", 1)[0]
        if n == "trace.span_off":
            # padded trace rows are empty segments: repeat the last offset
            out = np.zeros((Bp, NT_b + 1), dtype=np.int32)
            for bi, cols in enumerate(per_block):
                a = cols[n]
                out[bi, : a.shape[0]] = a
                out[bi, a.shape[0]:] = a[-1] if a.size else 0
            host[n] = out
            continue
        if n in ("sattr.span", "rattr.res"):
            # owner rows (grouped by owner) -> per-owner offsets over the
            # global rows, whole on every rank of a dp row
            n_seg_b = S_b if n == "sattr.span" else R_b
            out = np.zeros((Bp, n_seg_b + 1), dtype=np.int32)
            for bi, cols in enumerate(per_block):
                owners = cols[n]
                n_seg = (items[bi][0].pack.axes[S.AX_SPAN].n_rows if n == "sattr.span"
                         else n_res_per[bi])
                cnt = (np.bincount(np.clip(owners, 0, max(n_seg, 1) - 1),
                                   minlength=max(n_seg, 1))
                       if owners.size else np.zeros(max(n_seg, 1), dtype=np.int64))
                off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
                out[bi, : off.shape[0]] = off
                out[bi, off.shape[0]:] = off[-1]
            host[f"{pre}.off"] = out
            continue
        if n.startswith("span."):
            shape = (Bp, S_b)
        elif pre in attr_b:
            shape = (Bp, attr_b[pre])
        elif n.startswith("res."):
            shape = (Bp, R_b)
        elif n.startswith("trace."):
            shape = (Bp, NT_b)
        else:
            return None
        first = per_block[0][n]
        if first.dtype not in (np.int32, np.float32):
            return None
        out = np.full(shape, PAD_I32 if first.dtype == np.int32 else np.float32(0),
                      dtype=first.dtype)
        for bi, cols in enumerate(per_block):
            a = cols[n]
            out[bi, : a.shape[0]] = a
        host[n] = out

    n_spans = np.zeros((Bp,), dtype=np.int32)
    for bi, (blk, _) in enumerate(items):
        n_spans[bi] = blk.pack.axes[S.AX_SPAN].n_rows
    operands = [Operands.build(p.rows, p.tables or None) for _, p in items]
    operands += [Operands.build([(0, 0, 0, 0.0, 0.0)] * len(conds))] * (Bp - B)
    return host, n_spans, operands, NT_b


# ---- tag name / value discovery (the reference's /api/search/tags
# endpoints; host numpy over the block's columns, no kernel)


def search_tags(blk: BackendBlock, collector: DistinctStringCollector) -> None:
    """Every attribute key of the block (span, then resource attrs, each
    in code order) and the well-known resource tags it holds."""
    d = blk.dictionary
    for col in ("sattr.key_id", "rattr.key_id"):
        for c in np.unique(blk.pack.read(col)):
            if c >= 0:
                collector.collect(d.string(int(c)))
    # well-known resource attrs live only in dedicated columns
    for tag, col in _WELL_KNOWN_RES.items():
        if blk.pack.has(col) and (blk.pack.read(col) >= 0).any():
            collector.collect(tag)


def search_tag_values(blk: BackendBlock, tag: str, collector: DistinctStringCollector) -> None:
    """Every value of `tag` in the block: the intrinsic `name`, a
    well-known resource column, then the span and resource attribute rows
    with that key (strings, ints, bools; floats are not listed). The
    reference collects row by row; here each distinct (type, value) is
    collected once, in the order of its first row, which leaves the
    collector (its set, its byte cap, `exceeded`) exactly as the
    reference's row loop leaves it."""
    d = blk.dictionary
    kcode = d.lookup(tag)
    if tag == _INTRINSIC_NAME:
        for c in np.unique(blk.pack.read("span.name_id")):
            if c >= 0:
                collector.collect(d.string(int(c)))
        return
    ded = _WELL_KNOWN_RES.get(tag)
    if ded and blk.pack.has(ded):
        for c in np.unique(blk.pack.read(ded)):
            if c >= 0:
                collector.collect(d.string(int(c)))
    if kcode < 0:
        return
    for pre in ("sattr", "rattr"):
        mask = blk.pack.read(f"{pre}.key_id") == kcode
        if not mask.any():
            continue
        vt = blk.pack.read(f"{pre}.vtype")[mask]
        keep = (vt == 0) | (vt == 1) | (vt == 3)
        kind = vt[keep].astype(np.int64)
        i64 = blk.pack.read(f"{pre}.int64")[mask][keep].astype(np.int64)
        sid = blk.pack.read(f"{pre}.str_id")[mask][keep].astype(np.int64)
        val = np.where(kind == 0, sid, np.where(kind == 1, i64, (i64 != 0).astype(np.int64)))
        if not kind.size:
            continue
        _, first = np.unique(np.stack([kind, val], axis=1), axis=0, return_index=True)
        for j in np.sort(first):
            k, v = int(kind[j]), int(val[j])
            collector.collect(d.string(v) if k == 0 else str(v) if k == 1
                              else ("true" if v else "false"))
