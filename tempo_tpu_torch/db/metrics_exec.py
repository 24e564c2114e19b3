"""TraceQL metrics execution: `{...} | rate() by(...)` over the blocklist
(port of tempo_tpu/db/metrics_exec.py, serial driver).

  * per block, the spanset filter plans to the SAME condition tree the
    search path uses (traceql/plan.plan_metrics_filter, span level -- no
    trace lift), and the fused filter->bucketize->segmented-fold kernel
    B6 (ops/timeseries) produces [num_groups, num_buckets] accumulators
    in one pass on the card; a step or origin past int32 milliseconds
    takes the numpy engine instead, with identical results;
  * group keys (`by(...)`) resolve host-side through each block's own
    dictionary into dense per-span group ids; label STRINGS are the
    cross-block join key, so per-block code spaces never leak out;
  * per-block partial series merge with plain accumulator addition
    (min/max fold elementwise);
  * plans that are conservative (lossy encodings, unsupported
    constructs, pipelines with intermediate stages) take the EXACT
    engine: the host span mask only narrows the candidate traces, which
    are materialized and re-evaluated span by span with the exact host
    evaluator (traceql/hosteval) -- the conservative-filter/exact-verify
    split of search.

On a mesh of more than one rank the stacked fold of db/metrics_mesh
takes every clean block set. The pooled driver and the cold-read
prefetch of the JAX package are not part of the port yet.

Time axis: step-aligned buckets over [start_ms, end_ms); a span lands in
bucket (span_abs_ms - start_ms) // step_ms by its START time, where
span_abs_ms = block_base_ms + span.start_ms (the block-relative floored
millisecond encoding -- both engines and the exact path share this
definition so results are bit-identical across engines).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..block.reader import BackendBlock
from ..ops.filter import Operands, required_columns
from ..traceql.ast import (
    Field as QField,
    MetricsQuery,
    ParseError,
    Pipeline,
    Scope,
)
from ..traceql.plan import plan_metrics_filter

# one source of truth for enum label names: the exact evaluator's maps
# (themselves the inverse of ast.STATUS_NAMES/KIND_NAMES) -- a drifted
# copy here would label columnar and exact series differently
from ..traceql.hosteval import _KIND_NAMES, _STATUS_NAMES
from .batchexec import record_routing

# unified group-key encoding (per block): every resolvable by() value
# maps into one int64 space so span- and resource-side lookups of an
# EITHER-scope attribute can be combined with a plain where()
_TAG_STR, _TAG_INT, _TAG_BOOL, _TAG_STATUS, _TAG_KIND = 0, 1, 2, 3, 4
_INT_HALF = 1 << 43


def _enc_str(codes: np.ndarray) -> np.ndarray:
    out = codes.astype(np.int64)
    return np.where(out >= 0, (_TAG_STR << 44) | out, np.int64(-1))


def _enc_int(vals: np.ndarray) -> np.ndarray:
    v = np.clip(vals.astype(np.int64), -_INT_HALF, _INT_HALF - 1)
    return (np.int64(_TAG_INT) << 44) | (v + _INT_HALF)


def _enc_tagged(tag: int, vals: np.ndarray) -> np.ndarray:
    return (np.int64(tag) << 44) | vals.astype(np.int64)


# the schema's dedicated-column maps are authoritative (the builder
# diverts these keys OUT of the generic attr tables, incl. the
# cluster/namespace/pod/container -> res.*_id2 aliases); dict-code
# columns end in _id, everything else is a raw int column
from ..block.schema import WELL_KNOWN_RES_ATTRS as _WELL_KNOWN_RES
from ..block.schema import WELL_KNOWN_SPAN_ATTRS as _WK_SPAN

_WELL_KNOWN_SPAN_STR = {k: v for k, v in _WK_SPAN.items() if v.endswith("_id")}
_WELL_KNOWN_SPAN_INT = {k: v for k, v in _WK_SPAN.items() if not v.endswith("_id")}

# ------------------------------------------------------------- request

MAX_BUCKETS = 4096  # request-axis cap: 400 at the API, not an OOM later
# accumulator cap (padded groups x padded buckets): bounds memory on
# every engine and keeps the combined
# (group, bucket) segment index far from int32 overflow. A query whose
# by() cardinality blows past it fails with ValueError -> 400.
MAX_ACC_CELLS = 1 << 22


@dataclass
class MetricsRequest:
    """Step-aligned range-query axis (ms since epoch); end exclusive.
    (end_ms - start_ms) must be a positive multiple of step_ms --
    align_params builds a valid one from raw API seconds."""

    query: str
    start_ms: int
    end_ms: int
    step_ms: int

    @property
    def n_buckets(self) -> int:
        return (self.end_ms - self.start_ms) // self.step_ms


def align_params(query: str, start_s: float, end_s: float, step_s: float) -> MetricsRequest:
    """Raw API params -> aligned MetricsRequest: start floors and end
    ceils onto the step grid (Prometheus range-query alignment), so the
    bucket axis only depends on (step, grid), never on the exact request
    instant -- the property that makes time-sharded jobs mergeable."""
    step_ms = max(1, int(round(step_s * 1000)))
    start_ms = (int(start_s * 1000) // step_ms) * step_ms
    end_ms = -(-int(end_s * 1000) // step_ms) * step_ms
    if end_ms <= start_ms:
        end_ms = start_ms + step_ms
    if (end_ms - start_ms) // step_ms > MAX_BUCKETS:
        raise ValueError(
            f"query_range spans {(end_ms - start_ms) // step_ms} steps "
            f"(max {MAX_BUCKETS}); raise step or narrow the range")
    return MetricsRequest(query=query, start_ms=start_ms, end_ms=end_ms,
                          step_ms=step_ms)


def request_to_dict(req: MetricsRequest) -> dict:
    return {"query": req.query, "start_ms": req.start_ms,
            "end_ms": req.end_ms, "step_ms": req.step_ms}


def request_from_dict(d: dict) -> MetricsRequest:
    return MetricsRequest(query=d["query"], start_ms=int(d["start_ms"]),
                          end_ms=int(d["end_ms"]), step_ms=int(d["step_ms"]))


# ------------------------------------------------------------- response

# mergeable per-series accumulator state, by metrics fn
_STATE_FIELDS = {
    "rate": ("count",),
    "count_over_time": ("count",),
    "sum_over_time": ("vcnt", "vsum"),
    "avg_over_time": ("vcnt", "vsum"),
    "min_over_time": ("vcnt", "vmin"),
    "max_over_time": ("vcnt", "vmax"),
}
_FIELD_INIT = {"count": 0, "vcnt": 0, "vsum": 0.0,
               "vmin": np.inf, "vmax": -np.inf}


def _new_state(fn: str, nb: int) -> dict[str, np.ndarray]:
    return {f: np.full(nb, _FIELD_INIT[f],
                       dtype=np.int64 if f in ("count", "vcnt") else np.float64)
            for f in _STATE_FIELDS[fn]}


def _merge_field(name: str, dst: np.ndarray, src: np.ndarray) -> None:
    if name == "vmin":
        np.minimum(dst, src, out=dst)
    elif name == "vmax":
        np.maximum(dst, src, out=dst)
    else:
        dst += src


@dataclass
class MetricsResponse:
    """Partial or final result: per-series accumulator STATE on the
    request's bucket axis (merge-friendly); finalize with
    series_values / to_prometheus."""

    fn: str
    start_ms: int
    step_ms: int
    n_buckets: int
    label_names: tuple = ()
    series: dict = field(default_factory=dict)  # labels tuple -> state dict
    inspected_spans: int = 0
    inspected_bytes: int = 0

    def add_partial(self, labels: tuple, state: dict, offset: int = 0) -> None:
        """Merge one partial series whose arrays start at bucket
        `offset` of this response's axis (time-sharded jobs)."""
        dst = self.series.get(labels)
        if dst is None:
            dst = self.series[labels] = _new_state(self.fn, self.n_buckets)
        for f, arr in state.items():
            _merge_field(f, dst[f][offset:offset + len(arr)], arr)

    def merge(self, other: "MetricsResponse") -> None:
        off = (other.start_ms - self.start_ms) // self.step_ms
        for labels, state in other.series.items():
            self.add_partial(labels, state, offset=off)
        self.inspected_spans += other.inspected_spans
        self.inspected_bytes += other.inspected_bytes


def response_to_dict(resp: MetricsResponse) -> dict:
    return {
        "fn": resp.fn, "start_ms": resp.start_ms, "step_ms": resp.step_ms,
        "n_buckets": resp.n_buckets, "label_names": list(resp.label_names),
        "series": [
            {"labels": list(labels),
             "state": {f: a.tolist() for f, a in state.items()}}
            for labels, state in resp.series.items()
        ],
        "inspectedSpans": resp.inspected_spans,
        "inspectedBytes": resp.inspected_bytes,
    }


def response_from_dict(d: dict) -> MetricsResponse:
    resp = MetricsResponse(
        fn=d["fn"], start_ms=int(d["start_ms"]), step_ms=int(d["step_ms"]),
        n_buckets=int(d["n_buckets"]), label_names=tuple(d.get("label_names", [])),
        inspected_spans=int(d.get("inspectedSpans", 0)),
        inspected_bytes=int(d.get("inspectedBytes", 0)),
    )
    for s in d.get("series", []):
        resp.series[tuple(s["labels"])] = {
            f: np.asarray(a, dtype=np.int64 if f in ("count", "vcnt") else np.float64)
            for f, a in s["state"].items()
        }
    return resp


def series_values(resp: MetricsResponse, state: dict) -> np.ndarray:
    """Finalize one series' state into per-bucket float values; NaN
    marks buckets with no samples (value folds only -- count folds are
    dense, a bucket with nothing is a legitimate 0)."""
    fn = resp.fn
    if fn == "rate":
        return state["count"].astype(np.float64) / (resp.step_ms / 1000.0)
    if fn == "count_over_time":
        return state["count"].astype(np.float64)
    empty = state["vcnt"] == 0
    if fn == "sum_over_time":
        out = state["vsum"].copy()
    elif fn == "avg_over_time":
        with np.errstate(invalid="ignore", divide="ignore"):
            out = state["vsum"] / state["vcnt"]
    elif fn == "min_over_time":
        out = state["vmin"].copy()
    else:
        out = state["vmax"].copy()
    out[empty] = np.nan
    return out


def _fmt_value(v: float) -> str:
    """Full round-trip sample formatting (Prometheus emits shortest
    exact form): integral values as integers, others via repr -- a
    %g-style 6-digit truncation would corrupt large exact counts."""
    if v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def to_prometheus(resp: MetricsResponse) -> dict:
    """Prometheus query_range JSON (matrix result): series labels from
    the by() clause, sample timestamps at each bucket's start."""
    result = []
    for labels in sorted(resp.series):
        vals = series_values(resp, resp.series[labels])
        samples = []
        for i in range(resp.n_buckets):
            v = vals[i]
            if np.isnan(v):
                continue
            ts = (resp.start_ms + i * resp.step_ms) / 1000.0
            samples.append([ts, _fmt_value(float(v))])
        if not samples:
            continue
        result.append({"metric": dict(zip(resp.label_names, labels)),
                       "values": samples})
    return {"status": "success",
            "data": {"resultType": "matrix", "result": result}}


# --------------------------------------------------------- by() / values


def expr_label(e, i: int = 0) -> str:
    """Series label key for one by() expression (the query-surface
    attribute path for fields; positional for general expressions)."""
    if isinstance(e, QField):
        if e.scope == Scope.INTRINSIC:
            return e.name
        if e.scope == Scope.SPAN:
            return f"span.{e.name}"
        if e.scope == Scope.RESOURCE:
            return f"resource.{e.name}"
        return f".{e.name}"
    return f"by{i}"


def _label_of(enc: int, d) -> str:
    """Decode one unified group-key code back to its label string."""
    tag, v = enc >> 44, enc & ((1 << 44) - 1)
    if tag == _TAG_STR:
        return d.string(int(v))
    if tag == _TAG_INT:
        return str(int(v) - _INT_HALF)
    if tag == _TAG_BOOL:
        return "true" if v else "false"
    if tag == _TAG_STATUS:
        return _STATUS_NAMES.get(int(v), str(int(v)))
    return _KIND_NAMES.get(int(v), str(int(v)))


def _attr_enc(blk: BackendBlock, pre: str, n_owner: int, key: str) -> np.ndarray | None:
    """Generic attr table -> per-owner unified group code (-1 absent).
    str/int/bool values encode; complex rows stay absent on EVERY
    engine (the exact evaluator drops non-scalar labels too); any
    float-valued row makes the whole field unsupported (None) so the
    exact engine labels it -- a silent columnar drop would disagree
    with the exact path's float labels."""
    d = blk.dictionary
    kcode = d.lookup(key)
    out = np.full(max(n_owner, 1), -1, np.int64)
    if kcode < 0:
        return out[:n_owner]
    keys = blk.pack.read(f"{pre}.key_id")
    sel = keys == kcode
    if not sel.any():
        return out[:n_owner]
    owner_col = "sattr.span" if pre == "sattr" else "rattr.res"
    owner = blk.pack.read(owner_col)[sel]
    vt = blk.pack.read(f"{pre}.vtype")[sel]
    if (vt == 2).any():
        return None
    enc = np.full(owner.shape[0], -1, np.int64)
    if (vt == 0).any():
        enc[vt == 0] = _enc_str(blk.pack.read(f"{pre}.str_id")[sel][vt == 0])
    if (vt == 1).any():
        iv = blk.pack.read(f"{pre}.int64")[sel][vt == 1]
        if (np.abs(iv) >= _INT_HALF).any():
            # the 44-bit tagged encoding would clip (and so mislabel /
            # merge) huge int values: exact engine labels them instead
            return None
        enc[vt == 1] = _enc_int(iv)
    if (vt == 3).any():
        enc[vt == 3] = _enc_tagged(
            _TAG_BOOL, (blk.pack.read(f"{pre}.int64")[sel][vt == 3] != 0))
    ok = (enc >= 0) & (owner >= 0) & (owner < n_owner)
    out[owner[ok]] = enc[ok]
    return out[:n_owner]


def _gather_res(enc_res: np.ndarray, res_idx: np.ndarray) -> np.ndarray:
    safe = np.clip(res_idx, 0, max(enc_res.shape[0] - 1, 0))
    out = enc_res[safe] if enc_res.size else np.full(res_idx.shape[0], -1, np.int64)
    return np.where(res_idx >= 0, out, np.int64(-1))


def _by_codes(blk: BackendBlock, f) -> np.ndarray | None:
    """Per-span unified group code for one by() field; None = this
    field can't resolve columnar (exact engine takes over)."""
    if not isinstance(f, QField) or f.parent:
        return None
    pack = blk.pack
    n_spans = pack.axes["span"].n_rows if "span" in pack.axes else 0
    if f.scope == Scope.INTRINSIC:
        if f.name == "name":
            return _enc_str(pack.read("span.name_id"))
        if f.name == "status":
            return _enc_tagged(_TAG_STATUS, pack.read("span.status"))
        if f.name == "kind":
            return _enc_tagged(_TAG_KIND, pack.read("span.kind"))
        if f.name in ("rootName", "rootServiceName"):
            col = ("trace.root_name_id" if f.name == "rootName"
                   else "trace.root_service_id")
            tsid = pack.read("span.trace_sid")
            tcol = pack.read(col)
            return _enc_str(tcol[np.clip(tsid, 0, max(tcol.shape[0] - 1, 0))])
        return None  # duration/childCount/...: continuous or structural
    span_enc = res_enc = None
    if f.scope in (Scope.SPAN, Scope.EITHER):
        ded = _WELL_KNOWN_SPAN_STR.get(f.name)
        ded_int = _WELL_KNOWN_SPAN_INT.get(f.name)
        if ded is not None:
            span_enc = _enc_str(pack.read(ded))
        elif ded_int is not None:
            col = pack.read(ded_int)
            span_enc = np.where(col >= 0, _enc_int(col), np.int64(-1))
        else:
            span_enc = _attr_enc(blk, "sattr", n_spans, f.name)
            if span_enc is None:  # float-valued rows: exact engine only
                return None
    if f.scope in (Scope.RESOURCE, Scope.EITHER):
        res_idx = pack.read("span.res_idx")
        ded = _WELL_KNOWN_RES.get(f.name)
        if ded is not None and pack.has(ded):
            res_enc = _gather_res(_enc_str(pack.read(ded)), res_idx)
        else:
            n_res = int(res_idx.max()) + 1 if res_idx.size else 0
            enc_r = _attr_enc(blk, "rattr", n_res, f.name)
            if enc_r is None:
                return None
            res_enc = _gather_res(enc_r, res_idx)
    if span_enc is not None and res_enc is not None:
        return np.where(span_enc >= 0, span_enc, res_enc)
    return span_enc if span_enc is not None else res_enc


def _value_column(blk: BackendBlock, expr) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-span (float64 value, present mask) for a *_over_time(field)
    argument, from the EXACT host columns (int64/f64/start_ns), so both
    engines fold the true values; None = exact engine only."""
    if not isinstance(expr, QField) or expr.parent:
        return None
    pack = blk.pack
    n_spans = pack.axes["span"].n_rows if "span" in pack.axes else 0
    if expr.scope == Scope.INTRINSIC:
        if expr.name == "duration":
            s = pack.read("span.start_ns").astype(np.int64)
            e = pack.read("span.end_ns").astype(np.int64)
            return (np.maximum(e - s, 0) / 1e9,
                    np.ones(n_spans, dtype=bool))
        return None

    def attr_vals(pre: str, n_owner: int):
        d = blk.dictionary
        kcode = d.lookup(expr.name)
        val = np.zeros(max(n_owner, 1))
        pres = np.zeros(max(n_owner, 1), dtype=bool)
        if kcode < 0:
            return val[:n_owner], pres[:n_owner]
        keys = pack.read(f"{pre}.key_id")
        sel = keys == kcode
        if not sel.any():
            return val[:n_owner], pres[:n_owner]
        owner_col = "sattr.span" if pre == "sattr" else "rattr.res"
        owner = pack.read(owner_col)[sel]
        vt = pack.read(f"{pre}.vtype")[sel]
        v = np.where(vt == 1, pack.read(f"{pre}.int64")[sel].astype(np.float64),
                     pack.read(f"{pre}.f64")[sel])
        num = (vt == 1) | (vt == 2)
        ok = num & (owner >= 0) & (owner < n_owner)
        val[owner[ok]] = v[ok]
        pres[owner[ok]] = True
        return val[:n_owner], pres[:n_owner]

    span_vp = res_vp = None
    if expr.scope in (Scope.SPAN, Scope.EITHER):
        ded_int = _WELL_KNOWN_SPAN_INT.get(expr.name)
        if ded_int is not None:
            col = pack.read(ded_int)
            span_vp = (col.astype(np.float64), col >= 0)
        else:
            span_vp = attr_vals("sattr", n_spans)
    if expr.scope in (Scope.RESOURCE, Scope.EITHER):
        res_idx = pack.read("span.res_idx")
        n_res = int(res_idx.max()) + 1 if res_idx.size else 0
        rv, rp = attr_vals("rattr", n_res)
        safe = np.clip(res_idx, 0, max(n_res - 1, 0))
        if n_res:
            res_vp = (rv[safe], rp[safe] & (res_idx >= 0))
        else:
            res_vp = (np.zeros(n_spans), np.zeros(n_spans, dtype=bool))
    if span_vp is not None and res_vp is not None:
        val = np.where(span_vp[1], span_vp[0], res_vp[0])
        return val, span_vp[1] | res_vp[1]
    return span_vp if span_vp is not None else res_vp


# -------------------------------------------------------- block engines


def _check_cardinality(n_groups: int, nb: int) -> None:
    from ..ops.device import bucket

    if bucket(max(n_groups, 1)) * bucket(max(nb, 1)) > MAX_ACC_CELLS:
        raise ValueError(
            f"metrics series cardinality too high: {n_groups} groups x "
            f"{nb} buckets exceeds the accumulator budget; narrow the "
            "by() clause, the time range, or raise step")


def _block_axis(blk: BackendBlock, req: MetricsRequest):
    """Clip the request's bucket axis to the block's time range:
    (bucket_offset, n_local_buckets, t0_rel_ms). The kernel only ever
    folds the overlapping slice, and t0 stays within int32 (block-
    relative ms)."""
    base_ms = blk.meta.start_time_unix_nano // 1_000_000
    end_ms = -(-blk.meta.end_time_unix_nano // 1_000_000)
    b_lo = max(0, (base_ms - req.start_ms) // req.step_ms)
    b_hi = min(req.n_buckets, -(-(end_ms - req.start_ms) // req.step_ms))
    if b_hi <= b_lo:
        return 0, 0, 0
    t0_rel = req.start_ms + b_lo * req.step_ms - base_ms
    return int(b_lo), int(b_hi - b_lo), int(t0_rel)


def _outs_to_series(outs, fn: str, gid_labels: list, b_off: int,
                    resp: MetricsResponse) -> None:
    """Kernel accumulators -> merged response series at bucket offset."""
    if fn in ("rate", "count_over_time"):
        counts = outs[0]
        for g, labels in enumerate(gid_labels):
            row = counts[g]
            if row.any():
                resp.add_partial(labels, {"count": row.astype(np.int64)}, b_off)
        return
    _, vcnt, vsum, vmin, vmax = outs
    per_fn = {"sum_over_time": ("vsum", vsum), "avg_over_time": ("vsum", vsum),
              "min_over_time": ("vmin", vmin), "max_over_time": ("vmax", vmax)}
    fname, arr = per_fn[fn]
    for g, labels in enumerate(gid_labels):
        if vcnt[g].any():
            resp.add_partial(
                labels,
                {"vcnt": vcnt[g].astype(np.int64),
                 fname: arr[g].astype(np.float64)},
                b_off,
            )


def resolve_groups(blk: BackendBlock, by: tuple):
    """by() fields -> (per-span dense gid int32 (-1 drops the span),
    group label tuples). None when some field can't resolve columnar."""
    pack = blk.pack
    n_spans = pack.axes["span"].n_rows if "span" in pack.axes else 0
    if not by:
        return np.zeros(n_spans, np.int32), [()]
    encs = []
    for f in by:
        e = _by_codes(blk, f)
        if e is None:
            return None
        encs.append(e)
    stacked = np.stack(encs, axis=1)  # (n_spans, k)
    present = (stacked >= 0).all(axis=1)
    gid = np.full(n_spans, -1, np.int32)
    if not present.any():
        return gid, []
    uniq, inv = np.unique(stacked[present], axis=0, return_inverse=True)
    gid[present] = inv.reshape(-1).astype(np.int32)
    d = blk.dictionary
    labels = [tuple(_label_of(int(code), d) for code in row) for row in uniq]
    return gid, labels


def metrics_block(blk: BackendBlock, q: MetricsQuery, req: MetricsRequest,
                  resp: MetricsResponse, device=None) -> None:
    """Evaluate one block's contribution and merge it into resp: the
    exact engine for lossy plans and unplannable by()/value fields; else
    the device fold (B6) when the bucket math fits int32, and the numpy
    engine on an i32 overflow. The reference also sends cold readers to
    the numpy engine; the port has no cold reader yet (TempoDB pins
    every block it opens), so that route waits for the host engine."""
    if not blk.meta.overlaps_time(req.start_ms // 1000, -(-req.end_ms // 1000)):
        return
    b_off, nb, t0_rel = _block_axis(blk, req)
    if nb == 0:
        return
    io0 = blk.pack.bytes_read
    planned = plan_metrics_filter(q, blk.dictionary)
    if planned.prune:
        return
    groups = resolve_groups(blk, q.agg.by)
    vals = None
    has_val = q.agg.field is not None
    if groups is not None and has_val:
        vals = _value_column(blk, q.agg.field)
    if planned.needs_verify:
        exact, exact_reason = True, "lossy_plan"
    elif groups is None:
        exact, exact_reason = True, "unplannable_by"
    elif has_val and vals is None:
        exact, exact_reason = True, "unplannable_value"
    else:
        exact, exact_reason = False, ""
    if exact:
        record_routing("metrics", "exact", exact_reason)
        _metrics_block_exact(blk, q, req, resp, planned, b_off, nb)
        resp.inspected_bytes += blk.pack.bytes_read - io0
        return
    gid, labels = groups
    if not labels:
        return
    _check_cardinality(len(labels), nb)
    val, pres = vals if vals is not None else (None, None)
    query = (planned.tree, planned.conds)
    operands = Operands.build(planned.rows, planned.tables or None)
    # trace.span_off only serves the search path's tracify; the span-
    # level fold never touches it -- don't read or stage it
    needed = [n for n in required_columns(planned.conds)
              if n != "trace.span_off"] + ["span.start_ms"]
    # the device fold buckets in int32 (block-relative ms): a step or
    # origin past int32 ms (~24.8 days) runs on the int64 host engine
    # instead -- identical results, no overflow
    i32_ok = req.step_ms < 2**31 and -(2**31) < t0_rel < 2**31
    n_spans = blk.pack.axes["span"].n_rows if "span" in blk.pack.axes else 0
    if i32_ok:
        from ..ops.stage import stage_block
        from ..ops.timeseries import eval_timeseries_device

        record_routing("metrics", "device", "hot_block")
        staged = stage_block(blk, needed, device=device)
        outs = eval_timeseries_device(query, staged, operands, gid, val, pres,
                                      t0_rel, req.step_ms, nb, len(labels))
    else:
        from ..ops.timeseries import eval_timeseries_host

        record_routing("metrics", "host", "i32_range")
        cols = {n: blk.pack.read(n) for n in needed
                if not n.startswith("span@") and blk.pack.has(n)}
        outs = eval_timeseries_host(query, cols, operands, n_spans, blk.meta.total_traces,
                                    gid, val, pres, t0_rel, req.step_ms, nb, len(labels))
    _outs_to_series(outs, q.agg.fn, labels, b_off, resp)
    resp.inspected_spans += n_spans
    resp.inspected_bytes += blk.pack.bytes_read - io0


# ------------------------------------------------------------ exact path


def _label_value(v) -> str | None:
    from ..traceql.hosteval import _is_num

    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return v
    if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
        if v[0] == "status":
            return _STATUS_NAMES.get(int(v[1]), str(v[1]))
        if v[0] == "kind":
            return _KIND_NAMES.get(int(v[1]), str(v[1]))
    if _is_num(v):
        return str(int(v)) if isinstance(v, int) else repr(float(v))
    return None


def _fold_params(q: MetricsQuery) -> tuple:
    """(filt, count_fn, fname, vscale) of the exact fold."""
    filt = Pipeline(q.filter, q.stages) if q.stages else q.filter
    agg = q.agg
    count_fn = agg.fn in ("rate", "count_over_time")
    fname = {"sum_over_time": "vsum", "avg_over_time": "vsum",
             "min_over_time": "vmin", "max_over_time": "vmax"}.get(agg.fn)
    # duration-typed fold values are SECONDS on the wire (the columnar
    # engines fold span.start/end_ns deltas / 1e9); the exact evaluator
    # yields nanoseconds, so scale by the argument's static type
    vscale = 1.0
    if agg.field is not None:
        from ..traceql.validate import _expr_type

        try:
            if _expr_type(agg.field) == "duration":
                vscale = 1e-9
        except Exception:
            pass
    return filt, count_fn, fname, vscale


def _fold_span(local: dict, agg, sp, res, ctx, b: int, nb: int,
               count_fn: bool, fname, vscale: float) -> None:
    """Fold ONE matched span into the per-label state dict."""
    from ..traceql.hosteval import _is_num, _value

    labels = []
    for f in agg.by:
        lv = _label_value(_value(f, sp, res, ctx))
        if lv is None:
            return
        labels.append(lv)
    key = tuple(labels)
    state = local.get(key)
    if state is None:
        _check_cardinality(len(local) + 1, nb)
    if count_fn:
        if state is None:
            state = local[key] = {"count": np.zeros(nb, np.int64)}
        state["count"][b] += 1
        return
    v = _value(agg.field, sp, res, ctx)
    if not _is_num(v):
        return
    if state is None:
        varr = (np.zeros(nb, np.float64) if fname == "vsum"
                else np.full(nb, _FIELD_INIT[fname], np.float64))
        state = local[key] = {"vcnt": np.zeros(nb, np.int64), fname: varr}
    state["vcnt"][b] += 1
    v = float(v) * vscale
    if fname == "vsum":
        state[fname][b] += v
    elif fname == "vmin":
        state[fname][b] = min(state[fname][b], v)
    else:
        state[fname][b] = max(state[fname][b], v)


def metrics_live_traces(traces, q: MetricsQuery, req: MetricsRequest,
                        resp: MetricsResponse) -> None:
    """Fold DECODED live traces (the ingester's merged live head) into
    resp with the exact host evaluator -- the leg that makes unflushed
    spans visible to TraceQL metrics. Buckets use absolute span-start ms
    on the request's step grid. The block engines floor through the
    block base (base_ms + rel_ms, the columnar ms encoding), so a span
    within 1 ms of a step edge inside a block whose base_ns has a
    sub-ms remainder can land one bucket differently after flush --
    bounded at 1 ms and invisible at realistic steps."""
    from ..traceql.hosteval import _matched_spans, _TraceCtx

    filt, count_fn, fname, vscale = _fold_params(q)
    agg = q.agg
    nb = req.n_buckets
    local: dict[tuple, dict[str, np.ndarray]] = {}
    n_spans = 0
    for tr in traces:
        ctx = _TraceCtx(tr)
        for sp, res in _matched_spans(filt, ctx):
            n_spans += 1
            b = (sp.start_unix_nano // 1_000_000 - req.start_ms) // req.step_ms
            if not 0 <= b < nb:
                continue
            _fold_span(local, agg, sp, res, ctx, int(b), nb, count_fn, fname, vscale)
    for key, state in local.items():
        resp.add_partial(key, state, 0)
    resp.inspected_spans += n_spans


def _metrics_block_exact(blk: BackendBlock, q: MetricsQuery, req: MetricsRequest,
                         resp: MetricsResponse, planned, b_off: int, nb: int) -> None:
    """Exact engine: the conservative host span mask narrows the
    candidate traces; each is materialized and re-evaluated span by
    span with the exact host evaluator (incl. pipelines, parent scope,
    lossy leaves). Folds use exact span start times under the SAME
    floored-ms bucket definition as the columnar engines."""
    from ..ops.hostfilter import eval_span_mask_host
    from ..traceql.hosteval import _matched_spans, _TraceCtx

    n_traces = blk.meta.total_traces
    n_spans = blk.pack.axes["span"].n_rows if "span" in blk.pack.axes else 0
    if planned.tree is None:
        sids = list(range(n_traces))
    else:
        operands = Operands.build(planned.rows, planned.tables or None)
        cols = {n: blk.pack.read(n) for n in required_columns(planned.conds)
                if not n.startswith("span@") and n != "trace.span_off" and blk.pack.has(n)}
        mask = eval_span_mask_host((planned.tree, planned.conds), cols,
                                   operands, n_spans, n_traces)
        tsid = cols.get("span.trace_sid")
        if tsid is None:
            tsid = blk.pack.read("span.trace_sid")
        sids = np.unique(tsid[mask]).tolist()
    resp.inspected_spans += n_spans
    if not sids:
        return
    filt, count_fn, fname, vscale = _fold_params(q)
    base_ns = blk.meta.start_time_unix_nano
    base_ms = base_ns // 1_000_000
    t0_abs = req.start_ms + b_off * req.step_ms
    agg = q.agg
    local: dict[tuple, dict[str, np.ndarray]] = {}
    for lo in range(0, len(sids), 512):  # bounded materialization
        for tr in blk.materialize_traces(sids[lo:lo + 512]):
            ctx = _TraceCtx(tr)
            for sp, res in _matched_spans(filt, ctx):
                rel_ms = (sp.start_unix_nano - base_ns) // 1_000_000
                b = (base_ms + rel_ms - t0_abs) // req.step_ms
                if not 0 <= b < nb:
                    continue
                _fold_span(local, agg, sp, res, ctx, int(b), nb,
                           count_fn, fname, vscale)
    for key, state in local.items():
        resp.add_partial(key, state, b_off)


# ---------------------------------------------------------- orchestrator


def parse_metrics_query(query: str) -> MetricsQuery:
    from ..traceql.parser import parse

    q = parse(query)
    if not isinstance(q, MetricsQuery):
        raise ParseError(
            "not a metrics query: expected a terminal rate() / "
            "*_over_time() stage (e.g. `{ ... } | rate() by(...)`)")
    return q


def metrics_query_range_blocks(blocks: list[BackendBlock], req: MetricsRequest,
                               device=None, mesh=None) -> MetricsResponse:
    """Run one metrics range query over a block set: per-block folds,
    one block after another, partial series merged by label strings.
    With a mesh of more than one rank, clean same-structure plans run as
    ONE stacked fold over the mesh with an all_reduce combine
    (db/metrics_mesh, parallel/timeseries); everything else stays
    per-block."""
    q = parse_metrics_query(req.query)
    resp = MetricsResponse(
        fn=q.agg.fn, start_ms=req.start_ms, step_ms=req.step_ms,
        n_buckets=req.n_buckets,
        label_names=tuple(expr_label(e, i) for i, e in enumerate(q.agg.by)),
    )
    in_range = [b for b in blocks
                if b.meta.overlaps_time(req.start_ms // 1000, -(-req.end_ms // 1000))]
    if mesh is not None and mesh.size > 1 and len(in_range) > 1:
        from .metrics_mesh import try_metrics_mesh

        if try_metrics_mesh(mesh, in_range, q, req, resp):
            return resp
    for blk in in_range:
        metrics_block(blk, q, req, resp, device=device)
    return resp
