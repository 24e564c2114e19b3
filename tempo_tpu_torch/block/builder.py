"""vtpu block builder: sorted (trace_id, Trace) stream -> columnar block.

The write-side analog of vparquet's create.go:37-67 (WAL iterator ->
rows -> row-group cuts -> backend), but producing the span-major SoA
layout of schema.py. Blocks it writes are the same vtpu2 blocks the JAX
package writes (tempo_tpu/block/builder.py), and either package reads
the other's. The rows accumulate on the host; finalize runs the cut's
three device steps -- the dictionary remap of every code column (B9a),
the bloom bits (B9b) and the row-group stats (B9c) -- through
ops/blockcut.py on the builder's device: the kernels on a card, their
plain versions on the CPU. Traces MUST be added in ascending trace-id order
(the WAL iterator and compaction merge both yield sorted streams), which
makes `trace.id_codes` sorted => device lookup is a searchsorted.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..backend.base import RawBackend
from ..ops import blockcut
from ..ops.device import resolve_device
from ..wire.model import Trace
from ..wire.otlp_json import _value_from_json, _value_to_json
from . import schema as S
from .bloom import ShardedBloom
from .colio import AxisChunks, pack_columns_stream
from .dictionary import DictBuilder, Dictionary
from .meta import BlockMeta, RowGroupStats

DATA_NAME = "data.vtpu"
DICT_NAME = "dict.vtpu"
BLOOM_PREFIX = "bloom-"


def _attr_row(dictb: DictBuilder, value) -> tuple[int, int, int, float, int, float]:
    """-> (vtype, str_id, int32, f32, int64, f64)."""
    if isinstance(value, bool):
        return S.VT_BOOL, -1, int(value), 0.0, int(value), 0.0
    if isinstance(value, str):
        return S.VT_STR, dictb.code(value), 0, 0.0, 0, 0.0
    if isinstance(value, int):
        i32 = int(np.clip(value, -(2**31), 2**31 - 1))
        return S.VT_INT, -1, i32, float(value), value, 0.0
    if isinstance(value, float):
        return S.VT_FLOAT, -1, 0, np.float32(value).item(), 0, value
    # bytes / lists / anything else: exact OTLP-JSON payload in the dict
    payload = json.dumps(_value_to_json(value), separators=(",", ":"), sort_keys=True)
    return S.VT_COMPLEX, dictb.code(payload), 0, 0.0, 0, 0.0


def decode_attr_value(vtype: int, str_id: int, i32: int, i64: int, f64: float, d: Dictionary):
    if vtype == S.VT_STR:
        return d.string(str_id)
    if vtype == S.VT_INT:
        return int(i64)
    if vtype == S.VT_FLOAT:
        return float(f64)
    if vtype == S.VT_BOOL:
        return bool(i32)
    return _value_from_json(json.loads(d.string(str_id)))


class _AttrTable:
    """CSR attribute accumulator: one row per attr with an owner index."""

    def __init__(self):
        self.owner: list[int] = []
        self.key_id: list[int] = []
        self.vtype: list[int] = []
        self.str_id: list[int] = []
        self.i32: list[int] = []
        self.f32: list[float] = []
        self.i64: list[int] = []
        self.f64: list[float] = []

    def add(self, dictb: DictBuilder, owner: int, key: str, value) -> None:
        vt, sid, i32, f32, i64, f64 = _attr_row(dictb, value)
        self.owner.append(owner)
        self.key_id.append(dictb.code(key))
        self.vtype.append(vt)
        self.str_id.append(sid)
        self.i32.append(i32)
        self.f32.append(f32)
        self.i64.append(i64)
        self.f64.append(f64)

    def columns(self, prefix: str, owner_col: str) -> dict[str, np.ndarray]:
        return {
            f"{prefix}.{owner_col}": np.asarray(self.owner, dtype=np.int32),
            f"{prefix}.key_id": np.asarray(self.key_id, dtype=np.int32),
            f"{prefix}.vtype": np.asarray(self.vtype, dtype=np.int32),
            f"{prefix}.str_id": np.asarray(self.str_id, dtype=np.int32),
            f"{prefix}.int32": np.asarray(self.i32, dtype=np.int32),
            f"{prefix}.f32": np.asarray(self.f32, dtype=np.float32),
            f"{prefix}.int64": np.asarray(self.i64, dtype=np.int64),
            f"{prefix}.f64": np.asarray(self.f64, dtype=np.float64),
        }


@dataclass
class FinalizedBlock:
    meta: BlockMeta
    cols: dict[str, np.ndarray]
    axes: dict[str, AxisChunks]
    col_axis: dict[str, str]
    dictionary: Dictionary
    bloom: ShardedBloom


class BlockBuilder:
    def __init__(
        self,
        tenant: str,
        block_id: str | None = None,
        row_group_spans: int = S.DEFAULT_ROW_GROUP_SPANS,
        estimated_traces: int = 0,
        compaction_level: int = 0,
        replication_factor: int = 1,
        device=None,
    ):
        self.meta = BlockMeta.new(tenant, block_id)
        self.device = resolve_device(device)
        self.meta.compaction_level = compaction_level
        self.meta.replication_factor = replication_factor
        self.row_group_spans = row_group_spans
        self.estimated_traces = estimated_traces
        self.dictb = DictBuilder()
        self.dictb.code("")  # code 0 is always the empty string

        # span accumulators
        self.sp_trace_sid: list[int] = []
        self.sp_name: list[int] = []
        self.sp_service: list[int] = []
        self.sp_kind: list[int] = []
        self.sp_status: list[int] = []
        self.sp_start_ns: list[int] = []
        self.sp_end_ns: list[int] = []
        self.sp_http_status: list[int] = []
        self.sp_http_method: list[int] = []
        self.sp_http_url: list[int] = []
        self.sp_res_idx: list[int] = []
        self.sp_scope_idx: list[int] = []
        self.sp_id: list[bytes] = []
        self.sp_parent_id: list[bytes] = []
        self.sp_parent_idx: list[int] = []  # block row of the parent, -1 = root
        self.sp_trace_state: list[int] = []
        self.sp_status_msg: list[int] = []
        self.sp_dropped: list[int] = []
        self.sattr = _AttrTable()

        # trace accumulators
        self.tr_ids: list[bytes] = []
        self.tr_span_off: list[int] = [0]
        self.tr_start_ns: list[int] = []
        self.tr_end_ns: list[int] = []
        self.tr_root_service: list[int] = []
        self.tr_root_name: list[int] = []

        # resource / scope tables
        self.res_dedicated: dict[str, list[int]] = {
            col: [] for col in sorted(set(S.WELL_KNOWN_RES_ATTRS.values()))
        }
        self.rattr = _AttrTable()
        self.scope_key_to_idx: dict[tuple[int, int], int] = {}
        self.scope_name: list[int] = []
        self.scope_version: list[int] = []

        # events / links
        self.ev_span: list[int] = []
        self.ev_time_ns: list[int] = []
        self.ev_name: list[int] = []
        self.ev_dropped: list[int] = []
        self.evattr = _AttrTable()
        self.ln_span: list[int] = []
        self.ln_trace_id: list[bytes] = []
        self.ln_span_id: list[bytes] = []
        self.ln_state: list[int] = []
        self.lnattr = _AttrTable()

    # ------------------------------------------------------------------
    def add_trace(self, trace_id: bytes, trace: Trace) -> None:
        tid = trace_id.rjust(16, b"\x00")
        if self.tr_ids and tid <= self.tr_ids[-1]:
            raise ValueError("traces must be added in ascending unique id order")
        sid = len(self.tr_ids)
        self.tr_ids.append(tid)

        t_start, t_end = None, 0
        root_service, root_name = None, None
        first_service, first_name = None, None
        code = self.dictb.code

        # collect (start, ...) rows then sort spans within the trace by start
        rows = []
        for rs in trace.resource_spans:
            res_idx = len(self.res_dedicated["res.service_id"])
            # dedicated resource columns + generic rattr rows
            for col in self.res_dedicated:
                self.res_dedicated[col].append(-1)
            for k, v in rs.resource.attrs.items():
                ded = S.WELL_KNOWN_RES_ATTRS.get(k)
                if ded is not None and isinstance(v, str):
                    self.res_dedicated[ded][res_idx] = code(v)
                else:
                    self.rattr.add(self.dictb, res_idx, k, v)
            service = rs.resource.service_name
            svc_code = code(service) if service else -1
            self.res_dedicated["res.service_id"][res_idx] = svc_code

            for ss in rs.scope_spans:
                skey = (code(ss.scope.name), code(ss.scope.version))
                scope_idx = self.scope_key_to_idx.get(skey)
                if scope_idx is None:
                    scope_idx = len(self.scope_name)
                    self.scope_key_to_idx[skey] = scope_idx
                    self.scope_name.append(skey[0])
                    self.scope_version.append(skey[1])
                for sp in ss.spans:
                    rows.append((sp.start_unix_nano, res_idx, scope_idx, svc_code, sp))

        rows.sort(key=lambda r: (r[0], r[4].span_id))
        # parent ROW index within the block (span.parent_idx): parents
        # resolve within the trace, so one pass over the sorted rows
        # suffices; -1 = root / parent span not in this trace. Backs the
        # device/host structural operators (> >> ~) as exact gather /
        # segment ops (ops/filter 'struct' nodes) -- the reference
        # evaluates these relations row-by-row in its engine instead
        # (pkg/traceql/enum_operators.go OpSpansetChild/Descendant/Sibling).
        base = len(self.sp_trace_sid)
        local_of = {r[4].span_id: j for j, r in enumerate(rows) if r[4].span_id}
        # -1 = root (no parent id); -2 = ORPHAN (parent id set but that
        # span is absent from the trace -- dropped/partial ingest). The
        # distinction keeps the sibling operator exact-able: orphans can
        # still be siblings by shared parent ID, which the row-index
        # kernels over-match and host verification settles.
        for start_ns, res_idx, scope_idx, svc_code, sp in rows:
            pid = sp.parent_span_id
            has_pid = bool(pid and pid.strip(b"\x00"))
            j = local_of.get(pid) if has_pid else None
            self.sp_parent_idx.append(
                base + j if j is not None else (-2 if has_pid else -1))
        for start_ns, res_idx, scope_idx, svc_code, sp in rows:
            row = len(self.sp_trace_sid)
            self.sp_trace_sid.append(sid)
            self.sp_name.append(code(sp.name))
            self.sp_service.append(svc_code)
            self.sp_kind.append(int(sp.kind))
            self.sp_status.append(int(sp.status_code))
            self.sp_start_ns.append(sp.start_unix_nano)
            self.sp_end_ns.append(sp.end_unix_nano)
            self.sp_res_idx.append(res_idx)
            self.sp_scope_idx.append(scope_idx)
            self.sp_id.append(sp.span_id.ljust(8, b"\x00")[:8])
            self.sp_parent_id.append(sp.parent_span_id.ljust(8, b"\x00")[:8])
            self.sp_trace_state.append(code(sp.trace_state))
            self.sp_status_msg.append(code(sp.status_message))
            self.sp_dropped.append(sp.dropped_attributes_count)

            http_status, http_method, http_url = -1, -1, -1
            for k, v in sp.attrs.items():
                if k == "http.status_code" and isinstance(v, int) and not isinstance(v, bool):
                    http_status = int(np.clip(v, -(2**31), 2**31 - 1))
                elif k == "http.method" and isinstance(v, str):
                    http_method = code(v)
                elif k == "http.url" and isinstance(v, str):
                    http_url = code(v)
                self.sattr.add(self.dictb, row, k, v)
            self.sp_http_status.append(http_status)
            self.sp_http_method.append(http_method)
            self.sp_http_url.append(http_url)

            for e in sp.events:
                ev = len(self.ev_span)
                self.ev_span.append(row)
                self.ev_time_ns.append(e.time_unix_nano)
                self.ev_name.append(code(e.name))
                self.ev_dropped.append(e.dropped_attributes_count)
                for k, v in e.attrs.items():
                    self.evattr.add(self.dictb, ev, k, v)
            for l in sp.links:
                ln = len(self.ln_span)
                self.ln_span.append(row)
                self.ln_trace_id.append(l.trace_id.rjust(16, b"\x00")[:16])
                self.ln_span_id.append(l.span_id.ljust(8, b"\x00")[:8])
                self.ln_state.append(code(l.trace_state))
                for k, v in l.attrs.items():
                    self.lnattr.add(self.dictb, ln, k, v)

            if t_start is None or start_ns < t_start:
                t_start = start_ns
            t_end = max(t_end, sp.end_unix_nano)
            if first_service is None:
                first_service, first_name = svc_code, code(sp.name)
            if root_service is None and not sp.parent_span_id.strip(b"\x00"):
                root_service, root_name = svc_code, code(sp.name)

        self.tr_span_off.append(len(self.sp_trace_sid))
        self.tr_start_ns.append(t_start or 0)
        self.tr_end_ns.append(t_end)
        self.tr_root_service.append(root_service if root_service is not None else (first_service or 0))
        self.tr_root_name.append(root_name if root_name is not None else (first_name or 0))

    # ------------------------------------------------------------------
    def finalize(self, bloom: ShardedBloom | None = None) -> FinalizedBlock:
        """Assemble columns + meta. `bloom` (optional) is a precomputed
        filter covering every added trace id: compaction passes the OR
        union of the input blocks' filters (ops/bloom_ops.py) instead of
        re-inserting every id."""
        n_spans = len(self.sp_trace_sid)
        n_traces = len(self.tr_ids)
        dictionary, remap = self.dictb.finalize()
        cut = blockcut.CutEngine(self.device)
        # every code column of the cut, remapped together (one B9a launch)
        attr_cols = {prefix: table.columns(prefix, owner) for table, prefix, owner in (
            (self.sattr, "sattr", "span"), (self.rattr, "rattr", "res"),
            (self.evattr, "evattr", "ev"), (self.lnattr, "lnattr", "ln"))}
        code_cols = {
            "span.name_id": self.sp_name, "span.service_id": self.sp_service,
            "span.http_method_id": self.sp_http_method, "span.http_url_id": self.sp_http_url,
            "span.trace_state_id": self.sp_trace_state, "span.status_msg_id": self.sp_status_msg,
            "trace.root_service_id": self.tr_root_service, "trace.root_name_id": self.tr_root_name,
            "scope.name_id": self.scope_name, "scope.version_id": self.scope_version,
            "ev.name_id": self.ev_name, "ln.state_id": self.ln_state, **self.res_dedicated,
            **{f"{p}.{f}": tcols[f"{p}.{f}"] for p, tcols in attr_cols.items()
               for f in ("key_id", "str_id")}}
        remapped = dict(zip(code_cols, cut.remap_many(list(code_cols.values()),
                                                      cut.table(remap))))
        rm = remapped.__getitem__

        start_ns = np.asarray(self.sp_start_ns, dtype=np.uint64)
        end_ns = np.asarray(self.sp_end_ns, dtype=np.uint64)
        base_ns = int(start_ns.min()) if n_spans else 0
        start_ms = ((start_ns.astype(np.int64) - base_ns) // 1_000_000).astype(np.int32)
        dur_ns_full = np.maximum(end_ns.astype(np.int64) - start_ns.astype(np.int64), 0)
        dur_us = np.clip(dur_ns_full // 1_000, 0, 2**31 - 1).astype(np.int32)
        # ns remainder: (dur_us, dur_lo) compare == exact ns compare on device
        dur_lo = (dur_ns_full % 1_000).astype(np.int32)

        tr_start_ns = np.asarray(self.tr_start_ns, dtype=np.uint64)
        tr_end_ns = np.asarray(self.tr_end_ns, dtype=np.uint64)
        tr_start_ms = ((tr_start_ns.astype(np.int64) - base_ns) // 1_000_000).astype(np.int32)
        tr_end_ms = ((tr_end_ns.astype(np.int64) - base_ns) // 1_000_000).astype(np.int32)
        tr_dur_full = np.maximum(tr_end_ns.astype(np.int64) - tr_start_ns.astype(np.int64), 0)
        tr_dur_us = np.clip(tr_dur_full // 1_000, 0, 2**31 - 1).astype(np.int32)
        tr_dur_lo = (tr_dur_full % 1_000).astype(np.int32)

        id_codes = np.asarray(
            [S.trace_id_to_codes(t) for t in self.tr_ids], dtype=np.int32
        ).reshape(n_traces, 4)

        cols: dict[str, np.ndarray] = {
            "span.trace_sid": np.asarray(self.sp_trace_sid, dtype=np.int32),
            "span.name_id": rm("span.name_id"),
            "span.service_id": rm("span.service_id"),
            "span.kind": np.asarray(self.sp_kind, dtype=np.int32),
            "span.status": np.asarray(self.sp_status, dtype=np.int32),
            "span.start_ms": start_ms,
            "span.dur_us": dur_us,
            "span.dur_lo": dur_lo,
            "span.http_status": np.asarray(self.sp_http_status, dtype=np.int32),
            "span.http_method_id": rm("span.http_method_id"),
            "span.http_url_id": rm("span.http_url_id"),
            "span.res_idx": np.asarray(self.sp_res_idx, dtype=np.int32),
            "span.start_ns": start_ns,
            "span.end_ns": end_ns,
            "span.id": np.frombuffer(b"".join(self.sp_id) or b"", dtype=np.uint8).reshape(n_spans, 8),
            "span.parent_id": np.frombuffer(b"".join(self.sp_parent_id) or b"", dtype=np.uint8).reshape(n_spans, 8),
            "span.parent_idx": np.asarray(self.sp_parent_idx, dtype=np.int32),
            "span.trace_state_id": rm("span.trace_state_id"),
            "span.status_msg_id": rm("span.status_msg_id"),
            "span.dropped_attrs": np.asarray(self.sp_dropped, dtype=np.int32),
            "span.scope_idx": np.asarray(self.sp_scope_idx, dtype=np.int32),
            "trace.id": np.frombuffer(b"".join(self.tr_ids) or b"", dtype=np.uint8).reshape(n_traces, 16),
            "trace.id_codes": id_codes,
            "trace.span_off": np.asarray(self.tr_span_off, dtype=np.int32),
            "trace.start_ms": tr_start_ms,
            "trace.end_ms": tr_end_ms,
            "trace.dur_us": tr_dur_us,
            "trace.dur_lo": tr_dur_lo,
            "trace.root_service_id": rm("trace.root_service_id"),
            "trace.root_name_id": rm("trace.root_name_id"),
            "trace.start_ns": tr_start_ns,
            "trace.end_ns": tr_end_ns,
            "scope.name_id": rm("scope.name_id"),
            "scope.version_id": rm("scope.version_id"),
            "ev.span": np.asarray(self.ev_span, dtype=np.int32),
            "ev.time_ns": np.asarray(self.ev_time_ns, dtype=np.uint64),
            "ev.name_id": rm("ev.name_id"),
            "ev.dropped": np.asarray(self.ev_dropped, dtype=np.int32),
            "ln.span": np.asarray(self.ln_span, dtype=np.int32),
            "ln.trace_id": np.frombuffer(b"".join(self.ln_trace_id) or b"", dtype=np.uint8).reshape(len(self.ln_span), 16),
            "ln.span_id": np.frombuffer(b"".join(self.ln_span_id) or b"", dtype=np.uint8).reshape(len(self.ln_span), 8),
            "ln.state_id": rm("ln.state_id"),
        }
        for col in self.res_dedicated:
            cols[col] = rm(col)

        # trace-resource membership summary (tres axis): one row per
        # (trace, resource) pair with the span count, offsets per trace.
        # Res-scoped queries (service.name etc., the dominant search
        # shape) evaluate over ~resources-per-trace rows instead of the
        # full span axis -- a ~10x smaller cold decode than span.res_idx.
        # No reference analog: vparquet nests spans under ResourceSpans so
        # its res predicates skip span pages for free (schema.go:75-172);
        # this is the SoA equivalent of that skip.
        cols.update(build_tres(cols["span.trace_sid"], cols["span.res_idx"], n_traces))
        for prefix, tcols in attr_cols.items():
            tcols[f"{prefix}.key_id"] = rm(f"{prefix}.key_id")
            tcols[f"{prefix}.str_id"] = rm(f"{prefix}.str_id")
            cols.update(tcols)

        axes, col_axis, row_groups = compute_row_groups(cols, start_ms, dur_us,
                                                        self.row_group_spans, kernels=cut)

        m = self.meta
        m.total_traces = n_traces
        m.total_spans = n_spans
        m.min_id = self.tr_ids[0].hex() if self.tr_ids else ""
        m.max_id = self.tr_ids[-1].hex() if self.tr_ids else ""
        m.start_time_unix_nano = base_ns
        m.end_time_unix_nano = int(end_ns.max()) if n_spans else 0
        m.dict_size = len(dictionary)
        m.row_groups = row_groups

        if bloom is None:
            if self.estimated_traces:
                bloom = ShardedBloom.for_estimated_items(max(self.estimated_traces, n_traces))
            else:
                bloom = ShardedBloom.for_estimated_items(max(n_traces, 1))
            if self.tr_ids:
                bloom.words = cut.bloom_bits(bloom.words, cols["trace.id"], bloom.shard_bits)
        m.bloom_shards = bloom.n_shards
        m.bloom_shard_bits = bloom.shard_bits

        return FinalizedBlock(m, cols, axes, col_axis, dictionary, bloom)


def build_tres(trace_sid: np.ndarray, res_idx: np.ndarray, n_traces: int) -> dict[str, np.ndarray]:
    """tres columns from the span axis: unique (trace, res) pairs with
    span counts, plus per-trace offsets. Vectorized: one 64-bit
    composite-key unique."""
    if len(trace_sid) == 0:
        return {
            "tres.res": np.empty(0, np.int32),
            "tres.nspans": np.empty(0, np.int32),
            "trace.tres_off": np.zeros(n_traces + 1, np.int32),
        }
    key = (trace_sid.astype(np.int64) << 32) | (
        res_idx.astype(np.int64) & 0xFFFFFFFF
    )
    uniq, counts = np.unique(key, return_counts=True)
    tres_sid = (uniq >> 32).astype(np.int32)
    tres_res = (uniq & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    off = np.searchsorted(tres_sid, np.arange(n_traces + 1, dtype=np.int64)).astype(np.int32)
    return {
        "tres.res": np.ascontiguousarray(tres_res),
        "tres.nspans": counts.astype(np.int32),
        "trace.tres_off": off,
    }


def compute_row_groups(cols, start_ms, dur_us, row_group_spans, kernels=None):
    """Row-group boundaries + per-group pruning stats from assembled
    columns (shared by the builder, the columnar compactor and
    util/synth.py). `kernels` (an ops/blockcut.CutEngine, optional) runs
    the per-group min/max as B9c; the stats are identical either way."""
    n_spans = len(cols["span.trace_sid"])
    bounds = list(range(0, n_spans, row_group_spans)) + [n_spans]
    if len(bounds) < 2:
        bounds = [0, 0]
    span_ax = AxisChunks(bounds)

    def child_axis(owner: np.ndarray) -> AxisChunks:
        offs = np.searchsorted(owner, bounds, side="left")
        offs[0], offs[-1] = 0, len(owner)
        return AxisChunks([int(x) for x in offs])

    axes = {
        S.AX_SPAN: span_ax,
        S.AX_SATTR: child_axis(cols["sattr.span"]),
        S.AX_EVENT: child_axis(cols["ev.span"]),
        S.AX_LINK: child_axis(cols["ln.span"]),
    }
    axes[S.AX_EVATTR] = AxisChunks(
        [int(x) for x in np.searchsorted(cols["evattr.ev"], axes[S.AX_EVENT].offsets)]
    )
    axes[S.AX_LNATTR] = AxisChunks(
        [int(x) for x in np.searchsorted(cols["lnattr.ln"], axes[S.AX_LINK].offsets)]
    )

    col_axis: dict[str, str] = {}
    for name in cols:
        pref = name.split(".", 1)[0]
        ax = {
            "span": S.AX_SPAN,
            "sattr": S.AX_SATTR,
            "ev": S.AX_EVENT,
            "evattr": S.AX_EVATTR,
            "ln": S.AX_LINK,
            "lnattr": S.AX_LNATTR,
        }.get(pref)
        if ax is not None:
            col_axis[name] = ax

    trace_sid = cols["span.trace_sid"]
    # with any spans at all, every group is non-empty; no spans, no launch
    mm = (kernels.rowgroup_minmax(start_ms, dur_us, row_group_spans)
          if kernels is not None and n_spans > 0 else None)
    row_groups = []
    for g in range(span_ax.n_groups):
        lo, hi = bounds[g], bounds[g + 1]
        if hi <= lo:
            row_groups.append(RowGroupStats(lo, hi, 0, 0, 0, 0, 0))
            continue
        row_groups.append(
            RowGroupStats(
                span_lo=lo,
                span_hi=hi,
                trace_lo=int(trace_sid[lo]),
                trace_hi=int(trace_sid[hi - 1]) + 1,
                start_ms_min=int(mm[0][g] if mm else start_ms[lo:hi].min()),
                start_ms_max=int(mm[1][g] if mm else start_ms[lo:hi].max()),
                dur_us_max=int(mm[2][g] if mm else dur_us[lo:hi].max()),
            )
        )
    return axes, col_axis, row_groups


# metadata axes every COLD query must decode before it can do anything
# (tres plan columns, trace candidate/result columns, res and scope
# tables): stored UNCOMPRESSED so a cold open's critical path is pure
# IO -- they are a few percent of pack bytes, so the block grows ~2-3%
# while cold queries skip their entire decompress step. (The const-chunk
# codec still applies, so absent optional columns stay one row.) The
# span/attr payload keeps the ratio-optimal zstd level.
FAST_DECODE_PREFIXES = ("trace.", "tres.", "res.", "scope.")


def _column_level(name: str):
    return "raw" if name.startswith(FAST_DECODE_PREFIXES) else None


def write_block(backend: RawBackend, fin: FinalizedBlock, level: int = 3,
                codec: str = "zstd", defer_meta: bool = False) -> BlockMeta:
    """Write all block objects; meta.json last so pollers never see a
    partial block (reference writes meta last for the same reason).
    codec selects the chunk compression (colio codec matrix); readers
    dispatch per chunk, so mixed-codec backends are fine.

    defer_meta=True holds back the meta.json write: the block stays
    invisible to pollers until publish_block_meta. The compaction
    pipeline commits a multi-output job this way, every output's data
    durable before the first meta appears."""
    from .versioned import CURRENT_VERSION

    m = fin.meta
    m.version = CURRENT_VERSION
    app = backend.open_append(m.tenant_id, m.block_id, DATA_NAME)
    try:
        for part in pack_columns_stream(fin.cols, fin.axes, fin.col_axis,
                                        level=level, codec=codec,
                                        level_for=_column_level):
            app.append(part)
        app.close()
    except BaseException:
        app.abort()
        raise
    backend.write(m.tenant_id, m.block_id, DICT_NAME, fin.dictionary.to_bytes())
    for i in range(fin.bloom.n_shards):
        backend.write(m.tenant_id, m.block_id, f"{BLOOM_PREFIX}{i}", fin.bloom.shard_bytes(i))
    m.size_bytes = app.bytes_written
    if not defer_meta:
        publish_block_meta(backend, m)
    return m


def publish_block_meta(backend: RawBackend, meta: BlockMeta) -> None:
    """Commit a block written with defer_meta=True: the meta.json write
    is the visibility point for pollers."""
    backend.write(meta.tenant_id, meta.block_id, "meta.json", meta.to_json())


def build_block_from_traces(
    backend: RawBackend,
    tenant: str,
    traces: list[tuple[bytes, Trace]],
    block_id: str | None = None,
    row_group_spans: int = S.DEFAULT_ROW_GROUP_SPANS,
    compaction_level: int = 0,
    codec: str = "zstd",
    device=None,
) -> BlockMeta:
    """Cut one block from (trace id, trace) pairs on `device` and write it.
    The device defaults to the first card (an error without one); the CPU
    runs only when named. TempoDB passes its own device."""
    b = BlockBuilder(tenant, block_id, row_group_spans, compaction_level=compaction_level,
                     device=device)
    for tid, t in sorted(traces, key=lambda p: p[0]):
        b.add_trace(tid, t)
    return write_block(backend, b.finalize(), codec=codec)
