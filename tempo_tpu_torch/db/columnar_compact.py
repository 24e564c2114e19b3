"""Columnar compaction: numpy-level K-way merge of vtpu blocks.

Port of tempo_tpu/db/columnar_compact.py on its numpy paths: the JAX
package moves row runs and remaps codes with its native library where
that is built (gather_runs*, dict_union) and with numpy otherwise; the
port keeps the numpy semantics (a per-source fancy-index copy, an
unfused remap, the bytes-level dictionary union), which give the same
output columns. The merge is host work; the only kernel it reaches is
the bloom union (B10a) when the inputs' filters fit.

The fast path the reference takes at parquet.Row level (no proto decode,
vparquet/compactor.go:23-80) re-expressed for the vtpu SoA layout: blocks
are id-sorted, so the merge order is one lexsort over the stacked 128-bit
trace ids; maximal runs of consecutive traces from one block move as
COLUMN SLICES -- span rows, attr rows, events, links all come along via
their sorted owner columns with two searchsorteds per table. No wire
model anywhere on the unique-id path. Only colliding ids (replicated
partial traces) are materialized, combined with span dedupe
(wire/combine.py, the reference's combiner.go analog), and re-flattened
through a one-trace builder.

Output blocks cut at a size target estimated from input bytes/trace
(reference: tempodb/compactor.go:21-30 flush/size targets) and stream to
the backend through the appender (v2/streaming_block.go role): one
column's chunks in memory at a time, never the serialized block.

Dictionaries merge as a sorted string union; every code column remaps
through one gather. The output bloom is the device OR-union of the
inputs' filters when a single output block is cut and the union stays
within design capacity (ops/bloom_ops.py, B10a), else rebuilt id by id.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass

import numpy as np

from ..backend.base import DoesNotExist, RawBackend
from ..block import schema as S
from ..block.bloom import ShardedBloom
from ..block.builder import (
    BLOOM_PREFIX,
    DATA_NAME,
    DICT_NAME,
    BlockBuilder,
    FinalizedBlock,
    compute_row_groups,
    publish_block_meta,
    write_block,
)
from ..block.colio import CODEC_CONST, CODEC_RAW, CODEC_ZSTD, is_broadcast
from ..block.dictionary import Dictionary, apply_remap, dict_union
from ..block.meta import BlockMeta
from ..block.reader import BackendBlock
from ..ops.device import resolve_device
from ..wire.combine import combine_traces
from .compactor import (
    CompactionJob,
    CompactionResult,
    CompactorConfig,
    _union_input_blooms,
)


class UnsupportedColumnar(Exception):
    """Inputs this merge can't handle columnar-ly; caller falls back to
    the wire-level merge."""


# dict-code columns (remapped into the merged dictionary at load)
_DICT_COLS = frozenset(
    {
        "span.name_id", "span.service_id", "span.http_method_id", "span.http_url_id",
        "span.trace_state_id", "span.status_msg_id",
        "trace.root_service_id", "trace.root_name_id",
        "scope.name_id", "scope.version_id",
        "ev.name_id", "ln.state_id",
    }
    | set(S.WELL_KNOWN_RES_ATTRS.values())
    | {f"{p}.key_id" for p in ("sattr", "rattr", "evattr", "lnattr")}
    | {f"{p}.str_id" for p in ("sattr", "rattr", "evattr", "lnattr")}
)


class _Source:
    """One input block (or one combined collision trace) as raw columns."""

    def __init__(self, cols: dict[str, np.ndarray], dictionary: Dictionary):
        self.cols = cols
        self.dictionary = dictionary
        self.span_off = cols["trace.span_off"]

    # below this size the whole pack is fetched with ONE ranged read
    # before decode (kills the per-chunk open/read fixed costs that
    # dominate the many-tiny-blocks compaction shape)
    PRELOAD_MAX_BYTES = 32 << 20

    @classmethod
    def from_block(cls, blk: BackendBlock) -> "_Source":
        if blk.meta.size_bytes and blk.meta.size_bytes <= cls.PRELOAD_MAX_BYTES:
            blk.pack.preload()
        # const columns arrive as stride-0 broadcast views: zero decode,
        # zero memory, and _assemble forwards them const when every
        # source agrees (the dominant case -- absent optional columns)
        return cls(blk.pack.read_all(broadcast_const=True), blk.dictionary)

    def remap_codes(self, remap: np.ndarray) -> None:
        """Re-encode dict-code columns into the merged dictionary."""
        for name in self.cols:
            if name in _DICT_COLS:
                self.cols[name] = apply_remap(self.cols[name], remap)


def _merge_order(ids: list[np.ndarray]):
    """Global id-sorted order over all source traces (one (n,16) id
    array per source). Returns (src_idx, sid, same_as_prev) arrays;
    same_as_prev marks duplicate-id entries (collisions)."""
    ids = [np.ascontiguousarray(x).reshape(-1, 16) for x in ids]
    n = sum(len(x) for x in ids)
    if n == 0:
        z = np.empty(0, dtype=np.int32)
        return z, z, np.empty(0, dtype=bool)
    all_ids = np.concatenate(ids)
    u = all_ids.view(">u8").astype(np.uint64).reshape(-1, 2)
    src = np.concatenate([np.full(len(x), i, np.int32) for i, x in enumerate(ids)])
    sid = np.concatenate([np.arange(len(x), dtype=np.int32) for x in ids])
    order = np.lexsort((src, u[:, 1], u[:, 0]))
    ou = u[order]
    same = np.zeros(n, dtype=bool)
    same[1:] = (ou[1:] == ou[:-1]).all(axis=1)
    return src[order], sid[order], same


def _combine_collision(blocks: list[BackendBlock], base_names: set[str],
                       members: list[tuple[int, int]], tenant: str, device) -> _Source:
    """Materialize + combine one duplicated trace id, re-flatten through a
    one-trace builder into a columnar source of its own."""
    b0, sid0 = members[0]
    tid = np.ascontiguousarray(
        blocks[b0].pack.read("trace.id")).reshape(-1, 16)[sid0].tobytes()
    traces = [blocks[b].materialize_traces([sid])[0] for b, sid in members]
    combined = combine_traces(traces)
    b = BlockBuilder(tenant, device=device)
    b.add_trace(tid, combined)
    fin = b.finalize()
    # today's builder may emit columns (e.g. tres.*) that pre-upgrade
    # input blocks lack; the merge machinery requires every source to
    # share one column set, so shape the collision source to the blocks'
    cols = {k: v for k, v in fin.cols.items() if k in base_names}
    if base_names - set(cols):
        raise UnsupportedColumnar(
            f"collision rebuild lacks columns {sorted(base_names - set(cols))}"
        )
    return _Source(cols, fin.dictionary)


def _const_source_row(s: _Source, n: str) -> np.ndarray | None:
    """The column's constant row if the source is constant on n: a
    stride-0 broadcast view (const-chunk read_all) or a small
    materialized array (collision rebuilds) that checks out constant."""
    a = s.cols[n]
    if a.ndim == 0 or a.size == 0:
        return None
    if is_broadcast(a):
        row = np.ascontiguousarray(a[0])
    elif a.nbytes <= 65536:
        row = np.ascontiguousarray(a[0])
        if not (a == row).all():
            return None
    else:
        return None
    return row


def _unique_vals(a: np.ndarray) -> np.ndarray:
    """np.unique that costs O(1) on stride-0 broadcast views."""
    if is_broadcast(a):
        return np.unique(np.ascontiguousarray(a[:1]))
    return np.unique(a)


def _ranges_to_idx(los: np.ndarray, his: np.ndarray) -> np.ndarray:
    """Vectorized multi-range arange: concatenate(arange(lo, hi) for each
    range) without a Python loop."""
    lens = his - los
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.cumsum(lens) - lens
    return np.repeat(los - starts, lens) + np.arange(total, dtype=np.int64)


def _run_copy(src: np.ndarray, dst: np.ndarray, src_offs: np.ndarray,
              dst_offs: np.ndarray, lens: np.ndarray) -> None:
    """Move row runs src->dst by one fancy-index gather and scatter."""
    si = _ranges_to_idx(src_offs, src_offs + lens)
    di = _ranges_to_idx(dst_offs, dst_offs + lens)
    dst[di] = src[si]


def _packed_offs(lens: np.ndarray) -> np.ndarray:
    cs = np.cumsum(lens)
    return cs - lens


def _assemble(tenant: str, sources: list[_Source],
              chunks: tuple[np.ndarray, np.ndarray, np.ndarray],
              merged: Dictionary, level: int, row_group_spans: int,
              bloom: ShardedBloom | None,
              consume: bool = False) -> FinalizedBlock:
    """Assemble one output block from (src, sid_lo, sid_hi) run arrays.

    Everything is per-SOURCE vectorized: each axis of each source
    contributes via exactly one gather + one scatter per column, so cost
    does not degrade when the merge interleaves finely (many tiny runs,
    the 1000-small-blocks compaction shape)."""
    csrc, clo, chi = chunks
    csrc = csrc.astype(np.int32)
    n_chunks = csrc.shape[0]
    names = list(sources[int(csrc[0])].cols)
    src_order = [int(s) for s in np.unique(csrc)]
    by_src = {si: np.nonzero(csrc == si)[0] for si in src_order}

    # per-chunk row ranges along every axis (one vectorized searchsorted
    # per source per child axis)
    span_lo = np.zeros(n_chunks, np.int64)
    span_hi = np.zeros(n_chunks, np.int64)
    child_axes = {  # axis -> (owner col, parent range arrays)
        "sattr": "sattr.span", "ev": "ev.span", "ln": "ln.span",
        "evattr": "evattr.ev", "lnattr": "lnattr.ln",
    }
    ax_lo = {a: np.zeros(n_chunks, np.int64) for a in child_axes}
    ax_hi = {a: np.zeros(n_chunks, np.int64) for a in child_axes}
    for si in src_order:
        s = sources[si]
        ii = by_src[si]
        span_lo[ii] = s.span_off[clo[ii]]
        span_hi[ii] = s.span_off[chi[ii]]
        for a in ("sattr", "ev", "ln"):
            owner = s.cols[child_axes[a]]
            ax_lo[a][ii] = np.searchsorted(owner, span_lo[ii], "left")
            ax_hi[a][ii] = np.searchsorted(owner, span_hi[ii], "left")
        for a, parent in (("evattr", "ev"), ("lnattr", "ln")):
            owner = s.cols[child_axes[a]]
            ax_lo[a][ii] = np.searchsorted(owner, ax_lo[parent][ii], "left")
            ax_hi[a][ii] = np.searchsorted(owner, ax_hi[parent][ii], "left")

    # tres (trace-resource membership, builder.build_tres) is a
    # trace-child axis whose per-chunk ranges come straight from the
    # source's offsets column -- no searchsorted needed
    has_tres = "tres.res" in names
    tres_lo = np.zeros(n_chunks, np.int64)
    tres_hi = np.zeros(n_chunks, np.int64)
    if has_tres:
        for si in src_order:
            toff = sources[si].cols["trace.tres_off"].astype(np.int64)
            ii = by_src[si]
            tres_lo[ii] = toff[clo[ii]]
            tres_hi[ii] = toff[chi[ii]]

    # per-chunk output bases per axis
    def bases(lens: np.ndarray) -> tuple[np.ndarray, int]:
        cs = np.cumsum(lens)
        return cs - lens, int(cs[-1]) if len(lens) else 0

    tr_b, n_traces = bases(chi - clo)
    sp_b, n_spans = bases(span_hi - span_lo)
    ax_b = {}
    ax_n = {}
    for a in child_axes:
        ax_b[a], ax_n[a] = bases(ax_hi[a] - ax_lo[a])
    tres_b, n_tres = bases(tres_hi - tres_lo)

    # per (source, axis) RUN tables: (src row starts, dst row starts, lens)
    runs_of: dict[tuple[int, str], tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    axis_ranges = {"trace": (clo, chi, tr_b), "span": (span_lo, span_hi, sp_b)}
    for a in child_axes:
        axis_ranges[a] = (ax_lo[a], ax_hi[a], ax_b[a])
    if has_tres:
        axis_ranges["tres"] = (tres_lo, tres_hi, tres_b)
    for si in src_order:
        ii = by_src[si]
        for a, (alo, ahi, ab) in axis_ranges.items():
            runs_of[(si, a)] = (alo[ii], ab[ii], ahi[ii] - alo[ii])

    def packed_gather(si: int, axis: str, src: np.ndarray) -> np.ndarray:
        """Gather source rows of one axis into PACKED dst order (the
        concatenation of this source's dst runs): the staging buffer for
        columns needing element-level math before placement. Broadcast
        (const) sources stay broadcast: any gather of a constant is the
        same constant."""
        s_offs, _, lens = runs_of[(si, axis)]
        n_packed = int(lens.sum())
        if is_broadcast(src):
            return np.broadcast_to(src[0], (n_packed,) + src.shape[1:])
        out = np.empty((n_packed,) + src.shape[1:], dtype=src.dtype)
        _run_copy(src, out, s_offs, _packed_offs(lens), lens)
        return out

    def packed_scatter(si: int, axis: str, packed: np.ndarray, out: np.ndarray) -> None:
        _, d_offs, lens = runs_of[(si, axis)]
        _run_copy(packed, out, _packed_offs(lens), d_offs, lens)

    # owner-column rebase offsets per PACKED row: dst parent base - src
    # parent lo, repeated per run
    parent_of = {"sattr": (sp_b, span_lo), "ev": (sp_b, span_lo), "ln": (sp_b, span_lo),
                 "evattr": (ax_b["ev"], ax_lo["ev"]), "lnattr": (ax_b["ln"], ax_lo["ln"])}

    def owner_off_packed(si: int, a: str) -> np.ndarray:
        ii = by_src[si]
        pb, plo = parent_of[a]
        return np.repeat(pb[ii] - plo[ii], (ax_hi[a] - ax_lo[a])[ii])

    # res/scope subsetting: only rows this block's spans reference
    span_resvals: dict[int, np.ndarray] = {}
    span_scopevals: dict[int, np.ndarray] = {}
    used_res: dict[int, np.ndarray] = {}
    used_scope: dict[int, np.ndarray] = {}
    res_base: dict[int, int] = {}
    scope_base: dict[int, int] = {}
    rb = sb = 0
    for si in src_order:
        rv = packed_gather(si, "span", sources[si].cols["span.res_idx"])
        sv = packed_gather(si, "span", sources[si].cols["span.scope_idx"])
        span_resvals[si], span_scopevals[si] = rv, sv
        ur = _unique_vals(rv)
        us = _unique_vals(sv)
        used_res[si] = ur[ur >= 0]
        used_scope[si] = us[us >= 0]
        res_base[si], scope_base[si] = rb, sb
        rb += used_res[si].shape[0]
        sb += used_scope[si].shape[0]

    def _translate(si: int, old: np.ndarray, used: dict[int, np.ndarray],
                   base: dict[int, int]) -> np.ndarray:
        u = used[si]
        if u.size and int(u[-1]) < (1 << 22):
            # dense lookup table: O(n) gather instead of the O(n log m)
            # searchsorted -- res/scope index spaces are small ints
            lut = np.zeros(int(u[-1]) + 1, np.int32)
            lut[u] = np.arange(u.size, dtype=np.int32)
            new = lut[np.clip(old, 0, int(u[-1]))] + base[si]
        else:
            new = np.searchsorted(u, old).astype(np.int32) + base[si]
        return np.where(old >= 0, new, old).astype(np.int32)

    axis_rows = {"trace": n_traces, "span": n_spans, **ax_n}
    if has_tres:
        axis_rows["tres"] = n_tres
    _OWNER_COLS = frozenset(
        {"sattr.span", "ev.span", "ln.span", "evattr.ev", "lnattr.ln"}
    )

    cols: dict[str, np.ndarray] = {}

    def _consume(n: str) -> None:
        # single-output jobs: each source column is read by exactly ONE
        # output column's pass, so free it the moment that pass is done.
        # Halves peak memory (sources + output no longer coexist whole)
        # and keeps the working set cache-resident. Exceptions that later
        # passes re-read: trace.tres_off and trace.span_off (the
        # recompute section) and rattr.res (every rattr VALUE column
        # filters by the owner).
        if consume and n not in ("trace.tres_off", "trace.span_off", "rattr.res"):
            for si in src_order:
                sources[si].cols.pop(n, None)

    for n in names:
        pref = n.split(".", 1)[0]
        like = sources[src_order[0]].cols[n]
        if n in ("span.trace_sid", "span.start_ms", "trace.span_off",
                 "trace.start_ms", "trace.end_ms", "trace.tres_off"):
            _consume(n)
            continue  # recomputed below
        if pref in axis_rows:
            # const fast path: when every source is constant on this
            # column with the SAME row (in merged-dictionary code space),
            # the output is that constant -- a stride-0 broadcast view
            # that costs nothing here and writes as const chunks. Index
            # columns whose values are rebased/translated per source
            # can't take it.
            if n not in ("span.res_idx", "tres.res", "span.parent_idx",
                         "span.scope_idx") and n not in _OWNER_COLS:
                rows = [_const_source_row(sources[si], n) for si in src_order]
                if all(r is not None for r in rows) and all(
                    r.dtype == rows[0].dtype and r.tobytes() == rows[0].tobytes()
                    for r in rows[1:]
                ):
                    cols[n] = np.broadcast_to(
                        rows[0].astype(like.dtype, copy=False),
                        (axis_rows[pref],) + like.shape[1:])
                    _consume(n)
                    continue
            out = np.empty((axis_rows[pref],) + like.shape[1:], dtype=like.dtype)
            for si in src_order:
                if n == "span.res_idx":
                    packed_scatter(si, pref, _translate(
                        si, span_resvals[si], used_res, res_base), out)
                elif n == "tres.res":
                    packed_scatter(si, pref, _translate(
                        si, packed_gather(si, pref, sources[si].cols[n]),
                        used_res, res_base), out)
                elif n == "span.parent_idx":
                    # parent rows live in the SAME trace, so the chunk's
                    # span-base shift rebases them; negative sentinels
                    # (-1 root, -2 orphan) pass through unchanged
                    packed = packed_gather(si, pref, sources[si].cols[n])
                    ii = by_src[si]
                    off = np.repeat((sp_b[ii] - span_lo[ii]).astype(np.int64),
                                    (span_hi - span_lo)[ii])
                    packed = np.where(
                        packed >= 0, packed + off, packed).astype(like.dtype)
                    packed_scatter(si, pref, packed, out)
                elif n == "span.scope_idx":
                    packed_scatter(si, pref, _translate(
                        si, span_scopevals[si], used_scope, scope_base), out)
                elif n in _OWNER_COLS:
                    packed = packed_gather(si, pref, sources[si].cols[n])
                    packed = (packed + owner_off_packed(si, pref)).astype(like.dtype)
                    packed_scatter(si, pref, packed, out)
                else:
                    s_offs, d_offs, lens = runs_of[(si, pref)]
                    _run_copy(sources[si].cols[n], out, s_offs, d_offs, lens)
            cols[n] = out
        elif pref in ("res", "scope"):
            used = used_res if pref == "res" else used_scope
            parts = [sources[si].cols[n][used[si]] for si in src_order]
            cols[n] = np.concatenate(parts) if parts else like[:0]
        elif pref == "rattr":
            parts = []
            for si in src_order:
                owner = sources[si].cols["rattr.res"]
                keep = np.isin(owner, used_res[si])
                a = sources[si].cols[n][keep]
                if n == "rattr.res":
                    a = _translate(si, a, used_res, res_base)
                parts.append(a)
            cols[n] = np.concatenate(parts) if parts else like[:0]
        else:
            raise UnsupportedColumnar(f"unknown column family: {n}")
        _consume(n)

    # recomputed columns
    span_counts = np.empty(n_traces, dtype=np.int64)
    for si in src_order:
        so_diff = np.diff(sources[si].span_off.astype(np.int64))
        s_offs, d_offs, lens = runs_of[(si, "trace")]
        _run_copy(so_diff, span_counts, s_offs, d_offs, lens)
    cols["trace.span_off"] = np.concatenate(
        [[0], np.cumsum(span_counts)]
    ).astype(np.int32)
    cols["span.trace_sid"] = np.repeat(
        np.arange(n_traces, dtype=np.int32), span_counts
    )
    if has_tres:
        tres_counts = np.empty(n_traces, dtype=np.int64)
        for si in src_order:
            td = np.diff(sources[si].cols["trace.tres_off"].astype(np.int64))
            s_offs, d_offs, lens = runs_of[(si, "trace")]
            _run_copy(td, tres_counts, s_offs, d_offs, lens)
        cols["trace.tres_off"] = np.concatenate(
            [[0], np.cumsum(tres_counts)]
        ).astype(np.int32)

    start_ns = cols["span.start_ns"].astype(np.int64)
    base_ns = int(start_ns.min()) if start_ns.size else 0
    cols["span.start_ms"] = ((start_ns - base_ns) // 1_000_000).astype(np.int32)
    tr_start = cols["trace.start_ns"].astype(np.int64)
    tr_end = cols["trace.end_ns"].astype(np.int64)
    cols["trace.start_ms"] = ((tr_start - base_ns) // 1_000_000).astype(np.int32)
    cols["trace.end_ms"] = ((tr_end - base_ns) // 1_000_000).astype(np.int32)

    axes, col_axis, row_groups = compute_row_groups(
        cols, cols["span.start_ms"], cols["span.dur_us"], row_group_spans
    )

    m = BlockMeta.new(tenant)
    m.compaction_level = level
    m.total_traces = n_traces
    m.total_spans = n_spans
    ids = cols["trace.id"]
    m.min_id = ids[0].tobytes().hex() if n_traces else ""
    m.max_id = ids[-1].tobytes().hex() if n_traces else ""
    m.start_time_unix_nano = base_ns
    m.end_time_unix_nano = int(cols["span.end_ns"].max()) if cols["span.end_ns"].size else 0
    m.dict_size = len(merged)
    m.row_groups = row_groups

    if bloom is None:
        bloom = ShardedBloom.for_estimated_items(max(n_traces, 1))
        bloom.add_array(ids[:n_traces])
    m.bloom_shards = bloom.n_shards
    m.bloom_shard_bits = bloom.shard_bits
    return FinalizedBlock(m, cols, axes, col_axis, merged, bloom)


@dataclass
class ColumnarPlan:
    """Output of the fetch+merge stage (plan_columnar): everything the
    assemble/write stage (iter_outputs, write_output) needs."""

    tenant: str
    blocks: list[BackendBlock]
    # indexed like the run tables; None holes are passthrough-only
    # blocks whose columns were never decoded
    sources: list[_Source | None]
    merged: Dictionary | None
    out_level: int
    # (src, sid_lo, sid_hi) run arrays per output block; empty when the
    # inputs hold zero traces (mark-only job)
    chunk_lists: list[tuple[np.ndarray, np.ndarray, np.ndarray]]
    single_est: bool
    # per chunk list: the source block index whose compressed chunks
    # copy through verbatim, or None for an ordinary rewrite output
    passthrough: list[int | None]
    # where the bloom union and collision rebuilds run
    device: object = None


def plan_columnar(backend: RawBackend, job: CompactionJob, cfg: CompactorConfig,
                  device=None, blocks: list[BackendBlock] | None = None) -> ColumnarPlan:
    """Fetch + merge planning: decode sources, compute the global merge
    order (collisions combined), merge dictionaries, cut the run table
    into per-output chunk lists. Raises UnsupportedColumnar when the
    inputs can't merge columnar-ly. The device defaults to the first
    card (an error without one). `blocks`: readers already opened (the
    pipeline's prefetch stage passes preloaded ones)."""
    device = resolve_device(device)
    tenant = job.tenant
    from ..block.versioned import open_block_versioned

    # version dispatch: an unknown-format input must fail the job
    # loudly, never be misparsed as vtpu1 bytes
    if blocks is None:
        blocks = [open_block_versioned(backend, m) for m in job.blocks]
    # one output block => _assemble drops each source column after its
    # pass; multi-output jobs read the sources again, so never (estimate
    # from input bytes: single iff everything fits one target block)
    target_est = cfg.target_block_bytes or cfg.max_block_bytes
    single_est = sum(m.size_bytes for m in job.blocks) <= target_est * 9 // 10
    names = set(blocks[0].pack.names())
    if any(set(b.pack.names()) != names for b in blocks[1:]):
        raise UnsupportedColumnar("input blocks have differing column sets")
    out_level = max(m.compaction_level for m in job.blocks) + 1

    # merge order needs ONLY trace.id per block; full-column decode is
    # deferred until the output cuts reveal which sources any rewrite
    # output actually touches (a block that passes through whole never
    # decompresses at all)
    sources: list[_Source | None] = [None] * len(blocks)
    src_arr, sid_arr, same = _merge_order(
        [b.pack.read("trace.id") for b in blocks])
    n = len(src_arr)
    dup = same.copy()
    if n:
        dup[:-1] |= same[1:]

    # vectorized run detection (the old per-trace Python loop cost more
    # than the dictionary merge on realistic jobs): a run continues while
    # the source stays, sids stay consecutive, and neither row belongs to
    # a collision group
    if n:
        cont = np.zeros(n, dtype=bool)
        cont[1:] = ((src_arr[1:] == src_arr[:-1])
                    & (sid_arr[1:] == sid_arr[:-1] + 1)
                    & ~dup[1:] & ~dup[:-1])
        starts = np.nonzero(~cont)[0]
        seg_len = np.append(starts[1:], n) - starts
        run_src = src_arr[starts].astype(np.int64)
        run_lo = sid_arr[starts].astype(np.int64)
        run_hi = run_lo + seg_len
        if dup.any():
            # collision groups become one-trace sources appended after
            # the blocks (rare; random 16-byte ids almost never collide)
            seg_dup = dup[starts]
            cs = starts[seg_dup]  # every collision member is its own segment
            new_group = ~same[cs]
            gid = np.cumsum(new_group) - 1
            groups: list[list[tuple[int, int]]] = [[] for _ in range(int(gid[-1]) + 1)] if cs.size else []
            for t, g in zip(cs, gid):
                groups[int(g)].append((int(src_arr[t]), int(sid_arr[t])))
            coll_src = []
            for members in groups:
                sources.append(_combine_collision(blocks, names, members, tenant, device))
                coll_src.append(len(sources) - 1)
            # splice the one-trace collision runs back at their merged
            # position (each group sits where its first member sorted)
            all_pos = np.concatenate([starts[~seg_dup], cs[new_group]])
            all_src = np.concatenate([run_src[~seg_dup], np.asarray(coll_src, np.int64)])
            all_lo = np.concatenate([run_lo[~seg_dup], np.zeros(len(coll_src), np.int64)])
            all_hi = np.concatenate([run_hi[~seg_dup], np.ones(len(coll_src), np.int64)])
            o = np.argsort(all_pos, kind="stable")
            run_src, run_lo, run_hi = all_src[o], all_lo[o], all_hi[o]
    else:
        run_src = run_lo = run_hi = np.empty(0, np.int64)
    if run_src.size == 0:
        # zero input traces: nothing to assemble, mark-only job
        return ColumnarPlan(tenant, blocks, sources, None,
                            out_level, [], single_est, [], device)

    # merged dictionary: a byte-level union (dictionaries are their own
    # objects, so this never decompresses column data) + one remap
    # gather per decoded source below
    blob, offs, remaps = dict_union(
        [b.dictionary.raw() for b in blocks]
        + [s.dictionary.raw() for s in sources[len(blocks):]])
    merged = Dictionary.from_raw(blob, offs)

    # size-target output cuts, estimated from input bytes/trace. NOTE:
    # every output block carries the FULL merged dictionary (subsetting
    # it per output would force a second remap pass over every code
    # column), so the per-block trace budget is what remains of the
    # target AFTER the dictionary blob.
    total_in = sum(m.size_bytes for m in job.blocks)
    total_traces_in = max(1, sum(m.total_traces for m in job.blocks))
    bpt = max(1.0, total_in / total_traces_in)
    target = cfg.target_block_bytes or cfg.max_block_bytes
    cap_traces = max(1, int(max(target - len(blob), target // 4) / bpt))

    # split the run table into per-output-block slices at cap_traces
    # boundaries (vectorized; a run straddling a cut is split in two)
    lens = run_hi - run_lo
    cum = np.cumsum(lens)
    total_tr = int(cum[-1])
    n_out = max(1, -(-total_tr // cap_traces))
    chunk_lists: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    if n_out == 1:
        chunk_lists.append((run_src, run_lo, run_hi))
    else:
        prev_run, prev_off = 0, 0  # resume point: run index + traces consumed
        for b_idx in range(n_out):
            if b_idx < n_out - 1:
                boundary = (b_idx + 1) * cap_traces
                r = int(np.searchsorted(cum, boundary, "left"))
                off_in_r = boundary - (int(cum[r]) - int(lens[r]))
            else:
                r, off_in_r = len(lens) - 1, int(lens[-1])
            s_src = run_src[prev_run : r + 1].copy()
            s_lo = run_lo[prev_run : r + 1].copy()
            s_hi = run_hi[prev_run : r + 1].copy()
            s_lo[0] = run_lo[prev_run] + prev_off
            s_hi[-1] = run_lo[r] + off_in_r
            keep = s_hi > s_lo
            if keep.any():
                chunk_lists.append((s_src[keep], s_lo[keep], s_hi[keep]))
            prev_run, prev_off = r, off_in_r

    # compressed-chunk passthrough: an output that is exactly one whole
    # input block whose chunks are already the write codec inherits the
    # block's compressed bytes verbatim (write_output copies objects);
    # only sources a rewrite output touches ever decode their columns
    passthrough = [_passthrough_source(blocks, cl) for cl in chunk_lists]
    need = {int(s) for cl, pt in zip(chunk_lists, passthrough) if pt is None
            for s in np.unique(cl[0])}
    for si in sorted(need):
        if si < len(blocks) and sources[si] is None:
            sources[si] = _Source.from_block(blocks[si])
    for si, s in enumerate(sources):
        if s is not None:
            s.remap_codes(remaps[si])

    return ColumnarPlan(tenant, blocks, sources, merged,
                        out_level, chunk_lists, single_est, passthrough, device)


def _passthrough_source(blocks: list[BackendBlock],
                        cl: tuple[np.ndarray, np.ndarray, np.ndarray]) -> int | None:
    """The input block whose ENTIRE trace set this output chunk list
    covers verbatim, or None. Such an output's decoded contents equal
    the input block's exactly (one run, whole block -- collisions always
    split runs, so none involve it), so its compressed chunks copy
    through without decompress->recompress. Gated on the chunks already
    being the codec a rewrite would produce: a block written under a
    different codec still rewrites, keeping the backend converging on
    the configured one."""
    csrc, clo, chi = cl
    if len(csrc) != 1:
        return None
    si = int(csrc[0])
    if si >= len(blocks):  # collision rebuilds always rewrite
        return None
    m = blocks[si].meta
    if int(clo[0]) != 0 or int(chi[0]) != m.total_traces or not m.total_traces:
        return None
    if not blocks[si].pack.chunk_codecs() <= {CODEC_ZSTD, CODEC_CONST, CODEC_RAW}:
        return None
    return si


@dataclass
class PassthroughOutput:
    """One output block that inherits a single input block's compressed
    objects verbatim (yielded by iter_outputs in place of a
    FinalizedBlock; write_output copies instead of recompressing)."""

    blk: BackendBlock
    out_level: int

    @property
    def meta(self):  # the accounting surface FinalizedBlock exposes
        return self.blk.meta


def copy_block_through(backend: RawBackend, blk: BackendBlock, out_level: int,
                       defer_meta: bool = False) -> BlockMeta:
    """Produce a compaction output by verbatim object copy: data, dict
    and bloom shards move backend-side (local: hardlink; stores:
    server-side copy), compressed chunks never decode. Meta last, and
    held back with defer_meta, as write_block."""
    src = blk.meta
    m = BlockMeta.from_json(src.to_json())
    m.block_id = str(uuid.uuid4())
    m.compaction_level = out_level
    names = [DATA_NAME, DICT_NAME] + [
        f"{BLOOM_PREFIX}{s}" for s in range(src.bloom_shards)]
    for name in names:
        try:
            backend.copy_object(src.tenant_id, src.block_id, name, m.block_id)
        except DoesNotExist:
            if name == DATA_NAME:
                raise  # a block without data is corrupt; fail the job
    if not defer_meta:
        publish_block_meta(backend, m)
    return m


def write_output(backend: RawBackend, out, cfg: CompactorConfig, out_level: int,
                 defer_meta: bool = False) -> BlockMeta:
    """Write one iter_outputs product: FinalizedBlock -> full
    recompress through write_block, PassthroughOutput -> verbatim
    object copies. The sequential and the pipelined drivers both write
    here, so a passthrough behaves the same under either."""
    if isinstance(out, PassthroughOutput):
        return copy_block_through(backend, out.blk, out_level, defer_meta=defer_meta)
    return write_block(backend, out, level=cfg.level_for(out_level), defer_meta=defer_meta)


def iter_outputs(plan: ColumnarPlan, cfg: CompactorConfig):
    """Assemble the plan's output blocks one at a time, in a
    deterministic order and content. Passthrough outputs yield as PassthroughOutput markers (no assemble
    work; write_output performs the copy)."""
    single_out = len(plan.chunk_lists) == 1
    for cl, pt in zip(plan.chunk_lists, plan.passthrough):
        if pt is not None:
            yield PassthroughOutput(plan.blocks[pt], plan.out_level)
            continue
        bloom = _union_input_blooms(plan.blocks, plan.device) if single_out else None
        yield _assemble(plan.tenant, plan.sources, cl, plan.merged,
                        plan.out_level, cfg.row_group_spans, bloom,
                        consume=single_out and plan.single_est)


def compact_columnar(backend: RawBackend, job: CompactionJob, cfg: CompactorConfig,
                     device=None) -> CompactionResult:
    """Plan, then assemble and write each output block in turn. The
    device defaults to the first card (an error without one)."""
    plan = plan_columnar(backend, job, cfg, device)
    result = CompactionResult()
    for fin in iter_outputs(plan, cfg):
        meta = write_output(backend, fin, cfg, plan.out_level)
        result.new_blocks.append(meta)
        result.traces_out += meta.total_traces
        result.spans_out += meta.total_spans

    result.compacted_ids = [m.block_id for m in job.blocks]
    for m in job.blocks:
        backend.mark_compacted(job.tenant, m.block_id)
    return result
