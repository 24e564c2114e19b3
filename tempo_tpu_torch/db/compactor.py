"""Compaction: block selection, N-way merge, retention.

Port of tempo_tpu/db/compactor.py. The selector follows the reference's
time-window policy (tempodb/compaction_block_selector.go:29-47): blocks
bucket by time window; inside the active window (default 24 h) only
same-level blocks compact together, older windows compact anything.
Each job gets a deterministic hash (`tenant-level-...`) for an
ownership hook (TempoDB.owns_job).

Routes, in order: the no-decode concat into a compound block for
all-small level-0 inputs (concat_compact.py), the columnar numpy merge
(columnar_compact.py), and the wire-model merge through the builder
when the inputs are not columnar-mergeable. The output bloom is the OR
union of the inputs' filters (B10a, ops/bloom_ops.py) when their
geometries match and the union stays within design load; the wire
route's builder cuts on the device (B9a/B9b/B9c). The pipelined sweep
over many jobs and tenants is db/compact_pipeline.py.
"""

from __future__ import annotations

import hashlib
import heapq
import math
import time
from dataclasses import dataclass, field

from ..backend.base import RawBackend
from ..block.bloom import DEFAULT_FP_RATE, ShardedBloom
from ..block.builder import BlockBuilder, write_block
from ..block.meta import BlockMeta
from ..block.reader import BackendBlock
from ..block.versioned import open_block_versioned
from ..ops.bloom_ops import union_planes
from ..ops.device import resolve_device
from ..wire.combine import combine_traces

DEFAULT_ACTIVE_WINDOW_S = 24 * 3600
DEFAULT_WINDOW_S = 3600
DEFAULT_MAX_INPUT_BLOCKS = 4
DEFAULT_MAX_BLOCK_BYTES = 100 * 1024 * 1024 * 1024


@dataclass
class CompactionJob:
    tenant: str
    blocks: list[BlockMeta]
    hash: str = ""

    def __post_init__(self):
        if not self.hash and self.blocks:
            ids = "-".join(sorted(b.block_id for b in self.blocks))
            level = self.blocks[0].compaction_level
            self.hash = f"{self.tenant}-{level}-{hashlib.sha1(ids.encode()).hexdigest()[:16]}"


@dataclass
class CompactorConfig:
    window_s: int = DEFAULT_WINDOW_S
    active_window_s: int = DEFAULT_ACTIVE_WINDOW_S
    max_input_blocks: int = DEFAULT_MAX_INPUT_BLOCKS
    min_input_blocks: int = 2
    max_block_bytes: int = DEFAULT_MAX_BLOCK_BYTES
    max_compaction_level: int = 4
    retention_s: int = 14 * 24 * 3600
    compacted_retention_s: int = 3600
    row_group_spans: int = 1 << 16
    columnar: bool = True  # numpy-level merge (columnar_compact.py)
    target_block_bytes: int = 0  # output size cut; 0 -> max_block_bytes
    # output zstd level of final-level (long-lived) blocks; blocks below
    # max_compaction_level are rewritten again soon and take the fast
    # negative mode
    zstd_level: int = 1
    zstd_level_intermediate: int = -3
    # level-0 jobs whose inputs are ALL at most this size take the
    # no-decode concat path into a compound block; 0 disables
    concat_small_input_bytes: int = 8 << 20
    # ---- the pipelined sweep (db/compact_pipeline.py) ----
    # worker threads running jobs at once; None resolves from the
    # TEMPO_COMPACT_CONCURRENCY env (default 1: sequential). Jobs own
    # disjoint input blocks, so they are safe to run in parallel.
    concurrency: int | None = None
    # host-RAM admission budget for jobs in flight; None resolves from
    # TEMPO_COMPACT_MEM_BUDGET (bytes, default 1 GiB). A job's peak is
    # estimated as its input bytes x compact_pipeline.EXPANSION; one job
    # always admits, so an oversized job stalls the pipeline, never
    # deadlocks it
    pipeline_mem_budget_bytes: int | None = None
    # jobs the prefetch stage may open ahead of the workers (0: none)
    prefetch_depth: int = 2

    def level_for(self, out_level: int) -> int:
        """Output zstd level for a block produced at out_level."""
        return (self.zstd_level if out_level >= self.max_compaction_level
                else self.zstd_level_intermediate)


def select_jobs(tenant: str, metas: list[BlockMeta], cfg: CompactorConfig,
                now: float | None = None) -> list[CompactionJob]:
    """Group by (window, level-in-active-window); emit jobs of
    min..max_input_blocks."""
    now = now or time.time()
    buckets: dict[tuple, list[BlockMeta]] = {}
    for m in metas:
        if m.compacted_at_unix:
            # grace-listed (already compacted, still searchable): its
            # data already lives in an output, so never an input
            continue
        if m.compaction_level >= cfg.max_compaction_level:
            continue
        end_s = m.end_time_unix_nano / 1e9
        window = int(end_s // cfg.window_s)
        active = (now - end_s) < cfg.active_window_s
        key = (window, m.compaction_level) if active else (window, -1)
        buckets.setdefault(key, []).append(m)

    jobs = []
    for key in sorted(buckets):
        group = sorted(buckets[key], key=lambda m: m.size_bytes)
        batch: list[BlockMeta] = []
        size = 0
        for m in group:
            if m.size_bytes > cfg.max_block_bytes:
                # over the output cap on its own: skip it without cutting
                # the batch in progress
                continue
            if len(batch) >= cfg.max_input_blocks or (batch and size + m.size_bytes > cfg.max_block_bytes):
                if len(batch) >= cfg.min_input_blocks:
                    jobs.append(CompactionJob(tenant, batch))
                batch, size = [], 0
            batch.append(m)
            size += m.size_bytes
        if len(batch) >= cfg.min_input_blocks:
            jobs.append(CompactionJob(tenant, batch))
    return jobs


@dataclass
class CompactionResult:
    new_blocks: list[BlockMeta] = field(default_factory=list)
    compacted_ids: list[str] = field(default_factory=list)
    traces_out: int = 0
    spans_out: int = 0


def union_capacity(blocks: list[BackendBlock]) -> tuple[int, float, int] | None:
    """(total ids, bits they need at the design rate, bits of the shared
    geometry), or None when the inputs' geometries differ."""
    geos = {(b.meta.bloom_shards, b.meta.bloom_shard_bits) for b in blocks}
    if len(geos) != 1:
        return None
    n_shards, bits = geos.pop()
    bits_per_item = max(1.0, -math.log(DEFAULT_FP_RATE) / (math.log(2) ** 2))
    total_ids = sum(b.meta.total_traces for b in blocks)
    return total_ids, total_ids * bits_per_item, n_shards * bits


def _union_input_blooms(blocks: list[BackendBlock], device) -> ShardedBloom | None:
    """The OR union of the inputs' bloom filters on `device` (B10a).
    Valid because the output's id set is exactly the union of the
    inputs'. None on a geometry mismatch, or when the union would exceed
    the geometry's design load (the filter would saturate across levels;
    the caller rebuilds, sized for the merged count)."""
    cap = union_capacity(blocks)
    if cap is None or not blocks[0].meta.bloom_shards:
        return None
    _, need_bits, have_bits = cap
    if need_bits > have_bits:
        return None
    n_shards, bits = blocks[0].meta.bloom_shards, blocks[0].meta.bloom_shard_bits
    return union_planes([[b.bloom_shard(i) for i in range(n_shards)] for b in blocks],
                        n_shards, bits, device)


def concat_eligible(job: CompactionJob, cfg: CompactorConfig) -> bool:
    """True when the job takes the no-decode concat path (all-small
    level-0 inputs)."""
    return bool(cfg.concat_small_input_bytes
                and len(job.blocks) >= 2
                and all(m.compaction_level == 0
                        and m.version in ("vtpu1", "vtpu2")
                        and 0 < m.size_bytes <= cfg.concat_small_input_bytes
                        for m in job.blocks))


def route(job: CompactionJob, cfg: CompactorConfig) -> str:
    """The route compact() tries first: concat, columnar or wire."""
    if concat_eligible(job, cfg):
        return "concat"
    return "columnar" if cfg.columnar else "wire"


def compact(backend: RawBackend, job: CompactionJob, cfg: CompactorConfig,
            device=None) -> CompactionResult:
    """Run one compaction job on `device` (None: the first card): the
    concat route for all-small level-0 inputs, the columnar merge
    otherwise, the wire-model merge when the inputs are not
    columnar-mergeable."""
    device = resolve_device(device)
    first = route(job, cfg)
    if first == "concat":
        from .concat_compact import compact_concat

        return compact_concat(backend, job, cfg)
    if first == "columnar":
        from .columnar_compact import UnsupportedColumnar, compact_columnar

        try:
            return compact_columnar(backend, job, cfg, device)
        except UnsupportedColumnar:
            pass
    return _compact_wire(backend, job, cfg, device)


def _compact_wire(backend: RawBackend, job: CompactionJob, cfg: CompactorConfig,
                  device) -> CompactionResult:
    """Wire-model merge: every trace decodes to the wire model and
    re-encodes through the builder (a cut on `device`). Correct for any
    inputs; the columnar route's fallback."""
    blocks = [open_block_versioned(backend, m) for m in job.blocks]
    out_level = max(m.compaction_level for m in job.blocks) + 1
    builder = BlockBuilder(job.tenant, row_group_spans=cfg.row_group_spans,
                           compaction_level=out_level, device=device)

    # K-way merge over each block's sorted trace-id index
    cursors = []
    for bi, blk in enumerate(blocks):
        ids = blk.trace_index["trace.id"]
        if ids.shape[0]:
            cursors.append([ids, 0, bi])
    heap = [(c[0][c[1]].tobytes(), i) for i, c in enumerate(cursors)]
    heapq.heapify(heap)
    result = CompactionResult()
    while heap:
        tid, ci = heap[0]
        same: list[tuple[int, int]] = []  # (cursor idx, sid) at this id
        while heap and heap[0][0] == tid:
            _, ci = heapq.heappop(heap)
            ids, pos, bi = cursors[ci]
            same.append((ci, pos))
            pos += 1
            cursors[ci][1] = pos
            if pos < ids.shape[0]:
                heapq.heappush(heap, (ids[pos].tobytes(), ci))
        traces = [blocks[cursors[ci][2]].materialize_traces([sid])[0] for ci, sid in same]
        builder.add_trace(tid, combine_traces(traces) if len(traces) > 1 else traces[0])
        result.traces_out += 1

    fin = builder.finalize(bloom=_union_input_blooms(blocks, device))
    result.spans_out = fin.meta.total_spans
    result.new_blocks = [write_block(backend, fin, level=cfg.level_for(out_level))]
    result.compacted_ids = [m.block_id for m in job.blocks]
    for m in job.blocks:
        backend.mark_compacted(job.tenant, m.block_id)
    return result


@dataclass
class RetentionResult:
    marked: list[str] = field(default_factory=list)
    deleted: list[str] = field(default_factory=list)


def apply_retention(
    backend: RawBackend,
    tenant: str,
    metas: list[BlockMeta],
    compacted: list[BlockMeta],
    cfg: CompactorConfig,
    now: float | None = None,
    owns=lambda h: True,
) -> RetentionResult:
    """Mark live blocks past retention as compacted, delete compacted
    blocks past compacted retention (reference: tempodb/retention.go:37-90)."""
    from .blocklist import COMPACTED_GRACE_S

    now = now or time.time()
    out = RetentionResult()
    cutoff_ns = (now - cfg.retention_s) * 1e9
    for m in metas:
        if m.compacted_at_unix:
            continue  # grace-listed (already compacted): not a live block
        if m.end_time_unix_nano < cutoff_ns and owns(m.block_id):
            backend.mark_compacted(tenant, m.block_id)
            out.marked.append(m.block_id)
    for m in compacted:
        if m.compacted_at_unix:
            # compacted retention counts from the mark, and never ends
            # inside the blocklist's searchable grace
            hold = max(cfg.compacted_retention_s, COMPACTED_GRACE_S)
            expired = m.compacted_at_unix < now - hold
        else:  # a marker without a stamp: count from the block's end
            expired = m.end_time_unix_nano < (
                now - cfg.retention_s - cfg.compacted_retention_s) * 1e9
        if "/" in m.block_id:
            # a part of a compound block: reclaimed with the whole
            # compound (deleting the part's directory would drop its
            # marker and resurrect it as a live block without data)
            continue
        if expired and owns(m.block_id):
            backend.delete_block(tenant, m.block_id)
            out.deleted.append(m.block_id)
    return out
