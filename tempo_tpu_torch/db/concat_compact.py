"""No-decode compaction: concatenate small input blocks into one
COMPOUND block by verbatim object copy.

Port of tempo_tpu/db/concat_compact.py (the reference's no-decode idea,
vparquet/compactor.go:23-80, taken to its limit for the first level). A
compound block is K verbatim part copies under one block id:

    tenant/<cid>/meta.json              version "vtpu1c", parts list
    tenant/<cid>/p0/{data.vtpu,dict.vtpu,bloom-*}
    tenant/<cid>/p1/...

The poller expands a compound into per-part metas (block id "cid/p3"),
so search, find and further compaction see ordinary blocks. Parts come
out one level up, where the columnar rewrite merges them; a part that
rewrite consumes gets its own compacted marker
(RawBackend.mark_compacted handles meta-less parts), and a compound whose
parts are all consumed ages out whole. No kernel runs here.
"""

from __future__ import annotations

import json
import threading
import time
import uuid

from ..backend.base import COMPACTED_META_NAME, DoesNotExist, RawBackend
from ..block.builder import BLOOM_PREFIX, DATA_NAME, DICT_NAME
from ..block.meta import BlockMeta

COMPOUND_VERSION = "vtpu1c"


def part_metas(compound_doc: dict) -> list[BlockMeta]:
    return [BlockMeta.from_json(json.dumps(p).encode()) for p in compound_doc.get("parts", [])]


def compact_concat(backend: RawBackend, job, cfg):
    """Concatenate the job's input blocks into one compound block."""
    from .compactor import CompactionResult

    tenant = job.tenant
    cid = str(uuid.uuid4())
    out_level = max(m.compaction_level for m in job.blocks) + 1
    parts: list[dict] = []
    result = CompactionResult()
    for i, m in enumerate(job.blocks):
        part_id = f"{cid}/p{i}"
        for name in [DATA_NAME, DICT_NAME] + [f"{BLOOM_PREFIX}{s}" for s in range(m.bloom_shards)]:
            try:
                backend.copy_object(tenant, m.block_id, name, part_id)
            except DoesNotExist:
                if name == DATA_NAME:
                    raise  # a block without data is corrupt; fail the job
        pm = json.loads(m.to_json())
        pm["block_id"] = part_id
        pm["compaction_level"] = out_level
        parts.append(pm)
        result.traces_out += m.total_traces
        result.spans_out += m.total_spans
    doc = {
        "version": COMPOUND_VERSION,
        "block_id": cid,
        "tenant_id": tenant,
        "compaction_level": out_level,
        "total_traces": result.traces_out,
        "total_spans": result.spans_out,
        "size_bytes": sum(m.size_bytes for m in job.blocks),
        "created_at": time.time(),
        "parts": parts,
    }
    # meta last: pollers never see a partial compound
    backend.write(tenant, cid, "meta.json", json.dumps(doc, separators=(",", ":")).encode())
    for m in job.blocks:
        backend.mark_compacted(tenant, m.block_id)
    result.new_blocks = part_metas(doc)
    result.compacted_ids = [m.block_id for m in job.blocks]
    return result


# markers are monotonic (a part never un-compacts), so found stamps cache
# process-wide; bounded, since aged-out compounds are never probed again
_MARKER_CACHE_MAX = 4096
_marker_cache: dict[tuple[str, str], float] = {}
_marker_lock = threading.Lock()


def expand_compound(backend: RawBackend, tenant: str, doc: dict):
    """Compound meta doc -> [(part BlockMeta, is_compacted)]. A part is
    compacted when the rewrite that consumed it left a marker in its
    directory; a marker read that fails keeps the part live (searchable)
    for this cycle."""
    out = []
    for pm in doc.get("parts", []):
        meta = BlockMeta.from_json(json.dumps(pm).encode())
        key = (tenant, meta.block_id)
        stamp = _marker_cache.get(key)
        if stamp is None:
            try:
                marker = backend.read(tenant, meta.block_id, COMPACTED_META_NAME)
            except Exception:  # absent, or a transient read error: stay live
                out.append((meta, False))
                continue
            try:
                stamp = float(json.loads(marker).get("compacted_at_unix", 0.0))
            except (ValueError, TypeError):
                stamp = time.time()  # corrupt marker: hold, don't age out
            stamp = stamp or time.time()
            with _marker_lock:
                while len(_marker_cache) >= _MARKER_CACHE_MAX:
                    _marker_cache.pop(next(iter(_marker_cache)))
                _marker_cache[key] = stamp
        meta.compacted_at_unix = stamp
        out.append((meta, True))
    return out
