"""In-memory per-tenant blocklist + backend poller + tenant index.

Port of tempo_tpu/db/blocklist.py (the reference's blocklist/poller,
tempodb/blocklist/list.go:29-123, poller.go:122-180): readers and
compactors consult this list, refreshed by a poll, instead of listing
the backend on every query. A poller that builds the index lists the
backend and writes each tenant's `index.json.gz`; one that does not
(build_index=False), or a poller that does not own the tenant
(`owns_tenant`), reads that index instead -- either package's, the
document is the same. Updates that arrive while a poll is in flight are
patched into the fresh results (ApplyPollResults semantics). Compound
blocks (db/concat_compact.py) expand into their parts.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..backend.base import TENANT_INDEX_NAME, DoesNotExist, RawBackend, meta_name
from ..block.meta import BlockMeta

# blocks compacted this recently stay searchable: rides out the
# lister-vs-swap race window (two poll cycles' worth by default)
COMPACTED_GRACE_S = 60.0


class Blocklist:
    def __init__(self):
        self._lock = threading.Lock()
        self._metas: dict[str, list[BlockMeta]] = {}
        self._compacted: dict[str, list[BlockMeta]] = {}
        # blocks added/removed since the current poll started
        self._added: dict[str, list[BlockMeta]] = {}
        self._removed: dict[str, set[str]] = {}
        # per-tenant generation: bumps whenever the tenant's searchable
        # block set actually changes (flush, compaction, poll drift)
        self._gen: dict[str, int] = {}

    def generation(self, tenant: str) -> int:
        with self._lock:
            return self._gen.get(tenant, 0)

    def tenants(self) -> list[str]:
        with self._lock:
            return [t for t, m in self._metas.items() if m]

    def metas(self, tenant: str) -> list[BlockMeta]:
        with self._lock:
            return list(self._metas.get(tenant, []))

    def compacted_metas(self, tenant: str) -> list[BlockMeta]:
        with self._lock:
            return list(self._compacted.get(tenant, []))

    def metas_by_id(self, tenant: str, block_ids: list[str]) -> list[BlockMeta]:
        """Resolve block ids to metas (job payloads ship ids; a worker
        resolves them against its own polled list). Missing ids are
        skipped: poll lag is the caller's retry condition."""
        with self._lock:
            by_id = {m.block_id: m for m in self._metas.get(tenant, [])}
        return [by_id[b] for b in block_ids if b in by_id]

    def update(
        self,
        tenant: str,
        add: list[BlockMeta] | None = None,
        remove: list[str] | None = None,
        add_compacted: list[BlockMeta] | None = None,
    ) -> None:
        """Immediate local mutation (flush / compaction), also remembered
        so an in-flight poll can't resurrect or drop it."""
        with self._lock:
            metas = self._metas.setdefault(tenant, [])
            removed = self._removed.setdefault(tenant, set())
            changed = False
            if add:
                known = {m.block_id for m in metas}
                for m in add:
                    if m.block_id not in known:
                        metas.append(m)
                        changed = True
                self._added.setdefault(tenant, []).extend(add)
            if remove:
                rm = set(remove)
                kept = [m for m in metas if m.block_id not in rm]
                changed = changed or len(kept) != len(metas)
                self._metas[tenant] = kept
                removed |= rm
            if add_compacted:
                self._compacted.setdefault(tenant, []).extend(add_compacted)
            if changed:
                self._gen[tenant] = self._gen.get(tenant, 0) + 1

    def apply_poll_results(
        self, metas: dict[str, list[BlockMeta]], compacted: dict[str, list[BlockMeta]]
    ) -> None:
        with self._lock:
            for tenant in set(metas) | set(self._metas):
                fresh = metas.get(tenant, [])
                ids = {m.block_id for m in fresh}
                # patch in updates that raced the poll
                for m in self._added.get(tenant, []):
                    if m.block_id not in ids:
                        fresh.append(m)
                        ids.add(m.block_id)
                rm = self._removed.get(tenant, set())
                before = {m.block_id for m in self._metas.get(tenant, [])}
                self._metas[tenant] = [m for m in fresh if m.block_id not in rm]
                if {m.block_id for m in self._metas[tenant]} != before:
                    self._gen[tenant] = self._gen.get(tenant, 0) + 1
            self._compacted = {t: list(v) for t, v in compacted.items()}
            self._added.clear()
            self._removed.clear()


class Poller:
    """Lists the backend (or reads tenant indexes) into poll results; with
    `build_index` it also writes each tenant's index. A stale index (older
    than stale_index_max_age_s, when set) reads as none."""

    def __init__(self, backend: RawBackend, build_index: bool = True,
                 stale_index_max_age_s: float = 0.0):
        self.backend = backend
        self.build_index = build_index
        self.stale_max = stale_index_max_age_s
        # ring-sharded polling hook: where this instance does not own a
        # tenant, it reads the owner's index instead of listing the
        # backend. Default: own every tenant (a solo poller).
        self.owns_tenant = lambda tenant: True

    def poll(self) -> tuple[dict[str, list[BlockMeta]], dict[str, list[BlockMeta]]]:
        metas: dict[str, list[BlockMeta]] = {}
        compacted: dict[str, list[BlockMeta]] = {}
        for tenant in self.backend.tenants():
            metas[tenant], compacted[tenant] = self.poll_tenant(
                tenant, owned=self.owns_tenant(tenant))
        return metas, compacted

    def poll_tenant(self, tenant: str,
                    owned: bool = True) -> tuple[list[BlockMeta], list[BlockMeta]]:
        if not owned or not self.build_index:
            # the index IS the blocklist; list the backend only where no
            # index has been written yet (a cold start)
            got = self._read_index(tenant)
            if got is not None:
                return got
        metas, compacted = self._list_tenant(tenant)
        if self.build_index and owned:
            self._write_index(tenant, metas, compacted)
        return metas, compacted

    # ---- raw listing
    def _list_tenant(self, tenant: str) -> tuple[list[BlockMeta], list[BlockMeta]]:
        from .concat_compact import COMPOUND_VERSION, expand_compound

        metas: list[BlockMeta] = []
        compacted: list[BlockMeta] = []

        def read_one(block_id: str) -> list[tuple[BlockMeta, bool]]:
            try:
                raw = self.backend.read(tenant, block_id, meta_name())
            except DoesNotExist:
                try:
                    return [(BlockMeta.from_json(
                        self.backend.read(tenant, block_id, meta_name(compacted=True))), True)]
                except DoesNotExist:
                    return []
            doc = json.loads(raw)
            if doc.get("version") == COMPOUND_VERSION:
                # a compound block: its parts are ordinary blocks to every
                # downstream path; a fully-consumed compound ages out whole,
                # once every part's searchable grace has lapsed
                pairs = expand_compound(self.backend, tenant, doc)
                newest = max((m.compacted_at_unix for m, c in pairs if c), default=0.0)
                if (pairs and all(c for _, c in pairs)
                        and time.time() - newest > COMPACTED_GRACE_S):
                    whole = BlockMeta.from_json(json.dumps(
                        {k: v for k, v in doc.items() if k != "parts"}).encode())
                    whole.compacted_at_unix = newest
                    return [(whole, True)]
                return pairs
            return [(BlockMeta.from_json(raw), False)]

        block_ids = self.backend.blocks(tenant)
        with ThreadPoolExecutor(max_workers=16) as pool:
            for pairs in pool.map(read_one, block_ids):
                for meta, is_compacted in pairs:
                    (compacted if is_compacted else metas).append(meta)
        # swap-window grace: a listing can race a compaction swap (the
        # snapshot predates the output while the inputs are already
        # marked), so recently-compacted blocks stay searchable for a
        # grace window; trace-level dedupe makes the double view harmless
        now = time.time()
        ids = {m.block_id for m in metas}
        metas += [m for m in compacted
                  if m.compacted_at_unix
                  and now - m.compacted_at_unix < COMPACTED_GRACE_S
                  and m.block_id not in ids
                  # compound wholes are containers, not openable blocks
                  and m.version != COMPOUND_VERSION]
        metas.sort(key=lambda m: m.block_id)
        compacted.sort(key=lambda m: m.block_id)
        return metas, compacted

    # ---- tenant index
    def _write_index(self, tenant, metas, compacted) -> None:
        """The reference's index document (tempo_tpu/db/blocklist.py)."""
        doc = {
            "created_at": time.time(),
            "meta": [json.loads(m.to_json()) for m in metas],
            "compacted": [json.loads(m.to_json()) for m in compacted],
        }
        self.backend.write_tenant_object(tenant, TENANT_INDEX_NAME,
                                         gzip.compress(json.dumps(doc).encode("utf-8")))

    def _read_index(self, tenant) -> tuple[list[BlockMeta], list[BlockMeta]] | None:
        try:
            raw = self.backend.read_tenant_object(tenant, TENANT_INDEX_NAME)
        except DoesNotExist:
            return None
        doc = json.loads(gzip.decompress(raw))
        if self.stale_max and time.time() - doc.get("created_at", 0) > self.stale_max:
            return None

        def to_meta(d):
            return BlockMeta.from_json(json.dumps(d).encode())

        return [to_meta(d) for d in doc["meta"]], [to_meta(d) for d in doc["compacted"]]
