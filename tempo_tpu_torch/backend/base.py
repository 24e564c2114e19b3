"""Object-store backend abstraction.

One flat interface per the reference's RawReader/RawWriter seam
(tempodb/backend/raw.go:55-133, backend.go:22-66): named objects under
<tenant>/<block uuid>/<name>, tenant-level objects (the per-tenant
blocklist index), list operations and the compacted-marker protocol
(meta.json renamed to meta.compacted.json, stamped with the mark time)
-- the part of the JAX package's backend (tempo_tpu/backend/base.py)
that writing, reading and compacting blocks uses. Both packages lay
objects out the same way, so they share one store.
"""

from __future__ import annotations

import abc
import json
import time

META_NAME = "meta.json"
COMPACTED_META_NAME = "meta.compacted.json"
TENANT_INDEX_NAME = "index.json.gz"


def meta_name(compacted: bool = False) -> str:
    return COMPACTED_META_NAME if compacted else META_NAME


class BackendError(Exception):
    pass


class DoesNotExist(BackendError):
    pass


class Appender:
    """Incremental object writer (reference: backend.AppendTracker,
    tempodb/backend/raw.go). Default buffers parts and issues one write
    on close; backends with native append (local files) override
    open_append for true streamed flushes."""

    def __init__(self, backend: "RawBackend", tenant: str, block_id: str, name: str):
        self._backend = backend
        self._tenant = tenant
        self._block_id = block_id
        self._name = name
        self._parts: list[bytes] = []
        self.bytes_written = 0

    def append(self, data: bytes) -> None:
        self._parts.append(data)
        self.bytes_written += len(data)

    def close(self) -> None:
        self._backend.write(self._tenant, self._block_id, self._name, b"".join(self._parts))
        self._parts = []

    def abort(self) -> None:
        """Discard everything appended so far; nothing is written."""
        self._parts = []


class RawBackend(abc.ABC):
    """Reader+writer+compactor over raw named objects."""

    # ---- write
    @abc.abstractmethod
    def write(self, tenant: str, block_id: str, name: str, data: bytes) -> None: ...

    def open_append(self, tenant: str, block_id: str, name: str) -> Appender:
        return Appender(self, tenant, block_id, name)

    def copy_object(self, tenant: str, src_block_id: str, name: str,
                    dst_block_id: str) -> int:
        """Copy one immutable object between blocks of the same tenant
        (the concat compactor's verbatim part copies). Default: read +
        write; the local backend hardlinks. Returns the bytes copied."""
        data = self.read(tenant, src_block_id, name)
        self.write(tenant, dst_block_id, name, data)
        return len(data)

    @abc.abstractmethod
    def write_tenant_object(self, tenant: str, name: str, data: bytes) -> None: ...

    # ---- read
    @abc.abstractmethod
    def read(self, tenant: str, block_id: str, name: str) -> bytes: ...

    @abc.abstractmethod
    def read_range(self, tenant: str, block_id: str, name: str, offset: int, length: int) -> bytes: ...

    @abc.abstractmethod
    def read_tenant_object(self, tenant: str, name: str) -> bytes: ...

    def has_object(self, tenant: str, block_id: str, name: str) -> bool:
        try:
            self.read(tenant, block_id, name)
            return True
        except DoesNotExist:
            return False

    # ---- list
    @abc.abstractmethod
    def tenants(self) -> list[str]: ...

    @abc.abstractmethod
    def blocks(self, tenant: str) -> list[str]:
        """Block ids that have either a live or a compacted meta."""

    # ---- delete
    @abc.abstractmethod
    def delete_block(self, tenant: str, block_id: str) -> None:
        """Delete the block's objects, recursively: a compound block's
        parts live under "<block_id>/pN"."""

    @abc.abstractmethod
    def _delete_object(self, tenant: str, block_id: str, name: str) -> None: ...

    # ---- compacted-marker protocol
    def mark_compacted(self, tenant: str, block_id: str) -> None:
        """Rename meta.json -> meta.compacted.json, stamping
        compacted_at_unix so compacted retention counts from the mark.
        Idempotent. A compound block's part has no meta.json of its own:
        marking one writes a minimal stamped marker the poller's
        expansion reads (db/blocklist.py); an ordinary missing block
        raises DoesNotExist."""
        try:
            data = self.read(tenant, block_id, META_NAME)
        except DoesNotExist:
            if self.has_object(tenant, block_id, COMPACTED_META_NAME):
                return
            if "/" in block_id:
                data = json.dumps({"block_id": block_id, "tenant_id": tenant,
                                   "compacted_at_unix": time.time()},
                                  separators=(",", ":")).encode()
                self.write(tenant, block_id, COMPACTED_META_NAME, data)
                return
            raise
        try:
            d = json.loads(data)
            d["compacted_at_unix"] = time.time()
            data = json.dumps(d, separators=(",", ":")).encode()
        except (ValueError, TypeError):
            pass  # unparseable meta: keep the verbatim-copy rename
        self.write(tenant, block_id, COMPACTED_META_NAME, data)
        self._delete_object(tenant, block_id, META_NAME)
