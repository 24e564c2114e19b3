"""In-memory object store for unit tests (MockRawReader/Writer analog,
tempodb/backend/mocks.go:1-176)."""

from __future__ import annotations

import threading

from .base import COMPACTED_META_NAME, META_NAME, DoesNotExist, RawBackend


class MemBackend(RawBackend):
    def __init__(self):
        self._lock = threading.Lock()
        self._objects: dict[tuple[str, str, str], bytes] = {}
        self._tenant_objects: dict[tuple[str, str], bytes] = {}

    def write(self, tenant, block_id, name, data):
        with self._lock:
            self._objects[(tenant, block_id, name)] = bytes(data)

    def write_tenant_object(self, tenant, name, data):
        with self._lock:
            self._tenant_objects[(tenant, name)] = bytes(data)

    def read_tenant_object(self, tenant, name):
        with self._lock:
            try:
                return self._tenant_objects[(tenant, name)]
            except KeyError:
                raise DoesNotExist(f"{tenant}/{name}") from None

    def read(self, tenant, block_id, name):
        with self._lock:
            try:
                return self._objects[(tenant, block_id, name)]
            except KeyError:
                raise DoesNotExist(f"{tenant}/{block_id}/{name}") from None

    def read_range(self, tenant, block_id, name, offset, length):
        return self.read(tenant, block_id, name)[offset : offset + length]

    def tenants(self):
        with self._lock:
            return sorted({t for (t, _, _) in self._objects}
                          | {t for (t, _) in self._tenant_objects})

    def blocks(self, tenant):
        with self._lock:
            return sorted({b for (t, b, name) in self._objects
                           if t == tenant and name in (META_NAME, COMPACTED_META_NAME)})

    def delete_block(self, tenant, block_id):
        # prefix-recursive: a compound block's parts live under "<id>/pN"
        with self._lock:
            for key in [k for k in self._objects if k[0] == tenant and (
                    k[1] == block_id or k[1].startswith(block_id + "/"))]:
                del self._objects[key]

    def _delete_object(self, tenant, block_id, name):
        with self._lock:
            self._objects.pop((tenant, block_id, name), None)
