"""Filesystem object store: <path>/<tenant>/<block>/<name>.

Same layout as the reference's local backend
(tempodb/backend/local/local.go) and the JAX package's
(tempo_tpu/backend/local.py). Writes are atomic (tmp file + rename) so a
crashed writer never leaves a half-written meta visible to pollers.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from .base import COMPACTED_META_NAME, META_NAME, Appender, DoesNotExist, RawBackend

_TENANT_OBJECT_DIR = "__tenant__"


class _FileAppender(Appender):
    """True incremental append: parts stream to a temp file, atomically
    renamed into place on close (keeps the crash-safety of write())."""

    def __init__(self, backend: "LocalBackend", tenant: str, block_id: str, name: str):
        super().__init__(backend, tenant, block_id, name)
        path = backend._obj_path(tenant, block_id, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        self._f = os.fdopen(fd, "wb")
        self._path = path

    def append(self, data: bytes) -> None:
        self._f.write(data)
        self.bytes_written += len(data)

    def close(self) -> None:
        try:
            self._f.close()
            os.replace(self._tmp, self._path)
        except BaseException:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            raise

    def abort(self) -> None:
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


class LocalBackend(RawBackend):
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)

    def _obj_path(self, tenant: str, block_id: str, name: str) -> str:
        return os.path.join(self.path, tenant, block_id, name)

    def write(self, tenant: str, block_id: str, name: str, data: bytes) -> None:
        path = self._obj_path(tenant, block_id, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def open_append(self, tenant: str, block_id: str, name: str) -> Appender:
        return _FileAppender(self, tenant, block_id, name)

    def copy_object(self, tenant: str, src_block_id: str, name: str,
                    dst_block_id: str) -> int:
        """A hardlink: block objects are immutable and writes replace
        directory entries (tmp + rename), never inodes, so sharing the
        inode is safe. Falls back to read + write where the filesystem
        refuses the link."""
        src = self._obj_path(tenant, src_block_id, name)
        dst = self._obj_path(tenant, dst_block_id, name)
        try:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.link(src, dst)
            return os.path.getsize(dst)
        except FileNotFoundError:
            raise DoesNotExist(src) from None
        except OSError:
            return super().copy_object(tenant, src_block_id, name, dst_block_id)

    def write_tenant_object(self, tenant: str, name: str, data: bytes) -> None:
        self.write(tenant, _TENANT_OBJECT_DIR, name, data)

    def read(self, tenant: str, block_id: str, name: str) -> bytes:
        path = self._obj_path(tenant, block_id, name)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise DoesNotExist(path) from None

    def read_tenant_object(self, tenant: str, name: str) -> bytes:
        return self.read(tenant, _TENANT_OBJECT_DIR, name)

    def read_range(self, tenant: str, block_id: str, name: str, offset: int, length: int) -> bytes:
        path = self._obj_path(tenant, block_id, name)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except FileNotFoundError:
            raise DoesNotExist(path) from None

    def tenants(self) -> list[str]:
        try:
            return sorted(
                d for d in os.listdir(self.path) if os.path.isdir(os.path.join(self.path, d))
            )
        except FileNotFoundError:
            return []

    def blocks(self, tenant: str) -> list[str]:
        tdir = os.path.join(self.path, tenant)
        try:
            entries = os.listdir(tdir)
        except FileNotFoundError:
            return []
        return sorted(
            d for d in entries
            if d != _TENANT_OBJECT_DIR and any(
                os.path.exists(os.path.join(tdir, d, n)) for n in (META_NAME, COMPACTED_META_NAME))
        )

    def delete_block(self, tenant: str, block_id: str) -> None:
        """Recursive: a compound block nests its parts as subdirectories."""
        bdir = os.path.join(self.path, tenant, block_id)
        if not os.path.isdir(bdir):
            return

        def _onexc(fn, path, exc):
            # a concurrent deletion is fine; anything else surfaces
            if not isinstance(exc, FileNotFoundError):
                raise exc

        shutil.rmtree(bdir, onexc=_onexc)

    def _delete_object(self, tenant: str, block_id: str, name: str) -> None:
        try:
            os.unlink(self._obj_path(tenant, block_id, name))
        except FileNotFoundError:
            pass
