"""Column blob IO: named numpy arrays in one backend object, chunked by
row group.

Layout: [chunk buffers, each independently compressed] [footer]
[uint32le footer len] [magic 'VTPU'] -- the vtpu pack format of the JAX
package (tempo_tpu/block/colio.py), read and written byte-compatibly.

Every column belongs to an *axis* (span rows, trace rows, attr rows, ...)
and is stored as one chunk per row group along that axis. The footer
maps column name -> dtype/shape/axis/chunk table, so a reader fetches
the footer with two small range reads and then range-reads only the
(column, row-group) chunks a query touches.

Each chunk records its own codec, and the reader dispatches per chunk:
raw, const (one stored row tiled to the chunk length), gzip, lzma,
snappy, lz4 (block/blockcodecs.py, pure Python) and zstd. zstd goes
through the `zstandard` wheel where it imports, else through the zlib
shim (util/zstdshim.py), which refuses a real zstd
frame loudly instead of returning garbage.
"""

from __future__ import annotations

import json
import struct
import threading
from collections import OrderedDict

import numpy as np

try:
    import zstandard
except ModuleNotFoundError:  # image without the wheel: zlib-backed shim
    from ..util import zstdshim as zstandard

MAGIC = b"VTPU"
_TAIL = struct.Struct("<I4s")

CODEC_RAW = "raw"
CODEC_ZSTD = "zstd"
# constant chunk: stored bytes are ONE row, tiled to raw_len at read
CODEC_CONST = "const"
_MIN_COMPRESS = 128
_CONST_MIN = 64  # don't bother const-marking chunks smaller than this


def is_broadcast(arr: np.ndarray) -> bool:
    """True for stride-0 first-dim views (np.broadcast_to of one row):
    the in-memory marker for "this column is constant" (read_all's
    broadcast_const, the compaction merge's const fast path)."""
    return arr.ndim >= 1 and arr.size > 0 and arr.strides[0] == 0


def _gzip_c(data: bytes, level: int) -> bytes:
    import gzip

    # mtime=0 keeps output deterministic
    return gzip.compress(data, compresslevel=min(level, 9), mtime=0)


def _gzip_d(data: bytes, raw_len: int) -> bytes:
    import zlib

    # wbits=47 auto-detects gzip (RFC1952) and zlib (RFC1950) framing
    return zlib.decompress(data, 47)


def _lzma_c(data: bytes, level: int) -> bytes:
    import lzma

    return lzma.compress(data, preset=min(level, 6))


def _lzma_d(data: bytes, raw_len: int) -> bytes:
    import lzma

    return lzma.decompress(data)


def _zstd_c(data: bytes, level: int) -> bytes:
    return zstandard.ZstdCompressor(level=level).compress(data)


_DCTX_LOCAL = threading.local()  # zstd contexts are not thread-safe


def _zstd_d(data: bytes, raw_len: int) -> bytes:
    d = getattr(_DCTX_LOCAL, "d", None)
    if d is None:
        d = _DCTX_LOCAL.d = zstandard.ZstdDecompressor()
    return d.decompress(data, max_output_size=raw_len)


def _snappy_c(data: bytes, level: int) -> bytes:
    from .blockcodecs import snappy_compress

    return snappy_compress(data)  # snappy has no levels


def _snappy_d(data: bytes, raw_len: int) -> bytes:
    from .blockcodecs import snappy_decompress

    return snappy_decompress(data, raw_len)


def _lz4_c(data: bytes, level: int) -> bytes:
    from .blockcodecs import lz4_compress

    return lz4_compress(data)  # lz4 block format has no levels


def _lz4_d(data: bytes, raw_len: int) -> bytes:
    from .blockcodecs import lz4_decompress

    return lz4_decompress(data, raw_len)


_CODECS: dict[str, tuple] = {  # name -> (compress(data, level), decompress(data, raw_len))
    CODEC_ZSTD: (_zstd_c, _zstd_d),
    "gzip": (_gzip_c, _gzip_d),
    "lzma": (_lzma_c, _lzma_d),
    "snappy": (_snappy_c, _snappy_d),
    "lz4": (_lz4_c, _lz4_d),
}


class AxisChunks:
    """Row boundaries of the row groups along one axis: offsets[g] ..
    offsets[g+1] are the rows of group g."""

    def __init__(self, offsets: list[int]):
        if len(offsets) < 2 or offsets[0] != 0:
            raise ValueError(f"bad axis offsets {offsets[:4]}")
        self.offsets = list(offsets)

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_rows(self) -> int:
        return self.offsets[-1]


def pack_columns_stream(
    cols: dict[str, np.ndarray],
    axes: dict[str, AxisChunks] | None = None,
    col_axis: dict[str, str] | None = None,
    level: int = 3,
    codec: str = CODEC_ZSTD,
    level_for=None,
):
    """Yield the serialized pack as byte parts, one column at a time,
    then the binary footer and the tail. level_for(name) -> "raw" | int
    | None overrides the level per column (zstd packs only, as in the
    JAX package)."""
    axes = axes or {}
    col_axis = col_axis or {}
    if codec != CODEC_RAW and codec not in _CODECS:
        raise ValueError(f"unknown codec {codec!r} (matrix: {[CODEC_RAW, *sorted(_CODECS)]})")
    footer_tbl: dict = {"cols": {}, "axes": {k: v.offsets for k, v in axes.items()}}
    offset = 0
    for name, arr in cols.items():
        col_level, col_raw = level, False
        if level_for is not None and codec == CODEC_ZSTD:
            ov = level_for(name)
            if ov == "raw":
                col_raw = True
            elif ov is not None:
                col_level = ov
        # a broadcast view is constant by construction: const chunks,
        # never materialized (a raw pack stores bytes verbatim instead)
        bcast = codec != CODEC_RAW and is_broadcast(arr)
        if not bcast:
            arr = np.ascontiguousarray(arr)
        axis = col_axis.get(name)
        row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64))
        if axis is not None:
            ax = axes[axis]
            if ax.n_rows != arr.shape[0]:
                raise ValueError(
                    f"column {name}: {arr.shape[0]} rows != axis {axis} ({ax.n_rows})")
            bounds = [(ax.offsets[g] * row_bytes, ax.offsets[g + 1] * row_bytes)
                      for g in range(ax.n_groups)]
        else:
            bounds = [(0, arr.shape[0] * row_bytes)]
        recs: list[list] = []
        if bcast:
            row = np.ascontiguousarray(arr[:1]).tobytes()
            for lo, hi in bounds:
                if hi == lo:
                    recs.append([offset, 0, 0, CODEC_RAW])
                    continue
                recs.append([offset, len(row), hi - lo, CODEC_CONST])
                offset += len(row)
                yield row
            footer_tbl["cols"][name] = {
                "dtype": str(arr.dtype), "shape": list(arr.shape), "axis": axis, "chunks": recs,
            }
            continue
        buf = arr.reshape(-1).view(np.uint8) if arr.size else np.empty(0, np.uint8)
        for lo, hi in bounds:
            raw_len = hi - lo
            chunk = buf[lo:hi]
            data, chunk_codec = None, CODEC_RAW
            if codec != CODEC_RAW and row_bytes > 0 and raw_len >= max(_CONST_MIN, 2 * row_bytes):
                r0 = chunk[:row_bytes]
                if (chunk.reshape(-1, row_bytes) == r0).all():
                    data, chunk_codec = r0.tobytes(), CODEC_CONST
            if data is None and codec != CODEC_RAW and not col_raw and raw_len >= _MIN_COMPRESS:
                z = _CODECS[codec][0](chunk.tobytes(), col_level)
                if len(z) < raw_len:
                    data, chunk_codec = z, codec
            if data is None:
                data = chunk.tobytes()
            recs.append([offset, len(data), raw_len, chunk_codec])
            offset += len(data)
            yield data
        footer_tbl["cols"][name] = {
            "dtype": str(arr.dtype), "shape": list(arr.shape), "axis": axis, "chunks": recs,
        }
    fbytes = _encode_footer_binary(footer_tbl)
    yield fbytes
    yield _TAIL.pack(len(fbytes), MAGIC)


# Binary footer ("\x00BF1" marker; JSON can never start with NUL):
# marker, then [axes] u32 count + per axis (u16 name len, name utf8, u32
# n_offsets, i64 offsets), then a u8-counted codec table, then [cols]
# u32 count + per column (u16 name len, name, u32 body len, body); a
# body is (u8 dtype len, dtype str, u8 ndim, i64 dims, u8 axis len,
# axis, u32 n_chunks, (n,3) i64 [off, stored, raw], n u8 codec indexes).
_BF_MARKER = b"\x00BF1"


def _encode_footer_binary(footer: dict) -> bytes:
    out = bytearray(_BF_MARKER)

    def put_str(buf: bytearray, s: str, wide: bool = False):
        b = s.encode("utf-8")
        buf.extend(struct.pack("<H" if wide else "<B", len(b)))
        buf.extend(b)

    axes = footer.get("axes", {})
    out.extend(struct.pack("<I", len(axes)))
    for name, offsets in axes.items():
        put_str(out, name, wide=True)
        arr = np.asarray(offsets, dtype=np.int64)
        out.extend(struct.pack("<I", arr.shape[0]))
        out.extend(arr.tobytes())
    codecs = sorted({rec[3] for c in footer["cols"].values() for rec in c["chunks"]})
    out.extend(struct.pack("<B", len(codecs)))
    for c in codecs:
        put_str(out, c)
    cidx = {c: i for i, c in enumerate(codecs)}
    cols = footer["cols"]
    out.extend(struct.pack("<I", len(cols)))
    for name, meta in cols.items():
        put_str(out, name, wide=True)
        body = bytearray()
        put_str(body, meta["dtype"])
        shape = meta["shape"]
        body.extend(struct.pack("<B", len(shape)))
        body.extend(np.asarray(shape, dtype=np.int64).tobytes())
        put_str(body, meta["axis"] or "")
        recs = meta["chunks"]
        body.extend(struct.pack("<I", len(recs)))
        body.extend(np.asarray([[r[0], r[1], r[2]] for r in recs], dtype=np.int64).tobytes())
        body.extend(bytes(cidx[r[3]] for r in recs))
        out.extend(struct.pack("<I", len(body)))
        out.extend(body)
    return bytes(out)


def _decode_footer_binary(data: bytes) -> dict:
    pos = len(_BF_MARKER)

    def get(fmt):
        nonlocal pos
        vals = struct.unpack_from(fmt, data, pos)
        pos += struct.calcsize(fmt)
        return vals

    def get_str(wide: bool = False) -> str:
        nonlocal pos
        (ln,) = get("<H" if wide else "<B")
        s = data[pos : pos + ln].decode("utf-8")
        pos += ln
        return s

    axes = {}
    (n_axes,) = get("<I")
    for _ in range(n_axes):
        name = get_str(wide=True)
        (n_off,) = get("<I")
        axes[name] = np.frombuffer(data, dtype=np.int64, count=n_off, offset=pos).tolist()
        pos += 8 * n_off
    (n_codecs,) = get("<B")
    codecs = [get_str() for _ in range(n_codecs)]
    cols = {}
    (n_cols,) = get("<I")
    for _ in range(n_cols):
        name = get_str(wide=True)
        (blen,) = get("<I")
        end = pos + blen
        dtype = get_str()
        (ndim,) = get("<B")
        shape = np.frombuffer(data, dtype=np.int64, count=ndim, offset=pos).tolist()
        pos += 8 * ndim
        axis = get_str() or None
        (n_chunks,) = get("<I")
        tbl = np.frombuffer(data, dtype=np.int64, count=3 * n_chunks, offset=pos)
        pos += 24 * n_chunks
        ci = data[pos : pos + n_chunks]
        cols[name] = {
            "dtype": dtype, "shape": shape, "axis": axis,
            "chunks": [[o, s, r, codecs[c]]
                       for (o, s, r), c in zip(tbl.reshape(-1, 3).tolist(), ci)],
        }
        pos = end
    return {"cols": cols, "axes": axes}


class ColumnPack:
    """Lazy chunked-column reader over a backend object via range reads,
    with a decoded-chunk LRU and a whole-column LRU sharing one byte
    budget."""

    CHUNK_CACHE_BYTES = 256 << 20

    def __init__(self, read_range, total_size: int):
        """read_range(offset, length) -> bytes."""
        self._read_range = read_range
        self._size = total_size
        tail = self._read_range(total_size - _TAIL.size, _TAIL.size)
        flen, magic = _TAIL.unpack(tail)
        if magic != MAGIC:
            raise ValueError("not a vtpu column pack (bad magic)")
        fbytes = self._read_range(total_size - _TAIL.size - flen, flen)
        # the JSON footer is the vtpu1 form; readers accept both
        footer = (_decode_footer_binary(fbytes)
                  if fbytes[:4] == _BF_MARKER else json.loads(fbytes))
        self._cols: dict[str, dict] = footer["cols"]
        self.axes: dict[str, AxisChunks] = {
            k: AxisChunks(v) for k, v in footer.get("axes", {}).items()
        }
        self.bytes_read = _TAIL.size + flen  # inspected-bytes accounting
        self._lock = threading.Lock()
        self._cache: OrderedDict[int, bytes] = OrderedDict()  # chunk offset -> raw
        self._cache_bytes = 0
        self._arrays: OrderedDict[str, np.ndarray] = OrderedDict()
        self._arrays_bytes = 0

    @classmethod
    def from_bytes(cls, data: bytes) -> "ColumnPack":
        return cls(lambda off, ln: data[off : off + ln], len(data))

    def names(self) -> list[str]:
        return list(self._cols)

    def preload(self) -> None:
        """Fetch the whole pack with one ranged read and serve later
        reads from memory (small compaction inputs). Idempotent."""
        if getattr(self, "_preloaded", False):
            return
        data = self._read_range(0, self._size)
        self._read_range = lambda off, ln: data[off : off + ln]
        self._preloaded = True

    def chunk_codecs(self) -> set[str]:
        """Every chunk codec in the pack (footer metadata only, no IO)."""
        return {r[3] for meta in self._cols.values() for r in meta["chunks"]}

    def has(self, name: str) -> bool:
        return name in self._cols

    def n_rows_of(self, name: str) -> int:
        """Row count of a column from footer metadata alone -- no chunk
        IO (pre-read budget estimates)."""
        meta = self._cols.get(name)
        return int(meta["shape"][0]) if meta else 0

    def _evict_locked(self, keep: str | None = None) -> None:
        """Drop decoded chunks first, then whole columns LRU -- never the
        column just inserted."""
        while self._cache_bytes + self._arrays_bytes > self.CHUNK_CACHE_BYTES and self._cache:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= len(old)
        while (self._cache_bytes + self._arrays_bytes > self.CHUNK_CACHE_BYTES
               and len(self._arrays) > 1):
            n = next(iter(self._arrays))
            if n == keep:
                break
            self._arrays_bytes -= self._arrays.pop(n).nbytes

    def _chunk(self, rec: list) -> bytes:
        off, stored_len, raw_len, codec = rec
        if raw_len == 0 and stored_len == 0:
            # zero-length chunks share the byte offset of the NEXT chunk:
            # never cache them under that offset
            return b""
        with self._lock:
            hit = self._cache.get(off)
            if hit is not None:
                self._cache.move_to_end(off)
                return hit
        data = self._read_range(off, stored_len)
        if codec == CODEC_CONST:
            data = data * (raw_len // stored_len)  # tile the stored row
        elif codec != CODEC_RAW:
            data = _CODECS[codec][1](data, raw_len)
        with self._lock:
            self.bytes_read += stored_len
            if off not in self._cache and len(data) <= self.CHUNK_CACHE_BYTES // 4:
                self._cache[off] = data
                self._cache_bytes += len(data)
                self._evict_locked()
        return data

    def read(self, name: str) -> np.ndarray:
        """A whole column, cached read-only."""
        with self._lock:
            hit = self._arrays.get(name)
            if hit is not None:
                self._arrays.move_to_end(name)
                return hit
        meta = self._cols[name]
        raw = b"".join(self._chunk(r) for r in meta["chunks"])
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
        if arr.nbytes <= self.CHUNK_CACHE_BYTES:
            with self._lock:
                if name not in self._arrays:
                    self._arrays[name] = arr
                    self._arrays_bytes += arr.nbytes
                    self._evict_locked(keep=name)
        return arr

    def read_groups(self, name: str, groups: list[int]) -> np.ndarray:
        """Concatenated rows of the given row groups (in the given order).
        Column must be axis-chunked."""
        meta = self._cols[name]
        if meta["axis"] is None:
            raise ValueError(f"column {name} is not axis-chunked")
        with self._lock:
            full = self._arrays.get(name)
        if full is not None:
            offs = self.axes[meta["axis"]].offsets
            parts = [full[offs[g] : offs[g + 1]] for g in groups]
            return parts[0] if len(parts) == 1 else np.concatenate(parts)
        raw = b"".join(self._chunk(meta["chunks"][g]) for g in groups)
        shape = [-1] + meta["shape"][1:]
        return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(shape)

    def read_many(self, names: list[str]) -> dict[str, np.ndarray]:
        return {n: self.read(n) for n in names if n in self._cols}

    def _broadcast_const_cols(self) -> dict[str, np.ndarray]:
        """Columns whose every non-empty chunk is const with one identical
        row, as stride-0 broadcast views (zero decode, zero memory)."""
        out: dict[str, np.ndarray] = {}
        for name, meta in self._cols.items():
            chs = [c for c in meta["chunks"] if c[2] > 0]
            if not chs or any(c[3] != CODEC_CONST for c in chs):
                continue
            rows = {self._read_range(c[0], c[1]) for c in chs}
            if len(rows) != 1:
                continue
            shape = tuple(meta["shape"])
            rv = np.frombuffer(next(iter(rows)), dtype=np.dtype(meta["dtype"])).reshape(shape[1:])
            out[name] = np.broadcast_to(rv, shape)
        return out

    def read_all(self, broadcast_const: bool = False) -> dict[str, np.ndarray]:
        """Every column. broadcast_const=True returns fully-constant
        columns as read-only stride-0 views (the compaction merge's const
        fast path)."""
        bc = self._broadcast_const_cols() if broadcast_const else {}
        return {n: bc[n] if n in bc else self.read(n) for n in self._cols}
