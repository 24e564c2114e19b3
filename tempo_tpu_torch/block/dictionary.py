"""Per-block string dictionary.

All strings in a vtpu block (service names, span names, attribute keys
and string values, URLs, ...) live in ONE sorted dictionary; every
string column is an int32 code column. This is the core trick that makes
trace data TPU-friendly: string predicates become integer compares on
device, with the string->code mapping resolved host-side per query
(a miss prunes the whole block). Sorting at finalize means codes are
ordered lexicographically, so device kernels can do range/prefix
predicates as integer range checks. (utf-8 byte order equals unicode
codepoint order, so byte-level and str-level comparisons agree.)

Serialized form ("DIC2"): magic | zstd( u32 count | u32 offsets[count+1]
| utf8 blob ) -- two frombuffer calls to load, NO per-string parse, and
the loaded form stays as (blob, offsets) with per-string decode deferred
until somebody actually asks for the text. Block open cost is O(bytes),
not O(strings): the dominant cost of the old uvarint stream was half a
million Python-level varint reads per compaction. The legacy varint
form is still readable.
"""

from __future__ import annotations

import struct

import numpy as np
try:
    import zstandard
except ModuleNotFoundError:  # image without the wheel: zlib-backed shim
    from ..util import zstdshim as zstandard

from ..wire import pbwire as w

NO_CODE = np.int32(-1)  # "absent" sentinel in every code column

_MAGIC = b"DIC2"


class DictBuilder:
    def __init__(self):
        self._codes: dict[str, int] = {}

    def code(self, s: str) -> int:
        c = self._codes.get(s)
        if c is None:
            c = len(self._codes)
            self._codes[s] = c
        return c

    def __len__(self) -> int:
        return len(self._codes)

    def finalize(self) -> tuple["Dictionary", np.ndarray]:
        """Sort strings; return (dictionary, remap) where remap[old_code]
        -> sorted code. Apply remap to every code column before writing."""
        strings = sorted(self._codes)
        remap = np.empty(len(strings), dtype=np.int32)
        for new_code, s in enumerate(strings):
            remap[self._codes[s]] = new_code
        return Dictionary(strings), remap


def dict_union(raws: list[tuple[bytes, np.ndarray]]):
    """K-way union of K sorted dictionaries given as (blob, u32 offsets)
    pairs (Dictionary.raw()). Returns (merged_blob, merged_offsets,
    [per-source int32 remap]). Byte-level, so the order is utf-8 byte
    order, the dictionaries' own; the JAX package's numpy fallback
    (tempo_tpu/native/__init__.py `_dict_union_py`) in the same form."""
    if sum(len(offs) - 1 for _, offs in raws) == 0:
        return b"", np.zeros(1, dtype=np.uint32), [np.zeros(0, np.int32) for _ in raws]
    per_src: list[list[bytes]] = []
    for blob, offs in raws:
        o = offs.tolist()
        per_src.append([blob[o[i] : o[i + 1]] for i in range(len(o) - 1)])
    merged = sorted(set().union(*[set(s) for s in per_src]))
    code_of = {s: i for i, s in enumerate(merged)}
    remaps = [np.asarray([code_of[s] for s in src], dtype=np.int32) for src in per_src]
    offs = np.zeros(len(merged) + 1, dtype=np.uint32)
    np.cumsum([len(s) for s in merged], out=offs[1:])
    return b"".join(merged), offs, remaps


def apply_remap(col: np.ndarray, remap: np.ndarray) -> np.ndarray:
    """Remap a code column, passing through NO_CODE sentinels."""
    out = np.where(col >= 0, remap[np.maximum(col, 0)], col)
    return out.astype(np.int32)


class Dictionary:
    """Sorted string table. Two interchangeable representations:
    eager (list[str], from the builder) and lazy ((blob, offsets) from
    disk, strings decoded on demand and memoized)."""

    def __init__(self, strings: list[str] | None = None,
                 blob: bytes | None = None, offsets: np.ndarray | None = None):
        self._strings = strings
        self._blob = blob
        self._offsets = offsets
        self._decoded: dict[int, str] = {}

    @classmethod
    def from_raw(cls, blob: bytes, offsets: np.ndarray) -> "Dictionary":
        return cls(blob=blob, offsets=offsets)

    def __len__(self) -> int:
        if self._strings is not None:
            return len(self._strings)
        return len(self._offsets) - 1

    # ------------------------------------------------------- raw access
    def raw(self) -> tuple[bytes, np.ndarray]:
        """(utf8 blob, u32 offsets[count+1]) -- the union/merge unit."""
        if self._blob is None:
            bs = [s.encode("utf-8") for s in self._strings]
            offs = np.zeros(len(bs) + 1, dtype=np.uint32)
            np.cumsum([len(b) for b in bs], out=offs[1:])
            self._blob, self._offsets = b"".join(bs), offs
        return self._blob, self._offsets

    def _bytes_at(self, i: int) -> bytes:
        return self._blob[int(self._offsets[i]) : int(self._offsets[i + 1])]

    @property
    def strings(self) -> list[str]:
        """Full decoded table (materialized once, then cached)."""
        if self._strings is None:
            blob, offs = self._blob, self._offsets
            text = blob.decode("utf-8", errors="surrogateescape")
            # one whole-blob decode + zero-copy-ish slicing beats half a
            # million per-string decodes; offsets are byte offsets, which
            # equal str offsets only for ascii blobs -- fall back per
            # string when multibyte chars are present
            if len(text) == len(blob):
                o = offs.tolist()
                self._strings = [text[o[i] : o[i + 1]] for i in range(len(o) - 1)]
            else:
                self._strings = [
                    self._bytes_at(i).decode("utf-8") for i in range(len(offs) - 1)
                ]
        return self._strings

    # ----------------------------------------------------------- lookup
    def _bisect_bytes(self, needle: bytes) -> int:
        lo, hi = 0, len(self._offsets) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self._bytes_at(mid) < needle:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def lookup(self, s: str) -> int:
        """Code for s, or -1 if absent (prunes the block)."""
        import bisect

        if self._strings is not None:
            i = bisect.bisect_left(self._strings, s)
            if i < len(self._strings) and self._strings[i] == s:
                return i
            return -1
        needle = s.encode("utf-8")
        i = self._bisect_bytes(needle)
        if i < len(self) and self._bytes_at(i) == needle:
            return i
        return -1

    def string(self, code: int) -> str:
        code = int(code)
        if not 0 <= code < len(self):
            return ""
        if self._strings is not None:
            return self._strings[code]
        s = self._decoded.get(code)
        if s is None:
            s = self._decoded[code] = self._bytes_at(code).decode("utf-8")
        return s

    # -------------------------------------------------------------- io
    def to_bytes(self) -> bytes:
        blob, offs = self.raw()
        payload = (
            struct.pack("<I", len(offs) - 1)
            + np.ascontiguousarray(offs, dtype=np.uint32).tobytes()
            + blob
        )
        return _MAGIC + zstandard.ZstdCompressor(level=3).compress(payload)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Dictionary":
        if data[:4] == _MAGIC:
            raw = zstandard.ZstdDecompressor().decompress(data[4:])
            (count,) = struct.unpack_from("<I", raw, 0)
            offs = np.frombuffer(raw, dtype=np.uint32, count=count + 1, offset=4)
            blob = raw[4 + (count + 1) * 4 :]
            return cls.from_raw(blob, offs)
        # legacy uvarint stream
        raw = zstandard.ZstdDecompressor().decompress(data)
        count, pos = w.read_varint(raw, 0)
        strings = []
        for _ in range(count):
            ln, pos = w.read_varint(raw, pos)
            strings.append(raw[pos : pos + ln].decode("utf-8"))
            pos += ln
        return cls(strings)
