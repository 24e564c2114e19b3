"""Columnar WAL v2 ("w2") record codec (the port's copy of
tempo_tpu/ingest/walcodec.py: its frames are the same bytes).

The v1 WAL frames ONE segment per record; a 20-trace OTLP export window
therefore pays 20 varint frames and 20 file writes on the ack path, and
replay re-decodes every segment's proto to rebuild the live-search
staging state. v2 keeps v1's OUTER framing (`uvarint total_len | body`,
so the varint frame scan and its torn-tail detection work unchanged)
but makes the body columnar:

  body    := uint32le crc32(payload) | payload
  payload := uint8 rec_type | ...

  rec_type 1 (WINDOW): one distributor push window, all traces in one
    record -- one frame, one CRC, one write per push:
      uint32le n_traces
      n_traces x ( trace_id[16] | uint32le start_s | uint32le end_s |
                   uint32le seg_len )
      concat(segment bytes)

  rec_type 2 (FEATURES): a lazy checkpoint of already-decoded segment
    features (ingest/columnar.SegFeatures) referencing earlier windows
    BY POSITION, with a file-local dictionary delta so codes are
    self-contained (multi-file replay order never matters):
      uint32le n_delta | n_delta x (uvarint len | utf8 string)
      uint32le n_entries
      n_entries x ( uint32le window_idx | uint32le trace_idx |
                    uint32le n_kv | n_kv x uint32le file_code |
                    uint32le n_names | n_names x uint32le file_code |
                    uint64le lo_ns | uint64le hi_ns )

A record whose CRC does not match (disk corruption) invalidates itself
AND everything after it
-- the byte stream past a corruption cannot be trusted -- so readers
truncate there exactly like a torn tail. lo_ns/hi_ns use the all-ones
uint64 as the "unknown" sentinel (a segment with no spans).
"""

from __future__ import annotations

import struct
import zlib

from ..wire import pbwire as w

WAL2_VERSION = "w2"
REC_WINDOW = 1
REC_FEATURES = 2

NS_UNKNOWN = 0xFFFFFFFFFFFFFFFF  # lo/hi sentinel: no spans in segment

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_WIN_ENT = struct.Struct("<16sIII")  # trace_id, start_s, end_s, seg_len
_MIN_BODY = _U32.size + 1  # crc + rec_type


class CodecError(ValueError):
    pass


def _frame(parts: list[bytes]) -> bytes:
    """crc-prefix `parts` (the payload) and varint-frame the body."""
    payload = b"".join(parts)
    hdr = bytearray()
    w.write_varint(hdr, _U32.size + len(payload))
    return b"".join([bytes(hdr),
                     _U32.pack(zlib.crc32(payload) & 0xFFFFFFFF), payload])


def encode_window(batch: list[tuple[bytes, int, int, bytes]]) -> bytes:
    """One framed WINDOW record for [(trace_id, start_s, end_s, seg)]."""
    parts = [bytes([REC_WINDOW]), _U32.pack(len(batch))]
    parts.extend(_WIN_ENT.pack(tid.rjust(16, b"\x00"),
                               s & 0xFFFFFFFF, e & 0xFFFFFFFF, len(seg))
                 for tid, s, e, seg in batch)
    parts.extend(seg for _, _, _, seg in batch)
    return _frame(parts)


def encode_features(delta: list[str],
                    entries: list[tuple[int, int, list[int], list[int],
                                        int | None, int | None]]) -> bytes:
    """One framed FEATURES record. `delta` holds the strings for file
    codes assigned since the previous features record, in code order;
    entries are (window_idx, trace_idx, kv_file_codes, name_file_codes,
    lo_ns, hi_ns)."""
    parts = [bytes([REC_FEATURES]), _U32.pack(len(delta))]
    for s in delta:
        b = s.encode("utf-8")
        hdr = bytearray()
        w.write_varint(hdr, len(b))
        parts.append(bytes(hdr) + b)
    parts.append(_U32.pack(len(entries)))
    for w_idx, t_idx, kv, nm, lo, hi in entries:
        parts.append(_U32.pack(w_idx) + _U32.pack(t_idx))
        parts.append(_U32.pack(len(kv)) + b"".join(_U32.pack(c) for c in kv))
        parts.append(_U32.pack(len(nm)) + b"".join(_U32.pack(c) for c in nm))
        parts.append(_U64.pack(NS_UNKNOWN if lo is None else lo))
        parts.append(_U64.pack(NS_UNKNOWN if hi is None else hi))
    return _frame(parts)


def decode_record(data: bytes, off: int, ln: int):
    """Parse one framed BODY (data[off:off+ln], outer varint already
    consumed). Returns (rec_type, parsed) or None when the CRC or the
    shape rejects the record (readers treat that as corruption and stop
    there). Window parse -> [(tid, start_s, end_s, segment)]; features
    parse -> (delta_strings, entries)."""
    if ln < _MIN_BODY:
        return None
    end = off + ln
    (crc,) = _U32.unpack_from(data, off)
    payload = data[off + _U32.size : end]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        return None
    rtype = payload[0]
    try:
        if rtype == REC_WINDOW:
            return REC_WINDOW, _decode_window(payload)
        if rtype == REC_FEATURES:
            return REC_FEATURES, _decode_features(payload)
    except (CodecError, struct.error, ValueError, UnicodeDecodeError):
        return None
    return None  # unknown record type: written by a future version


def _decode_window(payload: bytes):
    pos = 1
    (n,) = _U32.unpack_from(payload, pos)
    pos += _U32.size
    heads = []
    for _ in range(n):
        tid, s, e, seg_len = _WIN_ENT.unpack_from(payload, pos)
        pos += _WIN_ENT.size
        heads.append((tid, s, e, seg_len))
    out = []
    for tid, s, e, seg_len in heads:
        if pos + seg_len > len(payload):
            raise CodecError("window segment overruns record")
        out.append((tid, s, e, payload[pos : pos + seg_len]))
        pos += seg_len
    if pos != len(payload):
        raise CodecError("trailing bytes in window record")
    return out


def _decode_features(payload: bytes):
    pos = 1
    (n_delta,) = _U32.unpack_from(payload, pos)
    pos += _U32.size
    delta = []
    for _ in range(n_delta):
        ln, pos = w.read_varint(payload, pos)
        if pos + ln > len(payload):
            raise CodecError("delta string overruns record")
        delta.append(payload[pos : pos + ln].decode("utf-8"))
        pos += ln
    (n_ent,) = _U32.unpack_from(payload, pos)
    pos += _U32.size
    entries = []
    for _ in range(n_ent):
        w_idx, t_idx = _U32.unpack_from(payload, pos)[0], _U32.unpack_from(payload, pos + 4)[0]
        pos += 8
        (n_kv,) = _U32.unpack_from(payload, pos)
        pos += _U32.size
        kv = list(struct.unpack_from(f"<{n_kv}I", payload, pos))
        pos += 4 * n_kv
        (n_nm,) = _U32.unpack_from(payload, pos)
        pos += _U32.size
        nm = list(struct.unpack_from(f"<{n_nm}I", payload, pos))
        pos += 4 * n_nm
        (lo,) = _U64.unpack_from(payload, pos)
        (hi,) = _U64.unpack_from(payload, pos + 8)
        pos += 16
        entries.append((w_idx, t_idx, kv, nm,
                        None if lo == NS_UNKNOWN else lo,
                        None if hi == NS_UNKNOWN else hi))
    if pos != len(payload):
        raise CodecError("trailing bytes in features record")
    return delta, entries
