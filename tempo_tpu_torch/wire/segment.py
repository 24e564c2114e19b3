"""Segment and object codecs: the distributor->ingester->block data path
(the port's copy of tempo_tpu/wire/segment.py).

Mirrors the reference's two-level codec seam (pkg/model/segment_decoder.go:19-32,
pkg/model/object_decoder.go:21-33): a *segment* is one distributor push for one
trace; an *object* is the concatenation of all segments for a trace as stored
in the WAL / row blocks. Like the reference's v2 codec, segments carry a
start/end-seconds header so time-range filtering never decodes span payloads
("FastRange").

Format "s1":
  segment := 0x01 | uint32le start_sec | uint32le end_sec | otlp_trace_bytes
  object  := repeated (uvarint len | segment)
"""

from __future__ import annotations

import struct

from . import pbwire as w
from .combine import combine_traces
from .model import Trace
from .otlp_pb import decode_trace, encode_trace

CURRENT_VERSION = "s1"
_HDR = struct.Struct("<BII")
_V1 = 0x01


class DecodeError(ValueError):
    pass


def segment_for_write(trace: Trace, start_sec: int, end_sec: int) -> bytes:
    return _HDR.pack(_V1, start_sec & 0xFFFFFFFF, end_sec & 0xFFFFFFFF) + encode_trace(trace)


def segment_fast_range(segment: bytes) -> tuple[int, int]:
    if len(segment) < _HDR.size or segment[0] != _V1:
        raise DecodeError("bad segment header")
    _, start, end = _HDR.unpack_from(segment, 0)
    return start, end


def segment_payload(segment: bytes) -> bytes:
    """The raw otlp-proto trace bytes inside a segment (no decode):
    the generator forward plane ships these blobs verbatim."""
    if len(segment) < _HDR.size or segment[0] != _V1:
        raise DecodeError("bad segment header")
    return segment[_HDR.size :]


def segment_to_trace(segment: bytes) -> Trace:
    if len(segment) < _HDR.size or segment[0] != _V1:
        raise DecodeError("bad segment header")
    return decode_trace(segment[_HDR.size :])


def segments_to_object(segments: list[bytes]) -> bytes:
    buf = bytearray()
    for seg in segments:
        w.write_varint(buf, len(seg))
        buf.extend(seg)
    return bytes(buf)


def object_segments(obj: bytes) -> list[bytes]:
    out = []
    pos = 0
    while pos < len(obj):
        ln, pos = w.read_varint(obj, pos)
        if pos + ln > len(obj):
            raise DecodeError("truncated object segment")
        out.append(obj[pos : pos + ln])
        pos += ln
    return out


def object_to_trace(obj: bytes) -> Trace:
    traces = [segment_to_trace(seg) for seg in object_segments(obj)]
    if len(traces) == 1:
        return traces[0]
    return combine_traces(traces)


def object_fast_range(obj: bytes) -> tuple[int, int]:
    lo, hi = None, None
    for seg in object_segments(obj):
        s, e = segment_fast_range(seg)
        lo = s if lo is None else min(lo, s)
        hi = e if hi is None else max(hi, e)
    if lo is None:
        return 0, 0
    return lo, hi


def combine_objects(a: bytes, b: bytes) -> bytes:
    """Concatenate two objects' segments (cheap combine used by compaction
    when the same trace id appears in two blocks; span-level dedupe happens
    at read time in object_to_trace via combine_traces)."""
    return a + b
