"""OTLP trace protobuf codec over the generic wire reader/writer (the
port's copy of tempo_tpu/wire/otlp_pb.py: its encoder writes the same
bytes).

Implements the public OTLP field numbering
(opentelemetry.proto.trace.v1 / common.v1 / resource.v1, and the
collector ExportTraceServiceRequest whose field 1 is the repeated
ResourceSpans) so encoded traces interoperate with any OTLP exporter.
The reference treats tempopb.Trace as wire-compatible with the export
request the same way (modules/distributor/receiver/shim.go:209-215).
"""

from __future__ import annotations

import struct

from . import pbwire as w
from .model import (
    AnyValue,
    Event,
    Link,
    Resource,
    ResourceSpans,
    Scope,
    ScopeSpans,
    Span,
    Trace,
)

# ---------------------------------------------------------------- AnyValue


def _encode_any_value(v: AnyValue) -> bytes:
    buf = bytearray()
    if isinstance(v, bool):  # before int: bool is an int subclass
        # emit the varint even for False so the oneof arm is present
        w.write_tag(buf, 2, w.WT_VARINT)
        w.write_varint(buf, 1 if v else 0)
    elif isinstance(v, str):
        w.write_string_field(buf, 1, v)
    elif isinstance(v, int):
        w.write_tag(buf, 3, w.WT_VARINT)
        w.write_varint(buf, v)
    elif isinstance(v, float):
        w.write_tag(buf, 4, w.WT_FIXED64)
        buf.extend(struct.pack("<d", v))
    elif isinstance(v, bytes):
        # emit the arm even for b"" so the value keeps its bytes type
        w.write_message_field(buf, 7, v)
    elif isinstance(v, list):
        arr = bytearray()
        for item in v:
            w.write_message_field(arr, 1, _encode_any_value(item))
        w.write_message_field(buf, 5, bytes(arr))
    else:
        w.write_string_field(buf, 1, str(v))
    return bytes(buf)


def _decode_any_value(data: bytes) -> AnyValue:
    for field_no, wt, val in w.iter_fields(data):
        if field_no == 1:
            return val.decode("utf-8", errors="replace")
        if field_no == 2:
            return bool(val)
        if field_no == 3:
            return w.to_signed64(val)
        if field_no == 4:
            return w.fixed64_to_double(val)
        if field_no == 5:
            out = []
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 1:
                    out.append(_decode_any_value(v2))
            return out
        if field_no == 7:
            return val
    return ""


def _encode_kv(k: str, v: AnyValue) -> bytes:
    kv = bytearray()
    w.write_string_field(kv, 1, k)
    w.write_message_field(kv, 2, _encode_any_value(v))
    return bytes(kv)


def _decode_kv(data: bytes) -> tuple[str, AnyValue]:
    key, value = "", ""
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            key = val.decode("utf-8", errors="replace")
        elif field_no == 2:
            value = _decode_any_value(val)
    return key, value


# ---------------------------------------------------------------- Span


def _encode_event(e: Event) -> bytes:
    buf = bytearray()
    w.write_fixed64_field(buf, 1, e.time_unix_nano)
    w.write_string_field(buf, 2, e.name)
    for k, v in e.attrs.items():
        w.write_message_field(buf, 3, _encode_kv(k, v))
    w.write_varint_field(buf, 4, e.dropped_attributes_count)
    return bytes(buf)


def _decode_event(data: bytes) -> Event:
    e = Event()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            e.time_unix_nano = val
        elif field_no == 2:
            e.name = val.decode("utf-8", errors="replace")
        elif field_no == 3:
            k, v = _decode_kv(val)
            e.attrs[k] = v
        elif field_no == 4:
            e.dropped_attributes_count = val
    return e


def _encode_link(l: Link) -> bytes:
    buf = bytearray()
    w.write_bytes_field(buf, 1, l.trace_id)
    w.write_bytes_field(buf, 2, l.span_id)
    w.write_string_field(buf, 3, l.trace_state)
    for k, v in l.attrs.items():
        w.write_message_field(buf, 4, _encode_kv(k, v))
    return bytes(buf)


def _decode_link(data: bytes) -> Link:
    l = Link()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            l.trace_id = val
        elif field_no == 2:
            l.span_id = val
        elif field_no == 3:
            l.trace_state = val.decode("utf-8", errors="replace")
        elif field_no == 4:
            k, v = _decode_kv(val)
            l.attrs[k] = v
    return l


def _encode_status(code: int, message: str) -> bytes:
    buf = bytearray()
    w.write_string_field(buf, 2, message)
    w.write_varint_field(buf, 3, code)
    return bytes(buf)


def encode_span(s: Span) -> bytes:
    buf = bytearray()
    w.write_bytes_field(buf, 1, s.trace_id)
    w.write_bytes_field(buf, 2, s.span_id)
    w.write_string_field(buf, 3, s.trace_state)
    w.write_bytes_field(buf, 4, s.parent_span_id)
    w.write_string_field(buf, 5, s.name)
    w.write_varint_field(buf, 6, s.kind)
    w.write_fixed64_field(buf, 7, s.start_unix_nano)
    w.write_fixed64_field(buf, 8, s.end_unix_nano)
    for k, v in s.attrs.items():
        w.write_message_field(buf, 9, _encode_kv(k, v))
    w.write_varint_field(buf, 10, s.dropped_attributes_count)
    for e in s.events:
        w.write_message_field(buf, 11, _encode_event(e))
    for l in s.links:
        w.write_message_field(buf, 13, _encode_link(l))
    if s.status_code or s.status_message:
        w.write_message_field(buf, 15, _encode_status(s.status_code, s.status_message))
    return bytes(buf)


def decode_span(data: bytes) -> Span:
    s = Span()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            s.trace_id = val
        elif field_no == 2:
            s.span_id = val
        elif field_no == 3:
            s.trace_state = val.decode("utf-8", errors="replace")
        elif field_no == 4:
            s.parent_span_id = val
        elif field_no == 5:
            s.name = val.decode("utf-8", errors="replace")
        elif field_no == 6:
            s.kind = val
        elif field_no == 7:
            s.start_unix_nano = val
        elif field_no == 8:
            s.end_unix_nano = val
        elif field_no == 9:
            k, v = _decode_kv(val)
            s.attrs[k] = v
        elif field_no == 10:
            s.dropped_attributes_count = val
        elif field_no == 11:
            s.events.append(_decode_event(val))
        elif field_no == 13:
            s.links.append(_decode_link(val))
        elif field_no == 15:
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 2:
                    s.status_message = v2.decode("utf-8", errors="replace")
                elif f2 == 3:
                    s.status_code = v2
    return s


# ---------------------------------------------------------------- batches


def _encode_scope(scope: Scope) -> bytes:
    buf = bytearray()
    w.write_string_field(buf, 1, scope.name)
    w.write_string_field(buf, 2, scope.version)
    return bytes(buf)


def _encode_scope_spans(ss: ScopeSpans) -> bytes:
    buf = bytearray()
    if ss.scope.name or ss.scope.version:
        w.write_message_field(buf, 1, _encode_scope(ss.scope))
    for sp in ss.spans:
        w.write_message_field(buf, 2, encode_span(sp))
    return bytes(buf)


def _decode_scope_spans(data: bytes) -> ScopeSpans:
    ss = ScopeSpans()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            for f2, _, v2 in w.iter_fields(val):
                if f2 == 1:
                    ss.scope.name = v2.decode("utf-8", errors="replace")
                elif f2 == 2:
                    ss.scope.version = v2.decode("utf-8", errors="replace")
        elif field_no == 2:
            ss.spans.append(decode_span(val))
    return ss


def _encode_resource(r: Resource) -> bytes:
    buf = bytearray()
    for k, v in r.attrs.items():
        w.write_message_field(buf, 1, _encode_kv(k, v))
    return bytes(buf)


def _decode_resource(data: bytes) -> Resource:
    r = Resource()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            k, v = _decode_kv(val)
            r.attrs[k] = v
    return r


def encode_resource_spans(rs: ResourceSpans) -> bytes:
    buf = bytearray()
    w.write_message_field(buf, 1, _encode_resource(rs.resource))
    for ss in rs.scope_spans:
        w.write_message_field(buf, 2, _encode_scope_spans(ss))
    return bytes(buf)


def decode_resource_spans(data: bytes) -> ResourceSpans:
    rs = ResourceSpans()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            rs.resource = _decode_resource(val)
        elif field_no == 2:
            rs.scope_spans.append(_decode_scope_spans(val))
    return rs


def encode_trace(t: Trace) -> bytes:
    """Encode as ExportTraceServiceRequest-compatible bytes
    (field 1 = repeated ResourceSpans)."""
    buf = bytearray()
    for rs in t.resource_spans:
        w.write_message_field(buf, 1, encode_resource_spans(rs))
    return bytes(buf)


def decode_trace(data: bytes) -> Trace:
    t = Trace()
    for field_no, _, val in w.iter_fields(data):
        if field_no == 1:
            t.resource_spans.append(decode_resource_spans(val))
    return t
