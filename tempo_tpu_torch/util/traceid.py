"""Trace-ID helpers (port of tempo_tpu/util/traceid.py).

Mirrors the reference's hex parse/pad semantics (pkg/util/traceid.go):
IDs are 128-bit, hex strings may arrive shorter (Jaeger 64-bit ids) and
are left-padded with zeros to 16 bytes.
"""

from __future__ import annotations

TRACE_ID_LEN = 16
SPAN_ID_LEN = 8


class InvalidTraceID(ValueError):
    pass


def parse_trace_id(hex_id: str) -> bytes:
    s = hex_id.strip().lower()
    if s.startswith("0x"):
        s = s[2:]
    if not s or len(s) > 2 * TRACE_ID_LEN:
        raise InvalidTraceID(f"trace id must be 1-32 hex chars, got {hex_id!r}")
    try:
        raw = bytes.fromhex(s.zfill(2 * TRACE_ID_LEN))
    except ValueError as e:
        raise InvalidTraceID(f"invalid hex in trace id {hex_id!r}") from e
    return raw


def pad_trace_id(tid: bytes) -> bytes:
    if len(tid) > TRACE_ID_LEN:
        raise InvalidTraceID(f"trace id longer than 16 bytes: {len(tid)}")
    return tid.rjust(TRACE_ID_LEN, b"\x00")


def trace_id_to_hex(tid: bytes) -> str:
    return pad_trace_id(tid).hex()
