"""Minimal protobuf wire-format reader/writer (the port's copy of
tempo_tpu/wire/pbwire.py).

A generic varint/length-delimited codec implementing the public protobuf
encoding spec: the OTLP codec (otlp_pb.py), the WAL record codec
(ingest/walcodec.py) and the block layer's legacy uvarint dictionary
form (block/dictionary.py) all read and write through it.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
from typing import Iterator

WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5


def write_varint(buf: bytearray, v: int) -> None:
    if v < 0:
        v &= 0xFFFFFFFFFFFFFFFF  # two's complement 64-bit
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        if shift == 63 and (b & 0x7F) > 1:
            raise ValueError("varint exceeds 64 bits")
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def tag(field_no: int, wire_type: int) -> int:
    return (field_no << 3) | wire_type


def write_tag(buf: bytearray, field_no: int, wire_type: int) -> None:
    write_varint(buf, tag(field_no, wire_type))


def write_bytes_field(buf: bytearray, field_no: int, data: bytes) -> None:
    if not data:
        return
    write_tag(buf, field_no, WT_LEN)
    write_varint(buf, len(data))
    buf.extend(data)


def write_string_field(buf: bytearray, field_no: int, s: str) -> None:
    if s:
        write_bytes_field(buf, field_no, s.encode("utf-8"))


def write_varint_field(buf: bytearray, field_no: int, v: int) -> None:
    if v:
        write_tag(buf, field_no, WT_VARINT)
        write_varint(buf, v)


def write_fixed64_field(buf: bytearray, field_no: int, v: int) -> None:
    if v:
        write_tag(buf, field_no, WT_FIXED64)
        buf.extend(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))


def write_double_field(buf: bytearray, field_no: int, v: float) -> None:
    if v != 0.0:
        write_tag(buf, field_no, WT_FIXED64)
        buf.extend(struct.pack("<d", v))


def write_message_field(buf: bytearray, field_no: int, msg: bytes) -> None:
    """Write a submessage even when empty (presence-significant)."""
    write_tag(buf, field_no, WT_LEN)
    write_varint(buf, len(msg))
    buf.extend(msg)


def iter_fields(data: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_no, wire_type, value); value is int for varint/fixed,
    bytes for length-delimited."""
    pos = 0
    n = len(data)
    while pos < n:
        t, pos = read_varint(data, pos)
        field_no, wt = t >> 3, t & 7
        if wt == WT_VARINT:
            v, pos = read_varint(data, pos)
            yield field_no, wt, v
        elif wt == WT_FIXED64:
            if pos + 8 > n:
                raise ValueError("truncated fixed64")
            yield field_no, wt, struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wt == WT_LEN:
            ln, pos = read_varint(data, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            yield field_no, wt, bytes(data[pos : pos + ln])
            pos += ln
        elif wt == WT_FIXED32:
            if pos + 4 > n:
                raise ValueError("truncated fixed32")
            yield field_no, wt, struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def fixed64_to_double(v: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v
