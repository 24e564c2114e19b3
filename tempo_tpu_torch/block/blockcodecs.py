"""Snappy and lz4 block codecs, pure Python (port of
tempo_tpu/block/blockcodecs.py, its Python halves).

The codec matrix's speed tier (reference: tempodb/backend/encoding.go
ships both next to zstd/gzip). The port loads no native library, so
these halves are the whole codec:

  * decompressors implement the COMPLETE public formats (snappy raw
    block framing; lz4 block format) -- any conformant producer's chunks
    decode here, including the hash-matched output of the JAX package's
    native compressor.
  * compressors emit format-valid output built from vectorized
    byte-run detection: long runs become offset-1 copies (the RLE
    subset of each format), everything else is literals -- byte for
    byte the JAX package's Python fallback. Column chunks are dominated
    by constant/sparse lanes, so the runs carry most of the win at numpy
    speed; entropy-heavy chunks come out as literals and the pack
    layer's "store raw when not smaller" rule keeps them honest.

Framing note: both are BLOCK formats (no container framing); the chunk
table's raw_len provides the decompressed size out of band, exactly as
it does for zstd chunks.
"""

from __future__ import annotations

import numpy as np

_RUN_MIN = 32  # shorter equal-byte runs stay literal (copy op overhead)


def _byte_runs(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of maximal equal-byte runs >= _RUN_MIN, vectorized
    (the Python fallback compressors' only scan)."""
    a = np.frombuffer(data, np.uint8)
    if a.size < _RUN_MIN:
        z = np.empty(0, np.int64)
        return z, z
    change = np.nonzero(np.diff(a))[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [a.size]))
    keep = (ends - starts) >= _RUN_MIN
    return starts[keep], ends[keep]


# ------------------------------------------------------------------ snappy


def _sn_emit_literal(out: bytearray, data: bytes, lo: int, hi: int) -> None:
    while lo < hi:
        l = min(hi - lo, 65536)
        n1 = l - 1
        if n1 < 60:
            out.append(n1 << 2)
        elif n1 < 256:
            out += bytes((60 << 2, n1))
        else:
            out += bytes((61 << 2, n1 & 0xFF, n1 >> 8))
        out += data[lo : lo + l]
        lo += l


def _sn_emit_copy1(out: bytearray, length: int) -> None:
    """Offset-1 copies (the RLE op) in <=64-byte elements (type 10)."""
    while length:
        l = min(length, 64)
        out += bytes((((l - 1) << 2) | 2, 1, 0))
        length -= l


def snappy_compress(data: bytes) -> bytes:
    n = len(data)
    out = bytearray()
    v = n
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    starts, ends = _byte_runs(data)
    pos = 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        # literal through the run's FIRST byte: the copy needs a source
        _sn_emit_literal(out, data, pos, s + 1)
        _sn_emit_copy1(out, e - s - 1)
        pos = e
    _sn_emit_literal(out, data, pos, n)
    return bytes(out)


def snappy_decompress(data: bytes, raw_len: int) -> bytes:
    n = len(data)
    pos = 0
    length = 0
    shift = 0
    while True:
        if pos >= n or shift > 35:
            raise ValueError("snappy: bad preamble")
        b = data[pos]
        pos += 1
        length |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if length != raw_len:
        raise ValueError("snappy: length mismatch")
    dst = bytearray(raw_len)
    d = 0
    while pos < n:
        tag = data[pos]
        pos += 1
        typ = tag & 3
        if typ == 0:
            l = (tag >> 2) + 1
            if l > 60:
                extra = l - 60  # 1..4 little-endian length bytes
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                l = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            if pos + l > n or d + l > raw_len:
                raise ValueError("snappy: literal overrun")
            dst[d : d + l] = data[pos : pos + l]
            pos += l
            d += l
            continue
        if typ == 1:
            if pos >= n:
                raise ValueError("snappy: truncated copy")
            l = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif typ == 2:
            if pos + 2 > n:
                raise ValueError("snappy: truncated copy")
            l = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:
            if pos + 4 > n:
                raise ValueError("snappy: truncated copy")
            l = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > d or d + l > raw_len:
            raise ValueError("snappy: bad copy")
        if off >= l:
            dst[d : d + l] = dst[d - off : d - off + l]
        else:  # overlapped copy repeats the trailing pattern
            for k in range(l):
                dst[d + k] = dst[d - off + k]
        d += l
    if d != raw_len:
        raise ValueError("snappy: short output")
    return bytes(dst)


# --------------------------------------------------------------------- lz4


def _lz4_seq(out: bytearray, data: bytes, lo: int, hi: int,
             match_len: int | None) -> None:
    """One sequence: literals data[lo:hi], then (unless final) an
    offset-1 match of match_len (>= 4)."""
    ll = hi - lo
    tok_idx = len(out)
    out.append(0)
    if ll >= 15:
        out[tok_idx] = 0xF0
        r = ll - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    else:
        out[tok_idx] = ll << 4
    out += data[lo:hi]
    if match_len is None:
        return
    out += b"\x01\x00"  # offset 1
    ml = match_len - 4
    if ml >= 15:
        out[tok_idx] |= 0x0F
        r = ml - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    else:
        out[tok_idx] |= ml


def lz4_compress(data: bytes) -> bytes:
    n = len(data)
    out = bytearray()
    pos = 0
    if n > 16:
        starts, ends = _byte_runs(data)
        for s, e in zip(starts.tolist(), ends.tolist()):
            # end-of-block rules: the match starts at s+1 (offset-1 RLE),
            # must start >= 12 bytes before the end and never cover the
            # last 5 bytes
            if s + 1 > n - 12:
                break
            mlen = min(e, n - 5) - (s + 1)
            if mlen < 4:
                continue
            _lz4_seq(out, data, pos, s + 1, mlen)
            pos = s + 1 + mlen
    _lz4_seq(out, data, pos, n, None)  # final literals-only sequence
    return bytes(out)


def lz4_decompress(data: bytes, raw_len: int) -> bytes:
    n = len(data)
    if n == 0:
        if raw_len:
            raise ValueError("lz4: empty input")
        return b""
    dst = bytearray(raw_len)
    pos = 0
    d = 0
    while pos < n:
        tok = data[pos]
        pos += 1
        ll = tok >> 4
        if ll == 15:
            while True:
                if pos >= n:
                    raise ValueError("lz4: truncated literal length")
                b = data[pos]
                pos += 1
                ll += b
                if b != 255:
                    break
        if pos + ll > n or d + ll > raw_len:
            raise ValueError("lz4: literal overrun")
        dst[d : d + ll] = data[pos : pos + ll]
        pos += ll
        d += ll
        if pos == n:
            break  # final literals-only sequence
        if pos + 2 > n:
            raise ValueError("lz4: truncated offset")
        off = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        ml = tok & 15
        if ml == 15:
            while True:
                if pos >= n:
                    raise ValueError("lz4: truncated match length")
                b = data[pos]
                pos += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        if off == 0 or off > d or d + ml > raw_len:
            raise ValueError("lz4: bad match")
        if off >= ml:
            dst[d : d + ml] = dst[d - off : d - off + ml]
        else:
            for k in range(ml):
                dst[d + k] = dst[d - off + k]
        d += ml
    if d != raw_len:
        raise ValueError("lz4: short output")
    return bytes(dst)
