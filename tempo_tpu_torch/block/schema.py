"""vtpu block schema: the column set and its device/host split.

Design (TPU-first rethink of vparquet's one-row-per-trace nested schema,
tempodb/encoding/vparquet/schema.go:75-172):

* span-major structure-of-arrays: every span is a row across flat,
  fixed-dtype columns; traces are contiguous runs bounded by
  `trace.span_off` (a segment-offsets array). Dremel rep/def levels are
  never needed -- hierarchy is explicit segment ids, so trace-level
  aggregation is a segmented reduce and "structural" joins are masks.
* all strings are int32 codes into one sorted per-block dictionary
  (dictionary.py); string predicates become integer compares on device.
* every DEVICE column is int32/float32 and uploads with zero
  transposition. Quantities that don't fit (u64 nanos, 128-bit ids,
  byte blobs) keep an exact HOST column for verification +
  materialization, and a *conservative* int32 device encoding for
  filtering: device filters may over-match (like a bloom), never
  under-match; the host re-checks survivors exactly.

Time encoding: span start is milliseconds relative to the block's start
(int32: +-24 days), duration is microseconds clamped to int32
(~35 min); the planner rounds thresholds outward so clamping stays
conservative.

Attribute tables are CSR-style: one row per attribute with an owner-row
column (`sattr.span`, `rattr.res`, ...), so device predicate hits
scatter back to spans with one segment-max.
"""

from __future__ import annotations

# attribute value types
VT_STR = 0
VT_INT = 1
VT_FLOAT = 2
VT_BOOL = 3
VT_COMPLEX = 4  # arrays/bytes/kvlists, stored as OTLP-JSON in the dict

# axes (row-group chunking dimensions in the column pack)
AX_SPAN = "span"
AX_SATTR = "sattr"
AX_EVENT = "ev"
AX_EVATTR = "evattr"
AX_LINK = "ln"
AX_LNATTR = "lnattr"
AX_RATTR = "rattr"  # not a row-group axis: resource attr tables are read whole

WELL_KNOWN_SPAN_ATTRS = {
    # attr key -> dedicated span column (vparquet's dedicated-column idea)
    "http.status_code": "span.http_status",
    "http.method": "span.http_method_id",
    "http.url": "span.http_url_id",
}
WELL_KNOWN_RES_ATTRS = {
    "service.name": "res.service_id",
    "k8s.cluster.name": "res.cluster_id",
    "k8s.namespace.name": "res.namespace_id",
    "k8s.pod.name": "res.pod_id",
    "k8s.container.name": "res.container_id",
    "cluster": "res.cluster_id2",
    "namespace": "res.namespace_id2",
    "pod": "res.pod_id2",
    "container": "res.container_id2",
}

DEFAULT_ROW_GROUP_SPANS = 1 << 16  # 64Ki span rows per group


def trace_id_to_codes(tid: bytes) -> tuple[int, int, int, int]:
    """16-byte id -> 4 order-preserving int32 codes: big-endian u32 words
    XOR 0x80000000, so signed int32 comparison == unsigned byte order."""
    t = tid.rjust(16, b"\x00")
    return tuple(
        int.from_bytes(t[i : i + 4], "big") - 0x80000000 for i in (0, 4, 8, 12)
    )


def codes_to_trace_id(codes) -> bytes:
    return b"".join(int(int(c) + 0x80000000).to_bytes(4, "big") for c in codes)
