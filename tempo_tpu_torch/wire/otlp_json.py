"""OTLP/JSON codec (the standard OTLP HTTP JSON encoding; port of
tempo_tpu/wire/otlp_json.py).

Follows the OTLP JSON mapping rules: trace/span ids are hex strings,
64-bit ints are decimal strings, enums are numbers, AnyValue is a
one-key object ({"stringValue": ...} etc.). The App's /v1/traces JSON
ingest and /api/traces/<id> answers speak it, and the block builder
stores complex attribute values (bytes, arrays, kvlists) as its
AnyValue JSON in the block dictionary.
"""

from __future__ import annotations

import json
from typing import Any

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


def _value_to_json(v: AnyValue) -> dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, str):
        return {"stringValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    if isinstance(v, bytes):
        import base64

        return {"bytesValue": base64.b64encode(v).decode("ascii")}
    if isinstance(v, list):
        return {"arrayValue": {"values": [_value_to_json(x) for x in v]}}
    return {"stringValue": str(v)}


def _value_from_json(d: dict[str, Any]) -> AnyValue:
    if "stringValue" in d:
        return d["stringValue"]
    if "boolValue" in d:
        return bool(d["boolValue"])
    if "intValue" in d:
        return int(d["intValue"])
    if "doubleValue" in d:
        return float(d["doubleValue"])
    if "bytesValue" in d:
        import base64

        return base64.b64decode(d["bytesValue"])
    if "arrayValue" in d:
        return [_value_from_json(x) for x in d["arrayValue"].get("values", [])]
    if "kvlistValue" in d:
        return [
            [kv.get("key", ""), _value_from_json(kv.get("value", {}))]
            for kv in d["kvlistValue"].get("values", [])
        ]
    return ""


def _attrs_to_json(attrs: dict[str, AnyValue]) -> list[dict]:
    return [{"key": k, "value": _value_to_json(v)} for k, v in attrs.items()]


def _attrs_from_json(lst: list[dict]) -> dict[str, AnyValue]:
    return {kv.get("key", ""): _value_from_json(kv.get("value", {})) for kv in lst}


def span_to_json(sp: Span) -> dict:
    d: dict[str, Any] = {
        "traceId": sp.trace_id.hex(),
        "spanId": sp.span_id.hex(),
        "name": sp.name,
        "kind": int(sp.kind),
        "startTimeUnixNano": str(sp.start_unix_nano),
        "endTimeUnixNano": str(sp.end_unix_nano),
    }
    if sp.parent_span_id:
        d["parentSpanId"] = sp.parent_span_id.hex()
    if sp.trace_state:
        d["traceState"] = sp.trace_state
    if sp.attrs:
        d["attributes"] = _attrs_to_json(sp.attrs)
    if sp.dropped_attributes_count:
        d["droppedAttributesCount"] = sp.dropped_attributes_count
    if sp.events:
        d["events"] = [
            {
                "timeUnixNano": str(e.time_unix_nano),
                "name": e.name,
                "attributes": _attrs_to_json(e.attrs),
                **(
                    {"droppedAttributesCount": e.dropped_attributes_count}
                    if e.dropped_attributes_count
                    else {}
                ),
            }
            for e in sp.events
        ]
    if sp.links:
        d["links"] = [
            {
                "traceId": l.trace_id.hex(),
                "spanId": l.span_id.hex(),
                "attributes": _attrs_to_json(l.attrs),
                **({"traceState": l.trace_state} if l.trace_state else {}),
            }
            for l in sp.links
        ]
    if sp.status_code or sp.status_message:
        st: dict[str, Any] = {"code": int(sp.status_code)}
        if sp.status_message:
            st["message"] = sp.status_message
        d["status"] = st
    return d


def span_from_json(d: dict) -> Span:
    sp = Span(
        trace_id=bytes.fromhex(d.get("traceId", "")),
        span_id=bytes.fromhex(d.get("spanId", "")),
        parent_span_id=bytes.fromhex(d.get("parentSpanId", "") or ""),
        trace_state=d.get("traceState", ""),
        name=d.get("name", ""),
        kind=int(d.get("kind", 0)),
        start_unix_nano=int(d.get("startTimeUnixNano", 0)),
        end_unix_nano=int(d.get("endTimeUnixNano", 0)),
        attrs=_attrs_from_json(d.get("attributes", [])),
        dropped_attributes_count=int(d.get("droppedAttributesCount", 0)),
    )
    for e in d.get("events", []):
        sp.events.append(
            Event(
                time_unix_nano=int(e.get("timeUnixNano", 0)),
                name=e.get("name", ""),
                attrs=_attrs_from_json(e.get("attributes", [])),
                dropped_attributes_count=int(e.get("droppedAttributesCount", 0)),
            )
        )
    for l in d.get("links", []):
        sp.links.append(
            Link(
                trace_id=bytes.fromhex(l.get("traceId", "")),
                span_id=bytes.fromhex(l.get("spanId", "")),
                trace_state=l.get("traceState", ""),
                attrs=_attrs_from_json(l.get("attributes", [])),
            )
        )
    st = d.get("status", {})
    sp.status_code = int(st.get("code", 0))
    sp.status_message = st.get("message", "")
    return sp


def trace_to_json(t: Trace) -> dict:
    return {
        "resourceSpans": [
            {
                "resource": {"attributes": _attrs_to_json(rs.resource.attrs)},
                "scopeSpans": [
                    {
                        "scope": {"name": ss.scope.name, "version": ss.scope.version},
                        "spans": [span_to_json(sp) for sp in ss.spans],
                    }
                    for ss in rs.scope_spans
                ],
            }
            for rs in t.resource_spans
        ]
    }


def trace_from_json(d: dict) -> Trace:
    t = Trace()
    for rs_j in d.get("resourceSpans", []):
        rs = ResourceSpans(
            resource=Resource(attrs=_attrs_from_json(rs_j.get("resource", {}).get("attributes", [])))
        )
        for ss_j in rs_j.get("scopeSpans", []) or rs_j.get("instrumentationLibrarySpans", []):
            scope_j = ss_j.get("scope", {}) or ss_j.get("instrumentationLibrary", {})
            ss = ScopeSpans(scope=Scope(name=scope_j.get("name", ""), version=scope_j.get("version", "")))
            for sp_j in ss_j.get("spans", []):
                ss.spans.append(span_from_json(sp_j))
            rs.scope_spans.append(ss)
        t.resource_spans.append(rs)
    return t


def dumps(t: Trace) -> str:
    return json.dumps(trace_to_json(t))


def loads(s: str | bytes) -> Trace:
    return trace_from_json(json.loads(s))
