"""The ingest wire layer against the JAX package's: the OTLP proto
encoder (wire/otlp_pb), segments (wire/segment) and the WAL v2 frames
(ingest/walcodec) write the same bytes in both packages, and each
package decodes what the other wrote."""

import dataclasses

import pytest

from tempo_tpu.ingest import walcodec as r_walcodec
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu.wire import otlp_pb as r_otlp
from tempo_tpu.wire import pbwire as r_pbwire
from tempo_tpu.wire import segment as r_segment
from tempo_tpu.wire.model import Event as REvent
from tempo_tpu.wire.model import Link as RLink
from tempo_tpu_torch.ingest import walcodec
from tempo_tpu_torch.util.testdata import make_traces
from tempo_tpu_torch.wire import otlp_pb, pbwire, segment
from tempo_tpu_torch.wire.model import Event, Link

SEEDS = [3, 17]


def _pairs(seed, n=40, n_spans=6):
    """The same traces built by each package's generator from one seed,
    with links and every AnyValue arm added the same way to both."""
    ours, theirs = make_traces(n, seed=seed, n_spans=n_spans), r_make_traces(n, seed=seed,
                                                                            n_spans=n_spans)
    for i, ((tid, t), (rtid, rt)) in enumerate(zip(ours, theirs)):
        assert tid == rtid
        if i % 3 == 0:
            for tr, link_cls, ev_cls in ((t, Link, Event), (rt, RLink, REvent)):
                sp = tr.resource_spans[0].scope_spans[0].spans[0]
                sp.links.append(link_cls(trace_id=tid, span_id=b"\x01" * 8, trace_state="x=1",
                                         attrs={"k": -7, "f": 0.5, "b": b"", "l": [1, "a", False]}))
                sp.events.append(ev_cls(time_unix_nano=5, name="e", attrs={"neg": -1},
                                        dropped_attributes_count=2))
                sp.dropped_attributes_count = 3
                sp.status_message = "boom"
    return ours, theirs


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_trace_is_byte_identical_and_round_trips(seed):
    ours, theirs = _pairs(seed)
    for (_, t), (_, rt) in zip(ours, theirs):
        data = otlp_pb.encode_trace(t)
        assert data == r_otlp.encode_trace(rt)
        back, rback = otlp_pb.decode_trace(data), r_otlp.decode_trace(data)
        assert dataclasses.asdict(back) == dataclasses.asdict(rback) == dataclasses.asdict(t)
        assert otlp_pb.encode_trace(back) == data


@pytest.mark.parametrize("seed", SEEDS)
def test_segments_and_objects_are_byte_identical(seed):
    ours, theirs = _pairs(seed)
    segs = []
    for i, ((tid, t), (_, rt)) in enumerate(zip(ours, theirs)):
        s, e = 1_700_000_000 + i, 1_700_000_010 + i
        seg = segment.segment_for_write(t, s, e)
        assert seg == r_segment.segment_for_write(rt, s, e)
        assert segment.segment_fast_range(seg) == r_segment.segment_fast_range(seg) == (s, e)
        assert segment.segment_payload(seg) == r_segment.segment_payload(seg)
        assert dataclasses.asdict(segment.segment_to_trace(seg)) == dataclasses.asdict(t)
        segs.append(seg)
    obj = segment.segments_to_object(segs[:5])
    assert obj == r_segment.segments_to_object(segs[:5])
    assert segment.object_segments(obj) == r_segment.object_segments(obj) == segs[:5]
    assert segment.object_fast_range(obj) == r_segment.object_fast_range(obj)
    assert (dataclasses.asdict(segment.object_to_trace(obj))
            == dataclasses.asdict(r_segment.object_to_trace(obj)))
    with pytest.raises(segment.DecodeError):
        segment.segment_to_trace(b"\x02" + seg[1:])


def test_varints_match_the_reference():
    for v in (0, 1, 127, 128, 300, 2**31, 2**63 - 1, -1, -(2**63)):
        a, b = bytearray(), bytearray()
        pbwire.write_varint(a, v)
        r_pbwire.write_varint(b, v)
        assert a == b
        assert pbwire.read_varint(bytes(a), 0) == r_pbwire.read_varint(bytes(b), 0)
    with pytest.raises(ValueError):
        pbwire.read_varint(b"\x80", 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_walcodec_frames_are_byte_identical(seed):
    ours, _ = _pairs(seed, n=12, n_spans=3)
    batch = [(tid[:15] if i == 3 else tid, i, 2 * i + 1, segment.segment_for_write(t, i, 2 * i + 1))
             for i, (tid, t) in enumerate(ours)]
    frame = walcodec.encode_window(batch)
    assert frame == r_walcodec.encode_window(batch)
    delta = ["", "svc\x00db", "name-é"]
    entries = [(0, 1, [0, 2], [1], 5, None), (0, 2, [], [2, 1], None, 2**63)]
    feat = walcodec.encode_features(delta, entries)
    assert feat == r_walcodec.encode_features(delta, entries)
    for data in (frame, feat):
        ln, off = pbwire.read_varint(data, 0)
        assert walcodec.decode_record(data, off, ln) == r_walcodec.decode_record(data, off, ln)
    ln, off = pbwire.read_varint(frame, 0)
    rtype, body = walcodec.decode_record(frame, off, ln)
    assert rtype == walcodec.REC_WINDOW
    assert body == [(tid.rjust(16, b"\x00"), s, e, seg) for tid, s, e, seg in batch]
    # a flipped payload byte fails the CRC in both packages
    bad = bytearray(frame)
    bad[-1] ^= 0x40
    assert walcodec.decode_record(bytes(bad), off, ln) is None
    assert r_walcodec.decode_record(bytes(bad), off, ln) is None
