"""Batched columnar decode for the write path (port of
tempo_tpu/ingest/columnar.py).

One OTLP push window decodes ONCE into flat coded features -- span
names and (attr key, lowered value) pairs as codes in the never-
remapping LiveDict, plus the segment's span-time bounds -- instead of
each consumer (live-search staging, WAL feature checkpoints, search
indexes) re-running the per-span Python object walk. The decode is
keyed by SEGMENT OBJECT IDENTITY: the ingester keeps one bytes object
per segment across the live/cut/flushing lifecycle, so the cache ref
IS the aliasing guard (holding the segment pins its id; an entry can
never be shadowed by a recycled id while it exists).

Lock order: callers may hold the livestage tail lock when computing
features (LiveStager._stage_trace_locked -> features_for); the cache
lock here is a leaf and never calls out while held.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np

from ..wire.segment import segment_to_trace


class LiveDict:
    """Append-only string<->code dictionary: codes are assigned in
    arrival order and NEVER remap (unlike block dictionaries, which
    sort+remap at finalize), so rows staged in earlier generations stay
    valid forever. Misses on lookup are exact prunes: a string absent
    here is provably absent from every staged row."""

    def __init__(self):
        self._lock = threading.Lock()
        self._code: dict[str, int] = {"": 0}
        self._strings: list[str] = [""]

    def code(self, s: str) -> int:
        with self._lock:
            c = self._code.get(s)
            if c is None:
                c = self._code[s] = len(self._strings)
                self._strings.append(s)
            return c

    def lookup(self, s: str) -> int:
        with self._lock:
            return self._code.get(s, -1)

    def string(self, code: int) -> str:
        with self._lock:
            return self._strings[code] if 0 <= code < len(self._strings) else ""

    def __len__(self) -> int:
        with self._lock:
            return len(self._strings)


def kv_pair_key(key: str, value: str) -> str:
    """Dictionary key for one (attr key, lowered value) membership pair
    -- a single code per pair keeps the tag test one equality on
    device. NUL can't appear in either half (attr keys and stringified
    values), so the join is collision-free."""
    return key + "\x00" + value


_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_U64 = (1 << 64) - 1


def _fnv1a_64(data: bytes, seed: int = _FNV64_OFFSET) -> int:
    """64-bit FNV-1a over raw bytes: the coded edge-store key hash.
    Python-side (runs inside the one-time decode walk); 64 bits keep
    accidental (trace, span) key collisions out of reach."""
    h = seed
    for b in data:
        h = ((h ^ b) * _FNV64_PRIME) & _U64
    return h


def edge_key_client(trace_id: bytes, span_id: bytes) -> int:
    """Coded pairing key for a CLIENT span: hash(trace_id || span_id).
    The matching SERVER span hashes (trace_id || parent_span_id) to the
    SAME integer, so client/server pairing is one dict probe on an int
    instead of a byte-tuple key. 0 is reserved for "no edge role"."""
    return _fnv1a_64(span_id, _fnv1a_64(trace_id)) or 1


class SpanColumns(NamedTuple):
    """Per-span coded columns for the streaming metrics-generator,
    filled inside the SAME decode that codes the search features. All
    arrays share span (document) order:

      svc_code/name_code  int32 LiveDict codes (resource service.name,
                          span name -- never remap, so series keys
                          assembled from them stay stable forever)
      kind/status         int32 raw enum values
      dur_s               float32 max(0, duration_nanos)/1e9 (exactly
                          the legacy processors' duration definition)
      edge_key            uint64 service-graph pairing key: CLIENT
                          spans hash (trace_id, span_id), SERVER spans
                          hash (trace_id, parent_span_id), others 0
      tid_hex             the segment's trace id (exemplars)
    """

    svc_code: np.ndarray
    name_code: np.ndarray
    kind: np.ndarray
    status: np.ndarray
    dur_s: np.ndarray
    edge_key: np.ndarray
    tid_hex: str


class SegFeatures(NamedTuple):
    """One segment's coded contribution to its trace's staged features.
    EXACTLY the per-span extraction services/ingester._SearchEntry.build
    performs, coded through the LiveDict: the union over a trace's
    segments is a conservative superset of the entry built from the
    combined trace (combine_traces dedupes by (span_id, start, name),
    so dropped duplicates only SHRINK the combined sets). lo/hi None =
    the segment carried no spans.

    `spans` (per-span generator columns) is optional: WAL replay seeds
    features from checkpointed strings WITHOUT a proto decode, and the
    generator tap only consumes freshly-pushed windows -- so replayed
    entries legitimately carry None here."""

    kv_codes: tuple[int, ...]
    name_codes: tuple[int, ...]
    lo_ns: int | None
    hi_ns: int | None
    spans: SpanColumns | None = None


# SpanKind values with a service-graph edge role (wire/model.py:
# SERVER=2, CLIENT=3)
_KIND_SERVER = 2
_KIND_CLIENT = 3


def span_columns_from_trace(tr, code) -> SpanColumns:
    """Per-span generator columns from an already-decoded Trace; `code`
    is a LiveDict.code bound method. Shared by compute_features (the
    write-path single decode) and the remote-generator push path (which
    receives decoded traces over /internal/genpush)."""
    svc: list[int] = []
    name: list[int] = []
    kind: list[int] = []
    status: list[int] = []
    dur: list[float] = []
    ekey: list[int] = []
    tid_hex = ""
    for res, _, sp in tr.all_spans():
        svc.append(code(res.service_name))
        name.append(code(sp.name))
        k = int(sp.kind)
        kind.append(k)
        status.append(int(sp.status_code))
        dur.append(max(0, sp.duration_nanos) / 1e9)
        if k == _KIND_CLIENT:
            ekey.append(edge_key_client(sp.trace_id, sp.span_id))
        elif k == _KIND_SERVER:
            ekey.append(edge_key_client(sp.trace_id, sp.parent_span_id))
        else:
            ekey.append(0)
        if not tid_hex and sp.trace_id:
            tid_hex = sp.trace_id.hex()
    return SpanColumns(
        np.asarray(svc, np.int32), np.asarray(name, np.int32),
        np.asarray(kind, np.int32), np.asarray(status, np.int32),
        np.asarray(dur, np.float32), np.asarray(ekey, np.uint64), tid_hex)


def compute_features(seg: bytes, ldict: LiveDict) -> SegFeatures:
    """Decode one segment's proto and code its features (first-seen
    order, deduped within the segment). The generator's per-span
    columns ride the same walk -- one decode serves search staging,
    WAL checkpoints AND the streaming metrics-generator."""
    tr = segment_to_trace(seg)
    code = ldict.code
    kv_codes: list[int] = []
    kv_seen: set[int] = set()
    name_codes: list[int] = []
    name_seen: set[int] = set()
    lo = hi = None
    for res, _, sp in tr.all_spans():
        c = code(sp.name)
        if c not in name_seen:
            name_seen.add(c)
            name_codes.append(c)
        for attrs in (sp.attrs, res.attrs):
            for k, v in attrs.items():
                c = code(kv_pair_key(k, str(v).lower()))
                if c not in kv_seen:
                    kv_seen.add(c)
                    kv_codes.append(c)
        if lo is None or sp.start_unix_nano < lo:
            lo = sp.start_unix_nano
        if hi is None or sp.end_unix_nano > hi:
            hi = sp.end_unix_nano
    return SegFeatures(tuple(kv_codes), tuple(name_codes), lo, hi,
                       span_columns_from_trace(tr, code))


class ColumnarIngest:
    """Per-instance columnar decode plane: one LiveDict shared by
    live-search staging and the WAL's feature checkpoints, plus the
    identity-keyed feature cache that makes 'decode once' true across
    consumers. Thread-safe; the internal lock is a leaf."""

    # cache ceiling (segments). Overflow evicts oldest-inserted half --
    # evicted entries recompute on next touch, so the cap only bounds
    # memory, never correctness.
    MAX_ENTRIES = 1 << 16

    def __init__(self, dictionary: LiveDict | None = None):
        self.dict = dictionary if dictionary is not None else LiveDict()
        self._lock = threading.Lock()
        # id(seg) -> (seg, SegFeatures); the held seg ref pins the id
        self._feats: dict[int, tuple[bytes, SegFeatures]] = {}
        self.decodes = 0  # proto decodes actually performed
        self.decode_s = 0.0  # host seconds spent in those decodes
        self.seeded = 0  # features installed without a decode (replay)

    # ------------------------------------------------------------ decode
    def features_for(self, seg: bytes) -> SegFeatures:
        """The segment's features, computing (and caching) on miss.
        This IS the batched-decode chokepoint: staging, WAL feature
        flushes and replay all read through here."""
        key = id(seg)
        with self._lock:
            ent = self._feats.get(key)
            if ent is not None:
                return ent[1]
        t0 = time.perf_counter()
        feat = compute_features(seg, self.dict)
        dt = time.perf_counter() - t0
        with self._lock:
            self.decode_s += dt
            self.decodes += 1
            self._install_locked(key, seg, feat)
        return feat

    def decode_window(self, batch: list[tuple[bytes, int, int, bytes]]) -> list[SegFeatures]:
        """Eager decode of one push window's segments
        ([(tid, start_s, end_s, seg)]), returned in order."""
        return [self.features_for(seg) for _, _, _, seg in batch]

    def cached(self, seg: bytes) -> SegFeatures | None:
        """Cache-only lookup (never decodes): the WAL feature flush uses
        this so checkpointing never ADDS decode work to the write path."""
        with self._lock:
            ent = self._feats.get(id(seg))
            return ent[1] if ent is not None else None

    # ------------------------------------------------------------ replay
    def seed_strings(self, seg: bytes, kv: tuple[str, ...],
                     names: tuple[str, ...], lo_ns: int | None,
                     hi_ns: int | None) -> None:
        """Install replayed WAL feature strings as this instance's codes
        -- the no-proto-decode replay path. kv strings are the joined
        kv_pair_key form, exactly as the dictionary stores them."""
        feat = SegFeatures(tuple(self.dict.code(s) for s in kv),
                           tuple(self.dict.code(n) for n in names),
                           lo_ns, hi_ns)
        with self._lock:
            self.seeded += 1
            self._install_locked(id(seg), seg, feat)

    # ---------------------------------------------------------- lifecycle
    def discard(self, segs: list[bytes]) -> None:
        """Drop cache entries for segments leaving the live window (a
        flushed block landed, or the WAL head was cleared)."""
        with self._lock:
            for seg in segs:
                self._feats.pop(id(seg), None)

    def _install_locked(self, key: int, seg: bytes, feat: SegFeatures) -> None:
        if len(self._feats) >= self.MAX_ENTRIES:
            for k in list(self._feats)[: self.MAX_ENTRIES // 2]:
                del self._feats[k]
        self._feats[key] = (seg, feat)

    def stats(self) -> dict:
        """Cache entries, decodes performed, features seeded by replay and
        the dictionary's size: `decodes - cached == 0` proves that no
        consumer decoded a segment twice (while no entry was evicted)."""
        with self._lock:
            return {"cached": len(self._feats), "decodes": self.decodes,
                    "seeded": self.seeded, "dict_size": len(self.dict)}
