"""Live-head staging: incremental device columns for the ingester's
live/cut/flushing traces (port of tempo_tpu/ops/livestage.py).

The ingester keeps per-tenant APPEND-ONLY columnar tails of its live
head so the same filter -> top-k shape as complete blocks covers live
traces too:

  * one SLOT per live trace id (merged across the live/cut/flushing
    lifecycle states) carrying the filterable per-trace aggregates:
    push-metadata time bounds, the exact span-time selection key
    (seconds since ops/stage.GKEY_ORIGIN_S), a conservative duration,
    an alive flag, and the 4x int32 trace-id codes for find;
  * append-only ROW tails for tag membership: (owner slot, code) rows
    for every (key, lowered-str-value) attr pair and every span name,
    through an append-only dictionary whose codes never remap.

New segments are delta-encoded into the host tails at the next refresh,
and refreshes delta-upload: when the buckets are unchanged only the NEW
rows and the dirty slots cross the host->device link, and the next
generation's columns are built on the device from the resident ones
(B7c appends rows, B7d patches slots). Every refresh stamps a new
generation and returns an immutable LiveSnapshot: B7c and B7d write new
tensors, so a query holding an older snapshot keeps a consistent view.
Cut/flush retiring a trace only flips its slot's alive flag, and a
compaction pass rebuilds the tails from the per-trace fragments once
dead slots or dead rows pass a threshold.

Conservative-filter contract: the slot mask (B7a) may over-match but
never under-match the host oracle (the ingester's _SearchEntry) -- tag
and name membership and the time prefilter are exact, min-duration
filters on the per-segment-union duration (>= the combined trace's),
and max-duration / TraceQL are settled ONLY by the exact host
verification of the selected candidates (db/live_engine).

Each kernel op sends CUDA tensors to its kernel (csrc/livestage.cu
through kernels.py) and CPU tensors to its plain PyTorch version below;
every output is an integer or a bool, so the two agree exactly.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..block import schema as S
from ..ingest.columnar import LiveDict, compute_features
from .device import PAD_I32, bucket, pad_rows, resolve_device
from .stage import GKEY_ORIGIN_S

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1
_SLOT_COLS = ("start_s", "end_s", "dur_ms", "key_s", "alive", "id_codes")


def _clip_i32(v: int) -> int:
    return int(min(max(v, _I32_MIN + 1), _I32_MAX))


def _delta_bucket(n: int, floor: int = 64) -> int:
    """Small power-of-two bucket for delta uploads (no MIN_BUCKET floor:
    a 50-row delta must not pad to 1024 rows or the append could not fit
    before the full bucket does)."""
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclass
class _TraceTail:
    """Host-side per-trace fragment: which segments are staged and the
    rows/aggregates they contributed. Fragments survive until the trace
    retires so a compaction rebuild never re-decodes segments."""

    slot: int
    staged_segs: list = field(default_factory=list)  # segment refs
    kv_codes: list = field(default_factory=list)
    name_codes: list = field(default_factory=list)
    kv_seen: set = field(default_factory=set)  # staged kv CODES
    name_seen: set = field(default_factory=set)  # staged name CODES
    min_start_ns: int | None = None
    max_end_ns: int | None = None
    state: str = "live"


@dataclass(frozen=True)
class LiveSnapshot:
    """One consistent, immutable view of the staged live head. Slot
    arrays are copies (they mutate in place across refreshes); row
    arrays are views into append-only storage (rows below the recorded
    counts are never rewritten; growth reallocates, compaction swaps in
    fresh arrays -- either way this snapshot's references stay valid).
    The device columns are tensors no later refresh writes."""

    generation: int
    n_slots: int
    n_kv: int
    n_name: int
    slot_b: int
    kv_b: int
    name_b: int
    # host columns (numpy)
    start_s: np.ndarray
    end_s: np.ndarray
    dur_ms: np.ndarray
    key_s: np.ndarray
    alive: np.ndarray
    id_codes: np.ndarray  # (n_slots, 4)
    kv_owner: np.ndarray
    kv_code: np.ndarray
    name_owner: np.ndarray
    name_code: np.ndarray
    # device columns (padded to the buckets)
    dev: dict
    # slot -> trace id (the collect step maps winners back through the
    # caller's own groups snapshot for segments/verification)
    slot_tid: dict


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """A device copy that never aliases the stager's mutable host arrays
    (torch.from_numpy shares memory, and .to() of a CPU tensor to the
    CPU returns it as is)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


def _padded_host_cols(start_s, end_s, dur_ms, key_s, alive, id_codes, kv_owner, kv_code,
                      name_owner, name_code, slot_b: int, kv_b: int, name_b: int) -> dict:
    """The device layout of the staged columns: each padded to its bucket
    with the JAX package's fill values."""
    return {
        "start_s": pad_rows(start_s, slot_b, np.int32(0)),
        "end_s": pad_rows(end_s, slot_b, np.int32(0)),
        "dur_ms": pad_rows(dur_ms, slot_b, np.int32(0)),
        "key_s": pad_rows(key_s, slot_b, np.int32(_I32_MIN)),
        "alive": pad_rows(alive, slot_b, np.int32(0)),
        "id_codes": pad_rows(id_codes, slot_b, PAD_I32),
        "kv_owner": pad_rows(kv_owner, kv_b, np.int32(0)),
        "kv_code": pad_rows(kv_code, kv_b, PAD_I32),
        "name_owner": pad_rows(name_owner, name_b, np.int32(0)),
        "name_code": pad_rows(name_code, name_b, PAD_I32),
    }


def snapshot_from_numpy(snap, device) -> LiveSnapshot:
    """The port's snapshot of a staged live head whose host columns are
    numpy (a LiveSnapshot of either package): the same host columns and
    the same padded device layout on `device`. Tests feed both packages
    one staged state this way."""
    device = resolve_device(device)
    cols = {n: np.asarray(getattr(snap, n)) for n in (
        "start_s", "end_s", "dur_ms", "key_s", "alive", "id_codes",
        "kv_owner", "kv_code", "name_owner", "name_code")}
    host = _padded_host_cols(**cols, slot_b=snap.slot_b, kv_b=snap.kv_b, name_b=snap.name_b)
    return LiveSnapshot(
        generation=snap.generation, n_slots=snap.n_slots, n_kv=snap.n_kv,
        n_name=snap.n_name, slot_b=snap.slot_b, kv_b=snap.kv_b, name_b=snap.name_b,
        **cols, dev={k: _upload(v, device) for k, v in host.items()},
        slot_tid=dict(snap.slot_tid))


# ------------------------------------------------------------ B7a
def live_filter(slots: tuple, kv: tuple, names: tuple, q, n_tags: int,
                t0: int | None, t1: int | None, dmin: int | None,
                n_slots: int, n_kv: int | None = None, n_name: int | None = None) -> torch.Tensor:
    """The slot mask: alive, below n_slots, end_s >= t0, start_s <= t1,
    dur_ms >= dmin (each where given), and for each of q's first n_tags
    codes a kv row of the slot with that code, for each later code a
    name row (owners clipped to the slot bucket). slots = (start_s,
    end_s, dur_ms, alive); kv and names = (owner, code). q: the codes, as
    ints or a CPU tensor; on a card they reach the kernel by value (a
    CUDA q would cost a read-back, so it is refused), and the kernel reads
    only the first n_kv / n_name rows (None: all), the rest being the
    stager's padding (owner 0, code PAD_I32), which the plain version
    reads as rows."""
    if isinstance(q, torch.Tensor) and q.device.type != "cpu":
        raise ValueError(f"live_filter: q on {q.device}; pass the codes as ints")
    if slots[3].device.type == "cuda":
        return kernels.live_filter(slots, kv, names, q, n_tags, t0, t1, dmin, n_slots, n_kv,
                                   n_name)
    return _live_filter_plain(slots, kv, names, torch.as_tensor(q, dtype=torch.int32), n_tags,
                              t0, t1, dmin, n_slots)


def _live_filter_plain(slots, kv, names, q, n_tags, t0, t1, dmin, n_slots) -> torch.Tensor:
    start_s, end_s, dur_ms, alive = slots
    slot_b = alive.shape[0]
    mask = (alive > 0) & (torch.arange(slot_b, device=alive.device) < n_slots)
    if t0 is not None:
        mask &= end_s >= t0
    if t1 is not None:
        mask &= start_s <= t1
    if dmin is not None:
        mask &= dur_ms >= dmin
    for i, c in enumerate(q.tolist()):
        owner, code = kv if i < n_tags else names
        hit = torch.zeros(slot_b, dtype=torch.bool, device=alive.device)
        hit.index_put_((owner.clamp(0, slot_b - 1)[code == c].long(),),
                       torch.tensor(True, device=alive.device))
        mask &= hit
    return mask


def eval_live_device(snap: LiveSnapshot, tag_codes: list[int], name_codes: list[int],
                     t0: int, t1: int, dmin: int) -> torch.Tensor:
    """The live head's slot mask on the snapshot's device columns.
    t0/t1/dmin <= 0 mean 'no filter' (SearchRequest's zero-is-unset
    convention). Returns the (slot_b,) bool mask on the device."""
    d = snap.dev
    return live_filter((d["start_s"], d["end_s"], d["dur_ms"], d["alive"]),
                       (d["kv_owner"], d["kv_code"]), (d["name_owner"], d["name_code"]),
                       [int(c) for c in tag_codes] + [int(c) for c in name_codes],
                       len(tag_codes), _clip_i32(t0) if t0 > 0 else None,
                       _clip_i32(t1) if t1 > 0 else None,
                       _clip_i32(dmin) if dmin > 0 else None, snap.n_slots, snap.n_kv,
                       snap.n_name)


def eval_live_host(snap: LiveSnapshot, tag_codes: list[int],
                   name_codes: list[int], t0: int, t1: int, dmin: int) -> np.ndarray:
    """Numpy twin of eval_live_device over the snapshot's host columns:
    identical mask semantics with zero device round trips."""
    n = snap.n_slots
    mask = snap.alive[:n] > 0
    if t0 > 0:
        mask &= snap.end_s[:n] >= _clip_i32(t0)
    if t1 > 0:
        mask &= snap.start_s[:n] <= _clip_i32(t1)
    if dmin > 0:
        mask &= snap.dur_ms[:n] >= _clip_i32(dmin)
    for codes, owner_all, code_all in ((tag_codes, snap.kv_owner, snap.kv_code),
                                       (name_codes, snap.name_owner, snap.name_code)):
        for c in codes:
            hit = np.zeros(max(n, 1), dtype=bool)
            owners = owner_all[code_all == c]
            hit[owners[(owners >= 0) & (owners < n)]] = True
            mask &= hit[:n]
    return mask


# ------------------------------------------------------------ B7b
def live_find(id_codes: torch.Tensor, alive: torch.Tensor, q, n_slots: int) -> torch.Tensor:
    """(1,) int32: the first slot below n_slots that is alive and whose
    4 id codes equal q's, else -1. q: the 4 codes, as ints or a CPU
    tensor; on a card they reach the kernel as its arguments (a CUDA q
    would cost a read-back, so it is refused)."""
    if isinstance(q, torch.Tensor) and q.device.type != "cpu":
        raise ValueError(f"live_find: q on {q.device}; pass the 4 codes as ints")
    if id_codes.device.type == "cuda":
        return kernels.live_find(id_codes, alive, q.tolist() if isinstance(q, torch.Tensor) else q,
                                 n_slots)
    return _live_find_plain(id_codes, alive, torch.as_tensor(q, dtype=torch.int32), n_slots)


def _live_find_plain(id_codes, alive, q, n_slots) -> torch.Tensor:
    slot_b = id_codes.shape[0]
    m = ((id_codes == q[None, :]).all(dim=1) & (alive > 0)
         & (torch.arange(slot_b, device=alive.device) < n_slots))
    first = m.to(torch.int32).argmax()  # the first maximum
    return torch.where(m.any(), first, -1).to(torch.int32).reshape(1)


def find_slot_device(snap: LiveSnapshot, trace_id: bytes) -> int:
    """A live trace's slot by its 4x int32 id codes on the device; -1 =
    not staged or not alive. One launch with the codes as its arguments,
    and one tiny fetch."""
    d = snap.dev
    codes = S.trace_id_to_codes(trace_id.rjust(16, b"\x00"))
    return int(live_find(d["id_codes"], d["alive"], codes, snap.n_slots).item())


def find_slot_host(snap: LiveSnapshot, trace_id: bytes) -> int:
    """Numpy twin of find_slot_device."""
    n = snap.n_slots
    if n == 0:
        return -1
    q = np.asarray(S.trace_id_to_codes(trace_id.rjust(16, b"\x00")), dtype=np.int32)
    m = np.all(snap.id_codes[:n] == q[None, :], axis=1) & (snap.alive[:n] > 0)
    idx = int(np.argmax(m))
    return idx if m[idx] else -1


# ------------------------------------------------------------ B7c
def append_rows(dst: torch.Tensor, src: torch.Tensor, start: int) -> torch.Tensor:
    """Delta append: a NEW column equal to dst with src written at
    `start` (a negative start counts from the end; the start is clamped
    to [0, len(dst) - len(src)], as dynamic_update_slice does). Only
    `src` crossed the host->device link."""
    if dst.device.type == "cuda":
        return kernels.live_append(dst, src, start)
    return _append_plain(dst, src, start)


def _append_plain(dst: torch.Tensor, src: torch.Tensor, start: int) -> torch.Tensor:
    n, m = dst.shape[0], src.shape[0]
    if m > n:
        raise ValueError(f"append_rows: {m} rows into a column of {n}")
    start = int(start)
    s = min(max(start + n if start < 0 else start, 0), n - m)
    out = dst.clone()
    out[s:s + m] = src
    return out


# ------------------------------------------------------------ B7d
def patch_slots(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Dirty-slot patch: a NEW column ((n,) or (n, 4)) equal to dst with
    rows idx set to vals. A negative index counts from the end; one
    still outside [0, n) is dropped (XLA's scatter). The stager pads idx
    by REPEATING a real index with its own value, so repeats carry equal
    values; with unequal values which one lands is not specified."""
    if dst.device.type == "cuda":
        return kernels.live_patch(dst, idx, vals)
    return _patch_plain(dst, idx, vals)


def _patch_plain(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    n = dst.shape[0]
    r = idx.long()
    r = torch.where(r < 0, r + n, r)
    keep = (r >= 0) & (r < n)
    return dst.index_put((r[keep],), vals[keep])


# ------------------------------------------------------------- stager


class LiveStager:
    """Per-tenant live-head staging state on one device. All mutation
    happens under self.lock (refresh/retire/compact); queries run
    lock-free against the immutable LiveSnapshot a refresh returns."""

    # rebuild the tails once dead slots or dead rows dominate
    COMPACT_DEAD_FRACTION = 0.5

    def __init__(self, dictionary: LiveDict | None = None, features_fn=None, device=None):
        self.device = resolve_device(device)
        # the RLock keeps refresh->retire recursion legal
        self.lock = threading.RLock()
        self.dict = dictionary or LiveDict()
        # seg -> SegFeatures source: the instance's ColumnarIngest cache
        # when wired (decode once per segment across consumers), else a
        # direct compute against this stager's own dictionary
        self._features = features_fn or (lambda seg: compute_features(seg, self.dict))
        self.tails: dict[bytes, _TraceTail] = {}
        self.generation = 0
        # slot columns (numpy, capacity-grown; n_slots is the high-water)
        self.n_slots = 0
        self.dead_slots = 0
        self._slot_cap = 0
        self.start_s = np.empty(0, np.int32)
        self.end_s = np.empty(0, np.int32)
        self.dur_ms = np.empty(0, np.int32)
        self.key_s = np.empty(0, np.int32)
        self.alive = np.empty(0, np.int32)
        self.id_codes = np.empty((0, 4), np.int32)
        # append-only row tails
        self.n_kv = 0
        self.dead_kv = 0
        self.kv_owner = np.empty(0, np.int32)
        self.kv_code = np.empty(0, np.int32)
        self.n_name = 0
        self.dead_name = 0
        self.name_owner = np.empty(0, np.int32)
        self.name_code = np.empty(0, np.int32)
        # device generation (tensors + the row counts they cover)
        self._dev: dict | None = None
        self._dev_rows: tuple[int, int, int] | None = None  # slots, kv, name
        self._dirty_slots: set[int] = set()  # slots changed since last upload
        self._snap: LiveSnapshot | None = None
        # what the refreshes moved: uploads by kind, bytes and rows sent,
        # host seconds in the delta encode and in the upload
        self.stats = {"full_uploads": 0, "delta_uploads": 0, "bytes": 0, "rows": 0,
                      "encode_s": 0.0, "upload_s": 0.0}
        self.last_upload: dict | None = None

    # ------------------------------------------------------ host tails
    def _grow_slots_locked(self, need: int) -> None:
        if need <= self._slot_cap:
            return
        cap = max(64, self._slot_cap * 2, need)
        for name in ("start_s", "end_s", "dur_ms", "key_s", "alive"):
            old = getattr(self, name)
            new = np.zeros(cap, np.int32)
            new[: old.shape[0]] = old
            setattr(self, name, new)
        old = self.id_codes
        new = np.zeros((cap, 4), np.int32)
        new[: old.shape[0]] = old
        self.id_codes = new
        self._slot_cap = cap

    @staticmethod
    def _append_rows(arr: np.ndarray, n: int, vals: list) -> np.ndarray:
        """Append vals at arr[n:]; grows by reallocation (old arrays --
        and any snapshot views into them -- stay intact)."""
        need = n + len(vals)
        if need > arr.shape[0]:
            cap = max(256, arr.shape[0] * 2, need)
            new = np.full(cap, PAD_I32, np.int32)
            new[: arr.shape[0]] = arr
            arr = new
        arr[n:need] = vals
        return arr

    def _alloc_slot_locked(self, tid: bytes) -> _TraceTail:
        slot = self.n_slots
        self._grow_slots_locked(slot + 1)
        self.n_slots += 1
        self.alive[slot] = 1
        self.id_codes[slot] = np.asarray(
            S.trace_id_to_codes(tid.rjust(16, b"\x00")), dtype=np.int32)
        tail = _TraceTail(slot=slot)
        self.tails[tid] = tail
        self._dirty_slots.add(slot)
        return tail

    def _retire_locked(self, tid: bytes, tail: _TraceTail) -> None:
        self.alive[tail.slot] = 0
        self._dirty_slots.add(tail.slot)
        self.dead_slots += 1
        self.dead_kv += len(tail.kv_codes)
        self.dead_name += len(tail.name_codes)
        del self.tails[tid]

    def _stage_trace_locked(self, tid: bytes, segs: list,
                            start_s: int, end_s: int, state: str) -> bool:
        """Bring one trace's tail up to `segs`; returns True when slot
        or row state changed. Segment identity is the staleness check:
        the lifecycle keeps a trace's merged segment list prefix-stable
        (cut extends, flush snapshots, failed flushes restore in order),
        and any violation simply restages the trace on a fresh slot."""
        tail = self.tails.get(tid)
        if tail is not None:
            ns = len(tail.staged_segs)
            if any(a is not b for a, b in zip(tail.staged_segs, segs)):
                # reordered merge (or reborn id): the old rows are
                # garbage now -- kill the slot, restage whole
                self._retire_locked(tid, tail)
                tail = None
            elif len(segs) < ns:
                # a strict prefix of what is already staged: a stale
                # snapshot racing a newer refresh -- staged state is
                # newer, no-op
                return False
        if tail is None:
            tail = self._alloc_slot_locked(tid)
        dirty = False
        for seg in segs[len(tail.staged_segs):]:
            feat = self._features(seg)
            lo, hi = feat.lo_ns, feat.hi_ns
            kv_add = [c for c in feat.kv_codes if c not in tail.kv_seen]
            tail.kv_seen.update(kv_add)
            nm_add = [c for c in feat.name_codes if c not in tail.name_seen]
            tail.name_seen.update(nm_add)
            if kv_add:
                self.kv_owner = self._append_rows(
                    self.kv_owner, self.n_kv, [tail.slot] * len(kv_add))
                self.kv_code = self._append_rows(self.kv_code, self.n_kv, kv_add)
                self.n_kv += len(kv_add)
                tail.kv_codes.extend(kv_add)
            if nm_add:
                self.name_owner = self._append_rows(
                    self.name_owner, self.n_name, [tail.slot] * len(nm_add))
                self.name_code = self._append_rows(self.name_code, self.n_name, nm_add)
                self.n_name += len(nm_add)
                tail.name_codes.extend(nm_add)
            if lo is not None and (tail.min_start_ns is None or lo < tail.min_start_ns):
                tail.min_start_ns = lo
            if hi is not None and (tail.max_end_ns is None or hi > tail.max_end_ns):
                tail.max_end_ns = hi
            tail.staged_segs.append(seg)
            dirty = True
        slot = tail.slot
        lo_ns = tail.min_start_ns or 0
        hi_ns = tail.max_end_ns or 0
        dur = _clip_i32(max(0, (hi_ns - lo_ns) // 1_000_000))
        key = _clip_i32(lo_ns // 1_000_000_000 - GKEY_ORIGIN_S) if lo_ns else _I32_MIN + 1
        vals = (int(np.int32(_clip_i32(start_s))), int(np.int32(_clip_i32(end_s))),
                dur, key)
        cur = (int(self.start_s[slot]), int(self.end_s[slot]),
               int(self.dur_ms[slot]), int(self.key_s[slot]))
        if dirty or cur != vals or tail.state != state:
            if cur != vals or dirty:
                self._dirty_slots.add(slot)
            self.start_s[slot], self.end_s[slot] = vals[0], vals[1]
            self.dur_ms[slot], self.key_s[slot] = vals[2], vals[3]
            tail.state = state
            dirty = True
        return dirty

    def _compact_locked(self) -> None:
        """Rebuild slots + row tails from the live per-trace fragments:
        dead slots and their rows vanish, fragments re-own fresh
        contiguous slots. Rebuilt arrays are NEW objects, so earlier
        snapshots keep their old views."""
        tails = sorted(self.tails.items(), key=lambda kv: kv[1].slot)
        n = len(tails)
        cap = max(64, n)
        start_s = np.zeros(cap, np.int32)
        end_s = np.zeros(cap, np.int32)
        dur_ms = np.zeros(cap, np.int32)
        key_s = np.zeros(cap, np.int32)
        alive = np.zeros(cap, np.int32)
        id_codes = np.zeros((cap, 4), np.int32)
        kv_owner: list[int] = []
        kv_code: list[int] = []
        nm_owner: list[int] = []
        nm_code: list[int] = []
        for new_slot, (tid, tail) in enumerate(tails):
            old = tail.slot
            start_s[new_slot] = self.start_s[old]
            end_s[new_slot] = self.end_s[old]
            dur_ms[new_slot] = self.dur_ms[old]
            key_s[new_slot] = self.key_s[old]
            alive[new_slot] = 1
            id_codes[new_slot] = self.id_codes[old]
            kv_owner.extend([new_slot] * len(tail.kv_codes))
            kv_code.extend(tail.kv_codes)
            nm_owner.extend([new_slot] * len(tail.name_codes))
            nm_code.extend(tail.name_codes)
            tail.slot = new_slot
        self.start_s, self.end_s = start_s, end_s
        self.dur_ms, self.key_s, self.alive = dur_ms, key_s, alive
        self.id_codes = id_codes
        self._slot_cap = cap
        self.n_slots, self.dead_slots = n, 0
        self.kv_owner = np.asarray(kv_owner or [], dtype=np.int32)
        self.kv_code = np.asarray(kv_code or [], dtype=np.int32)
        self.n_kv, self.dead_kv = len(kv_code), 0
        self.name_owner = np.asarray(nm_owner or [], dtype=np.int32)
        self.name_code = np.asarray(nm_code or [], dtype=np.int32)
        self.n_name, self.dead_name = len(nm_code), 0
        self._dev = None  # buckets/ownership changed: next upload is full
        self._dev_rows = None

    # ---------------------------------------------------------- refresh
    def refresh(self, items: dict) -> LiveSnapshot:
        """Reconcile the tails against `items` ({tid: (segments, state,
        start_s, end_s)} -- the caller's consistent instance-lock
        snapshot, segments merged flushing+cut+live per tid) and return
        the new generation's snapshot."""
        with self.lock:
            t_delta = time.perf_counter()
            dirty = False
            for tid in [t for t in self.tails if t not in items]:
                self._retire_locked(tid, self.tails[tid])
                dirty = True
            for tid, (segs, state, start_s, end_s) in items.items():
                dirty |= self._stage_trace_locked(tid, segs, start_s, end_s, state)
            total_rows = self.n_kv + self.n_name
            dead_rows = self.dead_kv + self.dead_name
            if self.n_slots and (
                self.dead_slots > self.COMPACT_DEAD_FRACTION * self.n_slots
                or (total_rows and dead_rows > self.COMPACT_DEAD_FRACTION * total_rows)
            ):
                self._compact_locked()
                dirty = True
            self.stats["encode_s"] += time.perf_counter() - t_delta
            snap = self._snap
            if not dirty and snap is not None:
                return snap  # same generation still describes the tails
            dev = self._upload_locked()
            self.generation += 1
            n = self.n_slots
            snap = LiveSnapshot(
                generation=self.generation,
                n_slots=n, n_kv=self.n_kv, n_name=self.n_name,
                slot_b=bucket(max(n, 1)),
                kv_b=bucket(max(self.n_kv, 1)),
                name_b=bucket(max(self.n_name, 1)),
                start_s=self.start_s[:n].copy(),
                end_s=self.end_s[:n].copy(),
                dur_ms=self.dur_ms[:n].copy(),
                key_s=self.key_s[:n].copy(),
                alive=self.alive[:n].copy(),
                id_codes=self.id_codes[:n].copy(),
                kv_owner=self.kv_owner[: self.n_kv],
                kv_code=self.kv_code[: self.n_kv],
                name_owner=self.name_owner[: self.n_name],
                name_code=self.name_code[: self.n_name],
                dev=dev,
                slot_tid={tail.slot: tid for tid, tail in self.tails.items()},
            )
            self._snap = snap
            return snap

    def _upload_locked(self) -> dict:
        """Bring the device columns up to the host tails. When the
        buckets are unchanged, dirty slots patch in (B7d) and new rows
        append (B7c) into new tensors; otherwise every column uploads
        whole. Returns the device column dict."""
        t_up = time.perf_counter()
        dev_t = self.device
        n = self.n_slots
        slot_b = bucket(max(n, 1))
        kv_b = bucket(max(self.n_kv, 1))
        name_b = bucket(max(self.n_name, 1))
        dev = dict(self._dev) if self._dev is not None else None
        prev = self._dev_rows
        full = (
            dev is None or prev is None
            or dev["start_s"].shape[0] != slot_b
            or dev["kv_owner"].shape[0] != kv_b
            or dev["name_owner"].shape[0] != name_b
        )
        sent = 0
        rows_sent = 0
        if full:
            host = _padded_host_cols(
                self.start_s[:n], self.end_s[:n], self.dur_ms[:n], self.key_s[:n],
                self.alive[:n], self.id_codes[:n], self.kv_owner[: self.n_kv],
                self.kv_code[: self.n_kv], self.name_owner[: self.n_name],
                self.name_code[: self.n_name], slot_b, kv_b, name_b)
            dev = {k: _upload(v, dev_t) for k, v in host.items()}
            sent = sum(int(a.nbytes) for a in host.values())
            rows_sent = n + self.n_kv + self.n_name
        else:
            # slot columns: scatter-patch only the DIRTY slots (idx
            # lanes pad by repeating a real index -- idempotent), so a
            # 2-trace push moves tens of bytes, not the padded columns
            dirty = sorted(s for s in self._dirty_slots if s < slot_b)
            if dirty:
                db_ = _delta_bucket(len(dirty), 16)
                idx = np.asarray(dirty + [dirty[0]] * (db_ - len(dirty)), dtype=np.int32)
                idx_t = _upload(idx, dev_t)
                for name_ in _SLOT_COLS:
                    src = getattr(self, name_)[idx]
                    dev[name_] = patch_slots(dev[name_], idx_t, _upload(src, dev_t))
                    sent += int(src.nbytes)
                sent += int(idx.nbytes)
                rows_sent += len(dirty)
            for owner_name, code_name, n_new, n_old in (
                ("kv_owner", "kv_code", self.n_kv, prev[1]),
                ("name_owner", "name_code", self.n_name, prev[2]),
            ):
                if n_new == n_old:
                    continue
                delta = n_new - n_old
                db = _delta_bucket(delta)
                bkt = dev[owner_name].shape[0]
                owner_src = getattr(self, owner_name)[n_old:n_new]
                code_src = getattr(self, code_name)[n_old:n_new]
                if n_old + db <= bkt:
                    owner_p = pad_rows(owner_src, db, np.int32(0))
                    code_p = pad_rows(code_src, db, PAD_I32)
                    dev[owner_name] = append_rows(dev[owner_name], _upload(owner_p, dev_t), n_old)
                    dev[code_name] = append_rows(dev[code_name], _upload(code_p, dev_t), n_old)
                else:  # padded delta would clip: full column re-upload
                    owner_p = pad_rows(getattr(self, owner_name)[:n_new], bkt, np.int32(0))
                    code_p = pad_rows(getattr(self, code_name)[:n_new], bkt, PAD_I32)
                    dev[owner_name], dev[code_name] = _upload(owner_p, dev_t), _upload(code_p, dev_t)
                sent += int(owner_p.nbytes + code_p.nbytes)
                rows_sent += delta
        self._dev = dev
        self._dev_rows = (n, self.n_kv, self.n_name)
        self._dirty_slots.clear()
        if sent:
            self.stats["full_uploads" if full else "delta_uploads"] += 1
            self.stats["bytes"] += sent
            self.stats["rows"] += rows_sent
            self.last_upload = {"full": full, "rows": rows_sent, "bytes": sent}
        self.stats["upload_s"] += time.perf_counter() - t_up
        return dev
