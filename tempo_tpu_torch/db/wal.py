"""Write-ahead log: append blocks + replay, row-based v1 and columnar v2
(port of tempo_tpu/db/wal.py; the files are the same bytes, so either
package replays the other's).

The WAL is the ingester's checkpoint: every accepted push is appended
and flushed to the OS before it is acknowledged (survives a process
crash); fsync to stable media runs on a BOUNDED interval
(fsync_interval_s, default 0.25 s, 0 = every flush), so a HOST crash can
lose pushes acked inside that window. On restart, rescan_blocks replays
the files back into the live head. The WAL stays row-oriented for
append speed while complete blocks are columnar.

File name: <block uuid>+<tenant>+<version>

v1 ("w1", legacy, still readable for migration):
  Record: uvarint total_len | trace_id(16) | uint32le start_s |
          uint32le end_s | segment bytes
v2 ("w2", columnar, the default write format -- ingest/walcodec.py):
  Record: uvarint total_len | uint32le crc32 | windowed segments or
          feature checkpoints; one push window = ONE record, and
          replay re-enters the live-search stage buckets without proto
          re-decode when feature records cover the segments.

A torn final record (crash mid-append) is detected by length and
truncated away during replay; a v2 CRC mismatch truncates from the
corrupt record on. The frame scan is pure Python.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass, field

from ..ingest import walcodec
from ..wire import pbwire as w

WAL_VERSION = "w1"
WAL2_VERSION = walcodec.WAL2_VERSION
DEFAULT_WAL_VERSION = WAL2_VERSION
_REC_HDR = struct.Struct("<II")


@dataclass
class WALRecord:
    trace_id: bytes
    start_s: int
    end_s: int
    segment: bytes


class _AppendFile:
    """Shared append-file mechanics for both WAL block versions. Not
    thread-safe; callers serialize per instance.

    Durability contract: flush() hands bytes to the OS (survives a
    process crash); fsync runs at most every fsync_interval_s, plus
    always on close/cut (flush(sync=True))."""

    VERSION = WAL_VERSION

    def __init__(self, dirpath: str, tenant: str, block_id: str | None = None,
                 fsync_interval_s: float = 0.25):
        self.block_id = block_id or str(uuid.uuid4())
        self.tenant = tenant
        self.path = os.path.join(dirpath, f"{self.block_id}+{tenant}+{self.VERSION}")
        self._f = open(self.path, "ab")
        self._unflushed = 0
        self._unsynced = False  # bytes handed to the OS but not fsynced
        self._fsync_interval_s = fsync_interval_s
        self._last_fsync = 0.0

    def _write_frame(self, rec: bytes) -> None:
        self._f.write(rec)
        self._unflushed += 1

    def flush(self, sync: bool = False) -> None:
        if self._unflushed:
            self._f.flush()
            self._unsynced = True
            self._unflushed = 0
        if self._unsynced:
            now = time.monotonic()
            if sync or now - self._last_fsync >= self._fsync_interval_s:
                os.fsync(self._f.fileno())
                self._last_fsync = now
                self._unsynced = False

    def size_bytes(self) -> int:
        self._f.flush()
        return os.path.getsize(self.path)

    def close(self) -> None:
        self.flush(sync=True)
        self._f.close()

    def clear(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _scan_frames(data: bytes) -> tuple[list[tuple[int, int]], bool, int]:
    """Varint frame scan: -> ([(body_off, body_len)], clean, torn_at).
    torn_at is the truncation offset when not clean."""
    out: list[tuple[int, int]] = []
    pos = 0
    clean = True
    torn_at = len(data)
    n = len(data)
    while pos < n:
        start_pos = pos
        try:
            ln, pos = w.read_varint(data, pos)
        except ValueError:
            clean, torn_at = False, start_pos
            break
        if pos + ln > n:
            clean, torn_at = False, start_pos
            break
        out.append((pos, ln))
        pos += ln
    return out, clean, torn_at


def _truncate(path: str, at: int) -> None:
    """Drop a torn or corrupt tail so future appends produce a valid file."""
    with open(path, "ab") as f:
        f.truncate(at)


class WALBlock(_AppendFile):
    """Row-based v1 append file: one record per segment (legacy write
    format, kept for migration -- IngesterConfig.wal_version selects)."""

    VERSION = WAL_VERSION

    def append(self, trace_id: bytes, start_s: int, end_s: int, segment: bytes) -> None:
        tid = trace_id.rjust(16, b"\x00")
        body = tid + _REC_HDR.pack(start_s & 0xFFFFFFFF, end_s & 0xFFFFFFFF) + segment
        hdr = bytearray()
        w.write_varint(hdr, len(body))
        self._write_frame(bytes(hdr) + body)

    # ---- replay
    @staticmethod
    def read_records(path: str) -> tuple[list[WALRecord], bool]:
        """-> (records, clean). clean=False if a torn tail was dropped."""
        with open(path, "rb") as f:
            data = f.read()
        frames, clean, torn_at = _scan_frames(data)
        out: list[WALRecord] = []
        for i, (off, ln) in enumerate(frames):
            if ln < 16 + _REC_HDR.size:
                # framed but impossibly small: torn at this frame's
                # header, right after the previous frame's body
                clean = False
                torn_at = frames[i - 1][0] + frames[i - 1][1] if i > 0 else 0
                break
            s, e = _REC_HDR.unpack_from(data, off + 16)
            out.append(WALRecord(data[off : off + 16], s, e,
                                 data[off + 16 + _REC_HDR.size : off + ln]))
        if not clean:
            _truncate(path, torn_at)
        return out, clean


class WAL2Block(_AppendFile):
    """Columnar v2 append file: one record per push WINDOW (all traces
    of one distributor push, single CRC-guarded frame + single file
    write on the ack path) plus lazy FEATURE records checkpointing
    already-decoded segment features so replay re-enters the stage
    buckets without proto re-decode (ingest/walcodec.py)."""

    VERSION = WAL2_VERSION

    def __init__(self, dirpath: str, tenant: str, block_id: str | None = None,
                 fsync_interval_s: float = 0.25):
        super().__init__(dirpath, tenant, block_id, fsync_interval_s)
        self._windows = 0
        # segments appended but not yet feature-checkpointed:
        # (window_idx, trace_idx, segment ref)
        self._pending_feat: list[tuple[int, int, bytes]] = []
        # live dict code -> file-local code (file codes are assigned in
        # first-reference order; their strings ship as dict deltas)
        self._file_code: dict[int, int] = {}

    def append_window(self, batch: list[tuple[bytes, int, int, bytes]]) -> None:
        """batch: [(trace_id, start_s, end_s, segment)] -- one record."""
        self._write_frame(walcodec.encode_window(batch))
        for i, (_, _, _, seg) in enumerate(batch):
            self._pending_feat.append((self._windows, i, seg))
        self._windows += 1

    def append(self, trace_id: bytes, start_s: int, end_s: int, segment: bytes) -> None:
        """Single-segment window: keeps version-agnostic callers working."""
        self.append_window([(trace_id, start_s, end_s, segment)])

    def flush_features(self, features_of, ldict) -> int:
        """Checkpoint features for every pending segment whose features
        are ALREADY decoded (features_of returns None to skip -- the
        checkpoint must never add decode work to the write path).
        ldict maps live codes back to strings for the file-local dict
        delta. Returns the number of entries written."""
        entries = []
        delta: list[str] = []
        still: list[tuple[int, int, bytes]] = []
        for w_idx, t_idx, seg in self._pending_feat:
            feat = features_of(seg)
            if feat is None:
                still.append((w_idx, t_idx, seg))
                continue
            kv = [self._file_code_of(c, ldict, delta) for c in feat.kv_codes]
            nm = [self._file_code_of(c, ldict, delta) for c in feat.name_codes]
            entries.append((w_idx, t_idx, kv, nm, feat.lo_ns, feat.hi_ns))
        self._pending_feat = still
        if not entries:
            return 0
        self._write_frame(walcodec.encode_features(delta, entries))
        return len(entries)

    def _file_code_of(self, live_code: int, ldict, delta: list[str]) -> int:
        fc = self._file_code.get(live_code)
        if fc is None:
            fc = self._file_code[live_code] = len(self._file_code)
            delta.append(ldict.string(live_code))
        return fc

    # ---- replay
    @staticmethod
    def read_records(path: str) -> tuple[list[WALRecord], bool,
                                         dict[int, tuple], list[str]]:
        """-> (records, clean, features, dict_delta). features maps a
        record's INDEX in `records` to (kv_strings, name_strings, lo_ns,
        hi_ns); dict_delta is the file's dictionary strings in file-code
        order (replay seeds them first so live codes reproduce). A CRC
        mismatch or malformed record truncates the file there, exactly
        like a torn tail."""
        with open(path, "rb") as f:
            data = f.read()
        spans, clean, torn_at = _scan_frames(data)
        records: list[WALRecord] = []
        features: dict[int, tuple] = {}
        strings: list[str] = []
        windows: list[list[int]] = []
        prev_end = 0
        for off, ln in spans:
            parsed = walcodec.decode_record(data, off, ln)
            if parsed is None:
                # CRC reject / malformed / truncated-to-tiny frame: the
                # stream past this point is untrusted
                clean, torn_at = False, prev_end
                break
            rtype, body = parsed
            if rtype == walcodec.REC_WINDOW:
                idxs = []
                for tid, s, e, seg in body:
                    idxs.append(len(records))
                    records.append(WALRecord(tid, s, e, seg))
                windows.append(idxs)
            else:  # REC_FEATURES
                delta, entries = body
                strings.extend(delta)
                bad = False
                for w_idx, t_idx, kv, nm, lo, hi in entries:
                    if (w_idx >= len(windows) or t_idx >= len(windows[w_idx])
                            or any(c >= len(strings) for c in kv)
                            or any(c >= len(strings) for c in nm)):
                        bad = True
                        break
                    features[windows[w_idx][t_idx]] = (
                        tuple(strings[c] for c in kv),
                        tuple(strings[c] for c in nm), lo, hi)
                if bad:
                    clean, torn_at = False, prev_end
                    break
            prev_end = off + ln
        if not clean:
            _truncate(path, torn_at)
        return records, clean, features, strings


@dataclass
class ReplayedBlock:
    block_id: str
    tenant: str
    path: str
    records: list[WALRecord] = field(default_factory=list)
    clean: bool = True
    version: str = WAL_VERSION
    # v2 only: record index -> (kv_strings, name_strings, lo_ns, hi_ns)
    features: dict = field(default_factory=dict)
    dict_delta: list = field(default_factory=list)


class WAL:
    """Directory manager + block factory + replay scan
    (reference: tempodb/wal/wal.go:39-142)."""

    def __init__(self, dirpath: str, fsync_interval_s: float = 0.25):
        self.dir = dirpath
        self.fsync_interval_s = fsync_interval_s
        os.makedirs(dirpath, exist_ok=True)

    def new_block(self, tenant: str, version: str | None = None):
        cls = WALBlock if (version or DEFAULT_WAL_VERSION) == WAL_VERSION else WAL2Block
        return cls(self.dir, tenant, fsync_interval_s=self.fsync_interval_s)

    def rescan_blocks(self) -> list[ReplayedBlock]:
        out: list[ReplayedBlock] = []
        for name in sorted(os.listdir(self.dir)):
            parts = name.split("+")
            if len(parts) != 3 or parts[2] not in (WAL_VERSION, WAL2_VERSION):
                continue  # unknown files are left alone
            path = os.path.join(self.dir, name)
            if parts[2] == WAL2_VERSION:
                records, clean, features, delta = WAL2Block.read_records(path)
                out.append(ReplayedBlock(parts[0], parts[1], path, records,
                                         clean, version=WAL2_VERSION,
                                         features=features, dict_delta=delta))
            else:
                records, clean = WALBlock.read_records(path)
                out.append(ReplayedBlock(parts[0], parts[1], path, records, clean))
        return out

    def delete_block_file(self, block_id: str, tenant: str) -> None:
        for version in (WAL_VERSION, WAL2_VERSION):
            try:
                os.unlink(os.path.join(self.dir, f"{block_id}+{tenant}+{version}"))
            except FileNotFoundError:
                pass
