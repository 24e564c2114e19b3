"""The port's WAL (db/wal, ingest/walcodec) against the JAX package's:
the w2 round trip, torn-tail and CRC truncation, a w1 file migrating
through replay, feature-checkpoint replay with no proto decode, and WAL
files crossing between the packages -- the same pushes write the same
bytes, and each package replays the other's files."""

import os
import random

import pytest

from tempo_tpu.backend import MemBackend as RMem
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.db.wal import WAL as RWAL
from tempo_tpu.db.wal import WAL2Block as RWAL2Block
from tempo_tpu.db.wal import WALBlock as RWALBlock
from tempo_tpu.services.ingester import Ingester as RIngester
from tempo_tpu.services.ingester import IngesterConfig as RIngesterConfig
from tempo_tpu.services.overrides import Overrides as ROverrides
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.db.wal import WAL, WAL2Block, WALBlock
from tempo_tpu_torch.ingest import columnar as columnar_mod
from tempo_tpu_torch.ingest.columnar import ColumnarIngest, LiveDict, compute_features
from tempo_tpu_torch.services.ingester import Ingester, IngesterConfig
from tempo_tpu_torch.services.overrides import Overrides
from tempo_tpu_torch.util.testdata import make_traces
from tempo_tpu_torch.wire import segment

TENANT = "t-ingest"


def _seg_batch(traces, start_s=1, end_s=2):
    return [(tid, start_s, end_s, segment.segment_for_write(t, start_s, end_s))
            for tid, t in traces]


def _mk_ing(tmp_path, name, wal_version=None):
    db = TempoDB(TempoDBConfig(block_codec="gzip"), backend=MemBackend(), device="cpu")
    cfg = IngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0)
    if wal_version is not None:
        cfg.wal_version = wal_version
    return db, Ingester(WAL(str(tmp_path / f"wal-{name}")), db, Overrides(), cfg, device="cpu")


def _mk_ref(tmp_path, name, wal_version=None):
    db = RTempoDB(RConfig(wal_path=str(tmp_path / f"rdbwal-{name}"), block_codec="gzip"),
                  backend=RMem())
    cfg = RIngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0)
    if wal_version is not None:
        cfg.wal_version = wal_version
    return db, RIngester(RWAL(str(tmp_path / f"rwal-{name}")), db, ROverrides(), cfg)


# --------------------------------------------------------------- codec


def test_wal2_roundtrip_windows_and_features(tmp_path):
    traces = make_traces(6, seed=21, n_spans=4)
    batch = _seg_batch(traces)
    col = ColumnarIngest()
    blk = WAL2Block(str(tmp_path), TENANT)
    blk.append_window(batch[:4])
    blk.append(*batch[4])  # single-entry window via the v1-shaped API
    blk.append_window(batch[5:])
    for *_, seg in batch:
        col.features_for(seg)
    assert blk.flush_features(col.cached, col.dict) == len(batch)
    blk.flush(sync=True)
    blk.close()

    for read in (WAL2Block.read_records, RWAL2Block.read_records):
        records, clean, features, delta = read(blk.path)
        assert clean
        assert [(r.trace_id, r.start_s, r.end_s, r.segment) for r in records] == [
            (tid.rjust(16, b"\x00"), s, e, seg) for tid, s, e, seg in batch]
        assert set(features) == set(range(len(batch)))
        fresh = LiveDict()
        for i, (_, _, _, seg) in enumerate(batch):
            want = compute_features(seg, fresh)
            kv, names, lo, hi = features[i]
            assert tuple(fresh.string(c) for c in want.kv_codes) == kv
            assert tuple(fresh.string(c) for c in want.name_codes) == names
            assert (lo, hi) == (want.lo_ns, want.hi_ns)
        assert len(delta) == len(set(delta))


@pytest.mark.parametrize("cut", [1, 7, 40])
def test_wal2_torn_tail_truncates_and_reappends(tmp_path, cut):
    traces = make_traces(5, seed=22, n_spans=3)
    batch = _seg_batch(traces)
    blk = WAL2Block(str(tmp_path), TENANT)
    blk.append_window(batch[:3])
    blk.append_window(batch[3:])
    blk.close()
    # crash mid-append: the second window's frame loses its tail
    with open(blk.path, "r+b") as f:
        f.truncate(os.path.getsize(blk.path) - cut)
    records, clean, features, _ = WAL2Block.read_records(blk.path)
    assert not clean and len(records) == 3 and not features
    # the torn bytes are gone from disk; appends resume cleanly
    blk2 = WAL2Block(str(tmp_path), TENANT, os.path.basename(blk.path).split("+")[0])
    blk2.append_window(batch[3:])
    blk2.close()
    records, clean, _, _ = WAL2Block.read_records(blk.path)
    assert clean and len(records) == 5


def test_wal2_crc_corruption_rejects_suffix(tmp_path):
    """A flipped byte in a record invalidates it AND the stream after it;
    the reference reads the same prefix."""
    traces = make_traces(6, seed=23, n_spans=3)
    batch = _seg_batch(traces)
    blk = WAL2Block(str(tmp_path), TENANT)
    blk.append_window(batch[:2])
    mid = blk.size_bytes()
    blk.append_window(batch[2:4])
    blk.append_window(batch[4:])
    blk.close()
    with open(blk.path, "r+b") as f:
        f.seek(mid + 12)
        b = f.read(1)
        f.seek(mid + 12)
        f.write(bytes([b[0] ^ 0x55]))
    with open(blk.path, "rb") as f:
        data = f.read()
    ref_path = str(tmp_path / "ref-copy")
    with open(ref_path, "wb") as f:
        f.write(data)
    records, clean, _, _ = WAL2Block.read_records(blk.path)
    rrecords, rclean, _, _ = RWAL2Block.read_records(ref_path)
    assert not clean and not rclean
    assert [r.segment for r in records] == [seg for *_, seg in batch[:2]]
    assert [r.segment for r in rrecords] == [r.segment for r in records]
    # the truncate-on-read made the prefix durable: a second scan is clean
    records2, clean2, _, _ = WAL2Block.read_records(blk.path)
    assert clean2 and len(records2) == 2
    assert os.path.getsize(blk.path) == os.path.getsize(ref_path) == mid


def test_wal1_torn_tail_matches_reference(tmp_path):
    traces = make_traces(4, seed=27, n_spans=3)
    blk = WALBlock(str(tmp_path), TENANT)
    for rec in _seg_batch(traces):
        blk.append(*rec)
    blk.close()
    with open(blk.path, "rb") as f:
        data = f.read()
    for cut in (3, len(data) // 2):
        paths = [str(tmp_path / f"p{cut}"), str(tmp_path / f"r{cut}")]
        for p in paths:
            with open(p, "wb") as f:
                f.write(data[:-cut])
        got, clean = WALBlock.read_records(paths[0])
        want, rclean = RWALBlock.read_records(paths[1])
        assert not clean and not rclean
        assert [(r.trace_id, r.segment) for r in got] == [(r.trace_id, r.segment) for r in want]
        assert os.path.getsize(paths[0]) == os.path.getsize(paths[1])


# ----------------------------------------------------------- migration


def test_legacy_w1_wal_migrates_through_replay(tmp_path):
    """An ingester that crashed on a v1 WAL replays into a v2 process:
    records recover, blocks flush, and the new heads are w2."""
    traces = make_traces(8, seed=24, n_spans=4)
    _, ing1 = _mk_ing(tmp_path, "old", wal_version="w1")
    ing1.push_segments(TENANT, _seg_batch(traces))
    inst = ing1.instance(TENANT)
    assert isinstance(inst.head, WALBlock) and not isinstance(inst.head, WAL2Block)
    wal_dir = ing1.wal.dir
    assert any(n.endswith("+w1") for n in os.listdir(wal_dir))

    db2, ing2 = _mk_ing(tmp_path, "new")
    ing2.wal = WAL(wal_dir)
    assert ing2.replay_wal() == len(traces)
    for tid, t in traces:
        got = db2.find_trace_by_id(TENANT, tid)
        assert got is not None and got.span_count() == t.span_count()
    assert not any(n_.endswith("+w1") for n_ in os.listdir(wal_dir))
    assert isinstance(ing2.instance(TENANT).head, WAL2Block)


def test_feature_checkpoint_replay_skips_proto_decode(tmp_path, monkeypatch):
    """Replay of a feature-checkpointed w2 WAL seeds the columnar cache
    without EVER re-running the feature decode."""
    traces = make_traces(10, seed=26, n_spans=3)
    _, ing1 = _mk_ing(tmp_path, "seed")
    ing1.push_segments(TENANT, _seg_batch(traces))
    inst1 = ing1.instance(TENANT)
    inst1.live_engine.maybe_refresh()  # decode features once, live
    assert inst1.flush_wal_features() == len(traces)
    wal_dir = ing1.wal.dir

    calls = {"n": 0}
    real = columnar_mod.compute_features

    def counting(seg, ldict):
        calls["n"] += 1
        return real(seg, ldict)

    monkeypatch.setattr(columnar_mod, "compute_features", counting)
    db2, ing2 = _mk_ing(tmp_path, "seed-replay")
    ing2.wal = WAL(wal_dir)
    assert ing2.replay_wal() == len(traces)
    inst2 = ing2.instance(TENANT)
    assert inst2.columnar.seeded == len(traces)
    assert inst2.columnar.decodes == 0 and calls["n"] == 0
    for tid, t in traces:
        got = db2.find_trace_by_id(TENANT, tid)
        assert got is not None and got.span_count() == t.span_count()


# ------------------------------------------------------- cross-package


def _windows(seed, n=30):
    """Randomized push windows with duplicate appends sprinkled in."""
    rng = random.Random(seed)
    entries = _seg_batch(make_traces(n, seed=seed, n_spans=4))
    pushes, i = [], 0
    while i < len(entries):
        k = rng.randint(1, 6)
        win = entries[i:i + k]
        if rng.random() < 0.3:
            win = win + [rng.choice(entries[: i + k])]
        pushes.append(win)
        i += k
    return pushes


def _wal_bytes(wal_dir) -> list[bytes]:
    (name,) = os.listdir(wal_dir)
    with open(os.path.join(wal_dir, name), "rb") as f:
        return name.split("+")[1:], f.read()


@pytest.mark.parametrize("version", ["w1", "w2"])
def test_same_pushes_write_byte_identical_wal_files(tmp_path, version):
    """The same pushes (and, on w2, the same feature checkpoint after a
    staging refresh) write the same file in both packages; only the
    block id in the file name differs."""
    pushes = _windows(31)
    _, ing = _mk_ing(tmp_path, "p", wal_version=version)
    _, ring = _mk_ref(tmp_path, "r", wal_version=version)
    for win in pushes:
        ing.push_segments(TENANT, win)
        ring.push_segments(TENANT, win)
    if version == "w2":
        ing.instance(TENANT).live_engine.maybe_refresh()
        ring.instance(TENANT).live_engine.maybe_refresh()
        n = ing.instance(TENANT).flush_wal_features()
        assert n > 0 and n == ring.instance(TENANT).flush_wal_features()
    assert _wal_bytes(ing.wal.dir) == _wal_bytes(ring.wal.dir)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_wal_files_replay_across_packages(tmp_path, direction):
    """A crash in one package, replay in the other: every record comes
    back, the features seed without a decode, and the flushed block holds
    every trace."""
    pushes = _windows(32)
    traces = {tid: seg for win in pushes for tid, _, _, seg in win}
    if direction == "reference_to_port":
        _, writer = _mk_ref(tmp_path, "w")
        reader_db, reader = _mk_ing(tmp_path, "r")
        reader.wal = WAL(writer.wal.dir)
    else:
        _, writer = _mk_ing(tmp_path, "w")
        reader_db, reader = _mk_ref(tmp_path, "r")
        reader.wal = RWAL(writer.wal.dir)
    for win in pushes:
        writer.push_segments(TENANT, win)
    writer.instance(TENANT).live_engine.maybe_refresh()
    assert writer.instance(TENANT).flush_wal_features() > 0
    assert reader.replay_wal() == sum(len(w) for w in pushes)
    inst = reader.instance(TENANT)
    assert inst.columnar.seeded == sum(len(w) for w in pushes)
    assert inst.columnar.decodes == 0 and inst.blocks_flushed == 1
    for tid in traces:
        got = reader_db.find_trace_by_id(TENANT, tid)
        assert got is not None and got.trace_id() == tid
    assert not os.listdir(writer.wal.dir) or all(
        os.path.getsize(os.path.join(writer.wal.dir, n)) == 0
        for n in os.listdir(writer.wal.dir))


def test_replay_into_fresh_ingesters_gives_equal_blocks(tmp_path):
    """The same WAL directory replayed by each package flushes equal
    blocks (gzip objects byte-identical; meta aside for its id)."""
    pushes = _windows(33)
    _, writer = _mk_ing(tmp_path, "w")
    for win in pushes:
        writer.push_segments(TENANT, win)
    writer.instance(TENANT).live_engine.maybe_refresh()
    writer.instance(TENANT).flush_wal_features()
    src = writer.wal.dir
    copies = []
    for name in ("a", "b"):
        dst = tmp_path / f"copy-{name}"
        os.makedirs(dst)
        for f in os.listdir(src):
            with open(os.path.join(src, f), "rb") as fi, open(dst / f, "wb") as fo:
                fo.write(fi.read())
        copies.append(str(dst))
    db, ing = _mk_ing(tmp_path, "pa")
    ing.wal = WAL(copies[0])
    rdb, ring = _mk_ref(tmp_path, "ra")
    ring.wal = RWAL(copies[1])
    assert ing.replay_wal() == ring.replay_wal() == sum(len(w) for w in pushes)
    (meta,), (rmeta,) = db.metas(TENANT), rdb.blocklist.metas(TENANT)
    for name in ("data.vtpu", "dict.vtpu", "bloom-0"):
        assert db.backend.read(TENANT, meta.block_id, name) == \
            rdb.backend.read(TENANT, rmeta.block_id, name), name
    rdb.close()
