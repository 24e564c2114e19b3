"""The codec matrix's snappy and lz4 in the port (block/blockcodecs.py,
block/colio.py) against the JAX package's: the pure-Python compressors
emit the reference's Python fallback byte for byte, the decompressors
read the reference's native (hash-matched) output, packs and whole
blocks written by either package open in the other, and compaction of a
snappy store gives the reference's outputs."""

import dataclasses

import numpy as np
import pytest
from test_torch_write_cases import TENANT, _compact_both, _dbs, assert_same_output

import tempo_tpu.native as r_native
from tempo_tpu.block import blockcodecs as RC
from tempo_tpu.block import colio as rcolio
from tempo_tpu.block import open_block as r_open
from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.block import blockcodecs as PC
from tempo_tpu_torch.block import colio
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.util.testdata import make_traces

CODECS = ("snappy", "lz4")
_COMPRESS = {"snappy": (PC.snappy_compress, RC.snappy_compress),
             "lz4": (PC.lz4_compress, RC.lz4_compress)}
_DECOMPRESS = {"snappy": PC.snappy_decompress, "lz4": PC.lz4_decompress}


def _inputs() -> dict[str, bytes]:
    rng = np.random.default_rng(5)
    runs = np.repeat(rng.integers(0, 4, 40, dtype=np.uint8), rng.integers(1, 400, 40))
    sparse = np.zeros(70_000, np.int32)
    sparse[rng.integers(0, sparse.size, 300)] = rng.integers(1, 9, 300)
    return {
        "runs": runs.tobytes(),
        "entropy": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "sparse_i32": sparse.tobytes(),
        "tiny": b"abc",
        "run_at_end": b"xyz" + b"\x00" * 40,
        "empty": b"",
    }


INPUTS = _inputs()


@pytest.fixture
def python_reference(monkeypatch):
    """The reference's compressors with its native library out of the way:
    its pure-Python halves (the reference file itself is untouched)."""
    monkeypatch.setattr(r_native, "block_compress_chunks", lambda *a, **k: None)
    monkeypatch.setattr(r_native, "block_decompress_chunks", lambda *a, **k: None)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", list(INPUTS))
def test_compress_equals_reference_python(codec, name, python_reference):
    data = INPUTS[name]
    ours, theirs = _COMPRESS[codec]
    got = ours(data)
    assert got == theirs(data)
    assert _DECOMPRESS[codec](got, len(data)) == data


@pytest.mark.parametrize("codec", CODECS)
def test_decodes_reference_native_output(codec):
    """The native compressor's hash-matched output (not only runs)."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 50, 4000, dtype=np.int32)  # repeated 4-byte patterns
    for data in [*INPUTS.values(), words.tobytes(), bytes(range(256)) * 40]:
        native = r_native.block_compress_chunks(codec, [data])
        assert native is not None, "the reference's native library did not load"
        assert _DECOMPRESS[codec](native[0], len(data)) == data


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", [32, 64, 256, 100_000])
def test_reference_pack_reads_in_port(codec, n):
    """ROADMAP §C: a reference pack of an alternating int32 column (32
    entries is the 128-byte compression floor) raised KeyError here."""
    col = (np.arange(n) % 2).astype(np.int32)
    data = rcolio.pack_columns({"span.x": col}, codec=codec)
    np.testing.assert_array_equal(colio.ColumnPack.from_bytes(data).read("span.x"), col)
    back = b"".join(colio.pack_columns_stream({"span.x": col}, codec=codec))
    np.testing.assert_array_equal(rcolio.ColumnPack.from_bytes(back).read("span.x"), col)


def _asdict(x):
    return None if x is None else dataclasses.asdict(x)


@pytest.mark.parametrize("codec", CODECS)
def test_reference_block_serves_port_finds_and_searches(codec, tmp_path):
    path = str(tmp_path / "store")
    traces = r_make_traces(60, seed=21, n_spans=6)
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path}, block_codec=codec,
                           wal_path=str(tmp_path / "wal"), batch_enabled=False))
    meta = ref.write_block(TENANT, traces)
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": path}, block_codec=codec,
                                 batch_enabled=False), device="cpu")
    port.poll_now()
    pblk = port.open_block(port.metas(TENANT)[0])
    assert codec in pblk.pack.chunk_codecs()
    for tid, _ in traces[::7] + [(b"\x42" * 16, None)]:
        assert _asdict(port.find_trace_by_id(TENANT, tid)) == \
            _asdict(ref.find_trace_by_id(TENANT, tid))
    for q in ('{ name = "db.query" }', '{ duration > 10ms }', '{ status = error }'):
        got = port.search(TENANT, SearchRequest(query=q, limit=100))
        want = ref.search(TENANT, RRequest(query=q, limit=100))
        assert [dataclasses.asdict(t) for t in got.traces] == \
            [dataclasses.asdict(t) for t in want.traces], q
    assert meta.block_id == pblk.meta.block_id
    ref.close()


@pytest.mark.parametrize("codec", CODECS)
def test_port_block_opens_in_reference(codec, tmp_path):
    path = str(tmp_path / "store")
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": path}, block_codec=codec),
                   device="cpu")
    pmeta = port.write_block(TENANT, make_traces(50, seed=23, n_spans=5))
    pblk = port.open_block(pmeta)
    assert codec in pblk.pack.chunk_codecs()
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": path},
                           wal_path=str(tmp_path / "wal")))
    rblk = r_open(ref.backend, TENANT, pmeta.block_id)
    assert rblk.pack.names() == pblk.pack.names()
    for name in rblk.pack.names():
        np.testing.assert_array_equal(pblk.pack.read(name), rblk.pack.read(name), err_msg=name)
    ref.close()


@pytest.mark.parametrize("codec", CODECS)
def test_compaction_of_codec_store_matches_reference(codec, tmp_path):
    ref, port = _dbs(tmp_path, "collision", codec=codec)
    rres, pres = _compact_both(ref, port)
    for r, p in zip(rres, pres):
        for rm, pm in zip(r.new_blocks, p.new_blocks):
            assert_same_output(port.backend, pm, ref.backend, rm)
    ref.close()
