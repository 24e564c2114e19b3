"""The block cut as a whole: the same traces through the JAX package's
TempoDB.write_block and the port's TempoDB(device="cpu").write_block
(the cut's B9a/B9b/B9c on their plain versions) give the same block --
every column, the dictionary, the bloom words, the row groups and the
meta except the block id -- and, under the gzip codec, byte-identical
data, dictionary and bloom objects."""

import json

import numpy as np
import pytest

from tempo_tpu.backend import MemBackend as RMem
from tempo_tpu.block import build_block_from_traces as r_build
from tempo_tpu.block import open_block as r_open
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.util.testdata import make_trace as r_make_trace
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import build_block_from_traces, open_block
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.util.testdata import make_trace, make_traces

TENANT = "t"
# (traces, spans a trace, row_group_spans): one trace; row groups of 256
# with a partial last one; many small groups; one group of the default size
CASES = {
    "one_trace": (1, 5, 256),
    "partial_groups": (120, 10, 256),
    "small_groups": (300, 12, 64),
    "default_groups": (200, 8, 1 << 16),
}


def _both(case, tmp_path, codec="gzip"):
    n, spans, rgs = CASES[case]
    ref = RTempoDB(RConfig(wal_path=str(tmp_path / "wal"), row_group_spans=rgs, block_codec=codec),
                   backend=RMem())
    port = TempoDB(TempoDBConfig(row_group_spans=rgs, block_codec=codec), backend=MemBackend(),
                   device="cpu")
    rmeta = ref.write_block(TENANT, r_make_traces(n, seed=n + spans, n_spans=spans))
    pmeta = port.write_block(TENANT, make_traces(n, seed=n + spans, n_spans=spans))
    ref.close()
    return ref, port, rmeta, pmeta


def _object_names(meta):
    return ["data.vtpu", "dict.vtpu"] + [f"bloom-{i}" for i in range(meta.bloom_shards)]


def _meta_doc(meta, drop=("block_id",)):
    d = json.loads(meta.to_json())
    for k in drop:
        d.pop(k)
    return d


def assert_same_block(port_backend, pmeta, ref_backend, rmeta, drop=("block_id",)):
    """Every column, the dictionary, the bloom words, the row groups and
    the meta (the `drop` fields aside) equal."""
    assert _meta_doc(pmeta, drop) == _meta_doc(rmeta, drop)
    pb = open_block(port_backend, pmeta.tenant_id, pmeta.block_id)
    rb = r_open(ref_backend, rmeta.tenant_id, rmeta.block_id)
    assert pb.pack.names() == rb.pack.names()
    for name in rb.pack.names():
        got, want = pb.pack.read(name), rb.pack.read(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pb.dictionary.strings == rb.dictionary.strings
    for i in range(rmeta.bloom_shards):
        np.testing.assert_array_equal(pb.bloom_shard(i), rb.bloom_shard(i))
    assert [vars(g) for g in pb.meta.row_groups] == [vars(g) for g in rb.meta.row_groups]


@pytest.mark.parametrize("case", list(CASES))
def test_write_block_matches_reference(case, tmp_path):
    ref, port, rmeta, pmeta = _both(case, tmp_path)
    assert pmeta.total_traces == CASES[case][0] and pmeta.row_groups
    assert_same_block(port.backend, pmeta, ref.backend, rmeta)
    assert port.metas(TENANT) == [pmeta]


@pytest.mark.parametrize("case", list(CASES))
def test_write_block_objects_byte_identical_under_gzip(case, tmp_path):
    ref, port, rmeta, pmeta = _both(case, tmp_path)
    for name in _object_names(rmeta):
        got = port.backend.read(TENANT, pmeta.block_id, name)
        want = ref.backend.read(TENANT, rmeta.block_id, name)
        assert got == want, name


@pytest.mark.parametrize("case", ["partial_groups", "small_groups"])
def test_write_block_zstd_columns_match_reference(case, tmp_path):
    """Under zstd the two packages' compressors may emit other bytes (and
    so another size_bytes); the decoded block is the same."""
    ref, port, rmeta, pmeta = _both(case, tmp_path, codec="zstd")
    assert_same_block(port.backend, pmeta, ref.backend, rmeta, drop=("block_id", "size_bytes"))


@pytest.mark.parametrize("estimated", [0, 5000])
def test_build_block_with_its_id_equals_reference_meta(estimated, tmp_path):
    """build_block_from_traces with a given block id: the whole meta is
    equal, and a builder sized for more traces sizes its bloom the same."""
    from tempo_tpu.block.builder import BlockBuilder as RBuilder
    from tempo_tpu.block.builder import write_block as r_write
    from tempo_tpu_torch.block.builder import BlockBuilder, write_block

    traces = make_traces(50, seed=3, n_spans=6)
    rtraces = r_make_traces(50, seed=3, n_spans=6)
    pb, rb = MemBackend(), RMem()
    if estimated:
        b = BlockBuilder(TENANT, "blk", 128, estimated_traces=estimated, device="cpu")
        r = RBuilder(TENANT, "blk", 128, estimated_traces=estimated)
        for (tid, t), (rtid, rt) in zip(sorted(traces, key=lambda p: p[0]),
                                        sorted(rtraces, key=lambda p: p[0])):
            b.add_trace(tid, t)
            r.add_trace(rtid, rt)
        pmeta, rmeta = write_block(pb, b.finalize(), codec="gzip"), r_write(rb, r.finalize(), codec="gzip")
    else:
        pmeta = build_block_from_traces(pb, TENANT, traces, block_id="blk", row_group_spans=128,
                                        codec="gzip", device="cpu")
        rmeta = r_build(rb, TENANT, rtraces, block_id="blk", row_group_spans=128, codec="gzip")
    assert pmeta.to_json() == rmeta.to_json()
    for name in _object_names(rmeta):
        assert pb.read(TENANT, "blk", name) == rb.read(TENANT, "blk", name), name


def test_write_block_with_a_one_span_trace(tmp_path):
    """A one-span trace among three-span ones (row groups of one partial
    group): the block equals the reference's and the trace reads back."""
    tid = b"\x42" * 16
    ref = RTempoDB(RConfig(wal_path=str(tmp_path / "wal"), block_codec="gzip"), backend=RMem())
    port = TempoDB(TempoDBConfig(block_codec="gzip"), backend=MemBackend(), device="cpu")
    rmeta = ref.write_block(TENANT, sorted(r_make_traces(6, seed=9, n_spans=3)
                                           + [(tid, r_make_trace(4, trace_id=tid, n_spans=1))],
                                           key=lambda p: p[0]))
    pmeta = port.write_block(TENANT, sorted(make_traces(6, seed=9, n_spans=3)
                                            + [(tid, make_trace(4, trace_id=tid, n_spans=1))],
                                            key=lambda p: p[0]))
    ref.close()
    assert_same_block(port.backend, pmeta, ref.backend, rmeta)
    got = port.find_trace_by_id(TENANT, tid)
    assert got is not None and got.span_count() == 1
