"""The port's block layer and TraceQL planner against the JAX package's.

Blocks are read and written both ways (the same vtpu2 format), the
port's synthesizer makes the bench's blocks, and TraceQL plans equal
tempo_tpu.traceql.plan's for the same dictionary. Exact equality
throughout."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from tempo_tpu.backend import MemBackend as RMemBackend
from tempo_tpu.block import build_block_from_traces as r_build
from tempo_tpu.block import open_block as r_open
from tempo_tpu.block.colio import ColumnPack as RColumnPack
from tempo_tpu.block.colio import pack_columns as r_pack_columns
from tempo_tpu.traceql import hosteval as r_hosteval
from tempo_tpu.traceql import parser as r_parser
from tempo_tpu.traceql import plan as r_plan
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import build_block_from_traces, open_block
from tempo_tpu_torch.block.colio import AxisChunks, ColumnPack, pack_columns_stream
from tempo_tpu_torch.traceql import hosteval, parser, plan
from tempo_tpu_torch.util import zstdshim
from tempo_tpu_torch.util.synth import synth_block

TENANT = "t"
TRACES = make_traces(120, seed=5, n_spans=10)


def _copy(src, dst):
    for (t, b, name), data in src._objects.items():
        dst.write(t, b, name, data)


def _assert_blocks_equal(a, b, same_id: bool = True, ids=None):
    """Two readers (any package) over equal block contents."""
    ma, mb = dataclasses.asdict(a.meta), dataclasses.asdict(b.meta)
    for m in (ma, mb):
        m.pop("size_bytes")
        if not same_id:
            m.pop("block_id")
    assert ma == mb
    assert sorted(a.pack.names()) == sorted(b.pack.names())
    assert a.pack.axes.keys() == b.pack.axes.keys()
    for ax in a.pack.axes:
        assert a.pack.axes[ax].offsets == b.pack.axes[ax].offsets
    for name in a.pack.names():
        np.testing.assert_array_equal(a.pack.read(name), b.pack.read(name), err_msg=name)
    assert a.dictionary.strings == b.dictionary.strings
    for tid in ids if ids is not None else [t for t, _ in TRACES[:10]]:
        assert a.bloom_test(tid) and b.bloom_test(tid)
    sids = list(range(a.meta.total_traces))
    for ta, tb in zip(a.materialize_traces(sids), b.materialize_traces(sids)):
        assert dataclasses.asdict(ta) == dataclasses.asdict(tb)


@pytest.mark.parametrize("codec", ["zstd", "gzip", "lzma", "raw"])
def test_port_written_block_reads_in_reference(codec):
    be = MemBackend()
    meta = build_block_from_traces(be, TENANT, TRACES, row_group_spans=256, codec=codec,
                                  device="cpu")
    rbe = RMemBackend()
    _copy(be, rbe)
    _assert_blocks_equal(open_block(be, TENANT, meta.block_id), r_open(rbe, TENANT, meta.block_id))


def test_reference_written_block_reads_in_port():
    rbe = RMemBackend()
    meta = r_build(rbe, TENANT, TRACES, row_group_spans=256)
    be = MemBackend()
    _copy(rbe, be)
    _assert_blocks_equal(r_open(rbe, TENANT, meta.block_id), open_block(be, TENANT, meta.block_id))


def test_builders_produce_equal_blocks():
    rbe, be = RMemBackend(), MemBackend()
    rm = r_build(rbe, TENANT, TRACES, row_group_spans=256)
    pm = build_block_from_traces(be, TENANT, TRACES, row_group_spans=256, device="cpu")
    rblk, pblk = r_open(rbe, TENANT, rm.block_id), open_block(be, TENANT, pm.block_id)
    _assert_blocks_equal(rblk, pblk, same_id=False)
    for i in range(rm.bloom_shards):
        assert rbe.read(TENANT, rm.block_id, f"bloom-{i}") == be.read(TENANT, pm.block_id, f"bloom-{i}")


def test_synth_block_matches_bench_synth():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench import synth_block as bench_synth

    rbe, be = RMemBackend(), MemBackend()
    rm, rids = bench_synth(rbe, TENANT, np.random.default_rng(7), 256, 8, n_res=64)
    pm, pids = synth_block(be, TENANT, np.random.default_rng(7), 256, 8, n_res=64, codec="gzip")
    np.testing.assert_array_equal(rids, pids)
    rblk, pblk = r_open(rbe, TENANT, rm.block_id), open_block(be, TENANT, pm.block_id)
    assert sorted(rblk.pack.names()) == sorted(pblk.pack.names())
    for name in rblk.pack.names():
        np.testing.assert_array_equal(rblk.pack.read(name), pblk.pack.read(name), err_msg=name)
    rbe2 = RMemBackend()
    _copy(be, rbe2)
    _assert_blocks_equal(r_open(rbe2, TENANT, pm.block_id), pblk,
                         ids=[bytes(t) for t in pids[:10]])


@pytest.mark.parametrize("codec", ["raw", "zstd", "gzip", "lzma"])
def test_column_pack_both_ways(codec):
    rng = np.random.default_rng(0)
    cols = {
        "span.a": rng.integers(0, 9, 1000).astype(np.int32),
        "span.const": np.full(1000, 7, np.int32),  # const chunks
        "span.id": rng.integers(0, 256, (1000, 8)).astype(np.uint8),
        "trace.x": rng.normal(size=40),
        "empty": np.empty((0, 16), np.uint8),
    }
    axes = {"span": AxisChunks([0, 256, 512, 1000])}
    col_axis = {"span.a": "span", "span.const": "span", "span.id": "span"}
    port = b"".join(pack_columns_stream(cols, axes, col_axis, codec=codec))
    ref = r_pack_columns(cols, axes, col_axis, codec=codec)
    for data in (port, ref):
        for pk in (ColumnPack.from_bytes(data), RColumnPack.from_bytes(data)):
            for name, arr in cols.items():
                np.testing.assert_array_equal(pk.read(name), arr)
            np.testing.assert_array_equal(pk.read_groups("span.a", [2, 0]),
                                          np.concatenate([cols["span.a"][512:], cols["span.a"][:256]]))
    if codec != "raw":
        assert "const" in {r[3] for r in ColumnPack.from_bytes(port)._cols["span.const"]["chunks"]}


def test_zstd_shim_refuses_a_real_zstd_frame():
    zstandard = pytest.importorskip("zstandard")
    frame = zstandard.ZstdCompressor().compress(b"x" * 1000)
    with pytest.raises(zstdshim.ZstdError):
        zstdshim.ZstdDecompressor().decompress(frame)
    assert zstdshim.ZstdDecompressor().decompress(zstdshim.ZstdCompressor().compress(b"ab")) == b"ab"


# ------------------------------------------------------------------ TraceQL

QUERIES = [
    '{ resource.service.name = "db" }',
    '{ .http.status_code = 500 }',
    '{ span.http.status_code >= 400 && kind = server }',
    '{ name =~ "GET.*" }',
    '{ name !~ "GET.*" || status = error }',
    '{ .component = "grpc" && duration > 100ms }',
    '{ .latency.weight > 0.5 }',
    '{ .latency.weight < 1 }',
    '{ .cache.hit = true }',
    '{ .cache.hit != false }',
    '{ .http.method }',
    '{ .nope = "x" }',
    '{ resource.k8s.namespace.name != "apps" }',
    '{ resource.k8s.cluster.name =~ "pr.*" }',
    '{ traceDuration > 1s }',
    '{ traceDuration > 1s || kind = client }',
    '{ (traceDuration > 1s && kind = client) && name != "render" }',
    '{ rootServiceName = "auth" && rootName =~ "GET.*" }',
    '{ duration > 1h }',
    '{ span.http.status_code = 99999999999 }',
    '{ true } > { kind = client }',
    '{ kind = server } >> { name = "db.query" }',
    '{ .component = "sql" } ~ { .cache.hit = true }',
    '{ kind = server } && { kind = client }',
    '{ kind = server } || { traceDuration > 1s }',
    '{ kind = server } > { traceDuration > 1s }',
    '{ status = error } | count() > 1',
    '{ .latency.weight * 2 > 1 }',
    '{ parent.kind = server }',
    '{ .http.method = nil }',
    '{ .http.method != nil }',
]


@pytest.fixture(scope="module")
def dicts():
    be = MemBackend()
    meta = build_block_from_traces(be, TENANT, TRACES, row_group_spans=256, device="cpu")
    blk = open_block(be, TENANT, meta.block_id)
    rbe = RMemBackend()
    _copy(be, rbe)
    return blk.dictionary, r_open(rbe, TENANT, meta.block_id).dictionary


def _plan_fields(p):
    return (p.tree, [dataclasses.astuple(c) for c in p.conds], [tuple(r) for r in p.rows],
            {i: np.asarray(t).tolist() for i, t in p.tables.items()}, p.prune, p.needs_verify,
            p.extra_cols)


@pytest.mark.parametrize("query", QUERIES)
def test_plans_match_reference(dicts, query):
    d, rd = dicts
    for kw in ({}, {"allow_struct": False}):
        got = plan.plan_search_request(d, {}, query=query, **kw)
        want = r_plan.plan_search_request(rd, {}, query=query, **kw)
        assert _plan_fields(got) == _plan_fields(want)


@pytest.mark.parametrize("tags,kw", [
    ({"service.name": "db"}, {}),
    ({"http.status_code": "500", "component": "grpc"}, {"min_duration_ms": 100}),
    ({"cache.hit": "true"}, {"max_duration_ms": 900, "start_rel_ms": (-5, 10_000)}),
    ({"name": "render"}, {"min_duration_ms": 1, "max_duration_ms": 2000}),
    ({"nope": "x"}, {}),
])
def test_tag_plans_match_reference(dicts, tags, kw):
    d, rd = dicts
    got = plan.plan_search_request(d, tags, **kw)
    want = r_plan.plan_search_request(rd, tags, **kw)
    assert _plan_fields(got) == _plan_fields(want)


def test_parse_and_host_eval_match_reference():
    for q in QUERIES:
        assert repr(parser.parse(q)) == repr(r_parser.parse(q))
    be = MemBackend()
    meta = build_block_from_traces(be, TENANT, TRACES[:40], row_group_spans=256,
                                  device="cpu")
    traces = open_block(be, TENANT, meta.block_id).materialize_traces(list(range(40)))
    rbe = RMemBackend()
    _copy(be, rbe)
    rtraces = r_open(rbe, TENANT, meta.block_id).materialize_traces(list(range(40)))
    for q in QUERIES:
        got = [hosteval.trace_matches(parser.parse(q), t) for t in traces]
        want = [r_hosteval.trace_matches(r_parser.parse(q), t) for t in rtraces]
        assert got == want, q
