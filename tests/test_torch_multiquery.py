"""The port's multi-query programs (ops/multiquery.py: lowering, packing,
B5a's and B5b's plain versions) on the CPU against the JAX package's.

Lowering is compared field by field on real plans; the program run and
the row-wise top-k take the same numpy inputs, made from a seed, through
the reference's jitted programs (on the CPU, as its own tests run them)
and the port's plain versions on device="cpu". Every output is a bool or
an int: equality is exact."""

import dataclasses

import numpy as np
import pytest
import torch
import test_torch_cases as TC

from tempo_tpu.backend import MemBackend as RMemBackend
from tempo_tpu.block import build_block_from_traces as r_build
from tempo_tpu.block import open_block as r_open
from tempo_tpu.db.search import SearchRequest as RRequest
from tempo_tpu.db.search import _plan_for_block as r_plan_for_block
from tempo_tpu.ops import multiquery as RMQ
from tempo_tpu.ops import stage as RST
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import open_block
from tempo_tpu_torch.db.search import SearchRequest, _plan_for_block
from tempo_tpu_torch.ops import multiquery as MQ
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops.device import bucket

TENANT = "t"

# tests/test_batchexec.py:48-62: eligible, then ineligible queries
ELIGIBLE = [
    '{ name = "db.query" }',
    '{ duration > 100ms }',
    '{ status = error && kind = server }',
    '{ name = "GET /" || duration < 1ms }',
    '{ span.http.status_code >= 500 }',
    '{ name = "db.query" && resource.service.name = "auth" }',
]
INELIGIBLE = [
    '{ span.component = "grpc" }',
    '{ name =~ "GET.*" }',
    '{ name = "GET /" } >> { name = "db.query" }',
]
# the batcher's differential set (tests/test_batchexec.py:62-77)
DIFFERENTIAL = [
    '{ name = "db.query" }',
    '{ name != "render" }',
    '{ duration > 500ms }',
    '{ status = error }',
    '{ kind = server }',
    '{ span.http.method = "GET" && duration > 10ms }',
    '{ span.http.status_code >= 500 }',
    '{ name = "GET /api" || name = "cache.get" }',
    '{ name = "db.query" && resource.service.name = "db" }',
    '{ span.http.status_code = 200 && status != error }',
]


@pytest.fixture(scope="module")
def blocks():
    """One block written by the JAX package, opened by both readers."""
    backend = RMemBackend()
    meta = r_build(backend, TENANT, make_traces(120, seed=7, n_spans=8), row_group_spans=256)
    port_backend = MemBackend()
    for (t, b, name), data in backend._objects.items():
        port_backend.write(t, b, name, data)
    return r_open(backend, TENANT, meta.block_id), open_block(port_backend, TENANT, meta.block_id)


def _lower_both(blocks, query):
    rblk, blk = blocks
    rp = r_plan_for_block(rblk, RRequest(query=query))
    p = _plan_for_block(blk, SearchRequest(query=query))
    assert rp.prune == p.prune
    return (None if rp.prune else RMQ.lower_plan(rp)), (None if p.prune else MQ.lower_plan(p))


def _fields_equal(want, got):
    assert dataclasses.asdict(want.shape) == dataclasses.asdict(got.shape)
    for f in dataclasses.fields(want):
        if f.name != "shape":
            np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                          np.asarray(getattr(want, f.name)), err_msg=f.name)


@pytest.mark.parametrize("query", ELIGIBLE + DIFFERENTIAL)
def test_lower_plan_matches_reference(blocks, query):
    want, got = _lower_both(blocks, query)
    assert want is not None and got is not None, query
    _fields_equal(want, got)


@pytest.mark.parametrize("query", INELIGIBLE)
def test_ineligible_plans_lower_to_none(blocks, query):
    assert _lower_both(blocks, query) == (None, None)


def test_from_arrays_carries_reference_programs(blocks):
    want, _ = _lower_both(blocks, ELIGIBLE[5])
    arrays = {f.name: getattr(want, f.name) for f in dataclasses.fields(want) if f.name != "shape"}
    arrays.update(span_cols=want.shape.span_cols, trace_cols=want.shape.trace_cols)
    _fields_equal(want, MQ.LoweredQuery.from_arrays(arrays))


def _reference_lowered(arrays: dict):
    lq = MQ.LoweredQuery.from_arrays(arrays)
    shape = RMQ.ProgramShape(**dataclasses.asdict(lq.shape))
    return RMQ.LoweredQuery(shape=shape, **{f.name: getattr(lq, f.name)
                                            for f in dataclasses.fields(lq) if f.name != "shape"}), lq


@pytest.mark.parametrize("q_b", [1, 4, 16])
def test_pack_queries_matches_reference(blocks, q_b):
    n = min(q_b, 3)
    pairs = [_reference_lowered(TC.random_program(np.random.default_rng(i))) for i in range(n)]
    want = RMQ.pack_queries([r for r, _ in pairs], q_b)
    got = MQ.pack_queries([p for _, p in pairs], q_b)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _run_both(cols, n_spans, n_traces, lowered_pairs, q_b):
    """The reference's _compiled_multiquery run and the port's plain B5a
    on the same staged columns; returns the port's (tm, counts)."""
    rlow = [r for r, _ in lowered_pairs]
    plow = [p for _, p in lowered_pairs]
    shape = rlow[0].shape
    nsb, ntb = bucket(n_spans), bucket(n_traces)
    fn = RMQ._compiled_multiquery(shape, q_b, nsb, ntb)
    want = fn(tuple(cols[n] for n in shape.span_cols), tuple(cols[n] for n in shape.trace_cols),
              cols["trace.span_off"], RMQ.pack_queries(rlow, q_b), np.int32(n_spans),
              np.int32(n_traces))
    staged = ST.staged_from_numpy(cols, n_spans, n_traces, 1, "cpu")
    got = MQ.eval_multiquery(plow, staged, MQ.pack_queries(plow, q_b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


@pytest.mark.parametrize("q", [1, 3, 16])
def test_program_run_matches_reference(q):
    """Random well-formed programs over columns with empty traces,
    traces longer than a warp, PAD span@res values and trace conds;
    q = 3 pads to 4 queries (padded rows must match nothing)."""
    rng = np.random.default_rng(q)
    pairs = [_reference_lowered(TC.random_program(rng)) for _ in range(q)]
    tm, counts = _run_both(TC.mq_cols(q), TC.N_SPANS, TC.N_TRACES, pairs, MQ._p2(q, lo=1))
    assert not tm[q:].any()
    assert tm[:q].any(), "vacuous: no program matched"


def test_program_run_no_groups_counts_every_span():
    rng = np.random.default_rng(5)
    pairs = [_reference_lowered(TC.random_program(rng, n_groups=0)) for _ in range(4)]
    cols = TC.mq_cols(2)
    tm, counts = _run_both(cols, TC.N_SPANS, TC.N_TRACES, pairs, 4)
    per = np.diff(cols["trace.span_off"][: TC.N_TRACES + 1])
    for qi in range(4):
        m = tm[qi, : TC.N_TRACES].numpy()
        np.testing.assert_array_equal(counts[qi, : TC.N_TRACES].numpy()[m], per[m])


@pytest.mark.parametrize("query_set", ["eligible", "differential"])
def test_program_run_on_a_staged_block(blocks, query_set):
    """Real plans of one shape group on a block staged by the JAX
    package: the batcher's own use."""
    rblk, blk = blocks
    queries = ELIGIBLE if query_set == "eligible" else DIFFERENTIAL
    lowered = [(r, p) for r, p in (_lower_both(blocks, q) for q in queries)]
    by_shape: dict = {}
    for r, p in lowered:
        by_shape.setdefault(r.shape, []).append((r, p))
    needed = sorted({n for s in by_shape for n in s.span_cols + s.trace_cols}
                    | {"trace.span_off", "span.res_idx", "res.service_id"})
    staged = RST.stage_block(rblk, [n for n in needed if not n.startswith("span@")]
                             + [n for n in needed if n.startswith("span@")])
    cols = {k: np.asarray(v) for k, v in staged.cols.items()}
    for pairs in by_shape.values():
        _run_both(cols, staged.n_spans, staged.n_traces, pairs, MQ._p2(len(pairs), lo=1))


def _select_inputs(seed, q, n):
    rng = np.random.default_rng(seed)
    tm = rng.random((q, n)) < 0.3
    key = rng.integers(0, 9, n).astype(np.int32)  # heavy ties
    counts = rng.integers(0, 50, (q, n)).astype(np.int32)
    return tm, key, counts


@pytest.mark.parametrize("k", [16, 64])
def test_row_select_matches_reference_and_keeps_prefixes(k):
    tm, key, counts = _select_inputs(k, 16, 1024)
    want = np.asarray(RMQ._compiled_mq_select(k, 16)(tm, key, counts))
    got = MQ._mq_select_plain(torch.from_numpy(tm), torch.from_numpy(key),
                              torch.from_numpy(counts), k).numpy()
    np.testing.assert_array_equal(got, want)
    # the prefix property: the first k' slots of a k-select = a k'-select
    rows = MQ.select_multiquery(torch.from_numpy(tm), torch.from_numpy(key),
                                torch.from_numpy(counts), k)
    small = MQ.select_multiquery(torch.from_numpy(tm), torch.from_numpy(key),
                                 torch.from_numpy(counts), k // 4)
    for (s, c, v, n), (s2, c2, v2, n2) in zip(rows, small):
        kk = k // 4
        assert n == n2
        np.testing.assert_array_equal(s[:kk], s2)
        np.testing.assert_array_equal(c[:kk], c2)
        np.testing.assert_array_equal(v[:kk], v2)


def test_mq_bytes_estimate_matches_reference():
    shape = MQ.ProgramShape(8, 4, 2, 2, 4, 2, ("a",), ())
    rshape = RMQ.ProgramShape(8, 4, 2, 2, 4, 2, ("a",), ())
    assert MQ.mq_bytes_estimate(shape, 16, 1 << 20) == RMQ.mq_bytes_estimate(rshape, 16, 1 << 20)
