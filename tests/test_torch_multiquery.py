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


# csrc/multiquery.cu mq_cond: an opcode to its three-way compare mask
# (bit 0: x < v0, bit 1: x == v0, bit 2: x > v0); unknown codes match nothing
_M3 = {0: 2, 1: 5, 2: 5, 3: 1, 4: 3, 5: 4, 6: 6, 7: 6}
_I32_MIN, _I32_MAX, _FULL = -(2**31), 2**31 - 1, 0xFFFFFFFF
_ALWAYS, _NEVER = 32, 33


def _jidx(i: int, n: int) -> int:
    """mq_jidx: a negative index counts from the end, then clamps."""
    i = int(i)
    return int(np.clip(i + n if i < 0 else i, 0, n - 1))


def _range_bits(lo: int, hi: int) -> int:
    return ((1 << (hi - lo)) - 1) << lo if hi > lo else 0


def _runs(a: int, b: int) -> list[int]:
    """mq_run: bits i of the run [a, b) whose partner i + s is in it too."""
    return [_range_bits(a, b - (1 << i)) for i in range(5)]


def _trace_ok(r, gany, trace_cols, t, dims) -> bool:
    """mq_trace_ok on program row r."""
    _, _, NG, PT, NA, TC_ = dims
    L = MQ._LAYOUT
    for c in range(TC_):
        cl = c >= r[L["n_tclauses"]]
        for a in range(*(_jidx(r[L["tclause_off"] + c + i], NA + 1) for i in (0, 1))):
            if cl:
                break
            kind, idx = r[L["atom_kind"] + a], r[L["atom_idx"] + a]
            if kind == 0:
                v = bool(gany >> int(np.clip(idx, 0, NG - 1)) & 1)
            else:
                j = int(np.clip(idx, 0, PT - 1))
                x = (int(trace_cols[int(np.clip(r[L["tcond_col"] + j], 0, len(trace_cols) - 1))][t])
                     if trace_cols else 0)
                v = bool(MQ._cmp_code(r[L["tcond_op"] + j], x, r[L["tcond_v0"] + j],
                                      r[L["tcond_v1"] + j]))
            cl = v and kind >= 0
        if not cl:
            return False
    return True


def _b5a_model(rows, dims, span_cols, trace_cols, span_off, n_spans, n_traces, n_spans_b):
    """B5a as csrc/multiquery.cu computes it, in numpy: the programs in
    chunks of 32 / P; each chunk compiled once (mq_compile) into one
    condition word a span -- equality conditions by value, as the hash
    probe gives them, the rest by their compare mask and range -- then,
    where every program's offsets are monotone, the clause, group and
    union runs as word operations (mq_group_word, mq_union_word), else
    each program's row (mq_span_bits: a group holds where its signed
    count of clauses equals its offsets' difference); folded per trace
    over its span range (signed where it runs backwards), then its trace
    clauses."""
    P, NC, NG = dims[:3]
    L = MQ._LAYOUT
    rows = rows.astype(np.int64)
    q_b, ntb = rows.shape[0], span_off.shape[0] - 1
    n_sc = len(span_cols)
    vals = [c[:n_spans].astype(np.int64) for c in span_cols] or [np.zeros(n_spans, np.int64)]
    tm = np.zeros((q_b, ntb), bool)
    cnt = np.zeros((q_b, ntb), np.int32)
    qc = min(q_b, 32 // P)
    for q0 in range(0, q_b, qc):
        chunk = rows[q0:q0 + qc]
        raw, used, regular = {}, 0, True
        sc, sg, hc, hg, lhg, cu = [0] * 5, [0] * 5, 0, 0, 0, 0
        tables, gdesc = [], {}
        for q, r in enumerate(chunk):
            base = q * P
            cl_raw = [int(r[L["clause_off"] + c]) for c in range(NC + 1)]
            go_raw = [int(r[L["group_off"] + g]) for g in range(NG + 1)]
            cl = [_jidx(x, P + 1) for x in cl_raw]
            go = [_jidx(x, NC + 1) for x in go_raw]
            cm = [_range_bits(cl[c], cl[c + 1]) << base for c in range(NC)]
            gm = [_range_bits(min(go[g], go[g + 1]), max(go[g], go[g + 1])) for g in range(NG)]
            gneg = [go[g + 1] < go[g] for g in range(NG)]
            gn = [int(np.int32(np.int64(go_raw[g + 1]) - go_raw[g])) for g in range(NG)]
            ucl = int(np.bitwise_or.reduce(gm))
            used |= int(np.bitwise_or.reduce([cm[c] for c in range(NC) if ucl >> c & 1] or [0]))
            ng = int(r[L["n_groups"]])
            tables.append((cm, gm, gneg, gn, ucl, ng))
            for p in range(P):
                op, v0 = int(r[L["cond_op"] + p]), int(r[L["cond_v0"] + p])
                lo = 0 if op == 2 else _I32_MIN
                hi = int(r[L["cond_v1"] + p]) if op == 7 else _I32_MAX
                if r[L["cond_guard"] + p] and lo == _I32_MIN:
                    lo += 1
                col = int(np.clip(r[L["cond_col"] + p], 0, n_sc - 1)) if n_sc else 0
                raw[base + p] = (col, _M3.get(op, 0), v0, lo, hi)
            mono = all(0 <= x <= P for x in cl_raw) and all(0 <= x <= NC for x in go_raw) and \
                all(cl[c] <= cl[c + 1] for c in range(NC)) and \
                all(go[g] <= go[g + 1] for g in range(NG))
            regular = regular and mono
            if not mono:
                continue
            if ng <= 0:
                cu |= 1 << base
            for g in range(NG):
                c0, c1 = go[g], go[g + 1]
                empty = False
                for c in range(c0, c1):
                    a, b = base + cl[c], base + cl[c + 1]
                    if b > a:
                        sc = [x | y for x, y in zip(sc, _runs(a, b))]
                        hc |= 1 << a
                    else:
                        empty = True
                d = _ALWAYS
                if c1 > c0:
                    d = _NEVER if empty else base + cl[c0]
                    if not empty:
                        sg = [x | y for x, y in zip(sg, _runs(base + cl[c0], base + cl[c1]))]
                        hg |= 1 << d
                        if g < ng:
                            lhg |= 1 << d
                elif g < ng:
                    cu |= 1 << base
                gdesc[q, g] = d
        cb = np.zeros(n_spans, np.int64)  # mq_cond_bits
        for d in range(32):
            if not used >> d & 1:
                continue
            col, m3, v0, lo, hi = raw[d]
            x = vals[col]
            if m3 == 2 and hi == _I32_MAX and lo in (_I32_MIN, _I32_MIN + 1):
                if not (lo == _I32_MIN + 1 and v0 == _I32_MIN):  # guarded at PAD: never
                    cb |= (x == v0).astype(np.int64) << d
                continue
            sel = (x > v0).astype(np.int64) + (x >= v0)
            cb |= (((m3 >> sel) & 1) & (x >= lo) & (x <= hi)) << d
        if regular:
            y = cb.copy()  # mq_group_word
            for i in range(5):
                y |= (y >> (1 << i)) & sc[i]
            z = (y & hc) | (~hc & _FULL)
            for i in range(5):
                z &= (z >> (1 << i)) | (~sg[i] & _FULL)
            gw = z & hg
            u = (gw & lhg) | cu  # mq_union_word
        for q, r in enumerate(chunk):
            cm, gm, gneg, gn, ucl, ng = tables[q]
            if regular:
                union = ((u >> (q * P)) & _range_bits(0, P)) != 0  # any of program q's bits
            else:  # mq_span_bits
                clb = np.zeros(n_spans, np.int64)
                for c in range(NC):
                    if ucl >> c & 1:
                        clb |= ((cb & cm[c]) != 0).astype(np.int64) << c
                bits = np.zeros(n_spans, np.int64)
                for g in range(NG):
                    n = np.bitwise_count((clb & gm[g]).astype(np.uint64)).astype(np.int64)
                    bits |= ((-n if gneg[g] else n) == gn[g]).astype(np.int64) << g
                live = (1 << min(max(ng, 0), 32)) - 1
                union = ((bits & live) != 0) if ng > 0 else np.ones(n_spans, bool)
            for t in range(min(n_traces, ntb)):
                lo, hi = (min(_jidx(span_off[t + i], n_spans_b + 1), n_spans) for i in (0, 1))
                a, b = min(lo, hi), max(lo, hi)
                if regular:
                    heads = int(np.bitwise_or.reduce(gw[a:b])) if b > a else 0
                    gany = 0
                    for g in range(NG):
                        d = gdesc[q, g]
                        held = (heads >> d) & 1 if d < 32 else d == _ALWAYS and hi > lo
                        gany |= int(held) << g
                else:
                    gany = int(np.bitwise_or.reduce(bits[a:b])) if b > a else 0
                if hi < lo:  # backwards: every group count below zero, the union count negated
                    gany = 0
                ok = _trace_ok(r, gany, trace_cols, t, dims)
                tm[q0 + q, t] = ok
                cnt[q0 + q, t] = (-1 if hi < lo else 1) * int(union[a:b].sum()) if ok else 0
    return tm, cnt


@pytest.mark.parametrize("kind", [1, 2])
def test_program_run_hostile_offsets_match_reference(kind):
    """Offset tables and span offsets no staging or lowering writes: the
    plain version gathers them as the reference does (negative indices
    from the end, then clamped; signed count differences)."""
    rng = np.random.default_rng(40 + kind)
    pairs = [_reference_lowered(TC.hostile_program(TC.random_program(rng), rng, kind) if i % 2
                                else TC.random_program(rng)) for i in range(8)]
    tm, counts = _run_both(TC.hostile_cols(kind), TC.N_SPANS, TC.N_TRACES, pairs, 8)
    assert tm.any() and (counts < 0).any()  # backward traces count negative spans


def _model_against_reference(arrays: list, cols: dict) -> None:
    """_b5a_model and the reference's jitted run on the same programs and
    columns, bit for bit."""
    q = len(arrays)
    pairs = [_reference_lowered(a) for a in arrays]
    tm, counts = _run_both(cols, TC.N_SPANS, TC.N_TRACES, pairs, MQ._p2(q, lo=1))
    progs = MQ.pack_queries([lq for _, lq in pairs], MQ._p2(q, lo=1))
    shape = pairs[0][1].shape
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    got = _b5a_model(MQ._program_rows(progs), dims, [cols[n] for n in shape.span_cols],
                     [cols[n] for n in shape.trace_cols], cols["trace.span_off"], TC.N_SPANS,
                     TC.N_TRACES, TC.N_SPANS_B)
    np.testing.assert_array_equal(got[0], tm.numpy())
    np.testing.assert_array_equal(got[1], counts.numpy())
    assert got[0].any()


@pytest.mark.parametrize("q,hostile", [(1, 0), (3, 0), (16, 0), (16, 1), (16, 2)])
def test_compiled_programs_equal_reference(q, hostile):
    """The card kernel's compiled form (_b5a_model) on random programs
    (every fifth with no group) over columns with empty traces, traces
    longer than a warp, PAD span@res values and padded traces, bit for bit
    against the reference's jitted run; with hostile offset tables and
    span offsets (TC.hostile_program, TC.hostile_cols) the chunk takes the
    per-program tables instead of the word operations."""
    rng = np.random.default_rng(100 + q)
    arrays = [TC.random_program(rng, n_groups=0 if i % 5 == 4 else None) for i in range(q)]
    if hostile:
        arrays = [TC.hostile_program(a, rng, hostile) if i % 2 else a for i, a in enumerate(arrays)]
    _model_against_reference(arrays, TC.hostile_cols(q + 7) if hostile else TC.mq_cols(q + 7))


@pytest.mark.parametrize("p", [3, 6])
def test_compiled_programs_odd_condition_tables(p):
    """_b5a_model against the reference on condition tables whose length
    is no power of two (from_arrays takes it as it comes): 32 programs,
    32 // p a chunk side by side in one word, so one program's union must
    not reach into the next program's bits."""
    rng = np.random.default_rng(300 + p)
    dims = dict(TC.MQ_DIMS, n_conds_b=p, n_clauses_b=p // 3, n_groups_b=1)
    arrays = [TC.random_program(rng, n_groups=0 if i % 5 == 4 else None, dims=dims)
              for i in range(32)]
    _model_against_reference(arrays, TC.mq_cols(39))


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
