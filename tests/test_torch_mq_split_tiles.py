"""M2 (the mesh-batched search's span half, kernels.mq_partial) and M3
(its trace half, kernels.mq_combine) as csrc/multiquery.cu computes them,
in numpy, on the CPU against the reference.

The M2 model takes the kernel's steps: programs in chunks of 32 / P, each
chunk compiled once (mq_compile: one condition word a span; where every
program's offsets are monotone and in their tables, the clause, group and
union runs as word operations, a warp's column sums of the group word,
of the programs' union bits and of the valid spans, and each counter --
a group of a program, or its union -- one of those columns); other
chunks by each program's row (mq_span_bits:
a group holds where its signed count of clauses equals its offsets'
difference). A trace's range is the reference's clip of its global
offsets to the slice (their int32 difference wraps, as the reference's),
negated where it runs backwards; a tile of 16
traces votes, and one with nothing to count writes zeros and walks
nothing; a walk takes 32 spans a step, each counter's step count a byte
of a __reduce_add_sync. The M3 model takes 4 traces a step: the counts
and trace columns 4 at a time, the trace conditions into one 64-bit
word, the trace clauses a trace, and writes one packed buffer, counts
then tm (kernels.mq_views). Both take trace rows in multiples of 4 only
(16-byte stores and loads; the wrappers refuse other counts).

Held: M2 on every row slice of 1, 2, 3 and 4 slices (bounds that cut
traces) against _mq_partial_plain; their sum through the M3 model against
_mq_combine_plain and the reference's single-device run
(tempo_tpu.ops.multiquery.eval_multiquery, JAX on the CPU), bit for
bit. Offsets within row0 of INT_MIN, whose int32 difference wraps, are
held against the reference's mesh programs: M2's, and the sharded
search's M5 and M7. Every output is an int or a bool: equality is
exact."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import test_torch_cases as TC
from torch_tile_cases import MQ_BOUNDS, MQ_CASES, mq_cut_traces, mq_split_case

from tempo_tpu.ops import multiquery as RMQ
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import multiquery as MQ

TT = 16  # csrc/multiquery.cu MQ2_TT: traces a tile of M2
L = MQ._LAYOUT
# mq_cond: an opcode to its three-way compare mask (bit 0: x < v0, bit 1:
# x == v0, bit 2: x > v0); unknown codes match nothing
_M3 = {0: 2, 1: 5, 2: 5, 3: 1, 4: 3, 5: 4, 6: 6, 7: 6}
_I32_MIN, _I32_MAX, _FULL = -(2**31), 2**31 - 1, 0xFFFFFFFF
_ALWAYS, _NEVER = 32, 33
_VALID, _NONE = 64, 65  # csrc/multiquery.cu MQ2_VALID, MQ2_NONE


def _jidx(i: int, n: int) -> int:
    i = int(i)
    return int(np.clip(i + n if i < 0 else i, 0, n - 1))


def _range_bits(lo: int, hi: int) -> int:
    return ((1 << min(hi - lo, 32)) - 1) << lo if hi > lo else 0


def _runs(a: int, b: int) -> list[int]:
    """mq_run: bits i of the run [a, b) whose partner i + s is in it too."""
    return [_range_bits(a, b - (1 << i)) for i in range(5)]


def _cond_bits(row, p: int, vals: list, n_sc: int) -> np.ndarray:
    """Condition p of a program row on every span, as mq_compile files it:
    by value where it is an equality (the hash probe), else by its
    compare mask and range."""
    op, v0 = int(row[L["cond_op"] + p]), int(row[L["cond_v0"] + p])
    m3 = _M3.get(op, 0)
    lo = 0 if op == 2 else _I32_MIN
    hi = int(row[L["cond_v1"] + p]) if op == 7 else _I32_MAX
    if row[L["cond_guard"] + p] and lo == _I32_MIN:
        lo += 1
    x = vals[int(np.clip(row[L["cond_col"] + p], 0, n_sc - 1)) if n_sc else 0]
    if m3 == 2 and hi == _I32_MAX and lo in (_I32_MIN, _I32_MIN + 1):
        return x == v0 if not (lo == _I32_MIN + 1 and v0 == _I32_MIN) else np.zeros(x.shape, bool)
    sel = (x > v0).astype(np.int64) + (x >= v0)
    return (((m3 >> sel) & 1) == 1) & (x >= lo) & (x <= hi)


def _chunk_hits(chunk, dims, vals: list, n_sc: int):
    """One chunk's counters on every span of the slice: (K, Sl) bools,
    counter q (NG + 1) + g for group g of program q, g = NG its union;
    and the chunk's route: "words" (the word operations), "union" (and a
    program whose union needs its own column sums), "rows"."""
    P, NC, NG = dims[:3]
    n = vals[0].shape[0]
    cl = [[int(r[L["clause_off"] + c]) for c in range(NC + 1)] for r in chunk]
    go = [[int(r[L["group_off"] + g]) for g in range(NG + 1)] for r in chunk]
    regular = all(all(0 <= c[i] <= c[i + 1] <= P for i in range(NC)) and
                  all(0 <= g[i] <= g[i + 1] <= NC for i in range(NG)) for c, g in zip(cl, go))
    hits = []
    if regular:  # mq_compile's words, then mq_group_word and mq_union_word
        cb = np.zeros(n, np.int64)
        sc, sg, hc, hg, lhg, cu, gdesc = [0] * 5, [0] * 5, 0, 0, 0, 0, {}
        for q, r in enumerate(chunk):
            base, ng = q * P, int(r[L["n_groups"]])
            for p in range(P):
                cb |= _cond_bits(r, p, vals, n_sc).astype(np.int64) << (base + p)
            for c in range(NC):
                a, b = cl[q][c], cl[q][c + 1]
                if b > a and go[q][0] <= c < go[q][NG]:
                    sc = [x | y for x, y in zip(sc, _runs(base + a, base + b))]
                    hc |= 1 << (base + a)
            if ng <= 0:
                cu |= 1 << base
            for g in range(NG):
                ra, rb = go[q][g], go[q][g + 1]
                d = _ALWAYS
                if rb > ra:
                    empty = any(cl[q][c + 1] <= cl[q][c] for c in range(ra, rb))
                    d = _NEVER if empty else base + cl[q][ra]
                    if not empty:
                        sg = [x | y for x, y in zip(sg, _runs(d, base + cl[q][rb]))]
                        hg |= 1 << d
                        lhg |= (1 << d) if g < ng else 0
                elif g < ng:
                    cu |= 1 << base
                gdesc[q, g] = d
        y = cb.copy()
        for i in range(5):
            y |= (y >> (1 << i)) & sc[i]
        z = (y & hc) | (~hc & _FULL)
        for i in range(5):
            z &= (z >> (1 << i)) | (~sg[i] & _FULL)
        gw = z & hg
        u = (gw & lhg) | cu
        union_col = False
        uq = np.zeros(n, np.int64)  # bit q: program q's union holds
        for q in range(len(chunk)):
            uq |= (((u >> (q * P)) & _range_bits(0, P)) != 0).astype(np.int64) << q
        # the warp's column sums: gw's bits, uq's bits, every span, none
        cols = ([(gw >> d) & 1 for d in range(32)] + [(uq >> q) & 1 for q in range(32)]
                + [np.ones(n, np.int64), np.zeros(n, np.int64)])
        for q in range(len(chunk)):
            heads = lhg & _range_bits(q * P, q * P + P)
            for g in range(NG + 1):  # csrc: the column a counter reads
                if g < NG:
                    e = gdesc[q, g]
                    src = e if e < 32 else _VALID if e == _ALWAYS else _NONE
                else:  # the union: always, one live head, none, or its own column
                    src = (_VALID if cu >> (q * P) & 1 else _NONE if heads == 0 else
                           heads.bit_length() - 1 if heads & (heads - 1) == 0 else 32 + q)
                    union_col = union_col or src == 32 + q
                hits.append(cols[src] != 0)
        return np.stack(hits), "union" if union_col else "words"
    for q, r in enumerate(chunk):  # mq_span_bits, each program's row as it stands
        co = [_jidx(x, P + 1) for x in cl[q]]
        conds = [_cond_bits(r, p, vals, n_sc) for p in range(P)]
        gbits = []
        for g in range(NG):
            a, b = _jidx(go[q][g], NC + 1), _jidx(go[q][g + 1], NC + 1)
            want = int(np.int32(np.int64(go[q][g + 1]) - go[q][g]))
            n_ok = np.zeros(n, np.int64)
            for c in range(min(a, b), max(a, b)):
                n_ok += np.logical_or.reduce(conds[co[c]:co[c + 1]] or [np.zeros(n, bool)])
            ok = n_ok == b - a if b >= a and want == b - a else (-n_ok if b < a else n_ok) == want
            gbits.append(ok)
        ng = int(r[L["n_groups"]])
        union = (np.logical_or.reduce(gbits[:max(0, min(ng, NG))] or [np.zeros(n, bool)])
                 if ng > 0 else np.ones(n, bool))
        hits += gbits + [union]
    return np.stack(hits), "rows"


def m2_model(rows: np.ndarray, dims, span_mat: np.ndarray, row0: int, span_off: np.ndarray,
             n_spans: int, stats: dict | None = None) -> np.ndarray:
    """M2 on the slice span_mat (n_sc, Sl) at global row row0 -> (q_b, NG
    + 1, NT_b) int32 partial counts. stats counts the chunks by route
    (_chunk_hits) and the tiles zeroed or walked."""
    P, NG = dims[0], dims[2]
    q_b, ntb = rows.shape[0], span_off.shape[0] - 1
    assert ntb % 4 == 0  # kernels.mq_partial refuses other trace rows
    n_sc, sl = span_mat.shape
    vals = [c.astype(np.int64) for c in span_mat] or [np.zeros(sl, np.int64)]
    vend = min(max(n_spans - row0, 0), sl)
    off = (span_off.astype(np.int64) - row0 + 2**31) % 2**32 - 2**31  # an int32 difference
    lo, hi = np.clip(off[:-1], 0, sl), np.clip(off[1:], 0, sl)
    a = np.minimum(lo, hi)
    e = np.maximum(a, np.minimum(np.maximum(lo, hi), vend))
    out = np.zeros((q_b, NG + 1, ntb), np.int64)
    stats = {} if stats is None else stats
    qc = min(q_b, 32 // P)
    for q0 in range(0, q_b, qc):
        hits, route = _chunk_hits(rows[q0:q0 + qc].astype(np.int64), dims, vals, n_sc)
        stats[route] = stats.get(route, 0) + 1
        cnt = out[q0:q0 + qc].reshape(-1, ntb)
        for t0 in range(0, ntb, TT):
            if not (e[t0:t0 + TT] > a[t0:t0 + TT]).any():  # the vote: zeros, no walk
                stats["zeroed"] = stats.get("zeroed", 0) + 1
                continue
            stats["walked"] = stats.get("walked", 0) + 1
            for t in range(t0, min(t0 + TT, ntb)):
                for base in range(a[t], e[t], 32):
                    step = hits[:, base:min(base + 32, e[t])].sum(axis=1)
                    assert step.max(initial=0) < 256  # one byte of a packed sum
                    cnt[:, t] += step
                if hi[t] < lo[t]:
                    cnt[:, t] = -cnt[:, t]
    return out.astype(np.int32)


def _trace_ok(row, gany: int, cond, dims) -> bool:
    """mq_trace_ok with trace condition j given by cond(j)."""
    _, _, NG, PT, NA, TC_ = dims
    for c in range(TC_):
        cl = c >= row[L["n_tclauses"]]
        for at in range(*(_jidx(row[L["tclause_off"] + c + i], NA + 1) for i in (0, 1))):
            if cl:
                break
            kind, idx = row[L["atom_kind"] + at], row[L["atom_idx"] + at]
            v = (bool(gany >> int(np.clip(idx, 0, NG - 1)) & 1) if kind == 0
                 else cond(int(np.clip(idx, 0, PT - 1))))
            cl = v and kind >= 0
        if not cl:
            return False
    return True


def m3_model(rows: np.ndarray, dims, counts: np.ndarray, trace_mat: np.ndarray,
             n_traces: int) -> np.ndarray:
    """M3 on the summed counts (q_b, NG + 1, NT_b) -> its packed uint8
    output (counts int32, then tm), 4 traces a step."""
    NG, PT = dims[2], dims[3]
    q_b, _, ntb = counts.shape
    assert ntb % 4 == 0  # kernels.mq_combine_packed refuses other trace rows
    n_tc = trace_mat.shape[0]
    packed = np.zeros(5 * q_b * ntb, np.uint8)
    cnt_o = packed[:4 * q_b * ntb].view(np.int32).reshape(q_b, ntb)
    tm_o = packed[4 * q_b * ntb:].reshape(q_b, ntb)

    def load4(row, t):  # 4 traces at once
        return row[t:t + 4].astype(np.int64)

    for q in range(q_b):
        r = rows[q].astype(np.int64)
        for t in range(0, ntb, 4):
            gp = 0
            for g in range(NG):
                gp |= sum(int(v > 0) << (8 * i + g) for i, v in enumerate(load4(counts[q, g], t)))
            un = load4(counts[q, NG], t)
            tb = 0
            for j in range(PT):
                op = int(r[L["tcond_op"] + j])
                if not 0 <= op <= 7:
                    continue
                x = (load4(trace_mat[int(np.clip(r[L["tcond_col"] + j], 0, n_tc - 1))], t)
                     if n_tc else np.zeros(4, np.int64))
                b = MQ._cmp_code(op, x, int(r[L["tcond_v0"] + j]), int(r[L["tcond_v1"] + j]))
                tb |= sum(int(bool(v)) << i for i, v in enumerate(b)) << (4 * j)
            for i in range(4):
                ok = t + i < n_traces and _trace_ok(r, (gp >> (8 * i)) & 0xFF,
                                                    lambda j: bool(tb >> (4 * j + i) & 1), dims)
                tm_o[q, t + i] = ok
                cnt_o[q, t + i] = un[i] if ok else 0
    return packed


def _lowered_pair(arrays: dict):
    lq = MQ.LoweredQuery.from_arrays(arrays)
    shape = RMQ.ProgramShape(**dataclasses.asdict(lq.shape))
    fields = {f.name: getattr(lq, f.name) for f in dataclasses.fields(lq) if f.name != "shape"}
    return RMQ.LoweredQuery(shape=shape, **fields), lq


def _inputs(arrays, cols, q_b):
    pairs = [_lowered_pair(a) for a in arrays]
    shape = pairs[0][1].shape
    progs = MQ.pack_queries([p for _, p in pairs], q_b)
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    span_mat = np.stack([cols[n] for n in shape.span_cols]) if shape.span_cols else \
        np.zeros((0, TC.N_SPANS_B), np.int32)
    trace_mat = np.stack([cols[n] for n in shape.trace_cols]) if shape.trace_cols else \
        np.zeros((1, TC.N_TRACES_B), np.int32)
    return pairs, progs, dims, span_mat, trace_mat


def _plain_partial(rows, dims, span_mat, row0, span_off, n_spans):
    sm = span_mat if span_mat.shape[0] else np.zeros((1, span_mat.shape[1]), np.int32)
    return MQ._mq_partial_plain(torch.from_numpy(np.ascontiguousarray(sm)),
                                torch.from_numpy(span_off),
                                MQ.program_tables(torch.from_numpy(rows), dims), row0,
                                n_spans).numpy()


@pytest.mark.parametrize("case", MQ_CASES)
def test_split_models_equal_reference(case):
    """M2's model on 1-4 row slices that cut traces, against the plain
    version slice by slice; the sum through M3's model against the plain
    version and the reference's single-device run, bit for bit."""
    arrays, cols, q = mq_split_case(case, sum(map(ord, case)))
    q_b = MQ._p2(q, lo=1)
    pairs, progs, dims, span_mat, trace_mat = _inputs(arrays, cols, q_b)
    rows = MQ._program_rows(progs)
    span_off = cols["trace.span_off"]
    rlow = [r for r, _ in pairs]
    ref = SimpleNamespace(cols=cols, n_spans=TC.N_SPANS, n_traces=TC.N_TRACES,
                          n_spans_b=TC.N_SPANS_B, n_traces_b=TC.N_TRACES_B)
    want_tm, want_cnt = (np.asarray(x) for x in RMQ.eval_multiquery(
        rlow, ref, RMQ.pack_queries(rlow, q_b)))
    tables = MQ.program_tables(torch.from_numpy(rows), dims)
    stats: dict = {}
    for w, bounds in MQ_BOUNDS.items():
        assert w == 1 or mq_cut_traces(span_off, bounds) > 0
        total = np.zeros((q_b, dims[2] + 1, TC.N_TRACES_B), np.int32)
        for r0, r1 in zip(bounds, bounds[1:]):
            got = m2_model(rows, dims, span_mat[:, r0:r1], r0, span_off, TC.N_SPANS, stats)
            np.testing.assert_array_equal(
                got, _plain_partial(rows, dims, span_mat[:, r0:r1], r0, span_off, TC.N_SPANS),
                err_msg=f"{w} slices, row {r0}")
            total += got
        packed = m3_model(rows, dims, total, trace_mat, TC.N_TRACES)
        tm, cnt = (x.numpy() for x in kernels.mq_views(torch.from_numpy(packed), q_b,
                                                         TC.N_TRACES_B))
        ptm, pcnt = MQ._mq_combine_plain(torch.from_numpy(total), torch.from_numpy(trace_mat),
                                         tables, TC.N_TRACES)
        np.testing.assert_array_equal(tm, ptm.numpy(), err_msg=f"{w} slices")
        np.testing.assert_array_equal(cnt, pcnt.numpy(), err_msg=f"{w} slices")
        np.testing.assert_array_equal(tm, want_tm, err_msg=f"{w} slices")
        np.testing.assert_array_equal(cnt, want_cnt, err_msg=f"{w} slices")
    assert want_tm.any(), "vacuous: no program matched"
    assert stats["walked"] and stats["zeroed"]
    if case == "regular":
        assert "rows" not in stats and stats["words"] and stats["union"]
    if case == "odd_p":  # one group a program: every union is its group's column
        assert set(stats) == {"words", "walked", "zeroed"}
    if case.startswith("hostile"):
        assert stats["rows"] and stats.get("words", 0) + stats.get("union", 0)
        assert (want_cnt < 0).any()  # traces that run backwards count negative spans


@pytest.mark.parametrize("kind", [1, 2])
def test_m2_model_offsets_below_zero(kind):
    """Span offsets that run backwards and fall below zero (the mesh's
    clip, not the single-device wrap): M2's model equals the plain
    version on every slice."""
    rng = np.random.default_rng(60 + kind)
    arrays = [TC.hostile_program(TC.random_program(rng), rng, kind) if i % 2
              else TC.random_program(rng) for i in range(4)]
    cols = TC.hostile_cols(kind)
    _, progs, dims, span_mat, _ = _inputs(arrays, cols, 4)
    rows = MQ._program_rows(progs)
    off = cols["trace.span_off"]
    assert (off < 0).any()
    for bounds in MQ_BOUNDS.values():
        for r0, r1 in zip(bounds, bounds[1:]):
            np.testing.assert_array_equal(
                m2_model(rows, dims, span_mat[:, r0:r1], r0, off, TC.N_SPANS),
                _plain_partial(rows, dims, span_mat[:, r0:r1], r0, off, TC.N_SPANS))


@pytest.mark.parametrize("row0", [1500, 1536, 1984])
def test_m2_model_slice_past_the_spans(row0):
    """A slice at or past n_spans (a rank whose rows are all padding):
    every tile votes empty and writes zeros, as the plain version counts."""
    arrays, cols, q = mq_split_case("regular", row0)
    q_b = MQ._p2(q, lo=1)
    _, progs, dims, span_mat, _ = _inputs(arrays, cols, q_b)
    rows = MQ._program_rows(progs)
    stats: dict = {}
    got = m2_model(rows, dims, span_mat[:, row0:], row0, cols["trace.span_off"], TC.N_SPANS,
                   stats)
    assert not got.any() and "walked" not in stats and stats["zeroed"]
    np.testing.assert_array_equal(got, _plain_partial(rows, dims, span_mat[:, row0:], row0,
                                                      cols["trace.span_off"], TC.N_SPANS))


@pytest.mark.parametrize("ntb", [1012, 1016, 1020])
def test_models_on_a_short_last_tile(ntb):
    """Trace rows a multiple of 4 but not of 16: M2's last tile holds 4, 8
    or 12 traces, which it walks and stores 16 bytes at a time; summed
    over 3 slices, then M3's, equal the plain versions. Rows not a
    multiple of 4 are refused."""
    rng = np.random.default_rng(ntb)
    arrays = [TC.random_program(rng) for _ in range(4)]
    cols = TC.mq_cols(ntb)
    off = np.sort(rng.integers(0, TC.N_SPANS, ntb + 1)).astype(np.int32)
    off[0], off[-8:] = 0, TC.N_SPANS - 20 + np.arange(8)  # the last tile walks
    _, progs, dims, span_mat, trace_mat = _inputs(arrays, cols, 4)
    rows = MQ._program_rows(progs)
    trace_mat = np.ascontiguousarray(trace_mat[:, :ntb])
    bounds = MQ_BOUNDS[3]
    total = np.zeros((4, dims[2] + 1, ntb), np.int32)
    for r0, r1 in zip(bounds, bounds[1:]):
        got = m2_model(rows, dims, span_mat[:, r0:r1], r0, off, TC.N_SPANS)
        np.testing.assert_array_equal(
            got, _plain_partial(rows, dims, span_mat[:, r0:r1], r0, off, TC.N_SPANS))
        total += got
    assert total[:, :, -(ntb % 16):].any()
    tm, cnt = kernels.mq_views(torch.from_numpy(m3_model(rows, dims, total, trace_mat, 1000)),
                               4, ntb)
    ptm, pcnt = MQ._mq_combine_plain(torch.from_numpy(total), torch.from_numpy(trace_mat),
                                     MQ.program_tables(torch.from_numpy(rows), dims), 1000)
    assert torch.equal(tm, ptm) and torch.equal(cnt, pcnt)
    assert tm.any() and not tm[:, 1000:].any()
    with pytest.raises(AssertionError):
        m2_model(rows, dims, span_mat, 0, off[:-2], TC.N_SPANS)
    with pytest.raises(AssertionError):
        m3_model(rows, dims, total[:, :, :-2], trace_mat[:, :-2], 1000)


@pytest.mark.parametrize("first", [-(2**31), -(2**31) + 700])
def test_offsets_that_wrap_match_the_mesh_reference(first):
    """Span offsets within row0 of INT_MIN: the reference's mesh program
    (tempo_tpu.parallel.multiquery, 8 CPU devices, slices of 256 rows)
    takes span_off - row0 in int32, which wraps. M2's model and plain
    version over the same 8 slices, summed, then M3's, equal it."""
    from tempo_tpu.parallel import make_mesh
    from tempo_tpu.parallel.multiquery import mesh_eval_multiquery

    rng = np.random.default_rng(5)
    arrays = [TC.random_program(rng, n_groups=0 if i % 2 else None) for i in range(4)]
    for p in arrays[:2]:
        p["n_tclauses"] = 0  # every trace passes: its counts show
    cols = TC.mq_cols(5)
    cols["trace.span_off"][[5, 9, 40]] = first
    pairs, progs, dims, span_mat, trace_mat = _inputs(arrays, cols, 4)
    rlow = [r for r, _ in pairs]
    ref = SimpleNamespace(cols=cols, n_spans=TC.N_SPANS, n_traces=TC.N_TRACES,
                          n_spans_b=TC.N_SPANS_B, n_traces_b=TC.N_TRACES_B)
    want_tm, want_cnt = mesh_eval_multiquery(make_mesh(8), rlow, ref,
                                             RMQ.pack_queries(rlow, 4))
    rows, off, sl = MQ._program_rows(progs), cols["trace.span_off"], TC.N_SPANS_B // 8
    model = sum(m2_model(rows, dims, span_mat[:, r * sl:(r + 1) * sl], r * sl, off, TC.N_SPANS)
                for r in range(8))
    plain = sum(_plain_partial(rows, dims, span_mat[:, r * sl:(r + 1) * sl], r * sl, off,
                               TC.N_SPANS) for r in range(8))
    np.testing.assert_array_equal(model, plain)
    tm, cnt = kernels.mq_views(torch.from_numpy(m3_model(rows, dims, model.astype(np.int32),
                                                         trace_mat, TC.N_TRACES)), 4,
                               TC.N_TRACES_B)
    np.testing.assert_array_equal(tm.numpy(), want_tm)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    assert (np.abs(want_cnt[:2, [4, 5, 8, 9, 39, 40]]) > 100).any()  # the wrapped ranges count


@pytest.mark.parametrize("col", ["trace.span_off", "sattr.off"])
def test_sharded_search_offsets_that_wrap(col):
    """The same int32 wrap in the sharded search: span offsets (M7's
    trace ranges) or span attr offsets (M5's owner ranges) within a
    shard's first row of INT_MIN. search_local on a 1 x 4 mesh of
    threads, every M5 and M7 through its plain version, equals the
    reference's shard_map program on 4 CPU devices."""
    from test_torch_mesh_search import CASES, _operands
    from test_torch_struct_mask import _reference, _threaded_search

    from tempo_tpu_torch.ops import filter as F

    tree, specs, rows, _, cols, n_spans, nt = CASES["attrs"](np.random.default_rng(7))
    off = cols[col]
    first = 8 if col == "trace.span_off" else 16  # shard 1's first span or attr row
    off[0, [2, 5]] = [_I32_MIN, _I32_MIN + first + 3]
    off[1, 4] = _I32_MIN + 2 * first + 1
    conds = tuple(F.Cond(t, c, o, is_float=f) for t, c, o, f in specs)
    (tm, sc), _ = _threaded_search(4, tree, conds, _operands(F, rows, None), cols, n_spans, nt)
    want_tm, want_sc = _reference(4, tree, specs, rows, cols, n_spans, nt)
    np.testing.assert_array_equal(tm, want_tm)
    np.testing.assert_array_equal(sc, want_sc)
    assert tm.any()

