"""M7's tile route, M8's program and the fused route of both
(csrc/meshsearch.cu search_tile_kernel, search_finish_kernel) as numpy
models, held against the reference's arithmetic (tempo_tpu/parallel/
search.py:272-318: `seg_reduce`'s cumsum and clipped offset gathers, as
tests/test_torch_meshsearch.py's `_seg_ref` runs it in jnp, and
`ev_trace` on the tree, in jnp) and the port's plain versions
(ops/meshsearch._search_partial_plain, _search_finish_plain).

The models keep the kernels' shapes: a CTA a tile of 512 traces; the
tile's clipped offsets and its CTA-wide monotone vote; the window read in
chunks of 16,384 rows from a 32-row word grid, 16 rows a load (a byte a
row where a load would cross the window's ends or the rows are not 16-byte
aligned), a bit a row by the kernel's byte test, two loads a word; the
word popcounts' exclusive prefix by thread, warp and CTA; the signed walk
of a tile that is not monotone or has more than 3 tracify slots; M8's 4
traces a thread, the program by value with its trace conditions
renumbered (a long one read as it is). Cases: sp cuts of 1, 2 and 4,
n_tr 0, 1 and 3, falling, negative and past-the-shard offsets, empty
traces and an empty tile, a trace longer than a chunk, windows that start
on an odd row, shard rows that are not 16-byte aligned, a ragged last
tile and group of 4, a trace condition and a table, a program past 64
operations and one past 16 trace conditions. Every output is an int or a
bool: exact."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_meshsearch import _seg_ref
from torch_tile_cases import SEARCH_SPECS, SEARCH_TREES, search_case

from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS
from tempo_tpu_torch.parallel.search import search_local

THREADS, OWN, VEC, STREAMS, TR, PROG, TC = 128, 4, 8, 4, 32, 64, 16
TILE, CHUNK = THREADS * OWN, THREADS * VEC * 16
WPT = CHUNK // 32 // THREADS
SPS = [1, 2, 4]
CONDS = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in SEARCH_SPECS)


def _nz4(w):
    """The kernel's byte test on uint32 words: bit k, byte k is not 0."""
    w = w.astype(np.uint32)
    y = (((w & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | w) & np.uint32(0x80808080)
    return (y >> 7 | y >> 14 | y >> 21 | y >> 28) & np.uint32(0xF)


def _chunk_words(row, g, w0, w1, vec, stats):
    """One stream's chunk at row g: load v (u THREADS + t) holds rows
    g + 16 v, the bytes outside [w0, w1) as 0; lanes 2l and 2l + 1 make
    word l. Returns the chunk's words (uint32)."""
    r = g + 16 * np.arange(CHUNK // 16)
    rows = r[:, None] + np.arange(16)
    inside = (rows >= w0) & (rows < w1)
    full = vec & (r >= w0) & (r + 16 <= w1)
    b = np.zeros(rows.shape, np.uint8)
    b[inside] = row[rows[inside]]
    stats["vec"] += int(full.sum())
    stats["byte"] += int((inside & ~full[:, None]).sum())
    x = b.view("<u4")  # (loads, 4): 4 rows a word, row 0 the low byte
    h = _nz4(x[:, 0]) | _nz4(x[:, 1]) << 4 | _nz4(x[:, 2]) << 8 | _nz4(x[:, 3]) << 12
    return (h[0::2] | h[1::2] << 16).astype(np.uint32)


def _prefix(words):
    """The CTA's exclusive prefix of the words' popcounts: WPT words a
    thread, an inclusive scan a warp, the warps' totals; and the total."""
    pc = np.bitwise_count(words).astype(np.int64)
    t = pc.reshape(THREADS, WPT).sum(axis=1)
    incl = t.reshape(-1, 32).cumsum(axis=1)
    woff = np.concatenate([[0], np.cumsum(incl[:, -1])[:-1]])
    e = (woff[:, None] + incl).reshape(-1) - t  # each thread's exclusive base
    pre = (e[:, None] + np.concatenate([np.zeros((THREADS, 1), np.int64),
                                        pc.reshape(THREADS, WPT).cumsum(axis=1)[:, :-1]],
                                       axis=1)).reshape(-1)
    assert np.array_equal(pre, np.concatenate([[0], np.cumsum(pc)[:-1]]))
    return pre, int(pc.sum())


def _walk(sb, tslots, lo, hi, nvp):
    """A trace's signed count a byte a row: each slot's, then the union's."""
    if not tslots:
        return [], min(hi, nvp) - min(lo, nvp)
    x, e, sign = min(lo, hi), max(lo, hi), 1 if hi >= lo else -1
    rows = sb[tslots, x:e] != 0
    per = [sign * int(r.sum()) for r in rows]
    return per, sign * int(rows.any(axis=0).sum())


def _tile_counts(slots, tslots, off, n_spans, row0, nt, stats):
    """M7's count, tile by tile: yields (b, t0, n, counts (n_tr + 1, n))."""
    bl, _, sl = slots.shape
    n_tr = len(tslots)
    ns = n_tr if n_tr <= 1 else n_tr + 1
    vec = sl % 16 == 0  # the rows of a slot start 16-byte aligned
    for b in range(bl):
        sb = slots[b]
        nvp = min(max(int(n_spans[b]) - row0, 0), sl)
        for t0 in range(0, max(nt, 1), TILE):
            n = min(TILE, nt - t0)
            c = np.clip(off[b, t0:t0 + n + 1].astype(np.int64) - row0, 0, sl)
            out = np.zeros((n_tr + 1, n), np.int64)
            if not (np.all(c[:-1] <= c[1:]) and ns <= STREAMS):
                stats["walk"] += 1
                for i in range(n):
                    per, out[n_tr, i] = _walk(sb, tslots, int(c[i]), int(c[i + 1]), nvp)
                    out[:n_tr, i] = per
                yield b, t0, n, out
                continue
            stats["mono"] += 1
            w0, w1 = int(c[0]), int(c[n])
            stats["odd"] += w0 % 2 == 1
            p = np.full((ns, n + 1), -1, np.int64)  # P at each offset, -1 until its chunk
            run = np.zeros(ns, np.int64)
            for g in range(w0 & ~31, w1, CHUNK) if ns else ():  # no slot: no rows read
                words = [_chunk_words(sb[s], g, w0, w1, vec, stats) for s in tslots]
                if ns > n_tr:
                    words.append(np.bitwise_or.reduce(words))
                pos = c - g
                take = (p[0] < 0) & (pos < CHUNK)
                k, low = pos[take] >> 5, (np.uint64(1) << (pos[take] & 31).astype(np.uint64))
                for s, w in enumerate(words):
                    pre, tot = _prefix(w)
                    p[s, take] = run[s] + pre[k] + np.bitwise_count(
                        w[k].astype(np.uint64) & (low - np.uint64(1)))
                    run[s] += tot
                stats["chunks"] += 1
            for s in range(ns):
                p[s, p[s] < 0] = run[s]  # c[i] == w1 past the last chunk: the total
            d = p[:, 1:] - p[:, :-1]
            out[:n_tr] = d[:n_tr]
            out[n_tr] = d[ns - 1] if n_tr else np.minimum(c[1:], nvp) - np.minimum(c[:-1], nvp)
            yield b, t0, n, out


def _m7_model(slots, tslots, off, n_spans, row0, nt, stats):
    counts = np.zeros((slots.shape[0], len(tslots) + 1, nt), np.int64)
    for b, t0, n, out in _tile_counts(slots, tslots, off, n_spans, row0, nt, stats):
        counts[b, :, t0:t0 + n] = out
    return counts


def _by_value(code):
    """tt_search_finish's program: (operations, trace conditions) by value
    with each C_COND's argument its index among them, or None where the
    program is past PROG operations or TC conditions (read as it is)."""
    ops, tc = [], []
    for op, arg in zip(code[0::2].tolist(), code[1::2].tolist()):
        if op == F.C_COND:
            if arg not in tc:
                tc.append(arg)
            arg = tc.index(arg)
        ops.append((op, arg))
    return (ops, tc) if len(ops) <= PROG and len(tc) <= TC else None


def _trace_model(code, case_ops, cols, tables, leaf, union, bl, nt, stats):
    """M8 over 4 consecutive traces a thread: leaf(b, arg, tr0, nq) the
    tracify bits of slot arg, union (Bl, nt) the union counts -> (tm,
    cnt) (Bl, nt)."""
    ints, floats = case_ops
    byval = _by_value(code)
    stats["long"] += byval is None
    ops = byval[0] if byval else list(zip(code[0::2].tolist(), code[1::2].tolist()))
    cond_of = (lambda a: byval[1][a]) if byval else (lambda a: a)
    tm = np.zeros((bl, nt), bool)
    for b in range(bl):
        for tr0 in range(0, nt, 4):
            nq = min(4, nt - tr0)
            st = []  # a stack of 4-bit entries, bit q the trace tr0 + q
            for op, arg in ops:
                if op in (F.C_AND, F.C_OR):
                    y, x = st.pop(), st.pop()
                    st.append(x & y if op == F.C_AND else x | y)
                elif op == F.C_TRACIFY:
                    st.append(leaf(b, arg, tr0, nq))
                elif op == F.C_COND:
                    i = cond_of(arg)
                    c = CONDS[i]
                    x = torch.from_numpy(cols[c.col][b:b + 1, tr0:tr0 + nq])
                    hit = F._cmp_b(c.op, x, torch.from_numpy(ints[b:b + 1]),
                                   torch.from_numpy(floats[b:b + 1]), i, c.is_float,
                                   torch.from_numpy(tables[i][b:b + 1]) if i in tables else None)
                    st.append(int(sum(int(h) << q for q, h in enumerate(hit[0].tolist()))))
                else:
                    st.append(0xF if op == F.C_TRUE else 0)
            m = st[-1] & ((1 << nq) - 1)
            tm[b, tr0:tr0 + nq] = [(m >> q) & 1 for q in range(nq)]
            stats["groups"] += 1
    return tm, np.where(tm, union, 0)


def _m8_model(code, case, counts, stats):
    bl, n_c, nt = counts.shape

    def leaf(b, arg, tr0, nq):
        return sum(int(counts[b, arg, tr0 + q] > 0) << q for q in range(nq))

    return _trace_model(code, (case["ints"], case["floats"]), case["cols"], case["tables"], leaf,
                        counts[:, -1], bl, nt, stats)


def _fused_model(code, case, slots, tslots, nt, stats):
    """The fused route at sp = 1: each tile's counts (never stored whole)
    feed M8's program, tracify bits a trace and the union's count."""
    bl = slots.shape[0]
    bits = np.zeros((bl, nt), np.int64)  # bit s: slot s's count > 0
    union = np.zeros((bl, nt), np.int64)
    for b, t0, n, out in _tile_counts(slots, tslots, case["span_off"], case["n_spans"], 0, nt,
                                      stats):
        for s in range(len(tslots)):
            bits[b, t0:t0 + n] |= (out[s] > 0).astype(np.int64) << s
        union[b, t0:t0 + n] = out[-1]

    def leaf(b, arg, tr0, nq):
        return sum(int(bits[b, tr0 + q] >> arg & 1) << q for q in range(nq))

    return _trace_model(code, (case["ints"], case["floats"]), case["cols"], case["tables"], leaf,
                        union, bl, nt, stats)


# -- the reference's arithmetic, in jnp


def _counts_ref(slots, tslots, off, n_spans, row0, nt):
    """seg_reduce of each tracify slot and of their union (the valid rows
    without one) on one shard: (Bl, n_tr + 1, nt)."""
    bl, _, sl = slots.shape
    masks = [slots[:, s] != 0 for s in tslots]
    union = (np.logical_or.reduce(masks) if masks
             else np.arange(sl)[None] + row0 < n_spans[:, None])
    return np.stack([_seg_ref(m, off, None, row0, nt) for m in masks + [union]], axis=1)


def _ev_trace_ref(tree, case, tr_counts):
    """ev_trace on the tree in jnp: a tracify leaf is its summed count > 0
    (tracify leaves in the tree's order), a trace condition compares its
    block's column with that block's operands."""
    cols, ints, tables = case["cols"], case["ints"], case["tables"]
    k = iter(range(len(tr_counts)))

    def ev(t):
        if t[0] == "tracify":
            return jnp.asarray(tr_counts[next(k)]) > 0
        if t[0] == "cond":
            c = CONDS[t[1]]
            x = jnp.asarray(cols[c.col])
            if c.op == "ge":
                return x >= jnp.asarray(ints[:, t[1], 1:2])
            tab = jnp.asarray(tables[t[1]])
            return (jnp.take_along_axis(tab, jnp.clip(x, 0, tab.shape[1] - 1), 1) > 0) & (x >= 0)
        ms = [ev(ch) for ch in t[1:]]
        out = ms[0]
        for m in ms[1:]:
            out = (out & m) if t[0] == "and" else (out | m)
        return out

    return np.asarray(ev(tree))


def _program(name):
    tree = F.normalize_tree(SEARCH_TREES[name], CONDS)
    return tree, F._program(tree, CONDS, sharded=True)


def _plain_finish(prog, case, counts):
    cols = {n: torch.from_numpy(a) for n, a in case["cols"].items()}
    tm, cnt = MS._search_finish_plain(prog.trace_code, CONDS, cols, torch.from_numpy(case["ints"]),
                                      torch.from_numpy(case["floats"]),
                                      {i: torch.from_numpy(t) for i, t in case["tables"].items()},
                                      torch.from_numpy(counts.astype(np.int32)))
    return tm.numpy(), cnt.numpy()


def _stats():
    return dict.fromkeys(("mono", "walk", "chunks", "vec", "byte", "odd", "long", "groups"), 0)


# -- tests


def test_tile_constants_match_the_kernel():
    src = open(os.path.join(kernels.CSRC, "meshsearch.cu")).read()
    d = {k: int(v) for k, v in re.findall(r"#define (ST_\w+) (\d+)", src)}
    assert (d["ST_THREADS"], d["ST_OWN"], d["ST_VEC"], d["ST_STREAMS"], d["ST_TR"], d["ST_PROG"],
            d["ST_TC"]) == (THREADS, OWN, VEC, STREAMS, TR, PROG, TC)
    assert kernels.FUSED_MAX_TR == TR


def test_byte_test_matches_every_byte():
    """_nz4 (the kernel's nz4) on every byte value in every position."""
    v = np.arange(256, dtype=np.uint32)
    for k in range(4):
        got = _nz4(v << (8 * k) | np.uint32(0))
        np.testing.assert_array_equal(got, (v != 0).astype(np.uint32) << k)
    w = np.random.default_rng(1).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    want = sum(((w >> (8 * k)) & 0xFF != 0).astype(np.uint32) << k for k in range(4))
    np.testing.assert_array_equal(_nz4(w), want)


def _check_m7(case, tslots, sp, stats, nt=None):
    """Model, reference and plain version on every shard of sp; the shards'
    sum against the whole block's counts."""
    slots, off, n_spans = case["slots"], case["span_off"], case["n_spans"]
    nt = off.shape[1] - 1 if nt is None else nt
    sl = slots.shape[2] // sp
    total = 0
    for k in range(sp):
        part = np.ascontiguousarray(slots[:, :, k * sl:(k + 1) * sl])
        got = _m7_model(part, tslots, off, n_spans, k * sl, nt, stats)
        want = _counts_ref(part, tslots, off, n_spans, k * sl, nt)
        np.testing.assert_array_equal(got, want)
        plain = MS._search_partial_plain(torch.from_numpy(part), tslots, torch.from_numpy(off),
                                         None, torch.from_numpy(n_spans), k * sl, nt).numpy()
        np.testing.assert_array_equal(plain, want)
        total = total + got
    return total


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("tslots", [[], [1], [0, 2, 3]], ids=["n_tr0", "n_tr1", "n_tr3"])
def test_m7_model_matches_reference(sp, tslots):
    case = search_case(30 + sp)
    stats = _stats()
    total = _check_m7(case, tslots, sp, stats)
    whole = _counts_ref(case["slots"], tslots, case["span_off"], case["n_spans"], 0,
                        case["span_off"].shape[1] - 1)
    np.testing.assert_array_equal(total, whole)  # the psum over sp stitches the cuts
    assert whole[:, -1].max() > 0 and (whole[:, -1] == 0).any()  # not vacuous
    assert stats["walk"] == 0 and stats["mono"] == 2 * 3 * sp and stats["odd"] > 0
    if tslots:  # 16-byte loads, and a byte a row at windows that start on an odd row
        assert stats["vec"] > 0 and stats["byte"] > 0


@pytest.mark.parametrize("sp", SPS)
def test_m7_model_hostile_offsets(sp):
    """Block 1's first tile is not monotone (a falling offset, one below 0
    and one past S): it walks its traces, signs kept; every other tile
    stays on the tile route. A tree of 4 tracify slots walks them all."""
    case = search_case(7, hostile=True)
    stats = _stats()
    for tslots in ([], [2], [0, 1, 3]):
        _check_m7(case, tslots, sp, stats)
    assert stats["walk"] > 0 and stats["mono"] > 0
    got = _m7_model(case["slots"], [2], case["span_off"], case["n_spans"], 0, 1203, stats)
    assert got.min() < 0  # the falling range counts negative, as ecs[hi] - ecs[lo]
    stats = _stats()
    _check_m7(case, [0, 1, 2, 3], sp, stats)
    assert stats["mono"] == 0 and stats["walk"] == 2 * 3 * sp


@pytest.mark.parametrize("shape", ["empty_tile", "long_trace", "unaligned", "ragged"])
def test_m7_model_edges(shape):
    """A tile of empty traces (an empty window), a trace of 40,000 rows
    (a window of several chunks), shards of rows that are not 16-byte
    aligned (no 16-byte load), and a last tile of one trace."""
    stats = _stats()
    if shape == "empty_tile":
        case = search_case(3, empty_tile=True)
        _check_m7(case, [0, 3], 2, stats)
    elif shape == "long_trace":
        case = search_case(4, S=1 << 16, big=40_000)
        assert np.diff(case["span_off"][0])[700] == 40_000
        for sp in (1, 2):
            _check_m7(case, [1], sp, stats)
        assert stats["chunks"] > stats["mono"] + 2
    elif shape == "unaligned":
        case = search_case(5, S=8200)
        _check_m7(case, [0, 1], 2, stats)  # 4,100 rows a shard
        assert stats["vec"] == 0 and stats["byte"] > 0
    else:
        case = search_case(6, nt=TILE + 1)
        _check_m7(case, [2], 1, stats)
        assert stats["mono"] == 4


@pytest.mark.parametrize("name", list(SEARCH_TREES))
def test_m8_model_matches_reference(name):
    """M8 over summed-looking counts (the shards' sums: any int, negative
    ones too), 4 traces a thread, over a ragged last group: the program
    by value or, past 64 operations or 16 conditions, read as it is."""
    case = search_case(50)
    tree, prog = _program(name)
    rng = np.random.default_rng(9)
    nt = case["span_off"].shape[1] - 1
    counts = rng.integers(-1, 3, (2, len(prog.tslots) + 1, nt))
    stats = _stats()
    tm, cnt = _m8_model(prog.trace_code, case, counts, stats)
    want = _ev_trace_ref(tree, case, [counts[:, k] for k in range(len(prog.tslots))])
    np.testing.assert_array_equal(tm, want)
    np.testing.assert_array_equal(cnt, np.where(want, counts[:, -1], 0))
    np.testing.assert_array_equal(_plain_finish(prog, case, counts)[0], want)
    assert want.any() and not want.all()
    assert stats["long"] == (name in ("long_program", "many_conditions"))
    assert stats["groups"] == 2 * -(-nt // 4) and nt % 4  # a ragged last group


@pytest.mark.parametrize("name", ["n_tr0", "n_tr1", "n_tr3", "long_program"])
def test_fused_model_matches_reference(name):
    """The fused route on a one-rank shard equals the reference's
    seg_reduce and ev_trace on the whole block, and M7 then M8: grouped
    offsets, then hostile ones (a tile that walks its traces)."""
    tree, prog = _program(name)
    tslots = prog.tslots
    for hostile in (False, True):
        case = search_case(60, hostile=hostile)
        nt = case["span_off"].shape[1] - 1
        stats = _stats()
        tm, cnt = _fused_model(prog.trace_code, case, case["slots"], tslots, nt, stats)
        ref = _counts_ref(case["slots"], tslots, case["span_off"], case["n_spans"], 0, nt)
        want = _ev_trace_ref(tree, case, [ref[:, k] for k in range(len(tslots))])
        np.testing.assert_array_equal(tm, want)
        np.testing.assert_array_equal(cnt, np.where(want, ref[:, -1], 0))
        m7 = _m7_model(case["slots"], tslots, case["span_off"], case["n_spans"], 0, nt, stats)
        np.testing.assert_array_equal(_m8_model(prog.trace_code, case, m7, stats)[1], cnt)
        assert want.any() and not want.all()
        assert (stats["walk"] > 0) == hostile


def test_search_local_fuses_where_sp_is_one(monkeypatch):
    """search_local takes partial_finish (one launch on a card) on a mesh
    whose sp axis is one rank, and never the all_reduce over sp."""
    from tempo_tpu_torch.parallel import make_mesh
    from tempo_tpu_torch.parallel.search import _stack_operands, search_static

    case = search_case(70)
    tree, prog = _program("n_tr1")
    calls = []
    fin, part = MS.ShardSearch.partial_finish, MS.ShardSearch.partial
    monkeypatch.setattr(MS.ShardSearch, "partial_finish",
                        lambda self: calls.append("fused") or fin(self))
    monkeypatch.setattr(MS.ShardSearch, "partial", lambda self: calls.append("m7") or part(self))
    mesh = make_mesh(device="cpu")
    monkeypatch.setattr(mesh, "all_reduce", lambda *a, **k: calls.append("all_reduce"))
    cols = {n: torch.from_numpy(a) for n, a in case["cols"].items()}
    cols["trace.span_off"] = torch.from_numpy(case["span_off"])
    ints, floats, tabs = _stack_operands(
        [F.Operands(case["ints"][b], case["floats"][b], {4: case["tables"][4][b]})
         for b in range(2)], 2, len(CONDS))
    ops = {"ops_i": torch.from_numpy(ints), "ops_f": torch.from_numpy(floats),
           "table.4": torch.from_numpy(tabs[4]), **cols}
    static = search_static(tree, CONDS, tuple(sorted(cols)), case["n_spans"],
                           case["span_off"].shape[1] - 1, (4,), True)
    tm, cnt = search_local(mesh, static, ops)
    assert calls == ["fused", "m7"]  # on the CPU partial_finish is M7, then M8
    assert tm.any()
