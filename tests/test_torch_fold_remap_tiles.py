"""M4's one cooperative launch over a rank's stacked blocks and B9a's
many-column remap, as numpy models of their kernels (csrc/timeseries.cu
ts_one_kernel<route, true>, csrc/blockcut.cu remap_kernel) held against
the JAX package, on the CPU.

M4: the grid walks the Bl x S rows of the stack, row r being span r % S
of block r / S, skipped past the block's span count; each route's
decomposition (the shared route's private grids reduced over a cluster
of 8 from each CTA's own slice on, the cluster route's owner slices, the
global grid) folds into encoded planes, min and max left in B6's
ordered-int32 encoding for the collective. Held against the port's plain
version bit for bit and, decoded, against
tempo_tpu.parallel.timeseries.make_sharded_timeseries on a one-device
CPU mesh: counts, value counts, min and max exact (NaN where one was
folded, -0.0 below +0.0), f32 sums within rtol 1e-5 and exact on dyadic
values. The inputs: tests/torch_tile_cases.stacked_case, shared with the
card tests.

B9a: a thread a quad of 4 codes from a multiple of 4, one 16-byte load
where the quad lies inside its segment and 16-byte aligned, code by code
where a segment's start or end cuts it; the table in shared memory or
read through L2. Held against the reference's remap_codes_device on
in-range codes, with the port's clamp of a code past the table pinned.
And a cut through BlockBuilder.finalize on the CPU gives the same
columns through the many-column route as through a call a column."""

import numpy as np
import pytest
import torch
from torch_tile_cases import (
    PAD_I32,
    REMAP_SEGMENTS,
    STACKED_G,
    STACKED_NB,
    STACKED_SPECS,
    STACKED_STEP,
    STACKED_TREE,
    remap_case,
    stacked_case,
)

from tempo_tpu.ops import blockcut as RB
from tempo_tpu.ops import filter as RF
from tempo_tpu.parallel import make_mesh as r_make_mesh
from tempo_tpu.parallel.timeseries import sharded_timeseries as r_sharded_ts
from tempo_tpu_torch import kernels
from tempo_tpu_torch.block.builder import BlockBuilder
from tempo_tpu_torch.ops import blockcut as BC
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops import timeseries as TS
from tempo_tpu_torch.util.testdata import make_traces

G, NB, STEP = STACKED_G, STACKED_NB, STACKED_STEP
CONDS = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in STACKED_SPECS)
RCONDS = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in STACKED_SPECS)
IDENT = (0, 0, 0, 0x7F800000, -2139095041)  # counts, vcnt, vsum, enc(+inf), enc(-inf)


# ------------------------------------------------------------------ M4
def _walk(case):
    """The rows of the stack as the kernel walks them: (ok, seg) of every
    row r = b S + l, the span program and bucketing of block b's
    operands, origin and row l (B6's semantics), kept only while l <
    n_spans[b]."""
    cols = {n: torch.from_numpy(a) for n, a in case["cols"].items()}
    bl, S = case["gid"].shape
    R, NT = cols["res.service_id"].shape[1], cols["trace.dur_ms"].shape[1]
    oks, segs = [], []
    for b in range(bl):
        cb = {n: t[b] for n, t in cols.items()}
        cb["span@res.service_id"] = ST.res_to_span(cb["res.service_id"], cb["span.res_idx"])
        ops = F.Operands.build(case["rows"][b])
        ok, seg = TS._ts_segments(STACKED_TREE, CONDS, cb, torch.from_numpy(ops.ints),
                                  torch.from_numpy(ops.floats), {},
                                  torch.from_numpy(case["gid"][b]), int(case["t0"][b]), STEP, S,
                                  NB, G, S, R, NT)
        oks.append(ok)
        segs.append(seg)
    r = torch.arange(bl * S)
    b, l = r // S, r % S
    keep = l < torch.from_numpy(case["n_spans"]).long()[b]
    return torch.cat(oks) & keep, torch.cat(segs)


def _enc(v: torch.Tensor, nan_wins: int) -> torch.Tensor:
    return torch.where(torch.isnan(v), torch.tensor(nan_wins, dtype=torch.int32), TS._ts_enc(v))


def _comb(p, x, y):
    if p == 2:
        return (x.view(torch.float32) + y.view(torch.float32)).view(torch.int32)
    return torch.minimum(x, y) if p == 3 else torch.maximum(x, y) if p == 4 else x + y


def _m4_model(ok, seg, pres, val, cells, plan, ctas):
    """ts_one_kernel<route, true>'s decomposition of the rows: shared, row
    r goes to the CTA of its grid-stride thread (TS_THREADS a CTA) and
    into its private grid; in each cluster CTA k reduces its slice of
    cells over the cluster's copies from its own on; each cluster's
    reduced grid adds into the output (its identity written first).
    cluster: the row's round chunk (TS_ROUND rows) picks its CTA, which
    files it with the owner of its cell in its cluster; the clusters'
    grids combine in order. global: one grid. Returns the A planes
    (cells,) int32, vsum as f32 bits, min and max still encoded."""
    n = ok.shape[0]
    s = torch.arange(n)
    c = plan.cluster
    ident = torch.tensor(IDENT, dtype=torch.int32)
    if plan.route == "global":
        cta, k_parts, per, slots = torch.zeros(n, dtype=torch.long), 1, cells, 1
    elif plan.route == "shared":
        cta = (s % (ctas * kernels.TS_THREADS)) // kernels.TS_THREADS
        k_parts, per, slots = ctas // c, cells, ctas
    else:
        cta = (s // kernels.TS_ROUND) % ctas
        k_parts, per, slots = ctas // c, plan.per, ctas
        cta = cta // c * c + seg.clamp(max=c * per - 1) // per  # the cell's owner in the cluster
    grids = ident[None, :, None].repeat(slots, 1, per)
    buf = grids.view(-1)
    at = cta * 5 * per + (seg if plan.route != "cluster" else seg % per)
    sp = ok & pres
    v = val[sp]
    buf.index_add_(0, at[ok], torch.ones(int(ok.sum()), dtype=torch.int32))
    buf.index_add_(0, at[sp] + per, torch.ones(v.shape[0], dtype=torch.int32))
    buf.view(torch.float32).index_add_(0, at[sp] + 2 * per, v)
    buf.scatter_reduce_(0, at[sp] + 3 * per, _enc(v, PAD_I32), "amin")
    buf.scatter_reduce_(0, at[sp] + 4 * per, _enc(v, 2**31 - 1), "amax")
    if plan.route == "global":
        parts = grids[:1]
    elif plan.route == "cluster":
        parts = grids.view(k_parts, c, 5, per).permute(0, 2, 1, 3).reshape(k_parts, 5, c * per)
    else:
        sl = -(-cells // c)
        parts = torch.empty((k_parts, 5, cells), dtype=torch.int32)
        for q in range(k_parts):
            for k in range(c):
                lo, hi = k * sl, min(cells, (k + 1) * sl)
                for p in range(5):
                    x = grids[q * c + k, p, lo:hi]
                    for t in range(1, c):
                        x = _comb(p, x, grids[q * c + (k + t) % c, p, lo:hi])
                    parts[q, p, lo:hi] = x
    out = ident[:, None].repeat(1, cells)  # the output's identity, then each part added in
    for j in range(k_parts):
        for p in range(5):
            out[p] = _comb(p, out[p], parts[j, p, :cells])
    return out


# (route, Bl, has_val, dyadic, S)
M4_CASES = [("shared", 1, True, True, 2048), ("shared", 3, True, False, 2048),
            ("shared", 10, False, True, 1024), ("cluster", 3, True, True, 2048),
            ("cluster", 10, True, False, 1024), ("global", 3, True, True, 2048),
            ("global", 1, False, True, 2048), ("shared", 40, True, True, 256)]


@pytest.mark.parametrize("route,bl,has_val,dyadic,S", M4_CASES)
def test_m4_walk_equals_jax(route, bl, has_val, dyadic, S):
    case = stacked_case(40 + bl, bl, S, has_val, dyadic)
    cells = G * NB
    plan = kernels.timeseries_route(route, cells, has_val)
    ctas = 2 * plan.cluster  # two clusters: two parts to merge
    ok, seg = _walk(case)
    pres = torch.from_numpy(case["pres"]).reshape(-1) if has_val else torch.zeros_like(ok)
    val = torch.from_numpy(case["val"]).reshape(-1) if has_val else torch.zeros(ok.shape[0])
    got = _m4_model(ok, seg, pres, val, cells, plan, ctas)
    # the port's plain version: the same planes, min and max encoded
    cols = {n: torch.from_numpy(a) for n, a in case["cols"].items()}
    cols["span@res.service_id"] = torch.stack([
        ST.res_to_span(cols["res.service_id"][b], cols["span.res_idx"][b]) for b in range(bl)])
    plain = TS._timeseries_stacked_plain(
        STACKED_TREE, CONDS, cols, [F.Operands.build(r) for r in case["rows"]],
        torch.from_numpy(case["gid"]), torch.from_numpy(case["val"]) if has_val else None,
        torch.from_numpy(case["pres"]) if has_val else None, case["t0"].tolist(),
        case["n_spans"].tolist(), STEP, NB, G)
    n_planes = 5 if has_val else 1
    for p in range(n_planes):
        w = plain[p].reshape(-1)
        if p == 2:
            w = w.view(torch.int32)
            if not dyadic:
                np.testing.assert_allclose(got[p].view(torch.float32).numpy(),
                                           w.view(torch.float32).numpy(), rtol=1e-5, atol=0)
                continue
        np.testing.assert_array_equal(got[p].numpy(), w.numpy(), err_msg=f"plane {p}")
    # the reference on a one-device mesh, min and max decoded
    want = r_sharded_ts(r_make_mesh(1), STACKED_TREE, RCONDS,
                        [RF.Operands.build(r) for r in case["rows"]], case["cols"],
                        case["n_spans"], case["t0"], case["gid"], case["val"], case["pres"],
                        STEP, NB, G)
    assert len(want) == n_planes and int(np.asarray(want[0]).sum()) > 0
    for p in range(n_planes):
        g = got[p]
        g = TS.ts_decode(g) if p >= 3 else g.view(torch.float32) if p == 2 else g
        g, w = g.numpy().reshape(G, NB), np.asarray(want[p])
        if p == 2 and not dyadic:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"output {p}")
    if has_val:
        mn = TS.ts_decode(got[3])
        assert torch.isnan(mn).any() and torch.isinf(TS.ts_decode(got[4])).any()
        # a -0.0 minimum stays below +0.0 in the encoding
        assert int(TS._ts_enc(torch.tensor([-0.0]))[0]) < int(TS._ts_enc(torch.tensor([0.0]))[0])


def test_m4_rows_skip_past_each_block_span_count():
    """Row r of the stack is span r % S of block r / S: blocks of 0 and S
    spans, one of 300, and the rows past each count never fold."""
    case = stacked_case(5, 4, 1024, has_val=False)
    case["gid"][:] = 0
    case["cols"]["span.dur_us"][:] = 39  # every span matches leaf 0
    case["cols"]["span.start_ms"][:] = case["t0"][:, None] + 5  # bucket 0
    ok, seg = _walk(case)
    assert case["n_spans"].tolist() == [924, 1024, 0, 300]
    per_block = ok.view(4, 1024).sum(dim=1).tolist()
    assert per_block == [924, 1024, 0, 300]
    assert not ok.view(4, 1024)[0, 924:].any() and not ok.view(4, 1024)[3, 300:].any()
    got = _m4_model(ok, seg, torch.zeros_like(ok), torch.zeros(ok.shape[0]), G * NB,
                    kernels.timeseries_plan(G * NB, False), 16)
    assert int(got[0][0]) == 924 + 1024 + 300 and int(got[0].sum()) == 2248


def test_m4_row_to_block_by_reciprocal():
    """The kernel's row-to-block split without a divide: b =
    umulhi(r, floor(2^32 / S)) (2^32 - 1 for S = 1), one short at most,
    corrected once; equal to divmod over every row count a launch takes
    (Bl x S < 2^31)."""
    rng = np.random.default_rng(7)
    for S in (1, 2, 3, 7, 256, 1000, 65_536, (1 << 20) + 1, 12_345_678, 2**31 - 1):
        inv = np.uint64((1 << 32) // S if S > 1 else 2**32 - 1)
        top = min((2**31 - 1) // S * S, 2**31 - 1)
        r = np.concatenate([rng.integers(0, top, 50_000), [0, S - 1, min(S, top - 1), top - 1]])
        r = r.astype(np.uint64)
        b = ((r * inv) >> np.uint64(32)).astype(np.int64)
        loc = r.astype(np.int64) - b * S
        fix = loc >= S
        b, loc = b + fix, loc - fix * S
        np.testing.assert_array_equal(b, r.astype(np.int64) // S, err_msg=f"S={S}")
        np.testing.assert_array_equal(loc, r.astype(np.int64) % S, err_msg=f"S={S}")


def test_bucket_floor_division_by_reciprocal():
    """B6's and M4's bucket without a divide (csrc/timeseries.cu ts_bucket):
    u = (start - t0) + 2^31 as unsigned, 2^31 = k step + m, the quotient
    (u - m) / step - k by the reciprocal floor(2^32 / step), corrected
    once, or -1 - k where u < m; equal to floor((start - t0) / step) with
    the int32 wrap of the subtraction, at the int32 ends too."""
    rng = np.random.default_rng(8)
    i32 = np.iinfo(np.int32)
    for step in (1, 2, 3, 7, 1000, 60_000, 60_001, 2**30 + 1, 2**31 - 2, 2**31 - 1):
        start = np.concatenate([rng.integers(i32.min, i32.max, 40_000, dtype=np.int64),
                                [i32.min, i32.max, 0, -1, 1, step, -step]]).astype(np.int64)
        t0 = np.concatenate([rng.integers(i32.min, i32.max, 40_000, dtype=np.int64),
                             [i32.max, i32.min, 0, 0, 0, 0, 0]]).astype(np.int64)
        diff = (start - t0 + 2**31) % 2**32 - 2**31  # the int32 wrap
        inv = (1 << 32) // step if step > 1 else 2**32 - 1
        k, m = (1 << 31) // step, (1 << 31) % step
        u = diff + 2**31
        v = np.maximum(u - m, 0).astype(np.uint64)  # 32-bit unsigned products in 64 bits
        q = ((v * np.uint64(inv)) >> np.uint64(32)).astype(np.int64)
        q = q + ((v.astype(np.int64) - q * step) >= step)
        got = np.where(u < m, -1 - k, q - k)
        np.testing.assert_array_equal(got, diff // step, err_msg=f"step={step}")


def test_stacked_program_is_one_buffer_with_the_block_table_at_its_end():
    """stacked_program's one upload: block b's program buffer at b x
    stride, its descriptors pointing at its row of each column, and the
    block table (descriptor address, origin, span count) after them, the
    same bytes as the host copy passed by value."""
    case = stacked_case(6, 3, 512)
    cols = {n: torch.from_numpy(a) for n, a in case["cols"].items()}
    cols["span@res.service_id"] = torch.stack([
        ST.res_to_span(cols["res.service_id"][b], cols["span.res_idx"][b]) for b in range(3)])
    operands = [F.Operands.build(r) for r in case["rows"]]
    prog, buf, blocks = TS.stacked_program((STACKED_TREE, CONDS), cols, operands, case["t0"],
                                           case["n_spans"])
    assert blocks.shape == (3, 4) and blocks.dtype == np.int32
    tail = buf[buf.shape[0] - 3 * kernels.TS_BLOCK:].numpy().view(np.int32).reshape(3, 4)
    np.testing.assert_array_equal(tail, blocks)
    np.testing.assert_array_equal(blocks[:, 2], case["t0"])
    np.testing.assert_array_equal(blocks[:, 3], case["n_spans"])
    addr = blocks.view(np.int64)[:, 0]
    stride = int(addr[1] - addr[0])
    assert stride > 0 and int(addr[2] - addr[1]) == stride and stride % 16 == 0
    assert int(addr[0]) == buf.data_ptr() + prog.desc_off
    base = buf.data_ptr()
    for b in range(3):
        d = buf[int(addr[b]) - base:].numpy()[: len(CONDS) * F.DW * 8].view(np.int64)
        d = d.reshape(len(CONDS), F.DW)
        assert int(d[0, F.D_COL]) == cols["span.dur_us"][b].data_ptr()
        assert int(d[2, F.D_COL]) == cols["trace.dur_ms"][b].data_ptr()
        assert int(d[0, F.D_V0]) == case["rows"][b][0][1]


# ------------------------------------------------------------------ B9a
def _remap_model(codes, offs, table, route, vec=True):
    """remap_kernel over the segments: the table as the route holds it (the
    shared route's copy: 16-byte chunks, then the r % 4 tail), a thread a
    quad, whole quads by one load and store, cut quads code by code; every
    code written exactly once."""
    r = table.shape[0]
    tab = table
    if route == "shared":
        tab = np.zeros(r, np.int32)
        tab[: r & ~3] = table[: r & ~3]
        tab[r & ~3:] = table[r & ~3:]
    out = np.zeros_like(codes)
    writes = np.zeros(codes.shape[0], np.int64)
    whole = 0

    def one(c):
        return np.where(c >= 0, tab[np.clip(c, 0, r - 1)], c)

    offs = kernels.remap_bounds(offs, codes.shape[0])
    for lo, hi in zip(offs, offs[1:]):
        if hi == lo:
            continue
        for e0 in range(lo & ~3, hi, 4):
            if vec and e0 >= lo and e0 + 4 <= hi:
                out[e0:e0 + 4] = one(codes[e0:e0 + 4])
                whole += 1
                writes[e0:e0 + 4] += 1
            else:
                a, b = max(e0, lo), min(e0 + 4, hi)
                out[a:b] = one(codes[a:b])
                writes[a:b] += 1
    assert (writes == 1).all()
    return out, whole


@pytest.mark.parametrize("route", ["shared", "l2"])
@pytest.mark.parametrize("case", sorted(REMAP_SEGMENTS))
def test_remap_many_model_equals_reference(case, route):
    lens, r = REMAP_SEGMENTS[case]
    codes, offs, table = remap_case(len(lens) + r, lens, r)
    got, whole = _remap_model(codes, offs, table, route)
    plain = BC._remap_many_plain(torch.from_numpy(codes), offs, torch.from_numpy(table))
    np.testing.assert_array_equal(got, plain.numpy())
    assert whole > 0 or codes.shape[0] < 8
    # unaligned: the same codes one to the right take the code-by-code path
    got_u, _ = _remap_model(codes, offs, table, route, vec=False)
    np.testing.assert_array_equal(got_u, got)
    for lo, hi in zip(offs, offs[1:]):  # the reference on each segment's in-range codes
        seg = codes[lo:hi]
        seg = seg[seg < r]
        if seg.size:
            np.testing.assert_array_equal(
                np.asarray(RB.remap_codes_device(seg, table)),
                np.where(seg >= 0, table[np.clip(seg, 0, r - 1)], seg))
            np.testing.assert_array_equal(RB.remap_codes_host(seg, table),
                                          BC._remap_plain(torch.from_numpy(seg),
                                                          torch.from_numpy(table)).numpy())


def test_remap_many_clamps_past_the_table_and_passes_negatives():
    """The port's clamp (a code past the table takes its last entry and
    never reads outside it) and negative codes passing through, segment
    by segment, as tests/test_torch_blockcut.py pins them for one column;
    bounds that do not rise from 0 to n are refused."""
    table = torch.tensor([7, 3, 5], dtype=torch.int32)
    codes = torch.tensor([2, -1, 0, PAD_I32, 1, 3, 99, 0], dtype=torch.int32)
    got = BC.remap_many(codes, [0, 5, 5, 8], table)
    assert got.tolist() == [5, -1, 7, PAD_I32, 3, 5, 5, 7]
    assert BC.remap_many(codes[:0], [0], table).tolist() == []
    for bad in ([1, 8], [0, 5, 3, 8], [0, 7]):
        with pytest.raises(ValueError):
            BC.remap_many(codes, bad, table)
    with pytest.raises(kernels.KernelError):
        kernels.remap_bounds([0, 9], 8)


def test_remap_plan_routes_and_bounds():
    """The shared route while the table fits REMAP_SMEM_MAX (49,152
    entries), else L2; past REMAP_SEGMENTS the bounds merge neighbours
    and keep every code in one segment."""
    assert kernels.remap_plan(5677) == kernels.remap_plan(49_152) == "shared"
    assert kernels.remap_plan(49_153) == "l2"
    offs = np.concatenate([[0], np.cumsum(np.arange(70))]).tolist()
    b = kernels.remap_bounds(offs, offs[-1])
    assert len(b) - 1 <= kernels.REMAP_SEGS and b[0] == 0 and b[-1] == offs[-1]
    assert set(b) <= set(offs) and b == sorted(b)
    assert kernels.remap_bounds([0, 0, 5], 5) == [0, 0, 5]


def test_cut_engine_remap_many_equals_a_call_a_column():
    lens, r = REMAP_SEGMENTS["cut_like"]
    codes, offs, table = remap_case(3, lens, r)
    cols = [codes[a:b] for a, b in zip(offs, offs[1:])]
    cols[1] = []  # a builder's list column, empty
    cols[3] = [int(x) for x in cols[3]]
    eng = BC.CutEngine("cpu")
    t = eng.table(table)
    got = eng.remap_many(cols, t)
    assert len(got) == len(cols)
    for g, c in zip(got, cols):
        w = eng.remap(c, t)
        assert g.dtype == w.dtype == np.int32 and g.tobytes() == w.tobytes()


def test_finalize_many_column_route_equals_a_call_a_column(monkeypatch):
    """BlockBuilder.finalize on the CPU: one remap_many call over its 29
    code columns, the finalized columns byte-equal to the same cut with a
    CutEngine.remap call a column."""
    traces = sorted(make_traces(60, seed=9, n_spans=6), key=lambda p: p[0])
    seen = []
    many = BC.CutEngine.remap_many

    def spy(self, cols, table):
        seen.append(len(cols))
        return many(self, cols, table)

    def per_column(self, cols, table):
        return [self.remap(c, table) for c in cols]

    fins = []
    for route in (spy, per_column):
        monkeypatch.setattr(BC.CutEngine, "remap_many", route)
        b = BlockBuilder("t", block_id="b" * 32, device="cpu")
        for tid, t in traces:
            b.add_trace(tid, t)
        fins.append(b.finalize())
    assert seen == [29]
    g, w = fins
    assert list(g.cols) == list(w.cols)
    for name in w.cols:
        assert g.cols[name].dtype == w.cols[name].dtype, name
        assert g.cols[name].tobytes() == w.cols[name].tobytes(), name
    assert g.dictionary.strings == w.dictionary.strings
