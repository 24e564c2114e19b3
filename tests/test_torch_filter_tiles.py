"""K1's trace-tile route and B8b's tile route on the CPU: their plans
(kernels.filter_plan over ops/filter.trace_tiles, kernels.edge_plan), and
each design's decomposition held against the JAX package.

The card's trace-tile route (csrc/filter.cu filter_tile_kernel) runs a
whole filter program a tile of whole traces at a time: span steps into
bit slots, struct steps on the tile's own parent rows (`>>` by pointer
doubling, `~` by per-parent counts), the block-wide `~` orphan flag from a
first pass over every tile, then the trace program over the tile's
traces. `_tile_model` below runs that decomposition in torch, step by step
from the compiled program's step table, with trace_tiles' tiles and
filter_plan's pass count, and the result is held bit for bit against
tempo_tpu's jitted filter program on the same numpy columns. B8b's tile
route (csrc/reduce.cu edge_tile_kernel) gives each CTA a range of edge
ids; `_edge_tiles` folds range by range. The kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py,
tests/test_torch_cuda_generator.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_cases as TC
import torch

from tempo_tpu.ops import filter as RF
from tempo_tpu.ops import reduce as RR
from tempo_tpu_torch import kernels
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import build_block_from_traces, open_block
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops.device import bucket, pad_rows
from tempo_tpu_torch.services.generator import LATENCY_BUCKETS
from tempo_tpu_torch.traceql.plan import plan_search_request
from tempo_tpu_torch.util.synth import synth_block
from tempo_tpu_torch.util.testdata import make_traces

# chip_smoke.py's K1_QUERIES and the two extra SEARCH_QUERIES forms
FORMS = [
    '{ span.http.status_code = 500 && kind = server }',
    '{ resource.service.name = "svc-007" }',
    '{ span.attr.key005 = "value-00042" }',
    '{ resource.attr.key000 =~ "value-00[0-4].*" }',
    '{ name =~ "op-00[0-3].*" }',
    '{ kind = server } > { status = error }',
    '{ name = "op-0001" } >> { kind = client }',
    '{ kind = producer } ~ { kind = consumer }',
    '{ duration > 500ms && duration < 600ms }',
    '{ status = error } || { span.http.status_code = 404 }',
]
EDGES = np.asarray(LATENCY_BUCKETS, np.float32)


def _shapes(staged):
    return (staged.n_spans, staged.n_traces, staged.n_spans_b, staged.n_res_b, staged.n_traces_b)


def _np_cols(staged):
    return {k: v.numpy() for k, v in staged.cols.items()}


def _retile(staged, tile):
    c = staged.cols
    return F.trace_tiles(c["trace.span_off"].numpy(),
                         c["span.parent_idx"].numpy() if "span.parent_idx" in c else None,
                         c["span.trace_sid"].numpy(), staged.n_spans, tile)


def _tile_model(tree, conds, staged, operands, tables, span_out, tiles):
    """K1's trace-tile route in torch: filter_tile_kernel's steps, tile by
    tile, over the leaves of cond.cuh (F._cond_mask, which both routes
    share), after a flag pass where filter_plan asks for one."""
    cols = staged.cols
    ns, nt, nsb, nrb, ntb = _shapes(staged)
    prog = F._program(tree, tuple(conds))
    plan = kernels.filter_plan(prog, tiles, span_out)
    assert plan.tiled
    ops_i = torch.from_numpy(np.ascontiguousarray(operands.ints, np.int32))
    ops_f = torch.from_numpy(np.ascontiguousarray(operands.floats, np.float32))
    ttab = {i: torch.from_numpy(pad_rows(np.asarray(t, np.uint8), bucket(max(1, len(t))), 0))
            for i, t in (tables or {}).items()}
    valid = torch.arange(nsb) < ns
    steps = prog.code(prog.steps_off).reshape(-1, F.SW).tolist()
    off = torch.clamp(cols["trace.span_off"].long(), max=ns)
    pidx = cols.get("span.parent_idx")
    bounds = tiles.bounds.tolist()
    tcode = prog.code(prog.trace_off).tolist()

    def postfix(code, leaf):
        st = []
        for op, arg in zip(code[0::2], code[1::2]):
            if op in (F.C_AND, F.C_OR):
                b, a = st.pop(), st.pop()
                st.append((a & b) if op == F.C_AND else (a | b))
            else:
                st.append(leaf(op, arg))
        return st[-1]

    def run(t0, t1, n_run, flags, flag_pass):
        s0, s1 = int(off[t0]), int(off[t1])
        n = s1 - s0
        pl = torch.full((n,), -1, dtype=torch.int64)
        if pidx is not None:
            p = pidx[s0:s1].long()
            pl = torch.where(p >= 0, p - s0, torch.where(p == -2, -2, -1))
        has, safe = pl >= 0, pl.clamp(min=0)
        slots, tflags = {}, 0

        def span_leaf(op, arg):
            if op == F.C_COND:
                return F._cond_mask(conds[arg], arg, cols, ops_i, ops_f, ttab, nsb, nrb,
                                    valid)[s0:s1]
            if op == F.C_MASK:
                return slots[arg]
            return torch.full((n,), op == F.C_TRUE)

        for kind, a, b, c, d in steps[:n_run]:
            if kind == F.S_SPAN:
                slots[c] = postfix(prog.code(a).tolist(), span_leaf)
                continue
            lm, rm = slots[a], slots[b]
            if kind == F.S_CHILD:
                out = rm & has & lm[safe]
            elif kind == F.S_DESC:
                acc, ptr = has & lm[safe], torch.where(has, pl, -1)
                for _ in range(plan.n_passes):
                    alive, ps = ptr >= 0, ptr.clamp(min=0)
                    acc, ptr = acc | (alive & acc[ps]), torch.where(alive, ptr[ps], -1)
                    if not alive.any():
                        break
                out = rm & acc
            else:
                lh = lm & has
                cnt = torch.zeros(n, dtype=torch.int64).index_add_(
                    0, safe[lh], torch.ones(int(lh.sum()), dtype=torch.int64))
                if flag_pass and bool((lm & (pl == -2)).any()):
                    tflags |= 1 << d
                orphan_rule = not flag_pass and bool(flags >> d & 1)
                out = rm & ((has & (cnt[safe] - lh.long() > 0)) | ((pl == -2) & orphan_rule))
            slots[c] = out
        return slots, tflags

    flags = 0
    if plan.flag_pass:
        for t0, t1 in zip(bounds[:-1], bounds[1:]):
            flags |= run(t0, t1, prog.last_sib + 1, 0, True)[1]
    trace_mask = torch.zeros(ntb, dtype=torch.bool)
    counts = torch.zeros(ntb, dtype=torch.int32)
    span_mask = torch.zeros(nsb, dtype=torch.bool)
    for t0, t1 in zip(bounds[:-1], bounds[1:]):
        slots, _ = run(t0, t1, len(steps), flags, False)
        s0, s1 = int(off[t0]), int(off[t1])
        lo, hi = off[t0:t1] - s0, off[t0 + 1:t1 + 1] - s0

        def seg_count(m):
            ecs = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(m.long(), 0)])
            return ecs[hi] - ecs[lo]

        def trace_leaf(op, arg):
            if op == F.C_TRACIFY:
                return seg_count(slots[prog.tslots[arg]]) > 0
            if op == F.C_COND:
                c = conds[arg]
                return F._cmp(c.op, cols[c.col], ops_i[arg, 1], ops_i[arg, 2], ops_f[arg, 0],
                              ops_f[arg, 1], c.is_float, ttab.get(arg))[t0:t1]
            return torch.full((t1 - t0,), op == F.C_TRUE)

        tm = postfix(tcode, trace_leaf) & (torch.arange(t0, t1) < nt)
        union = torch.ones(s1 - s0, dtype=torch.bool)
        if prog.tslots:
            union = torch.stack([slots[j] for j in prog.tslots]).any(dim=0)
        trace_mask[t0:t1] = tm
        counts[t0:t1] = torch.where(tm, seg_count(union), 0).to(torch.int32)
        span_mask[s0:s1] = union & tm.repeat_interleave(hi - lo)
    return (span_mask, trace_mask, counts) if span_out else (trace_mask, counts)


def _jax(tree, conds, staged, rows, tables, span_out):
    rconds = tuple(RF.Cond(c.target, c.col, c.op, is_float=c.is_float) for c in conds)
    return [np.asarray(w) for w in RF.eval_block(
        (tree, rconds), _np_cols(staged), RF.Operands.build(rows, tables or None),
        *_shapes(staged), span_out=span_out)]


def _check(tree, conds, staged, rows, tables, tiles, span_outs=(False, True)):
    """The tile model equals the JAX program; returns its trace mask."""
    tree = F.normalize_tree(tree, conds) if tree is not None else None
    for span_out in span_outs:
        got = _tile_model(tree, conds, staged, F.Operands.build(rows, tables or None), tables,
                          span_out, tiles)
        want = _jax(tree, conds, staged, rows, tables, span_out)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    return got[-2]


@pytest.fixture(scope="module")
def synth():
    """A 512-trace x 16-span synth block staged on the CPU (chain
    parents, all in-trace), and a forest of the same columns: a random
    tree per trace with 5 % orphans (chip_smoke.py's sibling form)."""
    backend = MemBackend()
    meta, _ = synth_block(backend, "t", np.random.default_rng(7), 512, 16, n_res=64, codec="gzip")
    blk = open_block(backend, "t", meta.block_id)
    # the span.attr form at a value this small block holds (the corpus's
    # value-00042 is in no row here)
    keys, vals = blk.pack.read("sattr.key_id"), blk.pack.read("sattr.str_id")
    val = blk.dictionary.strings[vals[keys == blk.dictionary.lookup("attr.key005")][0]]
    forms = [q.replace("value-00042", val) for q in FORMS]
    plans = [plan_search_request(blk.dictionary, {}, query=q) for q in forms]
    needed = sorted({n for p in plans for n in F.required_columns(p.conds) + list(p.extra_cols)})
    staged = ST.stage_block(blk, needed, cache=False, device="cpu")
    cols = _np_cols(staged)
    rng = np.random.default_rng(13)
    ns, off = staged.n_spans, cols["trace.span_off"].astype(np.int64)
    pos = np.arange(ns)
    lo = off[cols["span.trace_sid"][:ns]]
    par = lo + np.floor(rng.random(ns) * (pos - lo)).astype(np.int64)
    par = np.where(rng.random(ns) < 0.05, -2, par)
    cols["span.parent_idx"][:ns] = np.where(pos == lo, -1, par)
    forest = ST.staged_from_numpy(cols, ns, staged.n_traces, staged.n_res, "cpu")
    return plans, staged, forest


@pytest.mark.parametrize("form", range(len(FORMS)))
def test_tile_model_equals_jax_on_search_forms(synth, form):
    """Each search form over 16 tiles of 512 spans; the sibling form on
    the forest (orphans in many tiles: the flag pass decides)."""
    plans, staged, forest = synth
    p = plans[form]
    assert not p.prune
    st = forest if "~" in FORMS[form] else staged
    tiles = _retile(st, 512)
    assert tiles.bounds.shape[0] - 1 == 16 and tiles.parents_local and tiles.tsid_local
    tm = _check(p.tree, p.conds, st, p.rows, p.tables, tiles)
    assert tm.any(), FORMS[form]


def test_filter_cases_through_the_tile_model():
    """Every op, target and tree shape of test_torch_cases on tiles of 128
    spans (12 tiles; make_cols' parents lie in their traces, with 10 %
    orphans), both outputs."""
    for case, (specs, tree, rows, tables) in sorted(TC.filter_cases().items()):
        conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
        staged = ST.staged_from_numpy(TC.make_cols(seed=len(case)), TC.N_SPANS, TC.N_TRACES,
                                      TC.N_RES, "cpu")
        _check(tree, conds, staged, rows, tables, _retile(staged, 128))


def test_cross_trace_orphans_need_the_block_wide_flag():
    """One lhs orphan in the first tile makes rhs orphans in the last tile
    match (`~`'s block-wide rule): the flag pass carries it across tiles,
    and without it those traces would not match."""
    cols = TC.make_cols(seed=3)
    ns = TC.N_SPANS
    p = cols["span.parent_idx"]
    kind = cols["span.kind"]
    off = cols["trace.span_off"]
    kind[:ns] = 1
    p[:ns] = np.where(p[:ns] == -2, -1, p[:ns])  # no orphan but the two below
    first, last = int(off[1]) - 1, int(off[TC.N_TRACES - 1])
    p[first], kind[first] = -2, 2  # the lhs orphan, in trace 0
    p[last + 1:int(off[TC.N_TRACES])] = -2  # rhs orphans, in the last trace
    kind[last + 1:int(off[TC.N_TRACES])] = 3
    staged = ST.staged_from_numpy(cols, ns, TC.N_TRACES, TC.N_RES, "cpu")
    tiles = _retile(staged, 128)
    conds = (F.Cond("span", "span.kind", "eq"), F.Cond("span", "span.kind", "eq"))
    tree = ("tracify", ("struct", "~", ("cond", 0), ("cond", 1)))
    rows = [(0, 2, 0, 0.0, 0.0), (0, 3, 0, 0.0, 0.0)]
    prog = F._program(F.normalize_tree(tree, conds), conds)
    assert kernels.filter_plan(prog, tiles, False).flag_pass and tiles.bounds.shape[0] > 3
    tm = _check(tree, conds, staged, rows, None, tiles)
    assert tm[TC.N_TRACES - 1] and int(tm.sum()) == 1


def test_a_trace_longer_than_the_tile():
    """A 700-span trace: a tile of 512 cannot hold it (bounds None, the
    multi-launch route); 1,024 can, and the model equals JAX there; the
    default tile grows to the longest trace up to FILTER_TILE_MAX."""
    cols = TC.make_cols(seed=5)
    ns, off = TC.N_SPANS, cols["trace.span_off"]
    off[1:TC.N_TRACES] = np.maximum(off[1:TC.N_TRACES], 700)
    cols["span.trace_sid"][:ns] = np.repeat(np.arange(TC.N_TRACES), np.diff(off[:TC.N_TRACES + 1]))
    pos, lo = np.arange(ns), off[cols["span.trace_sid"][:ns]]
    cols["span.parent_idx"][:ns] = np.where(pos == lo, -1, pos - 1)  # a chain: 700 deep
    staged = ST.staged_from_numpy(cols, ns, TC.N_TRACES, TC.N_RES, "cpu")
    conds = (F.Cond("span", "span.kind", "eq"), F.Cond("span", "span.kind", "ge"))
    tree = ("tracify", ("struct", ">>", ("cond", 0), ("cond", 1)))
    prog = F._program(F.normalize_tree(tree, conds), conds)
    small = _retile(staged, 512)
    assert small.max_trace == 700 and small.bounds is None
    assert not kernels.filter_plan(prog, small, False).tiled
    assert staged.tiles.tile == kernels.FILTER_TILE and staged.tiles.bounds is not None
    tiles = _retile(staged, 1024)
    assert kernels.filter_plan(prog, tiles, False).n_passes == 10
    assert _check(tree, conds, staged, [(0, 1, 0, 0.0, 0.0), (0, 3, 0, 0.0, 0.0)], None,
                  tiles).any()
    off_long = np.asarray([0, 5000, 5000 + 20000], np.int32)
    assert F.trace_tiles(off_long, None, None, 5000).tile == 8192
    assert F.trace_tiles(off_long, None, None, 25000).bounds is None


def test_a_cross_trace_parent_routes_to_multi_launch():
    """One parent row outside its span's trace: struct programs take the
    multi-launch route, span-only programs stay on the tiles."""
    cols = TC.make_cols(seed=6)
    off = cols["trace.span_off"]
    cols["span.parent_idx"][int(off[5]) + 1] = int(off[9])
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    assert staged.tiles.parents_local is False
    for specs, tree, rows, tables in (TC.filter_cases()[c] for c in ("child", "op_eq")):
        conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
        prog = F._program(F.normalize_tree(tree, conds), conds)
        assert kernels.filter_plan(prog, staged.tiles, True).tiled == (not prog.struct_steps)


def test_group_range_staging():
    """span_base != 0: parent rows stay block-global (the plain version
    reads them as staged rows), so struct programs take the multi-launch
    route; span and trace programs tile, and the model equals JAX."""
    backend = MemBackend()
    meta = build_block_from_traces(backend, "t", make_traces(120, seed=5, n_spans=10),
                                   row_group_spans=256, device="cpu")
    blk = open_block(backend, "t", meta.block_id)
    conds = (F.Cond("span", "span.kind", "eq"), F.Cond("trace", "trace.dur_us", "gt"),
             F.Cond("sattr", "any", "exists"))
    needed = F.required_columns(conds) + ["span.parent_idx"]
    staged = ST.stage_block(blk, needed, groups=[1, 2], cache=False, device="cpu")
    assert staged.span_base == 256 and staged.tiles.parents_local is False
    tree = ("or", ("and", ("tracify", ("cond", 0)), ("cond", 1)), ("tracify", ("cond", 2)))
    rows = [(0, 2, 0, 0.0, 0.0), (0, 10_000, 0, 0.0, 0.0),
            (int(blk.dictionary.lookup("http.method")), 0, 0, 0.0, 0.0)]
    assert _check(tree, conds, staged, rows, None, _retile(staged, 128)).any()
    child = (F.Cond("span", "span.kind", "eq"), F.Cond("span", "span.kind", "eq"))
    prog = F._program(("tracify", ("struct", ">", ("cond", 0), ("cond", 1))), child)
    assert not kernels.filter_plan(prog, staged.tiles, False).tiled


def test_filter_plan_rules():
    """What filter_plan reads: no tiles (a block built without them), a
    span mask with a disagreeing trace_sid, nested `~` where the block
    holds orphans, and a tile beyond the shared-memory budget."""
    cols = TC.make_cols(seed=8)
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    tiles = staged.tiles
    assert tiles.tsid_local and tiles.has_orphans and tiles.parents_local
    sib = (F.Cond("span", "span.kind", "eq"),) * 3
    flat = F._program(("tracify", ("struct", "~", ("cond", 0), ("cond", 1))), sib)
    nested = F._program(("tracify", ("struct", "~", ("struct", "~", ("cond", 0), ("cond", 1)),
                                     ("cond", 2))), sib)
    assert not kernels.filter_plan(flat, None, False).tiled
    plan = kernels.filter_plan(flat, tiles, False)
    assert plan.tiled and plan.flag_pass and flat.n_sib == 1 and not flat.sib_nested
    assert nested.sib_nested and not kernels.filter_plan(nested, tiles, False).tiled
    no_orphans = dataclasses.replace(tiles, has_orphans=False)
    assert kernels.filter_plan(nested, no_orphans, False) == kernels.FilterPlan(
        True, False, plan.n_passes, kernels.filter_tile_smem(nested, tiles.tile))
    cols["span.trace_sid"][0] = 7
    bad = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu").tiles
    assert kernels.filter_plan(flat, bad, False).tiled and not kernels.filter_plan(flat, bad, True).tiled
    many = F._program(("or",) + tuple(("tracify", ("cond", 0)) for _ in range(400)), sib[:1])
    wide = dataclasses.replace(tiles, tile=kernels.FILTER_TILE_MAX)
    assert kernels.filter_tile_smem(many, wide.tile) > kernels.FILTER_SMEM_MAX
    assert not kernels.filter_plan(many, wide, False).tiled
    assert ST.StagedBlock(1, 1, 1, 1024, 1024, 1024, 0).tiles is None


def test_staging_computes_the_tiles_once():
    """stage_block caches the tiles with the block's staged entry; the
    bounds ride the one upload and cover every trace."""
    backend = MemBackend()
    meta = build_block_from_traces(backend, "t", make_traces(60, seed=2, n_spans=12),
                                   device="cpu")
    blk = open_block(backend, "t", meta.block_id)
    needed = ["span.trace_sid", "trace.span_off", "span.parent_idx"]
    staged = ST.stage_block(blk, needed, device="cpu")
    assert ST.stage_block(blk, needed, device="cpu").tiles is staged.tiles
    b = staged.tiles.bounds.tolist()
    assert b[0] == 0 and b[-1] == staged.n_traces_b and staged.tiles.parents_local
    assert staged.tiles.max_trace == 12 and "\0tile bounds" not in staged.cols
    metrics = ST.stage_block(blk, ["span.trace_sid", "span.start_ms"], device="cpu")
    assert metrics.tiles is None  # no trace.span_off: the multi-launch route


# ------------------------------------------------------------------ B8b


def _edge_tiles(eid, cdur, sdur, failed, n_valid, n_ids):
    """edge_tile_kernel's decomposition: CTA c folds the rows whose id
    lies in its range [c per, (c + 1) per) into its cells, then writes the
    range into the packed layout."""
    nb = EDGES.shape[0] + 1
    plan = kernels.edge_plan(n_valid, n_ids, nb)
    e = torch.from_numpy(EDGES)
    t = [torch.from_numpy(a) for a in (eid, cdur, sdur, failed)]
    packed = torch.empty(n_ids * (4 + 2 * nb), dtype=torch.int32)
    views = kernels.edge_views(packed, n_ids, nb)
    for c in range(plan.ctas):
        lo = c * plan.per
        m = min(plan.per, n_ids - lo)
        rows = t[0][:n_valid]
        keep = (rows >= lo) & (rows < lo + m)
        k, cd, sd, f = (rows[keep] - lo).long(), t[1][:n_valid][keep], t[2][:n_valid][keep], \
            t[3][:n_valid][keep]
        bc = (~(cd[:, None] <= e[None, :])).sum(1)
        bs = (~(sd[:, None] <= e[None, :])).sum(1)
        views[0][lo:lo + m] = torch.bincount(k, minlength=m).to(torch.int32)
        views[1][lo:lo + m] = torch.zeros(m, dtype=torch.int32).index_add_(0, k, f)
        views[2][lo:lo + m] = torch.zeros(m).index_add_(0, k, cd)
        views[3][lo:lo + m] = torch.zeros(m).index_add_(0, k, sd)
        views[4][lo:lo + m] = torch.bincount(k * nb + bc, minlength=m * nb).view(m, nb)
        views[5][lo:lo + m] = torch.bincount(k * nb + bs, minlength=m * nb).view(m, nb)
    return [v.numpy() for v in views]


@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 305, 4096), (1024, 1000, 1024),
                                             (2048, 2048, 1 << 15), (1024, 0, 4096)])
def test_edge_tiles_equal_jax(n, n_valid, n_ids):
    """Dyadic durations (exact f32 sums in any order), ids outside
    [0, n_ids) dropped, NaN and edge-equal values bucketed as numpy."""
    rng = np.random.default_rng(n + n_valid + n_ids)
    eid = rng.integers(-3, n_ids + 3, n).astype(np.int32)
    cdur = (rng.integers(0, 64, n) * 0.125).astype(np.float32)
    sdur = (rng.integers(0, 64, n) * 0.125).astype(np.float32)
    cdur[::37] = np.nan
    sdur[5::41] = EDGES[3]
    failed = rng.integers(0, 3, n).astype(np.int32)
    got = _edge_tiles(eid, cdur, sdur, failed, n_valid, n_ids)
    want = RR._edge_reduce_kernel(jnp.asarray(eid), jnp.asarray(cdur), jnp.asarray(sdur),
                                  jnp.asarray(failed), jnp.int32(n_valid), jnp.asarray(EDGES),
                                  n_ids, len(EDGES) + 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_edge_plan_routes():
    """The tile route at the generator's window (a few hundred rows into
    4,096 ids: 128 CTAs of 32 ids); the atomic route once every CTA
    re-reading every row passes EDGE_TILE_READS; shared memory in budget
    at every bucket count up to REDUCE_MAX_EDGES."""
    nb = len(LATENCY_BUCKETS) + 1
    p = kernels.edge_plan(305, 4096, nb)
    assert p.tiled and p.per == 32 and p.ctas == 128
    assert not kernels.edge_plan(65536, 65536, nb).tiled
    for n_valid, n_ids in ((305, 4096), (1024, 65536), (8192, 4096), (65536, 4096)):
        q = kernels.edge_plan(n_valid, n_ids, nb)
        assert q.tiled == (q.ctas * n_valid <= kernels.EDGE_TILE_READS)
        assert q.ctas * q.per >= n_ids > (q.ctas - 1) * q.per
    for b in (2, nb, kernels.REDUCE_MAX_EDGES + 1):
        q = kernels.edge_plan(1024, 1 << 20, b)
        assert q.per >= 1 and q.smem <= kernels.REDUCE_SMEM


def test_edge_views_are_one_allocation():
    packed = torch.arange(1024 * 34, dtype=torch.int32)
    v = kernels.edge_views(packed, 1024, 15)
    assert [tuple(x.shape) for x in v] == [(1024,)] * 4 + [(1024, 15)] * 2
    assert [x.dtype for x in v] == [torch.int32] * 2 + [torch.float32] * 2 + [torch.int32] * 2
    assert all(x.untyped_storage().data_ptr() == packed.data_ptr() for x in v)
    assert int(v[5][-1, -1]) == 1024 * 34 - 1
