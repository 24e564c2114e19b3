"""The sharded search's CUDA kernels on the card against their plain
versions: M5 attr_partial (and its mask), M6 mask_pack on both routes and
K1's struct pass reading the packed mask (M6's unpack), M7
search_partial, M8 search_finish, and K1's span pass and struct kernels
on a shard (the `>` offset by the shard's first row), stage by stage on
the second of two sp shards of every case of tests/test_torch_mesh_search.py;
M7's tile and trace_sid routes, M8 and the fused route of both
(search_fused) over tests/torch_tile_cases.search_case's shapes and at
phase 15's; then the host entry on a one-rank card mesh against the CPU.

Marked `cuda`; the fixture below skips them where no card exists. Run on
a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is an int or a bool and compared exactly."""

import numpy as np
import pytest
import torch
from test_torch_mesh_search import CASES, _operands
from torch_tile_cases import (
    ATTR_SPECS,
    SEARCH_SPECS,
    SEARCH_TREES,
    attr_case,
    attr_shard,
    search_case,
)

from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS
from tempo_tpu_torch.parallel import make_mesh, sharded_search
from tempo_tpu_torch.parallel.search import _stack_operands

pytestmark = pytest.mark.cuda
INT_MIN = -(2**31)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _shard(case: str, dev, sp: int = 2, k: int = 1):
    """Shard k of sp (dp 1) of a case, as a rank receives it."""
    tree, specs, rows, tables, cols, n_spans, nt = CASES[case](np.random.default_rng(7))
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    if case.startswith("struct"):
        tree = ("struct", ">>", ("cond", 0), ("cond", 1))
    if tree is not None:
        tree = F.normalize_tree(tree, conds)
    B = cols["span.trace_sid"].shape[0]
    ints, floats, tabs = _stack_operands(_operands(F, rows, tables), B, len(conds))
    if not ints.shape[1]:
        ints, floats = np.zeros((B, 1, 3), np.int32), np.zeros((B, 1, 2), np.float32)
    local = {}
    for n, a in cols.items():
        if not n.endswith(".off") and n.startswith(("span.", "sattr.", "rattr.")):
            w = a.shape[1] // sp
            a = a[:, k * w:(k + 1) * w]
        local[n] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sh = MS.ShardSearch(tree, conds, local, ints, floats, tabs, n_spans.tolist(), k, nt)
    return sh, cols


def _eq(got, want, what):
    assert torch.equal(got.cpu(), want.cpu()), what


@pytest.mark.parametrize("case", list(CASES))
def test_shard_kernels_match_plain(cuda, case):
    sh, cols = _shard(case, cuda)
    assert sh.on_card
    for i in sorted(sh.prog.leaf_slots):  # M5 and its mask
        c = sh.conds[i]
        cnt = sh.attr_partial(i)
        arow0 = 0 if c.target == "res" else sh.sp_index * sh.cols[f"{c.target}.key_id"].shape[1]
        _eq(cnt, MS._attr_partial_plain(c, sh.cols, sh.ops_i, sh.ops_f, i, sh.tables.get(i),
                                        arow0), f"M5 leaf {i}")
        if c.target == "sattr":  # stand-in for the reduce-scatter: this shard's columns
            cnt = cnt[:, sh.row0:sh.row0 + sh.sl].contiguous()
        sh.attr_mask(i, cnt)
        res_idx = None if c.target == "sattr" else sh.cols["span.res_idx"]
        _eq(sh.slot(sh.prog.leaf_slots[i]) != 0,
            MS._attr_mask_plain(cnt, res_idx, sh.n_spans_t, sh.row0, sh.sl), f"M5 mask {i}")
    rng = np.random.default_rng(3)
    for step in sh.prog.steps:  # K1 on the shard
        if step[0] == "span":
            sh.span_step(step)
            want = F._span_step_plain(sh.prog.code(step[1]), sh.conds, sh.cols, sh.ops_i,
                                      sh.ops_f, sh.tables, sh.slots, sh.n_spans_t, sh.row0)
            _eq(sh.slot(step[3]) != 0, want, f"span step {step}")
            continue
        op, _, r, out = step[1:]
        S = 2 * sh.sl
        lm_g = torch.from_numpy(rng.random((sh.slots.shape[0], S)) < 0.5).to(cuda)
        local = sh.cols["span.parent_idx"]
        for kind in (">", op):  # the offset '>' always, then the node's own op
            pidx = local if kind == ">" else torch.cat([local - sh.sl, local], dim=1)
            sh.struct_step(("struct", kind, step[2], r, out), lm_g, pidx.contiguous())
            want = F._struct_step_plain(kind, lm_g, sh.slot(r) != 0, pidx, sh.n_spans_t, sh.row0)
            _eq(sh.slot(out) != 0, want, f"struct {kind}")
            sh.slot(out).fill_(7)  # the packed read must write every row again
            sh.struct_step(("struct", kind, step[2], r, out), kernels.mask_pack(lm_g),
                           pidx.contiguous(), packed=True)
            _eq(sh.slot(out) != 0, want, f"struct {kind}, lhs packed")
    parts = sh.partial()  # M7
    span_off = sh.cols.get("trace.span_off")
    tsid = None if span_off is not None else sh.cols["span.trace_sid"]
    _eq(parts, MS._search_partial_plain(sh.slots, sh.prog.tslots, span_off, tsid, sh.n_spans_t,
                                        sh.row0, sh.nt), "M7")
    counts = parts * 2 + 1  # M8 on summed-looking counts
    tm, cnt = sh.finish(counts)
    want = MS._search_finish_plain(sh.prog.code(sh.prog.trace_off), sh.conds, sh.cols, sh.ops_i,
                                   sh.ops_f, sh.tables, counts)
    _eq(tm, want[0], "M8 trace_mask")
    _eq(cnt, want[1], "M8 counts")


def _attr_search(case: dict, sp: int, k: int, dev) -> MS.ShardSearch:
    """Shard k of sp of an attr_case on dev, every leaf of ATTR_SPECS in
    one tree (descriptors built on the card)."""
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in ATTR_SPECS)
    tree = ("cond", len(conds) - 1)
    for i in range(len(conds) - 2, -1, -1):
        tree = ("or", ("cond", i), tree)
    tree = F.normalize_tree(tree, conds)
    cols = {n: torch.from_numpy(a).to(dev) for n, a in attr_shard(case, sp, k).items()}
    n_own = cols["span.trace_sid"].shape[1] * sp
    return MS.ShardSearch(tree, conds, cols, case["ints"], case["floats"], case["tables"],
                          [n_own] * case["ints"].shape[0], k, 1)


def _attr_check(sh, what):
    """M5's count of every leaf on the shard against its plain version,
    one __global__ a call."""
    for i in range(len(ATTR_SPECS)):
        kernels.reset_counts()
        got = sh.attr_partial(i)
        torch.cuda.synchronize()
        assert kernels.grid_launches()["attr_partial"] == 1
        arow0 = sh.sp_index * sh.cols["sattr.key_id"].shape[1]
        _eq(got, MS._attr_partial_plain(sh.conds[i], sh.cols, sh.ops_i, sh.ops_f, i,
                                        sh.tables.get(i), arow0), f"{what} leaf {i}")


@pytest.mark.parametrize("shape", ["plain", "hostile", "no_rows", "ragged_tile", "past_shard",
                                   "wrap"])
def test_attr_tiles_match_plain(cuda, shape):
    """M5's tiled count over the CPU model's cases (tests/test_torch_attr_
    tiles.py) on every shard of sp = 1, 2 and 4 (arow0 > 0 past the
    first), each leaf: any, string, int, float and table; "wrap": offsets
    within a shard's arow0 of INT_MIN, whose int32 difference wraps."""
    if shape in ("hostile", "wrap"):
        case = attr_case(7, hostile=True)
        if shape == "wrap":
            case["cols"]["sattr.off"][1, [1150, 1250, 2200]] = [INT_MIN, INT_MIN + 5000,
                                                                 INT_MIN + 9000]
    elif shape == "no_rows":
        case = attr_case(3, big=0)
        case["cols"]["sattr.off"][:] = 0
    elif shape == "ragged_tile":
        case = attr_case(4, n_own=2049)
    elif shape == "past_shard":
        case = attr_case(5, big=0)
        case["cols"]["sattr.off"] //= 8
    else:
        case = attr_case(41)
    for sp in (1, 2, 4):
        for k in range(sp):
            _attr_check(_attr_search(case, sp, k, cuda), f"{shape} sp={sp} k={k}")


@pytest.mark.parametrize("big,n_own,A,hostile", [(100_000, 4096, 1 << 17, False),
                                                 (0, 1 << 20, 1 << 21, False),
                                                 (0, 1 << 20, 1 << 21, True)])
def test_attr_tiles_at_scale(cuda, big, n_own, A, hostile):
    """An owner of 100,000 rows (hundreds of chunks of one tile's
    window), on the whole block and on the second of two shards; then
    phase 15's shape in the rows a block (2^20 owners, 2^21 attr rows)
    over 10 blocks, with and without tiles that are not monotone among
    the monotone ones."""
    case = attr_case(17, n_own=n_own, A=A, big=big, hostile=hostile)
    if n_own == 1 << 20:  # 10 blocks: the operand rows of the two repeated
        case["cols"] = {n: np.concatenate([a] * 5) for n, a in case["cols"].items()}
        case["ints"], case["floats"] = np.concatenate([case["ints"]] * 5), \
            np.concatenate([case["floats"]] * 5)
        case["tables"] = {i: np.concatenate([t] * 5) for i, t in case["tables"].items()}
    for sp, k in ((1, 0), (2, 1)):
        _attr_check(_attr_search(case, sp, k, cuda), f"big={big} sp={sp} k={k}")


@pytest.mark.parametrize("layout", ["contiguous", "slot_view"])
@pytest.mark.parametrize("sl", [8, 16, 4096, 1 << 16])
def test_mask_pack_kernels_match_plain(cuda, sl, layout):
    """M6's pack of each of two shards' lhs slot (Sl rows, as a strided
    slot view or a contiguous copy) over mask bytes that are not only 0
    and 1, one __global__ a call; rows off the 8-byte grid refused. Then
    K1's struct pass on the second shard, for each op, reading the two
    packed rows as the all_gather joins them, against the plain struct
    step over the unpacked mask, bit for bit."""
    rng = np.random.default_rng(sl)
    bl, n_slots = 3, 4
    raw = np.where(rng.random((bl, n_slots, 2 * sl)) < 0.5, 0,
                   rng.integers(1, 256, (bl, n_slots, 2 * sl))).astype(np.uint8)
    parts = []
    for k in range(2):
        slots = torch.from_numpy(np.ascontiguousarray(raw[:, :, k * sl:(k + 1) * sl])).to(cuda)
        m = slots[:, 1].contiguous() if layout == "contiguous" else slots[:, 1]
        pk = _launched(lambda: kernels.mask_pack(m), "mask_pack")
        _eq(pk, MS._mask_pack_plain(m), "pack")
        np.testing.assert_array_equal(pk.cpu().numpy(),
                                      np.packbits(raw[:, 1, k * sl:(k + 1) * sl] != 0, axis=1))
        parts.append(pk)
        shard = slots
    flat = shard.view(-1)
    for bad in (flat[1:1 + bl * sl].view(bl, sl),  # a base off the 8-byte grid
                flat.as_strided((bl, sl), (sl + 4, 1))):  # a stride off it
        with pytest.raises(kernels.KernelError):
            kernels.mask_pack(bad)
    pk = torch.cat(parts, dim=1)  # the all_gather over two sp ranks
    S, row0 = 2 * sl, sl  # the gathered row of two shards; this shard the second
    n_spans = [S, S - 5, S // 2 + 3]
    n_spans_t = torch.tensor(n_spans, dtype=torch.int32, device=cuda)
    table = rng.integers(-2, S, (bl, S)).astype(np.int32)
    for op in (">", ">>", "~"):
        p = table[:, row0:] if op == ">" else table
        pidx = torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
        shard[:, 3].fill_(9)
        kernels.reset_counts()
        kernels.filter_struct_shard(op, pk, shard, 2, 3, pidx, n_spans, row0, packed=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["struct_packed"] == 1 and kernels.LAUNCHES["filter"] == 0
        assert kernels.grid_launches()["struct_packed"] >= 1
        want = F._struct_step_plain(op, MS._mask_unpack_plain(pk), shard[:, 2] != 0, pidx,
                                    n_spans_t, row0)
        _eq(shard[:, 3] != 0, want, f"packed struct pass {op}")
        assert want.any(), op


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_search_card_matches_cpu(cuda, case):
    """The host entry on a one-rank mesh: every step on the card, against
    the same program's plain route on the CPU."""
    tree, specs, rows, tables, cols, n_spans, nt = CASES[case](np.random.default_rng(7))
    if case.startswith("struct"):
        tree = ("struct", "~", ("cond", 0), ("cond", 1))
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    ops = _operands(F, rows, tables)
    got = sharded_search(make_mesh(device=cuda), tree, conds, ops, cols, n_spans, nt=nt)
    want = sharded_search(make_mesh(device="cpu"), tree, conds, ops, cols, n_spans, nt=nt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[0].any()


TAIL_CONDS = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in SEARCH_SPECS)
# 34 tracify slots in 67 operations: past the fused route's 32 slot bits,
# M7's 32 slots by value and the 64 operations M8 carries by value
MANY_SLOTS = ("and", ("cond", 3), ("or",) + tuple(("tracify", ("cond", j % 3)) for j in range(34)))


def _tail_search(case: dict, tree, sp: int, k: int, dev) -> MS.ShardSearch:
    """Shard k of sp of a search_case on dev, its mask slots set from the
    case's bytes (slot j from the case's slot j % 4)."""
    tree = F.normalize_tree(tree, TAIL_CONDS)
    S, nt = case["slots"].shape[2], case["span_off"].shape[1] - 1
    sl = S // sp
    cols = {n: a[:, k * sl:(k + 1) * sl] if n.startswith("span.") else a
            for n, a in case["cols"].items()}
    cols["trace.span_off"] = case["span_off"]
    cols = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for n, a in cols.items()}
    sh = MS.ShardSearch(tree, TAIL_CONDS, cols, case["ints"], case["floats"], case["tables"],
                        case["n_spans"].tolist(), k, nt)
    n = sh.slots.shape[1]
    src = case["slots"][:, [j % 4 for j in range(n)], k * sl:(k + 1) * sl]
    sh.slots.copy_(torch.from_numpy(np.ascontiguousarray(src)).to(dev))
    return sh


def _launched(fn, name):
    """fn() with one wrapper call and one __global__ of `name` counted."""
    kernels.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == 1 and kernels.grid_launches()[name] == 1, name
    return out


def _tail_check(sh: MS.ShardSearch, what: str) -> None:
    """M7 on both routes, M8 on its counts and on summed-looking ones, and
    the fused route, each against its plain version; the fused route's
    outputs equal M7 then M8's."""
    span_off, tsid = sh.cols["trace.span_off"], sh.cols["span.trace_sid"]
    tslots, code = sh.prog.tslots, sh.prog.trace_code
    parts = _launched(sh.partial, "search_partial")
    _eq(parts, MS._search_partial_plain(sh.slots, tslots, span_off, None, sh.n_spans_t, sh.row0,
                                        sh.nt), f"{what}: M7 tiles")
    got = kernels.search_partial(sh.prog, sh.bufs[0], sh.slots, None, tsid, sh.n_spans_t,
                                 sh.row0, sh.nt)
    _eq(got, MS._search_partial_plain(sh.slots, tslots, None, tsid, sh.n_spans_t, sh.row0, sh.nt),
        f"{what}: M7 trace_sid")
    for counts in (parts, parts * 2 - 1):
        tm, cnt = _launched(lambda c=counts: sh.finish(c), "search_finish")
        want = MS._search_finish_plain(code, sh.conds, sh.cols, sh.ops_i, sh.ops_f, sh.tables,
                                       counts)
        _eq(tm, want[0], f"{what}: M8 trace_mask")
        _eq(cnt, want[1], f"{what}: M8 counts")
    want = sh.finish(parts)
    if len(tslots) <= kernels.FUSED_MAX_TR:
        got = _launched(lambda: kernels.search_fused(sh.prog, sh.bufs[0], sh.descs, sh.slots,
                                                     span_off, sh.n_spans_t, sh.row0, sh.nt),
                        "search_fused")
    else:
        with pytest.raises(kernels.KernelError):
            kernels.search_fused(sh.prog, sh.bufs[0], sh.descs, sh.slots, span_off, sh.n_spans_t,
                                 sh.row0, sh.nt)
        got = sh.partial_finish()  # M7, then M8
    _eq(got[0], want[0], f"{what}: fused trace_mask")
    _eq(got[1], want[1], f"{what}: fused counts")


@pytest.mark.parametrize("shape", ["grouped", "hostile", "ragged_tile", "empty_tile", "unaligned",
                                   "long_trace", "wrap"])
def test_search_tail_matches_plain(cuda, shape):
    """M7, M8 and the fused route over search_case's shapes on every shard
    of sp = 1, 2 and 4 (row0 > 0 past the first): n_tr 0, 1 and 3, trace
    conditions and a table, a program past 64 operations and one past 16
    trace conditions, 34 tracify slots (M7 walks, M8 reads its program
    from the buffer, the fused route refuses it); falling, negative and
    past-the-shard offsets; a last tile of one trace; a tile of empty
    traces; shard rows not 16-byte aligned; a trace of 100,000 rows;
    offsets within a shard's row0 of INT_MIN, whose int32 difference
    wraps."""
    trees = dict(SEARCH_TREES, many_slots=MANY_SLOTS)
    sps = (1, 2, 4)
    if shape in ("hostile", "wrap"):
        case = search_case(7, hostile=True)
        if shape == "wrap":
            case["span_off"][1, [150, 250, 400]] = [INT_MIN, INT_MIN + 3000, INT_MIN + 5000]
    elif shape == "ragged_tile":
        case = search_case(8, nt=513)
    elif shape == "empty_tile":
        case = search_case(3, empty_tile=True)
    elif shape == "unaligned":
        case, sps = search_case(5, S=8200), (1, 2)
    elif shape == "long_trace":
        case, sps = search_case(4, S=1 << 17, big=100_000), (1, 2)
        assert np.diff(case["span_off"][0])[700] == 100_000
    else:
        case = search_case(31)
    for name, tree in trees.items():
        for sp in sps:
            for k in range(sp):
                _tail_check(_tail_search(case, tree, sp, k, torch.device("cuda", 0)),
                            f"{shape} {name} sp={sp} k={k}")


@pytest.mark.parametrize("tree", ["n_tr1", "n_tr3"])
def test_search_tail_at_scale(cuda, tree):
    """Phase 15's shape: 10 blocks of 2^20 span rows, 32,768 traces of 32
    rows a block, one rank (and the second of two shards)."""
    rng = np.random.default_rng(15)
    bl, S, nt = 10, 1 << 20, 1 << 15
    off = np.broadcast_to(np.arange(nt + 1, dtype=np.int32) * (S // nt), (bl, nt + 1))
    nz = rng.choice(np.asarray([1, 0x80, 0xFF], np.uint8), (bl, 4, S))
    case = {"slots": np.where(rng.random((bl, 4, S)) < 0.04, nz, 0).astype(np.uint8),
            "span_off": np.ascontiguousarray(off), "n_spans": np.full(bl, S, np.int32),
            "cols": {"span.dur_us": np.zeros((bl, S), np.int32),
                     "span.kind": np.zeros((bl, S), np.int32),
                     "span.trace_sid": np.broadcast_to(np.arange(S, dtype=np.int32) // (S // nt),
                                                       (bl, S)),
                     "trace.dur_ms": rng.integers(0, 100, (bl, nt)).astype(np.int32),
                     "trace.root_name_id": rng.integers(-1, 6, (bl, nt)).astype(np.int32)}}
    small = search_case(1)
    case["ints"] = np.concatenate([small["ints"]] * 5)
    case["floats"] = np.concatenate([small["floats"]] * 5)
    case["tables"] = {4: np.concatenate([small["tables"][4]] * 5)}
    for sp, k in ((1, 0), (2, 1)):
        _tail_check(_tail_search(case, SEARCH_TREES[tree], sp, k, torch.device("cuda", 0)),
                    f"phase 15 {tree} sp={sp} k={k}")
