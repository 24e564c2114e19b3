"""The sharded search's CUDA kernels on the card against their plain
versions: M5 attr_partial (and its mask), M6 mask_pack / mask_unpack, M7
search_partial, M8 search_finish, and K1's span pass and struct kernels
on a shard (the `>` offset by the shard's first row), stage by stage on
the second of two sp shards of every case of tests/test_torch_mesh_search.py;
then the host entry on a one-rank card mesh against the CPU.

Marked `cuda`; the fixture below skips them where no card exists. Run on
a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is an int or a bool and compared exactly."""

import numpy as np
import pytest
import torch
from test_torch_mesh_search import CASES, _operands
from torch_tile_cases import ATTR_SPECS, attr_case, attr_shard

from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS
from tempo_tpu_torch.parallel import make_mesh, sharded_search
from tempo_tpu_torch.parallel.search import _stack_operands

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("shape", ["plain", "hostile", "no_rows", "ragged_tile", "past_shard"])
def test_attr_tiles_match_plain(cuda, shape):
    """M5's tiled count over the CPU model's cases (tests/test_torch_attr_
    tiles.py) on every shard of sp = 1, 2 and 4 (arow0 > 0 past the
    first), each leaf: any, string, int, float and table."""
    if shape == "hostile":
        case = attr_case(7, hostile=True)
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


@pytest.mark.parametrize("sl", [8, 4096])
def test_mask_pack_kernels_match_plain(cuda, sl):
    rng = np.random.default_rng(sl)
    slots = torch.from_numpy(rng.integers(0, 2, (3, 4, sl)).astype(np.uint8)).to(cuda)
    m = slots[:, 1]
    pk = kernels.mask_pack(m)
    _eq(pk, MS._mask_pack_plain(m), "pack")
    _eq(kernels.mask_unpack(pk), MS._mask_unpack_plain(pk), "unpack")
    _eq(kernels.mask_unpack(pk), m != 0, "round trip")


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
