"""The sharded search of the port (parallel/search.py: M5-M8 around K1 on
each shard, a reduce-scatter, all_reduces and bit-packed all_gathers)
over spawned gloo ranks on the CPU, against the reference's shard_map
program on a mesh of the same (dp, sp). Port and reference get the same
seeded numpy inputs and per-block operands; trace masks and span counts
must match bit for bit (exact: bool and int32 outputs).

Cases: span + res leaves (tests/test_parallel.py:66), a trace-axis
condition with a regex table (:102), span and resource attr leaves whose
owners' rows straddle the sp cuts (:132), `>`, `>>` and `~` with
TEMPO_STRUCT_PACK on and off (:232), an OR of two tracify subtrees, no
tree at all, and three blocks padded to four for dp = 2; both layouts
(with and without trace.span_off)."""

import numpy as np
import pytest
from test_torch_mesh_cases import SHAPE_IDS, SHAPES, start_mesh

from tempo_tpu.ops import filter as RF
from tempo_tpu.parallel.search import sharded_search as r_sharded_search
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops.device import PAD_I32
from tempo_tpu_torch.parallel import sharded_search


@pytest.fixture(scope="module", params=SHAPES, ids=SHAPE_IDS)
def meshes(request, tmp_path_factory):
    yield from start_mesh(request.param, tmp_path_factory)


def _grouped(rng, B: int, S: int, NT: int, n_spans) -> dict:
    """span.trace_sid sorted within each block and trace.span_off (B,
    NT + 1) over it: the layout staging gives a block."""
    sid = np.sort(rng.integers(0, NT, size=(B, S)), axis=1).astype(np.int32)
    off = np.zeros((B, NT + 1), np.int32)
    for b in range(B):
        n = int(n_spans[b])
        off[b, 1:] = np.cumsum(np.bincount(sid[b, :n], minlength=NT))
    return {"span.trace_sid": sid, "trace.span_off": off}


def _span_res(rng, offsets: bool):
    B, S, NT, R = 4, 64, 16, 8
    n_spans = np.asarray([64, 50, 64, 3], np.int32)
    cols = {"span.dur_us": rng.integers(0, 1000, size=(B, S)).astype(np.int32),
            "span.res_idx": rng.integers(-1, R, size=(B, S)).astype(np.int32),
            "res.service_id": rng.integers(0, 4, size=(B, R)).astype(np.int32)}
    if offsets:
        cols.update(_grouped(rng, B, S, NT, n_spans))
    else:
        cols["span.trace_sid"] = rng.integers(0, NT, size=(B, S)).astype(np.int32)
    specs = [("span", "span.dur_us", "ge", False), ("res", "res.service_id", "eq", False)]
    rows = [[(0, 300 + 100 * b, 0, 0.0, 0.0), (0, b % 4, 0, 0.0, 0.0)] for b in range(B)]
    return ("and", ("cond", 0), ("cond", 1)), specs, rows, None, cols, n_spans, NT


def _trace_table(rng):
    B, S, NT = 2, 32, 8
    cols = {"span.trace_sid": rng.integers(0, NT, size=(B, S)).astype(np.int32),
            "span.name_id": rng.integers(0, 6, size=(B, S)).astype(np.int32),
            "trace.dur_us": rng.integers(0, 100, size=(B, NT)).astype(np.int32)}
    n_spans = np.asarray([32, 20], np.int32)
    specs = [("span", "span.name_id", "intable", False), ("trace", "trace.dur_us", "ge", False)]
    rows = [[(0, 0, 0, 0.0, 0.0), (0, 40, 0, 0.0, 0.0)], [(0, 0, 0, 0.0, 0.0), (0, 25, 0, 0.0, 0.0)]]
    tables = [{0: np.asarray([0, 1, 0, 1, 0, 0], np.uint8)}, {0: np.asarray([1, 0, 0, 1], np.uint8)}]
    return ("and", ("cond", 0), ("cond", 1)), specs, rows, tables, cols, n_spans, NT


def _attrs(rng):
    """Ragged attr rows a span and a resource, so owners straddle every
    sp cut; the trace.span_off layout."""
    B, S, NT, R, A, RA = 2, 32, 8, 4, 64, 16
    n_spans = np.asarray([32, 21], np.int32)
    cols = _grouped(rng, B, S, NT, n_spans)
    cols["span.res_idx"] = rng.integers(0, R, size=(B, S)).astype(np.int32)
    for name, n in (("sattr.key_id", A), ("sattr.vtype", A), ("sattr.str_id", A),
                    ("rattr.key_id", RA), ("rattr.vtype", RA), ("rattr.int32", RA)):
        cols[name] = np.full((B, n), PAD_I32, np.int32)
    cols["sattr.off"] = np.zeros((B, S + 1), np.int32)
    cols["rattr.off"] = np.zeros((B, R + 1), np.int32)
    for b in range(B):
        counts = rng.integers(0, 4, size=n_spans[b])
        counts[np.cumsum(counts) > A] = 0
        off = np.zeros(S + 1, np.int32)
        off[1 : n_spans[b] + 1] = np.cumsum(counts)
        off[n_spans[b] + 1 :] = off[n_spans[b]]
        cols["sattr.off"][b] = off
        n = int(off[-1])
        cols["sattr.key_id"][b, :n] = rng.integers(0, 3, size=n)
        cols["sattr.vtype"][b, :n] = rng.integers(0, 2, size=n)
        cols["sattr.str_id"][b, :n] = rng.integers(0, 3, size=n)
        rc = rng.integers(0, 4, size=R)
        rc[np.cumsum(rc) > RA] = 0
        cols["rattr.off"][b] = np.concatenate([[0], np.cumsum(rc)])
        rn = int(rc.sum())
        cols["rattr.key_id"][b, :rn] = rng.integers(0, 3, size=rn)
        cols["rattr.vtype"][b, :rn] = 1
        cols["rattr.int32"][b, :rn] = rng.integers(0, 50, size=rn)
    specs = [("sattr", "str", "eq", False), ("rattr", "int", "ge", False),
             ("sattr", "any", "exists", False)]
    rows = [[(2, 1, 0, 0.0, 0.0), (1, 20, 0, 0.0, 0.0), (0, 0, 0, 0.0, 0.0)],
            [(1, 2, 0, 0.0, 0.0), (1, 30, 0, 0.0, 0.0), (2, 0, 0, 0.0, 0.0)]]
    tree = ("and", ("cond", 0), ("or", ("cond", 1), ("cond", 2)))
    return tree, specs, rows, None, cols, n_spans, NT


def _struct(rng):
    """Parent chains and orphans (pid -2) across every shard cut."""
    B, S, NT = 2, 64, 8
    cols = {"span.trace_sid": np.sort(rng.integers(0, NT, size=(B, S)), axis=1).astype(np.int32),
            "span.dur_us": rng.integers(0, 100, size=(B, S)).astype(np.int32),
            "span.parent_idx": np.full((B, S), -1, np.int32)}
    for b in range(B):
        sid = cols["span.trace_sid"][b]
        prev = np.zeros(S, bool)
        prev[1:] = sid[1:] == sid[:-1]
        pidx = np.where(prev & (rng.random(S) < 0.6), np.arange(S) - 1, -1).astype(np.int32)
        # siblings: some children point two rows back within the trace
        two = np.zeros(S, bool)
        two[2:] = sid[2:] == sid[:-2]
        pidx = np.where(two & (rng.random(S) < 0.3), np.arange(S) - 2, pidx).astype(np.int32)
        for row in (17, 33, 49, 62):
            pidx[row] = -2
        cols["span.parent_idx"][b] = pidx
    n_spans = np.asarray([64, 52], np.int32)
    specs = [("span", "span.dur_us", "lt", False), ("span", "span.dur_us", "ge", False)]
    rows = [[(0, 80, 0, 0.0, 0.0), (0, 20, 0, 0.0, 0.0)], [(0, 70, 0, 0.0, 0.0), (0, 30, 0, 0.0, 0.0)]]
    return None, specs, rows, None, cols, n_spans, NT


def _or_tracify(rng):
    """An OR of two span sets, one of them beside a trace condition, a
    float compare among the leaves; no offsets."""
    B, S, NT = 4, 32, 8
    cols = {"span.trace_sid": rng.integers(0, NT, size=(B, S)).astype(np.int32),
            "span.status": rng.integers(0, 3, size=(B, S)).astype(np.int32),
            "span.dur_us": rng.integers(0, 1000, size=(B, S)).astype(np.int32),
            "trace.dur_ms": rng.integers(0, 50, size=(B, NT)).astype(np.int32)}
    n_spans = np.asarray([32, 17, 0, 30], np.int32)
    specs = [("span", "span.status", "eq", False), ("span", "span.dur_us", "gt", True),
             ("trace", "trace.dur_ms", "lt", False)]
    rows = [[(0, 2, 0, 0.0, 0.0), (0, 0, 0, 700.5 - 50 * b, 0.0), (0, 20 + 5 * b, 0, 0.0, 0.0)]
            for b in range(B)]
    tree = ("or", ("tracify", ("cond", 0)), ("and", ("tracify", ("cond", 1)), ("cond", 2)))
    return tree, specs, rows, None, cols, n_spans, NT


def _no_tree(rng):
    B, S, NT = 2, 32, 8
    n_spans = np.asarray([30, 9], np.int32)
    return None, [], None, None, _grouped(rng, B, S, NT, n_spans), n_spans, NT


def _padded(rng):
    """Three blocks with per-block operands, padded to four for dp = 2:
    the fourth block has no spans and zero operand rows."""
    tree, specs, rows, _, cols, n_spans, NT = _span_res(rng, offsets=True)
    n_spans[3] = 0
    for n in ("span.dur_us", "span.res_idx", "span.trace_sid"):
        cols[n][3] = PAD_I32 if n != "span.trace_sid" else 0
    cols["trace.span_off"][3] = 0
    return tree, specs, rows[:3], None, cols, n_spans, NT


CASES = {
    "span_res": lambda rng: _span_res(rng, offsets=False),
    "span_res_offsets": lambda rng: _span_res(rng, offsets=True),
    "trace_table": _trace_table,
    "attrs": _attrs,
    "struct_pack": _struct,
    "struct_nopack": _struct,
    "or_tracify": _or_tracify,
    "no_tree": _no_tree,
    "padded": _padded,
}


def _operands(M, rows, tables):
    if rows is None:
        return M.Operands.build([])
    return [M.Operands.build(r, tables[b] if tables else None) for b, r in enumerate(rows)]


def _both(mesh, rmesh, tree, specs, rows, tables, cols, n_spans, NT):
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    want = r_sharded_search(rmesh, tree, rconds, _operands(RF, rows, tables), cols, n_spans,
                            nt=NT)
    got = sharded_search(mesh, tree, conds, _operands(F, rows, tables), cols, n_spans, nt=NT)
    for g, w, what in zip(got, want, ("trace_mask", "span_count")):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_search_matches_reference(meshes, monkeypatch, case):
    mesh, rmesh = meshes
    tree, specs, rows, tables, cols, n_spans, NT = CASES[case](np.random.default_rng(7))
    if case.startswith("struct"):
        monkeypatch.setenv("TEMPO_STRUCT_PACK", "1" if case == "struct_pack" else "0")
        for op in (">", ">>", "~"):
            tm, _ = _both(mesh, rmesh, ("struct", op, ("cond", 0), ("cond", 1)), specs, rows,
                          tables, cols, n_spans, NT)
            assert tm.any() and not tm.all(), op
        return
    tm, sc = _both(mesh, rmesh, tree, specs, rows, tables, cols, n_spans, NT)
    assert tm.any() and sc.sum() > 0  # the check is not vacuous
