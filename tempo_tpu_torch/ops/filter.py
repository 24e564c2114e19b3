"""Data-driven predicate evaluation over vtpu columns: the TraceQL /
tag-search execution kernel (port of tempo_tpu/ops/filter.py).

Every condition becomes a boolean mask over its axis (span rows, attr
rows, resource rows); attr and resource hits fold to their owner span
through the row offsets; masks combine through the condition tree; the
span masks aggregate to a trace mask through `trace.span_off`.

Only the STRUCTURE (expression tree + condition targets/ops) is
compiled: `_FilterProgram` turns the trace-level tree into postfix
programs over condition descriptors for the CUDA kernel
(csrc/filter.cu), cached by the same key as the reference's
`_compiled` lru_cache. Operand values -- dictionary codes, thresholds,
regex-match tables -- travel as data, so `{span.foo = "bar"}` and
`{span.foo = "baz"}` share one program.

`eval_block` runs the kernel on CUDA tensors and `_run_plain`, the plain
PyTorch version of the same function, on CPU tensors. The plain version
is a line-by-line translation of the reference's jitted `run`
(including its segment_max forms for staging without offsets). On the
card K1 has two routes, chosen by kernels.filter_plan from
`TraceTiles`, which staging computes once per block (`trace_tiles`): a
tile of whole traces a CTA, one launch a program, where the traces
partition the rows and every parent row lies in its own trace; the
multi-launch kernels otherwise.

Device filters are *conservative* (may over-match, never under-match):
conditions whose encodings can over-match are flagged needs_verify and
re-checked exactly on host over the surviving candidates
(db/search.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .device import PAD_I32, bucket, pad_rows

# condition targets
T_SPAN = "span"  # direct span-axis column
T_TRACE = "trace"  # trace-axis column
T_RES = "res"  # resource-axis dedicated column (materialized at span@<col>)
T_SATTR = "sattr"  # generic span attr table
T_RATTR = "rattr"  # generic resource attr table

# ops: v0/v1 int operands, f0/f1 float operands, table = dict-code table
OPS = (
    "eq", "ne", "ne_present", "lt", "le", "gt", "ge", "range",
    "exists", "ne_clamped", "intable", "notintable",
)


@dataclass(frozen=True)
class Cond:
    """One predicate. Hashable => part of the program cache key."""

    target: str
    col: str  # device column ('span.dur_us', 'res.service_id', ...) or
    # value kind for attr targets: 'str', 'int', 'float', 'bool', 'any'
    op: str
    is_float: bool = False
    needs_verify: bool = False


@dataclass
class Operands:
    """Per-condition operand values (data, NOT part of the cache key).
    ints[i] = (key_code, v0, v1); floats[i] = (f0, f1);
    tables[i] = bool array over dictionary codes (intable ops only)."""

    ints: np.ndarray  # (n_conds, 3) int32
    floats: np.ndarray  # (n_conds, 2) float32
    tables: dict[int, np.ndarray] | None = None

    @classmethod
    def build(cls, rows: list, tables: dict[int, np.ndarray] | None = None) -> "Operands":
        if not rows:
            ints = np.zeros((0, 3), np.int32)
            floats = np.zeros((0, 2), np.float32)
        else:
            ints = np.asarray([[r[0], r[1], r[2]] for r in rows], dtype=np.int64)
            ints = np.clip(ints, -(2**31), 2**31 - 1).astype(np.int32)
            floats = np.asarray([[r[3], r[4]] for r in rows], dtype=np.float32)
        return cls(ints, floats, tables)


_ATTR_VALUE_COL = {"str": "str_id", "int": "int32", "bool": "int32", "float": "f32"}
_VT_CODE = {"str": 0, "int": 1, "float": 2, "bool": 3, "any": -1}

# expression trees: ('cond', i) | ('and', *children) | ('or', *children)
CondTree = tuple


def _flatten(conds) -> list:
    out = []
    for g in conds:
        if isinstance(g, Cond):
            out.append(g)
        else:
            out.extend(g)
    return out


def required_columns(conds) -> list[str]:
    # trace.span_off: spans are stored grouped by trace, so span->trace
    # aggregation walks each trace's span range. span@<res col> entries
    # are NOT physical columns: they ask the staging layer to
    # materialize that res column at span level once (query-independent,
    # kernel K4). Readers of raw columns must skip them.
    need = {"span.trace_sid", "trace.span_off"}
    for c in _flatten(conds):
        if c.target in (T_SPAN, T_TRACE):
            need.add(c.col)
        elif c.target == T_RES:
            need.add(c.col)
            need.add("span.res_idx")
            need.add(f"span@{c.col}")
        elif c.target == T_SATTR:
            need.update({"sattr.span", "sattr.key_id", "sattr.vtype"})
            if c.col in _ATTR_VALUE_COL:
                need.add(f"sattr.{_ATTR_VALUE_COL[c.col]}")
        elif c.target == T_RATTR:
            # res.service_id rides along to size the resource axis
            need.update({"rattr.res", "rattr.key_id", "rattr.vtype", "span.res_idx", "res.service_id"})
            if c.col in _ATTR_VALUE_COL:
                need.add(f"rattr.{_ATTR_VALUE_COL[c.col]}")
    return sorted(need)


def normalize_tree(tree: CondTree, conds: tuple[Cond, ...]) -> CondTree:
    """Lift a mixed tree into trace-level form: pure-span subtrees wrap in
    ('tracify', t); trace-target conds stay direct. A mix below an 'or'
    of span and trace conds is allowed: the span side tracifies."""
    trace_idx = {i for i, c in enumerate(conds) if c.target == T_TRACE}

    def purity(t):  # 'trace' | 'span' | 'mixed'
        if t[0] == "tracify":
            return "trace"
        if t[0] == "struct":
            # ('struct', op, lhs, rhs): spanset-relation node, span-level
            # by construction (t[1] is the op STRING -- never recurse it)
            return "span"
        if t[0] == "cond":
            return "trace" if t[1] in trace_idx else "span"
        kinds = {purity(ch) for ch in t[1:]}
        return kinds.pop() if len(kinds) == 1 else "mixed"

    def lift(t):
        p = purity(t)
        if p == "span":
            return ("tracify", t)
        if p == "trace":
            return t
        if t[0] == "and":
            # span-pure children must hold on the SAME span (single-spanset
            # semantics): group them under ONE tracify, don't lift each
            span_ch = [ch for ch in t[1:] if purity(ch) == "span"]
            rest = [lift(ch) for ch in t[1:] if purity(ch) != "span"]
            if span_ch:
                sub = span_ch[0] if len(span_ch) == 1 else ("and",) + tuple(span_ch)
                rest = [("tracify", sub)] + rest
            return rest[0] if len(rest) == 1 else ("and",) + tuple(rest)
        return (t[0],) + tuple(lift(ch) for ch in t[1:])

    return lift(tree)


def _groups_to_tree(groups) -> tuple[CondTree, tuple[Cond, ...]]:
    """CNF condition groups (tuple of OR-tuples) -> expression tree."""
    conds: list[Cond] = []
    children = []
    for g in groups:
        if isinstance(g, Cond):
            g = (g,)
        ors = []
        for c in g:
            conds.append(c)
            ors.append(("cond", len(conds) - 1))
        children.append(ors[0] if len(ors) == 1 else ("or",) + tuple(ors))
    tree = children[0] if len(children) == 1 else ("and",) + tuple(children)
    return tree, tuple(conds)


# ------------------------------------------------------------ plain version


def _cmp(op: str, x, v0, v1, f0, f1, is_float: bool, table):
    if is_float:
        a, b = f0, f1
    else:
        a, b = v0, v1
    if op == "eq":
        return x == a
    if op == "ne":
        return x != a
    if op == "ne_present":  # value present (code >= 0) and differs
        return (x != a) & (x >= 0)
    if op == "ne_clamped":  # conservative ne on a clamped int encoding
        return (x != a) | (x == 2**31 - 1) | (x == -(2**31) + 1)
    if op == "lt":
        return x < a
    if op == "le":
        return x <= a
    if op == "gt":
        return x > a
    if op == "ge":
        return x >= a
    if op == "range":  # inclusive [a, b]
        return (x >= a) & (x <= b)
    if op == "exists":
        return torch.ones_like(x, dtype=torch.bool)
    if op in ("intable", "notintable"):
        hit = table[torch.clamp(x, 0, table.shape[0] - 1).long()] > 0
        if op == "notintable":
            hit = ~hit
        return hit & (x >= 0)
    raise ValueError(f"unknown op {op}")


def _offset_counts(mask, off):
    """Per-segment True counts when rows are GROUPED by segment:
    exclusive cumsum + two gathers at the segment offsets."""
    ecs = torch.cat([torch.zeros(1, dtype=torch.int64, device=mask.device),
                     torch.cumsum(mask.to(torch.int64), 0)])
    off = off.long()
    return (ecs[off[1:]] - ecs[off[:-1]]).to(torch.int32)


def _segment_any(row_hit, owner, n_seg: int):
    out = torch.zeros(n_seg, dtype=torch.int32, device=row_hit.device)
    out.scatter_reduce_(0, owner.long(), row_hit.to(torch.int32), "amax")
    return out > 0


def _cond_mask(c: Cond, i, cols, ops_i, ops_f, tables, n_spans_b, n_res_b, valid_span):
    """Span-level mask for one condition."""
    key, v0, v1 = ops_i[i, 0], ops_i[i, 1], ops_i[i, 2]
    f0, f1 = ops_f[i, 0], ops_f[i, 1]
    table = tables.get(i)
    if c.target == T_SPAN:
        return _cmp(c.op, cols[c.col], v0, v1, f0, f1, c.is_float, table) & valid_span
    if c.target == T_RES:
        pre = cols.get(f"span@{c.col}")
        if pre is not None:
            return (
                _cmp(c.op, pre, v0, v1, f0, f1, c.is_float, table)
                & (pre != int(PAD_I32))
                & valid_span
            )
        res_mask = _cmp(c.op, cols[c.col], v0, v1, f0, f1, c.is_float, table)
        idx = torch.clamp(cols["span.res_idx"], 0, res_mask.shape[0] - 1).long()
        return res_mask[idx] & (cols["span.res_idx"] >= 0) & valid_span
    if c.target in (T_SATTR, T_RATTR):
        pre = c.target
        key_match = cols[f"{pre}.key_id"] == key
        if c.col == "any":
            row_hit = key_match
        else:
            vcol = cols[f"{pre}.{_ATTR_VALUE_COL[c.col]}"]
            vt_ok = cols[f"{pre}.vtype"] == _VT_CODE[c.col]
            row_hit = key_match & vt_ok & _cmp(c.op, vcol, v0, v1, f0, f1, c.is_float, table)
        if pre == T_SATTR:
            if "sattr.off" in cols:
                return (_offset_counts(row_hit, cols["sattr.off"]) > 0) & valid_span
            owner = torch.clamp(cols["sattr.span"], 0, n_spans_b - 1)
            return _segment_any(row_hit, owner, n_spans_b) & valid_span
        if "rattr.off" in cols:
            res_mask = _offset_counts(row_hit, cols["rattr.off"]) > 0
        else:
            owner = torch.clamp(cols["rattr.res"], 0, n_res_b - 1)
            res_mask = _segment_any(row_hit, owner, n_res_b)
        idx = torch.clamp(cols["span.res_idx"], 0, n_res_b - 1).long()
        return res_mask[idx] & (cols["span.res_idx"] >= 0) & valid_span
    raise ValueError(f"bad target {c.target}")


def _run_plain(tree, conds, cols, ops_i, ops_f, tables, n_spans, n_traces,
               n_spans_b, n_res_b, n_traces_b, span_out):
    """The plain PyTorch version of the filter program (the reference's
    jitted `run`, tempo_tpu/ops/filter.py:287-399)."""
    dev = ops_i.device
    valid_span = torch.arange(n_spans_b, dtype=torch.int32, device=dev) < n_spans
    valid_trace = torch.arange(n_traces_b, dtype=torch.int32, device=dev) < n_traces
    span_masks: list = []

    def ev_span(t):
        if t == ("true",):
            return valid_span
        if t == ("false",):
            return torch.zeros_like(valid_span)
        if t[0] == "cond":
            i = t[1]
            return _cond_mask(conds[i], i, cols, ops_i, ops_f, tables,
                              n_spans_b, n_res_b, valid_span)
        if t[0] == "struct":
            return ev_struct(t[1], ev_span(t[2]), ev_span(t[3]))
        masks = [ev_span(ch) for ch in t[1:]]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if t[0] == "and" else (out | m)
        return out

    def ev_struct(op, lm, rm):
        pidx = cols["span.parent_idx"]
        has_p = (pidx >= 0) & valid_span
        safe = torch.clamp(pidx, 0, n_spans_b - 1).long()
        if op == ">":
            return rm & has_p & lm[safe]
        if op == ">>":
            acc = has_p & lm[safe]
            ptr = torch.where(has_p, safe, -1)
            for _ in range(max(1, (n_spans_b - 1).bit_length())):
                psafe = torch.clamp(ptr, 0, n_spans_b - 1)
                alive = ptr >= 0
                acc = acc | (alive & acc[psafe])
                ptr = torch.where(alive, torch.where(ptr[psafe] >= 0, ptr[psafe], -1), -1)
            return rm & acc
        # '~': some DIFFERENT lhs span with the same parent; orphan-orphan
        # pairs over-match (see the reference) and host verification
        # settles them
        lhs_child = (lm & has_p).to(torch.int32)
        owner = torch.where(has_p & lm, safe, n_spans_b)
        cnt = torch.zeros(n_spans_b + 1, dtype=torch.int32, device=dev).index_add_(
            0, owner, lhs_child)[:n_spans_b]
        sibs = cnt[safe] - (lm & has_p).to(torch.int32)
        orphan = (pidx == -2) & valid_span
        any_lhs_orphan = torch.any(lm & orphan)
        return (rm & has_p & (sibs > 0)) | (rm & orphan & any_lhs_orphan)

    def seg_counts(span_mask):
        if "trace.span_off" in cols:
            return _offset_counts(span_mask & valid_span, cols["trace.span_off"])
        sid = torch.where(valid_span & span_mask, cols["span.trace_sid"], n_traces_b)
        sid = torch.clamp(sid, 0, n_traces_b).long()
        return torch.zeros(n_traces_b + 1, dtype=torch.int32, device=dev).index_add_(
            0, sid, span_mask.to(torch.int32))[:n_traces_b]

    def ev_trace(t):
        if t[0] == "tracify":
            sm = ev_span(t[1])
            span_masks.append(sm)
            return seg_counts(sm) > 0
        if t[0] == "cond":
            i = t[1]
            c = conds[i]
            return _cmp(c.op, cols[c.col], ops_i[i, 1], ops_i[i, 2],
                        ops_f[i, 0], ops_f[i, 1], c.is_float, tables.get(i))
        ms = [ev_trace(ch) for ch in t[1:]]
        out = ms[0]
        for m in ms[1:]:
            out = (out & m) if t[0] == "and" else (out | m)
        return out

    if tree is None:
        trace_mask = valid_trace
        union = valid_span
    else:
        trace_mask = ev_trace(tree) & valid_trace
        union = valid_span
        if span_masks:
            union = span_masks[0]
            for m in span_masks[1:]:
                union = union | m

    if not span_out:
        span_count = torch.where(trace_mask, seg_counts(union), 0).to(torch.int32)
        return trace_mask, span_count
    tsid = torch.clamp(cols["span.trace_sid"], 0, n_traces_b - 1).long()
    span_mask = union & trace_mask[tsid] & valid_span
    return span_mask, trace_mask, seg_counts(span_mask)


# ------------------------------------------- plain version on a mesh shard


def _cmp_b(op: str, x, ops_i, ops_f, i: int, is_float: bool, table):
    """The sharded search's per-block compare (the reference's `_cmp_b`,
    tempo_tpu/parallel/search.py:61-92): x (Bl, N), block b against its
    own operands ops_i[b, i], ops_f[b, i] and table row table[b]."""
    if op in ("intable", "notintable"):
        idx = torch.clamp(x, 0, table.shape[1] - 1).long()
        hit = torch.gather(table, 1, idx) > 0
        if op == "notintable":
            hit = ~hit
        return hit & (x >= 0)
    return _cmp(op, x, ops_i[:, i, 1:2], ops_i[:, i, 2:3], ops_f[:, i, 0:1], ops_f[:, i, 1:2],
                is_float, None)


def _shard_valid(n_spans, row0: int, n: int):
    """(Bl, n): global row row0 + s of each block below its span count."""
    rows = torch.arange(n, dtype=torch.int32, device=n_spans.device) + row0
    return rows[None, :] < n_spans[:, None]


def _span_step_plain(code, conds, cols, ops_i, ops_f, tables, slots, n_spans, row0: int):
    """K1's span pass on a shard, plain: the postfix program `code` over
    the shard's (Bl, Sl) rows, leaves reading their own block's
    operands; C_MASK reads slots (Bl, n_slots, Sl). Returns (Bl, Sl)."""
    valid = _shard_valid(n_spans, row0, slots.shape[2])
    st: list = []
    for op, arg in zip(code[0::2].tolist(), code[1::2].tolist()):
        if op in (C_AND, C_OR):
            b, a = st.pop(), st.pop()
            st.append((a & b) if op == C_AND else (a | b))
        elif op == C_COND:
            c = conds[arg]
            st.append(_cmp_b(c.op, cols[c.col], ops_i, ops_f, arg, c.is_float, tables.get(arg))
                      & valid)
        elif op == C_MASK:
            st.append(slots[:, arg] != 0)
        else:
            st.append(valid if op == C_TRUE else torch.zeros_like(valid))
    return st[-1]


def _struct_step_plain(op: str, lm_g, rm, pidx, n_spans, row0: int):
    """K1's struct passes on a shard, plain (the reference's mesh
    `ev_struct`, tempo_tpu/parallel/search.py:203-256): lm_g (Bl, S) the
    lhs mask gathered over sp, rm (Bl, Sl) the shard's rhs rows from
    row0, pidx the shard's parent rows (Bl, Sl) for '>' or the gathered
    table (Bl, S) for '>>' and '~'. Returns the shard's (Bl, Sl) rows."""
    S, sl = lm_g.shape[1], rm.shape[1]
    lm_g = lm_g.bool()
    valid = _shard_valid(n_spans, row0, sl)
    if op == ">":
        hit = torch.gather(lm_g, 1, torch.clamp(pidx, 0, S - 1).long())
        return rm & (pidx >= 0) & valid & hit
    has_p = (pidx >= 0) & _shard_valid(n_spans, 0, S)
    safe = torch.clamp(pidx, 0, S - 1).long()
    if op == ">>":
        acc = has_p & torch.gather(lm_g, 1, safe)
        ptr = torch.where(has_p, safe, -1)
        for _ in range(max(1, (S - 1).bit_length())):
            psafe = torch.clamp(ptr, 0, S - 1)
            alive = ptr >= 0
            acc = acc | (alive & torch.gather(acc, 1, psafe))
            nxt = torch.gather(ptr, 1, psafe)
            ptr = torch.where(alive, torch.where(nxt >= 0, nxt, -1), -1)
        out = acc
    else:  # '~', with the orphan rule of the single-block pass
        lhs_child = (lm_g & has_p).to(torch.int32)
        owner = torch.where(has_p & lm_g, safe, S)
        cnt = torch.zeros((lm_g.shape[0], S + 1), dtype=torch.int32, device=lm_g.device)
        cnt = cnt.scatter_add_(1, owner, lhs_child)[:, :S]
        sibs = torch.gather(cnt, 1, safe) - lhs_child
        orphan = (pidx == -2) & _shard_valid(n_spans, 0, S)
        any_lhs_orphan = (lm_g & orphan).any(dim=1, keepdim=True)
        out = (has_p & (sibs > 0)) | (orphan & any_lhs_orphan)
    return rm & out[:, row0 : row0 + sl] & valid


# ------------------------------------------------------ compiled program

_OP_CODE = {op: i for i, op in enumerate(OPS)}  # csrc/filter.cu enum Op
_KIND = {T_SPAN: 0, T_TRACE: 1, T_RES: 2, T_SATTR: 3, T_RATTR: 4}
# C_TCOND: a trace-target leaf read at the span's trace (B6's span programs)
C_COND, C_MASK, C_TRUE, C_FALSE, C_AND, C_OR, C_TRACIFY, C_TCOND = range(8)
DW = 17  # descriptor row width (csrc/filter.cu)
S_SPAN, S_CHILD, S_DESC, S_SIB = range(4)  # csrc/filter.cu enum StepKind
SW = 5  # step table row width (csrc/filter.cu)
(D_OP, D_KIND, D_FLOATCMP, D_COLFLOAT, D_VT, D_COL, D_KEYCOL, D_VTCOL, D_OFF,
 D_TABLE, D_TABLEN, D_V0, D_V1, D_KEY, D_F0, D_F1, D_RSLOT) = range(DW)
_MAX_STACK = 64  # the kernel's bit stack (csrc/filter.cu)


def _align(n: int) -> int:
    return (n + 15) & ~15


class _FilterProgram:
    """Host-compiled form of one trace-level tree: postfix span programs
    writing span-mask slots, struct steps between slots, a postfix trace
    program, and the buffer layout (descriptors, programs, slot lists)
    that one upload per call fills in.

    sharded=True compiles for one shard of the mesh search
    (ops/meshsearch.py): every generic-attr and resource leaf becomes a
    mask slot (leaf_slots) that M5 fills after its collective, read by
    the span pass as a C_MASK leaf, and a tree of None counts every
    valid span as one tracify slot (the reference's seg_reduce(valid))."""

    def __init__(self, tree, conds: tuple[Cond, ...], sharded: bool = False):
        self.conds = conds
        self.sharded = sharded
        self.leaf_slots: dict[int, int] = {}  # sharded: attr / res leaf -> its slot
        self.steps: list[tuple] = []  # ("span", code list, out) | ("struct", op, l, r, out)
        self.struct_steps: list[tuple] = []
        self.tslots: list[int] = []
        self.rconds: list[int] = []
        self.span_conds: set[int] = set()
        self.trace_conds: set[int] = set()
        self.n_slots = 0
        trace_code: list[int] = []
        if tree is None and not sharded:
            trace_code = [C_TRUE, 0]
        else:
            self._trace(("tracify", ("true",)) if tree is None else tree, trace_code)
        self._check_depth(trace_code)
        # buffer layout: descriptors | span programs | trace program |
        # tracify slots | rattr conds | step table | (tables, per call)
        off = _align(len(conds) * DW * 8)
        self.desc_off = 0
        codes, steps, rows = [], [], []
        # the trace-tile route's step table (csrc/filter.cu
        # filter_tile_kernel), SW int32 a step: (S_SPAN, code offset,
        # length, out slot, 0) or (S_CHILD / S_DESC / S_SIB, lhs, rhs,
        # out, the `~` node's flag bit); feeds_sib: a `~` output reaches
        # the slot, so a `~` whose lhs it is needs another `~`'s flag
        feeds_sib: dict[int, bool] = {}
        self.n_sib, self.last_sib, self.sib_nested = 0, -1, False
        for st in self.steps:
            if st[0] == "span":
                code = np.asarray(st[1], np.int32)
                steps.append(("span", off, len(st[1]), st[2]))
                codes.append((off, code))
                rows.append((S_SPAN, off, len(st[1]), st[2], 0))
                feeds_sib[st[2]] = any(feeds_sib.get(a, False)
                                       for c, a in zip(st[1][0::2], st[1][1::2]) if c == C_MASK)
                off = _align(off + code.nbytes)
            else:
                _, op, lslot, rslot, out = st
                steps.append(st)
                if op == "~":
                    self.sib_nested |= feeds_sib.get(lslot, False)
                    self.last_sib = len(rows)
                    rows.append((S_SIB, lslot, rslot, out, self.n_sib))
                    self.n_sib += 1
                else:
                    rows.append((S_CHILD if op == ">" else S_DESC, lslot, rslot, out, 0))
                feeds_sib[out] = (op == "~" or feeds_sib.get(lslot, False)
                                  or feeds_sib.get(rslot, False))
        self.steps = steps
        self.trace_off, self.trace_len = off, len(trace_code)
        # host copies of the trace program and the slot list, and their
        # addresses: M7 and M8 (csrc/meshsearch.cu) take them by value
        self.trace_code = np.asarray(trace_code, np.int32)
        self.tslots_host = np.asarray(self.tslots, np.int32)
        self.trace_code_ptr = self.trace_code.ctypes.data
        self.tslots_ptr = self.tslots_host.ctypes.data
        codes.append((off, self.trace_code))
        off = _align(off + 4 * len(trace_code))
        self.tslots_off = off
        codes.append((off, self.tslots_host))
        off = _align(off + 4 * len(self.tslots))
        self.rconds_off = off
        codes.append((off, np.asarray(self.rconds, np.int32)))
        off = _align(off + 4 * len(self.rconds))
        self.steps_off = off
        codes.append((off, np.asarray(rows, np.int32).reshape(-1)))
        self.tables_off = _align(off + 4 * SW * len(rows))
        self._codes = codes

    @staticmethod
    def _check_depth(code: list[int]) -> None:
        depth = peak = 0
        for op in code[0::2]:
            depth += -1 if op in (C_AND, C_OR) else 1
            peak = max(peak, depth)
        if peak > _MAX_STACK:
            raise ValueError(f"filter: program stack depth {peak} > {_MAX_STACK}")

    def _new_slot(self) -> int:
        self.n_slots += 1
        return self.n_slots - 1

    def _span_code(self, t, code: list[int]) -> None:
        if t == ("true",):
            code += [C_TRUE, 0]
        elif t == ("false",):
            code += [C_FALSE, 0]
        elif t[0] == "cond":
            c = self.conds[t[1]]
            if c.target not in (T_SPAN, T_RES, T_SATTR, T_RATTR):
                raise ValueError(f"bad target {c.target}")
            if self.sharded and c.target != T_SPAN:
                if t[1] not in self.leaf_slots:
                    self.leaf_slots[t[1]] = self._new_slot()
                code += [C_MASK, self.leaf_slots[t[1]]]
                return
            if c.target == T_RATTR and t[1] not in self.rconds:
                self.rconds.append(t[1])
            self.span_conds.add(t[1])
            code += [C_COND, t[1]]
        elif t[0] == "struct":
            code += [C_MASK, self._struct(t)]
        elif t[0] in ("and", "or"):
            self._span_code(t[1], code)
            for ch in t[2:]:
                self._span_code(ch, code)
                code += [C_AND if t[0] == "and" else C_OR, 0]
        else:
            raise ValueError(f"bad span node {t[0]}")

    def _materialize(self, t) -> int:
        if t[0] == "struct":
            return self._struct(t)
        code: list[int] = []
        self._span_code(t, code)
        self._check_depth(code)
        out = self._new_slot()
        self.steps.append(("span", code, out))
        return out

    def _struct(self, t) -> int:
        lslot = self._materialize(t[2])
        rslot = self._materialize(t[3])
        out = self._new_slot()
        step = ("struct", t[1], lslot, rslot, out)
        self.steps.append(step)
        self.struct_steps.append(step[1:])
        return out

    def _trace(self, t, code: list[int]) -> None:
        if t[0] == "tracify":
            self.tslots.append(self._materialize(t[1]))
            code += [C_TRACIFY, len(self.tslots) - 1]
        elif t[0] == "cond":
            self.trace_conds.add(t[1])
            code += [C_COND, t[1]]
        elif t[0] in ("and", "or"):
            self._trace(t[1], code)
            for ch in t[2:]:
                self._trace(ch, code)
                code += [C_AND if t[0] == "and" else C_OR, 0]
        else:
            raise ValueError(f"bad trace node {t[0]}")

    def code(self, off: int) -> np.ndarray:
        """The postfix program at buffer offset `off` (a span step's or
        trace_off): the plain versions walk it as the kernels do."""
        return dict(self._codes)[off]

    def layout(self, tables: dict) -> tuple[dict, int]:
        """Where this call's dictionary tables start in its program
        buffer, and the buffer's size (a multiple of 16 bytes)."""
        tbl_offs, total = {}, self.tables_off
        for i, t in tables.items():
            tbl_offs[i] = total
            total = _align(total + t.shape[0])
        return tbl_offs, max(total, 16)

    def buffer(self, cols: dict, operands: Operands, tables: dict) -> torch.Tensor:
        """The per-call program buffer on the card: descriptors with this
        call's column pointers and operand values, the cached programs,
        and this call's dictionary tables -- one upload."""
        # span.trace_sid is staged for every program (required_columns);
        # trace.span_off is not staged for the span-level metrics fold
        tbl_offs, total = self.layout(tables)
        buf = torch.empty(total, dtype=torch.uint8, device=cols["span.trace_sid"].device)
        host = np.zeros(total, np.uint8)
        self.fill(host, buf.data_ptr(), cols, operands, tables, tbl_offs)
        buf.copy_(torch.from_numpy(host))
        return buf

    def fill(self, host: np.ndarray, base: int, cols: dict, operands: Operands, tables: dict,
             tbl_offs: dict) -> None:
        """A program buffer's bytes in `host` (layout's size), for a buffer
        that will lie at device address `base`."""
        dev = cols["span.trace_sid"].device
        desc = np.zeros((len(self.conds), DW), np.int64)
        ints, floats = operands.ints, operands.floats

        def col(name):
            if name not in cols:
                raise KeyError(f"filter: staged column {name} missing")
            t = cols[name]
            if t.device != dev or not t.is_contiguous() or t.dtype not in (torch.int32, torch.float32):
                raise ValueError(f"filter: column {name} must be contiguous int32/f32 on {dev}")
            return t

        for i in sorted(self.span_conds | self.trace_conds | set(self.leaf_slots)):
            c = self.conds[i]
            d = desc[i]
            d[D_OP], d[D_KIND] = _OP_CODE[c.op], _KIND[c.target]
            d[D_VT] = _VT_CODE.get(c.col, 0) if c.target in (T_SATTR, T_RATTR) else 0
            if c.target in (T_SATTR, T_RATTR):
                p = c.target
                d[D_KEYCOL] = col(f"{p}.key_id").data_ptr()
                d[D_VTCOL] = col(f"{p}.vtype").data_ptr()
                d[D_OFF] = col(f"{p}.off").data_ptr()
                vcol = col(f"{p}.{_ATTR_VALUE_COL[c.col]}") if c.col != "any" else None
                if i in self.rconds:
                    d[D_RSLOT] = self.rconds.index(i)
            else:
                # a shard compares a resource leaf per resource (M5)
                res_span = c.target == T_RES and not self.sharded
                vcol = col(f"span@{c.col}" if res_span else c.col)
                if res_span and vcol.dtype != torch.int32:
                    raise TypeError(f"filter: res column {c.col} must be int32")
            colfloat = vcol is not None and vcol.dtype == torch.float32
            d[D_COL] = vcol.data_ptr() if vcol is not None else 0
            d[D_COLFLOAT] = colfloat
            d[D_FLOATCMP] = c.is_float or colfloat
            d[D_KEY], d[D_V0], d[D_V1] = ints[i]
            if c.is_float:
                f0, f1 = floats[i]
            else:  # an int operand against an f32 column promotes to f32
                f0, f1 = np.float32(ints[i][1]), np.float32(ints[i][2])
            d[D_F0] = np.float32(f0).view(np.int32)
            d[D_F1] = np.float32(f1).view(np.int32)
            if c.op in ("intable", "notintable"):
                if i not in tables or d[D_FLOATCMP]:
                    raise ValueError(f"filter: table op on cond {i} needs a table and an int column")
                d[D_TABLE] = base + tbl_offs[i]
                d[D_TABLEN] = tables[i].shape[0]
        host[: desc.nbytes] = desc.view(np.uint8).reshape(-1)
        for off, code in self._codes:
            host[off : off + code.nbytes] = code.view(np.uint8)
        for i, t in tables.items():
            host[tbl_offs[i] : tbl_offs[i] + t.shape[0]] = t


@dataclass(frozen=True)
class TraceTiles:
    """What K1's route plan (kernels.filter_plan) reads of a staged
    block, computed once when the block is staged (trace_tiles): the
    trace-tile route runs a program a tile of whole traces at a time, so
    it needs the traces to partition the span rows, each parent row to
    lie in its span's own trace, and (for span_out) span.trace_sid to
    name the trace whose range holds the span."""

    n_spans: int  # the staged block's span and padded trace rows
    n_traces_b: int
    tile: int  # spans a tile holds at most: a power of two
    bounds: torch.Tensor | None  # (n_tiles + 1,) int32 trace boundaries; None: no tiling
    max_trace: int  # spans of the longest trace
    parents_local: bool | None  # every parent row negative or in its trace; None: not staged
    tsid_local: bool  # span.trace_sid is the trace of every valid span
    has_orphans: bool  # some valid span's parent_idx is -2 (the `~` orphan rule)


def trace_tiles(span_off: np.ndarray, parent_idx: np.ndarray | None, trace_sid: np.ndarray | None,
                n_spans: int, tile: int | None = None) -> TraceTiles | None:
    """The staged block's tiling from its padded host columns: consecutive
    whole traces packed greedily into tiles of at most `tile` spans
    (default: kernels.FILTER_TILE, or the power of two at or above the
    longest trace up to kernels.FILTER_TILE_MAX; bounds None past it).
    None where trace.span_off does not partition the rows [0, n_spans)
    in order (every span must lie in exactly one trace's range)."""
    off = np.asarray(span_off, np.int64)
    if off.ndim != 1 or off.size < 2 or off.min() < 0:
        return None
    offc = np.minimum(off, n_spans)
    if offc[0] != 0 or offc[-1] != n_spans or np.any(np.diff(offc) < 0):
        return None
    lens = np.diff(offc)
    n_tr = lens.size
    max_trace = int(lens.max())
    trace_of = np.repeat(np.arange(n_tr, dtype=np.int64), lens)
    tsid_local = trace_sid is not None and bool(np.array_equal(
        np.clip(np.asarray(trace_sid[:n_spans], np.int64), 0, n_tr - 1), trace_of))
    parents_local, has_orphans = None, False
    if parent_idx is not None:
        p = np.asarray(parent_idx[:n_spans], np.int64)
        parents_local = bool(np.all((p < 0) | ((p >= offc[trace_of]) & (p < offc[trace_of + 1]))))
        has_orphans = bool(np.any(p == -2))
    if tile is None:
        tile = max(kernels.FILTER_TILE, 1 << (max(max_trace, 1) - 1).bit_length())
    if tile % 32:
        raise ValueError(f"trace_tiles: a tile of {tile} spans is not whole words")
    bounds = None
    if max_trace <= min(tile, kernels.FILTER_TILE_MAX):
        b = [0]
        while b[-1] < n_tr:  # the last trace whose range ends within the tile
            nxt = int(np.searchsorted(offc, offc[b[-1]] + tile, side="right")) - 1
            b.append(min(max(nxt, b[-1] + 1), n_tr))
        bounds = torch.tensor(b, dtype=torch.int32)
    return TraceTiles(n_spans, n_tr, tile, bounds, max_trace, parents_local, tsid_local,
                      has_orphans)


@lru_cache(maxsize=256)
def _program(tree, conds: tuple[Cond, ...], sharded: bool = False) -> _FilterProgram:
    return _FilterProgram(tree, conds, sharded)


def eval_block(
    query,
    combinator_or_cols,
    *args,
    span_out: bool = True,
    tiles: TraceTiles | None = None,
    plan: "kernels.FilterPlan | None" = None,
):
    """Two call forms:

    eval_block((tree, conds), cols, operands, n_spans, n_traces,
               n_spans_b, n_res_b, n_traces_b)               -- tree form
    eval_block(groups, "and", cols, operands, ...)            -- CNF form

    cols: staged tensors (ops/stage.py), all on one device. Returns
    (span_mask (n_spans_b,), trace_mask (n_traces_b,), per-trace matched
    span count) as tensors on that device; with span_out=False just
    (trace_mask, counts). CUDA tensors run kernel K1 by the route `plan`
    names (default: kernels.filter_plan over the staged block's `tiles`;
    no tiles, the multi-launch route); CPU tensors run the plain
    version."""
    if isinstance(combinator_or_cols, str):
        groups = query
        if combinator_or_cols != "and":
            tree, conds = _groups_to_tree([tuple(_flatten(groups))])  # single OR group
        else:
            tree, conds = _groups_to_tree(groups)
        cols, operands, n_spans, n_traces, n_spans_b, n_res_b, n_traces_b = args
    else:
        tree, conds = query
        cols = combinator_or_cols
        operands, n_spans, n_traces, n_spans_b, n_res_b, n_traces_b = args
    if tree is not None:
        tree = normalize_tree(tree, conds)  # idempotent
    tables = {
        i: pad_rows(np.asarray(t, dtype=np.uint8), bucket(max(1, len(t))), 0)
        for i, t in (operands.tables or {}).items()
    }
    dev = cols["span.trace_sid"].device
    if dev.type == "cpu":
        ops_i = torch.from_numpy(np.ascontiguousarray(operands.ints, np.int32))
        ops_f = torch.from_numpy(np.ascontiguousarray(operands.floats, np.float32))
        out = _run_plain(tree, conds, cols, ops_i, ops_f,
                         {i: torch.from_numpy(t) for i, t in tables.items()},
                         int(n_spans), int(n_traces), n_spans_b, n_res_b, n_traces_b, span_out)
        return out
    prog = _program(tree, tuple(conds))
    buf = prog.buffer(cols, operands, tables)
    span_mask, trace_mask, counts = kernels.filter_run(
        prog, buf, cols, int(n_spans), int(n_traces), n_spans_b, n_res_b, n_traces_b, span_out,
        tiles, plan)
    return (span_mask, trace_mask, counts) if span_out else (trace_mask, counts)
