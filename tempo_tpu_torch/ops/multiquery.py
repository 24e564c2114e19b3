"""Multi-query predicate programs: Q queries x R rows in ONE launch
(port of tempo_tpu/ops/multiquery.py).

The kernel half of the cross-query batching executor (db/batchexec.py):
concurrent queries against the same staged block merge into one device
step, the serving-stack analog of continuous batching.

Lowering (`lower_plan`) turns a planned query's condition tree into a
fixed-shape *predicate program*:

  * span-level conditions become padded (column-id, op-code, operand)
    tables -- data, not structure;
  * the boolean tree flattens to CNF at two levels: span conds group
    into OR-clauses under AND per tracify group (same-span semantics
    preserved), and trace-level atoms (tracify-group results + trace
    conds) group into OR-clauses under AND;
  * every table pads to a power-of-two bucket (ProgramShape), so the
    coalesce key depends only on the shape buckets + column set.

`eval_multiquery` runs the Q packed programs over one staged block:
kernel B5a (csrc/multiquery.cu) on CUDA tensors, `_multiquery_plain`
(the reference's jitted `run`, line by line) on CPU tensors. It gives
per-query (trace_mask, matched-span counts), bit-identical to running
ops/filter.eval_block per query. `select_multiquery` then runs ONE
batched top-k over all Q mask rows: kernel B5b, or `_mq_select_plain`.
On a mesh (parallel/multiquery.py) B5a splits at an all_reduce SUM:
`mq_partial` (M2) counts each rank's row slice per trace, and
`mq_combine` (M3) runs the trace-level half on the summed counts.

Eligibility is conservative: conditions over dedicated int32 columns
(span/trace intrinsics, well-known res/span attrs via the span@
materialization) with scalar compare ops. Regex tables, generic attr
tables, struct relations and float compares return None from
`lower_plan`; the caller falls back to the single-query path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import MQ_MAX, MQ_W
from .device import PAD_I32
from .filter import T_RES, T_SPAN, T_TRACE, normalize_tree

# op codes (order matters: _cmp_code dispatches on these)
_OPC = {"eq": 0, "ne": 1, "ne_present": 2, "lt": 3, "le": 4,
        "gt": 5, "ge": 6, "range": 7}
_NOP = -1  # padded condition slot: mask is False everywhere

# per-query program-size ceilings; a query that lowers past any of them
# is ineligible (falls back to the single-query engine)
MAX_CONDS = 32
MAX_CLAUSES = 16
MAX_GROUPS = 8
MAX_TCONDS = 16
MAX_ATOMS = 16
MAX_TCLAUSES = 8


def _p2(n: int, lo: int = 2) -> int:
    """Small power-of-two bucket (program tables, not row axes)."""
    b = lo
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class ProgramShape:
    """Bucketed program dims + column set: the plan-signature half of
    the coalesce key."""

    n_conds_b: int
    n_clauses_b: int
    n_groups_b: int
    n_tconds_b: int
    n_atoms_b: int
    n_tclauses_b: int
    span_cols: tuple[str, ...]  # staged span-axis columns, indexed by cond_col
    trace_cols: tuple[str, ...]  # staged trace-axis columns, by tcond_col


_TABLES = ("cond_col", "cond_op", "cond_v0", "cond_v1", "cond_guard",
           "clause_off", "group_off", "tcond_col", "tcond_op",
           "tcond_v0", "tcond_v1", "atom_kind", "atom_idx", "tclause_off")


@dataclass
class LoweredQuery:
    """One query's predicate program (host-side numpy tables, padded to
    the ProgramShape buckets)."""

    shape: ProgramShape
    # span-level conds, sorted by (group, clause); padded slots op=_NOP
    cond_col: np.ndarray  # (P,) index into shape.span_cols
    cond_op: np.ndarray  # (P,)
    cond_v0: np.ndarray  # (P,)
    cond_v1: np.ndarray  # (P,)
    cond_guard: np.ndarray  # (P,) bool: require x != PAD (span@res cols)
    clause_off: np.ndarray  # (NC+1,) cond-slot boundaries per clause
    group_off: np.ndarray  # (NG+1,) clause boundaries per tracify group
    n_groups: int
    # trace-level conds + atoms, atoms sorted by trace clause
    tcond_col: np.ndarray  # (PT,)
    tcond_op: np.ndarray  # (PT,)
    tcond_v0: np.ndarray  # (PT,)
    tcond_v1: np.ndarray  # (PT,)
    atom_kind: np.ndarray  # (NA,) 0=group result, 1=trace cond, -1=pad
    atom_idx: np.ndarray  # (NA,)
    tclause_off: np.ndarray  # (TC+1,) atom boundaries per trace clause
    n_tclauses: int

    @classmethod
    def from_arrays(cls, arrays: dict) -> "LoweredQuery":
        """A program given as plain arrays -- every table field, n_groups,
        n_tclauses, span_cols and trace_cols (the JAX package's
        LoweredQuery carries the same fields) -- with its ProgramShape
        read off the table lengths."""
        t = {f: np.asarray(arrays[f]) for f in _TABLES}
        shape = ProgramShape(
            n_conds_b=int(t["cond_col"].shape[0]),
            n_clauses_b=int(t["clause_off"].shape[0]) - 1,
            n_groups_b=int(t["group_off"].shape[0]) - 1,
            n_tconds_b=int(t["tcond_col"].shape[0]),
            n_atoms_b=int(t["atom_kind"].shape[0]),
            n_tclauses_b=int(t["tclause_off"].shape[0]) - 1,
            span_cols=tuple(arrays["span_cols"]),
            trace_cols=tuple(arrays["trace_cols"]),
        )
        t = {f: a.astype(bool if f == "cond_guard" else np.int32) for f, a in t.items()}
        return cls(shape=shape, n_groups=int(arrays["n_groups"]),
                   n_tclauses=int(arrays["n_tclauses"]), **t)


# --------------------------------------------------------------- lowering


def _cnf(tree, clause_cap: int = MAX_CLAUSES):
    """and/or tree with hashable leaves -> list of OR-clauses (lists of
    leaves) whose AND is equivalent. None when distribution would exceed
    clause_cap (OR-of-AND blowup)."""
    if not isinstance(tree, tuple) or tree[0] not in ("and", "or"):
        return [[tree]]
    parts = [_cnf(ch, clause_cap) for ch in tree[1:]]
    if any(p is None for p in parts):
        return None
    if tree[0] == "and":
        out = [c for p in parts for c in p]
        return out if len(out) <= clause_cap else None
    # or: cross-product of the children's clause sets
    out = [[]]
    for p in parts:
        nxt = []
        for acc in out:
            for clause in p:
                nxt.append(acc + clause)
                if len(nxt) > clause_cap:
                    return None
        out = nxt
    return out


def lower_plan(planned) -> LoweredQuery | None:
    """PlannedQuery (traceql/plan.py) -> predicate program, or None when
    the plan can't be expressed in the fixed-shape op set (caller falls
    back to the single-query engine). Must be given a non-pruned plan."""
    conds = tuple(planned.conds)
    if planned.tables:  # regex / set tables: per-query table shapes
        return None
    if getattr(planned, "has_struct", False):
        return None
    for c in conds:
        if c.target not in (T_SPAN, T_TRACE, T_RES):
            return None  # generic attr tables (sattr/rattr)
        if c.op not in _OPC or c.is_float:
            return None
    tree = planned.tree
    rows = planned.rows

    # trace-level tree -> atoms (tracify groups + trace conds)
    groups: list[list[list[int]]] = []  # per group: clauses of cond idxs
    atoms: list[tuple[int, int]] = []  # (kind, idx)
    tcond_idx: list[int] = []  # cond indices used at trace level

    def span_leaf(t):
        """span-CNF leaf check: ('cond', i) with span/res target."""
        return (isinstance(t, tuple) and len(t) == 2 and t[0] == "cond"
                and conds[t[1]].target in (T_SPAN, T_RES))

    def lower_tracify(span_tree) -> int | None:
        """span subtree -> group id (appended), or None if unlowerable."""
        if span_tree == ("true",):
            clauses: list[list[int]] | None = []  # AND of nothing: all spans
        elif span_tree == ("false",):
            return None  # planner folds these away; don't guess
        else:
            clauses = _cnf(span_tree)
            if clauses is None or len(clauses) > MAX_CLAUSES:
                return None
            for cl in clauses:
                for leaf in cl:
                    if not span_leaf(leaf):
                        return None
        groups.append([[leaf[1] for leaf in cl] for cl in (clauses or [])])
        return len(groups) - 1

    if tree is not None:
        tree = normalize_tree(tree, conds)
        tcnf = _cnf(tree, MAX_TCLAUSES)
        if tcnf is None or len(tcnf) > MAX_TCLAUSES:
            return None
        tclauses: list[list[int]] = []  # per trace clause: atom ids
        for cl in tcnf:
            atom_ids = []
            for leaf in cl:
                if isinstance(leaf, tuple) and leaf[0] == "tracify":
                    g = lower_tracify(leaf[1])
                    if g is None:
                        return None
                    atoms.append((0, g))
                elif isinstance(leaf, tuple) and leaf[0] == "cond" \
                        and conds[leaf[1]].target == T_TRACE:
                    tcond_idx.append(leaf[1])
                    atoms.append((1, len(tcond_idx) - 1))
                else:
                    return None  # struct / constants inside a clause
                atom_ids.append(len(atoms) - 1)
            tclauses.append(atom_ids)
    else:
        tclauses = []

    n_sconds = sum(len(cl) for g in groups for cl in g)
    n_clauses = sum(len(g) for g in groups)
    if (n_sconds > MAX_CONDS or n_clauses > MAX_CLAUSES
            or len(groups) > MAX_GROUPS or len(tcond_idx) > MAX_TCONDS
            or len(atoms) > MAX_ATOMS or len(tclauses) > MAX_TCLAUSES):
        return None

    # column maps (sorted for a canonical signature)
    span_cols = sorted({
        (f"span@{conds[i].col}" if conds[i].target == T_RES else conds[i].col)
        for g in groups for cl in g for i in cl
    })
    trace_cols = sorted({conds[i].col for i in tcond_idx})
    scol_of = {n: j for j, n in enumerate(span_cols)}
    tcol_of = {n: j for j, n in enumerate(trace_cols)}

    shape = ProgramShape(
        n_conds_b=_p2(max(n_sconds, 1)),
        n_clauses_b=_p2(max(n_clauses, 1)),
        n_groups_b=_p2(max(len(groups), 1), lo=1),
        n_tconds_b=_p2(max(len(tcond_idx), 1), lo=1),
        n_atoms_b=_p2(max(len(atoms), 1), lo=1),
        n_tclauses_b=_p2(max(len(tclauses), 1), lo=1),
        span_cols=tuple(span_cols),
        trace_cols=tuple(trace_cols),
    )

    def v01(i):
        v0 = int(np.clip(rows[i][1], -(2**31), 2**31 - 1))
        v1 = int(np.clip(rows[i][2], -(2**31), 2**31 - 1))
        return v0, v1

    P, NC, NG = shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b
    PT, NA, TC = shape.n_tconds_b, shape.n_atoms_b, shape.n_tclauses_b
    cond_col = np.zeros(P, np.int32)
    cond_op = np.full(P, _NOP, np.int32)
    cond_v0 = np.zeros(P, np.int32)
    cond_v1 = np.zeros(P, np.int32)
    cond_guard = np.zeros(P, bool)
    clause_off = np.zeros(NC + 1, np.int32)
    group_off = np.zeros(NG + 1, np.int32)
    s = c_i = 0
    for gi, g in enumerate(groups):
        group_off[gi] = c_i
        for cl in g:
            clause_off[c_i] = s
            for i in cl:
                c = conds[i]
                name = f"span@{c.col}" if c.target == T_RES else c.col
                cond_col[s] = scol_of[name]
                cond_op[s] = _OPC[c.op]
                cond_v0[s], cond_v1[s] = v01(i)
                cond_guard[s] = c.target == T_RES
                s += 1
            c_i += 1
            clause_off[c_i] = s
    group_off[len(groups):] = c_i
    clause_off[c_i:] = s  # padded clauses: empty ranges past the real conds

    tcond_col = np.zeros(PT, np.int32)
    tcond_op = np.full(PT, _NOP, np.int32)
    tcond_v0 = np.zeros(PT, np.int32)
    tcond_v1 = np.zeros(PT, np.int32)
    for j, i in enumerate(tcond_idx):
        tcond_col[j] = tcol_of[conds[i].col]
        tcond_op[j] = _OPC[conds[i].op]
        tcond_v0[j], tcond_v1[j] = v01(i)

    atom_kind = np.full(NA, _NOP, np.int32)
    atom_idx = np.zeros(NA, np.int32)
    tclause_off = np.zeros(TC + 1, np.int32)
    a = 0
    for ti, atom_ids in enumerate(tclauses):
        tclause_off[ti] = a
        for aid in atom_ids:
            atom_kind[a], atom_idx[a] = atoms[aid]
            a += 1
        tclause_off[ti + 1] = a
    tclause_off[len(tclauses):] = a

    return LoweredQuery(
        shape=shape,
        cond_col=cond_col, cond_op=cond_op, cond_v0=cond_v0, cond_v1=cond_v1,
        cond_guard=cond_guard, clause_off=clause_off, group_off=group_off,
        n_groups=len(groups),
        tcond_col=tcond_col, tcond_op=tcond_op,
        tcond_v0=tcond_v0, tcond_v1=tcond_v1,
        atom_kind=atom_kind, atom_idx=atom_idx, tclause_off=tclause_off,
        n_tclauses=len(tclauses),
    )


def pack_queries(lowered: list[LoweredQuery], q_b: int) -> dict[str, np.ndarray]:
    """Stack Q programs (identical ProgramShape) into (q_b, ...) tables;
    padded query rows match nothing (one impossible trace clause)."""
    shape = lowered[0].shape
    out: dict[str, np.ndarray] = {}
    for f in _TABLES:
        out[f] = np.stack([getattr(lq, f) for lq in lowered]
                          + [np.zeros_like(getattr(lowered[0], f))]
                          * (q_b - len(lowered)))
    ng = np.asarray([lq.n_groups for lq in lowered]
                    + [0] * (q_b - len(lowered)), np.int32)
    # padded queries: one empty trace clause => OR over nothing => False
    ntc = np.asarray([lq.n_tclauses for lq in lowered]
                     + [1] * (q_b - len(lowered)), np.int32)
    out["n_groups"] = ng
    out["n_tclauses"] = ntc
    assert all(lq.shape == shape for lq in lowered)
    return out


def mq_bytes_estimate(shape: ProgramShape, q_b: int, n_spans_b: int) -> int:
    """Dominant intermediate footprint of the reference's fused launch
    (the (Q, P, S) cond masks + cumsums in int32). B5a builds none of
    them; the executor keeps it as the reference's budget gate so both
    packages route the same groups."""
    return q_b * max(1, shape.n_conds_b) * n_spans_b * 4 * 3


# ------------------------------------------------------------ plain version


def _cmp_code(opc, x, v0, v1):
    """Data-driven compare; padded slots (opc == _NOP) and unknown codes
    yield False."""
    return (
        ((opc == 0) & (x == v0))
        | ((opc == 1) & (x != v0))
        | ((opc == 2) & ((x != v0) & (x >= 0)))
        | ((opc == 3) & (x < v0))
        | ((opc == 4) & (x <= v0))
        | ((opc == 5) & (x > v0))
        | ((opc == 6) & (x >= v0))
        | ((opc == 7) & ((x >= v0) & (x <= v1)))
    )


def _take(a: torch.Tensor, idx, n: int) -> torch.Tensor:
    """a[clip(idx, 0, n-1)] along axis 0: the reference's explicit clip."""
    return a[torch.clamp(torch.as_tensor(idx, device=a.device).long(), 0, n - 1)]


def _jidx(idx, n: int) -> torch.Tensor:
    """The row an index gathers where the reference indexes without a clip
    (an offset table, span_off): a negative index counts from the end,
    then XLA clamps it into [0, n - 1]."""
    idx = torch.as_tensor(idx).long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _jtake(a: torch.Tensor, idx) -> torch.Tensor:
    """a[idx] along axis 0 as the reference's implicit gather takes it."""
    return a[_jidx(torch.as_tensor(idx, device=a.device), a.shape[0])]


def _zcumsum(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive-prefix form: a zero row, then the running sums."""
    cs = torch.cumsum(m.to(torch.int64), dim=dim)
    zero = torch.zeros_like(cs.narrow(dim, 0, 1))
    return torch.cat([zero, cs], dim=dim)


def _multiquery_plain(span_cols: list, trace_cols: list, span_off: torch.Tensor,
                      progs: dict, n_spans: int, n_traces: int, n_spans_b: int,
                      n_traces_b: int):
    """Plain version of B5a: the reference's `run`
    (tempo_tpu/ops/multiquery.py:356-421) in torch, one query at a
    time. progs: packed tables as tensors on the columns' device."""
    dev = span_off.device
    valid_span = torch.arange(n_spans_b, device=dev) < n_spans
    valid_trace = torch.arange(n_traces_b, device=dev) < n_traces
    span_mat = (torch.stack(list(span_cols)) if span_cols
                else torch.zeros((1, n_spans_b), dtype=torch.int32, device=dev))
    trace_mat = (torch.stack(list(trace_cols)) if trace_cols
                 else torch.zeros((1, n_traces_b), dtype=torch.int32, device=dev))
    off = span_off.long()
    q_b = progs["cond_op"].shape[0]
    tms, cnts = [], []
    for q in range(q_b):
        p = {k: v[q] for k, v in progs.items()}
        x = _take(span_mat, p["cond_col"], span_mat.shape[0])
        m = _cmp_code(p["cond_op"][:, None], x, p["cond_v0"][:, None], p["cond_v1"][:, None])
        m = m & (~p["cond_guard"].bool()[:, None] | (x != int(PAD_I32)))
        m = m & valid_span[None, :]
        cs = _zcumsum(m, 0)
        co = p["clause_off"].long()
        clause_ok = (_jtake(cs, co[1:]) - _jtake(cs, co[:-1])) > 0
        cs2 = _zcumsum(clause_ok, 0)
        go = p["group_off"].int()
        n_cl = (go[1:] - go[:-1])[:, None]  # int32, as the reference's
        grp_ok = ((_jtake(cs2, go[1:]) - _jtake(cs2, go[:-1])) == n_cl) \
            & valid_span[None, :]
        cs3 = _zcumsum(grp_ok, 1)
        o1 = _jidx(off[1:], n_spans_b + 1)
        o0 = _jidx(off[:-1], n_spans_b + 1)
        gmask = (cs3[:, o1] - cs3[:, o0]) > 0  # (NG, T)
        tx = _take(trace_mat, p["tcond_col"], trace_mat.shape[0])
        tcm = _cmp_code(p["tcond_op"][:, None], tx, p["tcond_v0"][:, None], p["tcond_v1"][:, None])
        kind = p["atom_kind"]
        aval = torch.where((kind == 0)[:, None], _take(gmask, p["atom_idx"], gmask.shape[0]),
                           _take(tcm, p["atom_idx"], tcm.shape[0])) & (kind >= 0)[:, None]
        cs4 = _zcumsum(aval, 0)
        to = p["tclause_off"].long()
        tcl_ok = ((_jtake(cs4, to[1:]) - _jtake(cs4, to[:-1])) > 0) | (
            torch.arange(to.shape[0] - 1, device=dev) >= p["n_tclauses"])[:, None]
        tm = torch.all(tcl_ok, dim=0) & valid_trace
        live = (torch.arange(grp_ok.shape[0], device=dev) < p["n_groups"])[:, None]
        union = torch.any(grp_ok & live, dim=0) if int(p["n_groups"]) > 0 else valid_span
        ucs = _zcumsum(union, 0)
        counts = torch.where(tm, ucs[o1] - ucs[o0], 0).to(torch.int32)
        tms.append(tm)
        cnts.append(counts)
    return torch.stack(tms), torch.stack(cnts)


_NEG = -(2**31)


def _mq_select_plain(tm: torch.Tensor, key: torch.Tensor, counts: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Plain version of B5b: per row, a stable descending sort of the
    masked key (equal keys keep index order, as lax.top_k)."""
    keyed = torch.where(tm, key.to(torch.int32)[None, :], _NEG)
    topi = torch.sort(keyed, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.cat([
        topi.to(torch.int32),
        torch.gather(counts.to(torch.int32), 1, topi),
        torch.gather(tm, 1, topi).to(torch.int32),
        tm.to(torch.int32).sum(dim=1, keepdim=True).to(torch.int32),
    ], dim=1)


# --------------------------------------------------------------- dispatch

# the kernel's packed program row (csrc/multiquery.cu MqField): each
# table at its bucket ceiling, then n_groups and n_tclauses
_P, _NC, _NG, _PT, _NA, _TC = MQ_MAX
_LAYOUT = {}
_o = 0
for _name, _n in (("cond_col", _P), ("cond_op", _P), ("cond_v0", _P), ("cond_v1", _P),
                  ("cond_guard", _P), ("clause_off", _NC + 1), ("group_off", _NG + 1),
                  ("tcond_col", _PT), ("tcond_op", _PT), ("tcond_v0", _PT), ("tcond_v1", _PT),
                  ("atom_kind", _NA), ("atom_idx", _NA), ("tclause_off", _TC + 1),
                  ("n_groups", 1), ("n_tclauses", 1)):
    _LAYOUT[_name] = _o
    _o += _n
assert _o <= MQ_W


def _program_rows(progs: dict[str, np.ndarray]) -> np.ndarray:
    """Packed (q_b, ...) tables -> the kernel's (q_b, MQ_W) int32 rows."""
    q_b = progs["cond_op"].shape[0]
    rows = np.zeros((q_b, MQ_W), np.int32)
    for name, o in _LAYOUT.items():
        a = np.asarray(progs[name]).astype(np.int32).reshape(q_b, -1)
        rows[:, o:o + a.shape[1]] = a
    return rows


def device_program(lowered: list[LoweredQuery], staged, progs: dict):
    """The kernel's operands on the staged device, in one upload: the
    program rows (q_b, MQ_W), the table dims, and the pointer table of
    the span columns then the trace columns the shape names."""
    shape = lowered[0].shape
    cols = [staged.cols[n] for n in shape.span_cols + shape.trace_cols]
    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    rows = _program_rows(progs)
    ptrs = np.asarray([c.data_ptr() for c in cols] or [0], np.int64)
    buf = torch.from_numpy(np.concatenate([ptrs.view(np.uint8),
                                           rows.reshape(-1).view(np.uint8)]))
    buf = buf.to(staged.cols["trace.span_off"].device)
    prog_t = buf[ptrs.nbytes:].view(torch.int32).view(rows.shape)
    return prog_t, dims, buf[: ptrs.nbytes].view(torch.int64)


def eval_multiquery(lowered: list[LoweredQuery], staged, progs: dict):
    """Run Q packed programs against one staged block: ONE launch.
    Returns (q_b, n_traces_b) trace_mask, counts tensors on the staged
    device (kernel B5a on a card, its plain version on the CPU)."""
    shape = lowered[0].shape
    span_off = staged.cols["trace.span_off"]
    if span_off.device.type == "cpu":
        tp = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in progs.items()}
        return _multiquery_plain([staged.cols[n] for n in shape.span_cols],
                                 [staged.cols[n] for n in shape.trace_cols], span_off, tp,
                                 staged.n_spans, staged.n_traces, staged.n_spans_b,
                                 staged.n_traces_b)
    from .. import kernels

    prog_t, dims, ptr_t = device_program(lowered, staged, progs)
    return kernels.multiquery(prog_t, dims, ptr_t, len(shape.span_cols), len(shape.trace_cols),
                              span_off, staged.n_spans, staged.n_traces, staged.n_traces_b,
                              staged.n_spans_b)


def select_multiquery(tm, key, counts, k: int):
    """Batched twin of ops/select.select_topk_device: one launch + one
    fetch for all Q queries. Returns per query the RAW (sids, counts,
    valid, n_match) arrays of length k, still in top-k order -- callers
    slice to their own smaller k' THEN apply valid, which reproduces the
    single-query select at k' exactly (the order is total, so the first
    k' slots of a k-select equal a k'-select)."""
    q_b, nt = int(tm.shape[0]), int(tm.shape[1])
    k = int(min(k, nt))
    if tm.device.type == "cpu":
        out = _mq_select_plain(tm, key, counts, k)
    else:
        from .. import kernels

        out = kernels.mq_select(tm.contiguous(), key.to(torch.int32).contiguous(),
                                counts.to(torch.int32).contiguous(), k)
    out = out.cpu().numpy()
    res = []
    for q in range(q_b):
        row = out[q]
        res.append((row[:k], row[k:2 * k], row[2 * k:3 * k] > 0, int(row[3 * k])))
    return res


# ------------------------------------------- the mesh split (M2 and M3)

_TABLE_DIM = {"cond_col": 0, "cond_op": 0, "cond_v0": 0, "cond_v1": 0, "cond_guard": 0,
              "clause_off": 1, "group_off": 2, "tcond_col": 3, "tcond_op": 3, "tcond_v0": 3,
              "tcond_v1": 3, "atom_kind": 4, "atom_idx": 4, "tclause_off": 5}


def program_tables(rows: torch.Tensor, dims: tuple) -> dict[str, torch.Tensor]:
    """The kernel's (q_b, MQ_W) program rows back to the packed tables at
    the bucket dims (P, NC, NG, PT, NA, TC): the plain versions' operands
    on a rank that received the rows."""
    out = {}
    for name, o in _LAYOUT.items():
        if name in ("n_groups", "n_tclauses"):
            out[name] = rows[:, o]
            continue
        j = _TABLE_DIM[name]
        n = int(dims[j]) + (1 if name.endswith("_off") else 0)
        t = rows[:, o:o + n]
        out[name] = t.bool() if name == "cond_guard" else t
    return out


def _mq_partial_plain(span_mat: torch.Tensor, span_off: torch.Tensor, progs: dict,
                      row0: int, n_spans: int) -> torch.Tensor:
    """Plain version of M2: the reference's per-shard `fold_rows` and
    `seg_partial` (tempo_tpu/parallel/multiquery.py:57-100) on the row
    slice span_mat (n_sc, Sl) at global row row0 -> (q_b, NG + 1, NT_b)
    partial counts: per group, then the union of live groups."""
    dev = span_off.device
    sl = span_mat.shape[1]
    valid_span = (torch.arange(sl, device=dev) + int(row0)) < int(n_spans)
    off = (span_off.long() - int(row0) + 2**31) % 2**32 - 2**31  # the reference's int32 difference
    lo = torch.clamp(off[:-1], 0, sl)
    hi = torch.clamp(off[1:], 0, sl)
    out = []
    for q in range(progs["cond_op"].shape[0]):
        p = {k: v[q] for k, v in progs.items()}
        x = _take(span_mat, p["cond_col"], span_mat.shape[0])
        m = _cmp_code(p["cond_op"][:, None], x, p["cond_v0"][:, None], p["cond_v1"][:, None])
        m = m & (~p["cond_guard"].bool()[:, None] | (x != int(PAD_I32))) & valid_span[None, :]
        cs = _zcumsum(m, 0)
        co = p["clause_off"].long()
        clause_ok = (_jtake(cs, co[1:]) - _jtake(cs, co[:-1])) > 0
        cs2 = _zcumsum(clause_ok, 0)
        go = p["group_off"].int()
        n_cl = (go[1:] - go[:-1])[:, None]  # int32, as the reference's
        grp_ok = ((_jtake(cs2, go[1:]) - _jtake(cs2, go[:-1])) == n_cl) \
            & valid_span[None, :]
        live = (torch.arange(grp_ok.shape[0], device=dev) < p["n_groups"])[:, None]
        union = torch.any(grp_ok & live, dim=0) if int(p["n_groups"]) > 0 else valid_span
        masks = torch.cat([grp_ok, union[None]])
        cs3 = _zcumsum(masks, 1)
        out.append((cs3[:, hi] - cs3[:, lo]).to(torch.int32))
    return torch.stack(out)


def _mq_combine_plain(counts: torch.Tensor, trace_mat: torch.Tensor, progs: dict,
                      n_traces: int):
    """Plain version of M3: the reference's `combine`
    (tempo_tpu/parallel/multiquery.py:102-125) on the summed counts
    (q_b, NG + 1, NT_b) -> (tm bool, counts int32), each (q_b, NT_b)."""
    dev = counts.device
    nt_b = counts.shape[2]
    valid_trace = torch.arange(nt_b, device=dev) < int(n_traces)
    tms, cnts = [], []
    for q in range(counts.shape[0]):
        p = {k: v[q] for k, v in progs.items()}
        gmask = counts[q, :-1] > 0
        tx = _take(trace_mat, p["tcond_col"], trace_mat.shape[0])
        tcm = _cmp_code(p["tcond_op"][:, None], tx, p["tcond_v0"][:, None], p["tcond_v1"][:, None])
        kind = p["atom_kind"]
        aval = torch.where((kind == 0)[:, None], _take(gmask, p["atom_idx"], gmask.shape[0]),
                           _take(tcm, p["atom_idx"], tcm.shape[0])) & (kind >= 0)[:, None]
        cs4 = _zcumsum(aval, 0)
        to = p["tclause_off"].long()
        tcl_ok = ((_jtake(cs4, to[1:]) - _jtake(cs4, to[:-1])) > 0) | (
            torch.arange(to.shape[0] - 1, device=dev) >= p["n_tclauses"])[:, None]
        tm = torch.all(tcl_ok, dim=0) & valid_trace
        tms.append(tm)
        cnts.append(torch.where(tm, counts[q, -1], 0).to(torch.int32))
    return torch.stack(tms), torch.stack(cnts)


def mq_partial(rows: torch.Tensor, dims: tuple, span_mat: torch.Tensor, row0: int,
               span_off: torch.Tensor, n_spans: int) -> torch.Tensor:
    """M2 on CUDA tensors, its plain version on CPU tensors: rows are the
    kernel's (q_b, MQ_W) program rows at bucket dims `dims`."""
    if rows.device.type == "cpu":
        return _mq_partial_plain(span_mat, span_off, program_tables(rows, dims), row0, n_spans)
    from .. import kernels

    return kernels.mq_partial(rows, dims, span_mat, row0, span_off, n_spans)


def mq_combine(rows: torch.Tensor, dims: tuple, counts: torch.Tensor, trace_mat: torch.Tensor,
               n_traces: int) -> torch.Tensor:
    """M3 on CUDA tensors, its plain version on CPU tensors -> one uint8
    buffer of the int32 counts, then tm (kernels.mq_views reads the two)."""
    if rows.device.type == "cpu":
        tm, cnt = _mq_combine_plain(counts, trace_mat, program_tables(rows, dims), n_traces)
        return torch.cat([cnt.reshape(-1).view(torch.uint8), tm.reshape(-1).view(torch.uint8)])
    from .. import kernels

    return kernels.mq_combine_packed(rows, dims, counts, trace_mat, n_traces)
