"""Host (numpy) span-mask engine (port of the span-level half of
tempo_tpu/ops/hostfilter.py).

The metrics executor needs a span-level mask on the host in two places:
the exact engine narrows its candidate traces with it, and the
i32-overflow route folds with it (ops/timeseries.eval_timeseries_host).
Everything is O(rows) numpy over RAW unpadded columns with the device
filter's semantics (conservative encodings, same needs_verify
contract): predicate masks, attr -> span scatter via bincount,
resource -> span and trace -> span gathers.

The trace-level host engine (`eval_block_host`, the tres axis) and the
search path's host routing are not part of the port yet.
"""

from __future__ import annotations

import numpy as np

from .filter import (
    Cond,
    Operands,
    T_RATTR,
    T_RES,
    T_SATTR,
    T_SPAN,
    T_TRACE,
    _ATTR_VALUE_COL,
    _VT_CODE,
)


def _cmp_np(op: str, x: np.ndarray, v0, v1, f0, f1, is_float: bool, table):
    a, b = (f0, f1) if is_float else (v0, v1)
    if op == "eq":
        return x == a
    if op == "ne":
        return x != a
    if op == "ne_present":
        return (x != a) & (x >= 0)
    if op == "ne_clamped":
        return (x != a) | (x == 2**31 - 1) | (x == -(2**31) + 1)
    if op == "lt":
        return x < a
    if op == "le":
        return x <= a
    if op == "gt":
        return x > a
    if op == "ge":
        return x >= a
    if op == "range":
        return (x >= a) & (x <= b)
    if op == "exists":
        return np.ones(x.shape, dtype=bool)
    if op in ("intable", "notintable"):
        t = np.asarray(table)
        hit = t[np.clip(x, 0, t.shape[0] - 1)] > 0
        if op == "notintable":
            hit = ~hit
        return hit & (x >= 0)
    raise ValueError(f"unknown op {op}")


def _scatter_owner(row_hit: np.ndarray, owner: np.ndarray, n: int) -> np.ndarray:
    """OR rows onto their owner axis: True where any owned row hit."""
    if not row_hit.any():
        return np.zeros(n, dtype=bool)
    o = owner[row_hit]
    o = o[(o >= 0) & (o < n)]
    return np.bincount(o, minlength=n).astype(bool)


def _lut_gather(table_mask: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """table mask -> span mask through an index column; negative and
    out-of-range indices (absent resource) never match."""
    table_mask = np.asarray(table_mask, dtype=bool)
    ok = (idx >= 0) & (idx < table_mask.shape[0])
    out = np.zeros(idx.shape[0], dtype=bool)
    out[ok] = table_mask[idx[ok]]
    return out


def _cond_mask_np(c: Cond, i: int, cols, ops_i, ops_f, tables, n_spans, n_res):
    key, v0, v1 = int(ops_i[i, 0]), int(ops_i[i, 1]), int(ops_i[i, 2])
    f0, f1 = float(ops_f[i, 0]), float(ops_f[i, 1])
    table = tables.get(i)
    if c.target == T_SPAN:
        return _cmp_np(c.op, cols[c.col], v0, v1, f0, f1, c.is_float, table)
    if c.target == T_RES:
        rm = _cmp_np(c.op, cols[c.col], v0, v1, f0, f1, c.is_float, table)
        return _lut_gather(rm, cols["span.res_idx"])
    if c.target in (T_SATTR, T_RATTR):
        pre = c.target
        key_match = cols[f"{pre}.key_id"] == key
        if c.col == "any":
            row_hit = key_match
        else:
            vcol = cols[f"{pre}.{_ATTR_VALUE_COL[c.col]}"]
            vt_ok = cols[f"{pre}.vtype"] == _VT_CODE[c.col]
            row_hit = key_match & vt_ok & _cmp_np(c.op, vcol, v0, v1, f0, f1, c.is_float, table)
        if pre == T_SATTR:
            return _scatter_owner(row_hit, cols["sattr.span"], n_spans)
        res_hit = _scatter_owner(row_hit, cols["rattr.res"], n_res)
        return _lut_gather(res_hit, cols["span.res_idx"])
    raise ValueError(f"bad target {c.target}")


def _struct_mask_np(op: str, lm: np.ndarray, rm: np.ndarray,
                    pidx: np.ndarray, n_spans: int) -> np.ndarray:
    """Exact structural relation over the parent-row column (numpy twin
    of ops.filter's ev_struct): result spans = rhs matches standing in
    `op` relation to some lhs match."""
    has_p = pidx >= 0
    safe = np.clip(pidx, 0, max(n_spans - 1, 0))
    if op == ">":
        return rm & has_p & lm[safe]
    if op == ">>":
        acc = has_p & lm[safe]
        ptr = np.where(has_p, safe, -1)
        for _ in range(max(1, int(n_spans - 1).bit_length())):
            alive = ptr >= 0
            if not alive.any():
                break
            psafe = np.clip(ptr, 0, n_spans - 1)
            new_acc = acc | (alive & acc[psafe])
            ptr = np.where(alive, ptr[psafe], -1)
            if (new_acc == acc).all() and (ptr < 0).all():
                acc = new_acc
                break
            acc = new_acc
        return rm & acc
    # '~': some DIFFERENT lhs span with the same parent. Orphan rows
    # (parent_idx == -2) over-match when any lhs orphan exists; the plan
    # flags '~' trees needs_verify so the host settles the exact pairs
    lhs_child = (lm & has_p)
    cnt = np.bincount(safe[lhs_child], minlength=n_spans) if n_spans else np.zeros(0, int)
    sibs = cnt[safe] - lhs_child.astype(np.int64)
    orphan = pidx == -2
    return (rm & has_p & (sibs > 0)) | (rm & orphan & bool((lm & orphan).any()))


def eval_span_mask_host(
    query,
    cols: dict[str, np.ndarray],
    operands: Operands,
    n_spans: int,
    n_traces: int,
) -> np.ndarray:
    """SPAN-level mask of a raw (un-lifted) condition tree -- the host
    engine of the metrics path (db/metrics_exec): no tracify nodes, no
    trace-level output. Trace-target conds evaluate on the trace axis
    and gather to spans through span.trace_sid (a span inherits its
    trace's truth value). Returns a bool (n_spans,) mask with the same
    conservative-encoding semantics as the device engine."""
    tree, conds = query
    if tree is None:
        return np.ones(n_spans, dtype=bool)
    tables = operands.tables or {}
    ops_i, ops_f = operands.ints, operands.floats
    n_res = 0
    for n, a in cols.items():
        if n.startswith("res."):
            n_res = max(n_res, a.shape[0])
    tsid = cols.get("span.trace_sid")

    def ev(t):
        if t == ("true",):
            return np.ones(n_spans, dtype=bool)
        if t == ("false",):
            return np.zeros(n_spans, dtype=bool)
        if t[0] == "cond":
            i = t[1]
            c = conds[i]
            if c.target == T_TRACE:
                tm = _cmp_np(c.op, cols[c.col], int(ops_i[i, 1]), int(ops_i[i, 2]),
                             float(ops_f[i, 0]), float(ops_f[i, 1]), c.is_float,
                             tables.get(i))
                return _lut_gather(np.asarray(tm, dtype=bool), tsid)
            return _cond_mask_np(c, i, cols, ops_i, ops_f, tables, n_spans, n_res)
        ms = [ev(ch) for ch in t[1:]]
        out = ms[0]
        for m in ms[1:]:
            out = (out & m) if t[0] == "and" else (out | m)
        return out

    return ev(tree) & np.ones(n_spans, dtype=bool)
