"""Shared inputs for the port's filter tests: padded staged columns in
numpy (the layout ops/stage.py produces) and filter cases covering every
op, target and tree shape. numpy only, so both the CPU tests (JAX
reference vs port) and the card tests (kernel vs plain) import it."""

import numpy as np

INT_MAX, INT_MIN = 2**31 - 1, -(2**31)
N_SPANS, N_TRACES, N_RES = 1500, 200, 50
N_SPANS_B, N_TRACES_B, N_RES_B = 2048, 1024, 1024  # ops.device.bucket of the above


def _pad(a, n, fill):
    return np.concatenate([a, np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)])


def _owner_rows(rng, n_owner, max_per):
    per = rng.integers(0, max_per + 1, n_owner)
    off = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    return per, off


def _attr_table(rng, prefix, n_owner, n_owner_b, max_per):
    per, off = _owner_rows(rng, n_owner, max_per)
    n = int(off[-1])
    nb = max(1024, 1 << (max(n, 1) - 1).bit_length())
    vals = rng.integers(-5, 40, n).astype(np.int32)
    vals[::17] = INT_MAX
    f32 = rng.normal(0, 1, n).astype(np.float32)
    f32[::13] = np.float32(1e-40)  # subnormal
    owner = np.repeat(np.arange(n_owner, dtype=np.int32), per)
    return {
        f"{prefix}.{'span' if prefix == 'sattr' else 'res'}": _pad(owner, nb, INT_MIN),
        f"{prefix}.key_id": _pad(rng.integers(0, 6, n).astype(np.int32), nb, INT_MIN),
        f"{prefix}.vtype": _pad(rng.integers(0, 4, n).astype(np.int32), nb, INT_MIN),
        f"{prefix}.str_id": _pad(rng.integers(-1, 60, n).astype(np.int32), nb, INT_MIN),
        f"{prefix}.int32": _pad(vals, nb, INT_MIN),
        f"{prefix}.f32": _pad(f32, nb, INT_MIN),
        f"{prefix}.off": _pad(off, n_owner_b + 1, off[-1]),
    }


def make_cols(seed: int = 0, layout: str = "offsets") -> dict[str, np.ndarray]:
    """Padded staged columns with grouped spans, attr rows grouped by
    owner, roots (-1), orphans (-2), clamp-boundary ints and subnormal,
    signed-zero and infinite floats. layout "offsets" is what staging
    builds (owner offsets, trace.span_off); "owners" keeps the owner
    row columns instead (the reference's segment_max / segment_sum
    forms)."""
    rng = np.random.default_rng(seed)
    per = rng.multinomial(N_SPANS, np.ones(N_TRACES) / N_TRACES)
    span_off = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    sid = np.repeat(np.arange(N_TRACES, dtype=np.int32), per)
    parent = np.full(N_SPANS, -1, np.int32)
    for t in range(N_TRACES):
        lo, hi = span_off[t], span_off[t + 1]
        for s in range(lo + 1, hi):
            r = rng.random()
            parent[s] = -2 if r < 0.1 else (-1 if r < 0.15 else rng.integers(lo, s))
    http = rng.choice(np.asarray([200, 404, 500, -1, INT_MAX, INT_MIN + 1], np.int32), N_SPANS)
    weight = rng.normal(0, 1, N_SPANS).astype(np.float32)
    weight[::11] = np.float32(-0.0)
    weight[::23] = np.float32(np.inf)
    weight[::29] = np.float32(1e-42)
    res_idx = rng.integers(-1, N_RES, N_SPANS).astype(np.int32)
    service = rng.integers(-1, 12, N_RES).astype(np.int32)
    svc_pad = _pad(service, N_RES_B, INT_MIN)
    res_idx_pad = _pad(res_idx, N_SPANS_B, INT_MIN)
    span_at = np.where(res_idx_pad >= 0, svc_pad[np.clip(res_idx_pad, 0, N_RES_B - 1)], INT_MIN)
    cols = {
        "span.trace_sid": _pad(sid, N_SPANS_B, INT_MIN),
        "trace.span_off": _pad(span_off, N_TRACES_B + 1, span_off[-1]),
        "span.kind": _pad(rng.integers(1, 6, N_SPANS).astype(np.int32), N_SPANS_B, INT_MIN),
        "span.dur_us": _pad(rng.integers(0, 3_000_000, N_SPANS).astype(np.int32), N_SPANS_B, INT_MIN),
        "span.http_status": _pad(http, N_SPANS_B, INT_MIN),
        "span.name_id": _pad(rng.integers(-1, 3000, N_SPANS).astype(np.int32), N_SPANS_B, INT_MIN),
        "span.weight": _pad(weight, N_SPANS_B, np.float32(0)),
        "span.res_idx": res_idx_pad,
        "span.parent_idx": _pad(parent, N_SPANS_B, INT_MIN),
        "res.service_id": svc_pad,
        "span@res.service_id": span_at.astype(np.int32),
        "trace.dur_us": _pad(rng.integers(0, 5_000_000, N_TRACES).astype(np.int32), N_TRACES_B, INT_MIN),
        "trace.weight": _pad(rng.normal(0, 1, N_TRACES).astype(np.float32), N_TRACES_B, np.float32(0)),
    }
    cols.update(_attr_table(rng, "sattr", N_SPANS, N_SPANS_B, 3))
    cols.update(_attr_table(rng, "rattr", N_RES, N_RES_B, 8))
    drop = ("sattr.span", "rattr.res") if layout == "offsets" else (
        "sattr.off", "rattr.off", "trace.span_off")
    return {k: v for k, v in cols.items() if k not in drop}


OPS = ("eq", "ne", "ne_present", "lt", "le", "gt", "ge", "range",
       "exists", "ne_clamped", "intable", "notintable")


def _table(n, seed):
    return (np.random.default_rng(seed).random(n) < 0.4).astype(np.uint8)


def _case_for_op(op):
    """One span-target cond per op, on a column where the op bites."""
    if op in ("intable", "notintable"):  # codes up to 3000 clip into a 40-entry table
        return ((("span", "span.name_id", op, False),), ("cond", 0),
                [(0, 0, 0, 0.0, 0.0)], {0: _table(40, 1)})
    v0, v1 = (200, 499) if op == "range" else (200, 0)
    return ((("span", "span.http_status", op, False),), ("cond", 0),
            [(0, v0, v1, 0.0, 0.0)], None)


def filter_cases():
    """name -> (cond specs (target, col, op, is_float), tree, operand rows, tables)."""
    cases = {f"op_{op}": _case_for_op(op) for op in OPS}
    row = lambda key=0, v0=0, v1=0, f0=0.0, f1=0.0: (key, v0, v1, f0, f1)  # noqa: E731
    cases.update({
        "ne_clamped_max": ((("span", "span.http_status", "ne_clamped", False),), ("cond", 0),
                           [row(v0=INT_MAX)], None),
        "ne_clamped_min": ((("span", "span.http_status", "ne_clamped", False),), ("cond", 0),
                           [row(v0=INT_MIN + 1)], None),
        "float_col_float_op": ((("span", "span.weight", "lt", True),), ("cond", 0),
                               [row(f0=0.25)], None),
        "float_col_range": ((("span", "span.weight", "range", True),), ("cond", 0),
                            [row(f0=-0.0, f1=1e-30)], None),
        "float_col_int_op": ((("span", "span.weight", "ge", False),), ("cond", 0),
                             [row(v0=0)], None),
        "int_col_float_op": ((("span", "span.dur_us", "gt", True),), ("cond", 0),
                             [row(f0=1_000_000.5)], None),
        "trace_int": ((("trace", "trace.dur_us", "range", False),), ("cond", 0),
                      [row(v0=1_000_000, v1=3_000_000)], None),
        "trace_float": ((("trace", "trace.weight", "gt", True),), ("cond", 0),
                        [row(f0=0.0)], None),
        "res_eq": ((("res", "res.service_id", "eq", False),), ("cond", 0), [row(v0=3)], None),
        "res_ne_present": ((("res", "res.service_id", "ne_present", False),), ("cond", 0),
                           [row(v0=3)], None),
        "res_intable": ((("res", "res.service_id", "intable", False),), ("cond", 0),
                        [row()], {0: _table(8, 2)}),
        "sattr_str": ((("sattr", "str", "eq", False),), ("cond", 0), [row(key=2, v0=7)], None),
        "sattr_int": ((("sattr", "int", "ge", False),), ("cond", 0), [row(key=1, v0=20)], None),
        "sattr_float": ((("sattr", "float", "lt", True),), ("cond", 0), [row(key=3, f0=-0.5)], None),
        "sattr_bool": ((("sattr", "bool", "eq", False),), ("cond", 0), [row(key=4, v0=1)], None),
        "sattr_any": ((("sattr", "any", "exists", False),), ("cond", 0), [row(key=5)], None),
        "sattr_table": ((("sattr", "str", "notintable", False),), ("cond", 0),
                        [row(key=0)], {0: _table(30, 3)}),
        "rattr_str": ((("rattr", "str", "eq", False),), ("cond", 0), [row(key=2, v0=9)], None),
        "rattr_int": ((("rattr", "int", "range", False),), ("cond", 0),
                      [row(key=1, v0=0, v1=INT_MAX)], None),
        "rattr_float": ((("rattr", "float", "gt", True),), ("cond", 0), [row(key=0, f0=0.5)], None),
        "rattr_any": ((("rattr", "any", "exists", False),), ("cond", 0), [row(key=3)], None),
        "rattr_table": ((("rattr", "str", "intable", False),), ("cond", 0),
                        [row(key=4)], {0: _table(64, 4)}),
        "and_or_mixed": (
            (("span", "span.kind", "eq", False), ("sattr", "int", "lt", False),
             ("trace", "trace.dur_us", "gt", False), ("rattr", "str", "ne_present", False)),
            ("or", ("and", ("cond", 0), ("cond", 1)), ("cond", 2), ("cond", 3)),
            [row(v0=2), row(key=1, v0=10), row(v0=4_000_000), row(key=2, v0=5)], None),
        "two_tracify": (
            (("span", "span.kind", "eq", False), ("span", "span.kind", "eq", False),
             ("trace", "trace.dur_us", "lt", False)),
            ("and", ("tracify", ("cond", 0)), ("tracify", ("cond", 1)), ("cond", 2)),
            [row(v0=2), row(v0=3), row(v0=4_000_000)], None),
        "child": ((("span", "span.kind", "eq", False), ("span", "span.kind", "eq", False)),
                  ("tracify", ("struct", ">", ("cond", 0), ("cond", 1))),
                  [row(v0=2), row(v0=3)], None),
        "descendant": ((("span", "span.kind", "eq", False), ("sattr", "any", "exists", False)),
                       ("tracify", ("struct", ">>", ("cond", 0), ("cond", 1))),
                       [row(v0=1), row(key=2)], None),
        "sibling_orphans": ((("span", "span.kind", "le", False), ("span", "span.kind", "ge", False)),
                            ("tracify", ("struct", "~", ("cond", 0), ("cond", 1))),
                            [row(v0=2), row(v0=4)], None),
        "nested_struct": (
            (("span", "span.kind", "eq", False), ("res", "res.service_id", "ge", False),
             ("span", "span.http_status", "eq", False)),
            ("tracify", ("struct", ">>", ("struct", ">", ("cond", 0), ("cond", 1)), ("cond", 2))),
            [row(v0=1), row(v0=5), row(v0=500)], None),
        "struct_true_lhs": ((("span", "span.kind", "eq", False),),
                            ("and", ("tracify", ("struct", ">", ("true",), ("cond", 0))),
                             ("tracify", ("struct", "~", ("false",), ("cond", 0)))),
                            [row(v0=3)], None),
        "tree_none": ((), None, [], None),
        "many_tracify": (tuple(("span", "span.kind", "eq", False) for _ in range(40)),
                         ("or",) + tuple(("tracify", ("cond", i)) for i in range(40)),
                         [row(v0=6 + i) for i in range(39)] + [row(v0=3)], None),
    })
    return cases


# ------------------------------------------------- multi-query programs (B5a)

MQ_SPAN_COLS = ("span.dur_us", "span.http_status", "span.kind", "span@res.service_id")
MQ_TRACE_COLS = ("trace.dur_us",)
MQ_DIMS = dict(n_conds_b=8, n_clauses_b=4, n_groups_b=2, n_tconds_b=2, n_atoms_b=4,
               n_tclauses_b=2)


def mq_cols(seed: int = 0) -> dict[str, np.ndarray]:
    """make_cols, with a span layout that has empty traces and traces
    longer than a warp (0-70 spans each), for the multi-query program."""
    rng = np.random.default_rng(seed)
    cols = make_cols(seed)
    per = rng.integers(0, 16, N_TRACES)
    per[::9] = 0
    per[5::23] = 70
    per = np.floor(per * (N_SPANS / per.sum())).astype(np.int64)
    per[-1] += N_SPANS - per.sum()
    span_off = np.concatenate([[0], np.cumsum(per)]).astype(np.int32)
    cols["trace.span_off"] = _pad(span_off, N_TRACES_B + 1, span_off[-1])
    cols["span.trace_sid"] = _pad(np.repeat(np.arange(N_TRACES, dtype=np.int32), per),
                                  N_SPANS_B, INT_MIN)
    return cols


def _mq_operands(rng, col: str) -> tuple[int, int]:
    lo, hi = {"span.dur_us": (0, 3_000_000), "span.http_status": (-1, 600),
              "span.kind": (0, 7), "span@res.service_id": (-1, 13),
              "trace.dur_us": (0, 5_000_000)}[col]
    a, b = sorted(int(x) for x in rng.integers(lo, hi, 2))
    return a, b


def random_program(rng, n_groups: int | None = None, dims: dict | None = None) -> dict:
    """One well-formed CNF program over mq_cols at MQ_DIMS (or dims, such
    as a condition table whose length is no power of two), as the arrays
    LoweredQuery.from_arrays takes (monotone offsets, padded slots op -1,
    span@res conditions guarded)."""
    d = MQ_DIMS if dims is None else dims
    P, NC, NG = d["n_conds_b"], d["n_clauses_b"], d["n_groups_b"]
    PT, NA, TC = d["n_tconds_b"], d["n_atoms_b"], d["n_tclauses_b"]
    ng = int(rng.integers(0, NG + 1)) if n_groups is None else n_groups
    cond_col, cond_op = np.zeros(P, np.int32), np.full(P, -1, np.int32)
    cond_v0, cond_v1 = np.zeros(P, np.int32), np.zeros(P, np.int32)
    guard = np.zeros(P, bool)
    clause_off, group_off = np.zeros(NC + 1, np.int32), np.zeros(NG + 1, np.int32)
    s = c = 0
    for g in range(ng):
        group_off[g] = c
        for _ in range(int(rng.integers(0, (NC // NG) + 1))):
            clause_off[c] = s
            for _ in range(int(rng.integers(1, (P // NC) + 1))):
                j = int(rng.integers(0, len(MQ_SPAN_COLS)))
                cond_col[s], cond_op[s] = j, int(rng.integers(0, 8))
                cond_v0[s], cond_v1[s] = _mq_operands(rng, MQ_SPAN_COLS[j])
                guard[s] = MQ_SPAN_COLS[j].startswith("span@")
                s += 1
            c += 1
            clause_off[c] = s
    group_off[ng:] = c
    clause_off[c:] = s
    tcond_col, tcond_op = np.zeros(PT, np.int32), np.full(PT, -1, np.int32)
    tcond_v0, tcond_v1 = np.zeros(PT, np.int32), np.zeros(PT, np.int32)
    for j in range(int(rng.integers(0, PT + 1))):
        tcond_op[j] = int(rng.integers(0, 8))
        tcond_v0[j], tcond_v1[j] = _mq_operands(rng, "trace.dur_us")
    atom_kind, atom_idx = np.full(NA, -1, np.int32), np.zeros(NA, np.int32)
    tclause_off = np.zeros(TC + 1, np.int32)
    ntc = int(rng.integers(0, TC + 1))
    a = 0
    for t in range(ntc):
        tclause_off[t] = a
        for _ in range(int(rng.integers(1, NA // TC + 1))):
            kind = 0 if ng and rng.random() < 0.6 else 1
            atom_kind[a] = kind
            atom_idx[a] = rng.integers(0, ng) if kind == 0 else rng.integers(0, PT)
            a += 1
        tclause_off[t + 1] = a
    tclause_off[ntc:] = a
    return dict(cond_col=cond_col, cond_op=cond_op, cond_v0=cond_v0, cond_v1=cond_v1,
                cond_guard=guard, clause_off=clause_off, group_off=group_off, n_groups=ng,
                tcond_col=tcond_col, tcond_op=tcond_op, tcond_v0=tcond_v0, tcond_v1=tcond_v1,
                atom_kind=atom_kind, atom_idx=atom_idx, tclause_off=tclause_off,
                n_tclauses=ntc, span_cols=MQ_SPAN_COLS, trace_cols=MQ_TRACE_COLS)


# ------------------------------------------------------ timeseries fold (B6)


def hostile_program(arrays: dict, rng, kind: int) -> dict:
    """The program with offset tables lower_plan never writes: permuted
    (kind 1: runs out of order), or with entries below zero and past
    their table (kind 2: the reference's gathers count a negative index
    from the end, then clamp)."""
    out = dict(arrays)
    for f in ("clause_off", "group_off", "tclause_off"):
        a = np.asarray(arrays[f]).copy()
        if kind == 1:
            a = rng.permutation(a)
        else:
            a[rng.random(a.shape[0]) < 0.3] = rng.integers(-6, 12, a.shape[0])[:1]
        out[f] = a
    return out


def hostile_cols(seed: int) -> dict:
    """mq_cols with span offsets that run backwards for some traces and
    fall below zero for others."""
    cols = mq_cols(seed)
    off = cols["trace.span_off"].copy()
    rng = np.random.default_rng(seed)
    for t in rng.choice(N_TRACES, 12, replace=False):
        off[t], off[t + 1] = off[t + 1], off[t]
    off[rng.choice(N_TRACES, 4, replace=False)] = rng.integers(-40, -1, 4)
    cols["trace.span_off"] = off
    return cols


def span_level_cases() -> dict:
    """The filter cases whose tree is span level (no tracify, no struct):
    the trees the metrics planner emits."""
    def lifted(t):
        return isinstance(t, tuple) and (t[0] in ("tracify", "struct")
                                         or any(lifted(c) for c in t[1:]))
    return {k: v for k, v in filter_cases().items() if not lifted(v[1])}


def ts_inputs(seed: int, n_groups: int, dyadic: bool = False) -> dict[str, np.ndarray]:
    """Per-span inputs of the timeseries fold over make_cols' spans:
    span.start_ms (block-relative, some negative), group ids with -1,
    f32 values and a presence mask. Plain values are positive, so an f32
    sum taken in another order stays within rtol 1e-5, with a few NaNs,
    which a cell's sum, min and max must propagate; dyadic values are
    signed multiples of 1/8 below 64 in magnitude, whose sums are exact
    in f32 in any order, with signed zeros (-0.0 below +0.0 in min and
    max, as in XLA)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(-5_000, 600_000, N_SPANS).astype(np.int32)
    gid = rng.integers(-1, n_groups, N_SPANS).astype(np.int32)
    if dyadic:
        val = (rng.integers(-511, 512, N_SPANS) / 8).astype(np.float32)
        val[::41] = np.float32(-0.0)
    else:
        val = rng.lognormal(0, 2, N_SPANS).astype(np.float32)
        val[::211] = np.float32(np.nan)
    return {"span.start_ms": _pad(start, N_SPANS_B, INT_MIN), "gid": _pad(gid, N_SPANS_B, -1),
            "val": _pad(val, N_SPANS_B, np.float32(0)),
            "vpres": _pad(rng.random(N_SPANS) < 0.8, N_SPANS_B, False)}
