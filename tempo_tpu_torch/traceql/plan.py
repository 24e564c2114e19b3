"""TraceQL planner: AST -> device condition tree for one block.

The condition->column routing of the reference's
vparquet/block_traceql.go:330-451, re-targeted at vtpu columns:
intrinsics map to dedicated span/trace columns, well-known attrs to
dedicated columns, everything else to the generic attr tables; an
either-scope `.attr` ORs the span- and resource-side plans. String
operands resolve through the block dictionary (a miss folds to a
constant, which can prune the whole block); regexes evaluate host-side
over the dictionary into a code table (one device gather per row).

Durations compare exactly: nanos split into (us, ns-remainder) column
pairs => two-lane integer compares, no f64 needed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace

import numpy as np

from ..block.dictionary import Dictionary
from ..ops.filter import Cond, normalize_tree
from .ast import (
    Comparison,
    Field,
    LogicalExpr,
    MetricsQuery,
    ParseError,
    Pipeline,
    Scope,
    SpansetFilter,
    SpansetOp,
    Static,
)

_IMPOSSIBLE_CODE = -3  # operand code that matches no row (codes are >= -1)

_WELL_KNOWN_SPAN = {"http.method": "span.http_method_id", "http.url": "span.http_url_id"}
_WELL_KNOWN_SPAN_INT = {"http.status_code": "span.http_status"}
_WELL_KNOWN_RES = {
    "service.name": "res.service_id",
    "k8s.cluster.name": "res.cluster_id",
    "k8s.namespace.name": "res.namespace_id",
    "k8s.pod.name": "res.pod_id",
    "k8s.container.name": "res.container_id",
}

_OP_MAP = {"=": "eq", "!=": "ne_present", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}

TRUE = ("true",)
FALSE = ("false",)


@dataclass
class Plan:
    """Accumulates conditions while folding constants."""

    conds: list[Cond] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    tables: dict[int, np.ndarray] = field(default_factory=dict)
    # set when some construct couldn't be compiled to device conds (field
    # arithmetic, parent scope, childCount, ...): the plan over-matches
    # (TRUE leaf) and every candidate is exactly re-checked on host
    force_verify: bool = False

    def cond(self, c: Cond, key: int = 0, v0: int = 0, v1: int = 0, f0: float = 0.0,
             f1: float = 0.0, table: np.ndarray | None = None):
        self.conds.append(c)
        self.rows.append((key, v0, v1, f0, f1))
        i = len(self.conds) - 1
        if table is not None:
            self.tables[i] = table
        return ("cond", i)


def _fold(op: str, children: list):
    """and/or with true/false constant folding."""
    out = []
    for ch in children:
        if ch == TRUE:
            if op == "or":
                return TRUE
            continue
        if ch == FALSE:
            if op == "and":
                return FALSE
            continue
        out.append(ch)
    if not out:
        return TRUE if op == "and" else FALSE
    if len(out) == 1:
        return out[0]
    return (op,) + tuple(out)


def _regex_table(d: Dictionary, pattern: str) -> np.ndarray:
    rx = re.compile(pattern)
    return np.fromiter((1 if rx.search(s) else 0 for s in d.strings), dtype=np.uint8, count=len(d.strings))


def _dur_pair_tree(p: Plan, target: str, us_col: str, lo_col: str, op: str, dur_ns: int):
    """Exact duration compare via the (us, ns%1000) column pair."""
    q, r = divmod(max(0, int(dur_ns)), 1000)
    INT_MAX = 2**31 - 1
    if q >= INT_MAX:
        # the us column is clamped at INT_MAX (builder); operands at/past
        # the clamp can't compare exactly on device -- match conservatively
        # and let the host re-verify (needs_verify consumer, db/search.py)
        if op in (">", ">=", "="):
            # only clamped spans can possibly satisfy this
            return p.cond(Cond(target=target, col=us_col, op="eq", needs_verify=True),
                          v0=INT_MAX)
        # <, <=, != : any span might satisfy it
        return p.cond(Cond(target=target, col=us_col, op="range", needs_verify=True),
                      v0=0, v1=INT_MAX)

    def c(col, cop, v):
        return p.cond(Cond(target=target, col=col, op=cop), v0=v)

    if op == "=":
        return _fold("and", [c(us_col, "eq", q), c(lo_col, "eq", r)])
    if op == "!=":
        return _fold("or", [c(us_col, "ne", q), c(lo_col, "ne", r)])
    if op in (">", ">="):
        lo_op = "gt" if op == ">" else "ge"
        return _fold("or", [c(us_col, "gt", q), _fold("and", [c(us_col, "eq", q), c(lo_col, lo_op, r)])])
    if op in ("<", "<="):
        lo_op = "lt" if op == "<" else "le"
        return _fold("or", [c(us_col, "lt", q), _fold("and", [c(us_col, "eq", q), c(lo_col, lo_op, r)])])
    raise ParseError(f"cannot {op} a duration")


def _str_col_cond(p: Plan, d: Dictionary, target: str, col: str, op: str, value) -> tuple:
    """String compare against a dedicated code column."""
    if op in ("=~", "!~"):
        table = _regex_table(d, str(value))
        kind = "intable" if op == "=~" else "notintable"
        return p.cond(Cond(target=target, col=col, op=kind), table=table)
    code = d.lookup(str(value))
    if op == "=":
        if code < 0:
            return FALSE
        return p.cond(Cond(target=target, col=col, op="eq"), v0=code)
    if op == "!=":
        return p.cond(
            Cond(target=target, col=col, op="ne_present"),
            v0=code if code >= 0 else _IMPOSSIBLE_CODE,
        )
    # ordered string compares use the sorted-dictionary property:
    # code order == lexicographic order
    lo, hi = 0, len(d) - 1
    import bisect

    pos = bisect.bisect_left(d.strings, str(value))
    exact = pos < len(d) and d.strings[pos] == str(value)
    if op == "<":
        return FALSE if pos == 0 else p.cond(Cond(target=target, col=col, op="range"), v0=0, v1=pos - 1)
    if op == "<=":
        end = pos if exact else pos - 1
        return FALSE if end < 0 else p.cond(Cond(target=target, col=col, op="range"), v0=0, v1=end)
    if op == ">":
        start = pos + 1 if exact else pos
        return FALSE if start > hi else p.cond(Cond(target=target, col=col, op="range"), v0=start, v1=hi)
    if op == ">=":
        return FALSE if pos > hi else p.cond(Cond(target=target, col=col, op="range"), v0=pos, v1=hi)
    raise ParseError(f"unsupported string op {op}")


def _attr_cond(p: Plan, d: Dictionary, table_target: str, key: str, op: str, lit: Static) -> tuple:
    """Generic attr-table condition (sattr or rattr)."""
    kcode = d.lookup(key)
    if kcode < 0:
        # key never appears in this block: != and exists-negative fold false
        return FALSE
    if op == "exists":
        return p.cond(Cond(target=table_target, col="any", op="exists"), key=kcode)
    if lit.kind == "str":
        if op in ("=~", "!~"):
            table = _regex_table(d, str(lit.value))
            kind = "intable" if op == "=~" else "notintable"
            return p.cond(Cond(target=table_target, col="str", op=kind), key=kcode, table=table)
        code = d.lookup(str(lit.value))
        if op == "=":
            if code < 0:
                return FALSE
            return p.cond(Cond(target=table_target, col="str", op="eq"), key=kcode, v0=code)
        if op == "!=":
            return p.cond(
                Cond(target=table_target, col="str", op="ne_present"),
                key=kcode,
                v0=code if code >= 0 else _IMPOSSIBLE_CODE,
            )
        raise ParseError(f"unsupported string op {op} on attribute")
    if lit.kind == "bool":
        if op not in ("=", "!="):
            raise ParseError("booleans support = and != only")
        mapped = "eq" if op == "=" else "ne"
        return p.cond(Cond(target=table_target, col="bool", op=mapped), key=kcode, v0=1 if lit.value else 0)
    if lit.kind in ("int", "duration"):
        v = int(lit.value)
        clamped = not (-(2**31) < v < 2**31)
        mop = _OP_MAP[op] if op != "!=" else "ne"
        int_c = p.cond(
            Cond(target=table_target, col="int", op=mop, needs_verify=clamped),
            key=kcode,
            v0=int(np.clip(v, -(2**31) + 1, 2**31 - 1)),
        )
        # numbers also match float-typed attrs (TraceQL numeric compare)
        flt_c = p.cond(
            Cond(target=table_target, col="float", op=mop, is_float=True, needs_verify=True),
            key=kcode,
            f0=float(v),
        )
        return _fold("or", [int_c, flt_c])
    if lit.kind == "float":
        mop = _OP_MAP[op] if op != "!=" else "ne"
        flt_c = p.cond(
            Cond(target=table_target, col="float", op=mop, is_float=True, needs_verify=True),
            key=kcode,
            f0=float(lit.value),
        )
        int_c = p.cond(
            Cond(target=table_target, col="int", op=mop, needs_verify=True),
            key=kcode,
            v0=int(np.clip(lit.value, -(2**31) + 1, 2**31 - 1)),
        )
        return _fold("or", [flt_c, int_c])
    raise ParseError(f"unsupported literal kind {lit.kind}")


def _plan_comparison(p: Plan, d: Dictionary, cmp: Comparison) -> tuple:
    f, op, lit = cmp.field, cmp.op, cmp.value

    if f.scope == Scope.INTRINSIC:
        if f.name == "name":
            if op == "exists":
                return TRUE
            return _str_col_cond(p, d, "span", "span.name_id", op, lit.value)
        if f.name == "duration":
            if lit.kind not in ("duration", "int", "float"):
                raise ParseError("duration compares against a duration literal")
            ns = int(lit.value)
            return _dur_pair_tree(p, "span", "span.dur_us", "span.dur_lo", op, ns)
        if f.name == "traceDuration":
            ns = int(lit.value)
            return _dur_pair_tree(p, "trace", "trace.dur_us", "trace.dur_lo", op, ns)
        if f.name == "status":
            if lit.kind not in ("status", "int"):
                raise ParseError("status compares against ok/error/unset")
            mapped = _OP_MAP.get(op)
            if mapped is None:
                raise ParseError(f"unsupported status op {op}")
            if mapped == "ne_present":
                mapped = "ne"
            return p.cond(Cond(target="span", col="span.status", op=mapped), v0=int(lit.value))
        if f.name == "kind":
            if lit.kind not in ("kind", "int"):
                raise ParseError("kind compares against server/client/...")
            mapped = _OP_MAP.get(op)
            if mapped is None:
                raise ParseError(f"unsupported kind op {op}")
            if mapped == "ne_present":
                mapped = "ne"
            return p.cond(Cond(target="span", col="span.kind", op=mapped), v0=int(lit.value))
        if f.name == "rootName":
            return _str_col_cond(p, d, "trace", "trace.root_name_id", op, lit.value)
        if f.name == "rootServiceName":
            return _str_col_cond(p, d, "trace", "trace.root_service_id", op, lit.value)
        raise ParseError(f"intrinsic {f.name} not supported")

    alts = []
    if f.scope in (Scope.SPAN, Scope.EITHER):
        ded = _WELL_KNOWN_SPAN.get(f.name)
        ded_int = _WELL_KNOWN_SPAN_INT.get(f.name)
        if ded is not None and lit.kind == "str" and op != "exists":
            alts.append(_str_col_cond(p, d, "span", ded, op, lit.value))
        elif ded_int is not None and lit.kind in ("int", "float") and op != "exists":
            mapped = _OP_MAP[op] if op != "!=" else "ne_present"
            alts.append(
                p.cond(Cond(target="span", col=ded_int, op=mapped), v0=int(lit.value))
            )
        else:
            alts.append(_attr_cond(p, d, "sattr", f.name, op, lit))
    if f.scope in (Scope.RESOURCE, Scope.EITHER):
        ded = _WELL_KNOWN_RES.get(f.name)
        if ded is not None and lit.kind == "str" and op != "exists":
            alts.append(_str_col_cond(p, d, "res", ded, op, lit.value))
        elif ded is not None and op == "exists":
            # well-known res attrs live ONLY in dedicated columns
            # (builder.py res_dedicated); -1 marks absent
            alts.append(p.cond(Cond(target="res", col=ded, op="ge"), v0=0))
        else:
            alts.append(_attr_cond(p, d, "rattr", f.name, op, lit))
    return _fold("or", alts)


def _tree_has_sibling(t) -> bool:
    if not isinstance(t, tuple) or t in (TRUE, FALSE) or t[0] == "cond":
        return False
    if t[0] == "struct":
        return t[1] == "~" or any(_tree_has_sibling(ch) for ch in t[2:])
    return any(_tree_has_sibling(ch) for ch in t[1:])


def _tree_has_trace_cond(t, conds) -> bool:
    if t in (TRUE, FALSE):
        return False
    if t[0] == "cond":
        return conds[t[1]].target == "trace"
    if t[0] == "struct":
        return any(_tree_has_trace_cond(ch, conds) for ch in t[2:])
    return any(_tree_has_trace_cond(ch, conds) for ch in t[1:])


def _span_tree(p: Plan, d: Dictionary, q):
    """Span-level tree for a spanset expression, or None when it can't
    be expressed purely at span level (trace-target conds, pipelines,
    unplannable constructs, && / || combinators whose result spanset is
    trace-dependent)."""
    if isinstance(q, SpansetFilter):
        if q.expr is None:
            return TRUE
        fv0 = p.force_verify
        t = _plan_expr(p, d, q.expr)
        if (p.force_verify and not fv0) or _tree_has_trace_cond(t, p.conds):
            return None
        return t
    if isinstance(q, SpansetOp) and q.op in (">", ">>", "~"):
        lt = _span_tree(p, d, q.lhs)
        rt = _span_tree(p, d, q.rhs)
        if lt is None or rt is None:
            return None
        return ("struct", q.op, lt, rt)
    return None


def _plan_spanset_expr(p: Plan, d: Dictionary, q, allow_struct: bool = True) -> tuple[tuple, bool]:
    """Spanset expression -> (trace-level tree, needs host verification).
    Each leaf spanset tracifies independently; && combinators AND them
    (a qualifying trace must contain every leaf's spans), || ORs.

    Structural relations (> >> ~) over pure span-level sides compile to
    EXACT ('struct', op, lhs, rhs) span trees: the engines resolve the
    relation with parent-row gathers / segment sums over
    span.parent_idx, so no host verification is needed. Anything the
    struct compiler can't express falls back to the conservative
    trace-level AND of both sides + exact host verification."""
    if isinstance(q, SpansetFilter):
        if q.expr is None:
            return TRUE, False
        t = _plan_expr(p, d, q.expr)
        if t in (TRUE, FALSE):
            return t, False
        # lift instead of blind-wrapping: a trace-target cond inside
        # ('tracify', ...) would reach the engines' SPAN evaluators and
        # crash (fuzz-found on `{...} ~ { traceDuration > 1ms }`).
        # normalize_tree keeps this leaf's span conds in ONE tracify
        # group (same-span semantics) with trace conds alongside. The
        # mixed-or verify flag is computed on the RAW tree here and
        # propagated by the combinator fold: _finish's _mixed_or can't
        # see through the pre-inserted tracify nodes.
        return normalize_tree(t, tuple(p.conds)), _mixed_or(t, tuple(p.conds))
    if isinstance(q, Pipeline):
        # wrapped-pipeline operand ((...|count()>1|{false}) && ...):
        # prefilter by its first spanset; the stages are exact-host-only
        t, _ = _plan_spanset_expr(p, d, q.filter, allow_struct)
        return t, True
    if allow_struct and q.op in (">", ">>", "~"):
        # snapshot the accumulator: a failed struct compile must not
        # leave half-planned conds behind (the fallback re-plans both
        # sides, and duplicates cost a device mask evaluation each)
        n0, fv0 = len(p.conds), p.force_verify
        st = _span_tree(p, d, q)
        if st is not None:
            # `~` over-matches orphan siblings (shared parent id whose
            # span is absent from the trace); exact host re-check needed
            return ("tracify", st), _tree_has_sibling(st)
        del p.conds[n0:]
        del p.rows[n0:]
        for k in [k for k in p.tables if k >= n0]:
            del p.tables[k]
        p.force_verify = fv0  # the fallback re-plans and re-flags
    lt, lv = _plan_spanset_expr(p, d, q.lhs, allow_struct)
    rt, rv = _plan_spanset_expr(p, d, q.rhs, allow_struct)
    structural = q.op in (">", ">>", "~")
    fold_op = "or" if q.op == "||" else "and"
    return _fold(fold_op, [lt, rt]), lv or rv or structural


def _plan_expr(p: Plan, d: Dictionary, expr) -> tuple:
    from .ast import BinaryOp, Field, Static, UnaryOp

    if isinstance(expr, LogicalExpr):
        op = "and" if expr.op == "&&" else "or"
        return _fold(op, [_plan_expr(p, d, expr.lhs), _plan_expr(p, d, expr.rhs)])
    if isinstance(expr, Comparison):
        f, lit = expr.field, expr.value
        if f.parent or (f.scope == Scope.INTRINSIC
                        and f.name in ("childCount", "parent")):
            p.force_verify = True  # host re-checks exactly (hosteval)
            return TRUE
        if lit.kind == "nil":
            if f.scope == Scope.INTRINSIC:
                # non-parent intrinsics (duration, name, status, ...)
                # always carry a value: nil compares resolve statically
                # (the parent intrinsic is caught by the branch above)
                return TRUE if expr.op == "!=" else FALSE
            if expr.op == "!=":
                # existence: != nil <=> the attribute is present
                return _plan_comparison(p, d, Comparison(f, "exists", lit))
            p.force_verify = True  # `= nil` (absence) has no device cond
            return TRUE
        return _plan_comparison(p, d, expr)
    if isinstance(expr, Field):
        # bare field in boolean position: value must be boolean true
        if expr.parent or expr.scope == Scope.INTRINSIC:
            p.force_verify = True
            return TRUE
        return _plan_comparison(p, d, Comparison(expr, "=", Static("bool", True)))
    if isinstance(expr, Static):
        # constant in boolean position ({ true }, { false })
        return TRUE if expr.value is True else FALSE
    if isinstance(expr, (BinaryOp, UnaryOp)):
        # general field algebra: no device compilation (yet); scan
        # conservatively and verify candidates exactly on host
        p.force_verify = True
        return TRUE
    raise ParseError(f"cannot plan {expr!r}")


@dataclass
class PlannedQuery:
    tree: tuple | None  # trace-level tree (see ops.filter); None => match-all
    conds: tuple
    rows: list
    tables: dict[int, np.ndarray]
    prune: bool = False  # statically false for this block
    needs_verify: bool = False
    # extra engine columns the TREE (not the conds) requires -- e.g.
    # span.parent_idx for compiled ('struct', ...) nodes
    extra_cols: tuple = ()

    @property
    def has_struct(self) -> bool:
        return "span.parent_idx" in self.extra_cols


def _mixed_or(tree, conds) -> bool:
    """True when the engines' shallow trace-level lift (ops/filter
    normalize_tree) is INEXACT for this tree, so candidates need exact
    host re-verification. Two shapes qualify:

    - an OR mixing span- and trace-level children: the lift evaluates
      the span side per-trace, over-matching same-span semantics;
    - an AND with a MIXED child (e.g. nested `(traceDur > 1s && kind =
      client) && name != "x"`): the lift groups only DIRECT span
      siblings into one tracify, so span conds separated by the nesting
      land in different same-span groups and over-match -- found by the
      three-way equivalence fuzzer.

    Flat mixes (every and/or child pure span or pure trace) lift
    exactly and stay verification-free."""

    def purity(t):
        if t[0] in ("tracify", "true", "false"):
            return "trace"
        if t[0] == "struct":
            return "span"
        if t[0] == "cond":
            return "trace" if conds[t[1]].target == "trace" else "span"
        ks = {purity(ch) for ch in t[1:]}
        return ks.pop() if len(ks) == 1 else "mixed"

    def walk(t):
        if t[0] in ("cond", "tracify", "true", "false", "struct"):
            return False
        if t[0] == "or" and purity(t) == "mixed":
            return True
        if t[0] == "and" and any(purity(ch) == "mixed" for ch in t[1:]):
            return True
        return any(walk(ch) for ch in t[1:])

    return walk(tree)


def _has_struct_node(t) -> bool:
    if not isinstance(t, tuple) or t in (TRUE, FALSE) or t[0] == "cond":
        return False
    if t[0] == "struct":
        return True
    return any(_has_struct_node(ch) for ch in t[1:])


def _finish(p: Plan, children: list) -> PlannedQuery:
    tree = _fold("and", children)
    if tree == FALSE:
        return PlannedQuery(None, (), [], {}, prune=True)
    if tree == TRUE:
        tree = None
    nv = p.force_verify or any(c.needs_verify for c in p.conds)
    if tree is not None and _mixed_or(tree, tuple(p.conds)):
        nv = True
    extra = ("span.parent_idx",) if tree is not None and _has_struct_node(tree) else ()
    return PlannedQuery(tree, tuple(p.conds), p.rows, p.tables,
                        needs_verify=nv, extra_cols=extra)


def plan_metrics_filter(q: MetricsQuery, d: Dictionary) -> PlannedQuery:
    """Span-LEVEL plan for a metrics query's spanset filter: unlike the
    search planner, the tree is NOT lifted to trace level (no tracify) --
    the timeseries fold consumes per-span masks directly, with
    trace-target conds gathered to spans through span.trace_sid.

    Only a single-spanset filter compiles; pipelines with intermediate
    stages and combinator/structural spansets force the exact engine
    (force-verify plan), mirroring the conservative-filter/exact-verify
    split of the search path."""
    p = Plan()
    filt = q.filter
    force = bool(q.stages)
    if isinstance(filt, Pipeline):
        force = True
        filt = filt.filter
    if isinstance(filt, SpansetOp):
        # conservative SPAN-level prefilter: the OR of every leaf
        # spanset's tree over-matches any combinator/structural result
        # (candidate traces = traces holding any leaf span); the exact
        # engine settles the relation over materialized traces
        def leaves(e):
            if isinstance(e, SpansetOp):
                return leaves(e.lhs) + leaves(e.rhs)
            if isinstance(e, Pipeline):
                return leaves(e.filter)
            return [e]

        trees = [TRUE if lf.expr is None else _plan_expr(p, d, lf.expr)
                 for lf in leaves(filt)]
        tree = _fold("or", trees)
        force = True
    elif filt.expr is None:
        tree = TRUE
    else:
        tree = _plan_expr(p, d, filt.expr)
    if tree == FALSE:
        return PlannedQuery(None, (), [], {}, prune=True)
    if tree == TRUE:
        tree = None
    nv = force or p.force_verify or any(c.needs_verify for c in p.conds)
    return PlannedQuery(tree, tuple(p.conds), p.rows, p.tables, needs_verify=nv)


def plan_search_request(
    d: Dictionary,
    tags: dict[str, str],
    query: str = "",
    min_duration_ms: int = 0,
    max_duration_ms: int = 0,
    start_rel_ms: tuple[int, int] | None = None,
    allow_struct: bool = True,
) -> PlannedQuery:
    """Tag-search / TraceQL request -> trace-level plan.

    Tag semantics follow the reference's search (each tag matches
    anywhere in the trace: per-tag tracify groups ANDed at trace level),
    while a TraceQL `query` keeps single-span semantics."""
    from .parser import parse

    p = Plan()
    children: list = []
    force_verify = False
    if query:
        q = parse(query)
        if isinstance(q, MetricsQuery):
            # metrics pipelines only make sense on the metrics endpoints
            # (/api/metrics/query_range -> db/metrics_exec); a search
            # request carrying one is a caller error, not a plan
            raise ParseError(
                "metrics queries (rate(), *_over_time()) are only valid "
                "on /api/metrics/query_range")
        if isinstance(q, Pipeline):
            # pipeline: the device filter prunes by the spanset; the
            # aggregate stages (count/avg/min/max/sum scalar filters)
            # evaluate EXACTLY on host over surviving candidates
            # (hosteval._eval_pipeline), so verification is mandatory
            force_verify = True
            q = q.filter
        if isinstance(q, SpansetOp):
            # structural/combinator spansets: > >> ~ over pure span
            # sides compile to exact struct nodes (no verification);
            # everything else prunes to traces whose spanset LEAVES are
            # all (or, for ||, any) present and re-checks on host
            tree, sv = _plan_spanset_expr(p, d, q, allow_struct)
            force_verify = force_verify or sv
            children.append(tree)
        elif q.expr is not None:
            children.append(_plan_expr(p, d, q.expr))
    for key, value in tags.items():
        lit = Static("str", value)
        if key == "name":
            f = Field(Scope.INTRINSIC, "name")
        else:
            f = Field(Scope.EITHER, key)
        t = _plan_comparison(p, d, Comparison(f, "=", lit))
        # bare-value convenience: numeric/bool tag values also match typed attrs
        if key != "name":
            extra = []
            try:
                iv = int(value)
                extra.append(_plan_comparison(p, d, Comparison(f, "=", Static("int", iv))))
            except ValueError:
                pass
            if value in ("true", "false"):
                extra.append(
                    _plan_comparison(p, d, Comparison(f, "=", Static("bool", value == "true")))
                )
            if extra:
                t = _fold("or", [t] + extra)
        if t == FALSE:
            return PlannedQuery(None, (), [], {}, prune=True)
        if t != TRUE:
            children.append(("tracify", t))
    # duration bounds compare EXACTLY via the (us, ns%1000) column pair,
    # so they don't force verification (which tag searches never run --
    # the old conservative +-1us range silently over-matched there, and
    # needlessly host-verified every TraceQL duration query)
    if min_duration_ms:
        children.append(_dur_pair_tree(
            p, "trace", "trace.dur_us", "trace.dur_lo", ">=",
            min_duration_ms * 1_000_000))
    if max_duration_ms:
        children.append(_dur_pair_tree(
            p, "trace", "trace.dur_us", "trace.dur_lo", "<=",
            max_duration_ms * 1_000_000))
    if start_rel_ms is not None:
        lo, hi = start_rel_ms
        children.append(
            p.cond(Cond(target="trace", col="trace.start_ms", op="range", needs_verify=True), v0=lo, v1=hi)
        )
    planned = _finish(p, children)
    if force_verify and not planned.prune:
        planned = replace(planned, needs_verify=True)
    return planned
