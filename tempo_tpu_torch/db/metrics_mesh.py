"""Multi-device metrics orchestration: stack blocks onto the mesh fold
(port of tempo_tpu/db/metrics_mesh.py).

Glue between db/metrics_exec and parallel/timeseries: plans every
in-range block, GLOBALIZES the per-block group keys (the union of all
blocks' label tuples becomes the shared group axis -- per-block
dictionary codes never cross a block boundary), stacks padded per-block
columns, and runs the sharded fold whose all_reduce lands the combined
[num_groups, num_buckets] accumulators on the controller.

Falls back (returns False) whenever any block needs the exact engine,
a cond target needs the generic attr tables, the stacked footprint
exceeds the device budget, or fewer than two blocks survive pruning --
the per-block engines in metrics_exec then take over unchanged. Each
fallback and the stacked route are counted in batchexec's routing under
the site "metrics_mesh", as the reference records them.
"""

from __future__ import annotations

import numpy as np

from ..block import schema as S
from ..ops.device import PAD_I32, bucket
from ..ops.filter import Operands, required_columns
from ..traceql.plan import plan_metrics_filter
from .batchexec import record_routing

_MESH_MAX_BYTES = 512 << 20  # stacked-column budget (shared with search)


def _fallback(reason: str, n: int = 1) -> bool:
    """Record WHY the stacked mesh fold bowed out (the per-block engines
    take over) and return False for the caller to propagate."""
    record_routing("metrics_mesh", "fallback", reason, n)
    return False


def try_metrics_mesh(mesh, blocks, q, req, resp) -> bool:
    """Attempt the stacked mesh fold; True when resp now holds the
    complete answer for `blocks`, False to fall back per-block."""
    from ..parallel.timeseries import MESH_TARGETS, sharded_timeseries
    from .metrics_exec import (
        _block_axis,
        _outs_to_series,
        _value_column,
        resolve_groups,
    )

    if req.step_ms >= 2**31:
        return _fallback("i32_step")  # the mesh kernel buckets in int32 ms
    has_val = q.agg.field is not None
    items = []
    for blk in blocks:
        planned = plan_metrics_filter(q, blk.dictionary)
        if planned.prune:
            continue
        if planned.needs_verify:
            return _fallback("lossy_plan")
        if any(c.target not in MESH_TARGETS for c in planned.conds):
            return _fallback("attr_targets")
        groups = resolve_groups(blk, q.agg.by)
        if groups is None:
            return _fallback("unplannable_by")
        vals = _value_column(blk, q.agg.field) if has_val else None
        if has_val and vals is None:
            return _fallback("unplannable_value")
        _, nb, t0_rel = _block_axis(blk, req)
        if nb == 0:
            continue
        # the stacked fold uses one shared bucket axis: the full request
        # origin must stay within the block's int32-relative-ms range
        t0_full = req.start_ms - blk.meta.start_time_unix_nano // 1_000_000
        if not -(2**31) < t0_full < 2**31:
            return _fallback("i32_origin")
        items.append((blk, planned, groups, vals, t0_full))
    if len(items) < 2:
        return _fallback("too_few_blocks")

    # global group table: label tuples are the cross-block join key
    label_index: dict[tuple, int] = {}
    for _, _, (_gid, labels), _, _ in items:
        for lab in labels:
            label_index.setdefault(lab, len(label_index))
    glabels = list(label_index)
    if not glabels:
        for blk, _, _, _, _ in items:
            resp.inspected_spans += blk.pack.axes[S.AX_SPAN].n_rows
        return True
    from .metrics_exec import MAX_ACC_CELLS

    NB = req.n_buckets
    if bucket(len(glabels)) * bucket(NB) > MAX_ACC_CELLS:
        return _fallback("cardinality")

    ndev = mesh.size  # the fold's 1-D axis: every rank
    by_plan: dict[tuple, list] = {}
    for it in items:
        by_plan.setdefault((it[1].tree, it[1].conds), []).append(it)

    io0 = {id(blk): blk.pack.bytes_read for blk, _, _, _, _ in items}
    # two phases: EVERY plan group must stack and pass its budget/dtype
    # checks before ANY fold merges into resp -- a late fallback after a
    # partial merge would double-count those blocks when the per-block
    # engines re-run the full set
    runs = []
    for (tree, conds), its in by_plan.items():
        needed = [n for n in required_columns(conds)
                  if not n.startswith("span@") and n != "trace.span_off"]
        if "span.start_ms" not in needed:
            needed.append("span.start_ms")
        B = len(its)
        Bp = -(-B // ndev) * ndev
        s_max = max(blk.pack.axes[S.AX_SPAN].n_rows for blk, *_ in its)
        S_b = bucket(max(s_max, 1))
        NT_b = bucket(max(max(blk.meta.total_traces for blk, *_ in its), 1))
        # budget estimate BEFORE any column IO (footer row counts via
        # pack.n_rows_of, the same pre-read discipline as the search
        # group estimate): an over-budget attempt must fall back without
        # paying the cold reads it would then throw away
        res_cols = [n for n in needed if n.startswith("res.")]
        r_max = max((blk.pack.n_rows_of(n) for blk, *_ in its
                     for n in res_cols), default=1)
        R_b = bucket(max(r_max, 1))
        n_span_cols = sum(1 for n in needed if n.startswith("span."))
        n_trace_cols = sum(1 for n in needed if n.startswith("trace."))
        est = Bp * 4 * (S_b * (n_span_cols + 2 + (1 if has_val else 0))
                        + R_b * max(1, len(res_cols)) + NT_b * n_trace_cols)
        if est > _MESH_MAX_BYTES:
            return _fallback("pre_io_budget", n=len(its))
        per_block = [{n: blk.pack.read(n) for n in needed if blk.pack.has(n)}
                     for blk, *_ in its]

        host: dict[str, np.ndarray] = {}
        for n in needed:
            if n.startswith("span."):
                shape = (Bp, S_b)
            elif n.startswith("res."):
                shape = (Bp, R_b)
            elif n.startswith("trace."):
                shape = (Bp, NT_b)
            else:
                return _fallback("axis_shape")
            first = next((c[n] for c in per_block if n in c), None)
            if first is None or first.dtype not in (np.int32, np.float32):
                return _fallback("dtype")
            fill = PAD_I32 if first.dtype == np.int32 else np.float32(0)
            out = np.full(shape, fill, dtype=first.dtype)
            for bi, cols in enumerate(per_block):
                a = cols.get(n)
                if a is not None:
                    out[bi, : a.shape[0]] = a
            host[n] = out

        n_spans = np.zeros(Bp, np.int32)
        t0_arr = np.zeros(Bp, np.int32)
        gid = np.full((Bp, S_b), -1, np.int32)
        val = np.zeros((Bp, S_b), np.float32) if has_val else None
        pres = np.zeros((Bp, S_b), bool) if has_val else None
        operands = []
        for bi, (blk, planned, (bgid, blabels), vals, t0_full) in enumerate(its):
            ns = blk.pack.axes[S.AX_SPAN].n_rows
            n_spans[bi] = ns
            t0_arr[bi] = t0_full
            remap = np.asarray([label_index[lab] for lab in blabels], np.int32)
            if remap.size:
                gid[bi, :ns] = np.where(bgid >= 0,
                                        remap[np.clip(bgid, 0, remap.size - 1)],
                                        np.int32(-1))
            if has_val:
                v, p = vals
                val[bi, :ns] = v.astype(np.float32)
                pres[bi, :ns] = p
            operands.append(Operands.build(planned.rows, planned.tables or None))
        operands += [Operands.build([(0, 0, 0, 0.0, 0.0)] * len(conds))] * (Bp - B)
        runs.append((tree, tuple(conds), operands, host, n_spans, t0_arr,
                     gid, val, pres))

    # every group passed: fold and merge (no fallback past this point)
    record_routing("metrics_mesh", "device", "stacked", n=len(items))
    for (tree, conds, operands, host, n_spans, t0_arr, gid, val, pres) in runs:
        outs = sharded_timeseries(
            mesh, tree, conds, operands, host, n_spans, t0_arr,
            gid, val, pres, req.step_ms, NB, len(glabels))
        _outs_to_series(outs, q.agg.fn, glabels, 0, resp)
        resp.inspected_spans += int(n_spans.sum())
    resp.inspected_bytes += sum(
        blk.pack.bytes_read - io0[id(blk)] for blk, *_ in items)
    return True
