"""Sharded metrics fold: blocks over a 1-D axis of every rank, combined
by all_reduce (port of tempo_tpu/parallel/timeseries.py). The
reference's `mesh_1d` flattens its (dp, sp) mesh into that axis; here it
is the world group itself, rank r holding the r-th slice of blocks.

The multi-device twin of ops/timeseries: stacked per-block columns shard
over the flattened mesh (each rank folds its slice of whole blocks in
one cooperative M4 launch: the filter, the bucketing and the segmented
folds; the per-block operands, origins and span counts travel in the
program's header, and the descriptors in one upload), and
the (n_groups, n_buckets) partial accumulators combine with all_reduce
SUM for counts and sums, MIN / MAX for the min / max folds. Group ids
arrive already GLOBALIZED (db/metrics_mesh unions the per-block label
sets and remaps each block's dense ids onto the global table), which is
what makes the cross-rank sum correct.

Operands are per block (each block's dictionary yields different codes
for the same query), carried with a leading block axis. Condition
targets cover the span, res and trace axes; a res condition compares the
res column at the span's resource (one K4 call materializes every
span@<col> over a rank's stacked blocks, as staging does for one block). Generic attr conditions take the
per-block engines instead (db/metrics_exec).
"""

from __future__ import annotations

import numpy as np

from ..ops.filter import T_RES, T_SPAN, T_TRACE, Operands
from ..ops.stage import res_to_span_many
from ..ops.timeseries import timeseries_stacked, timeseries_stacked_finish
from .mesh import DISPATCH_LOCK, program
from .search import _stack_operands

MESH_TARGETS = (T_SPAN, T_RES, T_TRACE)


@program("timeseries")
def _ts_body(mesh, static: dict, ops: dict):
    tree, conds = static["tree"], static["conds"]
    cols = {n: ops[n] for n in static["names"]}
    bl = ops["gid"].shape[0]
    res = [n for n in dict.fromkeys(c.col for c in conds if c.target == T_RES)
           if f"span@{n}" not in cols]
    if res:  # span@<res col>: one K4 call over the local blocks, (C, Bl, S)
        for n, col in zip(res, res_to_span_many([cols[n] for n in res], cols["span.res_idx"])):
            cols[f"span@{n}"] = col
    # the small per-block operands came in the header: this rank's blocks
    blk = slice(mesh.rank * bl, (mesh.rank + 1) * bl)
    ints, floats = static["ints"][blk], static["floats"][blk]
    tabs = {i: t[blk] for i, t in static["tabs"].items()}
    operands = [Operands(ints[b], floats[b], {i: t[b] for i, t in tabs.items()} or None)
                for b in range(bl)]
    has_val = static["has_val"]
    outs = timeseries_stacked(
        (tree, conds), cols, operands, ops["gid"], ops["val"] if has_val else None,
        ops["pres"] if has_val else None, static["t0"][blk], static["n_spans"][blk],
        static["step"], static["n_buckets"], static["n_groups"])  # M4
    outs = [mesh.all_reduce(o, op) for o, op in zip(outs, ("sum", "sum", "sum", "min", "max"))]
    if has_val:
        outs[3], outs[4] = timeseries_stacked_finish(outs[3], outs[4])  # M4's decode
    return tuple(o.cpu().numpy() for o in outs) if mesh.rank == 0 else None


def sharded_timeseries(mesh, tree, conds, operands, cols: dict[str, np.ndarray],
                       n_spans: np.ndarray, t0_rel: np.ndarray,
                       gid: np.ndarray, val: np.ndarray | None,
                       pres: np.ndarray | None,
                       step_ms: int, n_buckets: int, n_groups: int):
    """Host entry. cols: stacked/padded per-block arrays -- span axis
    (B, S), res axis (B, R), trace axis (B, NT); B a multiple of the
    mesh size. gid: (B, S) GLOBAL dense group ids (-1 drops). val /
    pres: (B, S) f32/bool or None for count folds. t0_rel: (B,) per-
    block request-origin offset in block-relative ms. Returns numpy
    accumulators of shape (n_groups, n_buckets)."""
    names = tuple(sorted(cols))
    B = cols["span.start_ms"].shape[0]
    conds = tuple(conds)
    ints, floats, tabs = _stack_operands(operands, B, len(conds))
    has_val = val is not None
    shard0 = {n: cols[n] for n in names}
    shard0["gid"] = np.asarray(gid, np.int32)
    if has_val:
        shard0["val"] = np.asarray(val, np.float32)
        shard0["pres"] = np.asarray(pres, bool)
    # the per-block operands, span counts and origins (a few bytes a
    # block) ride in the header, so no rank reads them back from its card
    static = {"tree": tree, "conds": conds, "names": names, "has_val": has_val,
              "ints": ints, "floats": floats, "tabs": tabs,
              "n_spans": np.asarray(n_spans, np.int32), "t0": np.asarray(t0_rel, np.int32),
              "step": max(1, int(step_ms)), "n_buckets": int(n_buckets),
              "n_groups": int(n_groups)}
    with DISPATCH_LOCK:  # collective programs must not interleave
        return mesh.run("timeseries", static, shard0=shard0)
