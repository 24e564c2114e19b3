"""Sharded predicate search: blocks over dp, span rows over sp (port of
tempo_tpu/parallel/search.py).

The multi-device twin of the per-block search: the stacked blocks'
span axis shards over sp (each rank filters its row slice) and
independent blocks ride dp. Generic-attr rows shard over sp like span
rows; their per-owner counts stitch across the cut with a
reduce-scatter over sp (span attrs: each rank receives exactly its own
span slice) or an all_reduce over sp (resource attrs, to the small
replicated resource axis). Struct nodes (`>`, `>>`, `~`) gather their
lhs mask over sp, bit-packed 8 rows to a byte (M6) and read packed by
K1's struct pass, and `>>` and `~` gather the parent table once per
launch; an sp axis of one rank gathers nothing (the all_gather is the
identity there), so its struct nodes read the shard's own slot and
parent rows. Per-trace partial counts (M7) add up over sp with one
all_reduce SUM, and the trace program (M8) runs on the sums; with one
sp rank there is nothing to sum, and both run in one launch. The
per-shard steps are ops/meshsearch.py.

Operands are per block: every block resolves strings through its own
dictionary, so ops_i / ops_f / tables carry a leading block axis split
over dp, and every leaf compares a block's rows with that block's
operands.

  sharded_search(mesh, tree, conds, operands, cols, n_spans, nt=None)
      -> (trace_mask, span_count), (B, NT) numpy
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.device import bucket
from ..ops.filter import T_RATTR, T_SATTR, Operands, normalize_tree
from ..ops.meshsearch import ShardSearch, mask_pack
from .mesh import DISPATCH_LOCK, program


def _stack_operands(operands, B: int, n_conds: int):
    """Accept one Operands (replicated to every block) or a per-block
    list (padded with zero rows to B). Returns (ints (B,C,3),
    floats (B,C,2), tables {i: (B, L) u8})."""
    if isinstance(operands, Operands):
        ints = np.broadcast_to(operands.ints[None], (B,) + operands.ints.shape).copy()
        floats = np.broadcast_to(operands.floats[None], (B,) + operands.floats.shape).copy()
        tabs = {}
        for i, t in (operands.tables or {}).items():
            t8 = np.asarray(t, dtype=np.uint8)
            tabs[i] = np.broadcast_to(t8[None], (B,) + t8.shape).copy()
        return ints, floats, tabs
    ints = np.zeros((B, n_conds, 3), dtype=np.int32)
    floats = np.zeros((B, n_conds, 2), dtype=np.float32)
    idxs = set()
    for o in operands:
        idxs.update(o.tables or {})
    tabs = {}
    for i in sorted(idxs):
        L = bucket(max(max(len(o.tables[i]) for o in operands if o.tables and i in o.tables), 1))
        tabs[i] = np.zeros((B, L), dtype=np.uint8)
    for bi, o in enumerate(operands):
        ints[bi, : o.ints.shape[0]] = o.ints
        floats[bi, : o.floats.shape[0]] = o.floats
        for i, t in (o.tables or {}).items():
            tabs[i][bi, : len(t)] = np.asarray(t, dtype=np.uint8)
    return ints, floats, tabs


def struct_pack_enabled() -> bool:
    """TEMPO_STRUCT_PACK=0 turns struct nodes back to the reference's
    legacy gathers: every node gathers its lhs mask unpacked, and every
    `>>` or `~` node the parent table. Default: bit-packed masks and one
    parent-table gather per launch. The knob stays because the reference
    registers it (tempo_tpu/config_registry.py:188); the answers are the
    same either way."""
    return os.environ.get("TEMPO_STRUCT_PACK", "1") not in ("0", "false")


def search_local(mesh, static: dict, ops: dict):
    """The search body on this rank: (trace_mask, span_count), each
    (Bl, NT), replicated along sp. static holds the tree, conds, column
    names, NT, pack, table indexes and every block's span count."""
    conds, names = static["conds"], static["names"]
    cols = {n: ops[n] for n in names}
    dpi, spi = mesh.coords
    bl = ops["ops_i"].shape[0]
    sh = ShardSearch(static["tree"], conds, cols, ops["ops_i"].cpu().numpy(),
                     ops["ops_f"].cpu().numpy(),
                     {i: ops[f"table.{i}"].cpu().numpy() for i in static["table_idxs"]},
                     static["n_spans"][dpi * bl:(dpi + 1) * bl], spi, static["nt"])
    # leaves: M5, then its collective, into the leaf's mask slot
    for i in sorted(sh.prog.leaf_slots):
        cnt = sh.attr_partial(i)
        if conds[i].target == T_SATTR:
            cnt = mesh.reduce_scatter(cnt, "sum", "sp", dim=1)  # (Bl, Sl): this rank's spans
        elif conds[i].target == T_RATTR:
            cnt = mesh.all_reduce(cnt, "sum", "sp")  # (Bl, R), replicated
        sh.attr_mask(i, cnt)
    one = mesh.sp == 1  # an all_gather over one rank is the identity
    pack = not one and static["pack"] and sh.sl % 8 == 0

    def gather_mask(m):
        """The lhs mask over the block's rows: the slot itself on one sp
        rank; else gathered, packed (read packed by the struct pass) or,
        with TEMPO_STRUCT_PACK=0, as bytes."""
        if one:
            return m
        if pack:
            return mesh.all_gather(mask_pack(m), "sp", dim=1)
        return mesh.all_gather(m.contiguous(), "sp", dim=1)

    pid_g = None
    for step in sh.prog.steps:
        if step[0] == "span":
            sh.span_step(step)
            continue
        op, lslot = step[1], step[2]
        lm_g = gather_mask(sh.slot(lslot))
        pidx = cols["span.parent_idx"]
        if op != ">" and not one:
            # '>>' and '~' walk the gathered parent table; its validity is
            # the block's first n_spans rows, which K1's struct kernels test
            # (the reference gathers the valid mask beside it)
            if pid_g is None or not static["pack"]:
                pid_g = mesh.all_gather(pidx, "sp", dim=1)
            pidx = pid_g
        sh.struct_step(step, lm_g, pidx, packed=pack)
    if one:  # nothing to sum: M7 and M8 in one launch
        return sh.partial_finish()
    counts = mesh.all_reduce(sh.partial(), "sum", "sp")  # M7, then ONE sum over sp
    return sh.finish(counts)  # M8


def _controller_rows(mesh, tm, sc):
    """Every dp row's (trace_mask, span_count) on the controller, from its
    sp index 0 (the outputs are replicated along sp): (B, NT) numpy, None
    on the followers."""
    rows = mesh.gather0(torch.stack([tm.to(torch.int32), sc]))
    if rows is None:
        return None
    rows = rows[:: mesh.sp].cpu()  # (dp, 2, Bl, NT)
    return (rows[:, 0].reshape(-1, rows.shape[-1]).numpy().astype(bool),
            rows[:, 1].reshape(-1, rows.shape[-1]).numpy())


@program("search")
def _search_body(mesh, static: dict, ops: dict):
    return _controller_rows(mesh, *search_local(mesh, static, ops))


def search_operands(names, cols: dict, ints, floats, tabs: dict) -> tuple[dict, dict]:
    """The search's operands by kind: (dp, dpsp). Row axes (span.*,
    sattr.*, rattr.*) split over dp and sp; owner offsets, resource and
    trace columns, operands and tables over dp."""
    dp = {"ops_i": ints, "ops_f": floats}
    dp.update({f"table.{i}": t for i, t in tabs.items()})
    dpsp = {}
    for n in names:
        if not n.endswith(".off") and n.startswith(("span.", "sattr.", "rattr.")):
            dpsp[n] = cols[n]
        else:
            dp[n] = cols[n]
    return dp, dpsp


def search_static(tree, conds: tuple, names: tuple, n_spans, nt: int, table_idxs: tuple,
                  pack: bool) -> dict:
    return {"tree": tree, "conds": conds, "names": names, "nt": int(nt),
            "n_spans": [int(n) for n in np.asarray(n_spans).reshape(-1)],
            "table_idxs": table_idxs, "pack": pack}


def _min_rows(ints, floats):
    """A tree with no conditions still sends one operand row a block."""
    if ints.shape[1]:
        return ints, floats
    return np.zeros(ints.shape[:1] + (1, 3), np.int32), np.zeros(floats.shape[:1] + (1, 2),
                                                                 np.float32)


def sharded_search(mesh, tree, conds, operands, cols: dict[str, np.ndarray],
                   n_spans: np.ndarray, nt: int | None = None):
    """Host entry. `operands`: one Operands (the same codes for every
    block) or a list of per-block Operands (per-block dictionary codes).
    cols must already be stacked and padded: span-axis (B, S) with
    S % sp == 0 and B % dp == 0; res / trace axes (B, R) / (B, NT).
    Returns (trace_mask, span_count) as numpy, (B, NT)."""
    names = tuple(sorted(cols))
    NT = nt
    if NT is None and any(n.startswith("trace.") for n in names):
        NT = cols[[n for n in names if n.startswith("trace.")][0]].shape[1]
    if NT is None:
        NT = bucket(int(cols["span.trace_sid"].max(initial=0)) + 1)
    B = cols["span.trace_sid"].shape[0]
    conds = tuple(conds)
    if tree is not None:
        tree = normalize_tree(tree, conds)
    ints, floats, tabs = _stack_operands(operands, B, len(conds))
    ints, floats = _min_rows(ints, floats)
    table_idxs = tuple(sorted(tabs))
    dp, dpsp = search_operands(names, cols, ints, floats, tabs)
    static = search_static(tree, conds, names, n_spans, NT, table_idxs, struct_pack_enabled())
    with DISPATCH_LOCK:  # collective programs must not interleave
        return mesh.run("search", static, dp=dp, dpsp=dpsp)

