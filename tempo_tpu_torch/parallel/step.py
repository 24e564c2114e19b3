"""The composed multi-device step: find + search + bloom union in ONE mesh
program (port of tempo_tpu/parallel/step.py).

The read and compaction hot path as one program: the sharded trace-ID
lookup (K3 and M1 in one launch, one MAX round), the sharded predicate search
(parallel/search.py: M5-M8 around K1, one operand set for every block)
and the bloom union (B10a and its all_gathers), one header and no host
round trip between the three parts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ops.filter import Operands, normalize_tree
from .bloom import _union_body
from .find import _find_body
from .mesh import DISPATCH_LOCK, MeshError, program
from .search import _controller_rows, _min_rows, _stack_operands, search_local, search_operands
from .search import search_static


@program("step")
def _step_body(mesh, static: dict, ops: dict):
    hits = _find_body(mesh, static["find"], ops)
    rows = _controller_rows(mesh, *search_local(mesh, static["search"], ops))
    union = _union_body(mesh, {}, ops)
    return None if rows is None else (hits, *rows, union)


@lru_cache(maxsize=32)
def distributed_query_step(mesh, tree, conds, col_names: tuple[str, ...],
                           B: int, T: int, Q: int, S: int, R: int, NT: int,
                           K: int, NS: int, W: int):
    """Returns fn(ids, n_valid, queries, ops_i, ops_f, n_spans, col_arrays,
    blooms) -> (hits (Q,2) [block,row], trace_mask (B,NT), span_count
    (B,NT), bloom_union (NS,W)), numpy. ids (B, T, 4) and blooms (K, NS,
    W) uint32 split over every rank, queries (Q, 4) on every rank, the
    search's columns (col_arrays in col_names order) as the sharded
    search splits them, and one operand set (ops_i (C, 3), ops_f (C, 2))
    for every block."""
    conds = tuple(conds)
    if tree is not None:
        tree = normalize_tree(tree, conds)

    def step(ids, n_valid, queries, ops_i, ops_f, n_spans, col_arrays, blooms):
        ids, queries = np.asarray(ids, np.int32), np.asarray(queries, np.int32)
        blooms = np.asarray(blooms, np.uint32)
        if ids.shape != (B, T, 4) or queries.shape != (Q, 4) or blooms.shape != (K, NS, W):
            raise MeshError(f"step: ids {ids.shape}, queries {queries.shape}, blooms "
                            f"{blooms.shape} against ({B}, {T}, 4), ({Q}, 4), ({K}, {NS}, {W})")
        cols = dict(zip(col_names, col_arrays))
        if cols["span.trace_sid"].shape != (B, S):
            raise MeshError(f"step: span columns {cols['span.trace_sid'].shape}, not ({B}, {S})")
        op = Operands(np.asarray(ops_i, np.int32), np.asarray(ops_f, np.float32))
        ints, floats = _min_rows(*_stack_operands(op, B, len(conds))[:2])
        dp, dpsp = search_operands(col_names, cols, ints, floats, {})
        static = {"find": {"n_steps": int(T).bit_length()},
                  "search": search_static(tree, conds, col_names, n_spans, NT, (), True)}
        with DISPATCH_LOCK:  # collective programs must not interleave
            hits, tm, sc, union = mesh.run(
                "step", static, bcast={"queries": queries},
                shard0={"ids": ids, "n_valid": np.asarray(n_valid, np.int32),
                        "stacked": blooms.view(np.int32)},
                dp=dp, dpsp=dpsp)
        return hits.astype(np.int32), tm, sc, union.view(np.uint32)

    return step
