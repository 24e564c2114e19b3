"""Stacked per-block operands for the mesh programs (port of
tempo_tpu/parallel/search.py:336-372, `_stack_operands`).

The reference's sharded search (`make_sharded_search`, `sharded_search`)
is not ported yet; the metrics fold (parallel/timeseries.py) needs only
the operand stacking.
"""

from __future__ import annotations

import numpy as np

from ..ops.device import bucket
from ..ops.filter import Operands


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
