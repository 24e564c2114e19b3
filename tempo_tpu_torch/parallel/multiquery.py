"""Mesh-batched multi-query search: one admission window over every rank
(port of tempo_tpu/parallel/multiquery.py).

ops/multiquery.py fuses a window's Q queries into one single-device B5a
launch; here the same packed programs run over the staged block's span
rows split across every rank (both mesh axes flattened, dp-major: a
single block has no dp fan-out to ride). Each rank counts its row slice
per trace with M2, one all_reduce SUM adds the exact int32 partials, and
M3 runs the trace-level half on the sums, so (trace_mask, counts) equal
ops/multiquery.eval_multiquery bit for bit.
"""

from __future__ import annotations

import torch

from ..kernels import mq_views
from ..ops.multiquery import _program_rows, mq_combine, mq_partial
from .mesh import DISPATCH_LOCK, program


@program("multiquery")
def _mq_body(mesh, static: dict, ops: dict):
    rows, dims = ops["progs"], static["dims"]
    span_mat = ops["span_mat"]  # (n_sc, Sl): this rank's row slice
    row0 = mesh.rank * span_mat.shape[1]
    parts = mq_partial(rows, dims, span_mat, row0, ops["span_off"], static["n_spans"])  # M2
    parts = mesh.all_reduce(parts, "sum")  # ONE collective per window
    packed = mq_combine(rows, dims, parts, ops["trace_mat"], static["n_traces"])  # M3
    if mesh.rank != 0:
        return None
    tm, counts = mq_views(packed.cpu(), rows.shape[0], parts.shape[2])  # rank 0: one download
    return tm.numpy(), counts.numpy()


def mesh_batch_eligible(mesh, staged) -> bool:
    """Shape guard for the mesh-batched route: every rank needs a whole
    slice of the padded span axis. Power-of-two buckets (>= 1024) over
    power-of-two meshes always pass; other mesh sizes fall back to the
    single-device fused launch."""
    n = mesh.size
    return n > 1 and staged.n_spans_b % n == 0


def mesh_eval_multiquery(mesh, lowered: list, staged, progs: dict):
    """Run Q packed programs against one staged block as ONE program over
    every rank of the mesh. Same contract as ops/multiquery.eval_multiquery
    but returns host numpy (q_b, NT) arrays (trace_mask, counts)."""
    shape = lowered[0].shape
    dev = staged.cols["trace.span_off"].device

    def stack(names, n):
        if not names:
            return torch.zeros((1, n), dtype=torch.int32, device=dev)
        return torch.stack([staged.cols[c] for c in names])

    dims = (shape.n_conds_b, shape.n_clauses_b, shape.n_groups_b, shape.n_tconds_b,
            shape.n_atoms_b, shape.n_tclauses_b)
    static = {"dims": dims, "n_spans": int(staged.n_spans), "n_traces": int(staged.n_traces)}
    with DISPATCH_LOCK:  # collective programs must not interleave
        return mesh.run("multiquery", static,
                        bcast={"progs": _program_rows(progs),
                               "trace_mat": stack(shape.trace_cols, staged.n_traces_b),
                               "span_off": staged.cols["trace.span_off"]},
                        shard1={"span_mat": stack(shape.span_cols, staged.n_spans_b)})
