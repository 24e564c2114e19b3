"""Time-bucketed segmented reductions: the TraceQL-metrics fold (port of
tempo_tpu/ops/timeseries.py).

One device pass per (block, query): evaluate the span-level predicate
tree (the same data-driven condition machinery as ops/filter, so
`{span.foo = "bar"} | rate()` and `{span.foo = "baz"} | rate()` share a
compiled program), bucketize each surviving span's start time onto the
request's step-aligned axis, and fold into [num_groups, num_buckets]
accumulators: counts, and for value folds the value count, f32 sum,
min and max.

CUDA tensors run kernel B6 (csrc/timeseries.cu) on a `_SpanProgram`
(K1's span program plus trace-target leaves); CPU tensors run
`_timeseries_plain`, the reference's jitted `run` in torch. Both return
the (n_groups, n_buckets) slice the reference's caller keeps.

Group ids arrive as a per-span int32 column computed host-side from the
by() field's dictionary codes (db/metrics_exec); -1 drops the span.
Value folds take a per-span f32 value + presence mask derived host-side
from the exact host columns, so the only device-side loss is the f32
cast -- integer counts are exact on every engine.

On a mesh (parallel/timeseries.py) `timeseries_stacked` (kernel M4 in
the same source) folds one rank's stacked blocks into one grid with min
and max kept in B6's ordered-int32 encoding through the all_reduce MIN /
MAX; `timeseries_stacked_finish` decodes them after it.

`eval_timeseries_host` mirrors the semantics in numpy over raw columns
(int64 bucket math, f64 accumulation): the route for a step or origin
past int32 milliseconds.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .device import PAD_I32, bucket, pad_rows
from .filter import C_TCOND, T_TRACE, Cond, Operands, _cmp, _cond_mask, _FilterProgram
from .hostfilter import eval_span_mask_host


class _SpanProgram(_FilterProgram):
    """A span-level tree (no tracify) compiled as ONE postfix span
    program over K1's descriptor table; trace-target conditions become
    C_TCOND leaves. tree None matches every valid span."""

    def __init__(self, tree, conds: tuple[Cond, ...]):
        super().__init__(("tracify", ("true",) if tree is None else tree), conds)

    def _span_code(self, t, code: list[int]) -> None:
        if t[0] == "cond" and self.conds[t[1]].target == T_TRACE:
            self.trace_conds.add(t[1])
            code += [C_TCOND, t[1]]
        elif t[0] == "struct":
            raise ValueError("timeseries: structural nodes have no span-level plan")
        else:
            super()._span_code(t, code)


@lru_cache(maxsize=256)
def _span_program(tree, conds: tuple[Cond, ...]) -> _SpanProgram:
    return _SpanProgram(tree, conds)


def _ts_segments(tree, conds, cols, ops_i, ops_f, tables, gid, t0_ms: int, step_ms: int,
                 n_spans: int, n_buckets: int, n_groups: int, n_spans_b: int, n_res_b: int,
                 n_traces_b: int):
    """The span mask and time bucket of the reference's `run`
    (tempo_tpu/ops/timeseries.py:53-90) in torch: (ok, seg) with seg the
    (group, bucket) cell of each kept span and n_groups * n_buckets for
    the rest."""
    dev = gid.device
    valid = torch.arange(n_spans_b, device=dev) < n_spans

    def ev(t):
        if t == ("true",):
            return valid
        if t == ("false",):
            return torch.zeros_like(valid)
        if t[0] == "cond":
            i = t[1]
            c = conds[i]
            if c.target == T_TRACE:
                tm = _cmp(c.op, cols[c.col], ops_i[i, 1], ops_i[i, 2],
                          ops_f[i, 0], ops_f[i, 1], c.is_float, tables.get(i))
                sid = torch.clamp(cols["span.trace_sid"], 0, n_traces_b - 1).long()
                return tm[sid] & valid
            return _cond_mask(c, i, cols, ops_i, ops_f, tables, n_spans_b, n_res_b, valid)
        ms = [ev(ch) for ch in t[1:]]
        out = ms[0]
        for m in ms[1:]:
            out = (out & m) if t[0] == "and" else (out | m)
        return out

    sm = valid if tree is None else (ev(tree) & valid)
    # int32 bucket math with int32 wrap-around, as XLA's
    start = cols["span.start_ms"].to(torch.int64)
    diff = (start - int(t0_ms) + 2**31) % 2**32 - 2**31
    b = torch.div(diff, int(step_ms), rounding_mode="floor")
    ok = sm & (b >= 0) & (b < n_buckets) & (gid >= 0) & (gid < n_groups)
    nseg = n_groups * n_buckets
    seg = torch.where(ok, gid.to(torch.int64) * n_buckets + torch.clamp(b, 0, n_buckets - 1),
                      nseg)
    return ok, seg


def _timeseries_plain(tree, conds, cols, ops_i, ops_f, tables, gid, val, vpres,
                      t0_ms: int, step_ms: int, n_spans: int, n_buckets: int,
                      n_groups: int, n_spans_b: int, n_res_b: int, n_traces_b: int):
    """Plain version of B6: the reference's `run`
    (tempo_tpu/ops/timeseries.py:53-106) in torch, returning the
    (n_groups, n_buckets) slice of its accumulators."""
    dev = gid.device
    ok, seg = _ts_segments(tree, conds, cols, ops_i, ops_f, tables, gid, t0_ms, step_ms,
                           n_spans, n_buckets, n_groups, n_spans_b, n_res_b, n_traces_b)
    nseg = n_groups * n_buckets
    counts = torch.zeros(nseg + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, ok.to(torch.int32))[:-1].reshape(n_groups, n_buckets)
    if val is None:
        return (counts,)
    pres = ok & vpres
    segv = torch.where(pres, seg, nseg)
    vcnt = torch.zeros(nseg + 1, dtype=torch.int32, device=dev).index_add_(
        0, segv, pres.to(torch.int32))[:-1].reshape(n_groups, n_buckets)
    v = torch.where(pres, val, torch.zeros((), dtype=torch.float32, device=dev))
    vsum = torch.zeros(nseg + 1, dtype=torch.float32, device=dev).index_add_(
        0, segv, v)[:-1].reshape(n_groups, n_buckets)
    vmin = torch.full((nseg + 1,), float("inf"), dtype=torch.float32, device=dev).scatter_reduce_(
        0, segv, torch.where(pres, val, float("inf")), "amin")[:-1].reshape(n_groups, n_buckets)
    vmax = torch.full((nseg + 1,), float("-inf"), dtype=torch.float32, device=dev).scatter_reduce_(
        0, segv, torch.where(pres, val, float("-inf")), "amax")[:-1].reshape(n_groups, n_buckets)
    return counts, vcnt, vsum, vmin, vmax


def _table_list(operands: Operands) -> dict[int, np.ndarray]:
    return {i: pad_rows(np.asarray(t, dtype=np.uint8), bucket(max(1, len(t))), 0)
            for i, t in (operands.tables or {}).items()}


def timeseries_fold(query, cols: dict, operands: Operands, gid, val, vpres,
                    t0_ms: int, step_ms: int, n_spans: int, n_buckets: int, n_groups: int,
                    n_spans_b: int, n_res_b: int, n_traces_b: int) -> tuple:
    """B6 on CUDA tensors, its plain version on CPU tensors. gid / val /
    vpres are padded span-length tensors on the columns' device; t0_ms
    and step_ms must fit int32. Returns tensors of shape (n_groups,
    n_buckets): (counts,) or (counts, vcnt, vsum, vmin, vmax), views of
    timeseries_packed's one tensor."""
    from .. import kernels

    return kernels.timeseries_views(
        timeseries_packed(query, cols, operands, gid, val, vpres, t0_ms, step_ms, n_spans,
                          n_buckets, n_groups, n_spans_b, n_res_b, n_traces_b),
        val is not None, n_groups, n_buckets)


def timeseries_packed(query, cols: dict, operands: Operands, gid, val, vpres,
                      t0_ms: int, step_ms: int, n_spans: int, n_buckets: int, n_groups: int,
                      n_spans_b: int, n_res_b: int, n_traces_b: int) -> torch.Tensor:
    """timeseries_fold's accumulators in one int32 tensor on gid's device
    (kernels.timeseries_views' layout): the kernel's one allocation on
    the card, the plain version's planes packed the same way on the CPU."""
    tree, conds = query
    tables = _table_list(operands)
    if gid.device.type == "cpu":
        ops_i = torch.from_numpy(np.ascontiguousarray(operands.ints, np.int32))
        ops_f = torch.from_numpy(np.ascontiguousarray(operands.floats, np.float32))
        outs = _timeseries_plain(tree, conds, cols, ops_i, ops_f,
                                 {i: torch.from_numpy(t) for i, t in tables.items()},
                                 gid, val, vpres, t0_ms, step_ms, n_spans, n_buckets,
                                 n_groups, n_spans_b, n_res_b, n_traces_b)
        return torch.cat([o.reshape(-1).view(torch.int32) for o in outs])
    from .. import kernels

    prog = _span_program(tree, tuple(conds))
    buf = prog.buffer(cols, operands, tables)
    return kernels.timeseries_fold(prog, buf, cols, cols["span.start_ms"], gid, val, vpres, t0_ms,
                                   step_ms, n_spans, n_res_b, n_traces_b, n_buckets, n_groups)


def eval_timeseries_device(query, staged, operands: Operands,
                           gid: np.ndarray, val: np.ndarray | None,
                           vpres: np.ndarray | None,
                           t0_rel_ms: int, step_ms: int,
                           n_buckets: int, n_groups: int):
    """One fold over a StagedBlock (ops/stage). gid/val/vpres are raw
    span-length host arrays for the staged span slice; their padded
    copies go up in one upload, and on a card the accumulators come back
    in one download. Returns numpy accumulators of shape (n_groups,
    n_buckets): (counts,) or (counts, vcnt, vsum, vmin, vmax)."""
    dev = staged.cols["span.start_ms"].device
    nb = staged.n_spans_b
    has_val = val is not None
    gid_p = pad_rows(np.asarray(gid, np.int32), nb, np.int32(-1))
    if has_val:
        val_p = pad_rows(np.asarray(val, np.float32), nb, np.float32(0))
        pres_p = pad_rows(np.asarray(vpres, bool).view(np.uint8), nb, np.uint8(0))
        host = torch.from_numpy(np.concatenate([gid_p.view(np.uint8), val_p.view(np.uint8),
                                                pres_p]))
        buf = host.to(dev)
        gid_t = buf[: 4 * nb].view(torch.int32)
        val_t = buf[4 * nb : 8 * nb].view(torch.float32)
        pres_t = buf[8 * nb :].view(torch.bool)
    else:
        gid_t, val_t, pres_t = torch.from_numpy(gid_p).to(dev), None, None
    t0 = int(np.clip(t0_rel_ms, -(2**31) + 1, 2**31 - 1))
    packed = timeseries_packed(query, staged.cols, operands, gid_t, val_t, pres_t, t0,
                               max(1, int(step_ms)), staged.n_spans, n_buckets, n_groups, nb,
                               staged.n_res_b, staged.n_traces_b)
    from .. import kernels

    n_out = (5 if has_val else 1) * n_groups * n_buckets
    outs = kernels.timeseries_views(packed[:n_out].cpu(), has_val, n_groups, n_buckets)
    return tuple(o.numpy() for o in outs)


def eval_timeseries_host(query, cols: dict[str, np.ndarray],
                         operands: Operands, n_spans: int, n_traces: int,
                         gid: np.ndarray, val: np.ndarray | None,
                         vpres: np.ndarray | None,
                         t0_rel_ms: int, step_ms: int,
                         n_buckets: int, n_groups: int):
    """Numpy twin of the device fold over RAW host columns: same masks,
    same bucketing in int64, f64 value accumulation. Returns the same
    accumulator tuple shapes as the device path."""
    sm = eval_span_mask_host(query, cols, operands, n_spans, n_traces)
    b = (cols["span.start_ms"].astype(np.int64) - int(t0_rel_ms)) // int(step_ms)
    ok = sm & (b >= 0) & (b < n_buckets) & (gid >= 0)
    nb = int(n_buckets)
    key = gid.astype(np.int64) * nb + np.clip(b, 0, nb - 1)
    nk = max(n_groups, 1) * nb
    counts = np.bincount(key[ok], minlength=nk)[:nk].reshape(-1, nb)
    counts = counts[:n_groups]
    if val is None:
        return (counts,)
    pres = ok & vpres
    kp = key[pres]
    vcnt = np.bincount(kp, minlength=nk)[:nk].reshape(-1, nb)[:n_groups]
    vv = val.astype(np.float64)[pres]
    vsum = np.bincount(kp, weights=vv, minlength=nk)[:nk].reshape(-1, nb)[:n_groups]
    vmin = np.full(nk, np.inf)
    vmax = np.full(nk, -np.inf)
    np.minimum.at(vmin, kp, vv)
    np.maximum.at(vmax, kp, vv)
    return (counts, vcnt, vsum,
            vmin.reshape(-1, nb)[:n_groups], vmax.reshape(-1, nb)[:n_groups])


# ------------------------------------------------ the mesh fold (M4)

_INF_BITS, _NINF_BITS = 0x7F800000, -0x800000  # +inf and -inf as int32 bit patterns


def _ts_enc(v: torch.Tensor) -> torch.Tensor:
    """B6's order-preserving int32 encoding of f32 values (-0.0 below
    +0.0; csrc/timeseries.cu ts_enc)."""
    i = v.view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def ts_decode(e: torch.Tensor) -> torch.Tensor:
    """The encoding back to f32 (ts_finish_kernel's arithmetic)."""
    return torch.where(e >= 0, e, e ^ 0x7FFFFFFF).view(torch.float32)


def _timeseries_stacked_plain(tree, conds, cols: dict, operands: list, gid, val, vpres,
                              t0s, nspans, step_ms: int, n_buckets: int, n_groups: int):
    """Plain version of M4: B6's fold over Bl stacked blocks (block b with
    its own operands, origin t0s[b] and span count nspans[b]) into one
    (n_groups, n_buckets) grid; min and max stay in the ordered-int32
    encoding, a NaN winning both (ts_enc_min / ts_enc_max)."""
    bl, S = gid.shape
    dev = gid.device
    nseg = n_groups * n_buckets
    n_res_b = next((t.shape[1] for n, t in cols.items() if n.startswith("res.")), 1)
    n_traces_b = next((t.shape[1] for n, t in cols.items() if n.startswith("trace.")), 1)
    has_val = val is not None
    counts = torch.zeros(nseg + 1, dtype=torch.int32, device=dev)
    if has_val:
        vcnt = torch.zeros(nseg + 1, dtype=torch.int32, device=dev)
        vsum = torch.zeros(nseg + 1, dtype=torch.float32, device=dev)
        vmin = torch.full((nseg + 1,), _INF_BITS, dtype=torch.int32, device=dev)
        vmax = torch.full((nseg + 1,), _NINF_BITS ^ 0x7FFFFFFF, dtype=torch.int32, device=dev)
    for b in range(bl):
        ops = operands[b]
        ops_i = torch.from_numpy(np.ascontiguousarray(ops.ints, np.int32)).to(dev)
        ops_f = torch.from_numpy(np.ascontiguousarray(ops.floats, np.float32)).to(dev)
        tables = {i: torch.from_numpy(t).to(dev) for i, t in _table_list(ops).items()}
        cols_b = {n: t[b] for n, t in cols.items()}
        ok, seg = _ts_segments(tree, conds, cols_b, ops_i, ops_f, tables, gid[b], int(t0s[b]),
                               step_ms, int(nspans[b]), n_buckets, n_groups, S, n_res_b,
                               n_traces_b)
        counts.index_add_(0, seg, ok.to(torch.int32))
        if not has_val:
            continue
        pres = ok & vpres[b]
        segv = torch.where(pres, seg, nseg)
        v = val[b]
        vcnt.index_add_(0, segv, pres.to(torch.int32))
        vsum.index_add_(0, segv, torch.where(pres, v, torch.zeros((), device=dev)))
        nan = torch.isnan(v)
        enc = _ts_enc(v)
        vmin.scatter_reduce_(0, segv, torch.where(pres, torch.where(nan, int(PAD_I32), enc),
                                                  _INF_BITS), "amin")
        vmax.scatter_reduce_(0, segv, torch.where(pres, torch.where(nan, 2**31 - 1, enc),
                                                  _NINF_BITS ^ 0x7FFFFFFF), "amax")
    shape = (n_groups, n_buckets)
    if not has_val:
        return (counts[:-1].reshape(shape),)
    return tuple(t[:-1].reshape(shape) for t in (counts, vcnt, vsum, vmin, vmax))


def timeseries_stacked(query, cols: dict, operands: list, gid, val, vpres, t0s, nspans,
                       step_ms: int, n_buckets: int, n_groups: int) -> tuple:
    """M4 on CUDA tensors, its plain version on CPU tensors: the fold of Bl
    stacked blocks (cols (Bl, ·) per axis, span@ columns materialized,
    one Operands a block; gid / val / vpres (Bl, S); t0s, nspans (Bl,)
    int32) into (counts,) or (counts, vcnt, vsum, vmin, vmax), min and
    max still encoded for the collective (`timeseries_stacked_finish`)."""
    tree, conds = query
    if gid.device.type == "cpu":
        return _timeseries_stacked_plain(tree, conds, cols, operands, gid, val, vpres,
                                         t0s.tolist(), nspans.tolist(), step_ms, n_buckets,
                                         n_groups)
    from .. import kernels

    prog, bufs, descs = stacked_program(query, cols, operands)
    return kernels.timeseries_stacked(prog, bufs, descs, cols, gid, val, vpres, t0s, nspans,
                                      step_ms, n_buckets, n_groups)


def stacked_program(query, cols: dict, operands: list):
    """M4's operands on the card: the span program, one descriptor buffer
    a block (its operands, its row of every column) and the (Bl,) table
    of their descriptor addresses."""
    tree, conds = query
    prog = _span_program(tree, tuple(conds))
    bufs = [prog.buffer({n: t[b] for n, t in cols.items()}, ops, _table_list(ops))
            for b, ops in enumerate(operands)]
    descs = torch.tensor([b.data_ptr() + prog.desc_off for b in bufs], dtype=torch.int64)
    return prog, bufs, descs.to(bufs[0].device)


def timeseries_stacked_finish(vmin, vmax):
    """M4's decode after the collective: the encoded min and max as f32."""
    if vmin.device.type == "cpu":
        return ts_decode(vmin), ts_decode(vmax)
    from .. import kernels

    return kernels.timeseries_stacked_finish(vmin, vmax)
