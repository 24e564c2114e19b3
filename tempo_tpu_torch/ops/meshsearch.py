"""One rank's share of the sharded search (port of the per-shard
arithmetic of tempo_tpu/parallel/search.py:95-333, the `local` body of
`make_sharded_search`).

A rank holds Bl blocks (the dp axis) and a slice of each block's rows
(the sp axis): span rows [row0, row0 + Sl) and generic-attr rows
[arow0, arow0 + Al); resource, trace and offset columns whole. The
condition tree compiles once for a shard (ops/filter._FilterProgram,
sharded=True). `ShardSearch` holds that program, the shard's mask slots
(Bl, n_slots, Sl) and, on a card, one descriptor buffer a block (each
block compares with its own dictionary codes, tables and thresholds).
parallel/search.py runs its steps between the collectives:

  M5 attr_partial   per-owner partial counts of an attr leaf (a res leaf:
                    its compare per resource); after the reduce-scatter
                    (span attrs) or all_reduce (resource attrs), attr_mask
                    writes the leaf's span mask slot
  K1                the span pass and the struct passes (filter.cu) a
                    block at a time, `>` against the gathered lhs mask,
                    `>>` and `~` against the gathered parent table too;
                    a packed lhs mask read bit by bit (M6's unpack)
  M6 mask_pack      the lhs mask 8 rows to a byte before the sp all_gather
  M7 search_partial per-trace partial counts of every tracify slot and
                    their union; an all_reduce SUM over sp follows
  M8 search_finish  the trace program over the summed counts
  M7 + M8           partial_finish: both in one launch where sp is one
                    rank (nothing to sum)

Every public function runs its CUDA kernel (csrc/meshsearch.cu) on CUDA
tensors and its plain PyTorch version, the reference's arithmetic line
by line, on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .filter import (
    _ATTR_VALUE_COL,
    _VT_CODE,
    C_AND,
    C_COND,
    C_OR,
    C_TRACIFY,
    C_TRUE,
    T_RES,
    T_SATTR,
    Operands,
    _cmp_b,
    _program,
    _shard_valid,
    _span_step_plain,
    _struct_step_plain,
)

_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


# ------------------------------------------------------------ plain versions


def _wrap_diff(off, row0: int):
    """off - row0 as the reference's int32 difference, which wraps (int64)."""
    return (off.long() - int(row0) + 2**31) % 2**32 - 2**31


def _attr_partial_plain(c, cols: dict, ops_i, ops_f, i: int, table, arow0: int):
    """M5, plain (the reference's `owner_counts` over `attr_mask`'s row
    hits): (Bl, n_seg) int32 partial counts of leaf i."""
    if c.target == T_RES:
        return _cmp_b(c.op, cols[c.col], ops_i, ops_f, i, c.is_float, table).to(torch.int32)
    pre = c.target
    row_hit = cols[f"{pre}.key_id"] == ops_i[:, i, 0:1]
    if c.col != "any":
        vcol = cols[f"{pre}.{_ATTR_VALUE_COL[c.col]}"]
        row_hit = (row_hit & (cols[f"{pre}.vtype"] == _VT_CODE[c.col])
                   & _cmp_b(c.op, vcol, ops_i, ops_f, i, c.is_float, table))
    al = row_hit.shape[1]
    ecs = torch.cat([torch.zeros((row_hit.shape[0], 1), dtype=torch.int64, device=row_hit.device),
                     torch.cumsum(row_hit.to(torch.int64), dim=1)], dim=1)
    off = _wrap_diff(cols[f"{pre}.off"], arow0)
    lo = torch.clamp(off[:, :-1], 0, al)
    hi = torch.clamp(off[:, 1:], 0, al)
    return (torch.gather(ecs, 1, hi) - torch.gather(ecs, 1, lo)).to(torch.int32)


def _attr_mask_plain(cnt, res_idx, n_spans, row0: int, sl: int):
    """M5's second half, plain: (Bl, Sl) bool span mask of the summed
    counts (at the span, or at its clamped res_idx)."""
    valid = _shard_valid(n_spans, row0, sl)
    if res_idx is None:
        return (cnt > 0) & valid
    idx = torch.clamp(res_idx, 0, cnt.shape[1] - 1).long()
    return torch.gather(cnt > 0, 1, idx) & (res_idx >= 0) & valid


def _mask_pack_plain(m):
    """M6, plain: np.packbits of m != 0 along axis 1."""
    bl, sl = m.shape
    w = torch.tensor(_BITS, dtype=torch.int32, device=m.device)
    return ((m != 0).to(torch.int32).reshape(bl, sl // 8, 8) * w).sum(dim=2).to(torch.uint8)


def _mask_unpack_plain(pk):
    """M6's unpack, plain: np.unpackbits along axis 1, as bool. On the
    card K1's shard struct pass reads the packed bits in its place."""
    w = torch.tensor(_BITS, dtype=torch.int32, device=pk.device)
    return ((pk.to(torch.int32)[:, :, None] & w) != 0).reshape(pk.shape[0], -1)


def _search_partial_plain(slots, tslots: list, span_off, tsid, n_spans, row0: int, nt: int):
    """M7, plain (the reference's `seg_reduce` before its psum): (Bl,
    n_tr + 1, nt) int32 partial counts of each tracify slot and of their
    union (every valid row without one)."""
    bl, _, sl = slots.shape
    masks = [slots[:, s] != 0 for s in tslots]
    union = _shard_valid(n_spans, row0, sl)
    if masks:
        union = masks[0]
        for m in masks[1:]:
            union = union | m
    out = []
    for m in masks + [union]:
        if span_off is not None:
            ecs = torch.cat([torch.zeros((bl, 1), dtype=torch.int64, device=m.device),
                             torch.cumsum(m.to(torch.int64), dim=1)], dim=1)
            off = _wrap_diff(span_off, row0)
            lo = torch.clamp(off[:, :-1], 0, sl)
            hi = torch.clamp(off[:, 1:], 0, sl)
            out.append(torch.gather(ecs, 1, hi) - torch.gather(ecs, 1, lo))
        else:
            sid = torch.clamp(torch.where(m, tsid, nt), 0, nt).long()
            acc = torch.zeros((bl, nt + 1), dtype=torch.int64, device=m.device)
            out.append(acc.scatter_add_(1, sid, m.to(torch.int64))[:, :nt])
    return torch.stack(out, dim=1).to(torch.int32)


def _search_finish_plain(code, conds, cols: dict, ops_i, ops_f, tables: dict, counts):
    """M8, plain (the reference's `ev_trace` and its outputs): (trace_mask,
    where(trace_mask, union count, 0)), each (Bl, nt)."""
    shape = counts[:, 0].shape
    st: list = []
    for op, arg in zip(code[0::2].tolist(), code[1::2].tolist()):
        if op in (C_AND, C_OR):
            b, a = st.pop(), st.pop()
            st.append((a & b) if op == C_AND else (a | b))
        elif op == C_TRACIFY:
            st.append(counts[:, arg] > 0)
        elif op == C_COND:
            c = conds[arg]
            st.append(_cmp_b(c.op, cols[c.col], ops_i, ops_f, arg, c.is_float, tables.get(arg)))
        else:
            st.append(torch.full(shape, op == C_TRUE, dtype=torch.bool, device=counts.device))
    tm = st[-1]
    return tm, torch.where(tm, counts[:, -1], 0).to(torch.int32)


# ------------------------------------------------------------ kernels or plain


def mask_pack(m: torch.Tensor) -> torch.Tensor:
    """M6: (Bl, Sl) mask rows (Sl % 8 == 0) -> (Bl, Sl / 8) uint8."""
    if m.device.type == "cpu":
        return _mask_pack_plain(m)
    from .. import kernels

    return kernels.mask_pack(m)


class ShardSearch:
    """One rank's share of a sharded search over its local columns
    (tensors on one device: span.* (Bl, Sl), sattr.* / rattr.* (Bl, Al),
    res.* (Bl, R), trace.* (Bl, NT), *.off (Bl, n + 1)), its blocks'
    operands ints (Bl, C, 3), floats (Bl, C, 2) and tables {i: (Bl, L)
    uint8} as numpy, and their span counts."""

    def __init__(self, tree, conds: tuple, cols: dict, ints: np.ndarray, floats: np.ndarray,
                 tables: dict, n_spans: list, sp_index: int, nt: int):
        self.prog = _program(tree, conds, sharded=True)
        self.conds, self.cols, self.nt = conds, cols, nt
        tsid = cols["span.trace_sid"]
        dev = tsid.device
        self.on_card = dev.type == "cuda"
        bl, self.sl = tsid.shape
        self.sp_index = sp_index
        self.row0 = sp_index * self.sl
        self.n_spans = [int(n) for n in n_spans]
        self.n_spans_t = torch.tensor(self.n_spans, dtype=torch.int32, device=dev)
        self.slots = torch.empty((bl, max(self.prog.n_slots, 1), self.sl), dtype=torch.uint8,
                                 device=dev)
        self.ops_i = torch.from_numpy(np.ascontiguousarray(ints, np.int32)).to(dev)
        self.ops_f = torch.from_numpy(np.ascontiguousarray(floats, np.float32)).to(dev)
        self.tables = {i: torch.from_numpy(np.ascontiguousarray(t, np.uint8)).to(dev)
                       for i, t in tables.items()}
        self.bufs = self.descs = None
        if self.on_card:  # a descriptor table a block, pointing at its own rows
            self.bufs = [self.prog.buffer({n: t[b] for n, t in cols.items()},
                                          Operands(ints[b], floats[b]),
                                          {i: np.ascontiguousarray(t[b]) for i, t in tables.items()})
                         for b in range(bl)]
            self.descs = torch.tensor([b.data_ptr() + self.prog.desc_off for b in self.bufs],
                                      dtype=torch.int64, device=dev)

    def slot(self, s: int) -> torch.Tensor:
        """(Bl, Sl) view of one mask slot."""
        return self.slots[:, s]

    # -- M5
    def attr_partial(self, i: int) -> torch.Tensor:
        """(Bl, n_seg) int32 partial counts of attr or res leaf i."""
        c = self.conds[i]
        if c.target == T_RES:
            n_seg, al, arow0 = self.cols[c.col].shape[1], 0, 0
        else:
            n_seg = self.cols[f"{c.target}.off"].shape[1] - 1
            al = self.cols[f"{c.target}.key_id"].shape[1]
            arow0 = self.sp_index * al
        if not self.on_card:
            return _attr_partial_plain(c, self.cols, self.ops_i, self.ops_f, i, self.tables.get(i),
                                       arow0)
        from .. import kernels

        return kernels.attr_partial(self.descs, i, n_seg, al, arow0)

    def attr_mask(self, i: int, cnt: torch.Tensor) -> None:
        """Leaf i's span mask slot from its summed counts: (Bl, Sl) for a
        span attr, (Bl, n_res) for a resource attr or column."""
        res_idx = None if self.conds[i].target == T_SATTR else self.cols["span.res_idx"]
        s = self.prog.leaf_slots[i]
        if not self.on_card:
            self.slots[:, s] = _attr_mask_plain(cnt, res_idx, self.n_spans_t, self.row0, self.sl)
            return
        from .. import kernels

        kernels.attr_mask(cnt.contiguous(), res_idx, self.n_spans_t, self.row0, self.slots, s)

    # -- K1
    def span_step(self, step: tuple) -> None:
        """One span step ("span", off, len, out_slot): K1's span pass."""
        _, off, _, out = step
        if not self.on_card:
            self.slots[:, out] = _span_step_plain(self.prog.code(off), self.conds, self.cols,
                                                  self.ops_i, self.ops_f, self.tables, self.slots,
                                                  self.n_spans_t, self.row0)
            return
        from .. import kernels

        n_local = [min(max(n - self.row0, 0), self.sl) for n in self.n_spans]
        kernels.filter_span_shard(self.prog, self.bufs, step, self.slots, n_local)

    def struct_step(self, step: tuple, lm_g: torch.Tensor, pidx: torch.Tensor,
                    packed: bool = False) -> None:
        """One struct step ("struct", op, lslot, rslot, out_slot) against
        the gathered lhs mask lm_g: (Bl, S), or with packed (Bl, S / 8)
        uint8 as M6 packs it, which K1's struct pass reads bit by bit
        (here: unpacked by the plain version first). pidx is the shard's
        parent rows for '>', the gathered parent table for '>>' and '~'."""
        _, op, _, r, out = step
        if not self.on_card:
            lm = _mask_unpack_plain(lm_g) if packed else lm_g
            self.slots[:, out] = _struct_step_plain(op, lm, self.slots[:, r] != 0, pidx,
                                                    self.n_spans_t, self.row0)
            return
        from .. import kernels

        kernels.filter_struct_shard(op, lm_g, self.slots, r, out, pidx.contiguous(), self.n_spans,
                                    self.row0, packed)

    # -- M7, M8
    def partial(self) -> torch.Tensor:
        """(Bl, n_tr + 1, NT) int32 partial counts of the shard's rows."""
        span_off = self.cols.get("trace.span_off")
        tsid = None if span_off is not None else self.cols["span.trace_sid"]
        if not self.on_card:
            return _search_partial_plain(self.slots, self.prog.tslots, span_off, tsid,
                                         self.n_spans_t, self.row0, self.nt)
        from .. import kernels

        return kernels.search_partial(self.prog, self.bufs[0], self.slots, span_off, tsid,
                                      self.n_spans_t, self.row0, self.nt)

    def finish(self, counts: torch.Tensor):
        """(trace_mask, span_count), each (Bl, NT), from the summed counts."""
        if not self.on_card:
            return _search_finish_plain(self.prog.code(self.prog.trace_off), self.conds, self.cols,
                                        self.ops_i, self.ops_f, self.tables, counts)
        from .. import kernels

        return kernels.search_finish(self.prog, self.bufs[0], self.descs, counts.contiguous())

    def partial_finish(self):
        """finish(partial()) for a shard whose partial counts are the sums
        (an sp axis of one rank): on a card one launch of both halves
        (kernels.search_fused), the counts never in device memory, where
        the blocks have trace.span_off and the tree at most
        kernels.FUSED_MAX_TR tracify slots; else M7, then M8."""
        span_off = self.cols.get("trace.span_off")
        if self.on_card and span_off is not None:
            from .. import kernels

            if len(self.prog.tslots) <= kernels.FUSED_MAX_TR:
                return kernels.search_fused(self.prog, self.bufs[0], self.descs, self.slots,
                                            span_off, self.n_spans_t, self.row0, self.nt)
        return self.finish(self.partial())
