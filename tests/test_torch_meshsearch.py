"""The plain versions of the sharded search's kernels (ops/meshsearch.py:
M5 attr_partial and its mask, M6 mask_pack / mask_unpack, M7
search_partial, M8 search_finish; ops/filter.py: K1's struct step on a
shard) against the reference's per-shard arithmetic
(tempo_tpu/parallel/search.py:95-333) run in jnp and numpy on one
shard's rows, with no mesh: every sp cut of 1, 2 and 4 shards, owners and
traces that straddle a cut, shards with no rows of an owner. Partial
counts over the shards must also sum to the whole block's. Every output
is an int or a bool: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS

SPS = [1, 2, 4]
INT_MIN = -(2**31)


def _owner_counts_ref(row_hit, off, arow0):
    """The reference's owner_counts (search.py:122-140) in jnp."""
    al = row_hit.shape[1]
    ecs = jnp.concatenate([jnp.zeros((row_hit.shape[0], 1), jnp.int32),
                           jnp.cumsum(jnp.asarray(row_hit).astype(jnp.int32), axis=1)], axis=1)
    lo = jnp.clip(off[:, :-1] - arow0, 0, al)
    hi = jnp.clip(off[:, 1:] - arow0, 0, al)
    return np.asarray(jnp.take_along_axis(ecs, hi, 1) - jnp.take_along_axis(ecs, lo, 1))


def _attr_block(rng, bl=2, n_own=32, A=64):
    """Ragged attr rows grouped by owner: owners with none, owners whose
    rows cross every cut of A into 2 or 4."""
    off = np.zeros((bl, n_own + 1), np.int32)
    for b in range(bl):
        c = rng.integers(0, 5, size=n_own)
        c[np.cumsum(c) > A] = 0
        off[b, 1:] = np.cumsum(c)
    cols = {"sattr.off": off, "sattr.key_id": rng.integers(0, 3, (bl, A)).astype(np.int32),
            "sattr.vtype": rng.integers(0, 2, (bl, A)).astype(np.int32),
            "sattr.str_id": rng.integers(0, 4, (bl, A)).astype(np.int32)}
    for b in range(bl):
        cols["sattr.key_id"][b, off[b, -1]:] = F.PAD_I32
    return cols


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("col", ["str", "any"])
def test_attr_partial_plain_matches_reference(sp, col):
    rng = np.random.default_rng(10 + sp)
    cols = _attr_block(rng)
    bl, A = cols["sattr.key_id"].shape
    c = F.Cond("sattr", col, "eq" if col == "str" else "exists")
    ops_i = np.asarray([[[2, 1, 0]], [[1, 3, 0]]], np.int32)
    ops_f = np.zeros((bl, 1, 2), np.float32)
    key_match = cols["sattr.key_id"] == ops_i[:, 0, 0:1]
    hit = key_match if col == "any" else (
        key_match & (cols["sattr.vtype"] == 0) & (cols["sattr.str_id"] == ops_i[:, 0, 1:2]))
    al = A // sp
    total = np.zeros((bl, cols["sattr.off"].shape[1] - 1), np.int64)
    for k in range(sp):
        part = {n: torch.from_numpy(np.ascontiguousarray(a[:, k * al:(k + 1) * al]))
                for n, a in cols.items() if n != "sattr.off"}
        part["sattr.off"] = torch.from_numpy(cols["sattr.off"])
        got = MS._attr_partial_plain(c, part, torch.from_numpy(ops_i), torch.from_numpy(ops_f), 0,
                                     None, k * al)
        want = _owner_counts_ref(hit[:, k * al:(k + 1) * al], cols["sattr.off"], k * al)
        np.testing.assert_array_equal(got.numpy(), want)
        total += got.numpy()
    off = cols["sattr.off"]
    whole = np.asarray([[hit[b, off[b, o]:off[b, o + 1]].sum() for o in range(off.shape[1] - 1)]
                        for b in range(bl)])
    np.testing.assert_array_equal(total, whole)
    assert whole.sum() > 0


def test_attr_partial_plain_res_leaf_and_mask():
    """A resource leaf compares per resource; the mask gathers the summed
    counts through the clamped res_idx on valid rows only."""
    rng = np.random.default_rng(3)
    bl, R, sl, row0 = 2, 8, 16, 16
    res = rng.integers(0, 4, (bl, R)).astype(np.int32)
    ops_i = np.asarray([[[0, 2, 0]], [[0, 1, 0]]], np.int32)
    c = F.Cond("res", "res.service_id", "eq")
    cnt = MS._attr_partial_plain(c, {"res.service_id": torch.from_numpy(res)},
                                 torch.from_numpy(ops_i), torch.zeros((bl, 1, 2)), 0, None, 0)
    np.testing.assert_array_equal(cnt.numpy(), (res == ops_i[:, 0, 1:2]).astype(np.int32))
    res_idx = rng.integers(-1, R + 3, (bl, sl)).astype(np.int32)
    n_spans = torch.tensor([20, 40], dtype=torch.int32)
    got = MS._attr_mask_plain(cnt, torch.from_numpy(res_idx), n_spans, row0, sl).numpy()
    valid = (np.arange(sl)[None] + row0) < n_spans.numpy()[:, None]
    want = (np.take_along_axis(cnt.numpy() > 0, np.clip(res_idx, 0, R - 1), 1)
            & (res_idx >= 0) & valid)
    np.testing.assert_array_equal(got, want)
    span_cnt = rng.integers(-1, 3, (bl, sl)).astype(np.int32)
    got = MS._attr_mask_plain(torch.from_numpy(span_cnt), None, n_spans, row0, sl).numpy()
    np.testing.assert_array_equal(got, (span_cnt > 0) & valid)


@pytest.mark.parametrize("sl", [8, 64, 1024])
def test_mask_pack_matches_numpy(sl):
    rng = np.random.default_rng(sl)
    slots = torch.from_numpy(rng.integers(0, 2, (3, 4, sl)).astype(np.uint8))
    m = slots[:, 2]  # a slot of the shard's slots: rows strided
    pk = MS._mask_pack_plain(m)
    np.testing.assert_array_equal(pk.numpy(), np.packbits(m.numpy().astype(bool), axis=1))
    back = MS._mask_unpack_plain(pk)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), np.unpackbits(pk.numpy(), axis=1).astype(bool))
    np.testing.assert_array_equal(back.numpy(), m.numpy().astype(bool))


def _seg_ref(mask, off, sid, row0, nt):
    """The reference's seg_reduce before its psum (search.py:272-290)."""
    sl = mask.shape[1]
    if off is not None:
        ecs = jnp.concatenate([jnp.zeros((mask.shape[0], 1), jnp.int32),
                               jnp.cumsum(jnp.asarray(mask).astype(jnp.int32), axis=1)], axis=1)
        lo = jnp.clip(off[:, :-1] - row0, 0, sl)
        hi = jnp.clip(off[:, 1:] - row0, 0, sl)
        return np.asarray(jnp.take_along_axis(ecs, hi, 1) - jnp.take_along_axis(ecs, lo, 1))
    s = np.clip(np.where(mask, sid, nt), 0, nt)
    return np.stack([np.bincount(s[b], weights=mask[b], minlength=nt + 1)[:nt]
                     for b in range(mask.shape[0])]).astype(np.int32)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("layout", ["offsets", "trace_sid"])
def test_search_partial_plain_matches_reference(sp, layout):
    rng = np.random.default_rng(20 + sp)
    bl, S, nt, n_slots = 2, 64, 8, 3
    n_spans = np.asarray([64, 37], np.int32)
    sid = np.sort(rng.integers(-1, nt + 2, (bl, S)), axis=1).astype(np.int32)
    off = np.zeros((bl, nt + 1), np.int32)
    for b in range(bl):
        off[b, 1:] = np.cumsum(np.bincount(np.clip(sid[b, :n_spans[b]], 0, nt - 1), minlength=nt))
    valid = np.arange(S)[None] < n_spans[:, None]
    slots = (rng.random((bl, n_slots, S)) < 0.4) & valid[:, None]
    sl = S // sp
    for tslots in ([0, 2], []):
        masks = [slots[:, s] for s in tslots]
        union = np.logical_or.reduce(masks) if masks else valid
        total = 0
        for k in range(sp):
            cut = slice(k * sl, (k + 1) * sl)
            got = MS._search_partial_plain(
                torch.from_numpy(np.ascontiguousarray(slots[:, :, cut]).astype(np.uint8)), tslots,
                torch.from_numpy(off) if layout == "offsets" else None,
                torch.from_numpy(np.ascontiguousarray(sid[:, cut])), torch.from_numpy(n_spans),
                k * sl, nt).numpy()
            o = off if layout == "offsets" else None
            want = np.stack([_seg_ref(m[:, cut], o, sid[:, cut], k * sl, nt)
                             for m in masks + [union]], axis=1)
            np.testing.assert_array_equal(got, want)
            total = total + got
        whole = np.stack([_seg_ref(m, off if layout == "offsets" else None, sid, 0, nt)
                          for m in masks + [union]], axis=1)
        np.testing.assert_array_equal(total, whole)  # the psum over sp stitches the cuts
        assert whole.sum() > 0


def test_search_finish_plain_matches_reference():
    """The trace program: tracify leaves over the summed counts, a trace
    condition and a table against each block's own operands, no valid-
    trace mask (the reference's mesh ev_trace)."""
    rng = np.random.default_rng(5)
    bl, nt = 3, 16
    conds = (F.Cond("span", "span.dur_us", "gt"), F.Cond("trace", "trace.dur_ms", "ge"),
             F.Cond("trace", "trace.root_name_id", "intable"))
    tree = ("or", ("and", ("tracify", ("cond", 0)), ("cond", 1)), ("cond", 2))
    prog = F._program(tree, conds, sharded=True)
    counts = rng.integers(0, 3, (bl, len(prog.tslots) + 1, nt)).astype(np.int32)
    dur = rng.integers(0, 100, (bl, nt)).astype(np.int32)
    name = rng.integers(-1, 6, (bl, nt)).astype(np.int32)
    ops_i = np.zeros((bl, 3, 3), np.int32)
    ops_i[:, 1, 1] = [10, 50, 90]
    table = (rng.random((bl, 8)) < 0.3).astype(np.uint8)
    tm, cnt = MS._search_finish_plain(
        prog.code(prog.trace_off), conds,
        {"trace.dur_ms": torch.from_numpy(dur), "trace.root_name_id": torch.from_numpy(name)},
        torch.from_numpy(ops_i), torch.zeros((bl, 3, 2)), {2: torch.from_numpy(table)},
        torch.from_numpy(counts))
    in_tab = (np.take_along_axis(table, np.clip(name, 0, 7), 1) > 0) & (name >= 0)
    want = ((counts[:, 0] > 0) & (dur >= ops_i[:, 1, 1:2])) | in_tab
    np.testing.assert_array_equal(tm.numpy(), want)
    np.testing.assert_array_equal(cnt.numpy(), np.where(want, counts[:, -1], 0))
    assert want.any() and not want.all()


def _struct_oracle(op, lhs, rhs, pidx, n):
    """tests/test_parallel.py:266-285's numpy oracle of one block."""
    S = lhs.shape[0]
    valid = np.arange(S) < n
    has_p = (pidx >= 0) & valid
    safe = np.clip(pidx, 0, S - 1)
    if op == ">":
        rel = has_p & lhs[safe]
    elif op == ">>":
        rel = np.zeros(S, bool)
        for i in range(S):
            p = pidx[i] if valid[i] else -1
            while p >= 0:
                if lhs[p]:
                    rel[i] = True
                    break
                p = pidx[p]
    else:
        cnt = np.zeros(S, np.int32)
        np.add.at(cnt, safe, (lhs & has_p).astype(np.int32))
        sibs = cnt[safe] - (lhs & has_p).astype(np.int32)
        orphan = (pidx == -2) & valid
        rel = (has_p & (sibs > 0)) | (orphan & np.any(lhs & orphan))
    return rhs & rel & valid


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("op", [">", ">>", "~"])
def test_struct_step_plain_on_shards(sp, op):
    """K1's struct step on a shard: lm and (for >> and ~) the parent table
    whole, rm and the output the shard's rows from row0; the shards
    together equal the whole block's relation."""
    rng = np.random.default_rng(31)
    S, n = 64, 52
    pidx = np.where(rng.random(S) < 0.7, np.maximum(np.arange(S) - rng.integers(1, 4, S), -1),
                    -1).astype(np.int32)
    pidx[[17, 33, 49]] = -2
    valid = np.arange(S) < n
    lhs, rhs = (rng.random(S) < 0.5) & valid, (rng.random(S) < 0.6) & valid
    want = _struct_oracle(op, lhs, rhs, pidx, n)
    sl = S // sp
    got = []
    for k in range(sp):
        cut = slice(k * sl, (k + 1) * sl)
        p = pidx[cut] if op == ">" else pidx
        got.append(F._struct_step_plain(op, torch.from_numpy(lhs[None]),
                                        torch.from_numpy(rhs[None, cut]),
                                        torch.from_numpy(np.ascontiguousarray(p)[None]),
                                        torch.tensor([n], dtype=torch.int32), k * sl)[0].numpy())
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert want.any()


@pytest.mark.parametrize("kind", ["attr", "span"])
def test_partial_plain_offsets_that_wrap(kind):
    """Offsets within a shard's first row of INT_MIN: the reference takes
    off - row0 in int32, which wraps, so such a range clips to the
    shard's end, not its start. M5's and M7's plain versions on every
    shard of sp = 4 equal its arithmetic, and on some shard the wrap
    gives another count than a 64-bit difference would."""
    rng = np.random.default_rng(40)
    sp = 4
    if kind == "attr":
        cols = _attr_block(rng)
        mask = cols["sattr.key_id"] == 1
        off = cols["sattr.off"]
    else:
        bl, S, nt = 2, 64, 8
        sid = np.sort(rng.integers(0, nt, (bl, S)), axis=1).astype(np.int32)
        off = np.zeros((bl, nt + 1), np.int32)
        for b in range(bl):
            off[b, 1:] = np.cumsum(np.bincount(sid[b], minlength=nt))
        slots = (rng.random((bl, 1, S)) < 0.5).astype(np.uint8)
        mask = slots[:, 0] != 0
    off[0, [2, 5]] = [INT_MIN, INT_MIN + 30]
    off[1, 6] = INT_MIN + 40
    bl, n = mask.shape
    sl = n // sp
    differs = False
    for k in range(sp):
        cut, r0 = slice(k * sl, (k + 1) * sl), k * sl
        if kind == "attr":
            part = {c: torch.from_numpy(np.ascontiguousarray(a[:, cut]))
                    for c, a in cols.items() if c != "sattr.off"}
            part["sattr.off"] = torch.from_numpy(off)
            ops_i = torch.from_numpy(np.asarray([[[1, 0, 0]]] * bl, np.int32))
            got = MS._attr_partial_plain(F.Cond("sattr", "any", "exists"), part, ops_i,
                                         torch.zeros((bl, 1, 2)), 0, None, r0).numpy()
            want = _owner_counts_ref(mask[:, cut], off, r0)
        else:
            got = MS._search_partial_plain(
                torch.from_numpy(np.ascontiguousarray(slots[:, :, cut])), [0], torch.from_numpy(off),
                None, torch.from_numpy(np.asarray([S, S], np.int32)), r0, nt).numpy()[:, 0]
            want = _seg_ref(mask[:, cut], off, None, r0, nt)
        np.testing.assert_array_equal(got, want, err_msg=f"shard {k}")
        ecs = np.concatenate([np.zeros((bl, 1), np.int64), np.cumsum(mask[:, cut], axis=1)], 1)
        lo, hi = (np.clip(off.astype(np.int64)[:, i] - r0, 0, sl) for i in (slice(0, -1),
                                                                              slice(1, None)))
        wide = np.take_along_axis(ecs, hi, 1) - np.take_along_axis(ecs, lo, 1)
        differs = differs or not np.array_equal(want, wide)
    assert differs

