"""K4 over many resource columns (tempo_tpu_torch/csrc/stage.cu) and M1,
the sharded find's election fused with K3 (csrc/find.cu), on the CPU
against the JAX package.

K4: the many-column plain version against tempo_tpu.ops.stage's jitted
`_res_to_span`, column by column (and block by block where stacked), on
torch_tile_cases.RES_SHAPES (negative indexes and indexes past the table
in every case); a numpy model of the kernel's walk (quads of 4 spans, a
span at a time past a row boundary or off the vector rule, columns in
launches of RES_COLS) against the plain version; staging with two span@ columns against the reference's
staging, in one K4 call; M4's mesh body in one K4 call, no torch.stack.

M1: the packed key (block << 32) | row, -1 for a miss, decoded, against
the reference's `local` (tempo_tpu/parallel/find.py:44-64) in jnp on one
shard, for 1, 3, 12 and 130 blocks, all misses, an id in two blocks and
a hit at block 0 row 0; and a numpy model of the kernel (a CTA a query,
its warps taking blocks w, w + nw, ..., a launch a 64 blocks folding
into the same keys) against the plain version. Every output is an int:
equality is exact."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_find_warp import lockstep, warp_search
from torch_tile_cases import RES_SHAPES, elect_case, res_case

from tempo_tpu.backend import MemBackend as RMemBackend
from tempo_tpu.block import build_block_from_traces as r_build
from tempo_tpu.block import open_block as r_open
from tempo_tpu.ops import find as RFD
from tempo_tpu.ops import stage as RST
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch import kernels
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import open_block
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import find as FD
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.parallel import timeseries as PTS
from tempo_tpu_torch.parallel.mesh import Mesh

PAD_I32 = -(2**31)
QUAD = 4  # stage.cu: spans a thread's 16-byte load
ELECT_WARPS = 16  # find.cu: warps a CTA at most


def _source(name: str) -> str:
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


# ------------------------------------------------------------------ K4
def _reference(tables, idx) -> np.ndarray:
    """tempo_tpu's `_res_to_span` a column (and a block, where stacked)."""
    out = []
    for t in tables:
        if idx.ndim == 1:
            out.append(np.asarray(RST._res_to_span(t, idx)))
        else:
            out.append(np.stack([np.asarray(RST._res_to_span(t[b], idx[b]))
                                 for b in range(idx.shape[0])]))
    return np.stack(out)


@pytest.mark.parametrize("shape", list(RES_SHAPES))
def test_res_many_plain_matches_reference(shape):
    tables, idx = res_case(11, *RES_SHAPES[shape])
    got = ST.res_to_span_many([torch.from_numpy(t) for t in tables], torch.from_numpy(idx))
    assert got.shape == (len(tables),) + idx.shape and got.dtype == torch.int32
    want = _reference(tables, idx)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == PAD_I32).any() and (idx >= tables[0].shape[-1]).any()


def res_model(tables, idx) -> np.ndarray:
    """stage.cu's walk: launches of RES_COLS columns, each column's Bl
    tables end to end (block b's at b * n_res); a quad of 4 spans a
    thread where the vector rule holds (C = 1 or n % 4 == 0), a span at a
    time where a block's row cuts the quad and past the last whole
    quad."""
    bl, S = (1, idx.shape[0]) if idx.ndim == 1 else idx.shape
    flat = idx.reshape(-1)
    n = flat.shape[0]
    out = np.zeros((len(tables), n), np.int32)
    for c0 in range(0, len(tables), kernels.RES_COLS):
        chunk = [t.reshape(-1) for t in tables[c0:c0 + kernels.RES_COLS]]
        n_res = [t.shape[0] // bl for t in chunk]

        def one(c, b, r):
            if r < 0:
                return PAD_I32
            return chunk[c][b * n_res[c] + min(r, n_res[c] - 1)]

        def span(e):
            b = e // S
            for c in range(len(chunk)):
                out[c0 + c, e] = one(c, b, flat[e])

        vec = len(chunk) == 1 or n % QUAD == 0
        nq = n // QUAD if vec else 0
        for q in range(nq):
            e = QUAD * q
            b = e // S
            if (b + 1) * S < e + QUAD:
                for k in range(QUAD):
                    span(e + k)
                continue
            for c in range(len(chunk)):
                out[c0 + c, e : e + QUAD] = [one(c, b, r) for r in flat[e : e + QUAD]]
        for e in range(QUAD * nq, n):
            span(e)
    return out.reshape((len(tables),) + idx.shape)


@pytest.mark.parametrize("shape", ["small", "odd", "odd_stacked", "chunked"])
def test_res_kernel_model_matches_plain(shape):
    bl, S, n_res, C = RES_SHAPES[shape]
    tables, idx = res_case(12, bl, S, n_res, C)
    want = ST._res_to_span_many_plain([torch.from_numpy(t) for t in tables], torch.from_numpy(idx))
    np.testing.assert_array_equal(res_model(tables, idx), want.numpy())


def test_k4_constants_match_source():
    """The wrapper's columns a launch and the model's quad are the
    kernel's, and the wrapper's C type list is the entry point's."""
    src = _source("stage.cu")
    assert int(re.search(r"#define RS_COLS (\d+)", src).group(1)) == kernels.RES_COLS
    assert "int4 x[RS_UNROLL]" in src and "__ldcs((const int4*)a.idx" in src  # 4 spans a load
    args = re.search(r"TT_EXPORT int tt_res_to_span\(([^)]*)\)", src).group(1).split(",")
    assert len(args) == len(kernels._SIGNATURES["tt_res_to_span"][1])


@pytest.fixture(scope="module")
def ref_block():
    backend = RMemBackend()
    meta = r_build(backend, "t", make_traces(120, seed=16, n_spans=10), row_group_spans=256)
    port = MemBackend()
    for (t, b, name), data in backend._objects.items():
        port.write(t, b, name, data)
    return r_open(backend, "t", meta.block_id), open_block(port, "t", meta.block_id)


def test_staging_two_span_columns_match_reference(ref_block, monkeypatch):
    """A staged block with two span@ columns equals the reference's
    staging, through one K4 call whose rows are the two columns."""
    rblk, blk = ref_block
    needed = ["span.res_idx", "res.service_id", "res.namespace_id", "span@res.service_id",
              "span@res.namespace_id"]
    calls = []
    many = ST.res_to_span_many
    monkeypatch.setattr(ST, "res_to_span_many", lambda t, i: calls.append(len(t)) or many(t, i))
    got = ST.stage_block(blk, needed, cache=False, device="cpu")
    want = RST.stage_block(rblk, needed, cache=False)
    assert calls == [2]
    for name in ("span@res.service_id", "span@res.namespace_id"):
        np.testing.assert_array_equal(got.cols[name].numpy(), np.asarray(want.cols[name]), name)
    assert (np.asarray(want.cols["span@res.namespace_id"]) >= 0).any()


def test_ts_body_one_k4_call_no_stack(monkeypatch):
    """M4's mesh body with two resource conditions over 3 stacked blocks:
    one K4 call for both span@ columns and no torch.stack; the fold
    equals the body's fold over the same columns materialized by the
    reference's gather."""
    rng = np.random.default_rng(16)
    B, S, R = 3, 1024, 64
    cols = {"span.start_ms": rng.integers(0, 60_000, (B, S)).astype(np.int32),
            "span.trace_sid": np.sort(rng.integers(0, 100, (B, S)), axis=1).astype(np.int32),
            "span.res_idx": rng.integers(-1, R, (B, S)).astype(np.int32),
            "res.service_id": rng.integers(-1, 6, (B, R)).astype(np.int32),
            "res.namespace_id": rng.integers(-1, 4, (B, R)).astype(np.int32)}
    conds = (F.Cond("res", "res.service_id", "eq"), F.Cond("res", "res.namespace_id", "eq"),
             F.Cond("res", "res.service_id", "ne"))
    tree = ("or", ("and", ("cond", 0), ("cond", 1)), ("cond", 2))
    operands = [F.Operands.build([(0, b % 3, 0, 0.0, 0.0), (0, 1, 0, 0.0, 0.0),
                                  (0, 4, 0, 0.0, 0.0)]) for b in range(B)]
    gid = rng.integers(-1, 5, (B, S)).astype(np.int32)
    rest = (np.full(B, S, np.int32), np.zeros(B, np.int32), gid, None, None, 10_000, 7, 5)
    calls, stacks = [], []
    many = PTS.res_to_span_many
    monkeypatch.setattr(PTS, "res_to_span_many", lambda t, i: calls.append(len(t)) or many(t, i))
    stack = torch.stack
    monkeypatch.setattr(torch, "stack", lambda *a, **k: stacks.append(1) or stack(*a, **k))
    got = PTS.sharded_timeseries(Mesh(1, 1, "cpu"), tree, conds, operands, cols, *rest)
    monkeypatch.setattr(torch, "stack", stack)
    assert calls == [2] and not stacks
    pre = dict(cols)
    for n in ("res.service_id", "res.namespace_id"):
        pre[f"span@{n}"] = _reference([cols[n]], cols["span.res_idx"])[0]
    want = PTS.sharded_timeseries(Mesh(1, 1, "cpu"), tree, conds, operands, pre, *rest)
    assert calls == [2] and int(want[0].sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ M1
def _local(case: dict, n_steps: int) -> np.ndarray:
    """The reference's `local` (tempo_tpu/parallel/find.py:44-64) on one
    shard, whose blocks are the global blocks base ..: the vmapped
    bisection, then both stages' arithmetic (pmax over one shard is the
    identity) -> (Q, 2) [block, row]."""
    ids, nv, queries = (jnp.asarray(case[k]) for k in ("ids", "n_valid", "queries"))
    sids = jax.vmap(lambda a, n: RFD.bisect_ids(a, queries, n, n_steps))(ids, nv)
    gblock = case["base"] + jnp.arange(ids.shape[0], dtype=jnp.int32)[:, None]
    blk = jnp.where(sids >= 0, gblock, -1)
    best_blk = jnp.max(blk, axis=0)
    row = jnp.max(jnp.where(blk == best_blk[None, :], sids, -1), axis=0)
    return np.asarray(jnp.stack([best_blk, row], axis=-1))


def _port(case: dict, n_steps: int) -> np.ndarray:
    ids, nv, qs = (torch.from_numpy(case[k]) for k in ("ids", "n_valid", "queries"))
    keys = FD.find_elect(ids, qs, nv, n_steps, case["base"])
    assert keys.dtype == torch.int64 and keys.shape == (qs.shape[0],)
    return FD.decode_keys(keys.numpy())


@pytest.mark.parametrize("bl", [1, 3, 12, 130])
def test_packed_key_matches_reference_local(bl):
    case = elect_case(20 + bl, bl)
    steps = case["ids"].shape[1].bit_length()
    got = _port(case, steps)
    np.testing.assert_array_equal(got, _local(case, steps))
    assert (got[:, 0] >= 0).sum() >= len(case["queries"]) - len(case["queries"]) // 4


def test_packed_key_all_misses():
    case = elect_case(5, 12, misses_only=True)
    steps = case["ids"].shape[1].bit_length()
    got = _port(case, steps)
    np.testing.assert_array_equal(got, _local(case, steps))
    assert (got == -1).all()


def test_packed_key_id_in_two_blocks_higher_wins():
    """Query 1 is the last block's first row, also held by block 0: the
    last (highest) block and its row win, as the reference's two stages
    elect them."""
    case = elect_case(7, 5)
    steps = case["ids"].shape[1].bit_length()
    rows = FD._bisect_plain(*(torch.from_numpy(case[k]) for k in ("ids", "queries", "n_valid")),
                            steps)
    assert rows[0, 1] >= 0 and rows[-1, 1] == 0  # held by both
    got = _port(case, steps)
    np.testing.assert_array_equal(got, _local(case, steps))
    assert tuple(got[1]) == (case["base"] + 4, 0)


def test_packed_key_block_zero_row_zero_beats_a_miss():
    """A hit at global block 0, row 0 packs to key 0, which must beat a
    miss's -1 in the all_reduce MAX and decode to (0, 0)."""
    case = elect_case(10, 1)  # base 0
    assert case["base"] == 0
    steps = case["ids"].shape[1].bit_length()
    ids, nv, qs = (torch.from_numpy(case[k]) for k in ("ids", "n_valid", "queries"))
    q0 = qs[:1]  # block 0's row 0
    keys = FD.find_elect(ids, q0, nv, steps, 0)
    miss = FD._find_elect_plain(torch.full((3, 1), -1, dtype=torch.int32), 3)
    assert int(keys[0]) == 0 and int(miss[0]) == -1
    assert FD.decode_keys(torch.maximum(keys, miss).numpy()).tolist() == [[0, 0]]
    np.testing.assert_array_equal(FD.decode_keys(np.asarray([-1, 0, (5 << 32) | 7], np.int64)),
                                  [[-1, -1], [0, 0], [5, 7]])


def elect_model(ids: np.ndarray, nv: np.ndarray, queries: np.ndarray, n_steps: int,
                base: int) -> np.ndarray:
    """find.cu's election: a launch a FIND_BLOCKS blocks; a CTA a query
    of min(B, ELECT_WARPS) warps, warp w taking blocks w, w + nw, ...
    with K3's route a block (the warp search, or the lockstep loop where
    n_steps < bit_length(n_valid) or n_valid is outside [0, T]), keeping
    the last hit's key; the CTA's max over its warps, maxed into the
    previous launch's key after the first."""
    B, T, _ = ids.shape
    keys = np.full(queries.shape[0], -1, np.int64)
    for b0 in range(0, B, kernels.FIND_BLOCKS):
        nb = min(B - b0, kernels.FIND_BLOCKS)
        nw = min(nb, ELECT_WARPS)
        for qi, q in enumerate(queries):
            warp_keys = []
            for w in range(nw):
                key = -1
                for b in range(w, nb, nw):
                    g = b0 + b
                    n = int(nv[g])
                    short = n < 0 or n > T or n_steps < max(n, 0).bit_length()
                    r = lockstep(ids[g], n, q, n_steps) if short else warp_search(ids[g], n, q)[0]
                    if r >= 0:
                        key = ((base + g) << 32) | r
                warp_keys.append(key)
            cta = max(warp_keys)
            keys[qi] = cta if b0 == 0 else max(keys[qi], cta)
    return keys


@pytest.mark.parametrize("bl,short", [(1, False), (12, False), (12, True), (130, False)])
def test_election_model_matches_plain(bl, short):
    case = elect_case(30 + bl, bl, T=128, q=24)
    steps = 2 if short else case["ids"].shape[1].bit_length()
    got = elect_model(case["ids"], case["n_valid"], case["queries"], steps, case["base"])
    want = FD._find_elect_plain(
        FD._bisect_plain(*(torch.from_numpy(case[k]) for k in ("ids", "queries", "n_valid")),
                         steps), case["base"])
    np.testing.assert_array_equal(got, want.numpy())


def test_election_constants_match_source():
    src = _source("find.cu")
    assert int(re.search(r"#define ELECT_WARPS (\d+)", src).group(1)) == ELECT_WARPS
    assert int(re.search(r"#define FIND_BLOCKS (\d+)", src).group(1)) == kernels.FIND_BLOCKS
    assert re.search(r"\(\(long long\)\(a\.gbase \+ b\) << 32\) \| \(unsigned\)r", src)
