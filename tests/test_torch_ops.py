"""The port's find (K3), select (K2) and stage (K4) operations on the CPU
against the JAX package's (the filter program K1 is in test_torch_filter*.py).

Each test hands the same numpy inputs, made from a seed, to a tempo_tpu
program (jitted on the CPU, as its own tests run it) and to its
tempo_tpu_torch counterpart on device="cpu" (the kernel's plain PyTorch
version). Every output is a bool or an int: equality is exact."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import test_torch_cases as TC

from tempo_tpu.backend import MemBackend as RMemBackend
from tempo_tpu.block import build_block_from_traces as r_build
from tempo_tpu.block import open_block as r_open
from tempo_tpu.block import schema as RS
from tempo_tpu.ops import filter as RF
from tempo_tpu.ops import find as RFD
from tempo_tpu.ops import select as RSE
from tempo_tpu.ops import stage as RST
from tempo_tpu.util.testdata import make_traces
from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.block import open_block
from tempo_tpu_torch.block import schema as S
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import find as FD
from tempo_tpu_torch.ops import select as SE
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops.device import bucket
from tempo_tpu_torch.util.synth import synth_block

TENANT = "t"


@pytest.fixture(scope="module")
def ref_block():
    """A block written by the JAX package, opened by both readers."""
    backend = RMemBackend()
    traces = make_traces(120, seed=5, n_spans=10)
    meta = r_build(backend, TENANT, traces, row_group_spans=256)
    port_backend = MemBackend()
    for (t, b, name), data in backend._objects.items():
        port_backend.write(t, b, name, data)
    return r_open(backend, TENANT, meta.block_id), open_block(port_backend, TENANT, meta.block_id), traces


# ------------------------------------------------------------------ find (K3)


def test_find_present_and_absent_ids(ref_block):
    rblk, blk, traces = ref_block
    rng = np.random.default_rng(3)
    absent = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(20)]
    q = np.asarray([S.trace_id_to_codes(t) for t, _ in traces] +
                   [S.trace_id_to_codes(t) for t in absent], np.int32)
    got = FD.lookup_ids_blocks_cached([blk], q, "cpu")[0]
    np.testing.assert_array_equal(got, RFD.lookup_ids(rblk.trace_index["trace.id_codes"], q))
    np.testing.assert_array_equal(got[: len(traces)], np.arange(len(traces)))
    assert (got[len(traces):] == -1).all()


def test_find_signed_unsigned_boundary_ids():
    ids = sorted([b"\x00" * 16, b"\x7f" + b"\xff" * 15, b"\x80" + b"\x00" * 15, b"\xff" * 16])
    codes = np.asarray([S.trace_id_to_codes(t) for t in ids], dtype=np.int32)
    blk = SimpleNamespace(trace_index={"trace.id_codes": codes})
    got = FD.lookup_ids_blocks_cached([blk], codes, "cpu")[0]
    np.testing.assert_array_equal(got, RFD.lookup_ids(codes, codes))
    np.testing.assert_array_equal(got, np.arange(4))


def test_find_stacked_blocks_match_reference():
    backend = MemBackend()
    rng = np.random.default_rng(17)
    blocks, ids = [], []
    for n in (256, 700):
        meta, bid = synth_block(backend, TENANT, rng, n, 8, n_res=64)
        blocks.append(open_block(backend, TENANT, meta.block_id))
        ids.append(bid)
    pick = [ids[0][5], ids[1][0], ids[1][699], ids[0][255], b"\x00" * 16, b"\xff" * 16]
    q = np.asarray([S.trace_id_to_codes(bytes(t)) for t in pick], np.int32)
    got = FD.lookup_ids_blocks_cached(blocks, q, "cpu")
    want = RFD.lookup_ids_blocks([b.trace_index["trace.id_codes"] for b in blocks], q)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 5 and got[1, 2] == 699 and got[0, 3] == 255


# ---------------------------------------------------------------- select (K2)


def _select_inputs(n, seed, p_mask=0.3):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < p_mask
    key = rng.integers(0, 5, n).astype(np.int32)  # heavy ties
    counts = rng.integers(0, 100, n).astype(np.int32)
    return mask, key, counts


@pytest.mark.parametrize("k", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_select_every_k_bucket_with_ties(k):
    mask, key, counts = _select_inputs(2048, k)
    got = SE.select_topk_device(torch.from_numpy(mask), torch.from_numpy(key),
                                torch.from_numpy(counts), k)
    want = RSE.select_topk_device(mask, key, counts, k)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


def test_select_k_above_match_count():
    mask, key, counts = _select_inputs(1024, 9, p_mask=0.01)
    assert mask.sum() < 64
    got = SE.select_topk_device(torch.from_numpy(mask), torch.from_numpy(key),
                                torch.from_numpy(counts), 64)
    want = RSE.select_topk_device(mask, key, counts, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == mask.sum()


def test_select_multi_parts():
    parts = [_select_inputs(n, n) for n in (1024, 2048, 1024)]
    got = SE.select_topk_device_multi(*[[torch.from_numpy(p[i]) for p in parts] for i in range(3)], 128)
    want = RSE.select_topk_device_multi(*[[p[i] for p in parts] for i in range(3)], 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- stage (K4)

_ALL_CONDS = (
    RF.Cond("span", "span.kind", "eq"), RF.Cond("res", "res.service_id", "eq"),
    RF.Cond("sattr", "str", "eq"), RF.Cond("sattr", "float", "lt", is_float=True),
    RF.Cond("rattr", "int", "eq"), RF.Cond("trace", "trace.dur_us", "gt"),
    RF.Cond("res", "res.namespace_id", "eq"),
)


@pytest.mark.parametrize("groups", [None, [1, 2]])
def test_stage_every_column_matches_reference(ref_block, groups):
    rblk, blk, _ = ref_block
    needed = RF.required_columns(_ALL_CONDS) + ["span.parent_idx", "trace.start_ms", "trace@gkey_s"]
    want = RST.stage_block(rblk, needed, groups=groups, cache=False)
    got = ST.stage_block(blk, needed, groups=groups, cache=False, device="cpu")
    for f in ("n_spans", "n_traces", "n_res", "n_spans_b", "n_traces_b", "n_res_b", "span_base"):
        assert getattr(got, f) == getattr(want, f), f
    assert sorted(got.cols) == sorted(want.cols)
    assert {"span@res.service_id", "sattr.off", "rattr.off", "trace@gkey_s"} <= set(got.cols)
    for name, arr in want.cols.items():
        np.testing.assert_array_equal(got.cols[name].numpy(), np.asarray(arr), err_msg=name)


def test_res_to_span_matches_reference():
    """K4 on one column, and as one row of the many-column call (the form
    staging and the mesh fold take)."""
    rng = np.random.default_rng(8)
    res = rng.integers(-5, 1000, 1024).astype(np.int32)
    idx = rng.integers(-3, 1100, 4096).astype(np.int32)  # past the end: clamped
    want = np.asarray(RST._res_to_span(res, idx))
    got = ST.res_to_span(torch.from_numpy(res), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    many = ST.res_to_span_many([torch.from_numpy(res)], torch.from_numpy(idx))
    assert many.shape == (1, 4096)
    np.testing.assert_array_equal(many[0].numpy(), want)


def test_staged_from_numpy_round_trip():
    cols = TC.make_cols(seed=2)
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    assert (staged.n_spans_b, staged.n_traces_b, staged.n_res_b) == (
        TC.N_SPANS_B, TC.N_TRACES_B, bucket(TC.N_RES))
    for name, arr in cols.items():
        assert staged.cols[name].dtype == getattr(torch, arr.dtype.name)
        np.testing.assert_array_equal(staged.cols[name].numpy(), arr)


def test_stage_cache_budget_evicts_coldest(ref_block, monkeypatch):
    _, blk, _ = ref_block
    needed = F.required_columns((F.Cond("span", "span.kind", "eq"),))
    try:
        a = ST.stage_block(blk, needed, device="cpu")
        assert ST.stage_block(blk, needed, device="cpu") is a  # cached
        monkeypatch.setattr(ST, "_GLOBAL_CACHE_BUDGET", a.nbytes)
        b = ST.stage_block(blk, needed + ["span.dur_us"], device="cpu")
        assert ST.stage_block(blk, needed + ["span.dur_us"], device="cpu") is b
        assert ST.stage_block(blk, needed, device="cpu") is not a  # evicted, restaged
    finally:
        blk._staged_cache.clear()


def test_schema_codes_match_reference():
    ids = [b"\x00" * 16, b"\x80" + b"\x01" * 15, b"\xff" * 16, bytes(range(16))]
    for t in ids:
        assert S.trace_id_to_codes(t) == RS.trace_id_to_codes(t)
        assert S.codes_to_trace_id(S.trace_id_to_codes(t)) == t
