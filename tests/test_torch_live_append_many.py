"""B7c's many-column append (ops/livestage.append_rows_many, one launch a
delta refresh on a card) against the JAX package's `_append_rows_device`
(tempo_tpu/ops/livestage.py, jax.lax.dynamic_update_slice, run on the
CPU): its plain version column by column, a numpy model of the kernel's
quad plan (csrc/livestage.cu: segment placement by kernels.append_plan,
16-byte quads, edge quads row by row), and a LiveStager whose delta
refreshes append every row column in one call, against the reference's
stager. Inputs come from numpy with a seed; every output is an int32, so
every comparison is exact. The kernel itself is held against the plain
version on the card (tests/test_torch_cuda_ingest.py)."""

import random

import numpy as np
import pytest
import torch

from tempo_tpu.ops import livestage as R
from tempo_tpu.util.testdata import make_trace as r_make_trace
from tempo_tpu.wire.segment import segment_for_write as r_segment_for_write
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import livestage as L
from tempo_tpu_torch.util.testdata import make_trace, make_trace_id
from tempo_tpu_torch.wire.segment import segment_for_write

INT_MIN, INT_MAX = -(2**31), 2**31 - 1

# columns of one call: (column length, start, rows appended)
CASES = {
    "start_0": [(4096, 0, 64)],
    "start_mid": [(4096, 1001, 300)],
    "start_n_minus_m": [(4096, 4096 - 300, 300)],
    "start_negative": [(4096, -7, 5)],
    "start_int_min": [(4096, INT_MIN, 33)],
    "start_int_max": [(4096, INT_MAX, 33)],
    "m_0": [(1024, 5, 0)],
    "m_1": [(1024, 513, 1)],
    "m_n": [(1024, 7, 1024)],
    "four_two_buckets": [(8192, 3001, 1024), (8192, 3001, 1024), (2048, 999, 256),
                         (2048, 999, 256)],
    "three_columns": [(8192, -100, 64), (2048, 2, 2048), (1024, 1023, 1)],
    "two_ragged_columns": [(1030, 1, 5), (4099, 4000, 99)],
}


def _call(case, seed=0):
    """Seeded dsts and deltas of a case, and the src and segments one
    upload makes of them (kernels.append_plan's placement)."""
    rng = np.random.default_rng(seed + len(case))
    dsts = [rng.integers(-99, 99, n).astype(np.int32) for n, _, _ in case]
    deltas = [rng.integers(1000, 2000, m).astype(np.int32) for _, _, m in case]
    starts = [s for _, s, _ in case]
    src, segs = L.upload_deltas([(d, d.shape[0], 0) for d in deltas], [n for n, _, _ in case],
                                starts, torch.device("cpu"))
    return dsts, deltas, starts, src, segs


@pytest.mark.parametrize("name", sorted(CASES))
def test_many_plain_matches_reference(name):
    dsts, deltas, starts, src, segs = _call(CASES[name])
    got = L.append_rows_many([torch.from_numpy(d) for d in dsts], src, segs, starts)
    assert len(got) == len(dsts)
    for g, d, x, st in zip(got, dsts, deltas, starts):
        want = np.asarray(R._append_rows_device(d, x, np.int32(st)))
        np.testing.assert_array_equal(g.numpy(), want)
    for d, (n, _, _) in zip(dsts, CASES[name]):  # out of place
        assert d.shape == (n,)


def _kernel_model(dsts, src, segs, starts):
    """csrc/livestage.cu's live_append_kernel in numpy: the outputs as
    views of one buffer at 16-byte boundaries, the grid's quads over all
    columns; a quad wholly inside a window takes src's 4 rows, one wholly
    outside dst's, others (a window edge, the ragged end) row by row.
    Returns the outputs and, per column, the quads it took whole from src
    (their src offsets) and the quads it took row by row."""
    geom, at = [], 0
    for d, (o, m), st in zip(dsts, segs, starts):
        n = d.shape[0]
        geom.append((n, kernels.append_start(st, n, m), m, o, at))
        at += -(-n // 4) * 4
    buf = np.full(at, 7_777_777, np.int32)
    src_quads, edge_quads = [[] for _ in geom], [0] * len(geom)
    for c, (n, s, m, o, base) in enumerate(geom):
        e = s + m
        for q in range(-(-n // 4)):
            i = 4 * q
            if i + 4 <= n and s <= i and i + 4 <= e:
                buf[base + i:base + i + 4] = src[o + i - s:o + i - s + 4]
                src_quads[c].append(o + i - s)
            elif i + 4 <= n and (i + 4 <= s or i >= e):
                buf[base + i:base + i + 4] = dsts[c][i:i + 4]
            else:
                edge_quads[c] += 1
                for r in range(i, min(i + 4, n)):
                    buf[base + r] = src[o + r - s] if s <= r < e else dsts[c][r]
    return [buf[g[4]:g[4] + g[0]] for g in geom], src_quads, edge_quads


@pytest.mark.parametrize("name", ["start_mid", "start_negative", "m_n", "four_two_buckets",
                                  "three_columns", "two_ragged_columns"])
def test_quad_plan_model_matches_plain(name):
    dsts, _, starts, src, segs = _call(CASES[name], seed=1)
    want = L._append_many_plain([torch.from_numpy(d) for d in dsts], src, segs, starts)
    got, src_quads, edge_quads = _kernel_model(dsts, src.numpy(), segs, starts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    for (n, _, m), offs, edges in zip(CASES[name], src_quads, edge_quads):
        # append_plan's placement: every src quad a 16-byte aligned load
        assert all(o % 4 == 0 for o in offs)
        # a window's two edges and the ragged end at most
        assert edges <= 2 + (n % 4 != 0)


@pytest.mark.parametrize("start_mod", [0, 1, 2, 3])
def test_quad_plan_every_start_mod_4(start_mod):
    """Windows at every start mod 4 and every length mod 4, in calls of
    two bucket sizes (a window cutting a quad at either edge)."""
    rng = np.random.default_rng(start_mod)
    for m_mod in range(4):
        case = [(1 << 12, 400 + start_mod, 64 + m_mod), (1 << 10, 8 + start_mod, 13 + m_mod),
                (1 << 12, 2048 + start_mod, 4 + m_mod), (1 << 10, start_mod, 1 + m_mod)]
        dsts = [rng.integers(-99, 99, n).astype(np.int32) for n, _, _ in case]
        deltas = [rng.integers(1000, 2000, m).astype(np.int32) for _, _, m in case]
        starts = [s for _, s, _ in case]
        src, segs = L.upload_deltas([(d, d.shape[0], 0) for d in deltas],
                                    [n for n, _, _ in case], starts, torch.device("cpu"))
        got, src_quads, _ = _kernel_model(dsts, src.numpy(), segs, starts)
        for g, d, x, st in zip(got, dsts, deltas, starts):
            np.testing.assert_array_equal(g, np.asarray(R._append_rows_device(d, x, np.int32(st))))
        assert all(o % 4 == 0 for offs in src_quads for o in offs)


def test_append_plan_places_each_segment_on_its_start_mod_4():
    rng = np.random.default_rng(3)
    for _ in range(200):
        k = int(rng.integers(1, 5))
        ns = rng.integers(1, 5000, k).tolist()
        ms = [int(rng.integers(0, n + 1)) for n in ns]
        starts = [int(rng.integers(-6000, 6000)) for _ in ns]
        offs, total = kernels.append_plan(ns, ms, starts)
        at = 0
        for n, m, st, o in zip(ns, ms, starts, offs):
            assert at <= o < at + 4 and (o - kernels.append_start(st, n, m)) % 4 == 0
            at = o + m
        assert total == at


def test_upload_deltas_pads_each_segment_with_its_fill():
    rows = [np.arange(5, dtype=np.int32), np.arange(3, dtype=np.int32) + 10]
    src, segs = L.upload_deltas([(rows[0], 8, 0), (rows[1], 4, -(2**31))], [64, 32], [2, 5],
                                torch.device("cpu"))
    (o0, m0), (o1, m1) = segs
    assert (m0, m1) == (8, 4) and (o0 - 2) % 4 == 0 and (o1 - 5) % 4 == 0
    assert src[o0:o0 + 8].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert src[o1:o1 + 4].tolist() == [10, 11, 12, -(2**31)]


def test_kernel_wrappers_refuse_cpu_tensors():
    d, x = torch.zeros(64, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    with pytest.raises(kernels.KernelError, match="CUDA kernel"):
        kernels.live_append_many([d], x, [(0, 4)], [0])
    with pytest.raises(kernels.KernelError, match="CUDA kernel"):
        kernels.live_append(d, x, 0)


# ------------------------------------------------------------ stager
def _pushes(seed, n):
    """(tid, segs, t0, t1) per trace, built by each package from one seed."""
    out = []
    for mk, seg_for in ((make_trace, segment_for_write), (r_make_trace, r_segment_for_write)):
        rng = random.Random(seed)
        items = []
        for _ in range(n):
            tid = make_trace_id(rng)
            base = 1_700_000_000_000_000_000 + rng.randrange(0, 4) * 60 * 10**9
            tr = mk(rng, trace_id=tid, n_spans=rng.randrange(1, 5), base_time_ns=base)
            lo, hi = tr.time_range_nanos()
            items.append((tid, [seg_for(tr, lo // 10**9, hi // 10**9 + 1)], base // 10**9,
                          base // 10**9 + 2))
        out.append(items)
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_stager_appends_every_row_column_in_one_call(seed, monkeypatch):
    """Refreshes that grow the head inside its buckets: each delta
    refresh with new rows makes ONE append_rows_many call over the kv and
    name columns that fit, and the device columns equal the reference
    stager's at every step."""
    ours, theirs = _pushes(seed, 48)
    calls = []
    many = L.append_rows_many

    def spy(dsts, src, segs, starts):
        calls.append(len(dsts))
        return many(dsts, src, segs, starts)

    monkeypatch.setattr(L, "append_rows_many", spy)
    st, rst = L.LiveStager(device="cpu"), R.LiveStager()
    appended = 0
    for hi in (16, 24, 32, 40, 48):
        before = len(calls)
        snap = st.refresh({tid: (segs, "live", s, e) for tid, segs, s, e in ours[:hi]})
        rsnap = rst.refresh({tid: (segs, "live", s, e) for tid, segs, s, e in theirs[:hi]})
        for name, t in snap.dev.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(rsnap.dev[name]), err_msg=name)
        if not st.last_upload["full"]:
            assert len(calls) - before == 1 and calls[-1] == 4, calls
            appended += 1
    assert appended >= 2 and st.stats["append_calls"] == appended
