"""The live head's kernels (B7a-B7d) and its stager against the JAX
package's: each plain version equals the jitted program of
tempo_tpu/ops/livestage.py bit for bit on the same seeded numpy inputs
(edge cases included), the numpy twins equal the reference's, a
LiveStager fed the same segments in both packages stages the same host
tails and dictionary, and a delta refresh leaves an older snapshot's
device columns as they were."""

import random

import numpy as np
import pytest
import torch

from tempo_tpu.ops import livestage as R
from tempo_tpu.util.testdata import make_trace as r_make_trace
from tempo_tpu.wire.segment import segment_for_write as r_segment_for_write
from tempo_tpu_torch.ops import livestage as L
from tempo_tpu_torch.ops.device import PAD_I32
from tempo_tpu_torch.util.testdata import make_trace, make_trace_id
from tempo_tpu_torch.wire.segment import segment_for_write


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _filter_inputs(seed, slot_b=1024, kv_b=4096, name_b=2048, n_slots=700, n_kv=3000,
                   n_name=1500, n_codes=40):
    rng = np.random.default_rng(seed)
    cols = {
        "start_s": rng.integers(0, 1000, slot_b).astype(np.int32),
        "end_s": rng.integers(0, 1000, slot_b).astype(np.int32),
        "dur_ms": rng.integers(0, 5000, slot_b).astype(np.int32),
        "alive": rng.integers(0, 2, slot_b).astype(np.int32) | (rng.random(slot_b) < 0.8),
    }
    cols["alive"] = cols["alive"].astype(np.int32)
    for kind, nb, n in (("kv", kv_b, n_kv), ("name", name_b, n_name)):
        owner = np.zeros(nb, np.int32)
        code = np.full(nb, PAD_I32, np.int32)
        # owners at slot_b - 1 and past it (clipped), codes in a small range
        owner[:n] = rng.integers(0, slot_b + 3, n)
        owner[:8] = slot_b - 1
        code[:n] = rng.integers(0, n_codes, n)
        if n >= n_codes:  # slot 42 carries every code, so long queries can match
            owner[n - n_codes:n], code[n - n_codes:n] = 42, np.arange(n_codes)
        cols[f"{kind}_owner"], cols[f"{kind}_code"] = owner, code
    cols["alive"][42], cols["start_s"][42], cols["end_s"][42], cols["dur_ms"][42] = 1, 10, 500, 3000
    return cols


def _ref_filter(cols, tags, names, t0, t1, dmin, n_slots):
    slot_b, kv_b, name_b = (cols["alive"].shape[0], cols["kv_owner"].shape[0],
                            cols["name_owner"].shape[0])
    key = (len(tags), len(names), t0 > 0, t1 > 0, dmin > 0, slot_b, kv_b, name_b)
    fn = R._compiled_live_filter(*key)
    out = fn(cols["start_s"], cols["end_s"], cols["dur_ms"], cols["alive"], cols["kv_owner"],
             cols["kv_code"], cols["name_owner"], cols["name_code"],
             np.asarray(tags or [0], np.int32), np.asarray(names or [0], np.int32),
             np.int32(R._clip_i32(t0)), np.int32(R._clip_i32(t1)), np.int32(R._clip_i32(dmin)),
             np.int32(n_slots))
    return np.asarray(out)


def _port_filter(cols, tags, names, t0, t1, dmin, n_slots):
    tc = {k: _t(v) for k, v in cols.items()}
    q = torch.tensor(list(tags) + list(names), dtype=torch.int32)
    out = L.live_filter((tc["start_s"], tc["end_s"], tc["dur_ms"], tc["alive"]),
                        (tc["kv_owner"], tc["kv_code"]), (tc["name_owner"], tc["name_code"]),
                        q, len(tags), L._clip_i32(t0) if t0 > 0 else None,
                        L._clip_i32(t1) if t1 > 0 else None,
                        L._clip_i32(dmin) if dmin > 0 else None, n_slots)
    assert out.dtype == torch.bool
    return out.numpy()


FILTER_CASES = {
    "no_codes_no_filters": ([], [], 0, 0, 0),
    "one_tag": ([3], [], 0, 0, 0),
    "tags_and_names": ([3, 7], [1, 2], 100, 900, 50),
    "names_only": ([], [5], 0, 500, 0),
    "window_only": ([], [], 300, 700, 0),
    "min_duration": ([], [], 0, 0, 2500),
    "absent_code": ([39, 10**6], [], 0, 0, 0),
    "thresholds_at_clip": ([1], [2], 2**40, 2**40, 2**40),
    "negative_thresholds": ([1], [], -5, -(2**40), -1),
    "33_codes": (list(range(20)), list(range(13)), 0, 0, 0),
    "70_codes": (list(range(35)), list(range(35)), 1, 999, 1),
    "repeated_code": ([4, 4], [4], 0, 0, 0),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_live_filter_plain_matches_jax(case):
    tags, names, t0, t1, dmin = FILTER_CASES[case]
    for seed, n_slots in ((1, 700), (2, 1024), (3, 0)):
        cols = _filter_inputs(seed, n_slots=n_slots)
        want = _ref_filter(cols, tags, names, t0, t1, dmin, n_slots)
        got = _port_filter(cols, tags, names, t0, t1, dmin, n_slots)
        np.testing.assert_array_equal(got, want)
        if seed == 1 and case in ("one_tag", "tags_and_names", "33_codes", "70_codes"):
            assert got.any()  # not vacuous


def test_live_filter_pad_rows_never_hit():
    """Pad rows (owner 0, code PAD_I32) give slot 0 nothing: a slot 0
    with no real row of the code stays out of the mask."""
    cols = _filter_inputs(4, n_kv=0, n_name=0)
    cols["alive"][:] = 1
    for tags, names in (([0], []), ([], [0]), ([5, 6], [7])):
        want = _ref_filter(cols, tags, names, 0, 0, 0, 700)
        got = _port_filter(cols, tags, names, 0, 0, 0, 700)
        np.testing.assert_array_equal(got, want)
        assert not got.any()


def _find_inputs(seed, slot_b=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-(2**31), 2**31 - 1, (slot_b, 4)).astype(np.int32)
    ids[10] = ids[500] = ids[900] = ids[3]  # repeats: the first alive wins
    alive = (rng.random(slot_b) < 0.7).astype(np.int32)
    alive[3] = 0
    return ids, alive


@pytest.mark.parametrize("n_slots", [0, 5, 11, 700, 1024])
def test_live_find_plain_matches_jax(n_slots):
    ids, alive = _find_inputs(5)
    fn = R._compiled_find(ids.shape[0])
    for row in (3, 10, 600, 1023):
        for q in (ids[row], ids[row] + 1):
            want = int(np.asarray(fn(ids, alive, q, np.int32(n_slots))))
            got = L.live_find(_t(ids), _t(alive), _t(q.astype(np.int32)), n_slots)
            assert got.dtype == torch.int32 and got.shape == (1,)
            assert int(got[0]) == want


APPEND_CASES = [(0, 64), (100, 64), (960, 64), (1000, 64), (-4, 64), (-2000, 64), (2**31 - 1, 64),
                (-(2**31), 64), (5, 1024), (0, 0)]


@pytest.mark.parametrize("start,m", APPEND_CASES)
def test_append_rows_plain_matches_jax(start, m):
    rng = np.random.default_rng(6)
    dst = rng.integers(-99, 99, 1024).astype(np.int32)
    src = rng.integers(1000, 2000, m).astype(np.int32)
    want = np.asarray(R._append_rows_device(dst, src, np.int32(start)))
    got = L.append_rows(_t(dst), _t(src), start)
    np.testing.assert_array_equal(got.numpy(), want)


PATCH_CASES = {
    "sorted": [1, 5, 9],
    "repeated_pad": [4, 7, 4, 4],  # the stager pads by repeating a real index
    "negative": [-1, -1024, 3],
    "out_of_range": [1024, -1025, 2**31 - 1, -(2**31), 8],
    "last": [1023],
}


@pytest.mark.parametrize("case", sorted(PATCH_CASES))
@pytest.mark.parametrize("width", [1, 4])
def test_patch_slots_plain_matches_jax(case, width):
    rng = np.random.default_rng(7)
    shape = (1024,) if width == 1 else (1024, 4)
    dst = rng.integers(-99, 99, shape).astype(np.int32)
    idx = np.asarray(PATCH_CASES[case], np.int32)
    # repeated indices carry equal values, as the stager's padding does
    first = {}
    rows = [first.setdefault(int(i) % 1024, rng.integers(1000, 2000, shape[1:]))
            for i in idx]
    vals = np.asarray(rows, np.int32).reshape((len(idx),) + shape[1:])
    want = np.asarray(R._patch_slots_device(dst, idx, vals))
    got = L.patch_slots(_t(dst), _t(idx), _t(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy(), dst) or case == "out_of_range"


# ------------------------------------------------------------ stager


def _segments(seed, n=60):
    """(tid, segs) with 1-6 spans a segment, some traces in two
    segments; built by each package from one seed."""
    out = []
    for mk, seg_for in ((make_trace, segment_for_write), (r_make_trace, r_segment_for_write)):
        rng = random.Random(seed)
        items = []
        for i in range(n):
            tid = make_trace_id(rng)
            base = 1_700_000_000_000_000_000 + rng.randrange(0, 4) * 60 * 10**9
            segs = []
            for _ in range(1 if i % 4 else 2):
                tr = mk(rng, trace_id=tid, n_spans=rng.randrange(1, 7), base_time_ns=base)
                lo, hi = tr.time_range_nanos()
                segs.append(seg_for(tr, lo // 10**9, hi // 10**9 + 1))
            items.append((tid, segs, base // 10**9, base // 10**9 + 2))
        out.append(items)
    return out


HOST_COLS = ("start_s", "end_s", "dur_ms", "key_s", "alive", "id_codes", "kv_owner", "kv_code",
             "name_owner", "name_code")


def _same_snapshot(a, b):
    for name in HOST_COLS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert (a.n_slots, a.n_kv, a.n_name, a.slot_b, a.kv_b, a.name_b) == \
        (b.n_slots, b.n_kv, b.n_name, b.slot_b, b.kv_b, b.name_b)
    assert a.slot_tid == b.slot_tid


def test_stager_matches_reference_over_refreshes():
    """Identical segment lists, refreshed in the same steps (pushes, late
    segments, retirements, a compaction) in both packages: equal host
    tails, dictionaries and device columns; then eval/find twins and the
    device route agree with the reference's."""
    ours, theirs = _segments(8)
    st = L.LiveStager(device="cpu")
    rst = R.LiveStager()
    steps = [(0, 20, ()), (0, 40, ()), (10, 60, range(0, 10)), (30, 60, range(10, 30))]
    for lo, hi, _gone in steps:
        items = {tid: (segs, "live", s, e) for tid, segs, s, e in ours[lo:hi]}
        ritems = {tid: (segs, "live", s, e) for tid, segs, s, e in theirs[lo:hi]}
        snap, rsnap = st.refresh(items), rst.refresh(ritems)
        _same_snapshot(snap, rsnap)
        assert st.dict._strings == rst.dict._strings
        for name, t in snap.dev.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(rsnap.dev[name]), err_msg=name)
        # eval: the port's device route (plain), its twin and the reference's
        codes = [st.dict.lookup(s) for s in ("service.name\x00db", "component\x00sql")]
        names = [st.dict.lookup("db.query")]
        for tags, nms, t0, t1, dmin in (([], [], 0, 0, 0), (codes[:1], [], 0, 0, 0),
                                        (codes, names, 1_700_000_030, 1_700_000_200, 10),
                                        ([], names, 0, 0, 1500)):
            want = R.eval_live_host(rsnap, tags, nms, t0, t1, dmin)
            host = L.eval_live_host(snap, tags, nms, t0, t1, dmin)
            dev = L.eval_live_device(snap, tags, nms, t0, t1, dmin).numpy()[: snap.n_slots]
            np.testing.assert_array_equal(host, want)
            np.testing.assert_array_equal(dev, want)
        for tid, *_ in ours[:12] + [(b"\x07" * 16,)]:
            want = R.find_slot_host(rsnap, tid)
            assert L.find_slot_host(snap, tid) == L.find_slot_device(snap, tid) == want
    assert st.stats["delta_uploads"] > 0 and st.stats["full_uploads"] > 0


def test_snapshot_from_numpy_carries_the_reference_state():
    _, theirs = _segments(9, n=30)
    rsnap = R.LiveStager().refresh({tid: (segs, "live", s, e) for tid, segs, s, e in theirs})
    snap = L.snapshot_from_numpy(rsnap, "cpu")
    _same_snapshot(snap, rsnap)
    for name, t in snap.dev.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(rsnap.dev[name]), err_msg=name)


def test_delta_refresh_leaves_older_snapshot_unchanged():
    """The immutability contract: a snapshot's device columns stay as
    they were after later delta refreshes (B7c/B7d write new tensors)
    and after a retirement (a slot patch)."""
    ours, _ = _segments(10)
    st = L.LiveStager(device="cpu")
    first = st.refresh({tid: (segs, "live", s, e) for tid, segs, s, e in ours[:30]})
    before = {k: v.clone() for k, v in first.dev.items()}
    st.refresh({tid: (segs, "live", s, e) for tid, segs, s, e in ours[:40]})
    assert st.last_upload["full"] is False
    st.refresh({tid: (segs, "cut", s, e) for tid, segs, s, e in ours[5:40]})
    assert st.last_upload["full"] is False
    for k, v in first.dev.items():
        assert torch.equal(v, before[k]), k


def test_stager_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.LiveStager()
    snap = L.LiveStager(device="cpu").refresh({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.snapshot_from_numpy(snap, None)
