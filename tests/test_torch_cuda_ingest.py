"""Kernel-vs-plain tests of the live head's CUDA kernels (B7a-B7d) on
the card, and an ingester Instance on the card against one on the CPU
over the same pushes.

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is an integer or a bool, so every comparison is exact."""

import random

import numpy as np
import pytest
import torch
from torch_tile_cases import LIVE_CASES, live_case

from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db.metrics_exec import align_params
from tempo_tpu_torch.db.wal import WAL
from tempo_tpu_torch.ops.device import PAD_I32
from tempo_tpu_torch.services.ingester import Ingester
from tempo_tpu_torch.services.overrides import Overrides
from tempo_tpu_torch.util.testdata import make_trace, make_trace_id
from tempo_tpu_torch.wire.segment import segment_for_write

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _cols(rng, slot_b, kv_b, name_b, n_codes=40):
    cols = [rng.integers(0, 1000, slot_b), rng.integers(0, 1000, slot_b),
            rng.integers(0, 5000, slot_b), rng.random(slot_b) < 0.8]
    slots = tuple(torch.from_numpy(c.astype(np.int32)) for c in cols)
    rows = []
    for nb in (kv_b, name_b):
        n = nb * 3 // 4
        owner = np.zeros(nb, np.int32)
        code = np.full(nb, PAD_I32, np.int32)
        owner[:n] = rng.integers(0, slot_b + 3, n)
        code[:n] = rng.integers(0, n_codes, n)
        owner[n - n_codes:n], code[n - n_codes:n] = 42, np.arange(n_codes)
        rows.append((torch.from_numpy(owner), torch.from_numpy(code)))
    return slots, rows[0], rows[1]


@pytest.mark.parametrize("tags,names,t0,t1,dmin,n_slots", [
    ([], [], None, None, None, 700),
    ([3], [], None, None, None, 1024),
    ([3, 7], [1, 2], 100, 900, 50, 700),
    (list(range(20)), list(range(13)), None, None, None, 1024),  # 33 codes: two chunks
    (list(range(35)), list(range(35)), 1, 999, 1, 1024),  # 70 codes: three chunks
    ([0], [5], 2**31 - 1, -(2**31) + 1, 2**31 - 1, 0),
    ([PAD_I32, 3], [PAD_I32], None, None, None, 1024),  # the padding rows' code
])
def test_live_filter_kernel(cuda, tags, names, t0, t1, dmin, n_slots):
    """B7a equals _live_filter_plain reading the whole padded buckets,
    with the codes as ints and only the real rows (3/4 of each bucket)
    read; one __global__ a chunk of 32 codes."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    rng = np.random.default_rng(len(tags) * 31 + len(names))
    for slot_b, kv_b, name_b in ((1024, 4096, 2048), (1 << 14, 1 << 21, 1 << 19)):
        slots, kv, nm = _cols(rng, slot_b, kv_b, name_b)
        q = torch.tensor(tags + names, dtype=torch.int32)
        want = L._live_filter_plain(slots, kv, nm, q, len(tags), t0, t1, dmin, n_slots)
        args = (tuple(t.to(cuda) for t in slots), tuple(t.to(cuda) for t in kv),
                tuple(t.to(cuda) for t in nm))
        chunks = max(1, -(-len(tags + names) // kernels.LIVE_CHUNK))
        kernels.reset_counts()
        got = kernels.live_filter(*args, tags + names, len(tags), t0, t1, dmin, n_slots,
                                  kv_b * 3 // 4, name_b * 3 // 4)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["live_filter"] == 1
        assert kernels.grid_launches()["live_filter"] == chunks
        assert torch.equal(got.cpu(), want)
        assert torch.equal(L.live_filter(*args, q, len(tags), t0, t1, dmin, n_slots).cpu(), want)
        if tags == [3, 7] and n_slots:
            assert bool(want.any())
    with pytest.raises(ValueError):
        L.live_filter(*args, q.to(cuda), len(tags), t0, t1, dmin, n_slots)


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_live_filter_one_launch_cases(cuda, case):
    """The one-launch route's cases (tests/torch_tile_cases.py: PAD_I32
    codes over padded and full buckets, owners below 0 and past slot_b,
    duplicates, 0-70 codes, the int32 extremes) at every n_slots against
    the plain version, every call on one stream after the last (the
    epoch-tagged hit words carry nothing from one call to the next)."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    tags, names, t0, t1, dmin = LIVE_CASES[case]
    for slot_b, kv_b, name_b, n_kv, n_name in ((1024, 4096, 2048, 3000, 1500),
                                               (1024, 4096, 2048, 4096, 2048),
                                               (1 << 14, 1 << 21, 1 << 19, 1_146_880, 409_600)):
        cols = live_case(len(case), slot_b, kv_b, name_b, n_kv, n_name)
        tc = {k: torch.from_numpy(v) for k, v in cols.items()}
        plain_args = ((tc["start_s"], tc["end_s"], tc["dur_ms"], tc["alive"]),
                      (tc["kv_owner"], tc["kv_code"]), (tc["name_owner"], tc["name_code"]))
        card_args = tuple(tuple(t.to(cuda) for t in a) for a in plain_args)
        for n_slots in (0, 5, slot_b, slot_b + 7):
            want = L._live_filter_plain(*plain_args, torch.tensor(tags + names, dtype=torch.int32),
                                        len(tags), t0, t1, dmin, n_slots)
            got = kernels.live_filter(*card_args, tags + names, len(tags), t0, t1, dmin,
                                      n_slots, n_kv, n_name)
            assert torch.equal(got.cpu(), want), (slot_b, n_kv, n_slots)
    torch.cuda.synchronize()


def test_eval_live_device_one_launch_no_upload(cuda, monkeypatch):
    """A live search with at most 32 codes is one wrapper call, one
    __global__, no memset and no host-to-device copy: nothing moves a
    tensor to the card (every such call is recorded) and the profiler
    sees the kernel and no memset or memcpy."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    cols = live_case(5, 1 << 14, 1 << 21, 1 << 19, 1_146_880, 409_600)
    dev = {k: torch.from_numpy(v).to(cuda) for k, v in cols.items()}
    snap = types.SimpleNamespace(dev=dev, n_slots=1 << 14, n_kv=1_146_880, n_name=409_600)
    want = L._live_filter_plain(
        (dev["start_s"], dev["end_s"], dev["dur_ms"], dev["alive"]),
        (dev["kv_owner"], dev["kv_code"]), (dev["name_owner"], dev["name_code"]),
        torch.tensor([3, 7, 5], dtype=torch.int32, device=cuda), 2, 1, 900, 5, 1 << 14)
    moved = []
    to = torch.Tensor.to

    def spy_to(self, *a, **k):
        out = to(self, *a, **k)
        if self.device.type == "cpu" and out.device.type == "cuda":
            moved.append(tuple(self.shape))
        return out

    monkeypatch.setattr(torch.Tensor, "to", spy_to)
    L.eval_live_device(snap, [3, 7], [5], 1, 900, 5)  # warm
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = L.eval_live_device(snap, [3, 7], [5], 1, 900, 5)
        torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(want[42])
    assert not moved, moved
    assert kernels.LAUNCHES["live_filter"] == 1 and kernels.grid_launches()["live_filter"] == 1
    keys = [e.key for e in prof.key_averages()]
    assert any(k.startswith("live_filter_") for k in keys), keys
    assert not any("memset" in k.lower() or "memcpy" in k.lower() for k in keys), keys


@pytest.mark.parametrize("slot_b", [1024, 1 << 14, 1 << 20])
def test_live_find_kernel(cuda, slot_b):
    """B7b equals _live_find_plain at every n_slots (0, inside, slot_b,
    past it, negative), with repeated ids (the first alive wins) and
    dead slots, one __global__ a call; the query goes in as 4 ints or a
    CPU tensor, never uploaded. Every cluster size the plan takes
    agrees, each reached by its n_slots."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    rng = np.random.default_rng(slot_b)
    ids = rng.integers(-(2**31), 2**31 - 1, (slot_b, 4)).astype(np.int32)
    ids[10] = ids[500] = ids[900] = ids[slot_b - 2] = ids[3]
    alive = (rng.random(slot_b) < 0.7).astype(np.int32)
    alive[3] = 0
    ids_t, alive_t = torch.from_numpy(ids), torch.from_numpy(alive)
    ids_c, alive_c = ids_t.to(cuda), alive_t.to(cuda)
    n_calls = 0
    kernels.reset_counts()
    for n_slots in (0, 5, 11, 700, slot_b // 2 + 1, slot_b, slot_b + 5, -1):
        for row in (3, 10, 600, slot_b // 2, slot_b - 1):
            for q in (ids[row], ids[row] + 1):
                qt = torch.from_numpy(q.astype(np.int32))
                want = L._live_find_plain(ids_t, alive_t, qt, n_slots)
                got = L.live_find(ids_c, alive_c, [int(c) for c in q.astype(np.int32)], n_slots)
                assert torch.equal(got.cpu(), want), (n_slots, row)
                assert torch.equal(L.live_find(ids_c, alive_c, qt, n_slots).cpu(), want)
                n_calls += 2
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["live_find"] == n_calls
    assert kernels.grid_launches()["live_find"] == n_calls
    with pytest.raises(ValueError):
        L.live_find(ids_c, alive_c, torch.from_numpy(ids[3]).to(cuda), slot_b)
    # every cluster size the plan takes (C = ceil(n / 2,048) CTAs, at
    # most 8): each C at its fewest and most slots, queried for the last
    # slot inside n, one in its middle, the first past it and the last
    # alive one inside n, which must be found
    for c in range(1, 9):
        for n_slots in (2048 * (c - 1) + 1, 2048 * c):
            if n_slots > slot_b:
                continue
            last = np.flatnonzero(alive[:n_slots])[-1:].tolist()
            for row in [n_slots - 1, n_slots // 2, min(n_slots, slot_b - 1)] + last:
                q = [int(x) for x in ids[row]]
                want = L._live_find_plain(ids_t, alive_t, torch.tensor(q, dtype=torch.int32),
                                          n_slots)
                got = kernels.live_find(ids_c, alive_c, q, n_slots)
                assert torch.equal(got.cpu(), want), (c, n_slots, row)
            assert not last or int(want) >= 0, (c, n_slots)


@pytest.mark.parametrize("n", [1024, 1 << 21])
def test_live_append_kernel(cuda, n):
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    rng = np.random.default_rng(n)
    dst = torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32))
    kernels.reset_counts()
    for start, m in ((0, 64), (100, 64), (n - 10, 64), (-4, 64), (-(2**31), 64),
                     (2**31 - 1, 64), (5, 1024), (0, 0)):
        src = torch.from_numpy(rng.integers(1000, 2000, m).astype(np.int32))
        dst_c = dst.to(cuda)
        got = L.append_rows(dst_c, src.to(cuda), start)
        assert torch.equal(got.cpu(), L._append_plain(dst, src, start))
        assert torch.equal(dst_c.cpu(), dst)  # out of place
    assert kernels.LAUNCHES["live_append"] == kernels.grid_launches()["live_append"] == 8


@pytest.mark.parametrize("start_mod", [0, 1, 2, 3])
def test_live_append_many_kernel(cuda, start_mod):
    """B7c's one launch over a refresh's columns against its plain
    version: both bucket sizes in one call, windows at every start mod 4
    and every length mod 4 (cutting a quad at either edge), a ragged
    column, segments placed off append_plan and dsts off a 16-byte
    boundary (read 4 B at a time), the refresh's shape (2 x 2^20 kv and 2 x 2^19 name rows); one wrapper call
    and one __global__ a call, the dsts unchanged."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    rng = np.random.default_rng(start_mod)
    calls = [[(1 << 12, 400 + start_mod, 64 + m), (1 << 12, 400 + start_mod, 64 + m),
              (1 << 10, 8 + start_mod, 13 + m), (1 << 10, 1021 - m, 3 + m)] for m in range(4)]
    calls += [[(4099, 4000 + start_mod, 99), (1030, start_mod, 5)],
              [(1 << 20, 710_897 + start_mod, 262_144)] * 2
              + [(1 << 19, 317_120 + start_mod, 65_536)] * 2]
    for case in calls:
        dsts = [torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32)) for n, _, _ in case]
        deltas = [rng.integers(1000, 2000, m).astype(np.int32) for _, _, m in case]
        starts = [s for _, s, _ in case]
        src, segs = L.upload_deltas([(d, d.shape[0], 0) for d in deltas], [n for n, _, _ in case],
                                    starts, cuda)
        want = L._append_many_plain(dsts, src.cpu(), segs, starts)
        dsts_c = [d.to(cuda) for d in dsts]
        for off in (0, 1):  # off 1: every segment one row later, off the plan,
            if off:         # and every dst a view one row into its storage
                src = torch.cat([src[:1], src])
                segs = [(o + 1, m) for o, m in segs]
                dsts_c = [torch.cat([d[:1], d]).to(cuda)[1:] for d in dsts]
            kernels.reset_counts()
            got = L.append_rows_many(dsts_c, src, segs, starts)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["live_append"] == kernels.grid_launches()["live_append"] == 1
            for g, w, d, dc in zip(got, want, dsts, dsts_c):
                assert g.data_ptr() % 16 == 0
                assert torch.equal(g.cpu(), w), (case, off)
                assert torch.equal(dc.cpu(), d)  # out of place


def test_live_append_many_refuses(cuda):
    """More columns than a launch takes, a segment past src, a CPU dst
    and a 2-D column raise KernelError; nothing launches."""
    from tempo_tpu_torch import kernels

    d = torch.zeros(64, dtype=torch.int32, device=cuda)
    x = torch.ones(8, dtype=torch.int32, device=cuda)
    kernels.reset_counts()
    for dsts, segs in (([d] * 5, [(0, 1)] * 5), ([d], [(4, 8)]), ([d.cpu()], [(0, 1)]),
                       ([d.view(8, 8)], [(0, 1)]), ([d[:4]], [(0, 8)])):
        with pytest.raises(kernels.KernelError):
            kernels.live_append_many(dsts, x, segs, [0] * len(dsts))
    assert kernels.LAUNCHES["live_append"] == 0


@pytest.mark.parametrize("width", [1, 4])
def test_live_patch_kernel(cuda, width):
    """One __global__ a call (m = 0 too), at column lengths that are not
    a multiple of a CTA's range, the grid's cap passed (600,001 rows),
    and on a view one row into its storage (at width 1, data that is not
    16-byte aligned)."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    rng = np.random.default_rng(width)
    for n, offset in ((1024, 0), (1 << 14, 0), (16397, 0), (600_001, 0), (5003, 1)):
        shape = (n,) if width == 1 else (n, 4)
        dst = torch.from_numpy(rng.integers(-99, 99, shape).astype(np.int32))
        kernels.reset_counts()
        for idx in ([1, 5, 9], [4, 7, 4, 4], [-1, -n, 3], [n, -n - 1, 2**31 - 1, -(2**31), 8],
                    [], list(rng.permutation(n)[:300])):
            first = {}
            rows = [first.setdefault(int(i) % n, rng.integers(1000, 2000, shape[1:]))
                    for i in idx]
            vals = torch.from_numpy(np.asarray(rows, np.int32).reshape((len(idx),) + shape[1:]))
            it = torch.tensor(idx, dtype=torch.int32)
            # offset 1: dst a view one row into its storage
            dst_c = torch.cat([dst[:offset], dst]).to(cuda)[offset:]
            got = L.patch_slots(dst_c, it.to(cuda), vals.to(cuda))
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), L._patch_plain(dst, it, vals)), (n, idx[:5])
            assert torch.equal(dst_c.cpu(), dst)  # out of place
        assert kernels.LAUNCHES["live_patch"] == 6
        assert kernels.grid_launches()["live_patch"] == 6


def _dump(resp):
    return [(t.trace_id, t.start_time_unix_nano, t.root_service_name,
             t.root_trace_name, t.duration_ms) for t in resp.traces]


def test_instance_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """The same pushes, cuts, late segments and a flush into an Instance
    on the card and one on the CPU: searches, finds and live metrics are
    equal, and the card's went through B7a-B7d."""
    from tempo_tpu_torch import kernels

    ings = []
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        db = TempoDB(TempoDBConfig(), backend=MemBackend(), device=dev)
        ings.append(Ingester(WAL(str(tmp_path / name)), db, Overrides(), device=dev))
    insts = [ing.instance("t") for ing in ings]
    rng = random.Random(5)
    tids = []
    kernels.reset_counts()
    for step in range(200):
        if step % 50 == 49:
            for inst in insts:
                inst.cut_complete_traces(force=True)
            if step == 99:
                for inst in insts:
                    inst.cut_block_if_ready(force=True)
        tid = rng.choice(tids) if tids and rng.random() < 0.2 else make_trace_id(rng)
        tids.append(tid)
        tr = make_trace(rng, trace_id=tid, n_spans=rng.randrange(1, 6),
                        base_time_ns=1_700_000_000_000_000_000 + rng.randrange(0, 300) * 10**9)
        lo, hi = tr.time_range_nanos()
        batch = [(tid, lo // 10**9, hi // 10**9 + 1, segment_for_write(tr, lo // 10**9,
                                                                       hi // 10**9 + 1))]
        for inst in insts:
            inst.push_segments(batch)
        if step % 20 == 19:
            reqs = [SearchRequest(limit=20), SearchRequest(tags={"service.name": "db"}, limit=50),
                    SearchRequest(min_duration_ms=900, limit=10),
                    SearchRequest(query='{ span.http.status_code = 500 }', limit=20)]
            for req in reqs:
                a, b = (_dump(inst.search_live(req)) for inst in insts)
                assert a == b == _dump(insts[1].search_live_index(req))
    monkeypatch.setenv("TEMPO_LIVE_FIND_DEVICE", "1")
    for tid in tids[::7] + [b"\x02" * 16]:
        a, b = (inst.find_trace_by_id(tid) for inst in insts)
        assert (a is None) == (b is None) and (a is None or a.span_count() == b.span_count())
    mq = '{ true } | rate() by (resource.service.name)'
    a, b = (inst.metrics_query_range(align_params(mq, 1_700_000_000, 1_700_000_400, 60))
            for inst in insts)
    assert set(a.series) == set(b.series) and a.series
    for k in a.series:
        assert np.array_equal(a.series[k]["count"], b.series[k]["count"])
    counts = dict(kernels.LAUNCHES)
    for name in ("live_filter", "live_find", "live_append", "live_patch", "select"):
        assert counts[name] > 0, counts
    assert counts["remap"] > 0  # the flush cut on the card
