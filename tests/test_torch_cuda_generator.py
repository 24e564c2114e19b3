"""Kernel-vs-plain tests of the metrics-generator's CUDA kernels (B8a
span_reduce, B8b edge_reduce) on the card, B8b by each route its plan
can take, and the card's generator and distributor tap against the same
on the CPU.

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Counts and histograms are integers and compared exactly. Sums are f32
atomics on the card, added in an order that changes from run to run:
exact on dyadic durations, within rtol 1e-5 of the plain version's f32
sums on random ones."""

import random

import numpy as np
import pytest
import torch

from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import reduce as R
from tempo_tpu_torch.services.generator import LATENCY_BUCKETS, MetricsGenerator
from tempo_tpu_torch.services.overrides import Overrides
from tempo_tpu_torch.util.testdata import make_traces

pytestmark = pytest.mark.cuda

SUM_RTOL = 1e-5
EDGES = np.asarray(LATENCY_BUCKETS, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _durations(rng, n, kind):
    if kind == "dyadic":
        return (rng.integers(0, 64, n) * 0.125).astype(np.float32)
    if kind == "edges":
        special = np.concatenate([EDGES, np.nextafter(EDGES, np.float32(np.inf)),
                                  np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
        return rng.choice(special, n).astype(np.float32)
    return rng.exponential(0.05, n).astype(np.float32)


def _sums_close(got, want, kind):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if kind == "dyadic":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=SUM_RTOL, equal_nan=True)


@pytest.mark.parametrize("kind", ["dyadic", "random", "edges"])
@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 1024, 1024), (8192, 8000, 1 << 18),
                                             (1 << 19, 1 << 19, 1 << 18), (2048, 0, 1024)])
def test_span_reduce_kernel(cuda, n, n_valid, n_ids, kind):
    rng = np.random.default_rng(n + n_ids)
    sid = rng.integers(0, min(n_ids, 180_000), n).astype(np.int32)
    sid[::29] = -1
    sid[7::31] = n_ids
    dur = _durations(rng, n, kind)
    t = [torch.from_numpy(a) for a in (sid, dur, EDGES)]
    want = R._reduce_plain(t[0], t[1], n_valid, t[2], n_ids)
    kernels.reset_counts()
    got = R.span_reduce(*(x.to(cuda) for x in t[:2]), n_valid, t[2].to(cuda), n_ids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["span_reduce"] == 1 and kernels.grid_launches()["span_reduce"] == 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
    _sums_close(got[1], want[1], kind)


@pytest.mark.parametrize("kind", ["dyadic", "edges"])
@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 305, 4096), (16384, 8480, 1 << 18),
                                             (65536, 65536, 4096), (65536, 65536, 1 << 18),
                                             (16384, 16384, 1 << 20)])
def test_span_fold_table(cuda, n, n_valid, n_ids, kind):
    """B8a's packed table against the plain version at the generator's
    window (8,480 of 16,384 rows into 2^18 series) and the sweep's
    corners: one wrapper call and one __global__ a call into one
    allocation, read through span_views."""
    rng = np.random.default_rng(n_valid + n_ids)
    sid = rng.integers(-3, min(n_ids, 180_000) + 3, n).astype(np.int32)
    sid[n_valid:] = n_ids
    dur = _durations(rng, n, kind)
    t = [torch.from_numpy(a) for a in (sid, dur, EDGES)]
    want = R._reduce_plain(t[0], t[1], n_valid, t[2], n_ids)
    d = [x.to(cuda) for x in t]
    nb = len(EDGES) + 1
    kernels.reset_counts()
    packed = kernels.span_fold(d[0], d[1], n_valid, d[2], n_ids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["span_reduce"] == 1 and kernels.grid_launches()["span_reduce"] == 1
    assert packed.shape == (n_ids * (nb + 2),)
    got = kernels.span_views(packed, n_ids, nb)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[2].cpu(), want[2])
    _sums_close(got[1], want[1], kind)


@pytest.mark.parametrize("kind", ["dyadic", "random", "edges"])
@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 1000, 1024), (8192, 8192, 4096),
                                             (1 << 16, 60_000, 1 << 14)])
def test_edge_reduce_kernel(cuda, n, n_valid, n_ids, kind):
    rng = np.random.default_rng(n * 7 + n_ids)
    eid = rng.integers(-3, n_ids + 3, n).astype(np.int32)
    cdur, sdur = _durations(rng, n, kind), _durations(rng, n, kind)
    failed = (rng.random(n) < 0.3).astype(np.int32)
    t = [torch.from_numpy(a) for a in (eid, cdur, sdur, failed, EDGES)]
    want = R._edge_reduce_plain(*t[:4], n_valid, t[4], n_ids)
    kernels.reset_counts()
    got = R.edge_reduce(*(x.to(cuda) for x in t[:4]), n_valid, t[4].to(cuda), n_ids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edge_reduce"] == 1
    for k in (0, 1, 4, 5):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in (2, 3):
        _sums_close(got[k], want[k], kind)


@pytest.mark.parametrize("kind", ["dyadic", "edges"])
@pytest.mark.parametrize("n_valid,n_ids", [(305, 4096), (8192, 4096), (305, 65536),
                                           (65536, 65536)])
def test_edge_reduce_routes(cuda, n_valid, n_ids, kind):
    """Both B8b routes (the tile CTAs, the memset and atomic fold) against
    the plain version at the generator's window and past the plan's
    crossover; each call is 1 wrapper call and 1 __global__ into one
    allocation."""
    rng = np.random.default_rng(n_valid + n_ids)
    n = max(1024, n_valid)
    eid = rng.integers(-3, n_ids + 3, n).astype(np.int32)
    cdur, sdur = _durations(rng, n, kind), _durations(rng, n, kind)
    failed = rng.integers(0, 3, n).astype(np.int32)
    t = [torch.from_numpy(a) for a in (eid, cdur, sdur, failed, EDGES)]
    want = R._edge_reduce_plain(*t[:4], n_valid, t[4], n_ids)
    d = [x.to(cuda) for x in t]
    nb = len(EDGES) + 1
    plan = kernels.edge_plan(n_valid, n_ids, nb)
    for p in (plan, plan._replace(tiled=not plan.tiled)):
        kernels.reset_counts()
        packed = kernels.edge_fold(*d[:4], n_valid, d[4], n_ids, p)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["edge_reduce"] == 1 and kernels.grid_launches()["edge_reduce"] == 1
        got = kernels.edge_views(packed, n_ids, nb)
        for k in (0, 1, 4, 5):
            assert torch.equal(got[k].cpu(), want[k]), (k, p.tiled)
        for k in (2, 3):
            _sums_close(got[k], want[k], kind)


def test_reduce_wrappers_refuse_bad_arguments(cuda):
    sid = torch.zeros(1024, dtype=torch.int32, device=cuda)
    dur = torch.zeros(1024, dtype=torch.float32, device=cuda)
    edges = torch.from_numpy(EDGES).to(cuda)
    with pytest.raises(kernels.KernelError):
        kernels.span_reduce(sid, dur.double(), 1024, edges, 1024)
    with pytest.raises(kernels.KernelError):
        kernels.span_reduce(sid, dur, 2048, edges, 1024)
    with pytest.raises(kernels.KernelError):
        kernels.span_reduce(sid, dur, 10, torch.zeros(300, device=cuda), 1024)
    with pytest.raises(kernels.KernelError):
        kernels.edge_reduce(sid, dur, dur, sid.cpu(), 10, edges, 1024)


def test_metrics_reduce_card_equals_cpu(cuda):
    rng = np.random.default_rng(3)
    n, n_series = 20_000, 150_000
    sid = rng.integers(0, n_series, n).astype(np.int32)
    dur = _durations(rng, n, "random")
    got = R.span_metrics_reduce(sid, dur, n_series, LATENCY_BUCKETS, device=cuda)
    want = R.span_metrics_reduce(sid, dur, n_series, LATENCY_BUCKETS, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_RTOL)
    eid = rng.integers(0, 300, n).astype(np.int32)
    failed = (rng.random(n) < 0.1).astype(np.int32)
    got = R.edge_metrics_reduce(eid, dur, dur[::-1].copy(), failed, 300, LATENCY_BUCKETS, cuda)
    want = R.edge_metrics_reduce(eid, dur, dur[::-1].copy(), failed, 300, LATENCY_BUCKETS, "cpu")
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(got[k], want[k])
    for k in (2, 3):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL)


def test_generator_card_equals_cpu(cuda):
    """The card generator and a CPU one over the same pushes: the same
    series and edges, counts and buckets exact, sums within rtol."""
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device=cuda)
    cpu = MetricsGenerator(Overrides(), stale_series_s=3600.0, device="cpu")
    rng = random.Random(4)
    for w in range(6):
        batch = [t for _, t in make_traces(40, seed=rng.randrange(10**6), n_spans=12)]
        kernels.reset_counts()
        gen.push("t", batch)
        assert kernels.LAUNCHES["span_reduce"] == 1
        cpu.push("t", batch)
    a, b = gen._procs("t")["span-metrics"], cpu._procs("t")["span-metrics"]
    assert [vars(k) for k in a.key_list] == [vars(k) for k in b.key_list]
    for name in ("calls", "lat_count", "lat_buckets"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_allclose(a.lat_sum, b.lat_sum, rtol=SUM_RTOL)
    a, b = gen._procs("t")["service-graphs"], cpu._procs("t")["service-graphs"]
    assert a.edge_list == b.edge_list
    for name in ("counts", "failed_counts", "client_buckets", "server_buckets"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("client_sum", "server_sum"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=SUM_RTOL)


def test_distributor_tap_on_the_card(cuda, tmp_path):
    """The single-binary write path on the card: pushes through the
    distributor reach the card generator through the tap with no extra
    decode, B8a launched once a window."""
    from tempo_tpu_torch.backend import MemBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.db.wal import WAL
    from tempo_tpu_torch.ring.ring import InMemoryKV, Lifecycler, Ring
    from tempo_tpu_torch.services.app import generator_window_tap
    from tempo_tpu_torch.services.distributor import Distributor
    from tempo_tpu_torch.services.ingester import Ingester
    from tempo_tpu_torch.wire.model import Trace
    from tempo_tpu_torch.wire.otlp_pb import encode_trace

    db = TempoDB(TempoDBConfig(), backend=MemBackend(), device=cuda)
    ing = Ingester(WAL(str(tmp_path / "w")), db, Overrides(), device=cuda)
    gen = MetricsGenerator(Overrides(), stale_series_s=3600.0, device=cuda)
    kv = InMemoryKV()
    Lifecycler(kv, "ing", "ing-0").join()
    dist = Distributor(Ring(kv, "ing"), lambda a: ing, Overrides(),
                       generator_window=generator_window_tap(ing, gen))
    traces = make_traces(64, seed=5, n_spans=8)
    kernels.reset_counts()
    try:
        for i in range(0, 64, 16):
            t = Trace()
            for _, tr in traces[i:i + 16]:
                t.resource_spans.extend(tr.resource_spans)
            if i == 0:
                dist.push_raw("t", encode_trace(t))
            else:
                dist.push("t", t.resource_spans)
            assert dist.flush_generator_tap(timeout_s=60.0)
    finally:
        dist.stop()
    st = ing.instance("t").columnar.stats()
    assert st["decodes"] == 64 and st["decodes"] - st["cached"] == 0
    assert kernels.LAUNCHES["span_reduce"] == 4
    assert dist.stats.gen_tap_errors == dist.stats.gen_tap_dropped == 0
    assert int(gen._procs("t")["span-metrics"].calls.sum()) == 64 * 8
