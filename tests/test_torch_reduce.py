"""The metrics-generator's segmented reduces (B8a, B8b): the port's plain
versions against the JAX package's jitted programs
(tempo_tpu/ops/reduce.py `_reduce_kernel` / `_edge_reduce_kernel`, run
on the CPU), the port's numpy-facing folds against the JAX package's,
and the host twins against both, on seeded numpy inputs.

Tolerances: counts and histograms are integers and always exact. Sums
are f32 in both programs; on dyadic durations (exact in f32 at these
sizes) they are exact whatever the summation order, on random f32
durations they agree within rtol 1e-5 (XLA and PyTorch add in different
orders). The host twins sum in f64, so against them sums are exact only
on dyadic data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops import reduce as RR
from tempo_tpu.services.generator import LATENCY_BUCKETS as R_BUCKETS
from tempo_tpu_torch.ops import reduce as R
from tempo_tpu_torch.ops.device import bucket
from tempo_tpu_torch.services.generator import LATENCY_BUCKETS

SUM_RTOL = 1e-5
EDGES = np.asarray(LATENCY_BUCKETS, np.float32)


def _durations(rng, n, dyadic):
    if dyadic:
        return (rng.integers(0, 64, n) * 0.125).astype(np.float32)
    return rng.exponential(0.05, n).astype(np.float32)


def _edge_values(rng, n):
    """Durations on and beside every edge, NaN, +-inf, +-0."""
    special = np.concatenate([EDGES, np.nextafter(EDGES, np.float32(np.inf)),
                              np.nextafter(EDGES, np.float32(-np.inf)),
                              np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30],
                                         np.float32)])
    return rng.choice(special, n).astype(np.float32)


def _assert_sums(got, want, exact):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0)


def _span_both(sid, dur, n_valid, n_ids):
    want = RR._reduce_kernel(jnp.asarray(sid), jnp.asarray(dur), jnp.int32(n_valid),
                             jnp.asarray(EDGES), n_ids, len(EDGES) + 1)
    got = R._reduce_plain(torch.from_numpy(sid), torch.from_numpy(dur), n_valid,
                          torch.from_numpy(EDGES), n_ids)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _edge_both(eid, cdur, sdur, failed, n_valid, n_ids):
    want = RR._edge_reduce_kernel(jnp.asarray(eid), jnp.asarray(cdur), jnp.asarray(sdur),
                                  jnp.asarray(failed), jnp.int32(n_valid), jnp.asarray(EDGES),
                                  n_ids, len(EDGES) + 1)
    got = R._edge_reduce_plain(torch.from_numpy(eid), torch.from_numpy(cdur),
                               torch.from_numpy(sdur), torch.from_numpy(failed), n_valid,
                               torch.from_numpy(EDGES), n_ids)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_bucket_table_matches_reference():
    assert LATENCY_BUCKETS == R_BUCKETS


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 1024, 1024), (2048, 1500, 1024),
                                             (4096, 4096, 4096), (1024, 0, 1024)])
def test_span_reduce_plain_matches_jax(n, n_valid, n_ids, dyadic):
    rng = np.random.default_rng(n + n_valid + n_ids + dyadic)
    sid = rng.integers(0, n_ids, n).astype(np.int32)
    dur = _durations(rng, n, dyadic)
    got, want = _span_both(sid, dur, n_valid, n_ids)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_sums(got[1], want[1], dyadic)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32 and got[2].dtype == np.int32


def test_span_reduce_plain_edge_values_and_dropped_ids():
    """Edge-equal values go to that edge's bucket, NaN to the last, +-inf
    to the ends, -0.0 to the first; ids -1, Sb and larger are dropped
    from every output (FILL_OR_DROP), as are rows at or past n_valid."""
    rng = np.random.default_rng(5)
    n, n_ids = 2048, 1024
    sid = rng.integers(0, n_ids, n).astype(np.int32)
    sid[::7] = -1
    sid[3::11] = n_ids
    sid[5::13] = n_ids + 3
    sid[6::17] = 1 << 20
    dur = _edge_values(rng, n)
    got, want = _span_both(sid, dur, 1900, n_ids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    # the sums hold NaN and inf wherever a series saw them: compare with
    # NaN equal to NaN, finite sums within the stated tolerance
    np.testing.assert_allclose(got[1], want[1], rtol=SUM_RTOL, equal_nan=True)
    assert got[2].sum() == ((np.arange(n) < 1900) & (sid >= 0) & (sid < n_ids)).sum()


def test_span_reduce_plain_searchsorted_cases():
    edges = np.asarray([0.002, 0.004, 1.0], np.float32)
    v = np.asarray([np.nan, -0.0, 0.0, 0.002, 0.0020001, 1.0, np.inf, -np.inf], np.float32)
    got = R._bucket_idx(torch.from_numpy(v), torch.from_numpy(edges)).tolist()
    assert got == [3, 0, 0, 0, 1, 2, 3, 0]
    assert got == np.asarray(jnp.searchsorted(jnp.asarray(edges), jnp.asarray(v))).tolist()


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,n_valid,n_ids", [(1024, 1024, 1024), (2048, 1333, 1024),
                                             (1024, 0, 1024)])
def test_edge_reduce_plain_matches_jax(n, n_valid, n_ids, dyadic):
    rng = np.random.default_rng(n * 3 + n_valid + dyadic)
    eid = rng.integers(0, 40, n).astype(np.int32)
    eid[::9] = -1
    eid[4::19] = n_ids + 1
    cdur, sdur = _durations(rng, n, dyadic), _durations(rng, n, dyadic)
    failed = (rng.random(n) < 0.3).astype(np.int32)
    got, want = _edge_both(eid, cdur, sdur, failed, n_valid, n_ids)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(got[k], want[k])
    for k in (2, 3):
        _assert_sums(got[k], want[k], dyadic)


def test_edge_reduce_plain_edge_values():
    rng = np.random.default_rng(17)
    n, n_ids = 1024, 1024
    eid = rng.integers(-2, 70, n).astype(np.int32)
    cdur, sdur = _edge_values(rng, n), _edge_values(rng, n)
    failed = (rng.random(n) < 0.5).astype(np.int32)
    got, want = _edge_both(eid, cdur, sdur, failed, n, n_ids)
    for k in (0, 1, 4, 5):
        np.testing.assert_array_equal(got[k], want[k])
    for k in (2, 3):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, equal_nan=True)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,n_series", [(700, 40), (5000, 1300), (1, 1)])
def test_span_metrics_reduce_matches_reference(n, n_series, dyadic):
    """The numpy-facing fold (padding to bucket(n) / bucket(n_series),
    the slice, the f64 cast) against the JAX package's, and the host
    twins of both packages against it."""
    rng = np.random.default_rng(n + n_series + dyadic)
    sid = rng.integers(0, n_series, n).astype(np.int32)
    dur = _durations(rng, n, dyadic)
    got = R.span_metrics_reduce(sid, dur, n_series, LATENCY_BUCKETS, device="cpu")
    want = RR.span_metrics_reduce(sid, dur, n_series, R_BUCKETS)
    host = R._reduce_host(sid, dur, n_series, LATENCY_BUCKETS)
    rhost = RR._reduce_host(sid, dur, n_series, R_BUCKETS)
    assert bucket(n) >= n and bucket(n_series) >= n_series
    for out in (want, host, rhost):
        np.testing.assert_array_equal(got[0], out[0])
        np.testing.assert_array_equal(got[2], out[2])
        _assert_sums(got[1], out[1], dyadic)
    assert [a.dtype for a in got] == [np.int64, np.float64, np.int64]
    assert got[1].shape == (n_series,) and got[2].shape == (n_series, len(LATENCY_BUCKETS) + 1)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,n_edges", [(400, 13), (3000, 1100)])
def test_edge_metrics_reduce_matches_reference(n, n_edges, dyadic):
    rng = np.random.default_rng(n + n_edges + 7 * dyadic)
    eid = rng.integers(0, n_edges, n).astype(np.int32)
    cdur, sdur = _durations(rng, n, dyadic), _durations(rng, n, dyadic)
    failed = (rng.random(n) < 0.3).astype(np.int32)
    got = R.edge_metrics_reduce(eid, cdur, sdur, failed, n_edges, LATENCY_BUCKETS,
                                device="cpu")
    want = RR.edge_metrics_reduce(eid, cdur, sdur, failed, n_edges, R_BUCKETS)
    host = R._edge_reduce_host(eid, cdur, sdur, failed, n_edges, LATENCY_BUCKETS)
    rhost = RR._edge_reduce_host(eid, cdur, sdur, failed, n_edges, R_BUCKETS)
    for out in (want, host, rhost):
        for k in (0, 1, 4, 5):
            np.testing.assert_array_equal(got[k], out[k])
        for k in (2, 3):
            _assert_sums(got[k], out[k], dyadic)
    assert [a.dtype for a in got] == [np.int64] * 2 + [np.float64] * 2 + [np.int64] * 2


@pytest.mark.parametrize("n_ids", [0, 9])
def test_empty_window_short_cut(n_ids):
    nb = len(LATENCY_BUCKETS) + 1
    e32, ef = np.zeros(0, np.int32), np.zeros(0, np.float32)
    got = R.span_metrics_reduce(e32, ef, n_ids, LATENCY_BUCKETS, device="cpu")
    want = RR.span_metrics_reduce(e32, ef, n_ids, R_BUCKETS)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any()
    got = R.edge_metrics_reduce(e32, ef, ef, e32, n_ids, LATENCY_BUCKETS, device="cpu")
    want = RR.edge_metrics_reduce(e32, ef, ef, e32, n_ids, R_BUCKETS)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any()
    assert got[4].shape == (n_ids, nb)


def test_dispatch_takes_the_plain_version_on_cpu_tensors(monkeypatch):
    """A CPU tensor never reaches a kernel wrapper; a CUDA tensor would
    (tests/test_torch_cuda_generator.py)."""
    from tempo_tpu_torch import kernels

    def boom(*a, **k):
        raise AssertionError("kernel wrapper called with CPU tensors")

    monkeypatch.setattr(kernels, "span_reduce", boom)
    monkeypatch.setattr(kernels, "edge_reduce", boom)
    sid = torch.zeros(1024, dtype=torch.int32)
    dur = torch.ones(1024, dtype=torch.float32)
    edges = torch.from_numpy(EDGES)
    calls, _, _ = R.span_reduce(sid, dur, 10, edges, 1024)
    assert int(calls[0]) == 10
    counts, *_ = R.edge_reduce(sid, dur, dur, sid, 10, edges, 1024)
    assert int(counts[0]) == 10


def test_kernel_wrappers_refuse_cpu_tensors():
    from tempo_tpu_torch import kernels

    sid = torch.zeros(1024, dtype=torch.int32)
    dur = torch.zeros(1024, dtype=torch.float32)
    with pytest.raises(kernels.KernelError):
        kernels.span_reduce(sid, dur, 1024, torch.from_numpy(EDGES), 1024)
    with pytest.raises(kernels.KernelError):
        kernels.edge_reduce(sid, dur, dur, sid, 1024, torch.from_numpy(EDGES), 1024)


def test_fold_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sid = np.zeros(3, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.span_metrics_reduce(sid, np.ones(3, np.float32), 1, LATENCY_BUCKETS)


def test_huge_id_dropped_where_reference_histogram_wraps():
    """An id past 2^31 / nb: the JAX program's histogram index sid * nb
    wraps in int32 (2^30 * 4 = 2^32 -> cell 0), so its histogram counts
    the row in series 0 while its calls and sums drop it. The port drops
    it from every output (ROADMAP §C); the generator never makes such an
    id (sids stay below n_series)."""
    edges = np.asarray([0.002, 0.004, 1.0], np.float32)
    sid = np.asarray([2**30, 5], np.int32)
    dur = np.asarray([0.5, 0.5], np.float32)
    want = RR._reduce_kernel(jnp.asarray(sid), jnp.asarray(dur), jnp.int32(2),
                             jnp.asarray(edges), 1024, 4)
    got = R._reduce_plain(torch.from_numpy(sid), torch.from_numpy(dur), 2,
                          torch.from_numpy(edges), 1024)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.asarray(want[2])[0].tolist() == [0, 0, 1, 0]  # the reference's wrap
    assert got[2][0].tolist() == [0, 0, 0, 0] and int(got[2].sum()) == 1
