"""B8a's packed table and B6's one-launch fold on the CPU: B6's plan
(kernels.timeseries_plan, kernels.timeseries_route), the packed layouts
(span_views, timeseries_views), and each design held against the JAX
package.

B8a (csrc/reduce.cu) folds a window into one packed (n_ids, nb + 2)
int32 table whose first n rows are one contiguous download; span_fold
on CPU tensors packs the plain version's outputs the same way, and is
held against tempo_tpu's _reduce_kernel here. B6 (csrc/timeseries.cu
ts_one_kernel) reduces each cluster's spans to one grid: on the shared
route each CTA's private copy, reduced over the cluster slice by slice;
on the cluster route the cells spread over the cluster's CTAs (`per`
cells of each plane a CTA). The cluster grids are then combined (the
shared route by device atomics in any order, the cluster route as
partials merged in cluster order; min and max as ordered int32
encodings, decoded at the end); the global route folds every span into
one grid. `_ts_clusters` does the same in torch, merging in cluster
order, and is held against tempo_tpu's jitted program on the same numpy
inputs: exactly, but for f32 sums on values that are not dyadic. The kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, tests/test_torch_cuda_generator.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_cases as TC
import torch

from tempo_tpu.ops import filter as RF
from tempo_tpu.ops import reduce as RR
from tempo_tpu.ops import timeseries as RTS
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import reduce as R
from tempo_tpu_torch.ops import stage as ST
from tempo_tpu_torch.ops import timeseries as TS
from tempo_tpu_torch.ops.device import bucket
from tempo_tpu_torch.services.generator import LATENCY_BUCKETS

EDGES = np.asarray(LATENCY_BUCKETS, np.float32)
NB = len(LATENCY_BUCKETS) + 1

# ------------------------------------------------------------------ B8a


def _ids(kind, rng, n, n_ids):
    if kind == "mixed":  # out-of-range ids on both sides
        return rng.integers(-3, n_ids + 3, n).astype(np.int32)
    if kind == "narrow":  # every row in the ids [64, 96)
        return rng.integers(64, 96, n).astype(np.int32)
    if kind == "hole":  # the registry's live ids, [3,072, 4,096) left empty
        sid = rng.integers(0, min(n_ids, 180_000), n).astype(np.int32)
        return np.where((sid >= 3072) & (sid < 4096), sid - 3072, sid).astype(np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("n,n_valid,n_ids,kind", [(1024, 700, 4096, "mixed"),
                                                  (2048, 2048, 1 << 18, "hole"),
                                                  (1024, 1000, 4096, "narrow"),
                                                  (1024, 0, 4096, "mixed"),
                                                  (1024, 1024, 100, "mixed"),
                                                  (4096, 3000, 150_000, "hole"),
                                                  (1024, 555, 1 << 12, "narrow"),
                                                  (2048, 1999, 4095, "mixed")])
def test_span_fold_equal_jax(n, n_valid, n_ids, kind):
    """The packed table of span_fold (the plain version on CPU tensors)
    against tempo_tpu's _reduce_kernel: dyadic durations, NaN and
    edge-equal values bucketed as numpy, padded rows (i >= n_valid, some
    with live ids) and ids outside [0, n_ids) dropped, an empty id range
    left zero; every word of the table written."""
    rng = np.random.default_rng(n + n_valid + n_ids)
    sid = _ids(kind, rng, n, n_ids)
    sid[n_valid:] = np.where(np.arange(n - n_valid) % 2, n_ids, 5)
    dur = (rng.integers(0, 64, n) * 0.125).astype(np.float32)
    dur[::37] = np.nan
    dur[5::41] = EDGES[3]
    packed = R.span_fold(torch.from_numpy(sid), torch.from_numpy(dur), n_valid,
                         torch.from_numpy(EDGES), n_ids)
    assert packed.shape == (n_ids * (NB + 2),) and packed.dtype == torch.int32
    got = kernels.span_views(packed, n_ids, NB)
    want = RR._reduce_kernel(jnp.asarray(sid), jnp.asarray(dur), jnp.int32(n_valid),
                             jnp.asarray(EDGES), n_ids, NB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kind == "hole":
        assert not got[0][3072:4096].any() and got[0][:n_ids].any()


def test_span_metrics_reduce_one_fold_one_download(monkeypatch):
    """span_metrics_reduce folds a window once into the packed table and
    reads back only its first n_series rows, as the JAX program's
    [:n_series] slice; rows pad to bucket(n) with id bucket(n_series)."""
    rng = np.random.default_rng(8)
    n, n_series = 1500, 300
    sid = rng.integers(0, n_series, n).astype(np.int32)
    dur = (rng.integers(0, 4096, n) / 1024).astype(np.float32)
    folds, views = [], []
    fold, view = R.span_fold, kernels.span_views
    monkeypatch.setattr(R, "span_fold", lambda *a: folds.append(a) or fold(*a))
    monkeypatch.setattr(kernels, "span_views", lambda p, k, nb: views.append(p.shape) or
                        view(p, k, nb))
    calls, lsum, hist = R.span_metrics_reduce(sid, dur, n_series, LATENCY_BUCKETS, device="cpu")
    assert len(folds) == 1 and folds[0][4] == bucket(n_series) and folds[0][2] == n
    assert views == [(n_series * (NB + 2),)]
    want = RR._reduce_kernel(jnp.asarray(sid), jnp.asarray(dur), jnp.int32(n),
                             jnp.asarray(EDGES), n_series, NB)
    assert (calls.dtype, lsum.dtype, hist.dtype) == (np.int64, np.float64, np.int64)
    for g, w in zip((calls, lsum, hist), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_span_views_and_the_cpu_fold():
    """One allocation, row-major (n_ids, nb + 2): the first n rows are one
    contiguous prefix (span_metrics_reduce's one download); span_fold on
    CPU tensors packs the plain version's outputs the same way."""
    packed = torch.arange(1024 * 17 + 9, dtype=torch.int32)
    calls, lsum, hist = kernels.span_views(packed, 1024, 15)
    assert [tuple(x.shape) for x in (calls, lsum, hist)] == [(1024,), (1024,), (1024, 15)]
    assert (calls.dtype, lsum.dtype, hist.dtype) == (torch.int32, torch.float32, torch.int32)
    assert all(x.untyped_storage().data_ptr() == packed.data_ptr() for x in (calls, lsum, hist))
    assert int(calls[1]) == 17 and int(hist[-1, -1]) == 1024 * 17 - 1
    rng = np.random.default_rng(5)
    sid = torch.from_numpy(rng.integers(-2, 300, 1024).astype(np.int32))
    dur = torch.from_numpy(rng.exponential(0.05, 1024).astype(np.float32))
    edges = torch.from_numpy(EDGES)
    got = kernels.span_views(R.span_fold(sid, dur, 900, edges, 256), 256, NB)
    for g, w in zip(got, R._reduce_plain(sid, dur, 900, edges, 256)):
        assert torch.equal(g, w)


# ------------------------------------------------------------------ B6
G, NBK = 37, 29  # 1,073 cells: a cluster of 16 owns 68 a CTA, the last CTA 53


def _ts_inputs(dyadic: bool):
    """Spans of TC.make_cols with start times before, inside and past
    the axis, gid -1, and values with NaN, -0.0, +0.0, +inf and -inf."""
    rng = np.random.default_rng(11 + dyadic)
    cols = TC.make_cols(seed=3)
    n = TC.N_SPANS
    start = rng.integers(-20_000, 120_000, n).astype(np.int32)
    gid = rng.integers(-1, G, n).astype(np.int32)
    if dyadic:
        val = (rng.integers(-511, 512, n) / 8).astype(np.float32)
    else:
        val = rng.lognormal(0, 2, n).astype(np.float32)
    special = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
    hit = rng.random(n) < 0.04
    val[hit] = special[rng.integers(0, 5, hit.sum())]
    # one cell of signed zeros alone (group G - 1, bucket 0; spans that
    # "and_or_mixed" keeps): min -0.0, max +0.0
    gid[gid == G - 1] = 0
    zeros = [3, 8, 10, 15, 17, 19]
    val[zeros], gid[zeros], start[zeros] = [0.0, -0.0, 0.0, -0.0, 0.0, 0.0], G - 1, 4_000
    pres = rng.random(n) < 0.85
    pres[zeros] = True

    def pad(a, fill):
        out = np.full(TC.N_SPANS_B, fill, a.dtype)
        out[:n] = a
        return out

    cols["span.start_ms"] = pad(start, np.int32(-(2**31)))
    return cols, pad(gid, np.int32(-1)), pad(val, np.float32(0)), pad(pres, False)


def _enc(v: torch.Tensor, nan_wins: int) -> torch.Tensor:
    return torch.where(torch.isnan(v), torch.tensor(nan_wins, dtype=torch.int32), TS._ts_enc(v))


def _ts_clusters(ok, seg, pres, val, cells, plan, ctas):
    """ts_one_kernel's decomposition. shared: span s goes to the CTA of
    its grid-stride thread (TS_THREADS a CTA), which folds it into its
    private grid; in each cluster CTA r reduces its slice of cells over
    the cluster's copies, its own first, then ranks r + 1, r + 2, ...
    cluster: the CTA of span s is that of its round's chunk (TS_ROUND
    spans), and it files the span with the owner of its cell (cell //
    per) in its cluster, which folds it into its slice. global: one grid.
    The K cluster grids then combine, here in cluster order (the shared
    route's atomics take any order: the same integers, min and max, and
    f32 sums within rounding). Returns the decoded
    planes (counts, vcnt, vsum, vmin, vmax), each (cells,)."""
    n = ok.shape[0]
    s = torch.arange(n)
    c = plan.cluster
    ident = torch.tensor((0, 0, 0, 0x7F800000, -2139095041), dtype=torch.int32)  # enc(+-inf)
    if plan.route == "global":
        cta, k_parts, per, slots = torch.zeros(n, dtype=torch.long), 1, cells, 1
    elif plan.route == "shared":
        cta = (s % (ctas * kernels.TS_THREADS)) // kernels.TS_THREADS
        k_parts, per, slots = ctas // c, cells, ctas  # a private grid a CTA
    else:
        cta = (s // kernels.TS_ROUND) % ctas
        k_parts, per, slots = ctas // c, plan.per, ctas  # a slice a CTA
        cta = cta // c * c + seg.clamp(max=c * per - 1) // per  # the owner in its cluster
    assert per * (1 if plan.route == "shared" else c) >= cells and ctas % c == 0
    grids = ident[None, :, None].repeat(slots, 1, per)  # (CTA, plane, cell of its grid)
    buf = grids.view(-1)
    at = cta * 5 * per + (seg if plan.route != "cluster" else seg % per)  # plane 0 of the cell
    sp = ok & pres
    v = val[sp]
    buf.index_add_(0, at[ok], torch.ones(int(ok.sum()), dtype=torch.int32))
    buf.index_add_(0, at[sp] + per, torch.ones(v.shape[0], dtype=torch.int32))
    buf.view(torch.float32).index_add_(0, at[sp] + 2 * per, v)
    buf.scatter_reduce_(0, at[sp] + 3 * per, _enc(v, -(2**31)), "amin")
    buf.scatter_reduce_(0, at[sp] + 4 * per, _enc(v, 2**31 - 1), "amax")

    def comb(p, x, y):
        if p == 2:
            return (x.view(torch.float32) + y.view(torch.float32)).view(torch.int32)
        return torch.minimum(x, y) if p == 3 else torch.maximum(x, y) if p == 4 else x + y

    if plan.route == "global":
        parts = grids[:1]
    elif plan.route == "cluster":  # partial q: its cluster's slices in rank order
        parts = grids.view(k_parts, c, 5, per).permute(0, 2, 1, 3).reshape(k_parts, 5, c * per)
    else:  # partial q: slice r reduced over the cluster's copies from rank r on
        sl = -(-cells // c)
        parts = torch.empty((k_parts, 5, cells), dtype=torch.int32)
        for q in range(k_parts):
            for r in range(c):
                lo, hi = r * sl, min(cells, (r + 1) * sl)
                for p in range(5):
                    x = grids[q * c + r, p, lo:hi]
                    for t in range(1, c):
                        x = comb(p, x, grids[q * c + (r + t) % c, p, lo:hi])
                    parts[q, p, lo:hi] = x
    out = parts[0, :, :cells].clone()
    for j in range(1, k_parts):
        for p in range(5):
            out[p] = comb(p, out[p], parts[j, p, :cells])
    return out[0], out[1], out[2].view(torch.float32), TS.ts_decode(out[3]), TS.ts_decode(out[4])


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("route,parts", [("shared", 1), ("shared", 3), ("cluster", 1),
                                         ("cluster", 2), ("global", 1)])
def test_ts_clusters_equal_jax(route, parts, dyadic):
    """Each route the plan may take, with one or more cluster partials to
    merge, over a span and trace condition tree, against the JAX program:
    counts and value counts exact, min and max equal (NaN where a NaN was
    folded), -0.0 below +0.0; sums exact on dyadic values, else within
    rtol 1e-5."""
    specs, tree, rows, tables = TC.filter_cases()["and_or_mixed"]
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    cols, gid, val, pres = _ts_inputs(dyadic)
    t0, step, cells = 1_000, 3_500, G * NBK
    plan = kernels.timeseries_route(route, cells, True)
    ctas = parts * plan.cluster  # a partial a cluster
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    ops = F.Operands.build(rows, tables)
    ttab = {i: torch.from_numpy(t) for i, t in TS._table_list(ops).items()}
    ok, seg = TS._ts_segments(tree, conds, staged.cols, torch.from_numpy(ops.ints),
                              torch.from_numpy(ops.floats), ttab, torch.from_numpy(gid), t0, step,
                              TC.N_SPANS, NBK, G, TC.N_SPANS_B, TC.N_RES_B, TC.N_TRACES_B)
    got = _ts_clusters(ok, seg, torch.from_numpy(pres), torch.from_numpy(val), cells, plan, ctas)
    rops = RF.Operands.build(rows, tables)
    idxs, tabs = RTS._table_list(rops)
    fn = RTS._compiled_ts(tree, rconds, idxs, True, TC.N_SPANS_B, TC.N_RES_B, TC.N_TRACES_B,
                          bucket(G), bucket(NBK))
    want = fn(cols, rops.ints, rops.floats, tabs, gid, val, pres, np.int32(t0), np.int32(step),
              np.int32(TC.N_SPANS), np.int32(NBK))
    want = [np.asarray(w)[:G, :NBK].reshape(-1) for w in want]
    assert int(want[0].sum()) > 0 and np.isnan(want[3]).any() and np.isinf(want[4]).any()
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2 and not dyadic:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=0, equal_nan=True)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {i}")
    zero = (G - 1) * NBK + (4_000 - t0) // step  # the cell of signed zeros alone
    assert int(got[1][zero]) == 6
    assert str(float(got[3][zero])) == "-0.0" and str(float(got[4][zero])) == "0.0"


def test_ts_cluster_counts_only_equal_plain():
    """A counts-only grid on the cluster route (forced), and on the
    plan's route (the shared route), equals the plain version."""
    cols, gid, _, _ = _ts_inputs(True)
    cells = G * NBK
    staged = ST.staged_from_numpy(cols, TC.N_SPANS, TC.N_TRACES, TC.N_RES, "cpu")
    ok, seg = TS._ts_segments(None, (), staged.cols, None, None, {}, torch.from_numpy(gid), -3_000,
                              2_000, TC.N_SPANS, NBK, G, TC.N_SPANS_B, TC.N_RES_B, TC.N_TRACES_B)
    want = TS._timeseries_plain(None, (), staged.cols, None, None, {}, torch.from_numpy(gid), None,
                                None, -3_000, 2_000, TC.N_SPANS, NBK, G, TC.N_SPANS_B,
                                TC.N_RES_B, TC.N_TRACES_B)[0].reshape(-1)
    assert int(want.sum()) > 0
    for plan, ctas in ((kernels.timeseries_route("cluster", cells, False), 48),
                       (kernels.timeseries_plan(cells, False), 24)):
        got = _ts_clusters(ok, seg, torch.zeros_like(ok), torch.zeros(ok.shape[0]), cells, plan,
                           ctas)
        assert torch.equal(got[0], want), plan


def test_timeseries_plan_routes():
    """Phase 10's grids: rate() by service (64 x 61 counts) on the shared
    route (a private copy a CTA, clusters reducing them);
    avg_over_time by name (512 x 61 x 5 planes, 625 KB) over a cluster of
    16; a counts-only grid past one CTA, and a value grid past 16 CTAs'
    TS_SMEM_MAX, take the global route."""
    assert kernels.timeseries_plan(64 * 61, False) == ("shared", kernels.TS_SHARED_CLUSTER,
                                                       3904, 15616)
    assert kernels.timeseries_plan(512 * 61, True) == ("cluster", 16, 1952,
                                                       39040 + kernels.TS_EXCH)
    for cells, has_val in ((3904, True), (31232, False), (31232, True), (200_000, False),
                           (200_000, True), (1, False)):
        p = kernels.timeseries_plan(cells, has_val)
        words = 4 * (5 if has_val else 1)
        fits_one = words * cells <= kernels.TS_SMEM_CTA
        fits_16 = words * -(-cells // 16) + kernels.TS_EXCH <= kernels.TS_SMEM_MAX
        assert p.route == ("shared" if fits_one else "cluster" if has_val and fits_16
                           else "global"), (cells, has_val)
        assert p == kernels.timeseries_route(p.route, cells, has_val)
        if p.route == "shared":
            assert p.smem == words * cells and p.per == cells
        elif p.route == "cluster":
            assert p.cluster == 16 and p.per * 16 >= cells
            assert p.smem == words * p.per + kernels.TS_EXCH
    assert kernels.timeseries_plan(200_000, True).route == "global"


def test_timeseries_route_forces_and_refuses():
    """timeseries_route gives the plan a forced route takes: the shared
    route up to TS_SMEM_MAX of planes, the cluster route over TS_CLUSTER
    CTAs up to TS_SMEM_MAX a CTA, the global route always; a grid past a
    route's shared memory, or a route that does not exist, raises."""
    p = kernels.timeseries_route("cluster", 512 * 61, False)
    assert p == ("cluster", kernels.TS_CLUSTER, 1952, 4 * 1952 + kernels.TS_EXCH)
    assert kernels.timeseries_route("shared", 3904, True) == (
        "shared", kernels.TS_SHARED_CLUSTER, 3904, 20 * 3904)
    assert kernels.timeseries_route("global", 1 << 24, True) == ("global", 1, 0, 0)
    cap = kernels.TS_SMEM_MAX // 20
    assert kernels.timeseries_route("shared", cap, True).smem <= kernels.TS_SMEM_MAX
    with pytest.raises(kernels.KernelError):
        kernels.timeseries_route("shared", cap + 1, True)
    cap16 = kernels.TS_CLUSTER * ((kernels.TS_SMEM_MAX - kernels.TS_EXCH) // 20)
    assert kernels.timeseries_route("cluster", cap16, True).smem <= kernels.TS_SMEM_MAX
    with pytest.raises(kernels.KernelError):
        kernels.timeseries_route("cluster", cap16 + 1, True)
    with pytest.raises(kernels.KernelError):
        kernels.timeseries_route("tiles", 100, True)


def test_timeseries_views_are_one_allocation():
    packed = torch.arange(5 * 12 * 7 + 100, dtype=torch.int32)
    v = kernels.timeseries_views(packed, True, 12, 7)
    assert [tuple(x.shape) for x in v] == [(12, 7)] * 5
    assert [x.dtype for x in v] == [torch.int32] * 2 + [torch.float32] * 3
    assert all(x.untyped_storage().data_ptr() == packed.data_ptr() for x in v)
    assert int(v[4].view(torch.int32)[-1, -1]) == 5 * 84 - 1
    (c,) = kernels.timeseries_views(packed, False, 12, 7)
    assert tuple(c.shape) == (12, 7) and int(c[1, 0]) == 7
